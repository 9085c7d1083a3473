"""Consensus round state types (consensus/types/round_state.go +
height_vote_set.go), the port's copy of
``cometbft_tpu/consensus/cstypes.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE, Block, BlockID
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote_set import VoteSet

# RoundStepType (consensus/types/round_state.go:12-40).
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "RoundStepNewHeight",
    STEP_NEW_ROUND: "RoundStepNewRound",
    STEP_PROPOSE: "RoundStepPropose",
    STEP_PREVOTE: "RoundStepPrevote",
    STEP_PREVOTE_WAIT: "RoundStepPrevoteWait",
    STEP_PRECOMMIT: "RoundStepPrecommit",
    STEP_PRECOMMIT_WAIT: "RoundStepPrecommitWait",
    STEP_COMMIT: "RoundStepCommit",
}


class HeightVoteSet:
    """consensus/types/height_vote_set.go: prevotes + precommits for every
    round of one height; peers may each point one catchup round."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self._mtx = threading.RLock()
        self.round = 0
        self._round_vote_sets: dict[int, dict[int, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            raise ValueError("addRound() for an existing round")
        self._round_vote_sets[round_] = {
            PREVOTE_TYPE: VoteSet(
                self.chain_id, self.height, round_, PREVOTE_TYPE, self.val_set
            ),
            PRECOMMIT_TYPE: VoteSet(
                self.chain_id, self.height, round_, PRECOMMIT_TYPE, self.val_set
            ),
        }

    def set_round(self, round_: int) -> None:
        """Create vote sets up to and including round_ (the caller passes
        current+1 — height_vote_set.go SetRound)."""
        with self._mtx:
            new_round = self.round - 1 if self.round > 0 else 0
            if self.round != 0 and round_ < new_round:
                raise ValueError("SetRound() must increment hvs.round")
            for r in range(new_round, round_ + 1):
                if r not in self._round_vote_sets:
                    self._add_round(r)
            self.round = round_

    def add_vote(self, vote, peer_id: str = "") -> bool:
        """height_vote_set.go AddVote: unknown future rounds from peers are
        limited to one catchup round per peer."""
        with self._mtx:
            if not _is_vote_type_valid(vote.type):
                return False
            vote_set = self._get_vote_set(vote.round, vote.type)
            if vote_set is None:
                rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                if len(rounds) < 2:
                    self._add_round(vote.round)
                    vote_set = self._get_vote_set(vote.round, vote.type)
                    rounds.append(vote.round)
                else:
                    raise GotVoteFromUnwantedRoundError(vote.round)
            return vote_set.add_vote(vote)

    def set_peer_maj23(self, round_: int, vote_type: int, peer_id: str, block_id) -> None:
        with self._mtx:
            if not _is_vote_type_valid(vote_type):
                raise ValueError(f"SetPeerMaj23: invalid vote type {vote_type}")
            vote_set = self._get_vote_set(round_, vote_type)
            if vote_set is None:
                return
            vote_set.set_peer_maj23(peer_id, block_id)

    def prevotes(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get_vote_set(round_, PREVOTE_TYPE)

    def precommits(self, round_: int) -> VoteSet | None:
        with self._mtx:
            return self._get_vote_set(round_, PRECOMMIT_TYPE)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Last round with a prevote 2/3 majority (height_vote_set.go POLInfo)."""
        with self._mtx:
            for r in range(self.round, -1, -1):
                rvs = self._get_vote_set(r, PREVOTE_TYPE)
                if rvs is not None:
                    block_id, ok = rvs.two_thirds_majority()
                    if ok:
                        return r, block_id
            return -1, None

    def _get_vote_set(self, round_: int, vote_type: int) -> VoteSet | None:
        rvs = self._round_vote_sets.get(round_)
        if rvs is None:
            return None
        return rvs.get(vote_type)



class GotVoteFromUnwantedRoundError(Exception):
    def __init__(self, round_: int):
        super().__init__(
            f"peer has sent a vote that does not match our round for more than one round: {round_}"
        )


def _is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


@dataclass
class RoundState:
    """consensus/types/round_state.go:65-120: the full internal consensus
    state, exposed via RPC dump_consensus_state."""

    height: int = 0
    round: int = 0
    step: int = STEP_NEW_HEIGHT
    start_time: Time = dfield(default_factory=Time)
    commit_time: Time = dfield(default_factory=Time)
    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None
    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None
    votes: HeightVoteSet | None = None
    commit_round: int = -1
    last_commit: VoteSet | None = None
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def round_state_event(self):
        from cometbft_tpu_torch.types import events as ev

        return ev.EventDataRoundState(
            height=self.height, round=self.round, step=STEP_NAMES[self.step]
        )
