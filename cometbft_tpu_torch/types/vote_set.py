"""VoteSet: real-time 2/3-majority tracking during consensus
(types/vote_set.go), the port's copy of ``cometbft_tpu/types/vote_set.py``.

Two storage areas exactly as the reference documents (vote_set.go:27-58):
`votes` (canonical, one per validator) and `votes_by_block` (per-block
tallies, tracking conflicts only for blocks a peer claims have 2/3). Memory
stays bounded: a conflicting vote is kept only when its block is tracked.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.crypto import sigbatch
from cometbft_tpu_torch.libs.bit_array import BitArray
from cometbft_tpu_torch.types.block import BlockID, Commit
from cometbft_tpu_torch.types.vote import Vote, vote_to_commit_sig

MAX_VOTES_COUNT = 10000  # types/vote_set.go:15

# One error class across vote verification and vote-set bookkeeping, so
# callers (consensus tryAddVote) can classify invalid votes uniformly.
from cometbft_tpu_torch.types.vote import VoteError  # noqa: E402


class ErrVoteConflictingVotes(Exception):
    """Double-sign detected (types/vote.go NewConflictingVoteError)."""

    def __init__(self, vote_a: Vote, vote_b: Vote):
        self.vote_a = vote_a
        self.vote_b = vote_b
        super().__init__(
            f"conflicting votes from validator {vote_a.validator_address.hex().upper()}"
        )


class _BlockVotes:
    """votes for one block (vote_set.go blockVotes)."""

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Vote | None] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Vote | None:
        if 0 <= idx < len(self.votes):
            return self.votes[idx]
        return None


class VoteSet:
    """types/vote_set.go:62-470."""

    def __init__(self, chain_id: str, height: int, round_: int, signed_msg_type: int, val_set):
        if height == 0:
            raise ValueError("Cannot make VoteSet for height == 0, doesn't make sense")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self._mtx = threading.RLock()
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: list[Vote | None] = [None] * val_set.size()
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    # -- adding votes (vote_set.go:145-315) ----------------------------------

    def add_vote(self, vote: Vote | None) -> bool:
        with self._mtx:
            return self._add_vote(vote)

    def _add_vote(self, vote: Vote | None) -> bool:
        if vote is None:
            raise VoteError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()
        if val_index < 0:
            raise VoteError("index < 0: invalid validator index")
        if not val_addr:
            raise VoteError("empty address: invalid validator address")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            raise VoteError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, got "
                f"{vote.height}/{vote.round}/{vote.type}: unexpected step"
            )
        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteError(
                f"cannot find validator {val_index} in valSet of size {self.val_set.size()}"
            )
        if val_addr != lookup_addr:
            raise VoteError(
                f"vote.ValidatorAddress ({val_addr.hex().upper()}) does not match "
                f"address ({lookup_addr.hex().upper()}) for vote.ValidatorIndex ({val_index})"
            )
        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # exact duplicate
            raise VoteError(
                f"existing vote: {existing}; new vote: {vote}: non-deterministic signature"
            )
        # Check signature. The structural checks above stay inline; the
        # crypto rides the shared micro-batch window (crypto/sigbatch.py) so
        # concurrent admissions — gossip from many peers, every in-process
        # node of a devnet — merge into one columnar dispatch. Semantics are
        # exactly vote.verify's: address binding first, then the signature,
        # with the same VoteError messages (bit-identical to the scalar
        # path; asserted by tests/test_vote_batch.py).
        if val.pub_key.address() != val_addr:
            raise VoteError("invalid validator address")
        if not sigbatch.verify_vote_signature(
            val.pub_key, vote.sign_bytes(self.chain_id), vote.signature
        ):
            raise VoteError("invalid signature")
        added, conflicting = self._add_verified_vote(vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote)
        if not added:
            raise RuntimeError("Expected to add non-conflicting vote")
        return added

    def _get_vote(self, val_index: int, block_key: bytes) -> Vote | None:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(
        self, vote: Vote, block_key: bytes, voting_power: int
    ) -> tuple[bool, Vote | None]:
        val_index = vote.validator_index
        conflicting = None
        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise RuntimeError("addVerifiedVote does not expect duplicate votes")
            conflicting = existing
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power

        votes_by_block = self.votes_by_block.get(block_key)
        if votes_by_block is not None:
            if conflicting is not None and not votes_by_block.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                return False, conflicting
            votes_by_block = _BlockVotes(False, self.val_set.size())
            self.votes_by_block[block_key] = votes_by_block

        orig_sum = votes_by_block.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        votes_by_block.add_verified_vote(vote, voting_power)
        if orig_sum < quorum <= votes_by_block.sum:
            if self.maj23 is None:
                self.maj23 = vote.block_id
                for i, v in enumerate(votes_by_block.votes):
                    if v is not None:
                        self.votes[i] = v
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """vote_set.go:318-352."""
        with self._mtx:
            block_key = block_id.key()
            existing = self.peer_maj23s.get(peer_id)
            if existing is not None:
                if existing == block_id:
                    return
                raise VoteError(
                    f"setPeerMaj23: Received conflicting blockID from peer {peer_id}"
                )
            self.peer_maj23s[peer_id] = block_id
            votes_by_block = self.votes_by_block.get(block_key)
            if votes_by_block is not None:
                votes_by_block.peer_maj23 = True
            else:
                self.votes_by_block[block_key] = _BlockVotes(True, self.val_set.size())

    # -- queries --------------------------------------------------------------

    def bit_array(self) -> BitArray:
        with self._mtx:
            return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        with self._mtx:
            bv = self.votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv else None

    def get_by_index(self, val_index: int) -> Vote | None:
        with self._mtx:
            if val_index < 0 or val_index >= len(self.votes):
                return None
            return self.votes[val_index]

    def get_by_address(self, address: bytes) -> Vote | None:
        with self._mtx:
            idx, val = self.val_set.get_by_address(address)
            if val is None:
                return None
            return self.votes[idx]

    def list_votes(self) -> list[Vote]:
        with self._mtx:
            return [v for v in self.votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        with self._mtx:
            return self.maj23 is not None

    def is_commit(self) -> bool:
        from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE

        with self._mtx:
            return self.signed_msg_type == PRECOMMIT_TYPE and self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        with self._mtx:
            return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        with self._mtx:
            return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> tuple[BlockID | None, bool]:
        """(blockID, True) if 2/3 majority reached; blockID may be the zero
        BlockID for nil (vote_set.go:456-470)."""
        with self._mtx:
            if self.maj23 is not None:
                return self.maj23, True
            return None, False

    def make_commit(self) -> Commit:
        """vote_set.go:619-660: requires +2/3 precommits for a block."""
        from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE

        with self._mtx:
            if self.signed_msg_type != PRECOMMIT_TYPE:
                raise ValueError("Cannot MakeCommit() unless VoteSet.Type is PRECOMMIT_TYPE")
            if self.maj23 is None:
                raise ValueError("Cannot MakeCommit() unless a blockhash has +2/3")
            from cometbft_tpu_torch.types.block import CommitSig

            sigs = []
            for v in self.votes:
                cs = vote_to_commit_sig(v)
                # Votes for a different block than maj23 are excluded
                # (vote_set.go:635-638).
                if cs.for_block_flag() and v.block_id != self.maj23:
                    cs = CommitSig.absent()
                sigs.append(cs)
            return Commit(
                height=self.height,
                round=self.round,
                block_id=self.maj23,
                signatures=sigs,
            )
