"""sm.State: deterministic chain-state snapshot (state/state.go),
the port's copy of ``cometbft_tpu/state/state.py``.

Carries everything needed to validate the next block: the three validator
sets (last/current/next — the +1 delay from EndBlock updates), consensus
params, last block info, app hash, and last results hash.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield, replace

from cometbft_tpu_torch.types.block import Block, BlockID, Commit, Consensus, Data, Header
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet

BLOCK_PROTOCOL = 11  # version/version.go BlockProtocol


@dataclass
class State:
    """state/state.go:47-80."""

    chain_id: str = ""
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = dfield(default_factory=BlockID)
    last_block_time: Time = dfield(default_factory=Time)
    next_validators: ValidatorSet | None = None
    validators: ValidatorSet | None = None
    last_validators: ValidatorSet | None = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = dfield(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""
    version_consensus: Consensus = dfield(
        default_factory=lambda: Consensus(block=BLOCK_PROTOCOL, app=0)
    )

    def copy(self) -> "State":
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time=self.last_block_time,
            next_validators=self.next_validators.copy() if self.next_validators else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy() if self.last_validators else None,
            last_height_validators_changed=self.last_height_validators_changed,
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=self.last_height_consensus_params_changed,
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            version_consensus=self.version_consensus,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    def make_block(
        self,
        height: int,
        txs: list,
        last_commit: Commit | None,
        evidence: list,
        proposer_address: bytes,
    ) -> Block:
        """state/state.go:234-263 MakeBlock."""
        if height == self.initial_height:
            timestamp = self.last_block_time
        else:
            timestamp = median_time(last_commit, self.last_validators)
        from cometbft_tpu_torch.types.evidence import evidence_list_hash

        header = Header(
            version=self.version_consensus,
            chain_id=self.chain_id,
            height=height,
            time=timestamp,
            last_block_id=self.last_block_id,
            last_commit_hash=last_commit.hash() if last_commit else b"",
            data_hash=Data(txs=list(txs)).hash(),
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=evidence_list_hash(evidence),
            proposer_address=proposer_address,
        )
        block = Block(
            header=header,
            data=Data(txs=list(txs)),
            evidence=list(evidence),
            last_commit=last_commit,
        )
        return block


def median_time(commit: Commit, validators: ValidatorSet) -> Time:
    """Weighted median of commit timestamps by voting power
    (state/state.go:269-286 + types/time WeightedMedian): the median is the
    smallest timestamp t such that the power of signers with time <= t
    reaches half the counted total."""
    weighted: list[tuple[int, int]] = []  # (unix_nanos, power)
    total = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is not None:
            total += val.voting_power
            weighted.append((cs.timestamp.unix_nanos(), val.voting_power))
    weighted.sort()
    median = total // 2
    for nanos, power in weighted:
        if median <= power:
            return Time(nanos // 10**9, nanos % 10**9)
        median -= power
    return Time()


def make_genesis_state(gen_doc: GenesisDoc) -> State:
    """state/state.go MakeGenesisState."""
    err = _validate_genesis(gen_doc)
    if err:
        raise ValueError(err)
    if gen_doc.validators:
        vals = [Validator.new(v.pub_key, v.power) for v in gen_doc.validators]
        validator_set = ValidatorSet(vals)
        next_validator_set = validator_set.copy_increment_proposer_priority(1)
    else:
        validator_set = ValidatorSet()
        next_validator_set = ValidatorSet()
    return State(
        chain_id=gen_doc.chain_id,
        initial_height=gen_doc.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=gen_doc.genesis_time,
        next_validators=next_validator_set,
        validators=validator_set,
        last_validators=ValidatorSet(),
        last_height_validators_changed=gen_doc.initial_height,
        consensus_params=gen_doc.consensus_params,
        last_height_consensus_params_changed=gen_doc.initial_height,
        app_hash=gen_doc.app_hash,
    )


def _validate_genesis(gen_doc: GenesisDoc) -> str | None:
    if not gen_doc.chain_id:
        return "genesis doc must include non-empty chain_id"
    return None
