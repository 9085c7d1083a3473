"""Header-vs-state validation (state/validation.go), the port's
copy of ``cometbft_tpu/state/validation.py``.

validate_block is the call site that batch-verifies every applied block's
LastCommit through the process's verify backend (state/validation.go:92
LastValidators.VerifyCommit).
"""

from __future__ import annotations

from cometbft_tpu_torch.state.state import State, median_time
from cometbft_tpu_torch.types.block import Block


def validate_block(state: State, block: Block) -> None:
    """state/validation.go:15-150."""
    block.validate_basic()
    # Header-vs-state checks.
    h = block.header
    if h.version != state.version_consensus:
        raise ValueError(
            f"wrong Block.Header.Version. Expected {state.version_consensus}, got {h.version}"
        )
    if h.chain_id != state.chain_id:
        raise ValueError(
            f"wrong Block.Header.ChainID. Expected {state.chain_id}, got {h.chain_id}"
        )
    if state.last_block_height == 0 and h.height != state.initial_height:
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.initial_height} (initial height), got {h.height}"
        )
    if state.last_block_height > 0 and h.height != state.last_block_height + 1:
        raise ValueError(
            f"wrong Block.Header.Height. Expected {state.last_block_height + 1}, got {h.height}"
        )
    if h.last_block_id != state.last_block_id:
        raise ValueError(
            f"wrong Block.Header.LastBlockID. Expected {state.last_block_id}, got {h.last_block_id}"
        )
    if h.app_hash != state.app_hash:
        raise ValueError(
            f"wrong Block.Header.AppHash. Expected {state.app_hash.hex().upper()}, got {h.app_hash.hex()}"
        )
    if h.consensus_hash != state.consensus_params.hash():
        raise ValueError("wrong Block.Header.ConsensusHash")
    if h.last_results_hash != state.last_results_hash:
        raise ValueError("wrong Block.Header.LastResultsHash")
    if h.validators_hash != state.validators.hash():
        raise ValueError("wrong Block.Header.ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise ValueError("wrong Block.Header.NextValidatorsHash")

    # LastCommit — the batched device path (state/validation.go:86-97).
    if h.height == state.initial_height:
        if block.last_commit and len(block.last_commit.signatures) != 0:
            raise ValueError("initial block can't have LastCommit signatures")
    else:
        state.last_validators.verify_commit(
            state.chain_id, state.last_block_id, h.height - 1, block.last_commit
        )

    if len(h.proposer_address) != 20:
        raise ValueError(
            f"expected ProposerAddress size 20, got {len(h.proposer_address)}"
        )
    if not state.validators.has_address(h.proposer_address):
        raise ValueError(
            f"block.Header.ProposerAddress {h.proposer_address.hex().upper()} is not a validator"
        )

    # Block time (state/validation.go:113-140).
    if h.height > state.initial_height:
        if not h.time.after(state.last_block_time):
            raise ValueError(
                f"block time {h.time} not greater than last block time {state.last_block_time}"
            )
        expected = median_time(block.last_commit, state.last_validators)
        if h.time != expected:
            raise ValueError(f"invalid block time. Expected {expected}, got {h.time}")
    elif h.height == state.initial_height:
        if h.time != state.last_block_time:
            raise ValueError(
                f"block time {h.time} is not equal to genesis time {state.last_block_time}"
            )
    else:
        raise ValueError(
            f"block height {h.height} lower than initial height {state.initial_height}"
        )

    # Evidence size cap.
    ev_bytes = sum(len(ev.bytes()) for ev in block.evidence)
    if ev_bytes > state.consensus_params.evidence.max_bytes:
        raise ValueError(
            f"total evidence in block = {ev_bytes}B, max = {state.consensus_params.evidence.max_bytes}B"
        )
