"""One-block state rollback for the `rollback` CLI (state/rollback.go
Rollback), the port's copy of ``cometbft_tpu/state/rollback.py``: the same
state record from the same stores.

Overwrites state at height n with the state as of height n-1: the prior
block's header supplies LastBlockID/time, the validator-set triple shifts
back one step, and AppHash/LastResultsHash come from the latest block (they
are only agreed upon in the following block).
"""

from __future__ import annotations

from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.types.block import Consensus


def rollback_state(state_store, block_store) -> tuple[int, bytes]:
    """state/rollback.go:15-125. Returns (new_height, new_app_hash)."""
    invalid_state = state_store.load()
    if invalid_state is None or invalid_state.is_empty():
        raise ValueError("no state found")
    height = block_store.height()
    # Non-atomic persistence: the block store may be one ahead; the state is
    # already the one to keep (rollback.go:29-36).
    if height == invalid_state.last_block_height + 1:
        return invalid_state.last_block_height, invalid_state.app_hash
    if height != invalid_state.last_block_height:
        raise ValueError(
            f"statestore height ({invalid_state.last_block_height}) is not one below "
            f"or equal to blockstore height ({height})"
        )
    rollback_height = invalid_state.last_block_height - 1
    rollback_block = block_store.load_block_meta(rollback_height)
    if rollback_block is None:
        raise ValueError(f"block at height {rollback_height} not found")
    latest_block = block_store.load_block_meta(invalid_state.last_block_height)
    if latest_block is None:
        raise ValueError(f"block at height {invalid_state.last_block_height} not found")

    previous_last_validator_set = state_store.load_validators(rollback_height)
    previous_params = state_store.load_consensus_params(rollback_height + 1)

    val_change_height = invalid_state.last_height_validators_changed
    if val_change_height > rollback_height:
        val_change_height = rollback_height + 1
    params_change_height = invalid_state.last_height_consensus_params_changed
    if params_change_height > rollback_height:
        params_change_height = rollback_height + 1

    rolled = State(
        chain_id=invalid_state.chain_id,
        initial_height=invalid_state.initial_height,
        last_block_height=rollback_block.header.height,
        last_block_id=rollback_block.block_id,
        last_block_time=rollback_block.header.time,
        next_validators=invalid_state.validators,
        validators=invalid_state.last_validators,
        last_validators=previous_last_validator_set,
        last_height_validators_changed=val_change_height,
        consensus_params=previous_params,
        last_height_consensus_params_changed=params_change_height,
        last_results_hash=latest_block.header.last_results_hash,
        app_hash=latest_block.header.app_hash,
        version_consensus=Consensus(
            block=invalid_state.version_consensus.block,
            app=previous_params.version.app,
        ),
    )
    state_store.save(rolled)
    return rolled.last_block_height, rolled.app_hash
