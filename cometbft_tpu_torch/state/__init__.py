"""The state execution layer (state/ in CometBFT), the port's copy of
``cometbft_tpu/state`` as far as blocksync runs it: the chain state,
``validate_block``, the state store and the block executor."""

from cometbft_tpu_torch.state.state import State, make_genesis_state, median_time
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.state.execution import BlockExecutor

__all__ = ["State", "StateStore", "BlockExecutor", "make_genesis_state", "median_time"]
