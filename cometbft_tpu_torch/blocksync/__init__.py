"""Blocksync ("fast sync") — catch-up by downloading blocks from peers
(blocksync/ in CometBFT), the port's copy of ``cometbft_tpu/blocksync``."""

from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor

__all__ = ["BlockPool", "BlocksyncReactor"]
