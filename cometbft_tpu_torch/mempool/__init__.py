"""Mempool (mempool/ in CometBFT), the port's copy of the ``CListMempool`` of
``cometbft_tpu/mempool``. The QoS ingress pipeline and its lanes are not
ported yet."""

from cometbft_tpu_torch.mempool.clist_mempool import CListMempool, TxCache

__all__ = ["CListMempool", "TxCache"]
