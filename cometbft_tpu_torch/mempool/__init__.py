"""Mempool (mempool/ in CometBFT), the port's copy of ``cometbft_tpu/mempool``:
the ``CListMempool`` and the QoS ingress pipeline with its lanes."""

from cometbft_tpu_torch.mempool.clist_mempool import CListMempool, TxCache

__all__ = ["CListMempool", "TxCache", "IngressPipeline", "SignedTxEnvelope"]


def __getattr__(name):
    # Lazy: ingress pulls in crypto/backend modules; keep plain mempool
    # imports cheap for consumers that never touch admission.
    if name in ("IngressPipeline", "SignedTxEnvelope"):
        from cometbft_tpu_torch.mempool import ingress

        return getattr(ingress, name)
    raise AttributeError(name)
