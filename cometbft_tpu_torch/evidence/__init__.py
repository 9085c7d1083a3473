"""The evidence pool (evidence/ in CometBFT), the port's copy of
``cometbft_tpu/evidence``: verification, the pool and its gossip reactor."""

from cometbft_tpu_torch.evidence.pool import EvidencePool
from cometbft_tpu_torch.evidence.verify import verify_evidence

__all__ = ["EvidencePool", "verify_evidence"]
