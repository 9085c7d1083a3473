"""Node configuration (config/config.go), the port's copy of what the ported
modules read of ``cometbft_tpu/config/config.py``: ``MempoolConfig``, its
fields and defaults. The other sections wait for the node."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MempoolConfig:
    """config/config.go:640-720."""

    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = ""
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1048576
    max_batch_bytes: int = 0
    # QoS ingress (mempool/ingress.py, not ported); its CMTPU_INGRESS_* knobs
    # are read there.
    ingress_enable: bool = True
    ingress_lanes: int = 4
    ingress_sender_rps: float = 0.0  # 0 = per-sender rate limit off
    ingress_queue_max: int = 2048
    ingress_window_ms: float = 2.0
