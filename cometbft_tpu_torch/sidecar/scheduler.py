"""Coalescing scheduler: the compat shim over the continuous-batching
engine.

Counterpart of ``cometbft_tpu/sidecar/scheduler.py``, copied. Concurrent
callers' requests merge into one columnar dispatch with within-batch
triple dedup, per-request bitmap slicing, and per-request retries when a
merged dispatch fails; the machinery is the engine's
(``sidecar/engine.py``), and this class embeds one. ``submit()`` returns a
``VerifyFuture``, ``batch_verify`` is submit and wait;
``CMTPU_COALESCE_WINDOW_MS`` maps onto the engine's compat hold and
``CMTPU_COALESCE_MAX`` pins the merge cap.

The sidecar server embeds this shim over its device lock
(``sidecar/service.py``): there the concurrent submitters are connections
and streamed chunks, so requests from many node processes merge into one
dispatch on the card.
"""

from __future__ import annotations

import os

from cometbft_tpu_torch.sidecar.backend import VerifyBackend
from cometbft_tpu_torch.sidecar.engine import (  # noqa: F401  (VerifyFuture: re-exported)
    VerificationEngine,
    VerifyFuture,
    _env_float,
)


class CoalescingScheduler(VerifyBackend):
    """Micro-batching front of the verification chain (module docstring)."""

    name = "coalesce"

    def __init__(
        self,
        inner: VerifyBackend,
        window_ms: float | None = None,
        max_sigs: int | None = None,
    ):
        if window_ms is None:
            window_ms = _env_float("CMTPU_COALESCE_WINDOW_MS", 2.0)
        if max_sigs is None and os.environ.get("CMTPU_COALESCE_MAX", ""):
            max_sigs = int(_env_float("CMTPU_COALESCE_MAX", 16384))
        # max_sigs None -> the engine derives its pod-width auto cap
        # (16384 x mesh width, grow-only via refresh_cap).
        self.engine = VerificationEngine(
            inner, hold_ms=window_ms, max_sigs=max_sigs
        )

    # -- engine views (no local copies: refresh_cap must never leave a
    # stale cap behind on the shim) ---------------------------------------

    @property
    def inner(self) -> VerifyBackend:
        return self.engine.inner

    @property
    def window_ms(self) -> float:
        return self.engine.hold_ms

    @window_ms.setter
    def window_ms(self, v: float) -> None:
        self.engine.hold_ms = v

    @property
    def max_sigs(self) -> int:
        return self.engine.max_sigs

    @max_sigs.setter
    def max_sigs(self, v: int) -> None:
        self.engine.max_sigs = v

    @property
    def counters_(self) -> dict:
        return self.engine.counters_

    # -- delegated surface -------------------------------------------------

    def submit(self, pubs, msgs, sigs) -> VerifyFuture:
        return self.engine.submit(pubs, msgs, sigs)

    def batch_verify(self, pubs, msgs, sigs):
        return self.engine.batch_verify(pubs, msgs, sigs)

    def aggregate_verify(self, pubs, msgs, agg_sig):
        return self.engine.aggregate_verify(pubs, msgs, agg_sig)

    def merkle_root(self, leaves):
        return self.engine.merkle_root(leaves)

    def mesh_width(self) -> int:
        return self.engine.mesh_width()

    def refresh_cap(self) -> int:
        return self.engine.refresh_cap()

    def ping(self):
        return self.engine.ping()

    def counters(self) -> dict:
        return self.engine.counters()

    def register_metrics(self, registry) -> None:
        self.engine.register_metrics(registry)

    def close(self) -> None:
        self.engine.close()
