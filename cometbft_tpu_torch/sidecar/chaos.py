"""Deterministic fault injection for verification backends.

Counterpart of ``cometbft_tpu/sidecar/chaos.py``, copied. ``ChaosBackend``
wraps any ``VerifyBackend`` tier and injects failures drawn from a seeded
RNG, so tests and the chip check can show the supervisor's behaviour
(deadlines fire, breakers trip, the degradation chain serves a correct
result) instead of waiting for a real fault. The classes are a slow call,
an error, a wedged call, and the one failure a resilience layer must never
pass through silently: a device computing garbage *accepts*.

Env spec (``CMTPU_FAULTS``), comma-separated, each ``kind:probability[:ms]``:

    latency:p:ms   with probability p, sleep ms before the call
    error:p        with probability p, raise ConnectionError
    wedge:p[:ms]   with probability p, hang for ms (default 300000 —
                   "forever" at deadline scale) before answering
    flip:p         with probability p, corrupt batch_verify's result into
                   a false-accept (ok=True, all-True bitmap) — the
                   bit-flip a cpu cross-check must catch

Determinism: the same (spec, seed) wrapping the same call sequence injects
the same faults — ``random.Random(seed)`` drives every draw, no clock is
involved — so a failing chaos run reproduces from its seed.
"""

from __future__ import annotations

import os
import random
import threading
import time

from cometbft_tpu_torch.sidecar.backend import VerifyBackend

# "Forever" at per-call-deadline scale, but bounded so a wedged test
# process still unwinds.
_DEFAULT_WEDGE_MS = 300_000.0

_KINDS = ("latency", "error", "wedge", "flip")


class FaultSpecError(ValueError):
    pass


def parse_faults(spec: str) -> dict[str, tuple[float, float]]:
    """`latency:p:ms,error:p,...` -> {kind: (probability, ms)}.

    ms is meaningful for latency/wedge only; error/flip reject a third
    field loudly (a silently ignored knob reads as coverage that isn't).
    """
    faults: dict[str, tuple[float, float]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        fields = part.split(":")
        kind = fields[0]
        if kind not in _KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r} (want {_KINDS})")
        try:
            prob = float(fields[1])
        except (IndexError, ValueError):
            raise FaultSpecError(f"fault {part!r}: want {kind}:probability") from None
        if not 0.0 <= prob <= 1.0:
            raise FaultSpecError(f"fault {part!r}: probability outside [0, 1]")
        ms = None
        if len(fields) >= 3:
            if kind not in ("latency", "wedge"):
                raise FaultSpecError(f"fault {part!r}: {kind} takes no duration")
            ms = float(fields[2])
        if len(fields) > 3:
            raise FaultSpecError(f"fault {part!r}: too many fields")
        if kind == "latency" and ms is None:
            raise FaultSpecError(f"fault {part!r}: latency needs latency:p:ms")
        if kind == "wedge" and ms is None:
            ms = _DEFAULT_WEDGE_MS
        faults[kind] = (prob, ms if ms is not None else 0.0)
    return faults


def faults_from_env() -> dict[str, tuple[float, float]] | None:
    spec = os.environ.get("CMTPU_FAULTS", "").strip()
    return parse_faults(spec) if spec else None


def wrap_tiers_from_env(tiers: list[tuple[str, VerifyBackend]]) -> list[tuple[str, VerifyBackend]]:
    """Each ``(name, backend)`` wrapped in a ChaosBackend when
    ``CMTPU_FAULTS`` names faults, seeded from ``CMTPU_FAULTS_SEED`` plus
    the tier's position; the tiers as they are otherwise. The chain
    builders pass every tier but the anchor."""
    faults = faults_from_env()
    if not faults:
        return tiers
    try:
        seed = int(float(os.environ.get("CMTPU_FAULTS_SEED", "") or 0))
    except ValueError:
        seed = 0
    return [(name, ChaosBackend(b, faults, seed=seed + i)) for i, (name, b) in enumerate(tiers)]


class ChaosBackend(VerifyBackend):
    """A `VerifyBackend` (or sidecar client) with seeded fault injection.

    Transparent when healthy: delegates `batch_verify`/`merkle_root` (and
    `ping`, when the inner tier has one — so half-open probes see the same
    weather as real calls).  The draw order is fixed per call —
    latency, error, wedge, then flip on the result — so a spec's faults
    compose deterministically under one seed.
    """

    def __init__(self, inner: VerifyBackend, spec: str | dict, seed: int = 0):
        self.inner = inner
        self.name = f"chaos({inner.name})"
        self.faults = parse_faults(spec) if isinstance(spec, str) else dict(spec)
        self.seed = seed
        self._rng = random.Random(seed)
        # One draw stream shared by every calling thread: the lock keeps
        # the stream itself deterministic; cross-thread interleaving is
        # the caller's to pin (single-threaded tests, or per-tier workers).
        self._rng_lock = threading.Lock()
        self.injected: dict[str, int] = {k: 0 for k in _KINDS}

    def _draw(self, kind: str) -> tuple[bool, float]:
        prob, ms = self.faults.get(kind, (0.0, 0.0))
        if prob <= 0.0:
            return False, ms
        with self._rng_lock:
            hit = self._rng.random() < prob
        if hit:
            self.injected[kind] += 1
        return hit, ms

    def _pre_call(self) -> None:
        hit, ms = self._draw("latency")
        if hit:
            time.sleep(ms / 1000.0)
        hit, _ = self._draw("error")
        if hit:
            raise ConnectionError(f"chaos: injected error ({self.name})")
        hit, ms = self._draw("wedge")
        if hit:
            time.sleep(ms / 1000.0)

    def batch_verify(self, pubs, msgs, sigs):
        self._pre_call()
        ok, bits = self.inner.batch_verify(pubs, msgs, sigs)
        hit, _ = self._draw("flip")
        if hit:
            # The dangerous corruption: a FALSE-ACCEPT. A degraded device
            # reporting all-valid for a batch that isn't must be caught by
            # the supervisor's cpu cross-check, never served.
            return True, [True] * len(pubs)
        return ok, bits

    def aggregate_verify(self, pubs, msgs, agg_sig):
        self._pre_call()
        ok = self.inner.aggregate_verify(pubs, msgs, agg_sig)
        hit, _ = self._draw("flip")
        if hit:
            # An aggregate verdict is ONE boolean, so the false-accept
            # corruption is a plain inversion-to-True; the supervisor's
            # anchor recompute must catch it (there is no per-lane sample
            # granularity to catch it cheaper).
            return True
        return ok

    def merkle_root(self, leaves):
        self._pre_call()
        return self.inner.merkle_root(leaves)

    def ping(self):
        self._pre_call()
        inner_ping = getattr(self.inner, "ping", None)
        return inner_ping() if inner_ping is not None else True

    def mesh_width(self) -> int:
        # Shape, not weather: the supervisor's cap sizing must see the
        # wrapped tier's real width (a chaos-wrapped fanout fleet still
        # has the fleet's chips), so no fault draw here.
        mw = getattr(self.inner, "mesh_width", None)
        return int(mw()) if mw is not None else 1

    def counters(self) -> dict:
        inner_counters = getattr(self.inner, "counters", None)
        out = dict(inner_counters()) if inner_counters is not None else {}
        out["chaos_injected"] = dict(self.injected)
        return out

    def close(self):
        inner_close = getattr(self.inner, "close", None)
        if inner_close is not None:
            inner_close()
