"""Multi-host verification fan-out: one logical verifier across N sidecars.

Counterpart of ``cometbft_tpu/sidecar/fanout.py``, copied over the port's
tiers. Every lane-split path below this layer keys on one host's cards;
``FanoutBackend`` is the fleet seam: it makes N streaming sidecars (plus,
optionally, this host's own device tier) look like ONE wide
``VerifyBackend``. A merged columnar batch is split into contiguous
per-shard slices weighted by each shard's Ping-advertised mesh width, the
slices are dispatched concurrently over the chunk-stream protocol
(``sidecar/service.py``), and the bitmap is reassembled exactly: lane i of
the answer is lane i of the request, whichever host verified it.

Failure is handled per shard, not per fleet: a dead or wedged shard's slice
is redistributed across the surviving shards (ONE retry round) before the
error escapes to the supervisor, so one sick host costs a re-dispatch, not
the whole dispatch. Only when the retry round also fails, or no shard is
healthy at all, does the call raise and the supervised chain degrade to the
local tiers.

Width is a SUM here, not a max: the fleet's capacity is the total number of
cards behind all shards, and ``mesh_width()`` reports exactly that, so that
the engine's merge cap (16384 x width) and deadline sizing grow through the
combined fleet. The supervisor's chain-level ``mesh_width()`` takes the max
across tiers because its tiers are alternatives; the fanout's shards verify
concurrently, so within this tier the widths add.

Knobs (all read at construction):

* ``CMTPU_FANOUT_PEERS``: comma-separated ``host:port`` sidecars; setting it
  puts the fanout tier at the head of the supervised chain
  (``supervisor.build_chain``).
* ``CMTPU_FANOUT_DEADLINE_MS``: the per-round slice deadline before a shard
  is declared wedged and its slice redistributed (default
  ``CMTPU_DEADLINE_MS`` when set, else 30000). Each of the two rounds gets
  a fresh window.
* ``CMTPU_FANOUT_COOLDOWN_MS``: how long a failed shard sits out before the
  next dispatch tries it again (default 5000; the dispatch itself is the
  probe, as in the supervisor's half-open protocol).
"""

from __future__ import annotations

import os
import threading
import time

from cometbft_tpu_torch.sidecar.backend import CARD_SIGS_PER_MS, VerifyBackend
from cometbft_tpu_torch.sidecar.engine import _env_float

# The fixed cost of one fleet dispatch for the engine's dispatch-wall model:
# the intercept of the fleet's walls at 1,024 and 10,240 signatures, the
# mean of three runs of chip_smoke.py's fanout phase (PERF.md §5: 14.10,
# 11.86 and 16.95 ms) with two port sidecars, one in another process, and
# the local hybrid, all on one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit. So it holds the sidecar round trip and the card's own fixed cost.
# The per-card rate is the card's, CARD_SIGS_PER_MS.
FANOUT_DISPATCH_MS = 14.3  # CMTPU_DEV_OVERHEAD_MS


class ShardFailed(Exception):
    """A shard slice got no (usable) answer this round."""


class _Shard:
    """One member of the fleet: a remote GrpcBackend or the local tier."""

    def __init__(self, name: str, backend: VerifyBackend):
        self.name = name
        self.backend = backend
        self.width = 1  # last known; refreshed from ping/mesh_width
        self.down_until = 0.0
        self.calls = 0
        self.failures = 0
        self.last_error = ""

    def healthy(self, now: float) -> bool:
        return now >= self.down_until

    def read_width(self) -> int:
        """Cached-width read; never dials (GrpcBackend.mesh_width returns
        the width the last Ping capability reply advertised)."""
        mw = getattr(self.backend, "mesh_width", None)
        if mw is not None:
            try:
                self.width = max(1, int(mw()))
            except Exception:
                pass
        return self.width


class FanoutBackend(VerifyBackend):
    """N sidecar shards (plus the local tier) as one wide VerifyBackend."""

    name = "fanout"

    def __init__(
        self,
        shards: list[tuple[str, VerifyBackend]],
        deadline_ms: float | None = None,
        cooldown_ms: float | None = None,
    ):
        if not shards:
            raise ValueError("FanoutBackend needs at least one shard")
        self.shards = [_Shard(n, b) for n, b in shards]
        if deadline_ms is None:
            deadline_ms = _env_float(
                "CMTPU_FANOUT_DEADLINE_MS",
                _env_float("CMTPU_DEADLINE_MS", 0.0) or 30000.0,
            )
        self.deadline_ms = max(1.0, deadline_ms)
        self.cooldown_ms = (
            _env_float("CMTPU_FANOUT_COOLDOWN_MS", 5000.0)
            if cooldown_ms is None
            else cooldown_ms
        )
        self._lock = threading.Lock()
        self._probed = False
        self.counters_ = {
            "dispatches": 0,
            "shard_calls": 0,
            "shard_failures": 0,
            "redistributions": 0,
            "redistributed_sigs": 0,
        }
        # The engine's rate-model seam (duck-typed like HybridBackend's): the
        # fleet dispatches slices concurrently, so its throughput is the
        # per-card rate x the total card count behind all shards.
        self._dev_rate = _env_float("CMTPU_DEV_RATE", CARD_SIGS_PER_MS)
        self._dev_overhead = _env_float("CMTPU_DEV_OVERHEAD_MS", FANOUT_DISPATCH_MS)

    @property
    def _n_dev(self) -> int:
        return self.mesh_width()

    # -- fleet shape -------------------------------------------------------

    def mesh_width(self) -> int:
        """SUM of shard widths (module docstring). Cached widths only;
        nothing is dialed from here."""
        return sum(max(1, s.width) for s in self.shards)

    def shard_widths(self) -> dict[str, int]:
        return {s.name: max(1, s.width) for s in self.shards}

    def refresh_widths(self, dial: bool = True) -> None:
        """Learn each shard's width. With ``dial``, shards that speak
        ``ping`` are pinged concurrently (the Ping capability reply is where
        a sidecar advertises its mesh width); failures put the shard on
        cooldown instead of raising. Without, only cached widths move."""
        if not dial:
            for s in self.shards:
                s.read_width()
            return

        def probe(s: _Shard) -> None:
            ping = getattr(s.backend, "ping", None)
            try:
                if ping is not None and not ping():
                    raise ConnectionError("ping returned false")
            except Exception as e:
                self._mark_failure(s, e)
            else:
                s.down_until = 0.0
            s.read_width()

        threads = [
            threading.Thread(target=probe, args=(s,), daemon=True)
            for s in self.shards
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.deadline_ms / 1000.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._probed = True

    def _mark_failure(self, shard: _Shard, err: BaseException) -> None:
        with self._lock:
            shard.failures += 1
            shard.last_error = f"{type(err).__name__}: {err}"
            shard.down_until = time.monotonic() + self.cooldown_ms / 1000.0
            self.counters_["shard_failures"] += 1

    # -- slicing -----------------------------------------------------------

    def _split(self, lo: int, hi: int, shards: list[_Shard]):
        """Contiguous sub-slices of [lo, hi) weighted by shard width. The
        last shard absorbs rounding; empty slices are dropped (a fleet wider
        than the batch leaves the narrow shards idle)."""
        n = hi - lo
        total = sum(max(1, s.width) for s in shards)
        out, start, acc = [], lo, 0
        for i, s in enumerate(shards):
            acc += max(1, s.width)
            end = hi if i == len(shards) - 1 else lo + (n * acc) // total
            if end > start:
                out.append((s, start, end))
            start = end
        return out

    def _run_round(self, tasks, pubs, msgs, sigs, bits):
        """Dispatch every (shard, lo, hi) slice concurrently; fill ``bits``
        in place; return the slices that got no usable answer within this
        round's deadline. A thread past the deadline is abandoned, not
        joined: its shard sits out the cooldown and any late answer is
        discarded with the thread."""
        results: list = [None] * len(tasks)

        def call(i: int, shard: _Shard, lo: int, hi: int) -> None:
            try:
                ok, slice_bits = shard.backend.batch_verify(
                    pubs[lo:hi], msgs[lo:hi], sigs[lo:hi]
                )
                if len(slice_bits) != hi - lo:
                    raise ShardFailed(
                        f"shard {shard.name}: {len(slice_bits)} bits "
                        f"for a {hi - lo}-lane slice"
                    )
                results[i] = list(slice_bits)
            except BaseException as e:
                results[i] = e

        threads = []
        for i, (shard, lo, hi) in enumerate(tasks):
            with self._lock:
                shard.calls += 1
                self.counters_["shard_calls"] += 1
            t = threading.Thread(
                target=call, args=(i, shard, lo, hi), daemon=True,
                name=f"fanout-{shard.name}",
            )
            t.start()
            threads.append(t)
        deadline = time.monotonic() + self.deadline_ms / 1000.0
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        failed = []
        for (shard, lo, hi), res in zip(tasks, results):
            if isinstance(res, list):
                bits[lo:hi] = res
                shard.down_until = 0.0
            else:
                err = res if isinstance(res, BaseException) else (
                    TimeoutError(f"no answer within {self.deadline_ms:.0f} ms")
                )
                self._mark_failure(shard, err)
                failed.append((shard, lo, hi, err))
        return failed

    # -- VerifyBackend surface ---------------------------------------------

    def batch_verify(self, pubs, msgs, sigs):
        n = len(pubs)
        if n == 0:
            return False, []
        if not self._probed:
            self.refresh_widths()
        with self._lock:
            self.counters_["dispatches"] += 1
        now = time.monotonic()
        live = [s for s in self.shards if s.healthy(now)]
        if not live:
            raise ConnectionError(
                "fanout: no healthy shard "
                f"({', '.join(s.name for s in self.shards)} all cooling down)"
            )
        bits: list = [False] * n
        tasks = self._split(0, n, live)
        failed = self._run_round(tasks, pubs, msgs, sigs, bits)
        if failed:
            # Redistribute the dead shards' slices across the survivors: one
            # retry round, then the supervisor takes over.
            bad = {id(s) for s, *_ in failed}
            survivors = [s for s in live if id(s) not in bad]
            if survivors:
                with self._lock:
                    self.counters_["redistributions"] += 1
                    self.counters_["redistributed_sigs"] += sum(
                        hi - lo for _, lo, hi, _ in failed
                    )
                retry_tasks = []
                for _, lo, hi, _ in failed:
                    retry_tasks.extend(self._split(lo, hi, survivors))
                failed = self._run_round(retry_tasks, pubs, msgs, sigs, bits)
        if failed:
            shard, lo, hi, err = failed[0]
            raise ConnectionError(
                f"fanout: {len(failed)} slice(s) unserved after "
                f"redistribution (shard {shard.name}, lanes "
                f"[{lo}:{hi}]): {err}"
            )
        return all(bits), bits

    def merkle_root(self, leaves):
        """One tree a call, no slicing: served from the first healthy
        shard, walking on failure."""
        now = time.monotonic()
        last: BaseException | None = None
        ordered = [s for s in self.shards if s.healthy(now)] or self.shards
        for shard in ordered:
            with self._lock:
                shard.calls += 1
                self.counters_["shard_calls"] += 1
            try:
                root = shard.backend.merkle_root(leaves)
            except Exception as e:
                last = e
                self._mark_failure(shard, e)
                continue
            shard.down_until = 0.0
            return root
        raise ConnectionError("fanout: merkle_root failed on every shard") from last

    def ping(self) -> bool:
        """Fleet probe: refresh widths (dialing); true when ANY shard is up,
        since the fanout can serve with survivors."""
        self.refresh_widths(dial=True)
        now = time.monotonic()
        return any(s.healthy(now) for s in self.shards)

    def counters(self) -> dict:
        with self._lock:
            out = dict(self.counters_)
        out["mesh_width"] = self.mesh_width()
        out["shards"] = {
            s.name: {
                "width": max(1, s.width),
                "calls": s.calls,
                "failures": s.failures,
                "down": not s.healthy(time.monotonic()),
                "last_error": s.last_error,
            }
            for s in self.shards
        }
        return out

    def close(self) -> None:
        for s in self.shards:
            close = getattr(s.backend, "close", None)
            if close is not None:
                try:
                    close()
                except OSError:
                    pass


def fanout_peers() -> list[str]:
    """The ``CMTPU_FANOUT_PEERS`` fleet, parsed."""
    raw = os.environ.get("CMTPU_FANOUT_PEERS", "").strip()
    return [p.strip() for p in raw.split(",") if p.strip()]


def build_fanout(local: VerifyBackend | None = None) -> FanoutBackend | None:
    """The fleet tier ``supervisor.build_chain`` puts at the head of the
    chain when ``CMTPU_FANOUT_PEERS`` names peers: one port ``GrpcBackend``
    shard a peer, plus this host's own device tier (the hybrid) as the
    ``local`` shard, whose cards count toward the fleet width and whose
    slice rides the same concurrent dispatch. None without peers."""
    peers = fanout_peers()
    if not peers:
        return None
    from cometbft_tpu_torch.sidecar.service import GrpcBackend

    deadline_ms = _env_float(
        "CMTPU_FANOUT_DEADLINE_MS",
        _env_float("CMTPU_DEADLINE_MS", 0.0) or 30000.0,
    )
    shards: list[tuple[str, VerifyBackend]] = [
        (f"peer{i}", GrpcBackend(addr, timeout_s=deadline_ms / 1000.0))
        for i, addr in enumerate(peers)
    ]
    if local is not None:
        shards.append(("local", local))
    return FanoutBackend(shards)
