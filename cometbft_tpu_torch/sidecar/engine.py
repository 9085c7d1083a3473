"""Continuous-batching verification engine.

Counterpart of ``cometbft_tpu/sidecar/engine.py``, copied: the one engine
the sidecar server's coalescer embeds, run the way inference servers run
their device (continuous batching):

* There is no window-then-dispatch. The dispatcher sizes the next dispatch
  from whatever is queued the moment the device frees up. (A compat hold,
  ``hold_ms``, keeps the window-from-first-waiter behaviour for the
  ``CoalescingScheduler`` shim; the engine default is 0.)
* Requests carry a priority class (consensus votes > blocksync > ingress
  preverify > light clients), drained strict-priority with a starvation
  escape hatch: a request older than ``CMTPU_ENGINE_STARVATION_MS`` is
  promoted ahead of fresher higher-class work.
* Dispatch sizing is deadline-aware: a queued consensus request caps how
  large the merged dispatch may grow, from a rate model (sigs/ms x chips +
  fixed overhead) of the dispatch's wall time.
* The engine dispatches through the backend it wraps, with the columnar
  pack, within-batch dedup and per-request bitmap slicing of a merged
  dispatch, and splits a failed merged dispatch into per-request retries
  so a poisoned request errors alone.

Callers tag their class explicitly (``engine.submit(..., klass=...)``) or
with ``submission_class(...)``, a thread-local. Untagged traffic is
blocksync-class.

Knobs: ``CMTPU_ENGINE_HOLD_MS`` (compat hold, default 0),
``CMTPU_ENGINE_MAX`` (merge cap, default 16384 x mesh width, the auto cap
grows only, through ``refresh_cap``), ``CMTPU_ENGINE_STARVATION_MS``
(promotion age, default 100), ``CMTPU_ENGINE_DEADLINE_MS`` (consensus
admission deadline, default ``CMTPU_DEADLINE_MS`` else 50),
``CMTPU_ENGINE_RATE`` / ``CMTPU_ENGINE_OVERHEAD_MS`` (the dispatch-wall
model when the wrapped backend carries no rates).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from cometbft_tpu_torch.sidecar.backend import CARD_DISPATCH_MS, CARD_SIGS_PER_MS, VerifyBackend

# Priority classes, drained strict-priority (lower value wins).
CLASS_CONSENSUS = 0  # vote admission / commit verification on the hot path
CLASS_BLOCKSYNC = 1  # block-window pre-verify, untagged legacy callers
CLASS_INGRESS = 2    # mempool envelope preverify
CLASS_LIGHT = 3      # light-client speculative prewarm

CLASS_NAMES = ("consensus", "blocksync", "ingress", "light")
_N_CLASSES = len(CLASS_NAMES)

_WAIT_SAMPLES = 512  # admission-wait ring buffer (p50/p95 source)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _mesh_width_for_cap() -> int:
    """Device count behind the default dispatch cap (16384 x width): the
    port's kernel module's width when it is loaded, else 1 (no import of
    the device stack from this constructor)."""
    ek = sys.modules.get("cometbft_tpu_torch.ops.ed25519_kernel")
    return ek.mesh_width() if ek is not None else 1


# -- ambient class tagging ----------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def submission_class(klass: int):
    """Tag every engine submission made on this thread inside the block.

    This is how surfaces that reach the engine through BatchVerifier and
    the backend chain (ingress, gateway, blocksync) declare their class
    without threading a parameter through crypto-layer APIs."""
    prev = getattr(_tls, "klass", None)
    _tls.klass = klass
    try:
        yield
    finally:
        _tls.klass = prev


def current_class() -> int:
    """The class this thread's submissions carry: the port's own tag, else
    the JAX package's (a reference surface tags requests with that
    package's ``submission_class``), read through its engine module only
    when ``sys.modules`` already holds it; else blocksync. The class
    numbers are the same in both packages."""
    k = getattr(_tls, "klass", None)
    if k is None:
        ref = sys.modules.get("cometbft_tpu.sidecar.engine")
        if ref is not None:
            k = getattr(ref._tls, "klass", None)
    return CLASS_BLOCKSYNC if k is None else k


class VerifyFuture:
    """Result slot a submitter blocks on; filled by the dispatcher.

    `shared` reports (after resolution) whether the request rode a merged
    dispatch — surfaces use it for their legacy "batched" counters."""

    __slots__ = ("_event", "_result", "_error", "t_submit", "n_sigs", "shared")

    def __init__(self, n_sigs: int):
        self._event = threading.Event()
        self._result: tuple[bool, list[bool]] | None = None
        self._error: BaseException | None = None
        self.t_submit = time.perf_counter()
        self.n_sigs = n_sigs
        self.shared = False

    def _set_result(self, result: tuple[bool, list[bool]]) -> None:
        self._result = result
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> tuple[bool, list[bool]]:
        if not self._event.wait(timeout):
            raise TimeoutError("verification future not resolved in time")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("pubs", "msgs", "sigs", "future", "klass", "deadline", "t_start")

    def __init__(self, pubs, msgs, sigs, future, klass, deadline):
        self.pubs = pubs
        self.msgs = msgs
        self.sigs = sigs
        self.future = future
        self.klass = klass
        self.deadline = deadline  # absolute perf_counter deadline or None
        self.t_start = 0.0  # set when the dispatcher picks it up


class VerificationEngine(VerifyBackend):
    """Continuous-batching front of the verification chain (module docstring)."""

    name = "engine"

    def __init__(
        self,
        inner: VerifyBackend,
        hold_ms: float | None = None,
        max_sigs: int | None = None,
        starvation_ms: float | None = None,
        deadline_ms: float | None = None,
    ):
        self.inner = inner
        # Compat hold: the round-6 window-from-first-waiter, kept for the
        # CoalescingScheduler shim. 0 = true continuous batching.
        self.hold_ms = (
            _env_float("CMTPU_ENGINE_HOLD_MS", 0.0)
            if hold_ms is None
            else hold_ms
        )
        self.starvation_ms = (
            _env_float("CMTPU_ENGINE_STARVATION_MS", 100.0)
            if starvation_ms is None
            else starvation_ms
        )
        # Consensus admission deadline: a queued vote must be RESOLVED
        # within this budget, so it caps merged-dispatch growth. Derived
        # from the supervisor's per-call deadline when one is configured.
        if deadline_ms is None:
            deadline_ms = _env_float(
                "CMTPU_ENGINE_DEADLINE_MS",
                _env_float("CMTPU_DEADLINE_MS", 0.0) or 50.0,
            )
        self.consensus_deadline_ms = deadline_ms
        self._cap_auto = False
        if max_sigs is not None:
            self.max_sigs = max_sigs
        elif os.environ.get("CMTPU_ENGINE_MAX", ""):
            self.max_sigs = int(_env_float("CMTPU_ENGINE_MAX", 16384))
        else:
            # Pod-width default: one merged dispatch can fill every chip
            # (16384 lanes each). An explicit env or arg always wins. The
            # auto cap re-reads the chain's width periodically
            # (refresh_cap) because the width a grpc tier serves is only
            # learned from the sidecar's Ping capability reply AFTER the
            # first connect.
            self._cap_auto = True
            self.max_sigs = 16384 * max(1, _mesh_width_for_cap())
        self._queues: list[list[_Request]] = [[] for _ in range(_N_CLASSES)]
        self._cond = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None
        self._wait_ms: list[float] = []  # aggregate admission-wait ring
        self._wait_i = 0
        self._class_wait: list[list[float]] = [[] for _ in range(_N_CLASSES)]
        self._class_wait_i = [0] * _N_CLASSES
        self._rate_cache: tuple[float, float] | None = None
        self.counters_ = {
            "requests": 0,
            "dispatches": 0,
            "coalesced_dispatches": 0,  # dispatches carrying >1 request
            "batched_requests": 0,      # requests that shared a dispatch
            "coalesced_sigs": 0,        # sigs that rode a shared dispatch
            "dedup_sigs": 0,            # lanes saved by within-batch dedup
            "fallback_splits": 0,       # coalesced dispatches split on error
        }
        self.class_counters_ = [
            {"admitted": 0, "dispatched_sigs": 0, "starvation_promotions": 0}
            for _ in range(_N_CLASSES)
        ]

    # -- submission surface ------------------------------------------------

    def submit(
        self,
        pubs,
        msgs,
        sigs,
        klass: int | None = None,
        deadline_ms: float | None = None,
    ) -> VerifyFuture:
        """Enqueue one verification request; returns the future its caller
        blocks on.  Raises after close() — an engine with no dispatcher
        must fail loudly, not hang the submitter forever."""
        if klass is None:
            klass = current_class()
        klass = min(max(int(klass), 0), _N_CLASSES - 1)
        fut = VerifyFuture(len(pubs))
        if not pubs:
            fut._set_result((False, []))
            return fut
        if deadline_ms is None and klass == CLASS_CONSENSUS:
            deadline_ms = self.consensus_deadline_ms
        deadline = (
            fut.t_submit + deadline_ms / 1000.0
            if deadline_ms and deadline_ms > 0
            else None
        )
        req = _Request(list(pubs), list(msgs), list(sigs), fut, klass, deadline)
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            self.counters_["requests"] += 1
            self.class_counters_[klass]["admitted"] += 1
            self._queues[klass].append(req)
            self._ensure_thread()
            self._cond.notify_all()
        return fut

    def batch_verify(self, pubs, msgs, sigs):
        return self.submit(pubs, msgs, sigs).result()

    def aggregate_verify(self, pubs, msgs, agg_sig):
        # One boolean per whole commit: nothing to slice across callers;
        # pass straight through to the supervised chain.
        return self.inner.aggregate_verify(pubs, msgs, agg_sig)

    def merkle_root(self, leaves):
        # Roots carry no cross-caller coalescing opportunity (one tree per
        # call); pass straight through to the chain.
        return self.inner.merkle_root(leaves)

    def mesh_width(self) -> int:
        mw = getattr(self.inner, "mesh_width", None)
        return int(mw()) if mw is not None else 1

    def refresh_cap(self) -> int:
        """Re-derive the auto merge cap from the chain's CURRENT width
        (local chips, or a remote pod's once the sidecar Ping capability
        reply has been seen). Grow-only; pinned caps (arg/env) never move."""
        if self._cap_auto:
            try:
                width = max(1, self.mesh_width())
            except Exception:
                return self.max_sigs
            new_cap = 16384 * width
            if new_cap > self.max_sigs:
                self.max_sigs = new_cap
                # The width grew (a sidecar Ping reply arrived, a fanout
                # fleet came up): the dispatch-wall model must re-read
                # rates at the new device count or deadline sizing keeps
                # pricing the old, narrower chain.
                self._rate_cache = None
        return self.max_sigs

    def ping(self):
        inner_ping = getattr(self.inner, "ping", None)
        return inner_ping() if inner_ping is not None else True

    # -- dispatch-wall model -----------------------------------------------

    def _rate_model(self) -> tuple[float, float]:
        """(sigs/ms, fixed overhead ms) for one dispatch through the chain,
        read from the hybrid planner's EMA-calibrated rates when a hybrid
        tier is present (duck-typed walk — chain shapes vary by backend
        knob), else the env/default model."""
        cached = self._rate_cache
        if cached is not None:
            return cached
        # Without a hybrid tier: the card's dispatch cost, measured on it.
        rate = _env_float("CMTPU_ENGINE_RATE", CARD_SIGS_PER_MS)
        overhead = _env_float("CMTPU_ENGINE_OVERHEAD_MS", CARD_DISPATCH_MS)
        stack = [self.inner]
        seen: set[int] = set()
        while stack:
            b = stack.pop()
            if b is None or id(b) in seen:
                continue
            seen.add(id(b))
            if hasattr(b, "_dev_rate") and hasattr(b, "_n_dev"):
                rate = float(b._dev_rate) * max(1, int(b._n_dev))
                overhead = float(getattr(b, "_dev_overhead", overhead))
                break
            # LIFO stack: push tiers reversed so the CHAIN-ORDER head pops
            # first — a fanout fleet tier must price the dispatch, not the
            # narrower hybrid tier sitting below it in the chain.
            for t in reversed(getattr(b, "tiers", ()) or ()):
                stack.append(getattr(t, "backend", None))
            stack.append(getattr(b, "inner", None))
        model = (max(rate, 1e-6), max(overhead, 0.0))
        self._rate_cache = model
        return model

    def _deadline_cap(self, now: float) -> int:
        """How many signatures the NEXT dispatch may carry without driving
        a queued consensus request past its admission deadline: predicted
        wall(overhead + n/rate) must fit the tightest remaining budget.
        Queued consensus work itself always fits (it IS the deadline's
        beneficiary; shrinking below it would only delay it further)."""
        cons = self._queues[CLASS_CONSENSUS]
        deadlines = [r.deadline for r in cons if r.deadline is not None]
        if not deadlines:
            return self.max_sigs
        budget_ms = (min(deadlines) - now) * 1000.0
        rate, overhead = self._rate_model()
        fit = int(rate * max(0.0, budget_ms - overhead))
        cons_sigs = sum(len(r.pubs) for r in cons)
        return min(self.max_sigs, max(fit, cons_sigs, 1))

    # -- dispatcher --------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="verify-engine"
            )
            self._thread.start()

    def _queued_sigs(self) -> int:
        return sum(len(r.pubs) for q in self._queues for r in q)

    def _have_work(self) -> bool:
        return any(self._queues)

    def _collect(self) -> list[_Request]:
        """Block until work exists; in compat-hold mode keep the window
        open for batchmates; then assemble the next dispatch: starvation
        promotions first (oldest first), then strict class priority, whole
        requests only up to the deadline-aware cap (first always taken)."""
        with self._cond:
            while not self._have_work() and not self._closed:
                self._cond.wait()
            if not self._have_work():
                return []
            hold_s = self.hold_ms / 1000.0
            first_t = min(q[0].future.t_submit for q in self._queues if q)
            while hold_s > 0 and not self._closed:
                if self._queued_sigs() >= self.max_sigs:
                    break
                remaining = first_t + hold_s - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            now = time.perf_counter()
            cap = self._deadline_cap(now)
            # Starvation escape hatch: requests older than starvation_ms
            # jump the class ladder (oldest first). Ages are monotone
            # within a FIFO queue, so only each queue's stale prefix needs
            # checking.
            starv_s = self.starvation_ms / 1000.0
            promoted: list[_Request] = []
            if self.starvation_ms > 0:
                for q in self._queues:
                    for r in q:
                        if now - r.future.t_submit >= starv_s:
                            promoted.append(r)
                        else:
                            break
                promoted.sort(key=lambda r: r.future.t_submit)
            promoted_ids = {id(r) for r in promoted}
            order = promoted + [
                r
                for klass in range(_N_CLASSES)
                for r in self._queues[klass]
                if id(r) not in promoted_ids
            ]
            batch: list[_Request] = []
            total = 0
            for req in order:
                n = len(req.pubs)
                if batch and total + n > cap:
                    break
                if id(req) in promoted_ids and any(
                    self._queues[k] for k in range(req.klass)
                ):
                    # Promotion only counts when the escape hatch actually
                    # bypassed fresher higher-class work.
                    self.class_counters_[req.klass]["starvation_promotions"] += 1
                self._queues[req.klass].remove(req)
                total += n
                batch.append(req)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return  # closed and drained
            now = time.perf_counter()
            for req in batch:
                req.t_start = now
                self._record_wait(req.klass, (now - req.future.t_submit) * 1000.0)
            try:
                self._dispatch(batch)
            except BaseException as e:  # never kill the dispatcher
                for req in batch:
                    if not req.future.done():
                        req.future._set_error(e)

    def _dispatch(self, batch: list[_Request]) -> None:
        shared = len(batch) > 1
        with self._cond:
            self.counters_["dispatches"] += 1
            for req in batch:
                req.future.shared = shared
                self.class_counters_[req.klass]["dispatched_sigs"] += len(
                    req.pubs
                )
            refresh = self._cap_auto and self.counters_["dispatches"] % 64 == 1
        if refresh:
            # Cheap cached-width read (no dial): pick up a remote pod's
            # width once the grpc tier has seen a Ping capability reply.
            try:
                self.refresh_cap()
            except Exception:
                pass
        with self._cond:
            if shared:
                self.counters_["coalesced_dispatches"] += 1
                self.counters_["batched_requests"] += len(batch)
                self.counters_["coalesced_sigs"] += sum(
                    len(r.pubs) for r in batch
                )
        if not shared:
            # Nothing to slice or protect: serve the lone request directly
            # (errors propagate to its caller alone).
            req = batch[0]
            try:
                req.future._set_result(
                    self.inner.batch_verify(req.pubs, req.msgs, req.sigs)
                )
            except BaseException as e:
                req.future._set_error(e)
            return
        # Columnar pack with within-batch dedup: identical triples from
        # concurrent requests (N light clients walking the same descent)
        # share one lane.
        lane_of: dict[tuple, int] = {}
        pubs: list[bytes] = []
        msgs: list[bytes] = []
        sigs: list[bytes] = []
        lanes: list[list[int]] = []
        for req in batch:
            req_lanes = []
            for p, m, s in zip(req.pubs, req.msgs, req.sigs):
                key = (p, s, m)
                lane = lane_of.get(key)
                if lane is None:
                    lane = len(pubs)
                    lane_of[key] = lane
                    pubs.append(p)
                    msgs.append(m)
                    sigs.append(s)
                req_lanes.append(lane)
            lanes.append(req_lanes)
        dedup = sum(len(r.pubs) for r in batch) - len(pubs)
        if dedup:
            with self._cond:
                self.counters_["dedup_sigs"] += dedup
        try:
            _, bits = self.inner.batch_verify(pubs, msgs, sigs)
        except BaseException:
            self._fallback(batch)
            return
        if len(bits) != len(pubs):
            # A sick tier answering with the wrong shape is a failed
            # dispatch, not something to mis-slice.
            self._fallback(batch)
            return
        for req, req_lanes in zip(batch, lanes):
            req_bits = [bits[lane] for lane in req_lanes]
            req.future._set_result((all(req_bits), req_bits))

    def _fallback(self, batch: list[_Request]) -> None:
        """The merged dispatch failed: retry each request alone so one
        poisoned request cannot fail its batchmates.  Per-request errors go
        to that request's caller only."""
        with self._cond:
            self.counters_["fallback_splits"] += 1
        for req in batch:
            try:
                req.future._set_result(
                    self.inner.batch_verify(req.pubs, req.msgs, req.sigs)
                )
            except BaseException as e:
                req.future._set_error(e)

    # -- observability -----------------------------------------------------

    def _record_wait(self, klass: int, ms: float) -> None:
        with self._cond:
            if len(self._wait_ms) < _WAIT_SAMPLES:
                self._wait_ms.append(ms)
            else:
                self._wait_ms[self._wait_i % _WAIT_SAMPLES] = ms
            self._wait_i += 1
            ring = self._class_wait[klass]
            if len(ring) < _WAIT_SAMPLES:
                ring.append(ms)
            else:
                ring[self._class_wait_i[klass] % _WAIT_SAMPLES] = ms
            self._class_wait_i[klass] += 1

    @staticmethod
    def _percentile(data: list[float], q: float) -> float:
        if not data:
            return 0.0
        data = sorted(data)
        idx = min(len(data) - 1, int(q * (len(data) - 1) + 0.5))
        return data[idx]

    def _wait_percentile(self, q: float) -> float:
        with self._cond:
            data = list(self._wait_ms)
        return self._percentile(data, q)

    def class_wait_p95_ms(self, klass: int) -> float:
        with self._cond:
            data = list(self._class_wait[klass])
        return self._percentile(data, 0.95)

    def counters(self) -> dict:
        with self._cond:
            out = dict(self.counters_)
            out["queue_depth"] = sum(len(q) for q in self._queues)
            classes = {
                CLASS_NAMES[k]: dict(self.class_counters_[k])
                for k in range(_N_CLASSES)
            }
        out["max_sigs"] = self.max_sigs
        d = max(1, out["dispatches"])
        out["coalesce_ratio"] = round(out["requests"] / d, 3)
        out["queue_wait_p50_ms"] = round(self._wait_percentile(0.50), 3)
        out["queue_wait_p95_ms"] = round(self._wait_percentile(0.95), 3)
        for k in range(_N_CLASSES):
            classes[CLASS_NAMES[k]]["p95_us"] = int(
                self.class_wait_p95_ms(k) * 1000
            )
        out["classes"] = classes
        inner_counters = getattr(self.inner, "counters", None)
        if inner_counters is not None:
            out["inner"] = inner_counters()
        return out

    def register_metrics(self, registry) -> None:
        """scheduler_* gauges (legacy names, dashboards keep reading) on a
        libs.metrics Registry; the per-class engine_* gauges are registered
        lazily by node/node.py so a scrape never constructs the backend."""
        registry.gauge_func(
            "scheduler", "requests", "Verification requests submitted.",
            lambda: self.counters_["requests"],
        )
        registry.gauge_func(
            "scheduler", "dispatches", "Backend dispatches issued.",
            lambda: self.counters_["dispatches"],
        )
        registry.gauge_func(
            "scheduler", "batched_requests",
            "Requests that shared a coalesced dispatch.",
            lambda: self.counters_["batched_requests"],
        )
        registry.gauge_func(
            "scheduler", "fallback_splits",
            "Coalesced dispatches split into per-request retries.",
            lambda: self.counters_["fallback_splits"],
        )
        registry.gauge_func(
            "scheduler", "coalesce_ratio_milli",
            "Requests per dispatch x1000.",
            lambda: int(
                1000 * self.counters_["requests"]
                / max(1, self.counters_["dispatches"])
            ),
        )
        registry.gauge_func(
            "scheduler", "queue_wait_p95_us",
            "95th-percentile queue wait, microseconds.",
            lambda: int(self._wait_percentile(0.95) * 1000),
        )

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        inner_close = getattr(self.inner, "close", None)
        if inner_close is not None:
            inner_close()
