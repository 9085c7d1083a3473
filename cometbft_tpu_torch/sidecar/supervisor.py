"""Resilient verification-backend supervisor.

Counterpart of ``cometbft_tpu/sidecar/supervisor.py``, copied over the
port's tiers. ``ResilientBackend`` wraps an ordered list of tiers with the
four mechanisms a consensus verification path needs to degrade instead of
stall:

* **Per-call deadlines** (`CMTPU_DEADLINE_MS`): every non-anchor tier's
  call is dispatched on that tier's watchdogged worker thread, so even an
  in-process device tier, whose dispatch can block where no socket
  timeout reaches, is bounded. A wedged call leaves its worker busy;
  subsequent calls fail fast instead of queueing behind the wedge, so a
  wedged tier costs ONE deadline, not liveness.
* **Bounded retry** with jittered exponential backoff for transient errors
  (`CMTPU_RETRIES`, `CMTPU_BACKOFF_MS`) — connection drops retry, deadline
  exhaustion does not (the time is already spent).
* **A per-tier circuit breaker**: `CMTPU_BREAKER_THRESHOLD` consecutive
  failures open the tier; after `CMTPU_BREAKER_COOLDOWN_MS` it goes
  half-open and one probe — the sidecar `Ping` RPC when the tier has one,
  the real call otherwise — re-promotes a healed tier to its chain slot.
* **An ordered degradation chain** `grpc -> hybrid -> cpu`: the last tier
  is the liveness anchor, called inline with no deadline — it must answer,
  and its answer is trusted.

Degraded results are additionally **cross-checked against the anchor**
(`CMTPU_CROSSCHECK` = off | sample | full, default sample): a
deterministic sample of the served bitmap re-verifies on the host path, so
an injected bit-flip false-accept from a sick tier is caught, counted,
trips the tier, and the anchor's answer is served instead.

`build_resilient()` assembles the chain `grpc -> hybrid -> cpu` from what
the process can reach; `CMTPU_FAULTS` (sidecar/chaos.py) wraps the
non-anchor tiers for fault-injection runs. Unlike the reference, no
construction error is caught: without a card the hybrid tier raises, and
so does the chain.
"""

from __future__ import annotations

import hashlib
import os
import queue
import random
import threading
import time

from cometbft_tpu_torch.sidecar.backend import CpuBackend, HybridBackend, VerifyBackend
from cometbft_tpu_torch.sidecar.engine import _env_float

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"

# Transient faults worth a bounded retry on the SAME tier. TimeoutError is
# the sidecar client's own request deadline; DeadlineExceeded (ours) is
# deliberately absent — its time budget is already spent.
_TRANSIENT = (ConnectionError, TimeoutError, OSError)


class DeadlineExceeded(Exception):
    """A tier call outlived CMTPU_DEADLINE_MS on its worker."""


class TierWedged(Exception):
    """A tier's worker is still stuck inside an earlier wedged call."""


class ChainExhausted(Exception):
    """Every tier in the degradation chain failed the call."""



class MonotonicClock:
    """The supervisor's default clock: ``time.monotonic`` and
    ``time.sleep`` (the port's copy of the reference's
    ``simnet/clock.MonotonicClock``, the two methods it uses)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class _TierWorker:
    """One daemon worker per tier: the watchdogged execution lane that
    makes deadlines enforceable on in-process tiers (a dispatch stuck on
    the card cannot be cancelled, only abandoned).  `busy` stays set
    while a wedged call is still running, so the supervisor fails fast
    instead of stacking new work behind the wedge."""

    def __init__(self, name: str):
        self.name = name
        self._q: queue.Queue = queue.Queue()
        self._busy = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=f"tier-{self.name}"
                )
                self._thread.start()

    def _loop(self) -> None:
        while True:
            fn, slot, done = self._q.get()
            self._busy.set()
            try:
                slot[0] = ("ok", fn())
            except BaseException as e:  # delivered, not swallowed
                slot[0] = ("err", e)
            finally:
                self._busy.clear()
                done.set()

    @property
    def busy(self) -> bool:
        return self._busy.is_set() or not self._q.empty()

    def run(self, fn, timeout_s: float):
        if self.busy:
            raise TierWedged(f"tier {self.name}: worker still wedged")
        self._ensure_thread()
        slot: list = [None]
        done = threading.Event()
        self._q.put((fn, slot, done))
        if not done.wait(timeout_s):
            # Abandon, don't join: the worker stays busy until the wedged
            # call unwinds on its own, and `busy` fast-fails callers until
            # then. The stale result, when it lands, is discarded.
            raise DeadlineExceeded(
                f"tier {self.name}: no result within {timeout_s * 1000:.0f} ms"
            )
        status, value = slot[0]
        if status == "err":
            raise value
        return value


class _Tier:
    def __init__(self, name: str, backend: VerifyBackend):
        self.name = name
        self.backend = backend
        self.worker = _TierWorker(name)
        self.state = _CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.trips = 0
        self.calls = 0
        self.failures = 0
        self.width = 0  # last known mesh width (0 = never read)


class ResilientBackend(VerifyBackend):
    """The supervised degradation chain (see module docstring)."""

    name = "resilient"

    def __init__(
        self,
        tiers: list[tuple[str, VerifyBackend]],
        deadline_ms: float | None = None,
        retries: int | None = None,
        backoff_ms: float | None = None,
        breaker_threshold: int | None = None,
        breaker_cooldown_ms: float | None = None,
        crosscheck: str | None = None,
        clock=None,
    ):
        if not tiers:
            raise ValueError("ResilientBackend needs at least one tier")
        # Injected clock (now() and sleep()): breaker timestamps and retry
        # backoff run on it, so tests can pin breaker and backoff timing
        # to virtual time on a loaded host. Call DEADLINES stay on the
        # worker's real `Event.wait` — a wedged dispatch wedges in wall
        # time no matter what the test clock says.
        if clock is None:
            clock = MonotonicClock()
        self._clock = clock
        self.tiers = [_Tier(n, b) for n, b in tiers]
        self.deadline_ms = (
            _env_float("CMTPU_DEADLINE_MS", 0.0) if deadline_ms is None else deadline_ms
        )
        self.retries = (
            int(_env_float("CMTPU_RETRIES", 2)) if retries is None else retries
        )
        self.backoff_ms = (
            _env_float("CMTPU_BACKOFF_MS", 50.0) if backoff_ms is None else backoff_ms
        )
        self.breaker_threshold = (
            int(_env_float("CMTPU_BREAKER_THRESHOLD", 3))
            if breaker_threshold is None
            else breaker_threshold
        )
        self.breaker_cooldown_ms = (
            _env_float("CMTPU_BREAKER_COOLDOWN_MS", 5000.0)
            if breaker_cooldown_ms is None
            else breaker_cooldown_ms
        )
        self.crosscheck = (
            os.environ.get("CMTPU_CROSSCHECK", "sample")
            if crosscheck is None
            else crosscheck
        )
        if self.crosscheck not in ("off", "sample", "full"):
            raise ValueError(f"unknown CMTPU_CROSSCHECK {self.crosscheck!r}")
        self._lock = threading.Lock()  # breaker state + counters
        self._jitter = random.Random()  # retry jitter; no determinism contract
        self.counters_ = {
            "calls": 0,
            "degraded_calls": 0,
            "retries": 0,
            "deadline_exceeded": 0,
            "trips": 0,
            "crosscheck_catches": 0,
        }
        # The anchor's host tier doubles as the cross-check ground truth.
        self._cpu = self.tiers[-1].backend

    # -- breaker ----------------------------------------------------------

    def _admit(self, tier: _Tier) -> bool:
        """closed -> yes; open -> only once the cooldown elapsed (tier goes
        half-open and this call is the probe)."""
        with self._lock:
            if tier.state == _CLOSED:
                return True
            if (self._clock.now() - tier.opened_at) * 1000 < self.breaker_cooldown_ms:
                return False
            tier.state = _HALF_OPEN
            return True

    def _record_success(self, tier: _Tier) -> None:
        with self._lock:
            tier.consecutive_failures = 0
            tier.state = _CLOSED

    def _record_failure(self, tier: _Tier) -> None:
        with self._lock:
            tier.failures += 1
            tier.consecutive_failures += 1
            reopen = tier.state == _HALF_OPEN
            if reopen or tier.consecutive_failures >= self.breaker_threshold:
                if tier.state != _OPEN:
                    tier.trips += 1
                    self.counters_["trips"] += 1
                tier.state = _OPEN
                tier.opened_at = self._clock.now()
                tier.consecutive_failures = 0

    def _probe(self, tier: _Tier) -> bool:
        """Half-open recovery probe: the sidecar `Ping` RPC when the tier
        speaks it, else admit the real call as the probe."""
        ping = getattr(tier.backend, "ping", None)
        if ping is None:
            return True
        try:
            if self.deadline_ms > 0:
                return bool(tier.worker.run(ping, self.deadline_ms / 1000.0))
            return bool(ping())
        except Exception:
            return False

    # -- call protocol ----------------------------------------------------

    def _run_on(self, tier: _Tier, fn, *, anchored: bool):
        """One tier attempt with deadline + bounded jittered-backoff retry.
        The anchor runs inline and un-deadlined: it is the liveness floor,
        and with nowhere left to degrade a timeout would only convert a
        slow correct answer into no answer."""
        attempt = 0
        while True:
            try:
                if anchored or self.deadline_ms <= 0:
                    return fn()
                return tier.worker.run(fn, self.deadline_ms / 1000.0)
            except DeadlineExceeded:
                with self._lock:
                    self.counters_["deadline_exceeded"] += 1
                raise
            except _TRANSIENT:
                if attempt >= self.retries:
                    raise
                attempt += 1
                with self._lock:
                    self.counters_["retries"] += 1
                base = self.backoff_ms * (2 ** (attempt - 1))
                self._clock.sleep((base + self._jitter.uniform(0, base)) / 1000.0)

    def _call(self, op_name: str, fn_for, crosscheckable: bool = False):
        """Walk the chain: first admitted tier that answers wins.  `fn_for`
        maps a tier backend to the zero-arg call."""
        with self._lock:
            self.counters_["calls"] += 1
        last_err: Exception | None = None
        for i, tier in enumerate(self.tiers):
            anchored = i == len(self.tiers) - 1
            if not self._admit(tier):
                continue
            if tier.state == _HALF_OPEN and not self._probe(tier):
                self._record_failure(tier)  # reopens, restarts cooldown
                continue
            tier.calls += 1
            try:
                result = self._run_on(
                    tier, fn_for(tier.backend), anchored=anchored
                )
            except Exception as e:
                last_err = e
                self._record_failure(tier)
                continue
            if crosscheckable and not anchored and self.crosscheck != "off":
                caught, result = self._crosscheck(tier, result)
                if caught:
                    continue  # tier failed the ground truth; keep walking
            self._record_success(tier)
            if i > 0:
                with self._lock:
                    self.counters_["degraded_calls"] += 1
            return result
        raise ChainExhausted(
            f"{op_name}: every tier failed "
            f"({', '.join(t.name for t in self.tiers)})"
        ) from last_err

    # -- cross-check ------------------------------------------------------

    def _crosscheck(self, tier: _Tier, served):
        """Re-verify a deterministic sample (or all) of a non-anchor tier's
        batch_verify result on the host path.  Any disagreement counts as a
        tier failure — a false-accept must trip the breaker, not ship."""
        ok, bits, pubs, msgs, sigs = served
        n = len(pubs)
        if n == 0:
            return False, (ok, bits)
        if self.crosscheck == "full":
            idx = range(n)
        else:
            # Sample indices from the batch content, not a clock or RNG:
            # the same batch cross-checks the same lanes on every host.
            h = hashlib.sha256(b"".join(sigs[:64]) + n.to_bytes(4, "big"))
            rng = random.Random(h.digest())
            idx = sorted(rng.sample(range(n), min(32, n)))
        s_pubs = [pubs[i] for i in idx]
        s_msgs = [msgs[i] for i in idx]
        s_sigs = [sigs[i] for i in idx]
        _, truth_bits = self._cpu.batch_verify(s_pubs, s_msgs, s_sigs)
        if all(bits[i] == t for i, t in zip(idx, truth_bits)):
            return False, (ok, bits)
        with self._lock:
            self.counters_["crosscheck_catches"] += 1
        self._record_failure(tier)
        return True, None

    # -- VerifyBackend surface --------------------------------------------

    def batch_verify(self, pubs, msgs, sigs):
        def fn_for(backend):
            def call():
                ok, bits = backend.batch_verify(pubs, msgs, sigs)
                return ok, bits, pubs, msgs, sigs

            return call

        ok, bits, *_ = self._call("batch_verify", fn_for, crosscheckable=True)
        return ok, bits

    def aggregate_verify(self, pubs, msgs, agg_sig) -> bool:
        """One boolean over a whole aggregate-BLS commit (bn254 chain).

        Same walk as batch_verify — deadline, retry, breaker — but tiers
        that don't speak the verb are SKIPPED, not failed (the verb must
        not trip breakers on a chain that never advertised it). The
        crosscheck differs by necessity: an aggregate verdict has no
        per-lane sample granularity, so any non-off CMTPU_CROSSCHECK
        recomputes the WHOLE check on the anchor when a non-anchor tier
        served it — a flipped accept from a sick tier is caught, counted,
        and trips the tier, exactly like a bitmap flip would be."""
        with self._lock:
            self.counters_["calls"] += 1
        last_err: Exception | None = None
        speakers = [
            (i, t)
            for i, t in enumerate(self.tiers)
            if getattr(t.backend, "aggregate_verify", None) is not None
        ]
        if not speakers:
            raise ChainExhausted("aggregate_verify: no tier speaks the verb")
        for j, (i, tier) in enumerate(speakers):
            anchored = j == len(speakers) - 1
            if not self._admit(tier):
                continue
            if tier.state == _HALF_OPEN and not self._probe(tier):
                self._record_failure(tier)
                continue
            tier.calls += 1
            try:
                result = self._run_on(
                    tier,
                    lambda b=tier.backend: b.aggregate_verify(pubs, msgs, agg_sig),
                    anchored=anchored,
                )
            except Exception as e:
                last_err = e
                self._record_failure(tier)
                continue
            if not anchored and self.crosscheck != "off":
                anchor = speakers[-1][1].backend
                if bool(result) != bool(
                    anchor.aggregate_verify(pubs, msgs, agg_sig)
                ):
                    with self._lock:
                        self.counters_["crosscheck_catches"] += 1
                    self._record_failure(tier)
                    continue
            self._record_success(tier)
            if i > 0:
                with self._lock:
                    self.counters_["degraded_calls"] += 1
            return bool(result)
        raise ChainExhausted(
            "aggregate_verify: every tier failed "
            f"({', '.join(t.name for _, t in speakers)})"
        ) from last_err

    def merkle_root(self, leaves):
        return self._call(
            "merkle_root", lambda backend: lambda: backend.merkle_root(leaves)
        )

    def mesh_width(self) -> int:
        """Widest mesh any tier currently willing to serve can reach —
        local cards (the hybrid tier) or a remote host's (the grpc tier's
        Ping capability reply). The coalescer and engine size their merge
        caps from this.

        A tier whose breaker is open inside its cooldown is SKIPPED without
        touching its backend — a tripped grpc tier must not be dialed just
        to read its width — and every successful read is cached on the tier
        (`tier.width`), so a tier that errors on the read keeps reporting
        its last known width instead of vanishing from the estimate."""
        width = 1
        now = self._clock.now()
        for tier in self.tiers:
            with self._lock:
                tripped = tier.state == _OPEN and (
                    (now - tier.opened_at) * 1000 < self.breaker_cooldown_ms
                )
            if not tripped:
                mw = getattr(tier.backend, "mesh_width", None)
                if mw is not None:
                    try:
                        tier.width = max(1, int(mw()))
                    except Exception:
                        pass  # keep the cached width
                if tier.width:
                    width = max(width, tier.width)
        return width

    def ping(self) -> bool:
        return bool(
            self._call(
                "ping",
                lambda backend: (
                    getattr(backend, "ping", None) or (lambda: True)
                ),
            )
        )

    # -- observability ----------------------------------------------------

    @property
    def active_tier(self) -> str:
        """First tier currently willing to take a call."""
        now = self._clock.now()
        with self._lock:
            for tier in self.tiers:
                if tier.state != _OPEN or (
                    (now - tier.opened_at) * 1000 >= self.breaker_cooldown_ms
                ):
                    return tier.name
            return self.tiers[-1].name

    @property
    def active_tier_index(self) -> int:
        name = self.active_tier
        return next(i for i, t in enumerate(self.tiers) if t.name == name)

    def counters(self) -> dict:
        with self._lock:
            out = dict(self.counters_)
        out["active_tier"] = self.active_tier
        out["chain"] = [t.name for t in self.tiers]
        out["tiers"] = {}
        for t in self.tiers:
            entry = {
                "state": t.state,
                "calls": t.calls,
                "failures": t.failures,
                "trips": t.trips,
                "width": t.width,
            }
            # Tier backends with their own counters (the grpc client's
            # streamed/unary split, a chaos wrapper's injections) surface
            # them here so one snapshot explains the whole chain.
            tc = getattr(t.backend, "counters", None)
            if tc is not None:
                try:
                    entry["backend"] = tc()
                except Exception:
                    pass
            out["tiers"][t.name] = entry
        return out

    def register_metrics(self, registry) -> None:
        """backend_* gauges on a libs.metrics Registry (node/node.py wires
        this into the /metrics endpoint). active_tier is the chain index:
        0 = primary, rising as the chain degrades."""
        registry.gauge_func(
            "backend", "trips", "Circuit-breaker trips.",
            lambda: self.counters_["trips"],
        )
        registry.gauge_func(
            "backend", "retries", "Transient-error retries.",
            lambda: self.counters_["retries"],
        )
        registry.gauge_func(
            "backend", "deadline_exceeded", "Tier calls past CMTPU_DEADLINE_MS.",
            lambda: self.counters_["deadline_exceeded"],
        )
        registry.gauge_func(
            "backend", "active_tier",
            "Chain index of the serving tier (0 = primary).",
            lambda: self.active_tier_index,
        )

    def close(self) -> None:
        for tier in self.tiers:
            close = getattr(tier.backend, "close", None)
            if close is not None:
                try:
                    close()
                except OSError:
                    pass


# -- chain assembly -----------------------------------------------------------


def build_chain(device=None) -> list[tuple[str, VerifyBackend]]:
    """The `grpc -> hybrid -> cpu` degradation order:

    * a single-sidecar tier first, when `CMTPU_SIDECAR_ADDR` names one (the
      port's `GrpcBackend`, its request deadline `CMTPU_DEADLINE_MS`);
    * `HybridBackend(device)`: the card and the native host MSM (`device`
      None is `cuda`, which raises without a card; `"cpu"` is the plain
      path, for the tests);
    * `CpuBackend` as the anchor, always last.

    `CMTPU_FAULTS` wraps every non-anchor tier in ChaosBackend, seeded from
    `CMTPU_FAULTS_SEED` plus the tier's position. The fanout tier
    (`CMTPU_FANOUT_PEERS`) is not ported: naming peers raises.
    """
    from cometbft_tpu_torch.sidecar.chaos import wrap_tiers_from_env

    if os.environ.get("CMTPU_FANOUT_PEERS", "").strip():
        raise RuntimeError(
            "CMTPU_FANOUT_PEERS is set, but the fanout tier (sidecar/fanout.py) has no "
            "counterpart in cometbft_tpu_torch yet"
        )
    tiers: list[tuple[str, VerifyBackend]] = []
    addr = os.environ.get("CMTPU_SIDECAR_ADDR", "").strip()
    if addr:
        from cometbft_tpu_torch.sidecar.service import GrpcBackend

        deadline_ms = _env_float("CMTPU_DEADLINE_MS", 0.0)
        timeout_s = deadline_ms / 1000.0 if deadline_ms > 0 else 300.0
        tiers.append(("grpc", GrpcBackend(addr, timeout_s=timeout_s)))
    tiers.append(("hybrid", HybridBackend(device)))
    tiers = wrap_tiers_from_env(tiers)
    tiers.append(("cpu", CpuBackend()))
    return tiers


def build_resilient(device=None) -> ResilientBackend:
    """The supervised chain over ``build_chain(device)``."""
    return ResilientBackend(build_chain(device))
