"""Deadlock & stall detection (the single-process analog of CometBFT's `go
test -race` + go-deadlock usage), the port's copy of
``cometbft_tpu/libs/deadlock.py``.

Three tools:

  TrackedLock   an opt-in threading.Lock wrapper that records the wait-for
                graph (thread -> lock it waits on; lock -> owning thread).
                `detect_cycles()` reports actual deadlock cycles with the
                stacks of the involved threads. Zero overhead when unused;
                tests and CMTPU_DEBUG_LOCKS=1 runs opt in.
  Watchdog      progress monitor: samples a counter (e.g. consensus height)
                and fires a callback with a full thread-stack dump when it
                stops advancing for `stall_after` seconds — the "node is
                wedged, tell me where" tool.
  dump_stacks   one-shot all-thread stack dump (also exposed via the pprof
                endpoint's /debug/pprof/goroutine).

The watchdog reads an injected clock (``clock``, ``time.monotonic`` by
default) and does one sample a ``check()``, which its thread calls every
``interval`` seconds; its thread joins the caller's ``libs/threads`` group,
and ``stop()`` wakes and ends it. A progress function that raises is
counted (``sample_errors``, ``last_sample_error``) where the JAX package's
passes over it.
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.libs.pprof import thread_stacks as dump_stacks

_registry_mtx = threading.Lock()
_all_locks: list = []


class TrackedLock:
    """A lock participating in deadlock detection."""

    def __init__(self, name: str = ""):
        self._lock = threading.Lock()
        self.name = name or f"lock-{id(self):x}"
        self.owner: int | None = None
        self.waiters: dict[int, float] = {}
        self._meta = threading.Lock()
        with _registry_mtx:
            _all_locks.append(self)

    def acquire(self, timeout: float = -1) -> bool:
        me = threading.get_ident()
        with self._meta:
            self.waiters[me] = time.monotonic()
        try:
            ok = self._lock.acquire(timeout=timeout)
        finally:
            with self._meta:
                self.waiters.pop(me, None)
        if ok:
            self.owner = me
        return ok

    def release(self) -> None:
        self.owner = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *a):
        self.release()


def detect_cycles() -> list[list[str]]:
    """Find wait-for cycles over all TrackedLocks: thread T waits on lock L
    whose owner waits on a lock owned by ... T. Returns one
    ["thread A -> lockX (held by B)", ...] chain per cycle found."""
    with _registry_mtx:
        locks = list(_all_locks)
    waits: dict[int, "TrackedLock"] = {}
    owners: dict[int, list["TrackedLock"]] = {}
    for lk in locks:
        with lk._meta:
            for tid in lk.waiters:
                waits[tid] = lk
        if lk.owner is not None:
            owners.setdefault(lk.owner, []).append(lk)
    cycles = []
    for start_tid in list(waits):
        chain, tid, seen = [], start_tid, set()
        while tid in waits:
            if tid in seen:
                if tid == start_tid:
                    cycles.append(chain)
                break
            seen.add(tid)
            lk = waits[tid]
            chain.append(f"thread {tid} -> {lk.name} (held by {lk.owner})")
            if lk.owner is None:
                break
            tid = lk.owner
    return cycles


def stuck_waiters(threshold: float = 10.0) -> list[str]:
    """Threads blocked on a TrackedLock for longer than `threshold`."""
    now = time.monotonic()
    out = []
    with _registry_mtx:
        locks = list(_all_locks)
    for lk in locks:
        with lk._meta:
            for tid, since in lk.waiters.items():
                if now - since > threshold:
                    out.append(
                        f"thread {tid} stuck {now - since:.1f}s on {lk.name} "
                        f"(held by {lk.owner})"
                    )
    return out


class Watchdog:
    """Fires when a progress counter stops moving (consensus height, pool
    height, ...) — dumps every thread's stack so the wedge is attributable."""

    def __init__(self, progress_fn, stall_after: float = 60.0, interval: float = 5.0,
                 on_stall=None, logger=None, clock=time.monotonic):
        self.progress_fn = progress_fn
        self.stall_after = stall_after
        self.interval = interval
        self.on_stall = on_stall
        self.logger = logger
        self._clock = clock
        self._last_value = None
        self._last_change = clock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stalls = 0
        self.sample_errors = 0
        self.last_sample_error: BaseException | None = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threads.spawn(self._run, name="watchdog")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(max(1.0, 2 * self.interval))

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.check()

    def check(self) -> bool:
        """One sample; True when it reported a stall."""
        try:
            v = self.progress_fn()
        except Exception as e:  # counted; the next sample tries again
            self.sample_errors += 1
            self.last_sample_error = e
            return False
        now = self._clock()
        if v != self._last_value:
            self._last_value = v
            self._last_change = now
            return False
        if now - self._last_change < self.stall_after:
            return False
        self._last_change = now  # rate-limit repeat reports
        self.stalls += 1
        report = (
            f"watchdog: no progress for {self.stall_after}s "
            f"(value {v!r})\n"
            + "\n".join(stuck_waiters(self.stall_after / 2))
            + "\n"
            + dump_stacks()
        )
        if self.logger:
            self.logger.error("node stalled", module="watchdog", value=v)
        if self.on_stall:
            self.on_stall(report)
        return True
