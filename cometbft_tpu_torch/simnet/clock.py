"""Clock abstraction: real monotonic time vs an event-heap virtual clock, the
port's copy of ``cometbft_tpu/simnet/clock.py``.

Production code paths (consensus state, ticker, switch redial, blocksync
poll loops) take an injected ``Clock`` and default to ``MonotonicClock``,
whose three methods are literally ``time.monotonic`` / ``time.sleep`` /
``threading.Timer`` — zero behavior change when nothing is injected.

``SimClock`` is a discrete-event virtual clock.  Virtual time never
passes on its own: it jumps to the next scheduled event's due time, and
only when every *registered actor* is blocked (sleeping or waiting on
the clock).  A simulation therefore runs exactly as fast as the host can
drain the event heap — a 100-second simulated chain that contains two
seconds of actual work completes in two wall seconds — while every
timer/sleep interleaving stays deterministic given a deterministic event
set.

Two driving modes:

* **Single-threaded** (the scenario harness): nobody registers actors;
  the run loop pops events itself via :meth:`SimClock.step` /
  :meth:`SimClock.run` and timer callbacks execute inline on the loop's
  thread.  Fully deterministic — the heap is ordered by
  ``(due, sequence)`` and the sequence counter is allocated in program
  order.
* **Threaded** (clock-driven unit tests, SimTransport under real
  threads): threads ``register_actor()`` themselves; any thread blocked
  in :meth:`sleep`/:meth:`wait_until` advances time itself once ALL
  registered actors are blocked, firing due timer callbacks from
  whichever thread performed the advance.  Timer callbacks must
  therefore stay short and non-blocking (queue puts, event sets) — the
  convention every in-repo user follows.
"""

from __future__ import annotations

import heapq
import threading
import time as _time

from cometbft_tpu_torch.libs import threads


class TimerHandle:
    """Cancelable one-shot timer, returned by ``Clock.timer``."""

    def cancel(self) -> None:  # pragma: no cover - interface default
        pass


class Clock:
    """now()/sleep()/timer() — the only time surface consensus uses."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def timer(self, delay: float, fn, *args) -> TimerHandle:
        """Schedule ``fn(*args)`` after ``delay`` seconds; returns a handle
        whose ``cancel()`` is a no-op once the callback started."""
        raise NotImplementedError

    def nap(self, seconds: float, wake: threading.Event) -> None:
        """``sleep``, cut short once ``wake`` is set where the clock is the
        wall's (a virtual clock sleeps its full time)."""
        self.sleep(seconds)


class _RealTimerHandle(TimerHandle):
    def __init__(self, t: threading.Timer):
        self._t = t

    def cancel(self) -> None:
        self._t.cancel()


class MonotonicClock(Clock):
    """Wall-clock implementation: the pre-simnet behavior, verbatim."""

    def now(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    def nap(self, seconds: float, wake: threading.Event) -> None:
        wake.wait(seconds)

    def timer(self, delay: float, fn, *args) -> TimerHandle:
        return _RealTimerHandle(threads.timer(delay, fn, args))


class _SimTimerEntry(TimerHandle):
    __slots__ = ("due", "seq", "fn", "args", "cancelled")

    def __init__(self, due: float, seq: int, fn, args):
        self.due = due
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        # Flag only: the entry stays heap-resident and is skipped on pop,
        # so cancellation never needs a heap rebuild.
        self.cancelled = True

    def __lt__(self, other: "_SimTimerEntry") -> bool:
        return (self.due, self.seq) < (other.due, other.seq)


class SimClock(Clock):
    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: list[_SimTimerEntry] = []
        self._seq = 0
        self._cond = threading.Condition()
        # thread ident -> actor name, for threads whose runnable state
        # gates time advancement.
        self._actors: dict[int, str] = {}
        # thread idents currently blocked inside sleep()/wait_until().
        self._blocked: set[int] = set()
        self.events_run = 0

    # -- Clock surface ------------------------------------------------------

    def now(self) -> float:
        return self._now

    def timer(self, delay: float, fn, *args) -> TimerHandle:
        with self._cond:
            entry = _SimTimerEntry(
                self._now + max(float(delay), 0.0), self._seq, fn, args
            )
            self._seq += 1
            heapq.heappush(self._heap, entry)
            self._cond.notify_all()
        return entry

    def sleep(self, seconds: float) -> None:
        self.wait_until(self._now + max(float(seconds), 0.0))

    def wait_until(self, due: float) -> None:
        """Block the calling thread until virtual time reaches ``due``.

        The sleeper schedules a wake event so the advance logic has a
        target, marks itself blocked, and — if it finds every registered
        actor blocked — performs the advance itself.  The 50 ms real
        ``Condition.wait`` is only a lost-wakeup backstop; advancement is
        driven by notifications, not by that timeout.
        """
        ident = threading.get_ident()
        with self._cond:
            if due <= self._now:
                return
            wake = _SimTimerEntry(due, self._seq, None, ())
            self._seq += 1
            heapq.heappush(self._heap, wake)
            self._blocked.add(ident)
            self._cond.notify_all()
            try:
                while self._now < due:
                    fired = self._advance_locked_if_all_blocked()
                    if fired:
                        self._run_entries(fired)
                        continue
                    if self._now >= due:
                        break
                    self._cond.wait(0.05)
            finally:
                self._blocked.discard(ident)
                wake.cancelled = True
                self._cond.notify_all()

    # -- actors -------------------------------------------------------------

    def register_actor(self, name: str = "") -> None:
        """Declare the calling thread an actor: virtual time may only
        advance while this thread is blocked in sleep()/wait_until()."""
        with self._cond:
            self._actors[threading.get_ident()] = name or "actor"

    def unregister_actor(self) -> None:
        with self._cond:
            self._actors.pop(threading.get_ident(), None)
            self._cond.notify_all()

    # -- driving ------------------------------------------------------------

    def pending(self) -> int:
        with self._cond:
            return sum(1 for e in self._heap if not e.cancelled)

    def next_due(self) -> float | None:
        with self._cond:
            for e in sorted(self._heap):
                if not e.cancelled:
                    return e.due
            return None

    def step(self) -> bool:
        """Single-threaded run loop: pop the earliest live event, advance to
        its due time, run its callback inline.  False when the heap is
        drained."""
        with self._cond:
            entry = self._pop_live_locked()
            if entry is None:
                return False
            self._now = entry.due
            self._cond.notify_all()
        self._run_entries([entry])
        return True

    def run(self, until: float | None = None, max_events: int | None = None) -> int:
        """Drain events (single-threaded mode) until the heap empties, the
        next event lies past ``until``, or ``max_events`` ran. Returns the
        number of events executed."""
        ran = 0
        while max_events is None or ran < max_events:
            with self._cond:
                entry = self._pop_live_locked(peek_limit=until)
                if entry is None:
                    break
                self._now = entry.due
                self._cond.notify_all()
            self._run_entries([entry])
            ran += 1
        if until is not None and self._now < until and self.next_due() is None:
            # No events left before the horizon: time simply passes.
            with self._cond:
                self._now = until
                self._cond.notify_all()
        return ran

    # -- internals ----------------------------------------------------------

    def _pop_live_locked(self, peek_limit: float | None = None):
        while self._heap:
            if peek_limit is not None and self._heap[0].due > peek_limit:
                return None
            entry = heapq.heappop(self._heap)
            if not entry.cancelled:
                return entry
        return None

    def _advance_locked_if_all_blocked(self) -> list[_SimTimerEntry]:
        """If every registered actor is blocked, jump to the earliest due
        time and collect everything due there. Caller holds the lock and
        runs the returned callbacks outside it."""
        if any(i not in self._blocked for i in self._actors):
            return []
        entry = self._pop_live_locked()
        if entry is None:
            return []
        self._now = entry.due
        fired = [entry]
        while self._heap and self._heap[0].due <= self._now:
            nxt = heapq.heappop(self._heap)
            if not nxt.cancelled:
                fired.append(nxt)
        self._cond.notify_all()
        return fired

    def _run_entries(self, entries) -> None:
        for e in entries:
            self.events_run += 1
            if e.fn is not None and not e.cancelled:
                e.fn(*e.args)
