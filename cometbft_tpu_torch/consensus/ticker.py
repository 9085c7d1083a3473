"""Timeout ticker (consensus/ticker.go), the port's copy of
``cometbft_tpu/consensus/ticker.py``.

Schedules one pending round-step timeout at a time; scheduling a new one
cancels the old (ticker.go:40-110). Fired timeouts land on `tock_queue`,
drained by the consensus receive routine.
"""

from __future__ import annotations

import queue
import threading

from cometbft_tpu_torch.consensus.messages import TimeoutInfo
from cometbft_tpu_torch.simnet.clock import Clock, MonotonicClock


class TimeoutTicker:
    def __init__(self, clock: Clock | None = None):
        self.tock_queue: queue.Queue[TimeoutInfo] = queue.Queue()
        self.clock = clock or MonotonicClock()
        self._timer = None  # TimerHandle of the single pending timeout
        self._mtx = threading.Lock()
        self._running = False

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        with self._mtx:
            self._running = False
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        """ticker.go ScheduleTimeout: replaces any pending timeout."""
        with self._mtx:
            if not self._running:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = self.clock.timer(ti.duration, self._fire, ti)

    def _fire(self, ti: TimeoutInfo) -> None:
        self.tock_queue.put(ti)

