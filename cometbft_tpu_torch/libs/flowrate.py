"""Flow rate monitoring + limiting (libs/flowrate/flowrate.go Monitor —
mzimmerman/flowrate as CometBFT vendors it), the port's copy of
``cometbft_tpu/libs/flowrate.py``.

Monitor tracks a byte stream's totals and rates (average, EMA instantaneous,
peak) and enforces a target rate by sleeping the caller — MConnection holds
one per direction for its send/recv throttling and reports Status() through
the p2p layer."""

from __future__ import annotations

import threading
import time


class Monitor:
    """flowrate.Monitor: rate accounting + blocking limiter."""

    def __init__(self, sample_period: float = 0.1):
        self.sample_period = max(sample_period, 0.01)
        self._mtx = threading.Lock()
        self.start = time.monotonic()
        self.bytes_total = 0
        self.samples = 0
        self.inst_rate = 0.0  # EMA over sample periods
        self.peak_rate = 0.0
        self._window_bytes = 0
        self._window_start = self.start
        # limiter state
        self._allowance = 0.0
        self._last_fill = self.start

    def update(self, n: int) -> int:
        """Record n transferred bytes (flowrate.go Update)."""
        now = time.monotonic()
        with self._mtx:
            self.bytes_total += n
            self._window_bytes += n
            elapsed = now - self._window_start
            if elapsed >= self.sample_period:
                rate = self._window_bytes / elapsed
                # EMA with the reference's ~0.25 new-sample weight.
                self.inst_rate = (
                    rate if self.samples == 0 else 0.75 * self.inst_rate + 0.25 * rate
                )
                self.peak_rate = max(self.peak_rate, rate)
                self.samples += 1
                self._window_bytes = 0
                self._window_start = now
        return n

    def limit(self, want: int, rate: int, block: bool = True) -> int:
        """Token-bucket admission for `want` bytes at `rate` B/s: returns the
        admitted byte count, sleeping when block=True (flowrate.go Limit)."""
        if rate <= 0:
            return want
        with self._mtx:
            now = time.monotonic()
            self._allowance = min(
                float(rate), self._allowance + (now - self._last_fill) * rate
            )
            self._last_fill = now
            self._allowance -= want
            deficit = -self._allowance
        if deficit > 0:
            if not block:
                with self._mtx:
                    self._allowance += want  # undo: caller sends nothing
                return 0
            time.sleep(deficit / rate)
            with self._mtx:
                self._allowance = min(self._allowance, 0.0)
        return want

    def status(self) -> dict:
        """flowrate.Status: totals + rates for /net_info reporting."""
        with self._mtx:
            duration = time.monotonic() - self.start
            return {
                "duration": duration,
                "bytes": self.bytes_total,
                "avg_rate": self.bytes_total / duration if duration > 0 else 0.0,
                "inst_rate": self.inst_rate,
                "peak_rate": self.peak_rate,
            }
