"""Canonical time (types/time/time.go and the gogo stdtime wire form), the
port's copy of ``cometbft_tpu/types/cmttime.py``.

A time is (seconds, nanos) from the Unix epoch, as google.protobuf.Timestamp.
Go's zero time (0001-01-01T00:00:00Z) is seconds = -62135596800; it shows in
the canonical sign bytes of a zero-valued vote, so "zero time" and "the
epoch" differ on the wire.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

from cometbft_tpu_torch.wire import proto as wire

# Seconds from 0001-01-01T00:00:00Z to the Unix epoch (Go's zero time).
GO_ZERO_SECONDS = -62135596800


@dataclass(frozen=True, order=True)
class Time:
    seconds: int = GO_ZERO_SECONDS
    nanos: int = 0

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_SECONDS and self.nanos == 0

    def add_nanos(self, delta: int) -> "Time":
        total = self.seconds * 10**9 + self.nanos + delta
        return Time(total // 10**9, total % 10**9)

    def unix_nanos(self) -> int:
        return self.seconds * 10**9 + self.nanos

    def before(self, other: "Time") -> bool:
        return self.unix_nanos() < other.unix_nanos()

    def after(self, other: "Time") -> bool:
        return self.unix_nanos() > other.unix_nanos()

    def encode(self) -> bytes:
        """google.protobuf.Timestamp {seconds = 1 int64, nanos = 2 int32}."""
        return wire.field_varint(1, self.seconds) + wire.field_varint(2, self.nanos)

    @classmethod
    def decode(cls, data: bytes) -> "Time":
        f = wire.decode_fields(data)
        return cls(wire.get_varint(f, 1), wire.get_varint(f, 2))

    # -- RFC 3339 (genesis JSON) -------------------------------------------

    def rfc3339(self) -> str:
        secs = self.seconds
        frac = ""
        if self.nanos:
            frac = "." + f"{self.nanos:09d}".rstrip("0")
        st = _time.gmtime(secs) if secs >= 0 else _gmtime_neg(secs)
        return (
            f"{st[0]:04d}-{st[1]:02d}-{st[2]:02d}T"
            f"{st[3]:02d}:{st[4]:02d}:{st[5]:02d}{frac}Z"
        )

    @classmethod
    def parse_rfc3339(cls, s: str) -> "Time":
        import calendar
        import datetime as dt
        import re

        s = s.strip()
        offset_sec = 0
        if s.endswith(("Z", "z")):
            s = s[:-1]
        else:
            m = re.search(r"([+-])(\d{2}):(\d{2})$", s)
            if m:
                offset_sec = (int(m.group(2)) * 3600 + int(m.group(3)) * 60) * (
                    1 if m.group(1) == "+" else -1
                )
                s = s[: m.start()]
        nanos = 0
        if "." in s:
            s, frac = s.split(".")
            nanos = int((frac + "0" * 9)[:9])
        d = dt.datetime.strptime(s, "%Y-%m-%dT%H:%M:%S")
        return cls(calendar.timegm(d.timetuple()) - offset_sec, nanos)


def _gmtime_neg(secs: int):
    import datetime as dt

    d = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(seconds=secs)
    return (d.year, d.month, d.day, d.hour, d.minute, d.second)


# The source behind now(): the wall clock unless a caller installs another
# (a virtual clock makes timestamps deterministic).
_now_source = None


def set_now_source(fn) -> None:
    """Install ``fn() -> Time`` as the source behind ``now()`` (None: the
    wall clock again). Process-wide."""
    global _now_source
    _now_source = fn


def now() -> Time:
    """The current UTC time (types/time.Now)."""
    if _now_source is not None:
        return _now_source()
    ns = _time.time_ns()
    return Time(ns // 10**9, ns % 10**9)


def canonical(t: Time) -> Time:
    """cmttime.Canonical: UTC with the monotonic reading stripped, which a
    (seconds, nanos) pair already is."""
    return t
