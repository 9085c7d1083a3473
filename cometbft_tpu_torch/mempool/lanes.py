"""Priority lanes, weighted fair queuing, and per-sender token buckets, the
port's copy of ``cometbft_tpu/mempool/lanes.py``.

These are the queueing primitives for the QoS ingress pipeline
(``mempool/ingress.py``).  They are deliberately free of any mempool or
backend dependency so the fairness properties can be unit/property tested
with a fake clock.

Semantics
---------
- ``LaneSet`` holds N bounded FIFO lanes.  Lane ``N-1`` is the highest
  priority.  Enqueue sheds (raises) when the lane is at capacity or when a
  single sender already occupies more than its fair share of the lane, so
  one spammer can neither block the RPC thread nor squat the whole queue.
- Draining uses deficit-round-robin weighted fair queuing: each drain
  cycle grants lane ``i`` a quantum of ``2**i`` txs, so higher lanes get
  geometrically more bandwidth but low lanes are never starved.
- ``TokenBucket`` is a standard rate limiter keyed by authenticated
  sender identity (the envelope pubkey).  Legacy/unattributable txs are
  not bucketed — you cannot rate-limit an identity you cannot verify.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


class LaneFull(Exception):
    """Lane queue at capacity (or sender over its per-lane share)."""


class RateLimited(Exception):
    """Per-sender token bucket empty."""


class TokenBucket:
    """Token bucket: ``rate`` tokens/sec, capacity ``burst``.

    ``now`` is injectable for deterministic tests.
    """

    __slots__ = ("rate", "burst", "tokens", "_last", "_now")

    def __init__(self, rate: float, burst: float, now: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._now = now
        self._last = now()

    def allow(self, n: float = 1.0) -> bool:
        t = self._now()
        elapsed = t - self._last
        self._last = t
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


@dataclass
class LaneItem:
    tx: bytes
    sender: str = ""
    lane: int = 0
    meta: object = None
    seq: int = field(default=0)


class LaneSet:
    """N bounded FIFO lanes with DRR weighted-fair draining.

    Thread-safe.  ``queue_max`` bounds each lane; a single sender may hold
    at most ``max(1, queue_max // sender_share_div)`` slots per lane so a
    flood cannot squat a bounded queue ahead of honest traffic.
    """

    def __init__(
        self,
        lanes: int = 4,
        queue_max: int = 2048,
        sender_rps: float = 0.0,
        sender_burst: Optional[float] = None,
        sender_share_div: int = 4,
        now: Callable[[], float] = time.monotonic,
    ):
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        self.n_lanes = int(lanes)
        self.queue_max = int(queue_max)
        self.sender_rps = float(sender_rps)
        self.sender_burst = float(sender_burst if sender_burst is not None else max(1.0, 2 * sender_rps))
        self.sender_share = max(1, self.queue_max // max(1, sender_share_div))
        self._now = now
        self._mtx = threading.Lock()
        self._queues: List[Deque[LaneItem]] = [deque() for _ in range(self.n_lanes)]
        self._per_sender: List[Dict[str, int]] = [dict() for _ in range(self.n_lanes)]
        self._buckets: Dict[str, TokenBucket] = {}
        self._seq = 0
        # DRR state: deficit counter per lane, drained high -> low.
        self._deficit = [0] * self.n_lanes

    def clamp_lane(self, lane: int) -> int:
        return max(0, min(int(lane), self.n_lanes - 1))

    def rate_check(self, sender: str) -> bool:
        """Charge one token for ``sender``; True if admitted.

        Only authenticated (non-empty) senders are bucketed, and only when a
        positive rate is configured.
        """
        if self.sender_rps <= 0 or not sender:
            return True
        with self._mtx:
            b = self._buckets.get(sender)
            if b is None:
                b = TokenBucket(self.sender_rps, self.sender_burst, now=self._now)
                self._buckets[sender] = b
                # Opportunistic GC so a churn of one-shot senders can't grow
                # the bucket map without bound.
                if len(self._buckets) > 65536:
                    stale = [k for k, v in self._buckets.items() if v.tokens >= v.burst]
                    for k in stale[: len(stale) // 2]:
                        self._buckets.pop(k, None)
            return b.allow()

    def push(self, item: LaneItem) -> None:
        """Enqueue; raises LaneFull when shedding."""
        lane = self.clamp_lane(item.lane)
        item.lane = lane
        with self._mtx:
            q = self._queues[lane]
            if len(q) >= self.queue_max:
                raise LaneFull(f"lane {lane} full ({len(q)}/{self.queue_max})")
            held = self._per_sender[lane].get(item.sender, 0)
            if item.sender and held >= self.sender_share:
                raise LaneFull(
                    f"sender over lane share ({held}/{self.sender_share} in lane {lane})"
                )
            self._seq += 1
            item.seq = self._seq
            q.append(item)
            if item.sender:
                self._per_sender[lane][item.sender] = held + 1

    def drain(self, budget: int) -> List[LaneItem]:
        """Dequeue up to ``budget`` items in weighted-fair order.

        Deficit round robin over lanes high -> low with quantum ``2**i``
        for lane ``i``: strict enough that priority traffic wins, fair
        enough that lane 0 still drains under sustained high-lane load.
        """
        out: List[LaneItem] = []
        with self._mtx:
            if budget <= 0:
                return out
            while len(out) < budget and any(self._queues):
                progressed = False
                for lane in range(self.n_lanes - 1, -1, -1):
                    q = self._queues[lane]
                    if not q:
                        self._deficit[lane] = 0
                        continue
                    self._deficit[lane] += 1 << lane
                    while q and self._deficit[lane] > 0 and len(out) < budget:
                        item = q.popleft()
                        self._deficit[lane] -= 1
                        progressed = True
                        if item.sender:
                            cnt = self._per_sender[lane].get(item.sender, 1) - 1
                            if cnt <= 0:
                                self._per_sender[lane].pop(item.sender, None)
                            else:
                                self._per_sender[lane][item.sender] = cnt
                        out.append(item)
                    if len(out) >= budget:
                        break
                if not progressed:
                    break
        return out

    def depths(self) -> List[int]:
        with self._mtx:
            return [len(q) for q in self._queues]

    def size(self) -> int:
        with self._mtx:
            return sum(len(q) for q in self._queues)
