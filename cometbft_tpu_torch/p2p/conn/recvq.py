"""Prioritized recv demux: bounded per-channel queues + a DRR drain loop, the
port's copy of ``cometbft_tpu/p2p/conn/recvq.py`` (the same classes, quanta,
bounds and knobs: ``CMTPU_RECVQ``, ``CMTPU_RECVQ_MAX``,
``CMTPU_RECVQ_STARVATION_MS``, ``CMTPU_RECVQ_QUANTA``).

Channel priorities have always shaped the SEND side of an MConnection
(`_next_channel_to_send`'s recently-sent/priority ratio); the RECV side was
one serialized stream — `_recv_routine` called `on_receive` inline, so a
block part could sit behind hundreds of queued mempool messages and cross
timeout_propose (the e2e matrix seed 2/3/9 stall signature).  This module
is the recv-side counterpart: `_recv_routine` becomes a thin framer that
enqueues reassembled messages here, and one drain thread per connection
delivers them to `on_receive` in priority order.

Scheduling is deficit round robin over four channel CLASSES (consensus >
blocksync > mempool > other), the `mempool/lanes.py` machinery adapted to
message units: each cycle every backlogged class is granted its quantum and
classes are drained high-to-low, so consensus bytes go first while heavily
out-weighted low classes still progress every cycle.  A starvation hatch
promotes any message older than `CMTPU_RECVQ_STARVATION_MS` ahead of the
DRR pass (oldest first, like `sidecar/engine.py`), bounding worst-case
queue delay under a sustained high-class storm.

Queues are bounded (`CMTPU_RECVQ_MAX` messages per channel) with a
per-class overflow policy: consensus/blocksync overflow BLOCKS the framer
(TCP backpressure propagates to the sender — these messages must never be
dropped), mempool/other overflow SHEDS the arriving message (gossip is
best-effort and retried by design).  Per-channel FIFO order is preserved
unconditionally — the drain only ever pops queue heads — so delivery is
bit-identical per channel to the serialized path; only the interleaving
ACROSS channels changes.

The clock is injected (`simnet.clock` surface) so queue-delay accounting
and starvation ages run on virtual time inside simnet scenarios.
"""

from __future__ import annotations

import os
import threading
from collections import deque

from cometbft_tpu_torch.libs import threads

CLASS_CONSENSUS = 0
CLASS_BLOCKSYNC = 1
CLASS_MEMPOOL = 2
CLASS_OTHER = 3
CLASS_NAMES = ("consensus", "blocksync", "mempool", "other")

# Classes whose overflow sheds the arriving message instead of blocking
# the framer: loss here is the protocol's normal best-effort regime.
SHED_CLASSES = frozenset({CLASS_MEMPOOL, CLASS_OTHER})

DEFAULT_MAX = 1024
DEFAULT_STARVATION_MS = 100.0
DEFAULT_QUANTA = (8, 4, 2, 1)


def classify(chan_id: int) -> int:
    """Map a global channel byte id (p2p/reactor.py) to a drain class."""
    if 0x20 <= chan_id <= 0x23:  # consensus state/data/vote/vote-set-bits
        return CLASS_CONSENSUS
    if chan_id in (0x38, 0x40, 0x60, 0x61):  # evidence, blocksync, statesync
        return CLASS_BLOCKSYNC
    if chan_id == 0x30:  # mempool
        return CLASS_MEMPOOL
    return CLASS_OTHER  # PEX + anything future


def enabled() -> bool:
    return os.environ.get("CMTPU_RECVQ", "1").lower() not in ("0", "false", "off")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_quanta() -> tuple[int, ...]:
    raw = os.environ.get("CMTPU_RECVQ_QUANTA", "")
    if not raw:
        return DEFAULT_QUANTA
    try:
        parts = [max(1, int(x)) for x in raw.split(",")]
    except ValueError:
        return DEFAULT_QUANTA
    if len(parts) != len(CLASS_NAMES):
        return DEFAULT_QUANTA
    return tuple(parts)


class RecvQueues:
    """Per-connection bounded recv queues + one priority drain thread.

    ``push`` runs on the framer thread; ``deliver(chan_id, msg)`` runs on
    the drain thread.  A deliver exception stops the drain and surfaces
    through ``on_error`` — the same contract the inline path had.
    """

    def __init__(
        self,
        deliver,
        channels,
        clock=None,
        on_error=None,
        max_depth: int | None = None,
        starvation_ms: float | None = None,
        quanta: tuple[int, ...] | None = None,
    ):
        from cometbft_tpu_torch.simnet.clock import MonotonicClock

        self._deliver = deliver
        self._on_error = on_error
        self._clock = clock or MonotonicClock()
        self.max_depth = int(
            max_depth
            if max_depth is not None
            else _env_float("CMTPU_RECVQ_MAX", DEFAULT_MAX)
        )
        self.starvation_ms = (
            starvation_ms
            if starvation_ms is not None
            else _env_float("CMTPU_RECVQ_STARVATION_MS", DEFAULT_STARVATION_MS)
        )
        self.quanta = tuple(quanta) if quanta else _env_quanta()
        self._cv = threading.Condition()
        # chan_id -> deque[(msg_bytes, enqueue_time)]; registration order is
        # sorted ids so the within-class round robin is deterministic.
        self._queues: dict[int, deque] = {}
        self._class_chans: list[list[int]] = [[] for _ in CLASS_NAMES]
        for cid in sorted(channels):
            self._queues[cid] = deque()
            self._class_chans[classify(cid)].append(cid)
        self._rr = [0] * len(CLASS_NAMES)
        self._deficit = [0] * len(CLASS_NAMES)
        self._depth = 0
        self._stopped = False
        self._thread: threading.Thread | None = None
        self.counters_ = {
            "delivered": 0,
            "shed": 0,
            "promoted": 0,
            "backpressure_waits": 0,
            "max_delay_us": 0,
        }
        self.class_counters_ = [
            {"delivered": 0, "shed": 0, "promoted": 0} for _ in CLASS_NAMES
        ]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threads.spawn(self._drain_loop)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # -- producer side (framer thread) --------------------------------------

    def push(self, chan_id: int, msg: bytes) -> bool:
        """Enqueue a reassembled message.  Returns False when the message
        was shed (sheddable-class overflow) or the demux is stopped."""
        k = classify(chan_id)
        with self._cv:
            q = self._queues.get(chan_id)
            if q is None:  # unregistered channel: framer raises before this
                q = self._queues.setdefault(chan_id, deque())
                if chan_id not in self._class_chans[k]:
                    self._class_chans[k].append(chan_id)
            while len(q) >= self.max_depth:
                if self._stopped:
                    return False
                if k in SHED_CLASSES:
                    self.counters_["shed"] += 1
                    self.class_counters_[k]["shed"] += 1
                    return False
                # Backpressure: park the framer (and therefore the socket
                # read loop) until the drain makes room — the kernel's TCP
                # window then throttles the remote sender.
                self.counters_["backpressure_waits"] += 1
                self._cv.wait(0.1)
            if self._stopped:
                return False
            q.append((msg, self._clock.now()))
            self._depth += 1
            self._cv.notify_all()
        return True

    # -- consumer side (drain thread) ----------------------------------------

    def _select_locked(self):
        """Pick the next (chan_id, msg, enq_t, promoted) under the lock.

        Starvation hatch first: the OLDEST queue head past the age bound is
        delivered regardless of class (heads only, so per-channel FIFO
        holds).  Then one DRR step: classes high-to-low, each spending its
        deficit; when every backlogged class is exhausted the cycle refills
        all deficits from the quanta.
        """
        now = self._clock.now()
        cutoff = now - self.starvation_ms / 1000.0
        stale_chan, stale_t = -1, None
        highest_backlog = None
        for k, chans in enumerate(self._class_chans):
            for cid in chans:
                q = self._queues[cid]
                if not q:
                    continue
                if highest_backlog is None:
                    highest_backlog = k
                t = q[0][1]
                if t <= cutoff and (stale_t is None or t < stale_t):
                    stale_chan, stale_t = cid, t
        if highest_backlog is None:
            return None
        if stale_t is not None:
            k = classify(stale_chan)
            msg, enq_t = self._queues[stale_chan].popleft()
            # A promotion only counts when it bypassed backlogged work of a
            # strictly higher class (engine.py's accounting rule).
            promoted = k > highest_backlog
            return stale_chan, msg, enq_t, promoted
        while True:
            for k, chans in enumerate(self._class_chans):
                live = [c for c in chans if self._queues[c]]
                if not live:
                    self._deficit[k] = 0  # lanes.py: reset on empty
                    continue
                if self._deficit[k] <= 0:
                    continue
                self._deficit[k] -= 1
                cid = live[self._rr[k] % len(live)]
                self._rr[k] += 1
                msg, enq_t = self._queues[cid].popleft()
                return cid, msg, enq_t, False
            for k in range(len(CLASS_NAMES)):
                self._deficit[k] += self.quanta[k]

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while self._depth == 0 and not self._stopped:
                    self._cv.wait(0.1)
                if self._stopped:
                    return
                item = self._select_locked()
                if item is None:
                    continue
                cid, msg, enq_t, promoted = item
                k = classify(cid)
                self._depth -= 1
                self.counters_["delivered"] += 1
                self.class_counters_[k]["delivered"] += 1
                if promoted:
                    self.counters_["promoted"] += 1
                    self.class_counters_[k]["promoted"] += 1
                delay_us = int((self._clock.now() - enq_t) * 1e6)
                if delay_us > self.counters_["max_delay_us"]:
                    self.counters_["max_delay_us"] = delay_us
                self._cv.notify_all()  # wake backpressured pushers
            try:
                self._deliver(cid, msg)
            except Exception as e:
                if self._on_error is not None:
                    self._on_error(e)
                return

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Flat counter snapshot for gauges / the recvq_stats RPC."""
        with self._cv:
            out = {
                "depth": self._depth,
                "delivered_total": self.counters_["delivered"],
                "shed_total": self.counters_["shed"],
                "promoted_total": self.counters_["promoted"],
                "backpressure_waits": self.counters_["backpressure_waits"],
                "max_delay_us": self.counters_["max_delay_us"],
                "channels": {
                    f"{cid:#04x}": len(q)
                    for cid, q in self._queues.items()
                    if q
                },
            }
            for k, cname in enumerate(CLASS_NAMES):
                cc = self.class_counters_[k]
                out[f"{cname}_delivered"] = cc["delivered"]
                out[f"{cname}_shed"] = cc["shed"]
                out[f"{cname}_promoted"] = cc["promoted"]
            return out
