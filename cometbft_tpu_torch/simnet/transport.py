"""In-memory transport with a seeded WAN link model, the port's copy of
``cometbft_tpu/simnet/transport.py``.

``SimTransport`` duck-types the ``MultiplexTransport`` surface
(``listen(addr, accept_cb)`` / ``dial(addr, expected_id)`` / ``close()``)
and hands out the real :class:`cometbft_tpu_torch.p2p.transport.UpgradedConn`
wrapper, so a production ``Switch`` (and the ``MConnection`` threads it
spawns) runs over simulated links unchanged.

``SimNetwork`` owns the link model: per-pair base latency + seeded
jitter, optional bandwidth (serialization delay + a busy-until point per
directed link), and per-write drop.  Drops are whole-``write()`` calls —
``MConnection`` writes exactly one framed packet per call, so a dropped
write is a cleanly lost packet, never a desynced stream.  Partitions are
runtime-scriptable: ``partition(groups)`` silently discards traffic (and
refuses dials) across group boundaries until ``heal()``.

Delivery happens through ``clock.timer`` — a real ``MonotonicClock``
delivers on wall-time ``threading.Timer``s; a ``SimClock`` delivers when
the driver (or the blocked-actor advance) reaches the due time.  Per
directed link, delivery times are clamped monotonic so jitter can delay
but never reorder a byte stream.
"""

from __future__ import annotations

import random
import threading

from cometbft_tpu_torch.p2p.transport import TransportError, UpgradedConn
from cometbft_tpu_torch.simnet.clock import MonotonicClock


def _host_port(addr: str) -> str:
    """'proto://id@host:port' -> 'host:port' (mirrors transport._split_addr)."""
    if "://" in addr:
        addr = addr.split("://", 1)[1]
    if "@" in addr:
        addr = addr.split("@", 1)[1]
    return addr


class SimConn:
    """One endpoint of an in-memory duplex byte pipe.

    Surface = what ``MConnection`` and ``UpgradedConn`` need from a
    ``SecretConnection``: ``write``/``sendall``, ``read_exact``/``recv``,
    ``close``, and ``rem_pub_key`` (the peer-id source).
    """

    def __init__(self, network: "SimNetwork", local_id: str, remote_id: str, rem_pub_key):
        self.network = network
        self.local_id = local_id
        self.remote_id = remote_id
        self.rem_pub_key = rem_pub_key
        self.peer: "SimConn | None" = None  # set by the pairing dial
        self._buf = bytearray()
        self._cond = threading.Condition()
        self._closed = False
        self._eof = False  # peer closed: drain the buffer, then EOF

    # -- sending ------------------------------------------------------------

    def write(self, data: bytes) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        self.network._transmit(self, bytes(data))

    sendall = write

    # -- receiving ----------------------------------------------------------

    def _deliver(self, data: bytes) -> None:
        with self._cond:
            if self._closed:
                return
            self._buf += data
            self._cond.notify_all()

    def _signal_eof(self) -> None:
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    def read_exact(self, n: int) -> bytes:
        with self._cond:
            while len(self._buf) < n:
                if self._closed or self._eof:
                    raise ConnectionError("connection closed")
                # Real-time poll as a lost-wakeup backstop; deliveries
                # notify, so the common path never waits the full tick.
                self._cond.wait(0.1)
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def recv(self, n: int) -> bytes:
        with self._cond:
            while not self._buf:
                if self._closed or self._eof:
                    return b""  # socket-style EOF
                self._cond.wait(0.1)
            out = bytes(self._buf[:n])
            del self._buf[: len(out)]
            return out

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self.peer is not None:
            self.peer._signal_eof()


class SimNetwork:
    """Shared medium: listener registry + seeded per-link WAN model."""

    def __init__(
        self,
        clock=None,
        seed: int = 0,
        latency_s: float = 0.0,
        jitter_s: float = 0.0,
        bandwidth_bps: float = 0.0,  # 0 = infinite
        drop_p: float = 0.0,
    ):
        self.clock = clock or MonotonicClock()
        self._rng = random.Random(seed)
        self._mtx = threading.RLock()
        self._listeners: dict[str, SimTransport] = {}
        self._defaults = {
            "latency_s": latency_s,
            "jitter_s": jitter_s,
            "bandwidth_bps": bandwidth_bps,
            "drop_p": drop_p,
        }
        self._link_overrides: dict[frozenset, dict] = {}
        self._groups: list[set[str]] | None = None  # active partition
        # Per directed link: when the link frees up (bandwidth) and the
        # last scheduled delivery time (FIFO clamp under jitter).
        self._busy_until: dict[tuple[str, str], float] = {}
        self._last_delivery: dict[tuple[str, str], float] = {}
        # Per-source adversarial send taps (see set_send_tap).
        self._send_taps: dict[str, object] = {}
        self.stats = {"delivered": 0, "dropped": 0, "partitioned": 0, "tapped": 0}

    # -- topology scripting --------------------------------------------------

    def set_link(self, a_id: str, b_id: str, **params) -> None:
        """Override latency_s/jitter_s/bandwidth_bps/drop_p for one pair."""
        bad = set(params) - set(self._defaults)
        if bad:
            raise ValueError(f"unknown link params {sorted(bad)}")
        with self._mtx:
            self._link_overrides.setdefault(frozenset((a_id, b_id)), {}).update(params)

    def partition(self, groups) -> None:
        """Split the net: traffic (and dials) crossing group boundaries is
        silently discarded. Nodes in no group keep full connectivity."""
        with self._mtx:
            self._groups = [set(g) for g in groups]

    def heal(self) -> None:
        with self._mtx:
            self._groups = None

    def reachable(self, a_id: str, b_id: str) -> bool:
        with self._mtx:
            if self._groups is None:
                return True
            ga = next((g for g in self._groups if a_id in g), None)
            gb = next((g for g in self._groups if b_id in g), None)
            if ga is None or gb is None:
                return True
            return ga is gb

    def link_params(self, a_id: str, b_id: str) -> dict:
        with self._mtx:
            p = dict(self._defaults)
            p.update(self._link_overrides.get(frozenset((a_id, b_id)), {}))
            return p

    def set_send_tap(self, node_id: str, fn) -> None:
        """Install an adversarial tap on every write ``node_id`` makes.

        ``fn(dst_id, data)`` returns ``None`` to pass the write through
        untouched, or a list of ``(extra_delay_s, payload)`` replacements:
        ``[]`` drops the write, one entry delays/rewrites it, several
        duplicate it. Taps operate on whole ``write()`` calls — one framed
        MConnection packet — so a byzantine tap can reorder/replay/withhold
        *packets* without ever desyncing a stream (same granularity as the
        link drop model). ``fn=None`` removes the tap.
        """
        with self._mtx:
            if fn is None:
                self._send_taps.pop(node_id, None)
            else:
                self._send_taps[node_id] = fn

    # -- wire ----------------------------------------------------------------

    def _transmit(self, src: SimConn, data: bytes) -> None:
        dst = src.peer
        if dst is None:
            raise ConnectionError("unpaired conn")
        tap = self._send_taps.get(src.local_id)
        if tap is not None:
            plan = tap(src.remote_id, data)
            if plan is not None:
                self.stats["tapped"] += 1
                for extra_delay, payload in plan:
                    self._schedule(src, dst, bytes(payload), float(extra_delay))
                return
        self._schedule(src, dst, data, 0.0)

    def _schedule(self, src: SimConn, dst: SimConn, data: bytes, extra_delay: float) -> None:
        with self._mtx:
            if not self.reachable(src.local_id, src.remote_id):
                self.stats["partitioned"] += 1
                return
            p = self.link_params(src.local_id, src.remote_id)
            if p["drop_p"] > 0 and self._rng.random() < p["drop_p"]:
                self.stats["dropped"] += 1
                return
            now = self.clock.now()
            key = (src.local_id, src.remote_id)
            delay = p["latency_s"] + extra_delay
            if p["jitter_s"] > 0:
                delay += self._rng.uniform(0.0, p["jitter_s"])
            if p["bandwidth_bps"] > 0:
                tx = len(data) * 8.0 / p["bandwidth_bps"]
                start = max(now, self._busy_until.get(key, 0.0))
                self._busy_until[key] = start + tx
                deliver_at = start + tx + delay
            else:
                deliver_at = now + delay
            # FIFO per directed link: jitter may stretch, never reorder.
            deliver_at = max(deliver_at, self._last_delivery.get(key, 0.0))
            self._last_delivery[key] = deliver_at
            self.stats["delivered"] += 1
        self.clock.timer(max(deliver_at - now, 0.0), dst._deliver, data)

    # -- listeners ------------------------------------------------------------

    def _register(self, hp: str, transport: "SimTransport") -> str:
        with self._mtx:
            if hp in self._listeners:
                raise TransportError(f"sim address {hp} already bound")
            self._listeners[hp] = transport
            return hp

    def _unregister(self, transport: "SimTransport") -> None:
        with self._mtx:
            for hp, t in list(self._listeners.items()):
                if t is transport:
                    del self._listeners[hp]

    def _lookup(self, hp: str) -> "SimTransport | None":
        with self._mtx:
            return self._listeners.get(hp)


class SimTransport:
    """transport.MultiplexTransport duck-type over a SimNetwork."""

    def __init__(self, node_info, node_key, network: SimNetwork, fuzz_config=None):
        # fuzz_config accepted for factory-signature parity; the link model
        # subsumes it (latency/drop live in SimNetwork, seeded).
        self.node_info = node_info
        self.node_key = node_key
        self.network = network
        self._accept_cb = None
        self._closed = False

    def listen(self, addr: str, accept_cb) -> str:
        actual = self.network._register(_host_port(addr), self)
        self._accept_cb = accept_cb
        if not self.node_info.listen_addr:
            self.node_info.listen_addr = actual
        return actual

    def dial(self, addr: str, expected_id: str = "") -> UpgradedConn:
        if self._closed:
            raise TransportError("transport closed")
        hp = _host_port(addr)
        remote = self.network._lookup(hp)
        if remote is None or remote._closed or remote._accept_cb is None:
            raise TransportError(f"sim dial {hp}: no listener")
        if not self.network.reachable(self.node_key.id, remote.node_key.id):
            raise TransportError(f"sim dial {hp}: partitioned")
        if expected_id and remote.node_key.id != expected_id:
            raise TransportError(
                f"dialed {expected_id} but got {remote.node_key.id}"
            )
        try:
            self.node_info.compatible_with(remote.node_info)
        except Exception as e:
            raise TransportError(f"incompatible peer: {e}") from None
        out = SimConn(
            self.network, self.node_key.id, remote.node_key.id,
            remote.node_key.pub_key(),
        )
        inb = SimConn(
            self.network, remote.node_key.id, self.node_key.id,
            self.node_key.pub_key(),
        )
        out.peer, inb.peer = inb, out
        up_out = UpgradedConn(out, remote.node_info, outbound=True, remote_addr=hp)
        up_in = UpgradedConn(
            inb, self.node_info, outbound=False,
            remote_addr=self.node_info.listen_addr or f"{self.node_key.id[:8]}:0",
        )
        # In-process accept: the listener learns of the conn synchronously
        # (the real transport hands it to the accept thread's callback).
        remote._accept_cb(up_in)
        return up_out

    def close(self) -> None:
        self._closed = True
        self.network._unregister(self)
