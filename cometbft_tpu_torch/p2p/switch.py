"""Switch: peer lifecycle + reactor routing (p2p/switch.go), the port's copy
of ``cometbft_tpu/p2p/switch.py``.

Reactors register channel descriptors; inbound/outbound peers get an
MConnection whose receive callback dispatches to the owning reactor.
Broadcast fan-outs TrySend to every peer (switch.go:271). Persistent peers
are redialed on a two-phase schedule (switch.go:474+ reconnectToPeer:
quick linear attempts, then exponential backoff).

Where the reference passes over an exception, the port does the same but
counts it here, with the last one kept: ``inbound_errors`` (an inbound
upgrade that failed: handshake, node info, compatibility),
``redial_errors`` (a persistent peer's failed dial), ``recvq_errors`` (a
peer's demux counters that could not be read). ``peer_errors`` counts the
peers stopped for an error (a dead connection, a reactor's receive that
raised), the reference's ``StopPeerForError``.

``config`` is a ``P2PConfig`` (default: its defaults); each peer's
``MConnection`` takes its packet size and rates from it.
"""

from __future__ import annotations

import contextlib
import random
import threading

from cometbft_tpu_torch.config import P2PConfig
from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnection
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.transport import MultiplexTransport, UpgradedConn

# Redial schedule — INTENTIONAL DIVERGENCE from the reference constants.
# switch.go:25-31 reconnectToPeer does 20 linear attempts at 5 s, then 3^i
# exponential backoff, and gives up after a finite attempt budget.  Here:
# 20 linear attempts at 1 s, then 2^i doubling capped at 60 s, retrying
# FOREVER (+/-20% jitter on every sleep).  Giving up permanently on a
# persistent peer costs liveness on small loopback testnets (a healed
# partition must always be redialed), so only the two-phase shape is kept.
REDIAL_LINEAR_ATTEMPTS = 20
REDIAL_LINEAR_SLEEP_S = 1.0
REDIAL_MAX_SLEEP_S = 60.0


def redial_delay(attempt: int) -> float:
    """Seconds to wait before redial `attempt` (1-based)."""
    if attempt <= REDIAL_LINEAR_ATTEMPTS:
        base = REDIAL_LINEAR_SLEEP_S
    else:
        # Clamp the exponent BEFORE computing the power: a peer down for
        # a day pushes attempt past 1000 and 2.0**1000 overflows float,
        # which would kill the redial thread right when persistence
        # matters most.
        exp = min(attempt - REDIAL_LINEAR_ATTEMPTS, 16)
        base = min(REDIAL_LINEAR_SLEEP_S * 2.0 ** exp, REDIAL_MAX_SLEEP_S)
    return base * (0.8 + 0.4 * random.random())


class Peer:
    """p2p/peer.go peer: MConnection + metadata."""

    def __init__(self, up: UpgradedConn, channel_descs, on_receive, on_error,
                 clock=None, config: P2PConfig | None = None):
        config = config if config is not None else P2PConfig()
        self.node_info = up.node_info
        self.id = up.peer_id
        self.is_outbound = up.outbound
        self.remote_ip = up.remote_addr.rsplit(":", 1)[0]
        self._kv: dict = {}
        self.mconn = MConnection(
            up.conn,
            channel_descs,
            lambda ch, msg: on_receive(self, ch, msg),
            lambda err: on_error(self, err),
            max_packet_msg_payload_size=config.max_packet_msg_payload_size,
            send_rate=config.send_rate,
            recv_rate=config.recv_rate,
            clock=clock,
        )

    def start(self) -> None:
        self.mconn.start()

    def stop(self) -> None:
        self.mconn.stop()

    def send(self, chan_id: int, msg_bytes: bytes) -> bool:
        return self.mconn.send(chan_id, msg_bytes)

    def try_send(self, chan_id: int, msg_bytes: bytes) -> bool:
        return self.mconn.try_send(chan_id, msg_bytes)

    def set(self, key: str, value) -> None:
        self._kv[key] = value

    def get(self, key: str):
        return self._kv.get(key)

    def node_info_json(self) -> dict:
        return self.node_info.to_json()


class Switch:
    """p2p/switch.go Switch."""

    def __init__(
        self, node_info: NodeInfo, transport: MultiplexTransport, config=None,
        clock=None,
    ):
        from cometbft_tpu_torch.simnet.clock import MonotonicClock

        self.node_info = node_info
        self.transport = transport
        self.config = config if config is not None else P2PConfig()
        self.clock = clock or MonotonicClock()
        self.reactors: dict[str, object] = {}
        self._chan_to_reactor: dict[int, object] = {}
        self._channel_descs: list[ChannelDescriptor] = []
        self._peers: dict[str, Peer] = {}
        self._mtx = threading.RLock()
        self._running = False
        self._stopped = threading.Event()
        # Threads the switch starts for outside callers (a dial from an RPC
        # handler or a test) join the group it was built in, its node's.
        self._group = threads.current_group()
        self._persistent_addrs: list[str] = []
        self._dialing: set[str] = set()
        # Peer instances whose connection died before they reached the
        # table (stop_peer_for_error in _add_peer's start->insert window).
        self._dead: set[Peer] = set()
        # Recv-demux counters folded in from stopped peers, so node-level
        # recvq_* gauges survive peer churn (depths die with the queues).
        self._recvq_retired: dict = {}
        self.inbound_errors = 0
        self.last_inbound_error = None
        self.redial_errors = 0
        self.last_redial_error = None
        self.recvq_errors = 0
        self.last_recvq_error = None
        self.peer_errors = 0
        self.last_peer_error = None

    def errors(self) -> dict:
        """The counted errors, by name."""
        return {"inbound_errors": self.inbound_errors, "redial_errors": self.redial_errors,
                "recvq_errors": self.recvq_errors, "peer_errors": self.peer_errors}

    # -- reactors -------------------------------------------------------------

    def add_reactor(self, name: str, reactor) -> None:
        """switch.go AddReactor: claims the reactor's channel ids."""
        for desc in reactor.get_channels():
            if desc.id in self._chan_to_reactor:
                raise ValueError(f"channel {desc.id:#x} already registered")
            self._chan_to_reactor[desc.id] = reactor
            self._channel_descs.append(desc)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        self.node_info.channels = bytes(sorted(self._chan_to_reactor))

    # -- lifecycle ------------------------------------------------------------

    def _scope(self):
        group = self._group
        return group.scope() if group is not None else contextlib.nullcontext()

    def start(self, listen_addr: str = "") -> str:
        with self._scope():
            return self._start(listen_addr)

    def _start(self, listen_addr: str) -> str:
        self._running = True
        self._stopped.clear()
        for reactor in self.reactors.values():
            reactor.start()
        actual = ""
        if listen_addr:
            actual = self.transport.listen(listen_addr, self._on_inbound)
            # Peers learn our dialable port from the handshake NodeInfo
            # (PEX hands it on): record the ACTUAL bound address, which
            # matters for the ephemeral :0 listeners tests use.
            if not self.node_info.listen_addr or self.node_info.listen_addr.endswith(":0"):
                self.node_info.listen_addr = actual
        return actual

    def stop(self) -> None:
        self._running = False
        self._stopped.set()
        with self._mtx:
            peers = list(self._peers.values())
        for p in peers:
            self.stop_peer_for_error(p, "switch stopping")
        self.transport.close()
        for reactor in self.reactors.values():
            reactor.stop()

    # -- peers ----------------------------------------------------------------

    def peers(self) -> list[Peer]:
        with self._mtx:
            return list(self._peers.values())

    def num_peers(self) -> int:
        with self._mtx:
            return len(self._peers)

    def get_peer(self, peer_id: str) -> Peer | None:
        with self._mtx:
            return self._peers.get(peer_id)

    def _on_inbound(self, result) -> None:
        if isinstance(result, Exception):
            self.inbound_errors += 1
            self.last_inbound_error = result
            return
        self._add_peer(result)

    def _add_peer(self, up: UpgradedConn) -> None:
        """switch.go:808 addPeer."""
        if up.peer_id == self.node_info.node_id:
            up.conn.close()  # self-connection
            return
        with self._mtx:
            if up.peer_id in self._peers:
                up.conn.close()
                return
        peer = Peer(up, self._channel_descs, self._on_peer_receive,
                    self._on_peer_error, clock=self.clock, config=self.config)
        for reactor in self.reactors.values():
            reactor.init_peer(peer)
        peer.start()
        with self._mtx:
            # Re-check at insert: a simultaneous cross-dial (inbound accept
            # + outbound dial, same id) passes the pre-upgrade duplicate
            # check in both threads; overwriting here would displace a peer
            # that reactors were told about and that stop_peer_for_error's
            # instance check would then never clean up. The _dead check
            # covers the other window: the conn can die between start()
            # and this insert, in which case stop_peer_for_error found no
            # table entry and tombstoned the instance — tabling it anyway
            # would park a permanently-idle ghost that blocks redial.
            if peer in self._dead:
                self._dead.discard(peer)
                dup = True
            elif up.peer_id in self._peers:
                dup = True
            elif not self._running:
                # stop() set _running before it took the peer table: a peer
                # tabled now would outlive it, its connection's threads too.
                dup = True
            else:
                self._peers[peer.id] = peer
                dup = False
        if dup:
            peer.stop()
            return
        for reactor in self.reactors.values():
            reactor.add_peer(peer)
        with self._mtx:
            still_tabled = self._peers.get(peer.id) is peer
        if not still_tabled:
            # Removal raced the add_peer loop above: the remover's
            # reactor.remove_peer ran before (some) add_peer calls, which
            # would leave gossip state for a stopped peer. remove_peer is
            # idempotent in every reactor, so re-run it.
            for reactor in self.reactors.values():
                reactor.remove_peer(peer, "removal raced add")

    def dial_peer(self, addr: str) -> Peer | None:
        """addr format: id@host:port."""
        with self._scope():
            return self._dial_peer(addr)

    def _dial_peer(self, addr: str) -> Peer | None:
        expected_id = addr.split("@", 1)[0] if "@" in addr else ""
        with self._mtx:
            if addr in self._dialing:
                return None
            self._dialing.add(addr)
        try:
            up = self.transport.dial(addr, expected_id)
            self._add_peer(up)
            return self.get_peer(up.peer_id)
        finally:
            with self._mtx:
                self._dialing.discard(addr)

    def add_persistent_peers(self, addrs: list[str]) -> None:
        self._persistent_addrs.extend(a for a in addrs if a)

    def dial_persistent_peers(self) -> None:
        """Two-phase redial loop (switch.go reconnectToPeer): a burst of
        quick linear attempts first — a healed partition reconnects in
        seconds instead of waiting out a grown exponential backoff — then
        exponential growth to a 60 s cap for genuinely-gone peers. Jitter
        keeps a rebooted validator set from dialing in lockstep."""

        def redial(addr):
            attempt = 0
            while self._running:
                expected_id = addr.split("@", 1)[0] if "@" in addr else ""
                if expected_id and self.get_peer(expected_id) is not None:
                    attempt = 0
                    self.clock.nap(5, self._stopped)
                    continue
                try:
                    self.dial_peer(addr)
                    attempt = 0
                except Exception as e:
                    self.redial_errors += 1
                    self.last_redial_error = e
                    attempt += 1
                    self.clock.nap(redial_delay(attempt), self._stopped)

        with self._scope():
            for addr in self._persistent_addrs:
                threads.spawn(redial, (addr,))

    def stop_peer_for_error(self, peer: Peer, reason) -> None:
        """switch.go StopPeerForError."""
        import os

        if os.environ.get("CMTPU_P2P_DEBUG"):
            import sys
            import traceback

            print(
                f"[p2p] stop_peer_for_error {peer.id[:8]}: {reason!r}",
                file=sys.stderr, flush=True,
            )
            if isinstance(reason, Exception):
                traceback.print_exception(reason, file=sys.stderr)
        if isinstance(reason, Exception):
            self.peer_errors += 1
            self.last_peer_error = reason
        with self._mtx:
            existing = self._peers.get(peer.id)
            if existing is peer:
                del self._peers[peer.id]
            else:
                # Not (or not yet) tabled: possibly an error that fired in
                # _add_peer's start()->insert window. Tombstone the
                # instance so _add_peer won't table a dead peer; bounded
                # because _add_peer discards matches and the set only
                # grows on repeated errors from never-tabled instances.
                self._dead.add(peer)
                while len(self._dead) > 256:
                    self._dead.pop()
        self._fold_recvq(peer)
        # Always stop THIS instance's threads, but only the instance that
        # owns the table entry may tear down reactor state: a dead
        # connection errors from both its send and recv routines, and with
        # fast redial the replacement peer (same id) can already be live
        # when the second error fires — removing BY ID here evicted the
        # replacement, killed its gossip threads, and left a ghost TCP conn
        # that made the remote reject every subsequent redial as a
        # duplicate. That was the partition-heal wedge.
        peer.stop()
        if existing is not peer:
            return
        for reactor in self.reactors.values():
            reactor.remove_peer(peer, reason)

    def _fold_recvq(self, peer: Peer) -> None:
        """Accumulate a dying peer's demux counters exactly once (a dead
        connection reaches stop_peer_for_error from both its send and recv
        routines)."""
        if getattr(peer, "_recvq_folded", False):
            return
        peer._recvq_folded = True
        try:
            st = peer.mconn.recvq_stats()
        except Exception as e:
            self._recvq_failed(e)
            return
        if not st:
            return
        with self._mtx:
            for key, v in st.items():
                if not isinstance(v, int) or key == "depth":
                    continue
                if key == "max_delay_us":
                    self._recvq_retired[key] = max(
                        self._recvq_retired.get(key, 0), v
                    )
                else:
                    self._recvq_retired[key] = self._recvq_retired.get(key, 0) + v

    def _recvq_failed(self, e: Exception) -> None:
        self.recvq_errors += 1
        self.last_recvq_error = e

    def recvq_stats(self) -> dict:
        """Aggregate recv-demux counters across live peers + retired totals
        (the recvq_* node gauges and the recvq_stats RPC read this)."""
        with self._mtx:
            out: dict = {"enabled": False, **self._recvq_retired}
            if self._recvq_retired:
                out["enabled"] = True
        channels: dict[str, int] = {}
        for p in self.peers():
            try:
                st = p.mconn.recvq_stats()
            except Exception as e:
                self._recvq_failed(e)
                continue
            if not st:
                continue
            out["enabled"] = True
            for key, v in st.items():
                if key == "channels":
                    for cid, d in v.items():
                        channels[cid] = channels.get(cid, 0) + d
                elif isinstance(v, int):
                    if key == "max_delay_us":
                        out[key] = max(out.get(key, 0), v)
                    else:
                        out[key] = out.get(key, 0) + v
        out["channels"] = channels
        out.setdefault("depth", 0)
        out.setdefault("delivered_total", 0)
        out.setdefault("shed_total", 0)
        out.setdefault("promoted_total", 0)
        out.setdefault("max_delay_us", 0)
        return out

    # -- routing --------------------------------------------------------------

    def _on_peer_receive(self, peer: Peer, chan_id: int, msg_bytes: bytes) -> None:
        reactor = self._chan_to_reactor.get(chan_id)
        if reactor is None:
            self.stop_peer_for_error(peer, f"unknown channel {chan_id:#x}")
            return
        try:
            reactor.receive(chan_id, peer, msg_bytes)
        except Exception as e:
            self.stop_peer_for_error(peer, e)

    def _on_peer_error(self, peer: Peer, err) -> None:
        self.stop_peer_for_error(peer, err)

    def broadcast(self, chan_id: int, msg_bytes: bytes) -> None:
        """switch.go:271 Broadcast: TrySend to every peer."""
        for peer in self.peers():
            peer.try_send(chan_id, msg_bytes)
