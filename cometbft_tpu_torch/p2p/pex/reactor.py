"""PEX reactor: peer discovery over channel 0x00 (p2p/pex/pex_reactor.go),
the port's copy of ``cometbft_tpu/p2p/pex/reactor.py``.

Protocol (proto tendermint.p2p.Message oneof): PexRequest (field 1, empty)
asks for addresses; PexAddrs (field 2, repeated NetAddress{id,ip,port})
answers. A peer may only send PexAddrs after we asked (unsolicited lists are
a fingerprinting/poisoning vector — pex_reactor.go:268), and may only ask at
a bounded rate (:253 receiveRequest).

ensurePeersRoutine dials book addresses until max_num_outbound_peers is
reached; in seed mode the reactor crawls (dial → exchange → disconnect) and
serves its book to inbound nodes, pex_reactor.go:39,:478 crawlPeersRoutine.

Where the original swallows an exception, the port keeps the behaviour and
counts it: a failed dial in ``dial_errors`` (the last in
``last_dial_error``). ``stop()`` ends every thread the reactor started: the
ensure-peers loop waits on an event instead of sleeping (the dial threads
and seed hang-up timers end on their own, in the node's thread group).
"""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook, NetAddress
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.wire import proto as wire

PEX_CHANNEL = 0x00


def encode_pex_request() -> bytes:
    return wire.field_message(1, b"", emit_empty=True)


def encode_pex_addrs(addrs: list[NetAddress]) -> bytes:
    body = b""
    for a in addrs:
        na = (
            wire.field_string(1, a.id)
            + wire.field_string(2, a.ip)
            + wire.field_varint(3, a.port)
        )
        body += wire.field_message(1, na, emit_empty=True)
    return wire.field_message(2, body, emit_empty=True)


def decode_pex_message(data: bytes):
    f = wire.decode_fields(data)
    if 1 in f:
        return ("request", None)
    if 2 in f:
        inner = wire.decode_fields(wire.get_bytes(f, 2))
        addrs = []
        for b in wire.get_repeated_bytes(inner, 1):
            af = wire.decode_fields(b)
            addrs.append(
                NetAddress(
                    id=wire.get_string(af, 1).lower(),
                    ip=wire.get_string(af, 2),
                    port=wire.get_uvarint(af, 3),
                )
            )
        return ("addrs", addrs)
    raise ValueError("unknown pex message")


class PexReactor(Reactor):
    """p2p/pex/pex_reactor.go Reactor."""

    def __init__(
        self,
        book: AddrBook,
        seeds: list[str] | None = None,
        seed_mode: bool = False,
        ensure_interval: float = 30.0,
        max_outbound: int = 10,
        request_interval: float = 10.0,
    ):
        super().__init__("PEX")
        self.book = book
        self.seeds = [s for s in (seeds or []) if s]
        self.seed_mode = seed_mode
        self.ensure_interval = ensure_interval
        self.max_outbound = max_outbound
        self.request_interval = request_interval
        self._requests_sent: set[str] = set()  # peers we asked (may answer)
        self._last_request_from: dict[str, float] = {}  # rate limit inbound asks
        self._attempts: dict[str, int] = {}
        self._mtx = threading.Lock()
        self._running = False
        self._stopped = threading.Event()
        self.dial_errors = 0
        self.last_dial_error = None

    def get_channels(self):
        return [
            ChannelDescriptor(
                PEX_CHANNEL, priority=1, send_queue_capacity=10,
                recv_message_capacity=64 * 1024,
            )
        ]

    def start(self) -> None:
        self._running = True
        self._stopped.clear()
        threads.spawn(self._ensure_peers_routine, name="pex-ensure")

    def stop(self) -> None:
        self._running = False
        self._stopped.set()
        self.book.save()

    # -- peer events ----------------------------------------------------------

    def add_peer(self, peer) -> None:
        """pex_reactor.go:173 AddPeer: learn an inbound peer's self-reported
        address; ask an outbound peer for more when the book runs low."""
        addr = self._peer_net_address(peer)
        if peer.is_outbound:
            if addr is not None:
                self.book.mark_good(peer.id)
            if self.book.need_more_addrs() and not self.seed_mode:
                self._request_addrs(peer)
        elif addr is not None:
            self.book.add_address(addr, addr)

    def remove_peer(self, peer, reason) -> None:
        with self._mtx:
            self._requests_sent.discard(peer.id)
            # The inbound rate-limit clock must die with the connection
            # (pex_reactor.go:206-212 deletes lastReceivedRequests): a peer
            # reconnecting after a partition asks for addresses immediately,
            # and a stale timestamp would punish it as an abuser — dropping
            # the peer again and looping redial against the rate limit.
            self._last_request_from.pop(peer.id, None)

    def _peer_net_address(self, peer) -> NetAddress | None:
        """Observed IP + self-reported listen port (pex_reactor.go uses
        NodeInfo.NetAddress)."""
        la = peer.node_info.listen_addr
        if not la:
            return None
        port = la.rsplit(":", 1)[-1]
        try:
            return NetAddress(id=peer.id, ip=peer.remote_ip, port=int(port))
        except ValueError:
            return None

    # -- receive --------------------------------------------------------------

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        kind, payload = decode_pex_message(msg_bytes)
        if kind == "request":
            # Check-and-set under the same lock remove_peer pops under: an
            # in-flight request racing a disconnect must not write a stale
            # timestamp back after the pop (it would punish the reconnect).
            with self._mtx:
                now = time.monotonic()
                last = self._last_request_from.get(peer.id, 0.0)
                if now - last < self.request_interval and not self.seed_mode:
                    raise ValueError("peer is asking for addresses too often")
                self._last_request_from[peer.id] = now
            sel = self.book.get_selection()
            me = self._self_net_address()
            if me is not None:
                sel = [me] + [a for a in sel if a.id != me.id]
            peer.try_send(PEX_CHANNEL, encode_pex_addrs(sel))
            if self.seed_mode and peer.is_outbound is False:
                # Seeds serve then hang up to stay available (crawler shape).
                threads.timer(
                    1.0, lambda: self.switch
                    and self.switch.stop_peer_for_error(peer, "seed disconnect")
                )
        elif kind == "addrs":
            with self._mtx:
                asked = peer.id in self._requests_sent
                self._requests_sent.discard(peer.id)
            if not asked:
                raise ValueError("unsolicited pex addrs")
            src = self._peer_net_address(peer) or NetAddress(
                id=peer.id, ip=peer.remote_ip, port=0
            )
            for a in payload[:100]:
                self.book.add_address(a, src)

    def _self_net_address(self) -> NetAddress | None:
        """Our own dialable address, so one hop through a seed is enough for
        third parties to find us."""
        if self.switch is None:
            return None
        la = self.switch.node_info.listen_addr
        if not la:
            return None
        host, _, port = la.split("://")[-1].rpartition(":")
        try:
            return NetAddress(id=self.switch.node_info.node_id, ip=host or "127.0.0.1", port=int(port))
        except ValueError:
            return None

    def _request_addrs(self, peer) -> None:
        with self._mtx:
            if peer.id in self._requests_sent:
                return
            self._requests_sent.add(peer.id)
        peer.try_send(PEX_CHANNEL, encode_pex_request())

    # -- ensure-peers loop -----------------------------------------------------

    def _ensure_peers_routine(self) -> None:
        self._dial_seeds()
        while self._running:
            self._ensure_peers()
            if self._stopped.wait(self.ensure_interval):
                return

    def _dial_seeds(self) -> None:
        for s in self.seeds:
            try:
                addr = NetAddress.parse(s)
                self.book.add_address(addr, addr)
            except ValueError:
                continue

    def _ensure_peers(self) -> None:
        """pex_reactor.go:313 ensurePeers: top up outbound connections from
        the book, ask a connected peer for more when dry."""
        if self.switch is None:
            return
        out = sum(1 for p in self.switch.peers() if p.is_outbound)
        need = self.max_outbound - out
        if need <= 0:
            return
        connected = {p.id for p in self.switch.peers()}
        tried = set()
        for _ in range(need * 3):
            cand = self.book.pick_address(bias_towards_new=30 if out > 4 else 70)
            if cand is None:
                break
            if cand.id in connected or cand.id in tried:
                continue
            tried.add(cand.id)
            self.book.mark_attempt(cand)
            threads.spawn(self._dial, (cand,), name="pex-dial")
        if self.book.is_empty() or (need > 0 and not tried):
            peers = self.switch.peers()
            if peers:
                import random

                self._request_addrs(random.choice(peers))

    def _dial(self, cand: NetAddress) -> None:
        try:
            peer = self.switch.dial_peer(cand.dial_string())
            if peer is not None:
                self.book.mark_good(cand.id)
        except Exception as e:
            with self._mtx:
                self.dial_errors += 1
                self.last_dial_error = e
                self._attempts[cand.id] = self._attempts.get(cand.id, 0) + 1
                if self._attempts[cand.id] >= 5:
                    self.book.mark_bad(cand)
