"""Evidence gossip reactor (evidence/reactor.go, channel 0x38), the port's
copy of ``cometbft_tpu/evidence/reactor.py``.

Pending evidence is broadcast to every peer (reactor.go:107 broadcast
routine); received evidence is verified and pooled. The switch and the
peers are duck-typed (a peer's ``id`` and ``try_send``), as in blocksync.

Evidence from a peer that the pool refuses is dropped, as in the JAX
package, but counted (``receive_errors``, the last exception in
``last_receive_error``).
"""
from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.p2p.reactor import EVIDENCE_CHANNEL, ChannelDescriptor, Reactor
from cometbft_tpu_torch.types.evidence import decode_evidence, encode_evidence
from cometbft_tpu_torch.wire import proto as wire


def encode_evidence_list_msg(evidence: list) -> bytes:
    inner = b""
    for ev in evidence:
        inner += wire.field_message(1, encode_evidence(ev), emit_empty=True)
    return inner


def decode_evidence_list_msg(data: bytes) -> list:
    f = wire.decode_fields(data)
    return [decode_evidence(b) for b in wire.get_repeated_bytes(f, 1)]


class EvidenceReactor(Reactor):
    def __init__(self, evpool):
        super().__init__("EVIDENCE")
        self.evpool = evpool
        self._running = False
        self._peer_sent: dict[str, set] = {}
        self.receive_errors = 0
        self.last_receive_error: BaseException | None = None

    def get_channels(self):
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6, send_queue_capacity=100)]

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def add_peer(self, peer) -> None:
        self._peer_sent[peer.id] = set()
        threading.Thread(target=self._broadcast_routine, args=(peer,), daemon=True).start()

    def remove_peer(self, peer, reason) -> None:
        self._peer_sent.pop(peer.id, None)

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        for ev in decode_evidence_list_msg(msg_bytes):
            try:
                self.evpool.add_evidence(ev)
            except Exception as e:
                # invalid or expired evidence from a peer is dropped
                self.receive_errors += 1
                self.last_receive_error = e

    def _broadcast_routine(self, peer) -> None:
        while self._running and peer.id in self._peer_sent:
            sent = self._peer_sent.get(peer.id)
            if sent is None:
                return
            pending, _ = self.evpool.pending_evidence(-1)
            fresh = [ev for ev in pending if ev.hash() not in sent]
            if fresh:
                for ev in fresh:
                    sent.add(ev.hash())
                peer.try_send(EVIDENCE_CHANNEL, encode_evidence_list_msg(fresh))
            time.sleep(0.2)
