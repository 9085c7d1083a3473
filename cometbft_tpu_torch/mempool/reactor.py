"""Mempool gossip reactor (mempool/reactor.go, channel 0x30), the port's copy
of ``cometbft_tpu/mempool/reactor.py``.

One broadcast thread per peer walks the mempool FIFO and forwards txs the
peer hasn't seen from us (reactor.go:132 broadcastTxRoutine); received txs
enter CheckTx with the sender recorded so they aren't echoed back.

``mempool`` here is the admission surface (``check_tx(tx, sender=...)``):
when the node wires the QoS ingress pipeline (mempool/ingress.py), gossiped
txs flow through the same envelope-preverify/lane/shedding path as RPC
submissions. A received transaction that ``check_tx`` refuses is passed over
as in the reference (duplicates and a full mempool are expected during
gossip) and counted by the exception's class in ``check_tx_errors``, the
last kept in ``last_check_tx_error``.
"""

from __future__ import annotations


from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import MEMPOOL_CHANNEL, Reactor
from cometbft_tpu_torch.types.tx import tx_key
from cometbft_tpu_torch.wire import proto as wire


def encode_txs_message(txs: list[bytes]) -> bytes:
    """tendermint.mempool.Txs{txs=1 repeated}."""
    inner = b""
    for tx in txs:
        inner += wire.field_bytes(1, tx, emit_default=True)
    return wire.field_message(1, inner, emit_empty=True)


def decode_txs_message(data: bytes) -> list[bytes]:
    f = wire.decode_fields(data)
    inner = wire.decode_fields(wire.get_bytes(f, 1))
    return wire.get_repeated_bytes(inner, 1)


class MempoolReactor(Reactor):
    def __init__(self, config, mempool, clock=None):
        from cometbft_tpu_torch.simnet.clock import MonotonicClock

        super().__init__("MEMPOOL")
        self.config = config
        self.mempool = mempool
        self.clock = clock or MonotonicClock()
        self._running = False
        self._peer_sent: dict[str, set] = {}
        self.check_tx_errors: dict[str, int] = {}
        self.last_check_tx_error = None

    def get_channels(self):
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5, send_queue_capacity=100)]

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def add_peer(self, peer) -> None:
        if not self.config.broadcast:
            return
        self._peer_sent[peer.id] = set()
        threads.spawn(self._broadcast_tx_routine, (peer,))

    def remove_peer(self, peer, reason) -> None:
        self._peer_sent.pop(peer.id, None)

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        for tx in decode_txs_message(msg_bytes):
            try:
                self.mempool.check_tx(tx, sender=peer.id)
            except Exception as e:  # duplicates / full mempool are expected during gossip
                name = type(e).__name__
                self.check_tx_errors[name] = self.check_tx_errors.get(name, 0) + 1
                self.last_check_tx_error = e

    def _broadcast_tx_routine(self, peer) -> None:
        """mempool/reactor.go:132."""
        while self._running and peer.id in self._peer_sent:
            sent_set = self._peer_sent.get(peer.id)
            if sent_set is None:
                return
            batch, keys = [], []
            for mtx in self.mempool.txs_front():
                k = tx_key(mtx.tx)
                if k in sent_set or peer.id in mtx.senders:
                    continue
                keys.append(k)
                batch.append(mtx.tx)
            if batch and peer.try_send(MEMPOOL_CHANNEL, encode_txs_message(batch)):
                # Mark AFTER a successful enqueue: a full send queue drops
                # the message, and pre-marking would lose those txs from
                # gossip forever (same backpressure-liveness rule as the
                # consensus gossip).
                sent_set.update(keys)
            self.clock.sleep(0.05)
