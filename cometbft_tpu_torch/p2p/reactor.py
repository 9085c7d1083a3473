"""Reactor interface (p2p/base_reactor.go:15) and the channel descriptor
(p2p/conn/connection.go:42), the port's copy of ``cometbft_tpu/p2p/reactor.py``
and of ``ChannelDescriptor`` in ``cometbft_tpu/p2p/conn/connection.py``.

Every networked subsystem implements this and registers on the Switch
(``p2p/switch.py``) with reserved global channel byte IDs: PEX 0x00,
consensus 0x20-0x23, mempool 0x30, evidence 0x38, blocksync 0x40, statesync
0x60-0x61. ``ChannelDescriptor`` is defined here once;
``p2p/conn/connection.py`` imports it where the reference defines it.
"""

from __future__ import annotations


class Reactor:
    def __init__(self, name: str):
        self.name = name
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> list:
        """ChannelDescriptors this reactor speaks on."""
        return []

    def init_peer(self, peer) -> None:
        """Called before the peer starts (base_reactor.go InitPeer)."""

    def add_peer(self, peer) -> None:
        """Called once the peer is running."""

    def remove_peer(self, peer, reason) -> None:
        pass

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class ChannelDescriptor:
    """conn/connection.go ChannelDescriptor."""

    def __init__(
        self,
        channel_id: int,
        priority: int = 1,
        send_queue_capacity: int = 100,
        recv_message_capacity: int = 22020096,
    ):
        self.id = channel_id
        self.priority = priority
        self.send_queue_capacity = send_queue_capacity
        self.recv_message_capacity = recv_message_capacity


# Reserved channel IDs.
PEX_CHANNEL = 0x00
CONSENSUS_STATE_CHANNEL = 0x20
CONSENSUS_DATA_CHANNEL = 0x21
CONSENSUS_VOTE_CHANNEL = 0x22
CONSENSUS_VOTE_SET_BITS_CHANNEL = 0x23
MEMPOOL_CHANNEL = 0x30
EVIDENCE_CHANNEL = 0x38
BLOCKSYNC_CHANNEL = 0x40
SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
