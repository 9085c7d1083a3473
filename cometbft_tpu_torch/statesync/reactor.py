"""Statesync p2p reactor (statesync/reactor.go: channels 0x60/0x61,
snapshot/chunk serving from the local app, response routing into the
syncer), the port's copy of ``cometbft_tpu/statesync/reactor.py``.
``set_syncer`` takes the ``Syncer`` of ``statesync/syncer`` (or any object
with ``add_snapshot`` and ``add_chunk``)."""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci_types
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.reactor import Reactor
from cometbft_tpu_torch.statesync import messages as m

# reactor.go: recentSnapshots served per request.
RECENT_SNAPSHOTS = 10


class StatesyncReactor(Reactor):
    """statesync/reactor.go Reactor. Serving side always on; the syncing side
    activates when a Syncer is attached (node boot phase)."""

    def __init__(self, snapshot_conn=None, syncer=None):
        super().__init__("STATESYNC")
        self.snapshot_conn = snapshot_conn  # local app's snapshot connection
        self.syncer = syncer

    def set_syncer(self, syncer) -> None:
        self.syncer = syncer

    def get_channels(self):
        return [
            ChannelDescriptor(
                m.SNAPSHOT_CHANNEL,
                priority=5,
                send_queue_capacity=10,
                recv_message_capacity=4 * 1024 * 1024,
            ),
            ChannelDescriptor(
                m.CHUNK_CHANNEL,
                priority=3,
                send_queue_capacity=4,
                recv_message_capacity=20 * 1024 * 1024,
            ),
        ]

    def add_peer(self, peer) -> None:
        """reactor.go AddPeer: a syncing node asks every new peer for its
        snapshots."""
        if self.syncer is not None:
            peer.try_send(m.SNAPSHOT_CHANNEL, m.encode(m.SnapshotsRequest()))

    def request_snapshots(self) -> None:
        """Broadcast discovery (syncer.go SyncAny's periodic re-discovery)."""
        if self.switch:
            self.switch.broadcast(m.SNAPSHOT_CHANNEL, m.encode(m.SnapshotsRequest()))

    def request_chunk(self, peer_id: str, height: int, fmt: int, index: int) -> None:
        peer = self.switch.get_peer(peer_id) if self.switch else None
        if peer is not None:
            peer.try_send(
                m.CHUNK_CHANNEL,
                m.encode(m.ChunkRequest(height=height, format=fmt, index=index)),
            )

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        msg = m.decode(msg_bytes)
        if isinstance(msg, m.SnapshotsRequest):
            for snap in self._local_snapshots():
                peer.try_send(
                    m.SNAPSHOT_CHANNEL,
                    m.encode(
                        m.SnapshotsResponse(
                            height=snap.height,
                            format=snap.format,
                            chunks=snap.chunks,
                            hash=snap.hash,
                            metadata=snap.metadata,
                        )
                    ),
                )
        elif isinstance(msg, m.SnapshotsResponse):
            if self.syncer is not None:
                self.syncer.add_snapshot(peer.id, msg)
        elif isinstance(msg, m.ChunkRequest):
            chunk = b""
            if self.snapshot_conn is not None:
                res = self.snapshot_conn.load_snapshot_chunk(
                    abci_types.RequestLoadSnapshotChunk(
                        height=msg.height, format=msg.format, chunk=msg.index
                    )
                )
                chunk = res.chunk
            peer.try_send(
                m.CHUNK_CHANNEL,
                m.encode(
                    m.ChunkResponse(
                        height=msg.height,
                        format=msg.format,
                        index=msg.index,
                        chunk=chunk,
                        missing=not chunk,
                    )
                ),
            )
        elif isinstance(msg, m.ChunkResponse):
            if self.syncer is not None and not msg.missing:
                self.syncer.add_chunk(msg.height, msg.format, msg.index, msg.chunk)

    def _local_snapshots(self):
        """reactor.go recentSnapshots: newest first, capped."""
        if self.snapshot_conn is None:
            return []
        res = self.snapshot_conn.list_snapshots(abci_types.RequestListSnapshots())
        snaps = sorted(res.snapshots, key=lambda s: (s.height, s.format), reverse=True)
        return snaps[:RECENT_SNAPSHOTS]
