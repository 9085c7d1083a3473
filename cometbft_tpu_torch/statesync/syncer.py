"""Statesync syncer: pick a snapshot, restore the app from chunks, verify
against light-client truth (CometBFT's statesync/syncer.go — SyncAny :145,
offerSnapshot :322, fetchChunks/applyChunks :358-470, verifyApp :485;
chunk bookkeeping from statesync/chunks.go, candidate ranking from
statesync/snapshots.go).

Host-tier design: the syncer is driven by one thread (the node's statesync
phase); chunk fetch requests go out through the reactor, responses arrive on
the reactor's receive path and land in a condition-guarded chunk table. A
small pool of request threads keeps `chunk_fetchers` requests in flight —
the same pipeline CometBFT builds with goroutines. The port's copy of
``cometbft_tpu/statesync/syncer.py``."""

from __future__ import annotations

import threading
import time

from cometbft_tpu_torch.abci import types as abci_types
from cometbft_tpu_torch.statesync.messages import SnapshotsResponse

# DoS bound on peer-supplied snapshot metadata: chunk tables are allocated
# up-front, so an unvalidated `chunks` would let one malicious
# SnapshotsResponse OOM the node (CometBFT bounds it via chunkMsgSize etc.).
MAX_SNAPSHOT_CHUNKS = 16384


class ErrNoSnapshots(Exception):
    """syncer.go errNoSnapshots: no viable snapshot (left)."""


class ErrRejectSnapshot(Exception):
    """App rejected this snapshot; try another."""


class ErrAbort(Exception):
    """App aborted statesync entirely (syncer.go errAbort)."""


class ErrVerifyFailed(Exception):
    """Restored app does not match the trusted app hash."""


class _Candidate:
    def __init__(self, snapshot: SnapshotsResponse):
        self.snapshot = snapshot
        self.peers: set[str] = set()
        self.rejected = False


class Syncer:
    """statesync/syncer.go syncer."""

    def __init__(
        self,
        snapshot_conn,
        query_conn,
        state_provider,
        request_chunk,
        chunk_timeout: float = 10.0,
        chunk_fetchers: int = 4,
        logger=None,
    ):
        self.snapshot_conn = snapshot_conn
        self.query_conn = query_conn
        self.state_provider = state_provider
        self.request_chunk = request_chunk  # (peer_id, height, format, index)
        self.chunk_timeout = chunk_timeout
        self.chunk_fetchers = chunk_fetchers
        self.logger = logger
        self._lock = threading.Condition()
        self._candidates: dict[tuple, _Candidate] = {}
        self._chunks: dict[int, bytes] = {}
        self._current: SnapshotsResponse | None = None
        self._banned_peers: set[str] = set()
        # Counted exceptions (the JAX package's sync_any swallows them): each
        # candidate try that failed and was kept for a retry, and the last.
        self.retry_errors = 0
        self.last_retry_error: BaseException | None = None
        self._stopped = False

    def stop(self) -> None:
        """Ends ``sync_any`` with ErrAbort at its next wait (a node stopping
        while it syncs)."""
        with self._lock:
            self._stopped = True
            self._lock.notify_all()

    def _wait(self, seconds: float) -> None:
        """Waits on the chunk table's condition; raises ErrAbort once stopped."""
        with self._lock:
            if not self._stopped:
                self._lock.wait(seconds)
            if self._stopped:
                raise ErrAbort("statesync stopped")

    # -- inputs from the reactor ---------------------------------------------

    def add_snapshot(self, peer_id: str, snapshot: SnapshotsResponse) -> None:
        """syncer.go AddSnapshot: register a peer's snapshot offer."""
        if (
            snapshot.height <= 0
            or not 1 <= snapshot.chunks <= MAX_SNAPSHOT_CHUNKS
        ):
            return
        with self._lock:
            cand = self._candidates.setdefault(snapshot.key(), _Candidate(snapshot))
            cand.peers.add(peer_id)
            self._lock.notify_all()

    def add_chunk(self, height: int, fmt: int, index: int, chunk: bytes) -> None:
        """syncer.go AddChunk via chunks.go: accept only chunks for the
        snapshot currently being restored."""
        with self._lock:
            cur = self._current
            if cur is None or height != cur.height or fmt != cur.format:
                return
            if index not in self._chunks:
                self._chunks[index] = chunk
                self._lock.notify_all()

    # -- the sync loop --------------------------------------------------------

    def sync_any(self, discovery_time: float = 2.0, timeout: float = 120.0, request_hook=None):
        """syncer.go:145 SyncAny: wait for discovery, then try candidates
        best-first until one restores. Returns (state, commit).
        ``request_hook`` asks the connected peers for their snapshots, as
        Go's does, before discovery and whenever no candidate is left (the
        JAX package's takes none: its peers are asked only as they are
        added, ROADMAP F9)."""
        deadline = time.time() + timeout
        if request_hook is not None:
            request_hook()
        end_discovery = time.monotonic() + discovery_time
        while time.monotonic() < end_discovery:
            self._wait(end_discovery - time.monotonic())
        while time.time() < deadline:
            cand = self._best_candidate()
            if cand is None:
                if request_hook is not None:
                    request_hook()
                self._wait(1.0)
                continue
            try:
                return self._sync_one(cand, deadline)
            except (ErrRejectSnapshot, ErrVerifyFailed) as e:
                cand.rejected = True
                self._log(
                    f"snapshot {cand.snapshot.height} unusable ({e}); trying next"
                )
            except ErrAbort:
                raise
            except Exception as e:
                # Provider hiccup (e.g. the light provider can't serve H+2
                # for a tip snapshot yet): keep the candidate, retry shortly
                # — syncer.go SyncAny's retry loop. Bounded by `deadline`.
                self.retry_errors += 1
                self.last_retry_error = e
                self._log(f"snapshot {cand.snapshot.height} retry later: {e}")
                self._wait(1.0)
        raise ErrNoSnapshots("statesync timed out without a restorable snapshot")

    def _best_candidate(self) -> _Candidate | None:
        """snapshots.go Best(): highest height, then newest format, then most
        peers."""
        with self._lock:
            viable = [
                c
                for c in self._candidates.values()
                if not c.rejected and c.peers - self._banned_peers
            ]
        if not viable:
            return None
        return max(
            viable,
            key=lambda c: (c.snapshot.height, c.snapshot.format, len(c.peers)),
        )

    def _sync_one(self, cand: _Candidate, deadline: float):
        snapshot = cand.snapshot
        trusted_app_hash = self.state_provider.app_hash(snapshot.height)
        self._offer(snapshot, trusted_app_hash)
        with self._lock:
            self._current = snapshot
            self._chunks = {}
        try:
            self._fetch_and_apply(cand, deadline)
        finally:
            with self._lock:
                self._current = None
        state = self.state_provider.state(snapshot.height)
        commit = self.state_provider.commit(snapshot.height)
        self._verify_app(snapshot, state)
        return state, commit

    def _offer(self, snapshot: SnapshotsResponse, app_hash: bytes) -> None:
        """syncer.go:322 offerSnapshot."""
        res = self.snapshot_conn.offer_snapshot(
            abci_types.RequestOfferSnapshot(
                snapshot=abci_types.Snapshot(
                    height=snapshot.height,
                    format=snapshot.format,
                    chunks=snapshot.chunks,
                    hash=snapshot.hash,
                    metadata=snapshot.metadata,
                ),
                app_hash=app_hash,
            )
        )
        if res.result == abci_types.OFFER_SNAPSHOT_ACCEPT:
            return
        if res.result == abci_types.OFFER_SNAPSHOT_ABORT:
            raise ErrAbort("app aborted statesync on snapshot offer")
        raise ErrRejectSnapshot(f"offer result {res.result}")

    def _fetch_and_apply(self, cand: _Candidate, deadline: float) -> None:
        """syncer.go:358-470: pipelined fetch (chunk_fetchers in flight) +
        strictly in-order apply, with refetch rollback."""
        snapshot = cand.snapshot
        next_apply = 0
        requested_at: dict[int, float] = {}
        rr = 0
        while next_apply < snapshot.chunks:
            if time.time() > deadline:
                raise ErrNoSnapshots("chunk fetch timed out")
            peers = sorted(cand.peers - self._banned_peers)
            if not peers:
                raise ErrRejectSnapshot("no peers left serving this snapshot")
            now = time.time()
            with self._lock:
                outstanding = [
                    i
                    for i in range(next_apply, snapshot.chunks)
                    if i not in self._chunks
                ]
                in_flight = sum(
                    1
                    for i in outstanding
                    if now - requested_at.get(i, -1e18) <= self.chunk_timeout
                )
                to_request = [
                    i
                    for i in outstanding
                    if now - requested_at.get(i, -1e18) > self.chunk_timeout
                ][: max(0, self.chunk_fetchers - in_flight)]
            for i in to_request:
                peer = peers[rr % len(peers)]
                rr += 1
                requested_at[i] = now
                self.request_chunk(peer, snapshot.height, snapshot.format, i)
            with self._lock:
                if self._stopped:
                    raise ErrAbort("statesync stopped")
                if next_apply not in self._chunks:
                    self._lock.wait(0.05)
                    continue
                chunk = self._chunks[next_apply]
            res = self.snapshot_conn.apply_snapshot_chunk(
                abci_types.RequestApplySnapshotChunk(index=next_apply, chunk=chunk)
            )
            if res.result == abci_types.APPLY_CHUNK_ABORT:
                raise ErrAbort("app aborted statesync on chunk apply")
            if res.result == abci_types.APPLY_CHUNK_REJECT_SNAPSHOT:
                raise ErrRejectSnapshot("app rejected snapshot on chunk apply")
            for peer in res.reject_senders:
                self._banned_peers.add(peer)
            if res.result == abci_types.APPLY_CHUNK_RETRY_SNAPSHOT:
                refetch = set(range(snapshot.chunks))
            elif res.refetch_chunks or res.result == abci_types.APPLY_CHUNK_RETRY:
                refetch = set(res.refetch_chunks) or {next_apply}
            else:
                refetch = None
            if refetch is not None:
                # Roll back the apply cursor to the earliest refetched chunk:
                # already-applied chunks the app dropped must be re-applied
                # (chunks.go Retry/RetryAll semantics).
                with self._lock:
                    for i in refetch:
                        self._chunks.pop(i, None)
                        requested_at.pop(i, None)
                next_apply = min(next_apply, min(refetch))
                continue
            if res.result != abci_types.APPLY_CHUNK_ACCEPT:
                raise ErrRejectSnapshot(f"chunk apply result {res.result}")
            next_apply += 1

    def _verify_app(self, snapshot: SnapshotsResponse, state) -> None:
        """syncer.go:485 verifyApp: the restored app must sit exactly at the
        snapshot height with the trusted app hash."""
        info = self.query_conn.info(abci_types.RequestInfo())
        if info.last_block_height != snapshot.height:
            raise ErrVerifyFailed(
                f"app height {info.last_block_height} != snapshot height "
                f"{snapshot.height}"
            )
        if info.last_block_app_hash != state.app_hash:
            raise ErrVerifyFailed(
                f"app hash {info.last_block_app_hash.hex()} != trusted "
                f"{state.app_hash.hex()}"
            )

    def _log(self, msg: str) -> None:
        if self.logger:
            self.logger.info(msg)
