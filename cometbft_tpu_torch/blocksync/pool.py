"""Block pool: tracks in-flight block requests across peers
(blocksync/pool.go), the port's copy of ``cometbft_tpu/blocksync/pool.py``.

Requesters cover a moving window of heights (~600 in flight, pool.go:63);
peers advertise their heights via status messages; timed-out or bad peers
get their requests redistributed.
"""

from __future__ import annotations

import threading
import time

MAX_PENDING_REQUESTS = 600
REQUEST_TIMEOUT = 15.0
POOL_WINDOW = 200


class _Requester:
    def __init__(self, height: int):
        self.height = height
        self.peer_id: str | None = None
        self.block = None
        self.requested_at = 0.0


class BlockPool:
    """blocksync/pool.go BlockPool."""

    def __init__(self, start_height: int, send_request, clock=None):
        from cometbft_tpu_torch.sidecar.supervisor import MonotonicClock

        self.height = start_height  # next height to sync
        self._send_request = send_request  # fn(peer_id, height)
        self.clock = clock or MonotonicClock()
        self._mtx = threading.RLock()
        self._requesters: dict[int, _Requester] = {}
        self._peers: dict[str, int] = {}  # peer_id -> reported height
        self.max_peer_height = 0
        self._last_advance = self.clock.now()

    # -- peers ----------------------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        with self._mtx:
            self._peers[peer_id] = height
            self.max_peer_height = max(self.max_peer_height, height)

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self._peers.pop(peer_id, None)
            for req in self._requesters.values():
                if req.peer_id == peer_id and req.block is None:
                    req.peer_id = None

    # -- scheduling -----------------------------------------------------------

    def make_requests(self) -> None:
        """Spawn requesters for the window and (re)assign idle ones."""
        with self._mtx:
            for h in range(self.height, min(self.height + POOL_WINDOW, self.max_peer_height + 1)):
                if h not in self._requesters:
                    if len(self._requesters) >= MAX_PENDING_REQUESTS:
                        break
                    self._requesters[h] = _Requester(h)
            now = self.clock.now()
            for req in self._requesters.values():
                if req.block is not None:
                    continue
                if req.peer_id is not None and now - req.requested_at < REQUEST_TIMEOUT:
                    continue
                peer = self._pick_peer(req.height)
                if peer is None:
                    continue
                req.peer_id = peer
                req.requested_at = now
                self._send_request(peer, req.height)

    def _pick_peer(self, height: int) -> str | None:
        for peer_id, peer_height in self._peers.items():
            if peer_height >= height:
                return peer_id
        return None

    # -- block flow -----------------------------------------------------------

    def add_block(self, peer_id: str, block) -> bool:
        """pool.go:246 AddBlock."""
        with self._mtx:
            req = self._requesters.get(block.header.height)
            if req is None or req.block is not None:
                return False
            req.block = block
            req.peer_id = peer_id
            return True

    def peek_two_blocks(self):
        """pool.go:193 PeekTwoBlocks: (first, second) at height, height+1."""
        with self._mtx:
            first = self._requesters.get(self.height)
            second = self._requesters.get(self.height + 1)
            return (
                first.block if first else None,
                second.block if second else None,
            )

    def peek_window(self, max_k: int) -> list:
        """Consecutive fetched blocks starting at the sync height (up to
        max_k) — the prefetch window the reactor batch-verifies in one
        device dispatch."""
        with self._mtx:
            out = []
            h = self.height
            while len(out) < max_k:
                req = self._requesters.get(h)
                if req is None or req.block is None:
                    break
                out.append(req.block)
                h += 1
            return out

    def pop_request(self) -> None:
        """Advance after the first block validated + applied."""
        with self._mtx:
            self._requesters.pop(self.height, None)
            self.height += 1
            self._last_advance = self.clock.now()

    def redo_request(self, height: int) -> str | None:
        """Invalid block: drop both pending blocks, re-request (reactor.go:375)."""
        with self._mtx:
            bad_peer = None
            for h in (height, height + 1):
                req = self._requesters.get(h)
                if req is not None:
                    if bad_peer is None:
                        bad_peer = req.peer_id
                    req.block = None
                    req.peer_id = None
            return bad_peer

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp."""
        with self._mtx:
            if not self._peers:
                return False
            return self.height >= self.max_peer_height

    def stalled_for(self) -> float:
        with self._mtx:
            return self.clock.now() - self._last_advance
