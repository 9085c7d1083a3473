"""The light client's trusted store (light/store/db/db.go), the port's copy
of ``cometbft_tpu/light/store.py``.

Verified LightBlocks in a DB keyed by height (``lb/`` + the big-endian
int64 height; the value is ``LightBlock.encode()``), with first and last
height queries and pruning. The keys and values are byte-identical to the
JAX package's, so a store that package wrote loads here.
"""

from __future__ import annotations

import os
import struct

from cometbft_tpu_torch.libs.db import DB
from cometbft_tpu_torch.types.light_block import LightBlock

_PREFIX = b"lb/"
_SIZE_KEY = b"lb_size"
DEFAULT_CACHE_BLOCKS = 16


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">q", height)


class LightStore:
    """light/store/store.go Store interface + db implementation."""

    # Decoded blocks the store hands back again and again (latest_trusted on
    # every verify, the bisection's re-reads): decoding a large set's block
    # is Python proto work, so a small write-through cache of objects sits
    # in front of the DB, which stays the source of truth. An LRU with
    # refresh-on-reput, capped by CMTPU_LIGHT_STORE_CACHE or the
    # cache_blocks argument (default 16; a gateway's store serving many
    # clients wants more).

    def __init__(self, db: DB, cache_blocks: int | None = None):
        if cache_blocks is None:
            try:
                cache_blocks = int(
                    os.environ.get(
                        "CMTPU_LIGHT_STORE_CACHE", str(DEFAULT_CACHE_BLOCKS)
                    )
                )
            except ValueError:
                cache_blocks = DEFAULT_CACHE_BLOCKS
        self._cache_blocks = max(1, cache_blocks)
        self._db = db
        self._cache: dict[int, LightBlock] = {}

    def _cache_put(self, lb: LightBlock) -> None:
        # Delete + reinsert moves the height to the young end; evict from
        # the old end past the cap (insertion-ordered dict as LRU).
        self._cache.pop(lb.height, None)
        while len(self._cache) >= self._cache_blocks:
            self._cache.pop(next(iter(self._cache)))
        self._cache[lb.height] = lb

    def save_light_block(self, lb: LightBlock) -> None:
        if lb.height <= 0:
            raise ValueError("1 <= height required")
        self._db.set(_key(lb.height), lb.encode())
        self._cache_put(lb)

    def delete_light_block(self, height: int) -> None:
        self._db.delete(_key(height))
        self._cache.pop(height, None)

    def light_block(self, height: int) -> LightBlock | None:
        lb = self._cache.get(height)
        if lb is not None:
            return lb
        raw = self._db.get(_key(height))
        if raw is None:
            return None
        lb = LightBlock.decode(raw)
        self._cache_put(lb)
        return lb

    def _heights(self) -> list[int]:
        out = []
        for k, _ in self._db.iterator(_PREFIX, _PREFIX + b"\xff"):
            out.append(struct.unpack(">q", k[len(_PREFIX):])[0])
        return sorted(out)

    def last_light_block_height(self) -> int:
        hs = self._heights()
        return hs[-1] if hs else -1

    def first_light_block_height(self) -> int:
        hs = self._heights()
        return hs[0] if hs else -1

    def light_block_before(self, height: int) -> LightBlock | None:
        """Largest stored height strictly below `height` (db.go:141)."""
        best = None
        for h in self._heights():
            if h < height:
                best = h
            else:
                break
        return self.light_block(best) if best is not None else None

    def size(self) -> int:
        return len(self._heights())

    def prune(self, size: int) -> None:
        """Remove oldest blocks down to `size` entries (db.go Prune)."""
        hs = self._heights()
        excess = len(hs) - size
        for h in hs[:max(excess, 0)]:
            self.delete_light_block(h)
