"""Block store: block/part/commit persistence keyed by height and hash
(store/store.go), the port's copy of ``cometbft_tpu/store/__init__.py``;
keys and values are byte-identical, so a store the JAX package wrote loads
here.

Layout (store/store.go keys): H:<height> -> BlockMeta, P:<height>:<part> ->
Part, C:<height> -> last commit, SC:<height> -> seen commit, BH:<hash> ->
height, plus a BlockStoreState {base, height} record.
"""

from __future__ import annotations

import json
import threading

from cometbft_tpu_torch.libs.db import DB
from cometbft_tpu_torch.types.block import Block, BlockMeta, Commit
from cometbft_tpu_torch.types.part_set import Part, PartSet
from cometbft_tpu_torch.wire import proto as wire

_STATE_KEY = b"blockStore"


def _meta_key(height: int) -> bytes:
    return b"H:%d" % height


def _part_key(height: int, part: int) -> bytes:
    return b"P:%d:%d" % (height, part)


def _commit_key(height: int) -> bytes:
    return b"C:%d" % height


def _seen_commit_key(height: int) -> bytes:
    return b"SC:%d" % height


def _hash_key(h: bytes) -> bytes:
    return b"BH:" + h


class BlockStore:
    """store/store.go:36-600."""

    def __init__(self, db: DB):
        self._db = db
        self._mtx = threading.RLock()
        raw = db.get(_STATE_KEY)
        if raw:
            st = json.loads(raw)
            self._base = st["base"]
            self._height = st["height"]
        else:
            self._base = 0
            self._height = 0

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return 0 if self._height == 0 else self._height - self._base + 1

    def _save_state(self) -> None:
        self._db.set(
            _STATE_KEY, json.dumps({"base": self._base, "height": self._height}).encode()
        )

    # -- loads ---------------------------------------------------------------

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self._db.get(_meta_key(height))
        return BlockMeta.decode(raw) if raw else None

    def load_block(self, height: int) -> Block | None:
        """store/store.go:96: reassemble from parts."""
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            parts.append(part.bytes)
        return Block.decode(b"".join(parts))

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        raw = self._db.get(_hash_key(block_hash))
        if raw is None:
            return None
        return self.load_block(int(raw))

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self._db.get(_part_key(height, index))
        return Part.decode(raw) if raw else None

    def load_block_commit(self, height: int) -> Commit | None:
        """The commit for block at `height` stored with block height+1
        (store/store.go LoadBlockCommit)."""
        raw = self._db.get(_commit_key(height))
        return Commit.decode(raw) if raw else None

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self._db.get(_seen_commit_key(height))
        return Commit.decode(raw) if raw else None

    # -- saves ---------------------------------------------------------------

    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit) -> None:
        """store/store.go:368-430."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        height = block.header.height
        with self._mtx:
            expected = self._height + 1
            if self._height != 0 and height != expected:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks. Wanted {expected}, got {height}"
                )
            if not part_set.is_complete():
                raise ValueError(
                    "BlockStore can only save complete block part sets"
                )
            from cometbft_tpu_torch.types.block import BlockID

            block_id = BlockID(block.hash(), part_set.header())
            meta = BlockMeta(
                block_id=block_id,
                block_size=part_set.byte_size,
                header=block.header,
                num_txs=len(block.data.txs),
            )
            batch = self._db.new_batch()
            batch.set(_meta_key(height), meta.encode())
            batch.set(_hash_key(block.hash()), b"%d" % height)
            for i in range(part_set.total):
                batch.set(_part_key(height, i), part_set.get_part(i).encode())
            if block.last_commit is not None:
                batch.set(_commit_key(height - 1), block.last_commit.encode())
            batch.set(_seen_commit_key(height), seen_commit.encode())
            batch.write()
            self._height = height
            if self._base == 0:
                self._base = height
            self._save_state()

    def save_seen_commit(self, height: int, seen_commit: Commit) -> None:
        """store/store.go SaveSeenCommit: statesync bootstrap saves the
        light-client-verified commit for the restored height so consensus
        (and RPC /commit) can build on it without the block itself."""
        with self._mtx:
            self._db.set(_seen_commit_key(height), seen_commit.encode())

    def prune_blocks(self, retain_height: int) -> int:
        """store/store.go:268-330: delete blocks below retain_height, keep
        state-relevant commits. Returns number pruned."""
        if retain_height <= 0:
            raise ValueError("height must be greater than 0")
        with self._mtx:
            if self._height == 0:
                raise ValueError("no blocks to prune")
            if retain_height > self._height:
                raise ValueError(
                    f"cannot prune beyond the latest height {self._height}"
                )
            pruned = 0
            batch = self._db.new_batch()
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                batch.delete(_meta_key(h))
                batch.delete(_hash_key(meta.block_id.hash))
                batch.delete(_commit_key(h))
                batch.delete(_seen_commit_key(h))
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_part_key(h, i))
                pruned += 1
            batch.write()
            self._base = retain_height
            self._save_state()
            return pruned
