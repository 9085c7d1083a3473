"""RFC-6962 Merkle roots and inclusion proofs over hashlib: the port's host
side and oracle.

leaf  = SHA256(0x00 || data)
inner = SHA256(0x01 || left || right)
empty = SHA256("")

Pairing adjacent nodes level by level and promoting an odd trailing node
gives the same tree as the recursive split at the largest power of two
below the count (crypto/merkle/tree.go in CometBFT). A proof holds the
leaf hash and its aunts from the leaf's sibling up to the root's child
(crypto/merkle/proof.go); ``MAX_AUNTS`` bounds its size.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

HASH_SIZE = 32
MAX_AUNTS = 100


def empty_hash() -> bytes:
    return hashlib.sha256(b"").digest()


def leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + leaf).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def get_split_point(length: int) -> int:
    """Largest power of two strictly below ``length`` (tree.go)."""
    if length < 1:
        raise ValueError("Trying to split a tree with size < 1")
    k = 1 << (length.bit_length() - 1)
    if k == length:
        k >>= 1
    return k


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    """Merkle root of items (RFC 6962)."""
    if not items:
        return empty_hash()
    level = [leaf_hash(it) for it in items]
    while len(level) > 1:
        nxt = [inner_hash(level[i], level[i + 1]) for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


@dataclass
class Proof:
    """An inclusion proof (proof.go): leaf hash included, root excluded."""

    total: int = 0
    index: int = 0
    leaf_hash: bytes = b""
    aunts: list[bytes] = field(default_factory=list)

    def verify(self, root_hash: bytes, leaf: bytes) -> None:
        """Raises ValueError unless this proof links ``leaf`` to ``root_hash``."""
        if self.total < 0:
            raise ValueError("proof total must be positive")
        if self.index < 0:
            raise ValueError("proof index cannot be negative")
        lh = leaf_hash(leaf)
        if self.leaf_hash != lh:
            raise ValueError(f"invalid leaf hash: wanted {lh.hex()} got {self.leaf_hash.hex()}")
        computed = self.compute_root_hash()
        if computed != root_hash:
            raise ValueError(
                f"invalid root hash: wanted {root_hash.hex()} got "
                f"{computed.hex() if computed else None}"
            )

    def compute_root_hash(self) -> bytes | None:
        return compute_hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        if self.index < 0:
            raise ValueError("negative Index")
        if len(self.leaf_hash) != HASH_SIZE:
            raise ValueError(
                f"expected LeafHash size to be {HASH_SIZE}, got {len(self.leaf_hash)}"
            )
        if len(self.aunts) > MAX_AUNTS:
            raise ValueError(f"expected no more than {MAX_AUNTS} aunts, got {len(self.aunts)}")
        for i, aunt in enumerate(self.aunts):
            if len(aunt) != HASH_SIZE:
                raise ValueError(f"expected Aunts#{i} size to be {HASH_SIZE}, got {len(aunt)}")


def compute_hash_from_aunts(
    index: int, total: int, leaf_hash_: bytes, inner_hashes: list[bytes]
) -> bytes | None:
    """Fold the aunts into a root; None if the shape is wrong. Walks the
    split-point recursion iteratively (deep trees need no recursion)."""
    if index >= total or index < 0 or total <= 0:
        return None
    turns: list[bool] = []  # True: the leaf is in the left subtree at this step
    lo_total, lo_index = total, index
    while lo_total > 1:
        if len(turns) >= len(inner_hashes):
            return None
        k = get_split_point(lo_total)
        if lo_index < k:
            turns.append(True)
            lo_total = k
        else:
            turns.append(False)
            lo_index -= k
            lo_total -= k
    if len(turns) != len(inner_hashes):
        return None
    h = leaf_hash_
    for aunt, left in zip(inner_hashes, reversed(turns)):
        h = inner_hash(h, aunt) if left else inner_hash(aunt, h)
    return h


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root and one inclusion proof an item, level-synchronous: at each
    level node i's aunt is its neighbour i ^ 1, and an odd trailing node is
    promoted with no aunt (the same aunts as proof.go's recursion)."""
    n = len(items)
    if n == 0:
        return empty_hash(), []
    level = [leaf_hash(item) for item in items]
    leaf_hashes = list(level)
    aunts: list[list[bytes]] = [[] for _ in range(n)]
    pos = list(range(n))  # each leaf's node index on the current level
    while len(level) > 1:
        size = len(level)
        for leaf_i in range(n):
            sib = pos[leaf_i] ^ 1
            if sib < size:
                aunts[leaf_i].append(level[sib])
            pos[leaf_i] >>= 1
        nxt = [inner_hash(level[i], level[i + 1]) for i in range(0, size - 1, 2)]
        if size % 2:
            nxt.append(level[-1])
        level = nxt
    proofs = [Proof(total=n, index=i, leaf_hash=leaf_hashes[i], aunts=aunts[i]) for i in range(n)]
    return level[0], proofs
