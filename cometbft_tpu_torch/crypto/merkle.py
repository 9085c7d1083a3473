"""RFC-6962 Merkle roots and inclusion proofs: the port's host side and
oracle (hashlib), and the proofs path's selection among the card, the
native host pass and pure Python (``proofs_from_byte_slices``).

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
import os
from collections.abc import Sequence
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


def proofs_from_byte_slices_pure(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root and one inclusion proof an item in pure Python, level-synchronous:
    at each level node i's aunt is its neighbour i ^ 1, and an odd trailing
    node is promoted with no aunt (the same aunts as proof.go's recursion).
    The tests' oracle."""
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


class _LazyProofs(Sequence):
    """The proofs of one tree over the native pass's packed aunts buffer.

    Every level was hashed and every aunt gathered in one C pass; a
    ``Proof`` (its 32-byte aunt slices included) is made only when indexed,
    because a 65,536-leaf block would otherwise allocate ~1M small bytes
    objects up front that consumers (a transaction's proof, part-set
    gossip) touch one leaf at a time."""

    __slots__ = ("_n", "_leaf_hashes", "_packed", "_stride", "_counts")

    def __init__(self, n, leaf_hashes, packed, stride, counts):
        self._n = n
        self._leaf_hashes = leaf_hashes
        self._packed = packed
        self._stride = stride
        self._counts = counts

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        base = i * self._stride
        return Proof(
            total=self._n,
            index=i,
            leaf_hash=self._leaf_hashes[i],
            aunts=[self._packed[base + 32 * k : base + 32 * (k + 1)] for k in range(self._counts[i])],
        )

    def __iter__(self):
        for i in range(self._n):
            yield self[i]


# Where a proof set of 32 or more items goes when CMTPU_DEVICE_PROOFS is unset:
# the native host pass (False) or the card (True). chip_smoke.py's proofs
# paths phase on one NVIDIA H100 80GB HBM3 (700.00 W) and its host, medians
# of 3 in three runs (PERF.md §5): 65,536 leaves native 84.4-91.6 ms, the
# card 116.4-136.1 (its numpy aunt gather); 336 parts of 64 KiB native
# 22.8-23.1, the card 26.8-28.7. The native pass is faster in every run.
DEVICE_PROOFS_DEFAULT = False

# Which path the last proofs_from_byte_slices call took: "device",
# "host-native", "pure-python" or "empty". Observability only.
last_proofs_path = "none"


def _device_proofs() -> bool:
    """``CMTPU_DEVICE_PROOFS``: 1 the card, 0 the native host pass, unset
    ``DEVICE_PROOFS_DEFAULT``."""
    env = os.environ.get("CMTPU_DEVICE_PROOFS", "")
    return DEVICE_PROOFS_DEFAULT if env == "" else env == "1"


def proofs_from_byte_slices(items: list[bytes], device=None) -> tuple[bytes, Sequence[Proof]]:
    """Root and one inclusion proof an item (crypto/merkle/proof.go:35-49),
    by one of three paths (``last_proofs_path`` says which):

    - 32 items or more, on the card (``merkle_kernel.
      proofs_from_byte_slices_device`` on ``device``, ``cuda`` unless the
      caller asks for the CPU) or by the native host pass
      (``native.merkle_proof_parts``, served as ``_LazyProofs``), as
      ``_device_proofs()`` says. A failure of either raises: neither falls
      back to another path;
    - fewer, or while the native library is still building (its first use
      starts the build), pure Python.

    Every path gives the same root and aunts."""
    global last_proofs_path

    n = len(items)
    if n == 0:
        last_proofs_path = "empty"
        return empty_hash(), []
    if n >= 32 and _device_proofs():
        from cometbft_tpu_torch.ops import merkle_kernel as mk

        root, proofs = mk.proofs_from_byte_slices_device(items, device)
        last_proofs_path = "device"
        return root, proofs
    if n >= 32:
        from cometbft_tpu_torch import native

        if native.ready() is not None:
            root, leaf_hashes, packed, stride, counts = native.merkle_proof_parts(items)
            last_proofs_path = "host-native"
            return root, _LazyProofs(n, leaf_hashes, packed, stride, counts)
        native.ensure_built_async()
    last_proofs_path = "pure-python"
    return proofs_from_byte_slices_pure(items)
