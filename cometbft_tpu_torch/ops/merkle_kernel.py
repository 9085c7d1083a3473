"""Level-synchronous RFC-6962 Merkle roots, and the ``sha256`` kernel's
wrappers.

Counterpart of ``cometbft_tpu/ops/merkle_kernel.py``. Pairing adjacent
nodes level by level with odd promotion gives the same tree as the
reference's recursive split (crypto/merkle/tree.go), and each level is one
batched hash over all sibling pairs:

  leaf  = SHA-256(0x00 || leaf bytes)
  inner = SHA-256(0x01 || left(32) || right(32))   [65 bytes -> 2 blocks]

Digests are int32[8, N] tensors holding big-endian uint32 words. The
wrappers of the ``sha256`` kernel (``csrc/sha256.cu``) take their plain
versions for CPU tensors and launch the kernel for CUDA tensors:

  ``tree_root``   raw leaves (one flat byte buffer + offsets) to the root in
                  two launches; what ``merkle_root`` runs (plain version
                  ``tree_root_plain``);
  ``tree_levels_raw``  the same two launches storing every level as
                  int32[total, 8] (the levels entry, counterpart of the
                  reference's ``_leaves_to_levels_core``); what the proofs
                  run (plain version ``tree_levels_raw_plain``);
  ``digest_tree_root``  leaf digests int32[8, n] to the root in the same
                  two launches (the digests entry, counterpart of the
                  reference's ``merkle_root_pow2`` program and of the
                  subtree and top reductions of ``ops/sharded.py``; plain
                  version ``digest_tree_root_plain``);
  ``leaf_core``   pre-padded leaf blocks to leaf digests, and
  ``inner_core``  one level's sibling pairs to the next level, a launch a
                  level (``tree_levels``; the reference's ``_leaf_core``
                  and ``_inner_core`` over ``sha256_kernel.compress``).

The proofs (``proofs_from_byte_slices_device``) copy the levels to the
host once and gather each leaf's aunts there. ``merkle_root_fused`` routes
a power-of-two forest at or above ``CMTPU_MESH_MERKLE_FLOOR`` leaves over
this process's devices when there are a power of two of them
(``sharded.sharded_leaves_to_root_fn``), else takes the tree entry.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from cometbft_tpu_torch.crypto import merkle as host
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import sha256_kernel as sha

# Leaves a block of the tree entry's first launch hashes and reduces.
CHUNK = 256
# Long leaves (LONG_LEAF_BYTES or more on average, as a block's 64 KiB
# parts) take the levels entry's word loads and chunks of LONG_LEAF_CHUNK:
# one warp a block, so the leaves' compression chains spread over the SMs,
# a warp on each, where chunks of CHUNK would put eight warps of them on
# one SM. The switch lies where the long-leaf launch starts to win: a 21
# MiB block cut into 2 KiB leaves took 0.284 ms under it against 0.345
# under the short-leaf launch, cut into 1 KiB leaves 0.457 against 0.209
# (queued, an H100 80GB HBM3 at 700 W, chip_smoke.py levels_by_leaf_bytes).
LONG_LEAF_BYTES = 2048
LONG_LEAF_CHUNK = 32


def inner_core_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched inner-node hash: int32[8, N] digests -> int32[8, N]."""
    lft, rgt = sha.to_u32(left), sha.to_u32(right)
    m32 = 0xFFFFFFFF
    n = left.shape[1]
    # Block 1: 0x01 || left || right[:31] as big-endian words
    w = [None] * 16
    w[0] = (0x01 << 24) | (lft[0] >> 8)
    for i in range(1, 8):
        w[i] = ((lft[i - 1] << 24) & m32) | (lft[i] >> 8)
    w[8] = ((lft[7] << 24) & m32) | (rgt[0] >> 8)
    for i in range(9, 16):
        w[i] = ((rgt[i - 9] << 24) & m32) | (rgt[i - 8] >> 8)
    st = sha.compress(sha.iv_state(n, left.device), torch.stack(w))
    # Block 2: last byte of right || 0x80 pad || bit length (65 * 8 = 520)
    zero = torch.zeros_like(lft[0])
    w2 = [zero] * 16
    w2[0] = ((rgt[7] << 24) & m32) | (0x80 << 16)
    w2[15] = zero + 520
    return sha.to_i32(sha.compress(st, torch.stack(w2)))


def leaf_core_plain(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Hash N pre-padded messages: int32[B, 16, N] big-endian word blocks,
    int32[N] block counts -> int32[8, N]; lanes stop after their count."""
    n = blocks.shape[2]
    st = sha.iv_state(n, blocks.device)
    for i in range(blocks.shape[0]):
        new = sha.compress(st, sha.to_u32(blocks[i]))
        st = torch.where((i < nblocks)[None, :], new, st)
    return sha.to_i32(st)


def leaf_core(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Leaf hashes (the ``sha256`` kernel's leaf entry on CUDA tensors)."""
    if blocks.device.type == "cpu":
        return leaf_core_plain(blocks, nblocks)
    blk = blocks.to(torch.int32).contiguous()
    nb = nblocks.to(torch.int32).contiguous()
    _build.require_cuda("sha256", blk, nb)
    bmax, _, n = blk.shape
    out = torch.empty((8, n), dtype=torch.int32, device=blk.device)
    if n:
        _build.launch("sha256", "cmtpu_sha256_leaf", blk.device,
                      blk.data_ptr(), nb.data_ptr(), out.data_ptr(), bmax, n)
    return out


def inner_core(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Inner-node hashes of 0x01 || left || right (the ``sha256`` kernel's
    inner entry on CUDA tensors). left/right may be strided views, such as
    the even and odd columns of one level."""
    if left.device.type == "cpu":
        return inner_core_plain(left, right)
    for t in (left, right):
        if t.device.type != "cuda" or t.dtype != torch.int32 or t.device != left.device:
            raise ValueError("sha256: expected int32 CUDA digests on one device")
    if left.shape != right.shape or left.shape[0] != 8:
        raise ValueError(f"sha256: bad digest shapes {left.shape} {right.shape}")
    m = left.shape[1]
    out = torch.empty((8, m), dtype=torch.int32, device=left.device)
    if m:
        _build.launch("sha256", "cmtpu_sha256_inner", left.device,
                      left.data_ptr(), left.stride(0), left.stride(1),
                      right.data_ptr(), right.stride(0), right.stride(1), out.data_ptr(), m)
    return out


def _level_up(cur: torch.Tensor, inner) -> torch.Tensor:
    """One tree level: each sibling pair hashed by ``inner``, an odd last
    node promoted."""
    m = cur.shape[1]
    pairs = m // 2
    nxt = inner(cur[:, 0 : 2 * pairs : 2], cur[:, 1 : 2 * pairs : 2])
    if m % 2 == 1:
        nxt = torch.cat([nxt, cur[:, -1:]], dim=1)
    return nxt


def tree_levels(leaf_digests: torch.Tensor) -> list[torch.Tensor]:
    """All tree levels bottom-up from int32[8, n] leaf digests; each level
    is one batched hash over its sibling pairs, an odd node promoted."""
    levels = [leaf_digests]
    while levels[-1].shape[1] > 1:
        levels.append(_level_up(levels[-1], inner_core))
    return levels


def pack_leaves(leaves: list[bytes], device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The tree entry's input: the leaves joined into one uint8 buffer and
    int64 offsets[n + 1] (leaf i is flat[offsets[i]:offsets[i + 1]])."""
    n = len(leaves)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, leaves), np.int64, n), out=offsets[1:])
    flat = np.frombuffer(b"".join(leaves), np.uint8)
    dev = resolve(device)
    return torch.from_numpy(flat.copy()).to(dev), torch.from_numpy(offsets).to(dev)


def _reduce_chunks(nodes: torch.Tensor, chunk: int) -> torch.Tensor:
    """Each aligned run of ``chunk`` nodes (the last one ragged) reduced to
    its subtree root, level by level, all runs at once: int32[8, m] ->
    int32[8, ceil(m / chunk)]. Pairs never cross a run's edge, since a run
    starts at an even index of every level below the top."""
    for _ in range(chunk.bit_length() - 1):
        if nodes.shape[1] == 1:
            break
        nodes = _level_up(nodes, inner_core_plain)
    return nodes


def tree_root_plain(flat: torch.Tensor, offsets: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Plain version of the tree entry: the same (flat, offsets, chunk),
    leaves packed on the host, then the kernel's two passes: every chunk of
    ``chunk`` leaves to its root, then the chunk roots ``chunk`` at a time
    until one is left -> int32[8, 1]."""
    fl, off = flat.cpu().numpy(), offsets.cpu().numpy()
    items = [b"\x00" + fl[off[i] : off[i + 1]].tobytes() for i in range(len(off) - 1)]
    blocks, nblocks = sha.pack_messages(items)
    dev = flat.device
    nodes = leaf_core_plain(
        torch.from_numpy(blocks.view(np.int32)).to(dev), torch.from_numpy(nblocks).to(dev)
    )
    nodes = _reduce_chunks(nodes, chunk)
    while nodes.shape[1] > 1:
        nodes = _reduce_chunks(nodes, chunk)
    return nodes


def _check_tree(offsets: torch.Tensor, chunk: int, what: str) -> int:
    return _check_count(offsets.shape[0] - 1, chunk, what)


def _check_count(n: int, chunk: int, what: str) -> int:
    if n < 1:
        raise ValueError(f"{what}: needs at least one leaf")
    if chunk < 2 or chunk > 1024 or chunk & (chunk - 1):
        raise ValueError(f"{what}: chunk must be a power of two in [2, 1024], got {chunk}")
    return n


def _launch_tree(flat, offsets, n: int, chunk: int, levels: torch.Tensor | None,
                 words: bool = False) -> torch.Tensor:
    """The tree entry's two launches; ``levels`` None for the root alone,
    ``words`` for the levels entry's word loads. Returns the chunk-root
    scratch, the root in row 0."""
    _build.require_cuda("sha256", flat, dtype=torch.uint8)
    _build.require_cuda("sha256", offsets, dtype=torch.int64)
    if flat.device != offsets.device:
        raise ValueError("sha256: flat and offsets on different devices")
    nc = -(-n // chunk)
    roots = torch.empty((nc, 8), dtype=torch.int32, device=flat.device)
    lv = 0 if levels is None else levels.data_ptr()
    _build.launch("sha256", "cmtpu_sha256_tree_chunks", flat.device,
                  flat.data_ptr(), offsets.data_ptr(), n, chunk, roots.data_ptr(), lv, int(words))
    _build.launch("sha256", "cmtpu_sha256_tree_roots", flat.device,
                  roots.data_ptr(), nc, chunk, lv, n)
    return roots


def tree_root(flat: torch.Tensor, offsets: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """RFC-6962 root of n >= 1 raw leaves (``pack_leaves``): int32[8, 1].
    CPU tensors take ``tree_root_plain``; CUDA tensors launch the ``sha256``
    kernel's tree entry twice (chunks of ``chunk`` leaves, then the chunk
    roots)."""
    n = _check_tree(offsets, chunk, "tree_root")
    if flat.device.type == "cpu":
        return tree_root_plain(flat, offsets, chunk)
    return _launch_tree(flat, offsets, n, chunk, None)[0].reshape(8, 1)


# -- every level: the proofs' device program ------------------------------------


def level_rows(n: int) -> list[tuple[int, int]]:
    """(first row, node count) of each level of an n-leaf tree, leaves
    first, in the levels layout: level l has ceil(n / 2^l) nodes and they
    follow the levels below it. The last level is the root's."""
    rows, base, count = [(0, n)], 0, n
    while count > 1:
        base, count = base + count, (count + 1) // 2
        rows.append((base, count))
    return rows


def tree_levels_raw_plain(flat: torch.Tensor, offsets: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Plain version of the levels entry: the same (flat, offsets, chunk) ->
    int32[total, 8], every level of the tree, each node's 8 big-endian words
    on its row. Built as the kernel builds it: the leaf hashes, then passes
    that reduce every aligned run of ``chunk`` nodes by up to log2(chunk)
    levels, the full runs together and the ragged last run on its own (its
    root promoted unchanged once it is done), each level stored at its
    rows."""
    n = _check_tree(offsets, chunk, "tree_levels_raw")
    fl, off = flat.cpu().numpy(), offsets.cpu().numpy()
    items = [b"\x00" + fl[off[i] : off[i + 1]].tobytes() for i in range(n)]
    blocks, nblocks = sha.pack_messages(items)
    dev = flat.device
    nodes = leaf_core_plain(
        torch.from_numpy(blocks.view(np.int32)).to(dev), torch.from_numpy(nblocks).to(dev)
    )
    rows = level_rows(n)
    out = torch.empty((rows[-1][0] + 1, 8), dtype=torch.int32, device=dev)
    out[:n] = nodes.T
    level = 0
    while nodes.shape[1] > 1:
        full = nodes.shape[1] // chunk * chunk
        parts = [nodes[:, :full], nodes[:, full:]]
        for _ in range(chunk.bit_length() - 1):
            if level == len(rows) - 1:
                break
            parts = [_level_up(p, inner_core_plain) if p.shape[1] > 1 else p for p in parts]
            level += 1
            nodes = torch.cat(parts, dim=1)
            base, count = rows[level]
            out[base : base + count] = nodes.T
    return out


def long_leaves(n: int, nbytes: int) -> bool:
    """Whether n leaves of nbytes in all are long (``LONG_LEAF_BYTES`` or
    more on average): the levels entry then reads them in aligned words,
    in chunks of ``LONG_LEAF_CHUNK``."""
    return nbytes >= LONG_LEAF_BYTES * n


def tree_levels_raw(flat: torch.Tensor, offsets: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """Every level of the RFC-6962 tree over n >= 1 raw leaves
    (``pack_leaves``): int32[total, 8] in the ``level_rows`` layout, in
    chunks of ``chunk`` leaves (when None, ``LONG_LEAF_CHUNK`` for long
    leaves, else ``CHUNK``; the levels do not depend on it). CPU tensors
    take ``tree_levels_raw_plain``; CUDA tensors launch the ``sha256``
    kernel's tree entry twice with its levels output, long leaves read in
    aligned words."""
    long = long_leaves(offsets.shape[0] - 1, flat.numel())
    if chunk is None:
        chunk = LONG_LEAF_CHUNK if long else CHUNK
    n = _check_tree(offsets, chunk, "tree_levels_raw")
    if flat.device.type == "cpu":
        return tree_levels_raw_plain(flat, offsets, chunk)
    rows = level_rows(n)
    levels = torch.empty((rows[-1][0] + 1, 8), dtype=torch.int32, device=flat.device)
    _launch_tree(flat, offsets, n, chunk, levels, long)
    return levels


def levels_to_digests(levels: torch.Tensor) -> np.ndarray:
    """int32[total, 8] levels -> uint8[total, 32] digests on the host, in
    one device-to-host copy."""
    words = levels.cpu().numpy().view(np.uint32).astype(">u4")
    return words.view(np.uint8).reshape(-1, 32)


def split_levels(digests: np.ndarray, n: int) -> list[np.ndarray]:
    """uint8[total, 32] -> one uint8[m, 32] view a level, leaves first."""
    return [digests[base : base + count] for base, count in level_rows(n)]


def proof_levels_device(items: list[bytes], device=None) -> list[np.ndarray]:
    """Every tree level as uint8[m, 32] digests, bottom-up: the levels
    entry (two launches on the card) and one device-to-host copy."""
    levels = tree_levels_raw(*pack_leaves(items, device))
    return split_levels(levels_to_digests(levels), len(items))


def merkle_levels_bytes(leaves: list[bytes], device=None) -> list[list[bytes]]:
    """Every level as byte digests, bottom-up (the proof-building form of
    crypto/merkle's ProofsFromByteSlices)."""
    if len(leaves) == 0:
        return [[]]
    return [[bytes(d) for d in lv] for lv in proof_levels_device(leaves, device)]


def gather_aunts(levels: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Each leaf's aunts from the levels: (uint8[n, depth, 32] packed to the
    left, int32[n] counts). The aunt of leaf i on level l is node
    (i >> l) ^ 1, absent (skipped: odd promotion) past the level's end."""
    n, depth = levels[0].shape[0], len(levels) - 1
    aunts = np.zeros((n, depth, 32), np.uint8)
    counts = np.zeros(n, np.int32)
    idx = np.arange(n)
    for lvl in range(depth):
        level = levels[lvl]
        a = (idx >> lvl) ^ 1
        have = a < level.shape[0]
        rows = idx[have]
        aunts[rows, counts[rows]] = level[a[have]]
        counts[rows] += 1
    return aunts, counts


def proofs_aunts_device(items: list[bytes], device=None):
    """Inclusion proofs for every item in vectorized form: (root bytes,
    leaf hashes uint8[n, 32], aunts uint8[n, depth, 32], aunt counts
    int32[n]); the same aunts as the host's ``proofs_from_byte_slices_pure``."""
    if len(items) == 0:
        raise ValueError(
            "proofs_aunts_device: the empty tree has no proofs "
            "(proofs_from_byte_slices_device answers it)"
        )
    levels = proof_levels_device(items, device)
    aunts, counts = gather_aunts(levels)
    return bytes(levels[-1][0]), levels[0], aunts, counts


class DeviceProofs:
    """Lazy sequence of ``Proof`` over the vectorized proof data: building
    every Proof object up front costs more than the hashing, and callers
    usually need a few."""

    def __init__(self, root, leaf_hashes, aunts, counts):
        self.root = root
        self._leaf = leaf_hashes
        self._aunts = aunts
        self._counts = counts

    def __len__(self):
        return self._leaf.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return host.Proof(
            total=len(self),
            index=i,
            leaf_hash=bytes(self._leaf[i]),
            aunts=[bytes(a) for a in self._aunts[i, : self._counts[i]]],
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def proofs_from_byte_slices_device(items: list[bytes], device=None):
    """Counterpart of crypto/merkle's ``proofs_from_byte_slices`` on the
    card: (root bytes, DeviceProofs). The empty tree takes the host answer."""
    if len(items) == 0:
        return host.proofs_from_byte_slices_pure(items)
    root, leaf_hashes, aunts, counts = proofs_aunts_device(items, device)
    return root, DeviceProofs(root, leaf_hashes, aunts, counts)


def _root_bytes(digest: torch.Tensor) -> bytes:
    return sha.digest_words_to_bytes(digest[:, :1].cpu().numpy())[0]


def merkle_root(leaves: list[bytes], device=None) -> bytes:
    """Root of the RFC-6962 tree over ``leaves`` for any count (empty tree =
    SHA-256 of the empty string, on the host): the tree entry, two
    launches on the card."""
    if len(leaves) == 0:
        return hashlib.sha256(b"").digest()
    return _root_bytes(tree_root(*pack_leaves(leaves, device)))


# -- roots from leaf digests, and the mesh route ---------------------------------


def digest_tree_root_plain(digests: torch.Tensor) -> torch.Tensor:
    """Plain version of the digests entry: int32[8, n] leaf digests, n >= 1,
    reduced level by level (an odd node promoted) -> int32[8, 1]."""
    cur = digests
    while cur.shape[1] > 1:
        cur = _level_up(cur, inner_core_plain)
    return cur


def digest_tree_root(digests: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """RFC-6962 root over n >= 1 leaf digests (int32[8, n], big-endian
    words): int32[8, 1]. CPU tensors take ``digest_tree_root_plain``; CUDA
    tensors launch the ``sha256`` kernel's digests entry (chunks of
    ``chunk`` digests) and the tree entry's second launch."""
    if digests.dim() != 2 or digests.shape[0] != 8 or digests.shape[1] < 1:
        raise ValueError(f"digest_tree_root: expected int32[8, n >= 1], got {tuple(digests.shape)}")
    if digests.device.type == "cpu":
        return digest_tree_root_plain(digests)
    n = _check_count(digests.shape[1], chunk, "digest_tree_root")
    dg = digests.contiguous()
    _build.require_cuda("sha256", dg)
    nc = -(-n // chunk)
    roots = torch.empty((nc, 8), dtype=torch.int32, device=dg.device)
    _build.launch("sha256", "cmtpu_sha256_digest_tree", dg.device,
                  dg.data_ptr(), n, chunk, roots.data_ptr())
    _build.launch("sha256", "cmtpu_sha256_tree_roots", dg.device,
                  roots.data_ptr(), nc, chunk, 0, n)
    return roots[0].reshape(8, 1)


def merkle_root_pow2(leaf_digests, device=None) -> bytes:
    """Root from uint32[8, n] leaf digests (numpy, or an int32 tensor with
    the same bits), n a power of two: 32 bytes. One digest is its own root;
    otherwise the digests entry on the tensor's device (a numpy input goes
    to ``device``, ``cuda`` unless the caller asks for the CPU)."""
    n = leaf_digests.shape[1]
    if n < 1 or n & (n - 1):
        raise ValueError("merkle_root_pow2 requires a power-of-two leaf count")
    if isinstance(leaf_digests, torch.Tensor):
        dg = leaf_digests
    else:
        dg = torch.from_numpy(np.ascontiguousarray(leaf_digests).view(np.int32))
        if n > 1:
            dg = dg.to(resolve(device))
    return _root_bytes(dg if n == 1 else digest_tree_root(dg))


def _mesh_merkle_floor() -> int:
    """Leaf count from which ``merkle_root_fused`` routes to the mesh
    (``CMTPU_MESH_MERKLE_FLOOR``, default 16,384)."""
    try:
        return max(1, int(os.environ.get("CMTPU_MESH_MERKLE_FLOOR", "16384")))
    except ValueError:
        return 16384


def _sharded_root(device=None):
    """(width, the fused leaves-to-root program over this process's devices
    of ``device``'s type) when the routing width is a power of two above 1,
    else None: the subtree roots' top pairs level by level."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    from cometbft_tpu_torch.ops import sharded

    dev = resolve(device)
    w = ek.mesh_width(dev)
    if w <= 1 or w & (w - 1):
        return None
    return w, sharded.sharded_leaves_to_root_fn(sharded.make_mesh(ek.local_devices(dev.type, w)))


def merkle_root_fused(leaves: list[bytes], device=None) -> bytes:
    """RFC-6962 root. A power-of-two forest of at least
    ``CMTPU_MESH_MERKLE_FLOOR`` leaves on a power-of-two mesh routes to the
    subtree-parallel program (each device leaf-hashes and reduces its own
    subtree; counted as ``merkle_sharded_dispatches``); every other forest
    takes ``merkle_root`` (the tree entry, two launches on the card)."""
    n = len(leaves)
    if n == 0 or n & (n - 1) or n < _mesh_merkle_floor():
        return merkle_root(leaves, device)
    sh = _sharded_root(device)
    if sh is None or n % sh[0]:
        return merkle_root(leaves, device)
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    blocks, nblocks = sha.pack_messages([b"\x00" + it for it in leaves])
    ek._mesh_count("merkle_sharded_dispatches")
    return _root_bytes(sh[1](blocks, nblocks))
