"""Merkle Mountain Range over committed headers (the light gateway's and
the bundle origin's accumulator), the port's copy of
``cometbft_tpu/light/mmr.py``.

An append-only accumulator in the style of "The Merkle Mountain Belt"
(arXiv:2511.13582): header hashes are appended one at a time and every
perfect-subtree node is kept, so an inclusion proof for any past leaf under
the latest peaks costs O(log^2 n) hashes without rehashing history.

It is the RFC-6962 tree exactly: leaves and inner nodes use
``crypto/merkle``'s domain-separated ``leaf_hash`` / ``inner_hash``, peaks
are bagged right to left, and since bagging the binary decomposition's
peaks right to left is the ``get_split_point`` recursion, ``MMR.root()``
equals ``hash_from_byte_slices(leaves)`` and ``MMR.prove(i)`` is a
``crypto.merkle.Proof`` whose aunts are those of
``proofs_from_byte_slices(leaves)[1][i]``. A cold light client checks a
gateway's proof with the Proof it already has.

The state file (``save_state``) is byte-identical to the JAX package's, so
a file either package wrote resumes in the other.
"""
from __future__ import annotations

import os
import struct

from cometbft_tpu_torch.crypto.merkle import (
    Proof,
    empty_hash,
    get_split_point,
    inner_hash,
    leaf_hash,
)

_STATE_MAGIC = b"CMTPU-MMR-v1\n"


class MMRStateError(Exception):
    """Persisted MMR state is unreadable or inconsistent with its own
    peaks or with the chain it claims to accumulate.  Callers must treat
    this as fatal for the state file — refuse loudly, never guess."""


class MMR:
    """Append-only RFC-6962 Merkle tree with O(1) amortized append.

    `_levels[k][j]` is the root of the perfect subtree over leaves
    [j * 2^k, (j+1) * 2^k) — only complete pairs are merged, so level k
    holds floor(n / 2^k) nodes and the peaks of the range are the
    right-most node of each level where the binary digit of n is set.
    """

    def __init__(self) -> None:
        self._levels: list[list[bytes]] = [[]]

    def __len__(self) -> int:
        return len(self._levels[0])

    @property
    def size(self) -> int:
        return len(self._levels[0])

    def append(self, data: bytes) -> int:
        """Append one leaf (raw bytes, e.g. a 32-byte header hash); returns
        its 0-based leaf index."""
        idx = len(self._levels[0])
        self._levels[0].append(leaf_hash(data))
        k = 0
        # Merge complete pairs upward: after appending leaf idx, level k
        # gains a node whenever 2^(k+1) divides into the filled prefix.
        while len(self._levels[k]) % 2 == 0 and len(self._levels[k]) > 0:
            if len(self._levels) == k + 1:
                self._levels.append([])
            lvl = self._levels[k]
            self._levels[k + 1].append(inner_hash(lvl[-2], lvl[-1]))
            k += 1
        return idx

    def peaks(self) -> list[tuple[int, bytes]]:
        """[(subtree_size, peak_hash)] left-to-right — the binary
        decomposition of `size`, largest peak first."""
        return self.peaks_at(self.size)

    def peaks_at(self, size: int) -> list[tuple[int, bytes]]:
        """Peaks of the PREFIX of the first `size` leaves.  Every node over
        leaves [0, size) was created when those leaves were appended and is
        never mutated afterward, so any historical peak set is still
        addressable — this is what lets one live accumulator serve
        checkpoint artifacts frozen at past sizes."""
        if not 0 <= size <= self.size:
            raise IndexError(f"prefix size {size} not in MMR of size {self.size}")
        out: list[tuple[int, bytes]] = []
        consumed = 0
        for k in range(size.bit_length() - 1, -1, -1):
            if size & (1 << k):
                out.append((1 << k, self._levels[k][consumed >> k]))
                consumed += 1 << k
        return out

    def root(self) -> bytes:
        """Peaks bagged right-to-left == RFC-6962 root of the leaf list."""
        return bag_peaks([p for _, p in self.peaks()])

    def root_at(self, size: int) -> bytes:
        """RFC-6962 root of the first `size` leaves (historical root)."""
        return bag_peaks([p for _, p in self.peaks_at(size)])

    def _range_root(self, start: int, count: int) -> bytes:
        """Root of leaves [start, start+count).  A stored node when the
        range is an aligned perfect subtree; otherwise the split-point
        recursion over stored nodes (only the right spine is imperfect,
        so this is O(log n) hashes)."""
        if count & (count - 1) == 0 and start % count == 0:
            k = count.bit_length() - 1
            return self._levels[k][start >> k]
        k = get_split_point(count)
        return inner_hash(
            self._range_root(start, k), self._range_root(start + k, count - k)
        )

    def prove(self, index: int) -> Proof:
        """Inclusion proof for leaf `index` under the current root —
        bit-identical to proofs_from_byte_slices' audit path."""
        return self.prove_at(index, self.size)

    def prove_at(self, index: int, size: int) -> Proof:
        """Inclusion proof for leaf `index` under the HISTORICAL root of
        the first `size` leaves — identical to what prove() returned when
        the accumulator was that size (append-only: old nodes persist)."""
        n = size
        if not 0 < n <= self.size:
            raise IndexError(f"prefix size {n} not in MMR of size {self.size}")
        if not 0 <= index < n:
            raise IndexError(f"leaf {index} not in MMR prefix of size {n}")
        spans: list[tuple[int, int]] = []
        start, count, i = 0, n, index
        while count > 1:
            k = get_split_point(count)
            if i < k:
                spans.append((start + k, count - k))
                count = k
            else:
                spans.append((start, k))
                start += k
                i -= k
                count -= k
        # Aunts are ordered leaf-sibling first (proof.go contract); the
        # walk above collected them root-side first.
        resolved = [self._range_root(s, c) for s, c in reversed(spans)]
        return Proof(
            total=n, index=index, leaf_hash=self._levels[0][index], aunts=resolved
        )


def bag_peaks(peaks: list[bytes]) -> bytes:
    """Bag a left-to-right peak list right-to-left into the RFC-6962 root
    of the underlying leaf list.  Pure function so wire-decoded peak sets
    (checkpoint bundles) recompute their claimed root client-side."""
    if not peaks:
        return empty_hash()
    h = peaks[-1]
    for p in reversed(peaks[:-1]):
        h = inner_hash(p, h)
    return h


# -- persistence (shared by the light gateway and the bundle origin) --------
#
# State file layout: magic, a fixed header (the size as u64, the peak count
# as u8), the peak hashes of the full prefix (the integrity anchor), then
# every level-0 leaf hash.  Upper levels are NOT stored: they
# are pure hashing over level 0 (no block-store refetch), so load() rebuilds
# them and then REFUSES loudly if the rebuilt peaks disagree with the stored
# ones — a truncated/garbled file or one from a different chain can only
# fail closed.


def save_state(mmr: MMR, path: str) -> None:
    """Atomically persist (size, peaks, leaf hashes) to `path`."""
    n = mmr.size
    peaks = [p for _, p in mmr.peaks()]
    blob = (
        _STATE_MAGIC
        + struct.pack(">QB", n, len(peaks))
        + b"".join(peaks)
        + b"".join(mmr._levels[0])
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_state(path: str) -> MMR:
    """Rebuild an MMR from a state file written by save_state — raises
    MMRStateError on any structural or peak mismatch (refuse loudly; the
    caller decides whether a fresh rebuild from the block store is safe)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise MMRStateError(f"mmr state unreadable: {e}") from e
    if not blob.startswith(_STATE_MAGIC):
        raise MMRStateError("mmr state: bad magic")
    off = len(_STATE_MAGIC)
    if len(blob) < off + 9:
        raise MMRStateError("mmr state: truncated header")
    n, n_peaks = struct.unpack_from(">QB", blob, off)
    off += 9
    expect = off + 32 * n_peaks + 32 * n
    if len(blob) != expect or n_peaks != bin(n).count("1"):
        raise MMRStateError(
            f"mmr state: truncated/garbled (size {n}, {n_peaks} peaks, "
            f"{len(blob)} bytes, want {expect})"
        )
    peaks = [blob[off + 32 * i: off + 32 * (i + 1)] for i in range(n_peaks)]
    off += 32 * n_peaks
    mmr = MMR()
    mmr._levels = [[blob[off + 32 * i: off + 32 * (i + 1)] for i in range(n)]]
    # Rebuild upper levels from the stored leaf hashes (pure hashing).
    k = 0
    while len(mmr._levels[k]) > 1:
        lvl = mmr._levels[k]
        mmr._levels.append(
            [inner_hash(lvl[2 * j], lvl[2 * j + 1]) for j in range(len(lvl) // 2)]
        )
        k += 1
    got = [p for _, p in mmr.peaks()]
    if got != peaks:
        raise MMRStateError("mmr state: stored peaks do not match leaf hashes")
    return mmr


def resume_or_new(path: str | None, last_leaf_hash) -> MMR:
    """Load persisted state when `path` exists, cross-checking the LAST
    persisted leaf against the live chain via `last_leaf_hash(height) ->
    32-byte header hash | None` — a state file that disagrees with the
    block store it claims to accumulate raises MMRStateError instead of
    serving proofs for someone else's history.  No file -> fresh MMR."""
    if not path or not os.path.exists(path):
        return MMR()
    mmr = load_state(path)
    if mmr.size:
        h = last_leaf_hash(mmr.size)
        if h is None:
            raise MMRStateError(
                f"mmr state has {mmr.size} leaves but the source has no "
                f"header at height {mmr.size}"
            )
        if leaf_hash(h) != mmr._levels[0][mmr.size - 1]:
            raise MMRStateError(
                f"mmr state leaf {mmr.size - 1} does not match the source "
                f"header hash at height {mmr.size}"
            )
    return mmr


def catch_up(mmr: MMR, lock, tip: int, header_hash, chunk: int = 256) -> bool:
    """Append committed header hashes (heights mmr.size+1 .. tip) through
    `header_hash(height) -> bytes`.  Fetches run in bounded chunks OUTSIDE
    the lock — a tall-chain catch-up must not stall concurrent proof
    sessions — and each append re-checks the size under the lock, so
    concurrent catch-ups (hashes are deterministic per height) never
    double-append.  Returns True when leaves were added.  Shared by the
    light gateway and the bundle origin."""
    grew = False
    while True:
        with lock:
            next_h = mmr.size + 1
        if next_h > tip:
            return grew
        hi = min(tip, next_h + chunk - 1)
        hashes = [(h, header_hash(h)) for h in range(next_h, hi + 1)]
        with lock:
            for h, digest in hashes:
                if h == mmr.size + 1:
                    mmr.append(digest)
                    grew = True


def verify_inclusion(root: bytes, total: int, index: int, aunts: list[bytes],
                     data: bytes) -> None:
    """Check that `data` is the leaf at `index` of the `total`-leaf tree
    with `root` — raises ValueError otherwise.  Pure function over the
    existing Proof verifier, for callers holding a wire-decoded proof."""
    Proof(total=total, index=index, leaf_hash=leaf_hash(data),
          aunts=list(aunts)).verify(root, data)
