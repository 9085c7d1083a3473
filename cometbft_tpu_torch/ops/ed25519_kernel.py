"""Batched Ed25519 ZIP-215 verification on the card.

Counterpart of ``cometbft_tpu/ops/ed25519_kernel.py``. Every lane checks
its own cofactored equation

    [8]([s]B + [k](-A) + (-R)) == identity

so one call yields the exact per-signature validity bitmap.

Host side (numpy, no crypto): shape checks, the vectorized s < L check,
and the challenge messages R || A || M padded into SHA-512 blocks
(``pack_batch``, held operand-identical to the reference). Device side, in
pipeline order, three launches on CUDA tensors:

  1. SHA-512 of the challenges,
     k = digest mod L, digit recodes
     of s and k                     ``sha512`` kernel      (sha512_kernel)
  2. y and sign of A and R from
     their words, ZIP-215 decoding,
     lane-stacked into one 2N pass  ``decompress`` kernel  (edwards)
  3. -A, [s]B + [k](-A), add -R,
     3 doublings, identity test     ``ladder`` kernel      (ladder)

CPU tensors take each stage's plain version; ``unpack_stage`` (the
reference's unpack program in plain PyTorch) is the tests' oracle for the
work stages 1 and 2 took over from it.

The batch axis is bucketed as in the reference (``BUCKETS``,
``BLOCK_BUCKETS``) so bitmaps and packed operands compare lane for lane.
Oversized messages take the host-hash program (``verify_core_hosthash``):
the host hashes with hashlib and stage 1 starts from the digests
(``sha512_kernel.scalar_digits``).

On a host with several cards a dispatch spreads over all of them, as the
reference's routing does: ``mesh_width`` is this process's CUDA device
count, buckets at or above ``mesh_floor`` (``CMTPU_MESH_FLOOR``, default
the width) are rounded to a multiple of it, and such a bucket runs
``sharded.sharded_verify_fn`` (each card its contiguous lanes, the same
three launches, no collective). The host-hash program never shards. The
CPU's width is 1.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from concurrent.futures import Future
from functools import lru_cache

import numpy as np
import torch

from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import edwards as ed
from cometbft_tpu_torch.ops import ladder
from cometbft_tpu_torch.ops import sha512_kernel as s5
from cometbft_tpu_torch.ops import unpack

L = 2**252 + 27742317777372353535851937790883648493

BUCKETS = (8, 32, 128, 512, 1024, 2048, 4096, 6144, 8192, 10240, 16384, 32768)
BLOCK_BUCKETS = (2, 4, 8, 32)
# What ``warmup`` runs by default: commit-sized verify buckets and block-sized
# leaf counts.
WARM_BUCKETS = (128, 1024, 6144, 10240)
WARM_LEAVES = (1024, 65536)


_probed_width = 0  # mesh_width()'s last answer for CUDA; 0 = never probed


def mesh_width(device=None) -> int:
    """Devices one verify dispatch spreads over (the 1-D ``sig`` mesh of
    ``ops/sharded``): this process's CUDA devices for a CUDA request
    (``device`` None means ``cuda``; at least 1), and 1 for the CPU."""
    global _probed_width
    if torch.device("cuda" if device is None else device).type != "cuda":
        return 1
    _probed_width = _cuda_device_count()
    return _probed_width


@lru_cache(maxsize=1)
def _cuda_device_count() -> int:
    return max(1, torch.cuda.device_count())


def known_mesh_width() -> int:
    """The last CUDA ``mesh_width()`` answer, or 0 when nothing probed it:
    for readers that must not touch the device (Ping, metrics)."""
    return _probed_width


def mesh_floor(width: int | None = None) -> int:
    """Smallest batch bucket worth spreading over the mesh:
    ``CMTPU_MESH_FLOOR`` when set, else the mesh width itself (``width``,
    or ``mesh_width()`` when None)."""
    env = os.environ.get("CMTPU_MESH_FLOOR", "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return mesh_width() if width is None else width


def bucket_for(n: int, width: int | None = None) -> int:
    """Batch bucket for n signatures, rounded up to a multiple of the mesh
    width (``width``, or ``mesh_width()`` when None) at or above the floor,
    so a bucket the router shards splits evenly over the devices."""
    for b in BUCKETS:
        if n <= b:
            break
    else:
        b = int(2 ** np.ceil(np.log2(n)))
    w = mesh_width() if width is None else width
    if w > 1 and b >= mesh_floor(w) and b % w:
        b += w - b % w
    return b


def preferred_stream_chunk() -> int:
    """Chunk size the sidecar advertises to streaming clients (field 4 of
    its Ping reply): the smallest commit-sized batch bucket that is a
    multiple of the mesh width, so a streamed chunk needs no padding. Reads
    the width passively (``known_mesh_width``)."""
    w = known_mesh_width() or 1
    b = bucket_for(max(1024, 128 * w), w)
    return b + (w - b % w) % w


def local_devices(dev_type: str, width: int) -> list[torch.device]:
    """The devices of a ``width``-wide mesh in this process: the first
    ``width`` cards for ``cuda``; ``width`` virtual shards of the CPU."""
    if dev_type == "cuda":
        return [torch.device("cuda", i) for i in range(width)]
    return [torch.device(dev_type)] * width


_mesh_lock = threading.Lock()
_mesh_counters = {
    "sharded_dispatches": 0,  # verify dispatches routed to the mesh program
    "padded_lanes": 0,  # bucket-padding lanes shipped on those
    "merkle_sharded_dispatches": 0,  # fused roots through the subtree program
}


def mesh_counters() -> dict:
    """The mesh routing counters and the (passively read) device count."""
    with _mesh_lock:
        out = dict(_mesh_counters)
    out["devices"] = known_mesh_width()
    return out


def _mesh_count(key: str, delta: int = 1) -> None:
    with _mesh_lock:
        _mesh_counters[key] += delta


def block_bucket_for(b: int) -> int:
    for bb in BLOCK_BUCKETS:
        if b <= bb:
            return bb
    return int(2 ** np.ceil(np.log2(b)))


# -- device pipeline ---------------------------------------------------------


def unpack_stage(a_words, r_words, s_words, k_words):
    """The reference's unpack program in plain PyTorch: (y limbs
    int32[17, 2N] of A then R, signs bool[2N], s digits int32[64, N],
    k digits int32[64, N]). The pipeline does this work inside its
    ``sha512`` and ``decompress`` stages; tests hold them to it."""
    y_a, sign_a = unpack.words_to_limbs255(a_words)
    y_r, sign_r = unpack.words_to_limbs255(r_words)
    return (
        torch.cat([y_a, y_r], dim=1),
        torch.cat([sign_a, sign_r]),
        unpack.scalar_words_to_digits(s_words),
        unpack.digest_words_to_digits(k_words),
    )


def _verify_from_words(a_words, r_words, s_digits, k_digits) -> torch.Tensor:
    pt, ok = ed.decompress_words(a_words, r_words)
    return ladder.verify_lanes(s_digits, k_digits, pt, ok)


def verify_core(a_words, r_words, s_words, msg_words, msg_nblocks) -> torch.Tensor:
    """The whole verification on the device: A, R, S as int32[8, N] words,
    the padded challenge buffer as int32[N, B*32] little-endian words and
    int32[N] block counts -> bool[N]."""
    s_digits, k_digits = s5.challenge_digits(msg_words, msg_nblocks, s_words)
    return _verify_from_words(a_words, r_words, s_digits, k_digits)


def verify_core_hosthash(a_words, r_words, s_words, k_words) -> torch.Tensor:
    """Host-hash variant: the 64-byte challenge digests come from the host
    as int32[16, N] little-endian words."""
    s_digits, k_digits = s5.scalar_digits(k_words, s_words)
    return _verify_from_words(a_words, r_words, s_digits, k_digits)


def operands_to_device(operands, device) -> tuple:
    """pack_batch's numpy operands -> int32 tensors on ``device``."""
    dev = resolve(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(o).view(np.int32)).to(dev) for o in operands)


def verify_operands(dev_operands) -> torch.Tensor:
    """Run the program the operands select: 5 operands hash on the device,
    4 (pre-hashed digests) take the host-hash program."""
    if len(dev_operands) == 5:
        return verify_core(*dev_operands)
    return verify_core_hosthash(*dev_operands)


def _bucket_key(operands) -> tuple[int, int]:
    """(batch bucket, block bucket); block bucket 0 is the host-hash
    program (4 operands)."""
    bmax = operands[3].shape[1] // 32 if len(operands) == 5 else 0
    return operands[0].shape[1], bmax


def _sharded_verify(device):
    """(width, the lane-split verify over this process's devices of
    ``device``'s type) when the width is above 1, else None."""
    w = mesh_width(device)
    if w <= 1:
        return None
    from cometbft_tpu_torch.ops import sharded

    mesh = sharded.make_mesh(local_devices(torch.device(device).type, w))
    return w, sharded.sharded_verify_fn(mesh)


def _route_for(operands, device):
    """(program, sharded?) for pack_batch's numpy operands: the lane-split
    program when this process has several devices and the bucket is at or
    above the floor and divides over them, else the one-device program
    (operands copied to ``device``). The host-hash program never shards."""
    dev = resolve(device)
    key = _bucket_key(operands)
    if key[1] != 0:
        sh = _sharded_verify(dev)
        if sh is not None and key[0] >= mesh_floor(sh[0]) and key[0] % sh[0] == 0:
            return sh[1], True
    return (lambda *ops: verify_operands(operands_to_device(ops, dev))), False


def clear_compiled_caches() -> None:
    """Drop the cached device count, so that the next dispatch sees a
    changed device set (there is no compiled program to drop: the mesh
    programs are built a dispatch, which costs nothing beside it)."""
    _cuda_device_count.cache_clear()


# -- host packing ------------------------------------------------------------


def _host_checks(pubs, sigs, nb: int):
    """Shared host-side packing: shape checks, byte matrices, vectorized
    s < L. Returns (a_enc, r_enc, s_le, pubs_c, sigs_c, shape_ok,
    s_in_range) with nb rows."""
    n = len(pubs)
    zero_pub, zero_sig = b"\x00" * 32, b"\x00" * 64
    shape_ok = [len(pubs[i]) == 32 and len(sigs[i]) == 64 for i in range(n)]
    pubs_c = [pubs[i] if shape_ok[i] else zero_pub for i in range(n)]
    sigs_c = [sigs[i] if shape_ok[i] else zero_sig for i in range(n)]

    a_enc = np.zeros((nb, 32), np.uint8)
    r_enc = np.zeros((nb, 32), np.uint8)
    s_le = np.zeros((nb, 32), np.uint8)
    s_in_range = np.zeros(n, bool)
    if n:
        a_enc[:n] = np.frombuffer(b"".join(pubs_c), np.uint8).reshape(n, 32)
        sig_arr = np.frombuffer(b"".join(sigs_c), np.uint8).reshape(n, 64)
        r_enc[:n] = sig_arr[:, :32]
        s_le[:n] = sig_arr[:, 32:]
        # s < L: compare the four little-endian uint64 words, most
        # significant first.
        s_words = s_le[:n].view("<u8")  # [n, 4]
        l_words = np.frombuffer(L.to_bytes(32, "little"), dtype="<u8")
        decided = np.zeros(n, bool)
        for w in (3, 2, 1, 0):
            lt = ~decided & (s_words[:, w] < l_words[w])
            gt = ~decided & (s_words[:, w] > l_words[w])
            s_in_range |= lt
            decided |= lt | gt
        # s == L (all words equal) leaves decided False -> not in range.
        s_le[:n][~s_in_range] = 0
    return a_enc, r_enc, s_le, pubs_c, sigs_c, shape_ok, s_in_range


def pack_batch(pubs, msgs, sigs, width: int | None = None):
    """Host-side packing of one verification batch, no crypto: shape checks,
    the s < L check, raw bytes as words, and the challenges R || A || M
    padded into SHA-512 blocks, nb = bucket_for(n, width) lanes. Returns
    (operands, host_ok): 5 numpy operands (A, R, S words int32[8, nb], the
    pack buffer uint32[nb, B*32], block counts int32[nb]), or 4 with
    host-hashed digests int32[16, nb] when a message is past the largest
    block bucket. Invalid entries are packed as zeros: lanes the device
    evaluates but the host mask vetoes."""
    n = len(pubs)
    nb = bucket_for(n, width)
    a_enc, r_enc, s_le, pubs_c, sigs_c, shape_ok, s_in_range = _host_checks(pubs, sigs, nb)
    host_ok = np.zeros(nb, bool)
    if n:
        mlens = np.fromiter(
            (len(msgs[i]) if shape_ok[i] else 0 for i in range(n)), np.int64, n
        )
    else:
        mlens = np.zeros(0, np.int64)
    # Oversized messages (past the largest block bucket) are hashed on the
    # host: the host-hash program's shapes do not depend on message length.
    oversized = n > 0 and int(mlens.max()) + 64 > BLOCK_BUCKETS[-1] * 128 - 17
    if oversized:
        k_le = np.zeros((nb, 64), np.uint8)
        digest_rows = bytearray(64 * n)
        for i in range(n):
            if not shape_ok[i] or not s_in_range[i]:
                continue
            h = hashlib.sha512(sigs_c[i][:32])
            h.update(pubs_c[i])
            h.update(msgs[i])
            digest_rows[64 * i : 64 * (i + 1)] = h.digest()
            host_ok[i] = True
        k_le[:n] = np.frombuffer(bytes(digest_rows), np.uint8).reshape(n, 64)
        operands = (
            unpack.bytes_to_words(a_enc),
            unpack.bytes_to_words(r_enc),
            unpack.bytes_to_words(s_le),
            unpack.bytes_to_words(k_le),
        )
        return operands, host_ok

    host_ok[:n] = np.asarray(shape_ok) & s_in_range
    # Challenge blocks R || A || M, padded: R and A bulk-copy from the byte
    # matrices; messages fill in one pass per distinct length.
    tot = mlens + 64
    nblocks = s5.blocks_for(tot)
    bmax = block_bucket_for(int(nblocks.max()) if n else 1)
    buf = np.zeros((nb, bmax * 128), np.uint8)
    if n:
        buf[:n, 0:32] = r_enc[:n]
        buf[:n, 32:64] = a_enc[:n]
        for ln in np.unique(mlens):
            if ln == 0:
                continue  # shape-invalid rows were forced to length 0
            rows = np.nonzero(mlens == ln)[0]
            joined = b"".join(msgs[i] for i in rows)
            buf[rows, 64 : 64 + ln] = np.frombuffer(joined, np.uint8).reshape(len(rows), ln)
        s5.write_padding(buf[:n], tot, nblocks)
    pnb = np.zeros(nb, np.int32)
    pnb[:n] = nblocks
    # padded lanes hash zero blocks (nblocks 0 -> IV digest): vetoed by mask
    operands = (
        unpack.bytes_to_words(a_enc),
        unpack.bytes_to_words(r_enc),
        unpack.bytes_to_words(s_le),
        buf.view("<u4"),
        pnb,
    )
    return operands, host_ok


# -- dispatch ----------------------------------------------------------------

_device_pool = None
_device_pool_lock = threading.Lock()


class _DeviceOwner:
    """One daemon device-owner thread: serializes dispatches and gives
    callers an async seam (submit now, collect later). A daemon thread
    rather than a ThreadPoolExecutor, whose workers are joined at
    interpreter exit: a wedged dispatch must not hang shutdown."""

    def __init__(self):
        self._q = queue.Queue()
        t = threading.Thread(target=self._run, name="cmtpu-torch-dev", daemon=True)
        t.start()

    def _run(self):
        while True:
            fn, fut = self._q.get()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # surfaced at fut.result()
                fut.set_exception(e)

    def submit(self, fn):
        fut = Future()
        self._q.put((fn, fut))
        return fut


def _pool() -> _DeviceOwner:
    global _device_pool
    if _device_pool is None:
        with _device_pool_lock:
            if _device_pool is None:
                _device_pool = _DeviceOwner()
    return _device_pool


def batch_verify_submit(pubs, msgs, sigs, device=None):
    """Pack on the calling thread, dispatch on the device-owner thread,
    return a collect() -> (ok, bitmap) closure; the hybrid backend runs its
    host share between the two. ``collect.program_key`` is the (batch
    bucket, block bucket) of the program that ran, so that a caller can
    tell a first launch from a steady one; ``collect.launched`` is set once
    the device-owner thread has copied the operands and launched the
    program (or failed to), so that a caller can queue work behind it. A dispatch routed to the mesh is
    counted (``sharded_dispatches``, ``padded_lanes``)."""
    dev = resolve(device)
    n = len(pubs)
    operands, host_ok = pack_batch(pubs, msgs, sigs, mesh_width(dev))
    key = _bucket_key(operands)
    fn, sharded = _route_for(operands, dev)
    if sharded:
        _mesh_count("sharded_dispatches")
        _mesh_count("padded_lanes", key[0] - n)

    launched = threading.Event()

    def run():
        try:
            out = fn(*operands)
        finally:
            launched.set()
        return out.cpu().numpy()

    fut = _pool().submit(run)

    def collect() -> tuple[bool, list]:
        dev_ok = fut.result()
        results = [bool(host_ok[i] and dev_ok[i]) for i in range(n)]
        return all(results), results

    collect.program_key = key
    collect.launched = launched
    return collect


def batch_verify(pubs, msgs, sigs, device=None) -> tuple[bool, list]:
    """(overall ok, per-signature bitmap) for one batch."""
    if len(pubs) == 0:
        return False, []
    return batch_verify_submit(pubs, msgs, sigs, device)()


def warmup(buckets=None, merkle_leaves=None, device=None) -> None:
    """Make the first real commit pay no kernel build and no first launch:
    build the CUDA library, run one verify batch at each bucket (vote-sized
    challenges, two blocks, the three launches) and the tree entry, root and
    levels, at each leaf count. CPU tensors take the plain versions, which
    have nothing to build: there it returns at once."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    dev = resolve(device)
    if dev.type != "cuda":
        return
    _build.lib()
    msg = b"\x00" * 120  # 64 + 120 bytes: two SHA-512 blocks, as a vote
    for b in buckets or WARM_BUCKETS:
        operands, _ = pack_batch([b"\x00" * 32] * b, [msg] * b, [b"\x00" * 64] * b,
                                 mesh_width(dev))
        _route_for(operands, dev)[0](*operands)
    for n in merkle_leaves or WARM_LEAVES:
        flat, offsets = mk.pack_leaves([b"\x00"] * n, dev)
        mk.tree_root(flat, offsets)
        mk.tree_levels_raw(flat, offsets)
    torch.cuda.synchronize(dev)
