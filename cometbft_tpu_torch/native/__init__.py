"""The port's host tier in C: batch Ed25519 verification and Merkle trees.

Counterpart of ``cometbft_tpu/native/``: the same three C sources, byte for
byte (``ed25519_msm.c``: radix-51 field arithmetic, ZIP-215 decompression
and a Pippenger MSM over the random-linear-combination batch equation;
``fe_ifma.c``: the AVX-512 IFMA decompression exponent, dispatched at run
time; ``sha256_merkle.c``: the RFC-6962 tree with its level loop in C, on
SHA-NI where the CPU has it), so the results equal the reference's by
construction. ``gcc`` builds them at first use into
``_build/libcmtpu_native.so``, bound with ctypes.

Unlike the reference, a build that fails raises, with gcc's output: the
port never switches to another verifier because a compiler is missing.
``ready()`` raises too once a build has failed.

Soundness: the batch equation uses independent 128-bit random nonzero
coefficients, so a batch that verifies without being valid has probability
~2^-128. On batch failure the wrapper bisects; with z_i != 0 the randomized
single-signature check is exactly the cofactored ZIP-215 check ([8][z](sB -
R - hA) == id iff [8](sB - R - hA) == id for 0 < z < L), so the recovered
bitmap is exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("ed25519_msm.c", "sha256_merkle.c", "fe_ifma.c")
BUILD_DIR = os.path.join(_HERE, "_build")

L = 2**252 + 27742317777372353535851937790883648493

_lock = threading.Lock()
# The C MSM uses a static bucket table; serialize calls into it.
_msm_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: Exception | None = None  # the failed build, raised again on every use

_VOID, _LONG, _INT, _BUF = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p
# (name, restype, argtypes) of every function the wrappers below call.
_SIGNATURES = (
    ("cmtpu_ed25519_precheck", _LONG, [_LONG, _BUF, _BUF, _VOID, _VOID, _VOID]),
    ("cmtpu_ed25519_check_subset", _INT, [_VOID, _VOID, _VOID, _LONG, _BUF, _BUF, _BUF]),
    ("cmtpu_ge_size", _LONG, []),
    ("cmtpu_sha512_batch", None, [_LONG, _BUF, _VOID, _VOID]),
    ("cmtpu_ed25519_scalar_prep", None, [_LONG, _VOID, _BUF, _BUF, _VOID, _VOID, _VOID, _VOID]),
    ("cmtpu_merkle_root", None, [_LONG, _BUF, _VOID, _VOID, _VOID]),
    ("cmtpu_sha256_batch", None, [_LONG, _BUF, _VOID, _VOID]),
    ("cmtpu_merkle_levels", None, [_LONG, _BUF, _VOID, _VOID]),
    ("cmtpu_merkle_aunts", None, [_LONG, _VOID, _LONG, _VOID, _VOID]),
)


def _so_path() -> str:
    return os.path.join(BUILD_DIR, "libcmtpu_native.so")


def _build() -> str:
    """Compile the library unless a copy newer than every source exists;
    the path of the library. Raises RuntimeError with gcc's output."""
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    so = _so_path()
    if os.path.exists(so) and os.path.getmtime(so) >= max(os.path.getmtime(s) for s in srcs):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(["gcc", "-O3", "-fPIC", "-shared", "-o", tmp, *srcs],
                       check=True, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"cometbft_tpu_torch.native: gcc not found ({e})") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"cometbft_tpu_torch.native: gcc failed (exit {e.returncode}):\n{e.stderr}"
        ) from e
    os.replace(tmp, so)  # atomic: concurrent compiles each publish a whole library
    return so


def load() -> ctypes.CDLL:
    """The bound library, built first if need be (seconds of gcc). Raises
    when the build or the load failed, now or on an earlier call."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _error is not None:
                raise RuntimeError("cometbft_tpu_torch.native: the build failed") from _error
            try:
                lib = ctypes.CDLL(_build())
            except (RuntimeError, OSError) as e:
                _error = e
                raise
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def ready() -> ctypes.CDLL | None:
    """Non-blocking: the loaded library, or None while it is not built yet.
    Never starts a compile (pair it with ``ensure_built_async``); raises
    once a build has failed."""
    if _error is not None:
        raise RuntimeError("cometbft_tpu_torch.native: the build failed") from _error
    return _lib


def ensure_built_async() -> None:
    """Build and load on a daemon thread, so a first verification never
    waits on gcc unless it needs the library. A failure is kept and raised
    by the next ``ready()`` or wrapper call."""
    if _lib is not None or _error is not None:
        return

    def build():
        try:
            load()
        except (RuntimeError, OSError):
            pass  # kept in _error

    threading.Thread(target=build, name="cmtpu-torch-native-build", daemon=True).start()


def _offsets(lengths, n: int):
    """uint64[n + 1] cumulative offsets as a ctypes array, from n lengths."""
    offs = (ctypes.c_uint64 * (n + 1))()
    np.cumsum(np.fromiter(lengths, np.uint64, n), out=np.frombuffer(offs, np.uint64)[1:])
    return offs


def batch_verify(pubs: list[bytes], msgs: list[bytes], sigs: list[bytes]) -> tuple[bool, list[bool]]:
    """ZIP-215 batch verification with an exact per-signature bitmap: one
    MSM when every signature is valid, bisection on failure."""
    lib = load()
    n = len(pubs)
    bits = [False] * n
    cand = [i for i in range(n) if len(pubs[i]) == 32 and len(sigs[i]) == 64]
    m = len(cand)
    if m == 0:
        return False, bits

    pub_buf = b"".join(pubs[i] for i in cand)
    sig_buf = b"".join(sigs[i] for i in cand)
    ge_size = lib.cmtpu_ge_size()
    a_neg = ctypes.create_string_buffer(m * ge_size)
    r_neg = ctypes.create_string_buffer(m * ge_size)
    dec_ok = ctypes.create_string_buffer(m)
    lib.cmtpu_ed25519_precheck(m, pub_buf, sig_buf, a_neg, r_neg, dec_ok)

    # h = SHA512(R || A || M), then the scalar work (s < L, h mod L, z odd,
    # z * h, the s sum) in one C pass.
    chal_buf = b"".join(sigs[i][:32] + pubs[i] + msgs[i] for i in cand)
    offs = _offsets((64 + len(msgs[i]) for i in cand), m)
    digests = ctypes.create_string_buffer(64 * m)
    lib.cmtpu_sha512_batch(m, chal_buf, offs, digests)
    z_buf = ctypes.create_string_buffer(32 * m)
    zh_buf = ctypes.create_string_buffer(32 * m)
    ssum_buf = ctypes.create_string_buffer(32)
    lib.cmtpu_ed25519_scalar_prep(m, digests, sig_buf, os.urandom(16 * m), z_buf, zh_buf,
                                  ssum_buf, dec_ok)
    okflags = dec_ok.raw  # decompressed and s in range
    eligible = [j for j in range(m) if okflags[j]]
    if not eligible:
        return False, bits
    zb, zhb = z_buf.raw, zh_buf.raw

    def check(subset: list[int], ssum: bytes) -> bool:
        idx = (ctypes.c_int64 * len(subset))(*subset)
        with _msm_lock:
            return bool(lib.cmtpu_ed25519_check_subset(a_neg, r_neg, idx, len(subset), ssum, zb, zhb))

    if check(eligible, ssum_buf.raw):
        for j in eligible:
            bits[cand[j]] = True
        return all(bits), bits

    # The batch failed: bisect. A subset's s sum needs the integers.
    z_int = {j: int.from_bytes(zb[32 * j : 32 * j + 32], "little") for j in eligible}
    s_int = {j: int.from_bytes(sigs[cand[j]][32:], "little") for j in eligible}

    def settle(subset: list[int]) -> None:
        ssum = sum(z_int[j] * s_int[j] for j in subset)
        if check(subset, (ssum % L).to_bytes(32, "little")):
            for j in subset:
                bits[cand[j]] = True
            return
        if len(subset) == 1:
            return  # exact: the randomized single check is the cofactored one
        mid = len(subset) // 2
        settle(subset[:mid])
        settle(subset[mid:])

    mid = len(eligible) // 2
    if eligible[:mid]:
        settle(eligible[:mid])
    settle(eligible[mid:])
    return all(bits), bits


def merkle_root(leaves: list[bytes]) -> bytes:
    """RFC-6962 root, equal to ``crypto/merkle.hash_from_byte_slices``."""
    lib = load()
    n = len(leaves)
    if n == 0:
        return hashlib.sha256(b"").digest()
    out = ctypes.create_string_buffer(32)
    lib.cmtpu_merkle_root(n, b"".join(leaves), _offsets((len(v) for v in leaves), n),
                          ctypes.create_string_buffer(32 * n), out)
    return out.raw


def merkle_proof_parts(leaves: list[bytes]) -> tuple[bytes, list[bytes], bytes, int, list[int]]:
    """Every level hashed in one C pass: (root, leaf hashes, packed aunts,
    stride, counts); leaf i's aunts are ``packed[i * stride : i * stride +
    32 * counts[i]]``, 32-byte nodes, the sibling first."""
    lib = load()
    n = len(leaves)
    if n == 0:
        return hashlib.sha256(b"").digest(), [], b"", 0, []
    total_nodes, size, depth = 0, n, 0
    while True:
        total_nodes += size
        if size == 1:
            break
        size = (size + 1) // 2
        depth += 1
    levels = ctypes.create_string_buffer(32 * total_nodes)
    lib.cmtpu_merkle_levels(n, b"".join(leaves), _offsets((len(v) for v in leaves), n), levels)
    raw = levels.raw
    stride = 32 * max(depth, 1)
    aunts = ctypes.create_string_buffer(n * stride)
    counts = (ctypes.c_int32 * n)()
    lib.cmtpu_merkle_aunts(n, levels, max(depth, 1), aunts, counts)
    return (raw[32 * (total_nodes - 1) :], [raw[32 * i : 32 * i + 32] for i in range(n)],
            aunts.raw, stride, list(counts))


def sha256_batch(msgs: list[bytes]) -> list[bytes]:
    """SHA-256 of each message, in one C call."""
    lib = load()
    n = len(msgs)
    if n == 0:
        return []
    out = ctypes.create_string_buffer(32 * n)
    lib.cmtpu_sha256_batch(n, b"".join(msgs), _offsets((len(m) for m in msgs), n), out)
    raw = out.raw
    return [raw[32 * i : 32 * i + 32] for i in range(n)]
