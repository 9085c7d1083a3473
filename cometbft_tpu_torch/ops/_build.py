"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. Pointers and the
CUDA stream cross as ``c_void_p``. The library goes into ``ops/_build/``
(ignored by git) on first use, named by a hash of the sources and flags, so
a changed source always rebuilds. A missing ``nvcc`` or a failed build
raises; nothing falls back to the plain versions.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels. A source's entries count under its name
(``challenge_digits`` and ``scalar_digits`` under ``sha512``).

Every launch goes through ``launch``, which makes the tensors' device the
thread's current CUDA device for the call: the C entries launch on the
current device, and some size their grid or raise their shared-memory
ceiling from ``cudaGetDevice()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

FALLBACK_NVCC = "/usr/local/cuda/bin/nvcc"
KERNELS = ("ladder", "decompress", "sha512", "sha256", "bn254")
LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "cmtpu_ladder_verify": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "cmtpu_ladder_config": [_I, _I, _P],
    "cmtpu_decompress_words": [_P, _P, _P, _P, _I, _P],
    "cmtpu_challenge_digits": [_P, _P, _I, _P, _P, _P, _I, _P],
    "cmtpu_scalar_digits": [_P, _P, _P, _P, _I, _P],
    "cmtpu_sha256_leaf": [_P, _P, _P, _I, _I, _P],
    "cmtpu_sha256_inner": [_P, _LL, _LL, _P, _LL, _LL, _P, _I, _P],
    "cmtpu_sha256_tree_chunks": [_P, _P, _I, _I, _P, _P, _I, _P],
    "cmtpu_sha256_tree_roots": [_P, _I, _I, _P, _I, _P],
    "cmtpu_sha256_digest_tree": [_P, _I, _I, _P, _P],
    "cmtpu_bn254_miller": [_P, _P, _P, _P, _P, _I, _P],
    "cmtpu_bn254_config": [_I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    FALLBACK_NVCC. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append(FALLBACK_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cometbft_tpu_torch: nvcc not found (CUDA_HOME, PATH, /usr/local/cuda); "
        "the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link the
    shared library. Returns its path; an up-to-date library is reused."""
    global BUILD_LOG
    so = BUILD_DIR / f"libcmtpu_kernels_{_digest()}.so"
    if so.exists():
        return so
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
    tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.cmtpu_error_string.argtypes = [ctypes.c_int]
            handle.cmtpu_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check_launch(kernel: str, rc: int) -> None:
    """Raise on a nonzero cudaGetLastError() after a launch, else count it."""
    if rc != 0:
        msg = lib().cmtpu_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
    with _count_lock:  # launches come from several threads (the fanout's shards)
        LAUNCHES[kernel] += 1


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the current stream of
    ``device`` last, with ``device`` the calling thread's current CUDA
    device; raise on its error code, else count one launch of ``kernel``."""
    with torch.cuda.device(device):
        rc = getattr(lib(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(kernel, rc)


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.int32) -> None:
    """The kernels take contiguous CUDA tensors of one dtype (int32 unless
    stated) on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
