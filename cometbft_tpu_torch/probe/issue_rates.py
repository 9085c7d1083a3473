"""Measured issue rates of the integer instructions the field arithmetic
runs on: IMAD.WIDE, IMAD.WIDE.U32, IMAD, SHFL.IDX and LOP3, in thread-
instructions a clock per SM (``issue_rates.cu``).

The rates are what the kernels' issue estimates rest on (``chip_smoke.py``
divides the ladder's SASS instruction mix by them). Each probe's SASS is
read back (``cuobjdump``) and its count of the probed instruction printed
beside its rate, so a probe that the assembler rewrote shows as such.

Run on a CUDA machine: ``python3 -m cometbft_tpu_torch.probe.issue_rates``
prints one JSON object.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from cometbft_tpu_torch.ops import _build

SRC = Path(__file__).resolve().parent / "issue_rates.cu"
# probe kind -> the SASS opcode it issues
OPCODES = {0: "IMAD.WIDE", 1: "IMAD.WIDE.U32", 2: "IMAD", 3: "SHFL.IDX", 4: "LOP3.LUT"}
ITERS = 2048
BLOCKS_PER_SM = 4  # x 256 threads: 32 warps an SM, 8 chains each

_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def build() -> Path:
    """Compile the probes (nvcc, sm_90a) into the kernels' build directory;
    an up-to-date library is reused."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(_build.ARCH_FLAGS).encode())
    so = _build.BUILD_DIR / f"libcmtpu_probe_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(tmp), str(SRC)], check=True)
        os.replace(tmp, so)
    return so


def sass_counts(so: Path, pattern: str) -> dict[int, collections.Counter]:
    """Static SASS opcode counts of each instance of the kernel template
    whose mangled name matches ``pattern`` (one group: the template
    argument), from ``cuobjdump``; empty where the toolkit lacks it."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        return {}
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = re.search(pattern, line)
            cur = int(fn.group(1)) if fn else None
            if cur is not None:
                out[cur] = collections.Counter()
            continue
        op = _SASS_OP.search(line)
        if op and cur is not None:
            out[cur][op.group(1)] += 1
    return out


def measure(sms: int, clock_hz: float, reps: int = 5) -> dict:
    """{opcode: {"rate": probed instructions a clock per SM (median of
    ``reps`` launches), "ms": median launch time, "sass": static count of
    the opcode in its probe (rounds x chains unrolled: 32), "mix": the
    probe's most common opcodes}}. Where ptxas emits fewer than 32 of the
    opcode, the rate is that of the PTX instruction as ptxas lowered it."""
    so = build()
    lib = ctypes.CDLL(str(so))
    lib.cmtpu_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.cmtpu_probe.restype = ctypes.c_int
    lib.cmtpu_probe_ops_per_thread.argtypes = [ctypes.c_int]
    lib.cmtpu_probe_ops_per_thread.restype = ctypes.c_longlong
    counts = sass_counts(so, r"probe_kernelILi(\d+)E")
    dev = torch.device("cuda")
    inp = torch.arange(3, 3 + 17, dtype=torch.int32, device=dev)
    inp[16] = 0
    blocks = BLOCKS_PER_SM * sms
    out = torch.empty(blocks * 256 * 8, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ops = blocks * 256 * lib.cmtpu_probe_ops_per_thread(ITERS)
    result = {}
    for kind, opcode in OPCODES.items():
        def launch():
            rc = lib.cmtpu_probe(kind, blocks, ITERS, inp.data_ptr(), out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"probe {opcode} launch failed ({rc})")
        launch()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            launch()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = statistics.median(times)
        mix = counts.get(kind, collections.Counter())
        mix.pop("NOP", None)
        result[opcode] = {"rate": ops / (ms * 1e-3) / sms / clock_hz, "ms": ms,
                          "sass": mix.get(opcode), "mix": mix.most_common(6)}
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("issue_rates: needs a CUDA device", file=sys.stderr)
        return 2
    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    rates = measure(props.multi_processor_count, float(clock) * 1e6)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "max_sm_clock_mhz": float(clock),
                      "sms": props.multi_processor_count, "rates": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
