"""Short device probe: a timestamped line at each phase, so that a hang is
attributable (the counterpart of the JAX package's ``tpu_probe.py``).

    python -m cometbft_tpu_torch.probe.device

Phases: torch imported, device found, kernels built (nvcc at first use),
one 128-lane verify on the card, the copy back to the host, ``PROBE OK``.
Exits nonzero, with the phase that failed, when there is no card or a phase
raises. Redirect its output to a file that survives a timeout kill.
"""

import sys
import time

T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def main() -> int:
    log("start")
    import torch

    log(f"torch {torch.__version__} imported (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    dev = torch.device("cuda")
    log(f"device found: {torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} visible)")
    from cometbft_tpu_torch.ops import _build

    so = _build.build()
    _build.lib()
    log(f"kernels built: {so.name}")
    from cometbft_tpu_torch.entry import entry

    fn, args = entry(dev)
    out = fn(*args)
    torch.cuda.synchronize(dev)
    log(f"one 128-lane verify done ({sum(_build.LAUNCHES.values())} launches)")
    ok = out.cpu().numpy()
    log(f"D2H done: {ok.shape}, all valid: {bool(ok.all())}")
    if not ok.all():
        log("PROBE FAILED: the example batch did not verify")
        return 1
    log("PROBE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
