"""The ``ladder`` kernel's wrapper: the per-lane Ed25519 check after
decoding, [8]([s]B + [k](-A) - R) == identity and both decodings, on the
card.

Counterpart of ``cometbft_tpu/ops/pallas_ladder.py`` (``_ladder_kernel``,
the repo's one Pallas kernel), of its XLA twin
``edwards.windowed_double_base_mult`` and of the cofactored epilogue of
``ed25519_kernel._verify_from_words`` (-A before the ladder; add -R, three
doublings and the identity test after it): one hand-written CUDA kernel
(``csrc/ladder.cu``) replaces all of them, with G threads per lane
(``GROUPS``; ``GROUP`` on the main path). Its plain version is
``verify_lanes_plain``, which CPU tensors take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import edwards as ed
from cometbft_tpu_torch.ops import field25519 as fe

# Threads per lane the kernel is built for, and the one the main path runs
# (the fastest of the three on the H100: PERF.md).
GROUPS = (1, 2, 5)
GROUP = 5

# Bit offsets of the kernel's ten limbs of radix 2^25.5 (26, 25, 26, ... bits).
FE10_OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255)


def int_to_fe10(v: int) -> list[int]:
    """Python int (< 2^255) -> the kernel's ten limbs of radix 2^25.5."""
    return [
        (v >> FE10_OFFSETS[i]) & ((1 << (FE10_OFFSETS[i + 1] - FE10_OFFSETS[i])) - 1)
        for i in range(10)
    ]


@functools.lru_cache(maxsize=None)
def _table_b10(device: str) -> torch.Tensor:
    rows = [[int_to_fe10(v) for v in row] for row in ed.table_b_ints()]
    return torch.tensor(rows, dtype=torch.int32, device=device)  # [9, 4, 10]


def verify_lanes_plain(s_digits, k_digits, pt, ok):
    """Plain version of the kernel: (verdict bool[N], [s]B + [k](-A) as
    four int32[17, N] of loose limbs). pt holds A then R lane-stacked
    (four int32[17, 2N] coordinates, or one int32[4, 17, 2N]); ok bool[2N]."""
    n = s_digits.shape[1]
    a = tuple(c[:, :n] for c in pt)
    r = tuple(c[:, n:] for c in pt)
    acc = ed.windowed_double_base_mult(s_digits, k_digits, ed.point_neg(a))
    chk = ed.point_add(acc, ed.point_neg(r))
    chk = ed.point_double(ed.point_double(ed.point_double(chk)))
    return ok[:n] & ok[n:] & ed.point_is_identity(chk), acc


def verify_lanes(s_digits, k_digits, pt, ok, *, group: int | None = None,
                 with_acc: bool = False):
    """The per-lane verdict bool[N] for s_digits/k_digits int32[64, N] in
    [-8, 8] (row w of weight 16^w), pt the decoded A then R
    (``edwards.decompress_words``: int32[4, 17, 2N]) and ok bool[2N].
    With ``with_acc`` also [s]B + [k](-A) as four int32[17, N].

    CPU tensors take the plain version; CUDA tensors launch the kernel once,
    with ``group`` threads per lane (``GROUP`` when None). The kernel's
    accumulator is canonical; the plain version's agrees with it through
    ``edwards.point_freeze``."""
    if s_digits.device.type == "cpu":
        verdict, acc = verify_lanes_plain(s_digits, k_digits, pt, ok)
        return (verdict, acc) if with_acc else verdict
    g = GROUP if group is None else group
    if g not in GROUPS:
        raise ValueError(f"ladder: group must be one of {GROUPS}, got {g}")
    n = s_digits.shape[1]
    tb = _table_b10(str(s_digits.device))
    _build.require_cuda("ladder", s_digits, k_digits, pt, tb)
    _build.require_cuda("ladder", ok, dtype=torch.bool)
    if (s_digits.shape != (ed.DIGITS, n) or k_digits.shape != (ed.DIGITS, n)
            or pt.shape != (4, fe.LIMBS, 2 * n) or ok.shape != (2 * n,)):
        raise ValueError(f"ladder: bad shapes {s_digits.shape} {k_digits.shape} "
                         f"{pt.shape} {ok.shape}")
    verdict = torch.empty((n,), dtype=torch.bool, device=s_digits.device)
    acc = torch.empty((4, fe.LIMBS, n) if with_acc else (0,), dtype=torch.int32,
                      device=s_digits.device)
    if n:
        rc = _build.lib().cmtpu_ladder_verify(
            s_digits.data_ptr(), k_digits.data_ptr(), pt.data_ptr(), ok.data_ptr(),
            tb.data_ptr(), verdict.data_ptr(), acc.data_ptr() if with_acc else None,
            n, g, _build.stream_of(s_digits),
        )
        _build.check_launch("ladder", rc)
    return (verdict, (acc[0], acc[1], acc[2], acc[3])) if with_acc else verdict


def launch_config(n: int, group: int) -> dict:
    """The launch shape the kernel takes for n lanes at ``group`` threads a
    lane, and its registers and local (spill) bytes a thread (needs CUDA)."""
    out = (ctypes.c_int * 6)()
    rc = _build.lib().cmtpu_ladder_config(n, group, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"ladder config: {_build.lib().cmtpu_error_string(rc).decode()}")
    keys = ("blocks", "threads", "smem_bytes", "lanes_per_block", "registers", "local_bytes")
    return dict(zip(keys, out))
