"""Carry-across between the reference package's numpy state and the port's
tensors (this system's counterpart of converting weights).

The reference keeps its constants and packed operands as numpy arrays
(``int32[17, N]`` field limbs, ``int32[9, 4, 17, 1]`` for the fixed-base
table, the 4- or 5-tuple ``pack_batch`` returns; for BN254 the float64
operands ``p1``, ``qa``, ``q1a``, ``q2a`` of its ``_pack`` and the
``(n, 6, 2, 13)`` Miller values its program returns; for Merkle proofs the
tuple of ``uint32[8, m]`` tree levels of ``_leaves_to_levels_core``). These
helpers turn
them into the port's tensors and back, so the tests can hand one input to
both implementations. They take numpy arrays and import nothing of the
reference.

The state of commit verification is its wire bytes: ``commit_from_wire``,
``signed_header_from_wire`` and ``validator_set_from_wire`` take what the
reference's ``Commit.encode()``, ``SignedHeader.encode()`` and its
validators' public-key proto bytes and powers give, and return the port's
objects, which encode to the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import encoding
from cometbft_tpu_torch.ops import bn254_kernel, merkle_kernel
from cometbft_tpu_torch.types import Commit, SignedHeader, Validator, ValidatorSet


def _tensor(a, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)  # same bits; this PyTorch has no uint32 arithmetic
    return torch.from_numpy(arr.copy()).to(device)


def operands_from_jax(operands, device="cpu") -> tuple:
    """The reference's ``pack_batch`` operands (A, R, S words int32[8, N],
    then either the pack buffer uint32[N, B*32] and block counts int32[N],
    or host-hashed digest words int32[16, N]) -> int32 tensors."""
    if len(operands) not in (4, 5):
        raise ValueError(f"expected 4 or 5 operands, got {len(operands)}")
    return tuple(_tensor(o, device) for o in operands)


def point_from_jax(point, device="cpu") -> tuple:
    """(X, Y, Z, T) as int32[17, N] arrays -> four int32 tensors."""
    return tuple(_tensor(c, device).to(torch.int32) for c in point)


def point_to_jax(point) -> tuple:
    """Four int32[17, N] tensors -> numpy int32 arrays."""
    return tuple(c.detach().to(torch.int32).cpu().numpy() for c in point)


def table_b_from_jax(table, device="cpu") -> torch.Tensor:
    """The reference's TABLE_B_PRE, int32[9, 4, 17, 1] -> tensor."""
    t = _tensor(table, device)
    if tuple(t.shape) != (9, 4, 17, 1):
        raise ValueError(f"expected a [9, 4, 17, 1] table, got {tuple(t.shape)}")
    return t.to(torch.int32)


def bn254_operands_from_jax(operands, device="cpu") -> tuple:
    """The reference's BN254 ``_pack`` operands: p1 float64 (n, 2, 13) and
    qa, q1a, q2a float64 (n, 2, 2, 13) -> float64 tensors."""
    if len(operands) != 4:
        raise ValueError(f"expected 4 operands (p1, qa, q1a, q2a), got {len(operands)}")
    p1, *qs = (torch.from_numpy(np.ascontiguousarray(o, dtype=np.float64)).to(device)
               for o in operands)
    n = p1.shape[0]
    if tuple(p1.shape) != (n, 2, 13) or any(tuple(q.shape) != (n, 2, 2, 13) for q in qs):
        raise ValueError(f"bad BN254 operand shapes {[tuple(o.shape) for o in (p1, *qs)]}")
    return (p1, *qs)


def bn254_values_from_jax(out) -> list:
    """(n, 6, 2, 13) Miller values (loose float64 limbs, the reference's
    program output, or the port's) -> n Fp12 values as host ints mod P."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    return bn254_kernel.unpack_values(np.asarray(out, dtype=np.float64))


def bn254_values_to_jax(values) -> np.ndarray:
    """n Fp12 values (6 pairs of ints) -> (n, 6, 2, 13) float64 canonical
    limbs, the layout of the reference's program output."""
    out = np.zeros((len(values), 6, 2, 13), dtype=np.float64)
    for lane, v in enumerate(values):
        for k in range(6):
            for c in range(2):
                out[lane, k, c] = bn254_kernel.to_limbs(v[k][c] % bn254_kernel.P)
    return out


def levels_from_jax(levels, device="cpu") -> torch.Tensor:
    """The reference's tree levels, a sequence of uint32[8, m] arrays
    (leaves first) -> int32[total, 8], the levels entry's layout."""
    levels = [np.asarray(lv) for lv in levels]
    rows = merkle_kernel.level_rows(levels[0].shape[1]) if levels else []
    if [lv.shape for lv in levels] != [(8, count) for _, count in rows]:
        raise ValueError(f"not the levels of one tree: {[lv.shape for lv in levels]}")
    return _tensor(np.concatenate([lv.T for lv in levels]), device)


def levels_to_jax(levels) -> tuple:
    """int32[total, 8] levels -> the reference's tuple of uint32[8, m]
    arrays, leaves first (the leaf count follows from total)."""
    arr = np.ascontiguousarray(levels.detach().cpu().numpy()).view(np.uint32)
    total, n = arr.shape[0], max(1, (arr.shape[0] - 64) // 2)
    while merkle_kernel.level_rows(n)[-1][0] + 1 < total:
        n += 1
    rows = merkle_kernel.level_rows(n)
    if rows[-1][0] + 1 != total or arr.shape[1:] != (8,):
        raise ValueError(f"{tuple(arr.shape)} is not the levels of any tree")
    return tuple(np.ascontiguousarray(arr[base : base + count].T) for base, count in rows)


def commit_from_wire(encoded: bytes) -> Commit:
    """A commit from its proto bytes (the reference's ``Commit.encode()``)."""
    return Commit.decode(encoded)


def signed_header_from_wire(encoded: bytes) -> SignedHeader:
    """A signed header from its proto bytes (``SignedHeader.encode()``)."""
    return SignedHeader.decode(encoded)


def validator_set_from_wire(validators) -> ValidatorSet:
    """A validator set from (public-key proto bytes, voting power) pairs,
    one a validator (the reference's ``pub_key_to_proto(v.pub_key)`` and
    ``v.voting_power``): the set is built as the reference builds it, so
    its order, proposer priorities, hash and encoding are the same."""
    return ValidatorSet([Validator.new(encoding.pub_key_from_proto(pk), power)
                         for pk, power in validators])
