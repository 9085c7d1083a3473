"""Operand unpacking for the verify pipeline (plain PyTorch).

Counterpart of ``cometbft_tpu/ops/unpack.py``. The verify path takes the
raw encodings (A, R, S as 8 little-endian uint32 words per 32-byte string;
the 64-byte SHA-512 challenge as 16 words) and computes:

  - point y-limbs + sign bit        (words_to_limbs255)
  - s -> signed 4-bit window digits (scalar_words_to_digits)
  - k = digest mod L -> digits      (digest_words_to_digits)

On the card that work is done inside two kernels: the recodes and the
reduction in ``sha512`` (``sha512_kernel.challenge_digits``), the y-limbs
and signs in ``decompress`` (``edwards.decompress_words``). This module is
their plain side: the CPU path and the tests' oracle run it.

Words arrive as int32 tensors holding the uint32 bit pattern; they are
widened to int64 and masked, because this PyTorch does not implement
shifts and adds on uint32. The mod-L reduction is the reference's: 12-bit
limbs, three folds by 2^252 = -c (mod L) with c = L - 2^252, each adding a
precomputed multiple of L before the subtraction, then one conditional
subtract of L; the signed-window recode is the add-8s identity. The
results are bit-identical to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.ops import field25519 as fe
from cometbft_tpu_torch.ops.sha256_kernel import to_u32

L = 2**252 + 27742317777372353535851937790883648493
C = L - 2**252  # 125 bits

_LB = 12  # limb bits for the scalar arithmetic
_LMASK = (1 << _LB) - 1


def _int_to_limbs12(v: int, n: int) -> list[int]:
    return [(v >> (_LB * i)) & _LMASK for i in range(n)]


_C_LIMBS = _int_to_limbs12(C, 11)
_L_LIMBS = _int_to_limbs12(L, 22)
# Multiples of L with headroom for each fold's subtraction.
_M1_LIMBS = _int_to_limbs12(L << 140, 33)  # >= max D1 = 2^264 * c < 2^389
_M2_LIMBS = _int_to_limbs12(L << 15, 23)   # >= max D2 = 2^141 * c < 2^266
_M3_LIMBS = _L_LIMBS                        # >= max D3 = 2^16 * c < 2^141
_EIGHTS_LIMBS = _int_to_limbs12(int("8" * 64, 16), 22)


def bytes_to_words(b: np.ndarray) -> np.ndarray:
    """uint8[N, 4k] little-endian -> int32[k, N] holding the uint32 words
    (host)."""
    w = np.ascontiguousarray(b, np.uint8).view("<u4")  # [N, k]
    return np.ascontiguousarray(w.T).astype(np.int32)  # int32 BIT pattern


def words_to_limbs255(w: torch.Tensor):
    """int32[8, N] words -> (int32[17, N] 15-bit limbs of bits 0..254,
    bool[N] sign = bit 255)."""
    wu = to_u32(w)
    limbs = []
    for i in range(fe.LIMBS):
        j, off = divmod(15 * i, 32)
        v = wu[j] >> off
        if off > 32 - 15 and j + 1 < 8:
            v = v | (wu[j + 1] << (32 - off))
        limbs.append(v & fe.MASK)
    sign = (wu[7] >> 31) == 1
    return torch.stack(limbs).to(torch.int32), sign


def _words_to_limbs12(w: torch.Tensor, nbits: int) -> torch.Tensor:
    """int32[k, N] uint32 words -> int64[ceil(nbits / 12), N] 12-bit limbs."""
    wu = to_u32(w)
    nwords = w.shape[0]
    out = []
    for i in range((nbits + _LB - 1) // _LB):
        j, off = divmod(_LB * i, 32)
        v = wu[j] >> off
        if off > 32 - _LB and j + 1 < nwords:
            v = v | (wu[j + 1] << (32 - off))
        out.append(v & _LMASK)
    return torch.stack(out)


def _carry_seq(limbs: torch.Tensor, nout: int) -> torch.Tensor:
    """Sequential signed carry chain: normalize to nout limbs in [0, 2^12).
    Arithmetic >> floors, so negative intermediates stay correct; the value
    must be non-negative and fit nout limbs."""
    out = []
    carry = None
    for i in range(nout):
        v = limbs[i] if i < limbs.shape[0] else torch.zeros_like(limbs[0])
        if carry is not None:
            v = v + carry
        q = v >> _LB
        out.append(v - (q << _LB))
        carry = q
    return torch.stack(out)


def _const(limbs, like: torch.Tensor) -> torch.Tensor:
    return fe.const_limbs(limbs, like.device).to(torch.int64)


def _fold(limbs: torch.Tensor, m_limbs: list[int], nout: int) -> torch.Tensor:
    """One reduction round: split at limb 21 (bit 252), return
    lo + (M - hi*c) carried to nout limbs."""
    lo, hi = limbs[:21], limbs[21:]
    # hi * c as column sums: products < 2^24, columns < 11 * 2^24
    d = fe.band_columns(_const(_C_LIMBS, hi)[:, None, :] * hi[None, :, :])
    n = limbs.shape[1]
    acc = torch.zeros((nout, n), dtype=torch.int64, device=limbs.device)
    acc[: lo.shape[0]] += lo
    acc[: len(m_limbs)] += _const(m_limbs, limbs)
    acc[: min(nout, d.shape[0])] -= d[:nout]
    return _carry_seq(acc, nout)


def _cond_sub_l(limbs: torch.Tensor) -> torch.Tensor:
    """22 limbs (value < 2L) -> value mod L by one conditional subtract."""
    diff = []
    borrow = None
    for i in range(22):
        v = limbs[i] - _L_LIMBS[i]
        if borrow is not None:
            v = v + borrow
        q = v >> _LB  # 0 or -1
        diff.append(v - (q << _LB))
        borrow = q
    ge = borrow == 0  # no final borrow -> value >= L
    return torch.where(ge[None, :], torch.stack(diff), limbs)


def _limbs_to_digits(limbs: torch.Tensor) -> torch.Tensor:
    """22 12-bit limbs (value < 2^253) -> int32[64, N] signed radix-16
    digits in [-8, 7] by the add-8s identity (t = v + 0x88..8; nibble - 8)."""
    t = _carry_seq(limbs + _const(_EIGHTS_LIMBS, limbs), 22)
    digits = []
    for d in range(64):
        j, off = divmod(4 * d, _LB)  # 4 divides 12: no nibble straddles limbs
        digits.append(((t[j] >> off) & 15) - 8)
    return torch.stack(digits).to(torch.int32)


def scalar_words_to_digits(w: torch.Tensor) -> torch.Tensor:
    """int32[8, N] words of s (< L, host-checked) -> signed digits [64, N]."""
    return _limbs_to_digits(_words_to_limbs12(w, 256))


def digest_words_to_digits(w: torch.Tensor) -> torch.Tensor:
    """int32[16, N] words of the 64-byte SHA-512 challenge -> signed digits
    of (digest mod L)."""
    limbs = _words_to_limbs12(w, 512)  # 43 limbs
    r1 = _fold(limbs, _M1_LIMBS, 33)
    r2 = _fold(r1, _M2_LIMBS, 23)
    r3 = _fold(r2, _M3_LIMBS, 22)  # < lo_max + L < 2L
    return _limbs_to_digits(_cond_sub_l(r3))
