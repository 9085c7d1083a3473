"""Batched edwards25519 point operations (plain PyTorch) and the
``decompress`` kernel's wrapper.

Counterpart of ``cometbft_tpu/ops/edwards.py``: points are extended
homogeneous coordinates (X, Y, Z, T), each an ``int32[17, N]`` field
element (see field25519); the formulas are the reference's, in the same
order, so every coordinate agrees with it as a canonical residue mod p.
On edwards25519 the hwcd-3 addition is complete: one branch-free formula
covers doubling, the identity and small-order inputs.

Double-scalar multiplication [s]B + [k]A uses signed 4-bit windows (64
digits in [-8, 8], MSB first): 4 doublings plus one add from the per-lane
[0..8]A table and one from the constant [0..8]B table per window.
``windowed_double_base_mult`` here is the plain version of the ``ladder``
kernel's accumulator (ops/ladder.py).

``decompress_words`` is the ZIP-215 decoding wrapper, from the raw
encodings of A and R: the CUDA kernel (``csrc/decompress.cu``) for CUDA
tensors, ``decompress_words_plain`` (``unpack.words_to_limbs255`` on both
operands, then ``decompress_plain``) for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import field25519 as fe
from cometbft_tpu_torch.ops import unpack

_P = fe.P_INT
_D = fe.D_INT
_BY = (4 * pow(5, _P - 2, _P)) % _P


def _recover_x_int(y: int, sign: int) -> int:
    y2 = y * y % _P
    u = (y2 - 1) % _P
    v = (_D * y2 + 1) % _P
    x = (u * pow(v, 3, _P)) % _P * pow((u * pow(v, 7, _P)) % _P, (_P - 5) // 8, _P) % _P
    if v * x % _P * x % _P != u:
        x = x * fe.SQRT_M1_INT % _P
    if x & 1 != sign:
        x = _P - x
    return x


_BX = _recover_x_int(_BY, 0)

WINDOW_BITS = 4
DIGITS = 64  # ceil(253 / 4) windows cover scalars < L < 2^253 (+ carry room)


def _c(v: int, like: torch.Tensor) -> torch.Tensor:
    return fe.const_fe(v, like.device)


def _full(v: int, n: int, device) -> torch.Tensor:
    return fe.const_fe(v, device).expand(fe.LIMBS, n).contiguous()


def identity(n: int, device):
    """(0 : 1 : 1 : 0) broadcast to batch n."""
    z, o = _full(0, n, device), _full(1, n, device)
    return (z, o, o.clone(), z.clone())


# -- group law ---------------------------------------------------------------


def point_add(p, q):
    """Unified complete addition (add-2008-hwcd-3, a = -1): 9 field muls."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = fe.fe_mul(fe.fe_sub(y1, x1), fe.fe_sub(y2, x2))
    b = fe.fe_mul(fe.fe_add(y1, x1), fe.fe_add(y2, x2))
    c = fe.fe_mul(fe.fe_mul(t1, _c(fe.TWO_D_INT, t1)), t2)
    zz = fe.fe_mul(z1, z2)
    d = fe.fe_add(zz, zz)
    e = fe.fe_sub(b, a)
    f = fe.fe_sub(d, c)
    g = fe.fe_add(d, c)
    h = fe.fe_add(b, a)
    return (fe.fe_mul(e, f), fe.fe_mul(g, h), fe.fe_mul(f, g), fe.fe_mul(e, h))


def point_double(p):
    """dbl-2008-hwcd for a = -1: 4 squarings + 4 muls."""
    x1, y1, z1, _ = p
    a = fe.fe_sq(x1)
    b = fe.fe_sq(y1)
    zz = fe.fe_sq(z1)
    c = fe.fe_add(zz, zz)
    e = fe.fe_sub(fe.fe_sub(fe.fe_sq(fe.fe_add(x1, y1)), a), b)
    g = fe.fe_sub(b, a)             # a*A + B with a = -1
    f = fe.fe_sub(g, c)
    h = fe.fe_neg(fe.fe_add(a, b))  # a*A - B
    return (fe.fe_mul(e, f), fe.fe_mul(g, h), fe.fe_mul(f, g), fe.fe_mul(e, h))


def point_neg(p):
    x, y, z, t = p
    return (fe.fe_neg(x), y, z, fe.fe_neg(t))


def point_is_identity(p):
    """bool[N]: P == (0:1:1:0), i.e. X == 0 and Y == Z (projectively)."""
    x, y, z, _ = p
    return fe.fe_is_zero(x) & fe.fe_is_zero(fe.fe_sub(y, z))


def point_compress(p):
    """Canonical 255-bit y limbs [17, N] and the x-parity sign bool[N]."""
    x, y, z, _ = p
    zinv = fe.fe_invert(z)
    xa = fe.fe_freeze(fe.fe_mul(x, zinv))
    ya = fe.fe_freeze(fe.fe_mul(y, zinv))
    return ya, (xa[0] & 1) == 1


def point_freeze(p):
    """Each coordinate as its canonical residue (the form two
    representations of the same point are compared in)."""
    return tuple(fe.fe_freeze(c) for c in p)


# -- decompression (ZIP-215) -------------------------------------------------


def decompress_plain(y_limbs: torch.Tensor, sign: torch.Tensor):
    """Batched ZIP-215 decoding: y may be non-canonical (>= p, reduced
    implicitly); x = 0 with sign 1 is rejected; the sqrt(-1) flip branch
    covers v*x^2 == -u. Returns (point, ok bool[N])."""
    y = y_limbs
    one = _c(1, y)
    y2 = fe.fe_sq(y)
    u = fe.fe_sub(y2, one.expand_as(y))
    v = fe.fe_add(fe.fe_mul(y2, _c(_D, y)), one.expand_as(y))
    v3 = fe.fe_mul(fe.fe_sq(v), v)
    v7 = fe.fe_mul(fe.fe_sq(v3), v)
    t = fe.fe_pow2523(fe.fe_mul(u, v7))
    x = fe.fe_mul(fe.fe_mul(u, v3), t)  # candidate root of u/v
    vxx = fe.fe_mul(v, fe.fe_sq(x))
    ok_direct = fe.fe_eq(vxx, u)
    ok_flip = fe.fe_is_zero(fe.fe_add(vxx, u))  # vxx == -u
    x = fe.fe_select(ok_flip & ~ok_direct, fe.fe_mul(x, _c(fe.SQRT_M1_INT, x)), x)
    ok = ok_direct | ok_flip
    ok = ok & ~(fe.fe_is_zero(x) & sign)
    x = fe.fe_select(fe.fe_parity(x) != sign, fe.fe_neg(x), x)
    return (x, y, one.expand_as(y).contiguous(), fe.fe_mul(x, y)), ok


def decompress_words_plain(a_words: torch.Tensor, r_words: torch.Tensor):
    """Plain version of ``decompress_words``."""
    y_a, sign_a = unpack.words_to_limbs255(a_words)
    y_r, sign_r = unpack.words_to_limbs255(r_words)
    pt, ok = decompress_plain(torch.cat([y_a, y_r], dim=1), torch.cat([sign_a, sign_r]))
    return torch.stack(pt), ok


def decompress_words(a_words: torch.Tensor, r_words: torch.Tensor):
    """ZIP-215 decoding of A and R from their raw encodings, int32[8, N]
    little-endian words each (y = bits 0..254, sign = bit 255) ->
    (int32[4, 17, 2N] X, Y, Z, T of A then R, lane-stacked, ok bool[2N]):
    the layout the ``ladder`` kernel reads.

    CPU tensors take ``decompress_words_plain``. CUDA tensors launch the
    ``decompress`` kernel, which returns canonical coordinates (equal to the
    plain version's as residues mod p)."""
    if a_words.device.type == "cpu":
        return decompress_words_plain(a_words, r_words)
    aw, rw = a_words.contiguous(), r_words.contiguous()
    _build.require_cuda("decompress", aw, rw)
    n = aw.shape[1]
    if aw.shape != (8, n) or rw.shape != (8, n):
        raise ValueError(f"decompress: bad shapes {aw.shape} {rw.shape}")
    out = torch.empty((4, fe.LIMBS, 2 * n), dtype=torch.int32, device=aw.device)
    ok = torch.empty((2 * n,), dtype=torch.bool, device=aw.device)
    if n:
        rc = _build.lib().cmtpu_decompress_words(
            aw.data_ptr(), rw.data_ptr(), out.data_ptr(), ok.data_ptr(), n,
            _build.stream_of(aw),
        )
        _build.check_launch("decompress", rc)
    return out, ok


# -- precomputed ("cached") point form ---------------------------------------
#
# Table entries are (Y-X, Y+X, 2d*T, Z) so the 2d scaling is paid once at
# table-build time; adding a cached point costs 8 field muls, or 7 against a
# Z == 1 table (add_precomp_z1: the constant B table qualifies).


def to_precomp(p):
    """(X:Y:Z:T) -> (Y-X, Y+X, 2d*T, Z)."""
    x, y, z, t = p
    return (fe.fe_sub(y, x), fe.fe_add(y, x), fe.fe_mul(t, _c(fe.TWO_D_INT, t)), z)


def precomp_identity(n: int, device):
    o = _full(1, n, device)
    return (o, o.clone(), _full(0, n, device), o.clone())


def precomp_select(mask, p, q):
    return tuple(fe.fe_select(mask, a, b) for a, b in zip(p, q))


def precomp_neg(q_pre):
    """-(Y-X, Y+X, 2dT, Z) = (Y+X, Y-X, -2dT, Z): a swap plus one negation."""
    ymx, ypx, td2, z = q_pre
    return (ypx, ymx, fe.fe_neg(td2), z)


def _add_precomp_core(p, q_pre, zz):
    x1, y1, _, t1 = p
    ymx, ypx, td2, _ = q_pre
    a = fe.fe_mul(fe.fe_sub(y1, x1), ymx)
    b = fe.fe_mul(fe.fe_add(y1, x1), ypx)
    c = fe.fe_mul(t1, td2)
    d = fe.fe_add(zz, zz)
    e = fe.fe_sub(b, a)
    f = fe.fe_sub(d, c)
    g = fe.fe_add(d, c)
    h = fe.fe_add(b, a)
    return (fe.fe_mul(e, f), fe.fe_mul(g, h), fe.fe_mul(f, g), fe.fe_mul(e, h))


def add_precomp(p, q_pre):
    """Complete addition against a precomputed point: 9 field muls."""
    return _add_precomp_core(p, q_pre, fe.fe_mul(p[2], q_pre[3]))


def add_precomp_z1(p, q_pre):
    """add_precomp for a precomputed point with Z == 1: zz = Z1."""
    return _add_precomp_core(p, q_pre, p[2])


def build_table_pre(p) -> torch.Tensor:
    """Per-lane window table [0..8]P in precomp form as one
    int32[9, 4, 17, N] tensor (axis 1 = ymx/ypx/2dT/Z), built by the
    reference's chain of additions."""
    n = p[0].shape[1]
    pp = to_precomp(p)
    rows = [torch.stack(precomp_identity(n, p[0].device)), torch.stack(pp)]
    cur = p
    for _ in range(2, 9):
        cur = add_precomp(cur, pp)
        rows.append(torch.stack(to_precomp(cur)))
    return torch.stack(rows)


def _add_int(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    num = _D * x1 * x2 % _P * y1 % _P * y2 % _P
    x3 = (x1 * y2 + x2 * y1) % _P * pow(1 + num, _P - 2, _P) % _P
    y3 = (y1 * y2 + x1 * x2) % _P * pow(1 - num + _P, _P - 2, _P) % _P
    return (x3, y3)


def table_b_ints() -> list:
    """[0..8]B in precomp form (ymx, ypx, 2dT, Z) as Python ints, from host
    integer math: the fixed-base table both the plain ladder and the kernel
    (in its own limb layout) read."""
    rows = [(1, 1, 0, 1)]
    cur = (_BX, _BY)
    for _ in range(8):
        x, y = cur
        rows.append(((y - x) % _P, (y + x) % _P, x * y % _P * fe.TWO_D_INT % _P, 1))
        cur = _add_int(cur, (_BX, _BY))
    return rows


def _host_table_b() -> np.ndarray:
    """Constant table [0..8]B as int32[9, 4, 17, 1] limbs."""
    return np.stack(
        [np.stack([fe.int_to_limbs(v) for v in row]) for row in table_b_ints()]
    )[:, :, :, None]


TABLE_B_PRE = _host_table_b()


@functools.lru_cache(maxsize=None)
def _table_b_cached(device: str) -> torch.Tensor:
    return torch.from_numpy(TABLE_B_PRE).to(device)


def table_b(device) -> torch.Tensor:
    """TABLE_B_PRE on ``device`` (cached)."""
    return _table_b_cached(str(torch.device(device)))


def select_precomp_signed(table: torch.Tensor, digits: torch.Tensor):
    """Per-lane signed table lookup: digits int32[N] in [-8, 8] ->
    table[|d|], negated when d < 0. The reference's binary-cascade selects
    over the stacked table. table: [9, 4, 17, N] or [9, 4, 17, 1]."""
    idx = digits.abs()

    def m(bit):
        return ((idx & bit) == bit)[None, None, None, :]

    u = table[:8]
    s = torch.where(m(1), u[1::2], u[0::2])       # [4, 4, 17, N]
    s = torch.where(m(2)[0], s[1::2], s[0::2])    # [2, 4, 17, N]
    s = torch.where(m(4)[0, 0], s[1], s[0])       # [4, 17, N]
    s = torch.where(m(8)[0, 0], table[8], s)      # |d| == 8
    pt = (s[0], s[1], s[2], s[3])
    return precomp_select(digits < 0, precomp_neg(pt), pt)


def windowed_double_base_mult(s_digits: torch.Tensor, k_digits: torch.Tensor, a_point):
    """[s]B + [k]A batched over lanes (plain version of the ladder kernel).
    s_digits/k_digits: int32[64, N] signed digits, row w of weight 16^w."""
    n = s_digits.shape[1]
    dev = s_digits.device
    table_a = build_table_pre(a_point)
    tb = table_b(dev)
    acc = identity(n, dev)
    for w in range(DIGITS):
        row = DIGITS - 1 - w
        for _ in range(WINDOW_BITS):
            acc = point_double(acc)
        acc = add_precomp(acc, select_precomp_signed(table_a, k_digits[row]))
        # every entry of the constant B table (identity and negated
        # selections included) has Z == 1
        acc = add_precomp_z1(acc, select_precomp_signed(tb, s_digits[row]))
    return acc


def scalars_to_digits(scalars: np.ndarray) -> np.ndarray:
    """uint8[N, 32] little-endian scalars (< 2^253) -> int32[64, N] signed
    radix-16 digits in [-8, 7] (host), by the add-8s identity: for
    t = s + 0x88..8, nibble_w(t) - 8 is a valid signed digit string."""
    n = scalars.shape[0]
    if n == 0:
        return np.zeros((DIGITS, 0), np.int32)
    words = np.ascontiguousarray(scalars, np.uint8).view("<u8").reshape(n, 4)
    eights = np.uint64(0x8888888888888888)
    t = np.zeros((n, 4), np.uint64)
    carry = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for w in range(4):
            tw = words[:, w] + eights
            wrapped = tw < words[:, w]
            tw2 = tw + carry
            wrapped |= (carry == 1) & (tw2 == 0)
            t[:, w] = tw2
            carry = wrapped.astype(np.uint64)
    tb = t.view(np.uint8).reshape(n, 32)
    nib = np.empty((n, DIGITS), np.int32)
    nib[:, 0::2] = tb & 15
    nib[:, 1::2] = tb >> 4
    return np.ascontiguousarray((nib - 8).T)
