"""Pure-Python BN254 (alt_bn128): the port's own copy of the host side of
aggregate BLS commits, and the oracles its device path is held against.

Counterpart of ``cometbft_tpu/crypto/bn254.py`` as plain functions: the
field towers (Fp2 = Fp[u]/(u^2 + 1), Fp12 = Fp2[w]/(w^6 - xi), xi = 9 + u),
affine G1 and G2 arithmetic, the twist Frobenius, gnark-style point
encodings, try-and-increment hash-to-G2 (SHA3-256, cofactor cleared) with
its cache, the batch weights of the bitmap check, the shared-squaring
multi-Miller loop and the fast final exponentiation. Keys are plain
scalars here (``public_key``, ``sign``): the reference's PubKey and
PrivKey classes belong to its crypto registry and do not come over.

A signature is [sk]H(m) on G2; verification is the pairing check
e(-pk, H(m)) * e(G1, sig) == 1, and an aggregate over n signers is one
(n + 1)-way product with one shared final exponentiation.
"""

from __future__ import annotations

import hashlib

SIGNATURE_SIZE = 128
SIGNATURE_SIZE_COMPRESSED = 64

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1 = (1, 2)
# Fp2 elements as (a0, a1) = a0 + a1*u
G2 = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# -- Fp2 ---------------------------------------------------------------------


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def f2_mul(x, y):
    a = x[0] * y[0] % P
    b = x[1] * y[1] % P
    c = (x[0] + x[1]) * (y[0] + y[1]) % P
    return ((a - b) % P, (c - a - b) % P)


def f2_sqr(x):
    return f2_mul(x, x)


def f2_inv(x):
    t = pow((x[0] * x[0] + x[1] * x[1]) % P, P - 2, P)
    return (x[0] * t % P, (-x[1] * t) % P)


def f2_scalar(x, k):
    return (x[0] * k % P, x[1] * k % P)


def _f2_conj(x):
    return (x[0], (-x[1]) % P)


def _f2_pow(x, e):
    r = F2_ONE
    while e > 0:
        if e & 1:
            r = f2_mul(r, x)
        x = f2_sqr(x)
        e >>= 1
    return r


F2_ONE = (1, 0)
F2_ZERO = (0, 0)

# G1: y^2 = x^3 + 3; the twist G2: y^2 = x^3 + 3 / xi
B = 3
XI = (9, 1)
B2 = f2_mul((B, 0), f2_inv(XI))

# -- curve arithmetic (affine) -----------------------------------------------


def _g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _g1_mul(k, p):
    r = None
    while k > 0:
        if k & 1:
            r = _g1_add(r, p)
        p = _g1_add(p, p)
        k >>= 1
    return r


def _g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def _g2_mul(k, p):
    r = None
    while k > 0:
        if k & 1:
            r = _g2_add(r, p)
        p = _g2_add(p, p)
        k >>= 1
    return r


def _g2_neg(p):
    if p is None:
        return None
    return (p[0], f2_neg(p[1]))


# -- Fp12: 6-tuples of Fp2 coefficients of 1, w, ..., w^5 ---------------------


def f12_mul(a, b):
    res = [F2_ZERO] * 12
    for i in range(6):
        if a[i] == F2_ZERO:
            continue
        for j in range(6):
            if b[j] == F2_ZERO:
                continue
            res[i + j] = f2_add(res[i + j], f2_mul(a[i], b[j]))
    out = list(res[:6])
    for k in range(6, 12):
        if res[k] != F2_ZERO:
            out[k - 6] = f2_add(out[k - 6], f2_mul(res[k], XI))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5


def f12_inv(a):
    """a^-1 by Gaussian elimination on the 12 x 12 matrix of x -> a*x over Fp."""
    cols = []
    for j in range(6):
        for im in range(2):
            basis = [F2_ZERO] * 6
            basis[j] = (0, 1) if im else (1, 0)
            cols.append([c for coeff in f12_mul(a, tuple(basis)) for c in coeff])
    n = 12
    m = [[cols[j][i] % P for j in range(n)] for i in range(n)]
    rhs = [1] + [0] * (n - 1)
    for col in range(n):
        piv = next(r for r in range(col, n) if m[r][col] != 0)
        m[col], m[piv] = m[piv], m[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = pow(m[col][col], P - 2, P)
        m[col] = [x * inv % P for x in m[col]]
        rhs[col] = rhs[col] * inv % P
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [(m[r][c] - f * m[col][c]) % P for c in range(n)]
                rhs[r] = (rhs[r] - f * rhs[col]) % P
    return tuple((rhs[2 * j], rhs[2 * j + 1]) for j in range(6))


def f12_pow(a, e):
    r = F12_ONE
    while e > 0:
        if e & 1:
            r = f12_mul(r, a)
        a = f12_mul(a, a)
        e >>= 1
    return r


# -- Miller loop ---------------------------------------------------------------


def _line(q1, q2, p_pt):
    """The line through q1 and q2 (the tangent when equal) at G1 point p,
    under the untwist (x, y) -> (x / w^2, y / w^3), scaled by its slope's
    denominator (an Fp2 factor the final exponentiation kills)."""
    xp, yp = p_pt
    x1, y1 = q1
    x2, y2 = q2
    if x1 == x2 and y1 == y2:
        lam_num = f2_scalar(f2_sqr(x1), 3)
        lam_den = f2_scalar(y1, 2)
    elif x1 == x2:
        coeffs = [F2_ZERO] * 6
        coeffs[0] = (xp % P, 0)
        coeffs[2] = f2_neg(x1)
        return tuple(coeffs)
    else:
        lam_num = f2_sub(y2, y1)
        lam_den = f2_sub(x2, x1)
    coeffs = [F2_ZERO] * 6
    coeffs[0] = f2_scalar(lam_den, yp)
    coeffs[1] = f2_neg(f2_scalar(lam_num, xp))
    coeffs[3] = f2_sub(f2_mul(lam_num, x1), f2_mul(y1, lam_den))
    return tuple(coeffs)


# BN parameter t; the optimal-ate loop runs over 6t + 2 (65 bits, MSB skipped)
_T = 4965661367192848881
_ATE_LOOP = 6 * _T + 2

_GAMMA12 = _f2_pow(XI, (P - 1) // 3)
_GAMMA13 = _f2_pow(XI, (P - 1) // 2)


def _g2_frobenius(q):
    """(x, y) -> (conj(x) * xi^((p-1)/3), conj(y) * xi^((p-1)/2)) on the twist."""
    if q is None:
        return None
    x, y = q
    return (f2_mul(_f2_conj(x), _GAMMA12), f2_mul(_f2_conj(y), _GAMMA13))


def multi_miller_loop(pairs):
    """prod_i f_{6t+2,Q_i}(P_i) with the two Frobenius lines, one shared
    Fp12 squaring an iteration; pairs with a point at infinity drop out."""
    live = [(p_pt, q) for p_pt, q in pairs if p_pt is not None and q is not None]
    if not live:
        return F12_ONE
    f = F12_ONE
    ts = [q for _, q in live]
    for bit in bin(_ATE_LOOP)[3:]:
        f = f12_sqr(f)
        for i, (p_pt, q) in enumerate(live):
            f = f12_mul(f, _line(ts[i], ts[i], p_pt))
            ts[i] = _g2_add(ts[i], ts[i])
            if bit == "1":
                f = f12_mul(f, _line(ts[i], q, p_pt))
                ts[i] = _g2_add(ts[i], q)
    for i, (p_pt, q) in enumerate(live):
        q1 = _g2_frobenius(q)
        q2 = _g2_neg(_g2_frobenius(q1))
        f = f12_mul(f, _line(ts[i], q1, p_pt))
        ts[i] = _g2_add(ts[i], q1)
        f = f12_mul(f, _line(ts[i], q2, p_pt))
    return f


# -- final exponentiation ------------------------------------------------------


def _f12_conj6(a):
    """a^(p^6): negates the odd-power-of-w coefficients (the inverse inside
    the cyclotomic subgroup)."""
    return tuple(c if i % 2 == 0 else f2_neg(c) for i, c in enumerate(a))


# gamma[k][i] = xi^(i (p^k - 1) / 6): the basis twists of a -> a^(p^k)
_F12_GAMMA = {
    k: tuple(_f2_pow(XI, i * (P**k - 1) // 6) for i in range(6)) for k in (1, 2, 3)
}


def _f12_frobenius(a, k):
    g = _F12_GAMMA[k]
    if k % 2:
        return tuple(f2_mul(_f2_conj(c), g[i]) for i, c in enumerate(a))
    return tuple(f2_mul(c, g[i]) for i, c in enumerate(a))


def final_exponentiation_fast(f):
    """f^((p^12 - 1) / r): the easy part (p^6 - 1)(p^2 + 1) by conjugation,
    one inversion and a Frobenius; the hard part by the Scott et al.
    addition chain in t."""
    t = f12_mul(_f12_conj6(f), f12_inv(f))
    m = f12_mul(_f12_frobenius(t, 2), t)
    fu = f12_pow(m, _T)
    fu2 = f12_pow(fu, _T)
    fu3 = f12_pow(fu2, _T)
    y0 = f12_mul(f12_mul(_f12_frobenius(m, 1), _f12_frobenius(m, 2)), _f12_frobenius(m, 3))
    y1 = _f12_conj6(m)
    y2 = _f12_frobenius(fu2, 2)
    y3 = _f12_conj6(_f12_frobenius(fu, 1))
    y4 = _f12_conj6(f12_mul(fu, _f12_frobenius(fu2, 1)))
    y5 = _f12_conj6(fu2)
    y6 = _f12_conj6(f12_mul(fu3, _f12_frobenius(fu3, 1)))
    t0 = f12_mul(f12_mul(f12_sqr(y6), y4), y5)
    t1 = f12_mul(f12_mul(y3, y5), t0)
    t0 = f12_mul(t0, y2)
    t1 = f12_mul(f12_sqr(t1), t0)
    t1 = f12_sqr(t1)
    t0 = f12_mul(t1, y1)
    t1 = f12_mul(t1, y0)
    return f12_mul(f12_sqr(t0), t1)


def pairing_check_fast(pairs) -> bool:
    """prod e(P_i, Q_i) == 1."""
    return final_exponentiation_fast(multi_miller_loop(pairs)) == F12_ONE


# -- hash to G2 ----------------------------------------------------------------

_G2_COFACTOR = 2 * P - R


def _f2_sqrt(a):
    """A square root in Fp2 (p = 3 mod 4), or None for a non-residue."""
    if a == F2_ZERO:
        return F2_ZERO
    a0, a1 = a
    if a1 == 0:
        r = pow(a0, (P + 1) // 4, P)
        if r * r % P == a0:
            return (r, 0)
        r = pow((-a0) % P, (P + 1) // 4, P)
        if r * r % P == (-a0) % P:
            return (0, r)
        return None
    norm = (a0 * a0 + a1 * a1) % P
    n = pow(norm, (P + 1) // 4, P)
    if n * n % P != norm:
        return None
    for sign in (1, -1):
        alpha = (a0 + sign * n) % P * pow(2, P - 2, P) % P
        x0 = pow(alpha, (P + 1) // 4, P)
        if x0 * x0 % P != alpha:
            continue
        x1 = a1 * pow(2 * x0 % P, P - 2, P) % P
        cand = (x0, x1)
        if f2_sqr(cand) == a:
            return cand
    return None


def _hash_to_g2(msg: bytes):
    """Try-and-increment over SHA3-256 to an x on the twist, the smaller y
    root, then the cofactor 2p - r cleared: a point of unknown discrete log."""
    base = hashlib.sha3_256(msg).digest()
    ctr = 0
    while True:
        h0 = hashlib.sha3_256(base + b"\x00" + ctr.to_bytes(4, "big")).digest()
        h1 = hashlib.sha3_256(base + b"\x01" + ctr.to_bytes(4, "big")).digest()
        x = (int.from_bytes(h0, "big") % P, int.from_bytes(h1, "big") % P)
        y = _f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), B2))
        if y is not None:
            if (y[1], y[0]) > ((P - y[1]) % P, (P - y[0]) % P):
                y = f2_neg(y)
            q = _g2_mul(_G2_COFACTOR, (x, y))
            if q is not None:
                return q
        ctr += 1


_HM_CACHE: dict[bytes, tuple] = {}
_HM_CACHE_MAX = 8192


def _hash_to_g2_cached(msg: bytes):
    key = bytes(msg)
    hit = _HM_CACHE.get(key)
    if hit is not None:
        return hit
    q = _hash_to_g2(key)
    if len(_HM_CACHE) >= _HM_CACHE_MAX:
        for k in list(_HM_CACHE)[: _HM_CACHE_MAX // 4]:
            _HM_CACHE.pop(k, None)
    _HM_CACHE[key] = q
    return q


# -- encodings -----------------------------------------------------------------

_MASK = 0b11 << 6
_COMPRESSED_SMALLEST = 0b10 << 6
_COMPRESSED_LARGEST = 0b11 << 6
_COMPRESSED_INFINITY = 0b01 << 6


def g1_compress(p) -> bytes:
    """32 bytes: big-endian x, the top two bits flag infinity or which y."""
    if p is None:
        out = bytearray(32)
        out[0] = _COMPRESSED_INFINITY
        return bytes(out)
    x, y = p
    out = bytearray(x.to_bytes(32, "big"))
    out[0] |= _COMPRESSED_LARGEST if y > (P - y) % P else _COMPRESSED_SMALLEST
    return bytes(out)


def g1_decompress(b: bytes):
    """The G1 point of a 32-byte encoding (None for infinity); raises
    ValueError on a bad length, x >= p or an x off the curve."""
    if len(b) != 32:
        raise ValueError("bad G1 compressed length")
    flag = b[0] & _MASK
    if flag == _COMPRESSED_INFINITY:
        return None
    x = int.from_bytes(bytes([b[0] & ~_MASK]) + b[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("not on curve")
    if flag == _COMPRESSED_LARGEST:
        if y < (P - y) % P:
            y = (P - y) % P
    elif y > (P - y) % P:
        y = (P - y) % P
    return (x, y)


def g2_marshal(q) -> bytes:
    """128 bytes: x.a1 || x.a0 || y.a1 || y.a0, big-endian (gnark order)."""
    if q is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = q
    return b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))


def g2_compress(q) -> bytes:
    """64 bytes: x.a1 || x.a0 with the flag of the lexicographically
    larger y = (y1, y0) in the top bits."""
    if q is None:
        out = bytearray(64)
        out[0] = _COMPRESSED_INFINITY
        return bytes(out)
    (x0, x1), (y0, y1) = q
    out = bytearray(x1.to_bytes(32, "big") + x0.to_bytes(32, "big"))
    neg = ((P - y1) % P, (P - y0) % P)
    out[0] |= _COMPRESSED_LARGEST if (y1, y0) > neg else _COMPRESSED_SMALLEST
    return bytes(out)


def _check_subgroup(q) -> None:
    if _g2_mul(R, q) is not None:
        raise ValueError("G2 point not in r-torsion subgroup")


def g2_decompress(b: bytes):
    if len(b) != 64:
        raise ValueError("bad G2 compressed length")
    flag = b[0] & _MASK
    if flag == _COMPRESSED_INFINITY:
        if (b[0] & ~_MASK) or any(b[1:]):
            raise ValueError("bad G2 infinity encoding")
        return None
    if flag not in (_COMPRESSED_SMALLEST, _COMPRESSED_LARGEST):
        raise ValueError("bad G2 compression flag")
    x1 = int.from_bytes(bytes([b[0] & ~_MASK]) + b[1:32], "big")
    x0 = int.from_bytes(b[32:64], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 coordinate out of range")
    x = (x0, x1)
    y = _f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    larger = (y[1], y[0]) > ((P - y[1]) % P, (P - y[0]) % P)
    if (flag == _COMPRESSED_LARGEST) != larger:
        y = f2_neg(y)
    q = (x, y)
    _check_subgroup(q)
    return q


def g2_unmarshal(b: bytes):
    """The G2 point of a 64- or 128-byte encoding (None for infinity);
    raises ValueError unless it is on the twist and in the r-torsion."""
    if len(b) == SIGNATURE_SIZE_COMPRESSED:
        return g2_decompress(b)
    if len(b) != SIGNATURE_SIZE:
        raise ValueError("bad G2 length")
    if b == b"\x00" * SIGNATURE_SIZE:
        return None
    x1, x0, y1, y0 = (int.from_bytes(b[i : i + 32], "big") for i in range(0, 128, 32))
    if any(v >= P for v in (x0, x1, y0, y1)):
        raise ValueError("G2 coordinate out of range")
    q = ((x0, x1), (y0, y1))
    if f2_sqr(q[1]) != f2_add(f2_mul(f2_sqr(q[0]), q[0]), B2):
        raise ValueError("G2 point not on curve")
    _check_subgroup(q)
    return q


# -- keys, signatures, batch weights ---------------------------------------------


def public_key(sk: int) -> bytes:
    """The compressed G1 public key of secret scalar sk (0 < sk < r)."""
    return g1_compress(_g1_mul(sk % R, G1))


def sign(sk: int, msg: bytes) -> bytes:
    """[sk]H(msg) on G2, uncompressed (128 bytes)."""
    return g2_marshal(_g2_mul(sk % R, _hash_to_g2_cached(msg)))


def _batch_weights(pubs, msgs, sigs):
    """One odd 64-bit weight a signature, Fiat-Shamir from the whole batch,
    so that two bad signatures cannot cancel in the product."""
    h = hashlib.sha256()
    for col in (pubs, msgs, sigs):
        for x in col:
            h.update(len(x).to_bytes(4, "big"))
            h.update(x)
    seed = h.digest()
    return [
        int.from_bytes(hashlib.sha256(seed + i.to_bytes(4, "big")).digest()[:8], "big") | 1
        for i in range(len(pubs))
    ]
