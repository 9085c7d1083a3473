"""Pure-Python edwards25519 with ZIP-215 verification semantics: the
port's own copy of the oracle (signing, key derivation and single
verification), used by chip_smoke.py for fixtures and by the tests.

Semantics: A and R encodings may be non-canonical (y >= p accepted); x = 0
with sign bit 1 fails decoding; s must be canonical (s < L); verification
uses the cofactored equation [8][s]B = [8]R + [8][k]A.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
IDENTITY = (0, 1, 1, 0)

# Base point
_BY = (4 * pow(5, P - 2, P)) % P
_BX = None  # set below


def _recover_x(y: int, sign: int) -> int | None:
    """x from y via sqrt((y^2-1)/(d y^2+1)); None if no root or x=0 with sign=1."""
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    # candidate root of u/v: x = u v^3 (u v^7)^((p-5)/8)
    x = (u * pow(v, 3, P)) % P * pow((u * pow(v, 7, P)) % P, (P - 5) // 8, P) % P
    vxx = v * x % P * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)


def point_add(p1, p2):
    """add-2008-hwcd-3 for a=-1 twisted Edwards (unified, complete)."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * D * T1 % P * T2 % P
    Dd = 2 * Z1 * Z2 % P
    E = B - A
    F = Dd - C
    G = Dd + C
    H = B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p):
    return point_add(p, p)


# [j * 16^i]B for i < 64, 0 < j < 16, affine, as (y + x, y - x, 2d x y):
# a fixed-base product is then 64 of these additions, with no doubling.
# Built at the first use.
_BASE_TABLE: list | None = None


def _base_table() -> list:
    global _BASE_TABLE
    if _BASE_TABLE is None:
        points, p = [], BASE
        for _ in range(64):
            q = p
            for _ in range(15):
                points.append(q)
                q = point_add(q, p)
            p = q  # 16 p
        # One inversion for every Z (Montgomery's trick).
        prefix, acc = [], 1
        for q in points:
            prefix.append(acc)
            acc = acc * q[2] % P
        inv = pow(acc, P - 2, P)
        affine = [None] * len(points)
        for n in range(len(points) - 1, -1, -1):
            X, Y, Z, _T = points[n]
            zi = inv * prefix[n] % P
            inv = inv * Z % P
            x, y = X * zi % P, Y * zi % P
            affine[n] = ((y + x) % P, (y - x) % P, 2 * D * x % P * y % P)
        _BASE_TABLE = [[None] + affine[15 * i:15 * i + 15] for i in range(64)]
    return _BASE_TABLE


def base_mult(k: int):
    """[k]B for 0 <= k < 2^256, from the fixed-base table (equal to
    ``scalar_mult(k, BASE)``; variable time, as the rest of this module)."""
    table = _base_table()
    X1, Y1, Z1, T1 = IDENTITY
    for i in range(64):
        j = (k >> (4 * i)) & 15
        if j:
            yp, ym, t2d = table[i][j]
            A = (Y1 - X1) * ym % P
            B = (Y1 + X1) * yp % P
            C = T1 * t2d % P
            Dd = 2 * Z1
            E, F, G, H = B - A, Dd - C, Dd + C, B + A
            X1, Y1, Z1, T1 = E * F % P, G * H % P, F * G % P, E * H % P
    return (X1, Y1, Z1, T1)


def point_neg(p):
    X, Y, Z, T = p
    return ((P - X) % P, Y, Z, (P - T) % P)


def scalar_mult(k: int, p):
    """Double-and-add; variable time (verification only, not secret-dependent)."""
    q = IDENTITY
    while k > 0:
        if k & 1:
            q = point_add(q, p)
        p = point_double(p)
        k >>= 1
    return q


def point_equal(p1, p2) -> bool:
    X1, Y1, Z1, _ = p1
    X2, Y2, Z2, _ = p2
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def point_compress(p) -> bytes:
    X, Y, Z, _ = p
    zinv = pow(Z, P - 2, P)
    x = X * zinv % P
    y = Y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress_zip215(s: bytes):
    """Decompress allowing non-canonical y (ZIP-215 rule 1); None on failure."""
    if len(s) != 32:
        return None
    enc = int.from_bytes(s, "little")
    sign = enc >> 255
    y = (enc & ((1 << 255) - 1)) % P  # non-canonical y >= p is reduced, not rejected
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def point_decompress_canonical(s: bytes):
    """Strict RFC 8032 decoding: y must be canonical (< p)."""
    if len(s) != 32:
        return None
    enc = int.from_bytes(s, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    if y >= P:
        return None
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def sha512_mod_l(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little") % L


def secret_expand(seed: bytes) -> tuple[int, bytes]:
    """RFC 8032 §5.1.5: clamped scalar + hash prefix from a 32-byte seed."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return point_compress(base_mult(a))


def sign(seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6."""
    a, prefix = secret_expand(seed)
    r = sha512_mod_l(prefix, msg)
    R = base_mult(r)
    Rs = point_compress(R)
    k = sha512_mod_l(Rs, pub, msg)
    s = (r + k * a) % L
    return Rs + int.to_bytes(s, 32, "little")


def verify_zip215(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Single-signature ZIP-215 verification (the acceptance set the batch
    kernels and the reference verifier share)."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    A = point_decompress_zip215(pub)
    if A is None:
        return False
    Rs = sig[:32]
    R = point_decompress_zip215(Rs)
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = sha512_mod_l(Rs, pub, msg)
    # [8][s]B == [8]R + [8][k]A  ⇔  [8]([s]B - [k]A - R) == identity
    sB = base_mult(s)
    kA = scalar_mult(k, A)
    diff = point_add(point_add(sB, point_neg(kA)), point_neg(R))
    eight_diff = point_double(point_double(point_double(diff)))
    return point_equal(eight_diff, IDENTITY)
