"""Device multi-pairing for BN254 aggregate BLS commits.

Counterpart of ``cometbft_tpu/ops/bn254_kernel.py``. The Miller loop is the
batchable part of a pairing: every (G1, G2) lane of a commit walks the same
constant optimal-ate ladder (6t + 2, 64 bits below its top one), so all
lanes run in lockstep. Per-lane Miller values f_{6t+2,Q}(P), with the two
Frobenius lines, come back to the host, which multiplies the real lanes
(padding is skipped), runs one shared final exponentiation and compares
against F12_ONE. On a host with several cards a chunk's lanes split over
them (a 1-D ``lane`` mesh, one launch a card, counted as
``sharded_dispatches``) once its bucket, rounded to the width, is at or
above the mesh floor, as the reference's routing does.

On a CUDA tensor the loop is one launch of the hand-written ``bn254``
kernel (``csrc/bn254.cu``: eight 32-bit words in Montgomery form, a lane
over a team of threads that walks the schedule ``ops/bn254_schedule.py``
generates, the lane's state in shared memory, canonical residues out as 13
limbs of 21 bits). On a CPU
tensor it is ``miller_values_plain``: the reference's float64 program in
PyTorch, with the same 13 x 21-bit limbs, carry rounds, fold tables
(``_M_ROWS``, ``_C26``, ``_K13``) and one-hot scatter matrices. Every
intermediate is an exact integer below 2^53, so the plain version is
limb-identical to the JAX program on the same operands. The kernel's limbs
differ (canonical against loose); its values are equal mod P.

G2 runs Jacobian (no inversions); the line coefficients are the sparse
(c0, c1 w, c3 w^3) untwist form scaled by Z^6 (doubling) or Z^3
(addition). Those Fp2 factors die in the final exponentiation. Points are
packed on the host (``_pack``), pi(Q) and -pi^2(Q) included.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch

from cometbft_tpu_torch.crypto import bn254_pure as _b
from cometbft_tpu_torch.crypto import merkle as _merkle
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_kernel as _ek

BASE = 1 << 21
NLIMB = 13
NCOL = 2 * NLIMB
P = _b.P

# Ate-loop bits, MSB skipped: the constant ladder every lane walks.
_BITS = [1 if c == "1" else 0 for c in bin(_b._ATE_LOOP)[3:]]

_LADDER = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]
MAX_LANES = _LADDER[-1]

_counters = {"dispatches": 0, "lanes": 0, "sharded_dispatches": 0}
_counters_lock = threading.Lock()


def to_limbs(x: int) -> list:
    """254-bit int -> 13 limbs of 21 bits (little-endian)."""
    out = []
    for _ in range(NLIMB):
        out.append(float(x & (BASE - 1)))
        x >>= 21
    return out


def from_limbs(limbs) -> int:
    """Loose (possibly negative) limbs -> exact int mod P."""
    acc = 0
    for i, v in enumerate(limbs):
        acc += int(round(float(v))) << (21 * i)
    return acc % P


_LIMB_WEIGHTS = np.array([1 << (21 * i) for i in range(NLIMB)], dtype=object)


def limbs_to_ints(arr) -> np.ndarray:
    """Loose limbs (..., 13) -> an object array (...) of ints mod P."""
    a = np.asarray(arr, dtype=np.float64)
    return (np.rint(a).astype(np.int64).astype(object) * _LIMB_WEIGHTS).sum(axis=-1) % P


# Fold tables (plain python; tensor copies per device in _tables()).
_M_ROWS = [to_limbs(pow(2, 21 * (NLIMB + k), P)) for k in range(NLIMB)]
_C26 = to_limbs(pow(2, 21 * NCOL, P))
_K13 = to_limbs(pow(2, 21 * NLIMB, P))


def mesh_width(device=None) -> int:
    """Devices one dispatch spreads over: ``ed25519_kernel.mesh_width``
    (this process's CUDA devices; 1 for the CPU)."""
    return _ek.mesh_width(device)


def _mesh_floor(width: int | None = None) -> int:
    return _ek.mesh_floor(width)


def bucket_for(n: int, width: int | None = None) -> int:
    """The lane ladder, rounded up to a multiple of the mesh width
    (``width``, or ``mesh_width()`` when None) at or above the mesh floor:
    the shape of ``ed25519_kernel.bucket_for``."""
    n = max(1, int(n))
    b = next((x for x in _LADDER if x >= n), MAX_LANES)
    w = mesh_width() if width is None else width
    if w > 1 and b >= _mesh_floor(w):
        b = ((b + w - 1) // w) * w
    return b


def counters() -> dict:
    with _counters_lock:
        return dict(_counters)


class _Tables:
    pass


@lru_cache(maxsize=4)
def _tables(device: str) -> _Tables:
    t = _Tables()
    f64 = np.float64
    e0 = np.zeros((NLIMB, NLIMB, NCOL), dtype=f64)
    e1 = np.zeros((NLIMB, NLIMB, NCOL), dtype=f64)
    for i in range(NLIMB):
        for j in range(NLIMB):
            e0[i, j, i + j] = 1.0
            e1[i, j, i + j + 1] = 1.0

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    t.e0, t.e1 = dev(e0), dev(e1)
    t.m = dev(np.array(_M_ROWS, dtype=f64))
    t.c26 = dev(np.array(_C26, dtype=f64))
    t.k13 = dev(np.array(_K13, dtype=f64))
    # f12 squaring: 21 symmetric (i, j) products, cross terms weight 2
    pairs21 = [(i, j) for i in range(6) for j in range(i, 6)]
    s21 = np.zeros((len(pairs21), 12), dtype=f64)
    for k, (i, j) in enumerate(pairs21):
        s21[k, i + j] = 2.0 if i != j else 1.0
    t.i21 = dev([i for i, _ in pairs21], torch.int64)
    t.j21 = dev([j for _, j in pairs21], torch.int64)
    t.s21 = dev(s21)
    # sparse line mul: f[i] * c_j for the line's w^0, w^1, w^3 slots
    slots = (0, 1, 3)
    trip18 = [(i, jj) for i in range(6) for jj in range(3)]
    s18 = np.zeros((len(trip18), 12), dtype=f64)
    for k, (i, jj) in enumerate(trip18):
        s18[k, i + slots[jj]] = 1.0
    t.i18 = dev([i for i, _ in trip18], torch.int64)
    t.jsel18 = dev([jj for _, jj in trip18], torch.int64)
    t.s18 = dev(s18)
    return t


# -- Fp: 13 x 21-bit float64 limbs ---------------------------------------------


def _carry_round(x, t, fold=None):
    """One parallel carry round: every limb drops its multiple of BASE into
    its neighbour (floor carries handle negatives; exact for |value| <
    2^52). With ``fold`` the top carry re-enters at 2^273 mod P; without,
    it is returned for the caller to fold."""
    c = torch.floor(x * (1.0 / BASE))
    low = x - c * BASE
    y = low + torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)
    if fold is not None:
        return y + c[..., -1:] * fold
    return y, c[..., -1]


def _fp_condense(x, t):
    """|limb| < 2^46 -> |limb| < 2^23 by four carry+fold rounds."""
    for _ in range(4):
        x = _carry_round(x, t, fold=t.k13)
    return x


def _fp_mul(a, b, t):
    """Exact modular multiply, |input limb| < 2^26 -> |output limb| < 2^23:
    outer product, hi/lo split, one-hot scatter to 26 columns, one carry
    round, the high half folded against 2^(21k) mod P, condensed."""
    prod = a[..., :, None] * b[..., None, :]
    hi = torch.floor(prod * (1.0 / BASE))
    lo = prod - hi * BASE
    cols = torch.einsum("...ij,ijk->...k", lo, t.e0) + torch.einsum("...ij,ijk->...k", hi, t.e1)
    limbs, top = _carry_round(cols, t)
    low, high = limbs[..., :NLIMB], limbs[..., NLIMB:]
    red = high @ t.m + top[..., None] * t.c26
    return _fp_condense(low + red, t)


# -- Fp2: (n, 2, 13), u^2 = -1; each stage's products in one _fp_mul -----------


def _f2_mul_many(xs, ys, t):
    """Karatsuba Fp2 multiply for k independent pairs in one _fp_mul call."""
    k = len(xs)
    X = torch.stack(xs, dim=1)
    Y = torch.stack(ys, dim=1)
    L = torch.cat([X[:, :, 0], X[:, :, 1], X[:, :, 0] + X[:, :, 1]], dim=1)
    R = torch.cat([Y[:, :, 0], Y[:, :, 1], Y[:, :, 0] + Y[:, :, 1]], dim=1)
    prod = _fp_mul(L, R, t)
    a, b, c = prod[:, :k], prod[:, k : 2 * k], prod[:, 2 * k :]
    out = torch.stack([a - b, c - a - b], dim=2)
    return [out[:, i] for i in range(k)]


def _f2_cond_many(xs, t):
    v = _fp_condense(torch.stack(xs, dim=1), t)
    return [v[:, i] for i in range(len(xs))]


# -- Fp12 = Fp2[w]/(w^6 - xi): (n, 6, 2, 13) -------------------------------------


def _fold_cond(re, im, t):
    """Residues 6..11 back through w^6 = xi = 9 + u, then condensed."""
    r6 = re[:, :6] + 9 * re[:, 6:] - im[:, 6:]
    i6 = im[:, :6] + re[:, 6:] + 9 * im[:, 6:]
    return _fp_condense(torch.stack([r6, i6], dim=2), t)


def _f12_sqr(F, t):
    """Schoolbook squaring with symmetry: 21 Fp2 products in one mul."""
    aL, aR = F[:, t.i21], F[:, t.j21]
    L = torch.cat([aL[:, :, 0], aL[:, :, 1], aL[:, :, 0] + aL[:, :, 1]], dim=1)
    R = torch.cat([aR[:, :, 0], aR[:, :, 1], aR[:, :, 0] + aR[:, :, 1]], dim=1)
    prod = _fp_mul(L, R, t)
    a, b, c = prod[:, :21], prod[:, 21:42], prod[:, 42:]
    re = torch.einsum("nkl,km->nml", a - b, t.s21)
    im = torch.einsum("nkl,km->nml", c - a - b, t.s21)
    return _fold_cond(re, im, t)


def _f12_sparse(F, line, t):
    """F times a line sparse at w^0, w^1, w^3: 18 Fp2 products in one mul."""
    C = torch.stack(line, dim=1)
    aL, aR = F[:, t.i18], C[:, t.jsel18]
    L = torch.cat([aL[:, :, 0], aL[:, :, 1], aL[:, :, 0] + aL[:, :, 1]], dim=1)
    R = torch.cat([aR[:, :, 0], aR[:, :, 1], aR[:, :, 0] + aR[:, :, 1]], dim=1)
    prod = _fp_mul(L, R, t)
    a, b, c = prod[:, :18], prod[:, 18:36], prod[:, 36:]
    re = torch.einsum("nkl,km->nml", a - b, t.s18)
    im = torch.einsum("nkl,km->nml", c - a - b, t.s18)
    return _fold_cond(re, im, t)


# -- G2 Jacobian steps with scaled sparse lines ----------------------------------


def _dbl_and_line(X, Y, Z, xp2, yp2, t):
    """Double T = (X, Y, Z) and the tangent at (xp, yp), scaled by Z^6:
    c0 = 2 Y Z^3 yp, c1 = -3 X^2 Z^2 xp, c3 = 3 X^3 - 2 Y^2."""
    A, Bv, Z2 = _f2_mul_many([X, Y, Z], [X, Y, Z], t)
    Cv, XB, Z3p, YZ = _f2_mul_many([Bv, X + Bv, Z2, Y], [Bv, X + Bv, Z, Z], t)
    D, E = _f2_cond_many([2 * (XB - A - Cv), 3 * A], t)
    F2, EZ2, AX, YZ3 = _f2_mul_many([E, E, A, Y], [E, Z2, X, Z3p], t)
    X3, c3, Z3 = _f2_cond_many([F2 - 2 * D, 3 * AX - 2 * Bv, 2 * YZ], t)
    EDX, c0h, c1h = _f2_mul_many([E, YZ3, EZ2], [D - X3, yp2, xp2], t)
    Y3 = _f2_cond_many([EDX - 8 * Cv], t)[0]
    return X3, Y3, Z3, (2 * c0h, -c1h, c3)


def _add_and_line(X, Y, Z, xq, yq, xp2, yp2, t):
    """Mixed add T + Q (Q affine) and the chord through Q, scaled by Z^3:
    c0 = H Z yp, c1 = -r xp, c3 = r xq - yq H Z."""
    Z2 = _f2_mul_many([Z], [Z], t)[0]
    Z3p, U2 = _f2_mul_many([Z2, xq], [Z, Z2], t)
    S2 = _f2_mul_many([yq], [Z3p], t)[0]
    H, r = _f2_cond_many([U2 - X, S2 - Y], t)
    H2, rsq, ZH = _f2_mul_many([H, r, Z], [H, r, H], t)
    H3, V, rxq, yqZH, c0, c1h = _f2_mul_many([H2, X, r, yq, ZH, r], [H, H2, xq, ZH, yp2, xp2], t)
    X3, Z3 = _f2_cond_many([rsq - H3 - 2 * V, ZH], t)
    rVX3, YH3 = _f2_mul_many([r, Y], [V - X3, H3], t)
    Y3 = _f2_cond_many([rVX3 - YH3], t)[0]
    return X3, Y3, Z3, (c0, -c1h, rxq - yqZH)


def miller_values_plain(p1, q, q1, q2) -> torch.Tensor:
    """The plain version: per-lane Miller values as float64 loose limbs
    (n, 6, 2, 13), limb-identical to the reference's program. p1 (n, 2, 13)
    is P = (xp, yp); q, q1, q2 (n, 2, 2, 13) are Q, pi(Q), -pi^2(Q). The
    reference's scan computes the addition at every bit and selects it;
    here the bit (a constant) decides, which gives the same values."""
    t = _tables(str(p1.device))
    n = p1.shape[0]
    zero = torch.zeros((n, NLIMB), dtype=p1.dtype, device=p1.device)
    xp2 = torch.stack([p1[:, 0], zero], dim=1)
    yp2 = torch.stack([p1[:, 1], zero], dim=1)
    xq, yq = q[:, 0], q[:, 1]
    F = torch.zeros((n, 6, 2, NLIMB), dtype=p1.dtype, device=p1.device)
    F[:, 0, 0, 0] = 1.0
    X, Y = xq, yq
    Z = torch.zeros((n, 2, NLIMB), dtype=p1.dtype, device=p1.device)
    Z[:, 0, 0] = 1.0
    for bit in _BITS:
        F = _f12_sqr(F, t)
        X, Y, Z, line = _dbl_and_line(X, Y, Z, xp2, yp2, t)
        F = _f12_sparse(F, line, t)
        if bit:
            X, Y, Z, line = _add_and_line(X, Y, Z, xq, yq, xp2, yp2, t)
            F = _f12_sparse(F, line, t)
    X, Y, Z, line = _add_and_line(X, Y, Z, q1[:, 0], q1[:, 1], xp2, yp2, t)
    F = _f12_sparse(F, line, t)
    _, _, _, line = _add_and_line(X, Y, Z, q2[:, 0], q2[:, 1], xp2, yp2, t)
    return _f12_sparse(F, line, t)


def miller_values(p1, q, q1, q2) -> torch.Tensor:
    """Per-lane Miller values (n, 6, 2, 13) float64 for the packed operands
    (``_pack``: canonical limbs, values below 2^256). CPU tensors take the
    plain version (loose limbs); CUDA tensors launch the ``bn254`` kernel
    once (canonical limbs, equal to the plain version's mod P)."""
    if p1.device.type == "cpu":
        return miller_values_plain(p1, q, q1, q2)
    _build.require_cuda("bn254", p1, q, q1, q2, dtype=torch.float64)
    n = p1.shape[0]
    if p1.shape != (n, 2, NLIMB) or any(x.shape != (n, 2, 2, NLIMB) for x in (q, q1, q2)):
        raise ValueError(f"bn254: bad shapes {p1.shape} {q.shape} {q1.shape} {q2.shape}")
    out = torch.empty((n, 6, 2, NLIMB), dtype=torch.float64, device=p1.device)
    if n:
        _build.launch("bn254", "cmtpu_bn254_miller", p1.device,
                      p1.data_ptr(), q.data_ptr(), q1.data_ptr(), q2.data_ptr(), out.data_ptr(), n)
    return out


CONFIG_KEYS = ("blocks", "threads", "lanes_per_block", "registers", "local_bytes", "team",
               "shared_bytes", "slots")


def launch_config(n: int) -> dict:
    """The kernel's launch shape for n lanes (blocks, threads, lanes a
    block, threads a lane, dynamic shared bytes a block, slots a lane) and
    its registers and local (spill and stack) bytes a thread (needs CUDA)."""
    out = (ctypes.c_int * len(CONFIG_KEYS))()
    rc = _build.lib().cmtpu_bn254_config(n, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"bn254 config: {_build.lib().cmtpu_error_string(rc).decode()}")
    return dict(zip(CONFIG_KEYS, out))


# -- host packing / dispatch -------------------------------------------------------


def _pack(pairs, bucket):
    """(G1, G2-affine) lanes -> the four float64 operands, padded to
    ``bucket`` with (G1, G2) lanes; pi(Q) and -pi^2(Q) computed here."""
    p1 = np.zeros((bucket, 2, NLIMB), dtype=np.float64)
    qa = np.zeros((bucket, 2, 2, NLIMB), dtype=np.float64)
    q1a = np.zeros_like(qa)
    q2a = np.zeros_like(qa)
    padded = list(pairs) + [(_b.G1, _b.G2)] * (bucket - len(pairs))
    for lane, (p_pt, q) in enumerate(padded):
        p1[lane, 0] = to_limbs(p_pt[0] % P)
        p1[lane, 1] = to_limbs(p_pt[1] % P)
        q1 = _b._g2_frobenius(q)
        q2 = _b._g2_neg(_b._g2_frobenius(q1))
        for arr, pt in ((qa, q), (q1a, q1), (q2a, q2)):
            for ci, comp in enumerate(pt):
                arr[lane, ci, 0] = to_limbs(comp[0] % P)
                arr[lane, ci, 1] = to_limbs(comp[1] % P)
    return p1, qa, q1a, q2a


def _unpack_lane(out, lane) -> tuple:
    return tuple((from_limbs(out[lane, k, 0]), from_limbs(out[lane, k, 1])) for k in range(6))


def unpack_values(out) -> list:
    """(n, 6, 2, 13) limbs -> n Fp12 values as host ints: ``_unpack_lane``
    for every lane at once."""
    return [tuple((int(v[k, 0]), int(v[k, 1])) for k in range(6)) for v in limbs_to_ints(out)]


def operands_to_device(arrays, device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _dispatch(pairs, device) -> list:
    """One chunk of lanes: one launch, or, on a mesh, one launch a device
    over its contiguous lanes; exact per-lane Fp12 Miller values back as
    host ints."""
    w = mesh_width(device)
    bucket = bucket_for(len(pairs), w)
    arrays = _pack(pairs, bucket)
    split = w > 1 and bucket % w == 0 and bucket >= _mesh_floor(w)
    if split:
        from cometbft_tpu_torch.ops import sharded

        mesh = sharded.make_mesh(_ek.local_devices(device.type, w), axis="lane")
        shards = zip(*(sharded.split_lanes(mesh, a, 0) for a in arrays))
        outs = [miller_values(*ops) for ops in shards]
        out = torch.cat([o.cpu() for o in outs]).numpy()
    else:
        out = miller_values(*operands_to_device(arrays, device)).cpu().numpy()
    with _counters_lock:
        _counters["dispatches"] += 1
        _counters["lanes"] += len(pairs)
        _counters["sharded_dispatches"] += int(split)
    return unpack_values(out[: len(pairs)])


def multi_miller_values(pairs, device=None) -> list:
    """Per-lane f_{6t+2,Q}(P) (Jacobian-scaled; valid under the final
    exponentiation). Lanes with a point at infinity come back as F12_ONE,
    so indices stay 1:1; the rest go in chunks of ``MAX_LANES``."""
    dev = resolve(device)
    live = [(i, pr) for i, pr in enumerate(pairs) if pr[0] is not None and pr[1] is not None]
    vals = [_b.F12_ONE] * len(pairs)
    for start in range(0, len(live), MAX_LANES):
        chunk = live[start : start + MAX_LANES]
        for (i, _), v in zip(chunk, _dispatch([pr for _, pr in chunk], dev)):
            vals[i] = v
    return vals


def f12_product(vals):
    f = _b.F12_ONE
    for v in vals:
        f = _b.f12_mul(f, v)
    return f


def multi_pairing_check(pairs, device=None) -> bool:
    """prod e(P_i, Q_i) == 1: Miller loops on the device, one shared host
    final exponentiation."""
    if not pairs:
        return True
    f = f12_product(multi_miller_values(pairs, device))
    return _b.final_exponentiation_fast(f) == _b.F12_ONE


def warmup(n: int = 8, device=None) -> None:
    """Run one bucket for n lanes (builds the kernel library on CUDA)."""
    _dispatch([(_b.G1, _b.G2)] * min(n, MAX_LANES), resolve(device))


# -- the backend -------------------------------------------------------------------


def parse_aggregate(pubs, msgs, agg_sig):
    """The (G1, G2) lanes of an aggregate check, e(-pk_i, H(m_i)) for each
    signer and e(G1, agg) last; None when any encoding is malformed."""
    if len(pubs) != len(msgs) or not pubs:
        return None
    if len(agg_sig) not in (_b.SIGNATURE_SIZE, _b.SIGNATURE_SIZE_COMPRESSED):
        return None
    try:
        s = _b.g2_unmarshal(bytes(agg_sig))
        pairs = []
        for pk_b, m in zip(pubs, msgs):
            pk = _b.g1_decompress(bytes(pk_b))
            if pk is None:
                return None
            pairs.append(((pk[0], (P - pk[1]) % P), _b._hash_to_g2_cached(bytes(m))))
        pairs.append((_b.G1, s))
    except (ValueError, TypeError):
        return None
    return pairs


class Bn254DeviceBackend:
    """The device tier of the BN254 chain, with the reference backend's duck
    type (``aggregate_verify``, ``batch_verify``, ``merkle_root``,
    ``mesh_width``, ``ping``): Miller loops on one PyTorch device (``cuda``
    unless the caller passes ``device="cpu"``), parsing, hashing, weights
    and the final exponentiation on the host."""

    name = "bn254-torch"

    def __init__(self, device=None):
        self.device = resolve(device)

    def aggregate_verify(self, pubs, msgs, agg_sig) -> bool:
        pairs = parse_aggregate(pubs, msgs, agg_sig)
        return pairs is not None and multi_pairing_check(pairs, self.device)

    def batch_verify(self, pubs, msgs, sigs):
        n = len(pubs)
        bits = [False] * n
        parsed: dict[int, tuple] = {}
        for i in range(n):
            try:
                pk = _b.g1_decompress(bytes(pubs[i]))
                s = _b.g2_unmarshal(bytes(sigs[i]))
            except (ValueError, TypeError):
                continue
            if pk is None or s is None:
                continue
            parsed[i] = ((pk[0], (P - pk[1]) % P), _b._hash_to_g2_cached(bytes(msgs[i])), s)
        if not parsed:
            return False, bits
        ws = _b._batch_weights([bytes(p) for p in pubs], [bytes(m) for m in msgs],
                               [bytes(s) for s in sigs])
        # Two lanes a signature, e([w](-pk), H(m)) and e(G1, [w]s), so a
        # failed product is attributed per signature with one more final
        # exponentiation each and no second dispatch.
        order = sorted(parsed)
        lanes = []
        for i in order:
            neg_pk, hm, s = parsed[i]
            lanes.append((_b._g1_mul(ws[i], neg_pk), hm))
            lanes.append((_b.G1, _b._g2_mul(ws[i], s)))
        vals = multi_miller_values(lanes, self.device)
        if _b.final_exponentiation_fast(f12_product(vals)) == _b.F12_ONE:
            for i in order:
                bits[i] = True
        else:
            for k, i in enumerate(order):
                v = _b.f12_mul(vals[2 * k], vals[2 * k + 1])
                bits[i] = _b.final_exponentiation_fast(v) == _b.F12_ONE
        return (n > 0 and all(bits)), bits

    def merkle_root(self, leaves):
        return _merkle.hash_from_byte_slices(list(leaves))

    def mesh_width(self) -> int:
        return mesh_width(self.device)

    def ping(self) -> bool:
        """True when the device can serve: on CUDA, the kernel library loads."""
        if self.device.type == "cpu":
            return True
        try:
            _build.lib()
        except (RuntimeError, OSError):
            return False
        return True
