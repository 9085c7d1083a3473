"""cometbft_tpu_torch.ops.edwards against the JAX package's edwards (XLA on
the CPU) and the eager Pallas row helpers: ZIP-215 decoding, the group law,
the signed table selects, the fixed-base table carried across by
``convert.table_b_from_jax``, and the plain ladder over all 64 windows.
Coordinates are compared as canonical residues (and limb for limb where
both sides use the 17x15-bit layout); no tolerance, the arithmetic is
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519
from cometbft_tpu.crypto import ed25519_pure as pure
from cometbft_tpu.ops import edwards as jed
from cometbft_tpu.ops import field25519 as jfe
from cometbft_tpu.ops import pallas_ladder as plad
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.ops import edwards as ted
from cometbft_tpu_torch.ops import field25519 as tfe

pytestmark = pytest.mark.torch_port

P = tfe.P_INT


def _enc_int(y, sign=0):
    return (y | (sign << 255)).to_bytes(32, "little")


@pytest.fixture(scope="module")
def encodings():
    """ZIP-215 edge encodings (tests/test_ops_kernel.py) plus real keys:
    identity y = 1 and its non-canonical alias 1 + p, y = p - 1, y >= p,
    x = 0 with sign 1 (y = 1), y = 0 with sign 1, a garbage R, an all-zero
    padded lane, random keys."""
    encs = [
        (1).to_bytes(32, "little"),
        _enc_int(1 + P),
        _enc_int(P - 1, 0),
        _enc_int((1 << 255) - 1, 0),
        _enc_int(1, 1),
        _enc_int(0, 1),
        b"\x11" * 32,
        b"\x00" * 32,
    ]
    encs += [
        ed25519.gen_priv_key_from_secret(b"torch-ed-%d" % i).pub_key().bytes()
        for i in range(9)
    ]
    enc = np.stack([np.frombuffer(e, np.uint8) for e in encs])
    y = tfe.fe_from_bytes_le(enc)
    sign = (enc[:, 31] >> 7).astype(bool)
    return encs, y, sign


@pytest.fixture(scope="module")
def decoded(encodings):
    _, y, sign = encodings
    t_pt, t_ok = ted.decompress_plain(torch.from_numpy(y), torch.from_numpy(sign))
    j_pt, j_ok = jed.decompress(jnp.asarray(y), jnp.asarray(sign))
    return t_pt, t_ok, j_pt, j_ok


def _canon_t(pt):
    return np.stack([tfe.fe_freeze(c).numpy() for c in pt])


def _canon_j(pt):
    return np.stack([np.asarray(jfe.fe_freeze(jnp.asarray(np.asarray(c)))) for c in pt])


def test_decompress_matches_jax(decoded):
    t_pt, t_ok, j_pt, j_ok = decoded
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    carried = convert.point_from_jax(tuple(np.asarray(c) for c in j_pt))
    for tc, jc in zip(t_pt, carried):
        assert torch.equal(tc, jc)


def test_decompress_zip215_rules_match_pure(encodings, decoded):
    encs, _, _ = encodings
    _, t_ok, _, _ = decoded
    for e, ok in zip(encs, t_ok.numpy().tolist()):
        assert ok == (pure.point_decompress_zip215(e) is not None), e.hex()
    assert t_ok[1], "non-canonical identity alias must decode (rule 1)"
    assert not t_ok[4], "x = 0 with sign 1 is rejected"


def _points(decoded):
    t_pt, t_ok, j_pt, _ = decoded
    good = t_ok.numpy()
    tp = tuple(c[:, good] for c in t_pt)
    jp = tuple(jnp.asarray(np.asarray(c)[:, good]) for c in j_pt)
    return tp, jp


def test_group_law_matches_jax(decoded):
    tp, jp = _points(decoded)
    tq = tuple(torch.roll(c, 1, dims=1) for c in tp)
    jq = tuple(jnp.roll(c, 1, axis=1) for c in jp)
    pairs = [
        (ted.point_add(tp, tq), jed.point_add(jp, jq)),
        (ted.point_double(tp), jed.point_double(jp)),
        (ted.point_neg(tp), jed.point_neg(jp)),
        (ted.to_precomp(tp), jed.to_precomp(jp)),
        (ted.add_precomp(tp, ted.to_precomp(tq)), jed.add_precomp(jp, jed.to_precomp(jq))),
        (ted.add_precomp_z1(tp, ted.to_precomp(tq)), jed.add_precomp_z1(jp, jed.to_precomp(jq))),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        ted.point_is_identity(ted.point_add(tp, ted.point_neg(tp))).numpy(),
        np.ones(tp[0].shape[1], bool),
    )
    ty, ts = ted.point_compress(tp)
    jy, js = jed.point_compress(jp)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _rows(c):
    return [jnp.asarray(np.asarray(c)[i]) for i in range(17)]


def test_group_law_matches_pallas_row_helpers(decoded):
    tp, _ = _points(decoded)
    tq = tuple(torch.roll(c, 1, dims=1) for c in tp)
    rp = tuple(_rows(c.numpy()) for c in tp)
    rq = tuple(_rows(c.numpy()) for c in tq)
    pairs = [
        (ted.point_double(tp), plad._pdbl(rp)),
        (ted.to_precomp(tp), plad._to_precomp(rp)),
        (ted.add_precomp(tp, ted.to_precomp(tq)),
         plad._add_precomp(rp, plad._to_precomp(rq), z2_is_one=False)),
    ]
    for got, want in pairs:
        want_np = tuple(np.stack([np.asarray(r) for r in c]) for c in want)
        np.testing.assert_array_equal(_canon_t(got), _canon_t(tuple(torch.from_numpy(w) for w in want_np)))


def test_select_b_matches_pallas_and_jax():
    digits = np.arange(-8, 9, dtype=np.int32)
    got = ted.select_precomp_signed(ted.table_b("cpu"), torch.from_numpy(digits))
    want_j = jed.select_precomp_signed(jnp.asarray(jed.TABLE_B_PRE), jnp.asarray(digits))
    for g, w in zip(got, want_j):
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(np.asarray(w), g.shape))
    want_p = plad._select_b(jnp.asarray(digits))
    want_p = tuple(torch.from_numpy(np.stack([np.asarray(r) for r in c])) for c in want_p)
    np.testing.assert_array_equal(_canon_t(got), _canon_t(want_p))


def test_table_b_carries_across():
    carried = convert.table_b_from_jax(jed.TABLE_B_PRE)
    np.testing.assert_array_equal(carried.numpy(), ted.TABLE_B_PRE)
    np.testing.assert_array_equal(ted.TABLE_B_PRE, jed.TABLE_B_PRE)


def test_scalars_to_digits_matches_jax():
    rng = np.random.default_rng(3)
    scal = [0, 1, pure.L - 1, 0x8888888888888888, 2**252]
    scal += [int.from_bytes(rng.bytes(32), "little") % pure.L for _ in range(5)]
    le = np.stack([np.frombuffer(s.to_bytes(32, "little"), np.uint8) for s in scal])
    np.testing.assert_array_equal(ted.scalars_to_digits(le), jed.scalars_to_digits(le))


def test_plain_ladder_matches_jax_all_windows(decoded):
    """The ladder kernel's plain version against
    edwards.windowed_double_base_mult under jax.jit: 8 lanes, all 64
    windows, digits covering -8, 0 and 8."""
    t_pt, t_ok, _, _ = decoded
    good = np.nonzero(t_ok.numpy())[0][:8]
    a_pt = tuple(c[:, good] for c in t_pt)
    n = len(good)
    rng = np.random.default_rng(11)
    s_dig = rng.integers(-8, 9, (64, n)).astype(np.int32)
    k_dig = rng.integers(-8, 9, (64, n)).astype(np.int32)
    s_dig[:, 0], k_dig[:, 0] = 8, -8
    s_dig[:, 1], k_dig[:, 1] = 0, 0
    got = ted.windowed_double_base_mult(
        torch.from_numpy(s_dig), torch.from_numpy(k_dig), a_pt
    )
    want = jax.jit(jed.windowed_double_base_mult)(
        jnp.asarray(s_dig), jnp.asarray(k_dig), convert.point_to_jax(a_pt)
    )
    np.testing.assert_array_equal(_canon_t(got), _canon_j(want))
    ty, ts = ted.point_compress(got)
    jy, js = jed.point_compress(tuple(jnp.asarray(np.asarray(c)) for c in want))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
