"""The plain sides of the two fused device stages against the JAX package,
bit for bit: ``sha512_kernel.challenge_digits_plain`` and
``scalar_digits_plain`` against the reference's ``hash_blocks_core`` then
``unpack.digest_words_to_digits`` / ``scalar_words_to_digits``, and
``edwards.decompress_words_plain`` against ``unpack.words_to_limbs255`` on
A and R then ``edwards.decompress`` (points through ``point_freeze``, ok
flags). Edge cases: zero-block padded lanes, the all-zero and all-ones
digests and multiples of L, s in {0, L - 1}, the non-canonical
y in {p, p + 1, 2^255 - 1}, x = 0 with sign 1, all-zero encodings.
Tolerance zero: the arithmetic is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import edwards as jed
from cometbft_tpu.ops import field25519 as jfe
from cometbft_tpu.ops import sha512_kernel as js5
from cometbft_tpu.ops import unpack as jun
from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.ops import edwards as ted
from cometbft_tpu_torch.ops import field25519 as tfe
from cometbft_tpu_torch.ops import sha512_kernel as ts5
from cometbft_tpu_torch.ops import unpack as tun

pytestmark = pytest.mark.torch_port

L = tun.L
P = tfe.P_INT


def _le(v: int, nbytes: int) -> bytes:
    return v.to_bytes(nbytes, "little")


def _words(values, nbytes):
    return tun.bytes_to_words(np.stack([np.frombuffer(_le(v, nbytes), np.uint8) for v in values]))


def _jax_digits(k_words, s_words):
    return (np.asarray(jun.scalar_words_to_digits(jnp.asarray(s_words))),
            np.asarray(jun.digest_words_to_digits(jnp.asarray(k_words))))


SCALARS = [0, L - 1, 1, 2**252, int("8" * 63, 16)]


@pytest.mark.parametrize("padded_lanes", [(), (0,), (2, 5, 6)])
def test_challenge_digits_plain_matches_jax(padded_lanes):
    """Ragged messages across the 111/112-byte padding edge and up to
    three blocks; the listed lanes hash zero blocks (the IV)."""
    rng = np.random.default_rng(31 + len(padded_lanes))
    lens = [0, 16, 111, 112, 113, 239, 240, 300]
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    buf, nblocks = ts5.pack_buffer512(msgs)
    nblocks = nblocks.copy()
    nblocks[list(padded_lanes)] = 0
    s_words = _words([SCALARS[i % len(SCALARS)] for i in range(len(msgs))], 32)
    s_dig, k_dig = ts5.challenge_digits_plain(
        torch.from_numpy(buf.view("<u4").view(np.int32)), torch.from_numpy(nblocks),
        torch.from_numpy(s_words))

    blocks, _ = js5.pack_messages512(msgs)
    state = jax.jit(js5.hash_blocks_core)(jnp.asarray(blocks), jnp.asarray(nblocks))
    want_s, want_k = _jax_digits(np.asarray(js5.digest_to_le_words(state)), s_words)
    np.testing.assert_array_equal(s_dig.numpy(), want_s)
    np.testing.assert_array_equal(k_dig.numpy(), want_k)
    assert k_dig.min() >= -8 and k_dig.max() <= 7


@pytest.mark.parametrize("digests", [
    [0, 2**512 - 1],
    [L - 1, L, L + 1, 2**252, 2**253 - 1],
    "multiples",
    "random",
])
def test_scalar_digits_plain_matches_jax(digests):
    rng = np.random.default_rng(41)
    if digests == "multiples":
        ks = [int(k) for k in rng.integers(1, 2**62, 4)]
        digests = [k * L + d for k in ks for d in (-1, 0, 1)]
    elif digests == "random":
        digests = [int.from_bytes(rng.bytes(64), "little") for _ in range(16)]
    scalars = [SCALARS[i % len(SCALARS)] for i in range(len(digests))]
    k_words, s_words = _words(digests, 64), _words(scalars, 32)
    s_dig, k_dig = ts5.scalar_digits_plain(torch.from_numpy(k_words), torch.from_numpy(s_words))
    want_s, want_k = _jax_digits(k_words, s_words)
    np.testing.assert_array_equal(s_dig.numpy(), want_s)
    np.testing.assert_array_equal(k_dig.numpy(), want_k)
    for lane, d in enumerate(digests):
        assert sum(int(x) << (4 * i) for i, x in enumerate(k_dig[:, lane])) == d % L
        assert sum(int(x) << (4 * i) for i, x in enumerate(s_dig[:, lane])) == scalars[lane]


EDGE_Y = {
    "y=p": [_le(P, 32), _le(P | 1 << 255, 32)],
    "y=p+1": [_le(P + 1, 32), _le((P + 1) | 1 << 255, 32)],
    "y=2^255-1": [_le((1 << 255) - 1, 32), _le(2**256 - 1, 32)],
    "x=0,sign=1": [_le(1 | 1 << 255, 32), _le((P - 1) | 1 << 255, 32)],
    "all-zero": [bytes(32), _le(1 << 255, 32)],
}


@pytest.mark.parametrize("case", sorted(EDGE_Y))
def test_decompress_words_plain_matches_jax(case):
    """The edge encodings as A (and as R, swapped) beside random ones and
    real keys: ok and the points equal to the reference's, and ok equal to
    the pure oracle's ZIP-215 decoding."""
    rng = np.random.default_rng(sorted(EDGE_Y).index(case))
    keys = [pure.public_key(rng.bytes(32)) for _ in range(2)]
    a = EDGE_Y[case] + keys + [rng.bytes(32)]
    r = [rng.bytes(32)] + keys + EDGE_Y[case][::-1]
    enc = np.stack([np.frombuffer(e, np.uint8) for e in a + r])
    words = tun.bytes_to_words(enc)
    n = len(a)
    pt, ok = ted.decompress_words_plain(torch.from_numpy(words[:, :n]),
                                        torch.from_numpy(words[:, n:]))
    assert pt.shape == (4, tfe.LIMBS, 2 * n)

    y_a, s_a = jun.words_to_limbs255(jnp.asarray(words[:, :n]))
    y_r, s_r = jun.words_to_limbs255(jnp.asarray(words[:, n:]))
    j_pt, j_ok = jed.decompress(jnp.concatenate([y_a, y_r], axis=1), jnp.concatenate([s_a, s_r]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.tolist() == [pure.point_decompress_zip215(bytes(e)) is not None for e in enc]
    got = np.stack([t.numpy() for t in ted.point_freeze(tuple(pt))])
    want = np.stack([np.asarray(jfe.fe_freeze(c)) for c in j_pt])
    np.testing.assert_array_equal(got, want)
