"""The port's SHA-512 (challenge hash), SHA-256 packer and RFC-6962 Merkle
roots against the JAX package and hashlib: byte-identical packers, equal
digests across the 111/112-byte padding boundary, ragged block counts and
zero-block (padding) lanes, and equal roots for ragged and power-of-two
leaf counts."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.merkle import hash_from_byte_slices as jax_pkg_root
from cometbft_tpu.ops import merkle_kernel as jmk
from cometbft_tpu.ops import sha256_kernel as jsha
from cometbft_tpu.ops import sha512_kernel as js5
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.ops import merkle_kernel as tmk
from cometbft_tpu_torch.ops import sha256_kernel as tsha
from cometbft_tpu_torch.ops import sha512_kernel as ts5

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def messages():
    rng = np.random.default_rng(21)
    lens = [0, 1, 110, 111, 112, 113, 127, 128, 239, 240, 241, 500]
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]


def test_sha512_packer_byte_identical(messages):
    got, got_nb = ts5.pack_messages512(messages)
    want, want_nb = js5.pack_messages512(messages)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_nb, want_nb)
    lens = np.array([len(m) for m in messages])
    np.testing.assert_array_equal(ts5.blocks_for(lens), js5.blocks_for(lens))


def test_sha512_matches_jax_and_hashlib(messages):
    """Ragged block counts, plus one lane forced to 0 blocks, which must
    return the IV as the reference's masked loop does."""
    buf, nblocks = ts5.pack_buffer512(messages)
    nblocks = nblocks.copy()
    nblocks[3] = 0
    words = torch.from_numpy(buf.view("<u4").view(np.int32))
    got = ts5.hash_blocks_plain(words, torch.from_numpy(nblocks)).numpy()

    blocks, _ = js5.pack_messages512(messages)
    state = jax.jit(js5.hash_blocks_core)(jnp.asarray(blocks), jnp.asarray(nblocks))
    want = np.asarray(js5.digest_to_le_words(state))
    np.testing.assert_array_equal(got, want)

    digests = ts5.digest_words_to_bytes(got)
    for i, m in enumerate(messages):
        if i != 3:
            assert digests[i] == hashlib.sha512(m).digest()
    iv = b"".join(v.to_bytes(8, "big") for v in ts5._IV)
    assert digests[3] == iv


def test_sha256_packer_byte_identical(messages):
    got, got_nb = tsha.pack_messages(messages)
    want, want_nb = jsha._pack_messages_np(messages, np.array([len(m) for m in messages]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_nb, want_nb)


def test_sha256_compress_matches_jax(messages):
    blocks, _ = tsha.pack_messages(messages)
    n = blocks.shape[2]
    got = tsha.compress(
        tsha.iv_state(n, "cpu"), torch.from_numpy(blocks[0].astype(np.int64))
    ).numpy()
    want = np.asarray(jsha.compress(jsha.iv_state(n), jnp.asarray(blocks[0])))
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_leaf_and_inner_match_jax(messages):
    msgs = [b"\x00" + m for m in messages]
    blocks, nblocks = tsha.pack_messages(msgs)
    got = tmk.leaf_core(
        torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(nblocks)
    )
    want = jmk._leaf_core(jnp.asarray(blocks), jnp.asarray(nblocks))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    for i, m in enumerate(messages):
        assert tsha.digest_words_to_bytes(got.numpy())[i] == hashlib.sha256(b"\x00" + m).digest()
    inner = tmk.inner_core(got[:, 0::2], got[:, 1::2])
    want_inner = jmk._inner_core(want[:, 0::2], want[:, 1::2])
    np.testing.assert_array_equal(inner.numpy().view(np.uint32), np.asarray(want_inner))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 1000, 1024])
def test_merkle_root_matches_jax_and_hashlib(n):
    leaves = [b"torch-tx-%05d" % i * (1 + i % 3) for i in range(n)]
    want = hash_from_byte_slices(leaves)
    assert jax_pkg_root(leaves) == want
    assert tmk.merkle_root(leaves, device="cpu") == want
    if n & (n - 1) == 0:
        assert jmk.merkle_root_fused(leaves) == want
    else:
        assert jmk.merkle_root(leaves) == want
