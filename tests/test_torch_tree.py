"""The sha256 tree entry's plain version (``merkle_kernel.tree_root_plain``,
the chunked two-pass reduction the kernel runs: every aligned chunk of C
raw leaves to its root, then the chunk roots C at a time) against the JAX
package's ``merkle_root`` and both packages' ``hash_from_byte_slices``, at
small and full chunk widths, for counts on both sides of every power of
two and leaf lengths across the one- to two-block edge (the 0x00 prefix
moves it to 55/56 bytes), empty and multi-block leaves included."""

import functools

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.merkle import hash_from_byte_slices as jax_pkg_root
from cometbft_tpu.ops import merkle_kernel as jmk
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.ops import merkle_kernel as tmk
from cometbft_tpu_torch.ops import sha256_kernel as tsha

pytestmark = pytest.mark.torch_port

LEAF_LENGTHS = (0, 54, 55, 56, 63, 64, 118, 119, 300)
COUNTS = (1, 2, 3, 5, 8, 255, 256, 257, 1000, 1024, 1025, 2049)


@functools.lru_cache(maxsize=None)
def _case(n):
    """n leaves cycling through LEAF_LENGTHS, and the JAX package's root."""
    rng = np.random.default_rng(n)
    leaves = [rng.bytes(LEAF_LENGTHS[(i + n) % len(LEAF_LENGTHS)]) for i in range(n)]
    return leaves, jmk.merkle_root(leaves)


@pytest.mark.parametrize("chunk", [4, 256])
@pytest.mark.parametrize("n", COUNTS)
def test_chunked_tree_matches_jax_and_oracles(n, chunk):
    leaves, want = _case(n)
    assert want == hash_from_byte_slices(leaves) == jax_pkg_root(leaves)
    flat, offsets = tmk.pack_leaves(leaves, "cpu")
    got = tmk.tree_root_plain(flat, offsets, chunk)
    assert got.shape == (8, 1)
    assert tsha.digest_words_to_bytes(got.numpy()) == [want]
    assert torch.equal(tmk.tree_root(flat, offsets, chunk), got)


@pytest.mark.parametrize("n", [3, 255, 1025])
def test_chunk_roots_are_a_tree_level(n):
    """The identity both passes rest on: the roots of the aligned chunks of
    2^c leaves are level c of the level-by-level tree, the ragged last
    chunk included."""
    leaves, _ = _case(n)
    blocks, nblocks = tsha.pack_messages([b"\x00" + x for x in leaves])
    digests = tmk.leaf_core(torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(nblocks))
    levels = tmk.tree_levels(digests)
    for c in (1, 2, 3):
        got = tmk._reduce_chunks(digests, 1 << c)
        assert torch.equal(got, levels[min(c, len(levels) - 1)])


def test_pack_leaves_layout():
    leaves = [b"", b"ab", b"", b"cde", bytes(300)]
    flat, offsets = tmk.pack_leaves(leaves, "cpu")
    assert flat.dtype == torch.uint8 and offsets.dtype == torch.int64
    assert offsets.tolist() == [0, 0, 2, 2, 5, 305]
    assert bytes(flat.numpy()) == b"".join(leaves)


@pytest.mark.parametrize("chunk", [0, 1, 3, 2048])
def test_tree_root_rejects_bad_chunks(chunk):
    flat, offsets = tmk.pack_leaves([b"a", b"b"], "cpu")
    with pytest.raises(ValueError, match="chunk"):
        tmk.tree_root(flat, offsets, chunk)
    with pytest.raises(ValueError, match="at least one leaf"):
        tmk.tree_root(flat[:0], offsets[:1])
