"""Merkle inclusion proofs of the port on the CPU, held to the JAX package.

``proofs_from_byte_slices_device(..., device="cpu")`` (the levels entry's
plain version, the aunt gather, ``DeviceProofs``) against the reference's
``crypto.merkle.proofs_from_byte_slices`` and the port's host oracle:
roots, totals, indexes, leaf hashes and aunts equal, every proof verifies.
The plain levels (``tree_levels_raw_plain``) against the reference's device
programs, carried across by ``convert.levels_from_jax``: its fused
``_leaves_to_levels_core`` at power-of-two counts, its level-by-level
``tree_levels`` elsewhere; at small chunks (4 and 8) too, which puts
ragged runs and promoted roots on every pass of the chunked layout."""

import functools

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.merkle import Proof as RefProof
from cometbft_tpu.crypto.merkle import proofs_from_byte_slices as ref_proofs
from cometbft_tpu.ops import merkle_kernel as jmk
from cometbft_tpu.ops import sha256_kernel as jsha
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import merkle as host
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import merkle_kernel as tmk

pytestmark = pytest.mark.torch_port

PROOF_COUNTS = (1, 2, 3, 5, 7, 8, 13, 64, 100, 255, 256, 257, 1000)
LEVEL_COUNTS = (1, 2, 3, 5, 8, 13, 64, 100, 256, 257, 1000)


@pytest.fixture(autouse=True)
def _one_thread():
    """Eight PyTorch threads a worker oversubscribe the cores under xdist."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _items(n):
    rng = np.random.default_rng(n)
    return [rng.bytes(int(k)) for k in rng.integers(0, 140, n)]


@functools.lru_cache(maxsize=None)
def _reference_levels(n):
    """The reference's device levels of _items(n), as uint32[8, m] arrays."""
    items = _items(n)
    if n & (n - 1) == 0:
        blocks, nblocks = jsha.pack_messages([b"\x00" + it for it in items])
        out = jmk._leaves_to_levels_jit(blocks.shape[0], n)(blocks, nblocks)
        return tuple(np.asarray(lv) for lv in out)
    return tuple(np.asarray(lv) for lv in jmk.tree_levels(jmk.hash_leaves_device(items)))


def _fields(p):
    return p.total, p.index, p.leaf_hash, list(p.aunts)


@pytest.mark.parametrize("n", PROOF_COUNTS)
def test_proofs_equal_reference(n):
    items = _items(n)
    root_r, proofs_r = ref_proofs(items)
    root_h, proofs_h = host.proofs_from_byte_slices(items)
    before = dict(_build.LAUNCHES)
    root_d, proofs_d = tmk.proofs_from_byte_slices_device(items, device="cpu")
    assert _build.LAUNCHES == before
    assert root_d == root_r == root_h
    assert len(proofs_d) == len(proofs_r) == n
    for i in range(n):
        pd = proofs_d[i]
        assert _fields(pd) == _fields(proofs_r[i]) == _fields(proofs_h[i])
        assert pd.verify(root_d, items[i]) is None
        pd.validate_basic()
        # the reference's own Proof accepts the port's proof as is
        assert RefProof(*_fields(pd)).verify(root_r, items[i]) is None


def test_single_leaf_has_depth_zero():
    root, leaf_hashes, aunts, counts = tmk.proofs_aunts_device([b"only"], device="cpu")
    assert root == host.leaf_hash(b"only") == bytes(leaf_hashes[0])
    assert aunts.shape == (1, 0, 32) and counts.tolist() == [0]


def test_empty_tree_takes_the_host_answer():
    assert tmk.proofs_from_byte_slices_device([], device="cpu") == (host.empty_hash(), [])
    assert ref_proofs([]) == (host.empty_hash(), [])
    assert tmk.merkle_levels_bytes([], device="cpu") == [[]] == jmk.merkle_levels_bytes([])


@pytest.mark.parametrize("chunk", [4, 8, 256])
@pytest.mark.parametrize("n", LEVEL_COUNTS)
def test_plain_levels_equal_reference_levels(n, chunk):
    flat, offsets = tmk.pack_leaves(_items(n), "cpu")
    got = tmk.tree_levels_raw_plain(flat, offsets, chunk)
    want = convert.levels_from_jax(_reference_levels(n))
    assert got.dtype == torch.int32 and got.shape == (tmk.level_rows(n)[-1][0] + 1, 8)
    assert torch.equal(got, want)
    assert torch.equal(tmk.tree_levels_raw(flat, offsets, chunk), got)
    assert [np.array_equal(a, b) for a, b in zip(convert.levels_to_jax(got), _reference_levels(n))] \
        == [True] * len(tmk.level_rows(n))


def _part_set(n):
    """n leaves in the shape of a block's parts at a small size: parts of
    8 KiB, the last part ragged (1,234 bytes), two short leaves (an empty
    one) among them, so the start of every leaf after them is unaligned."""
    rng = np.random.default_rng(n)
    items = [rng.bytes(8192) for _ in range(n - 3)] + [rng.bytes(1234)]
    return items[:2] + [b"", rng.bytes(77)] + items[2:-1] + [items[-1]]


@pytest.mark.parametrize("n", [7, 8])
def test_levels_of_long_leaves_equal_reference(n):
    """Long leaves (the levels entry's word loads and one warp a block):
    the wrapper tells them from the leaves' bytes, and its levels at their
    chunk equal the reference's (``_leaves_to_levels_core`` at a
    power-of-two count, its level-by-level program otherwise) and the plain
    version's at CHUNK."""
    items = _part_set(n)
    assert len(items) == n
    flat, offsets = tmk.pack_leaves(items, "cpu")
    assert tmk.long_leaves(n, flat.numel()) and not tmk.long_leaves(n, 100 * n)
    got = tmk.tree_levels_raw(flat, offsets)
    if n & (n - 1) == 0:
        blocks, nblocks = jsha.pack_messages([b"\x00" + it for it in items])
        ref = jmk._leaves_to_levels_jit(blocks.shape[0], n)(blocks, nblocks)
    else:
        ref = jmk.tree_levels(jmk.hash_leaves_device(items))
    assert torch.equal(got, convert.levels_from_jax([np.asarray(lv) for lv in ref]))
    assert torch.equal(got, tmk.tree_levels_raw_plain(flat, offsets))


@pytest.mark.parametrize("n", [3, 100])
def test_merkle_levels_bytes_equal_reference(n):
    assert tmk.merkle_levels_bytes(_items(n), device="cpu") == jmk.merkle_levels_bytes(_items(n))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9, 255, 256, 257, 65_536, 65_537])
def test_level_rows(n):
    rows = tmk.level_rows(n)
    assert rows[0] == (0, n) and rows[-1][1] == 1
    assert len(rows) - 1 == (n - 1).bit_length()
    for (base, count), (nxt, _) in zip(rows, rows[1:]):
        assert nxt == base + count
    assert [c for _, c in rows] == [-(-n // (1 << lvl)) for lvl in range(len(rows))]


@pytest.mark.parametrize("shapes", [[(8, 3), (8, 1)], [(8, 3), (8, 2)], [(8, 4), (8, 2)]])
def test_levels_from_jax_rejects_what_is_not_a_tree(shapes):
    with pytest.raises(ValueError, match="levels"):
        convert.levels_from_jax([np.zeros(s, np.uint32) for s in shapes])


def test_proofs_reject_cross_tree():
    txs = [b"x-%d" % i for i in range(8)]
    _, proofs = tmk.proofs_from_byte_slices_device(txs, device="cpu")
    other_root, _ = tmk.proofs_from_byte_slices_device([b"y"], device="cpu")
    with pytest.raises(ValueError, match="root hash"):
        proofs[0].verify(other_root, txs[0])
    with pytest.raises(ValueError, match="leaf hash"):
        proofs[0].verify(proofs.root, txs[1])


def test_proofs_lazy_sequence_protocol():
    txs = [b"s-%d" % i for i in range(5)]
    _, proofs = tmk.proofs_from_byte_slices_device(txs, device="cpu")
    assert len(list(proofs)) == 5
    assert [p.index for p in proofs[1:3]] == [1, 2]
    assert proofs[-1].index == 4
    with pytest.raises(IndexError):
        proofs[5]


@pytest.mark.parametrize(
    "change",
    ["index", "total", "aunt", "drop_aunt", "extra_aunt", "negative_index"],
)
def test_tampered_proof_fails_as_in_the_reference(change):
    """The port's Proof rejects exactly what the reference's rejects."""
    items = _items(13)
    root, proofs = host.proofs_from_byte_slices(items)
    fields = dict(total=13, index=6, leaf_hash=proofs[6].leaf_hash, aunts=list(proofs[6].aunts))
    if change == "index":
        fields["index"] = 7
    elif change == "total":
        fields["total"] = 7
    elif change == "aunt":
        fields["aunts"][1] = bytes(32)
    elif change == "drop_aunt":
        fields["aunts"].pop()
    elif change == "extra_aunt":
        fields["aunts"].append(bytes(32))
    else:
        fields["index"] = -1
    ported, ref = host.Proof(**fields), RefProof(**fields)
    assert ported.compute_root_hash() == ref.compute_root_hash()
    with pytest.raises(ValueError):
        ref.verify(root, items[6])
    with pytest.raises(ValueError):
        ported.verify(root, items[6])


@pytest.mark.parametrize("bad", ["leaf", "aunt", "too_many"])
def test_validate_basic_as_in_the_reference(bad):
    fields = dict(total=4, index=1, leaf_hash=bytes(32), aunts=[bytes(32), bytes(32)])
    if bad == "leaf":
        fields["leaf_hash"] = bytes(31)
    elif bad == "aunt":
        fields["aunts"][1] = bytes(33)
    else:
        fields["aunts"] = [bytes(32)] * (host.MAX_AUNTS + 1)
    with pytest.raises(ValueError):
        RefProof(**fields).validate_basic()
    with pytest.raises(ValueError):
        host.Proof(**fields).validate_basic()
