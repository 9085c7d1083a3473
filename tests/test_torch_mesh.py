"""The port's lane-split programs (``ops/sharded.py``) and the mesh routing
of ``ed25519_kernel``, ``merkle_kernel`` and ``bn254_kernel`` on the CPU:
the port runs on meshes of virtual ``cpu`` shards, the reference on the 8
virtual XLA devices tests/conftest.py sets up. Everything compared here is
an integer, so every comparison is exact:

- ``bucket_for`` and ``mesh_floor`` equal the reference's at widths 1, 5, 6
  and 8, with ``CMTPU_MESH_FLOOR`` set and unset (both packages' widths
  monkeypatched, as tests/test_mesh.py does); the host-hash program never
  shards;
- K1: the sharded bitmap equals the reference's ``sharded_verify_fn`` and
  the port's one-device path, a bad signature, a shape-invalid lane and the
  padded tail included; a 5-wide mesh pads 6 lanes to 10 and stays exact;
- K2, K3, K4: the fused leaves-to-root, the digest forest and the commit
  step equal the reference (ok, all_valid, root) on ``example_txs(64)``;
  also across a one-rank ``gloo`` group, so the collectives run;
- ``merkle_root_fused`` routes at ``CMTPU_MESH_MERKLE_FLOOR=16``, not at the
  default floor, and only on a power-of-two width;
- K6: ``merkle_root_pow2`` equals the reference's at n = 1, 2, 64, 1,024
  and raises on other counts; ``digest_tree_root`` equals the host tree at
  ragged counts;
- K7: ``bn254_kernel.bucket_for`` equals the reference's at the same
  widths, and the sharded ``_dispatch`` gives the one-device Miller values
  lane for lane, and the reference's (held at width 1, as
  tests/test_torch_bn254.py holds it).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cometbft_tpu.crypto.merkle import hash_from_byte_slices
from cometbft_tpu.ops import bn254_kernel as jbk
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.ops import merkle_kernel as jmk
from cometbft_tpu.ops import sharded as jsh
from cometbft_tpu.ops import sha256_kernel as jsha
from cometbft_tpu_torch.crypto import bn254_pure as bn
from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.ops import bn254_kernel as tbk
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import merkle_kernel as mk
from cometbft_tpu_torch.ops import sha256_kernel as sha
from cometbft_tpu_torch.ops import sharded
from cometbft_tpu_torch.sidecar.backend import TorchBackend

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
BUCKET_PROBES = (1, 3, 6, 8, 9, 11, 33, 400, 512, 513, 1000, 2048, 6000, 10_240, 16_385, 40_000)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eight PyTorch threads a worker oversubscribe the cores under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _width(monkeypatch, w):
    """Both packages route as if this process had w devices."""
    monkeypatch.setattr(jek, "mesh_width", lambda: w)
    monkeypatch.setattr(ek, "mesh_width", lambda device=None: w)


def _signed(n, tag=b"mesh"):
    """tests/test_mesh.py's keys (seed = SHA-256 of the secret) and messages."""
    seeds = [hashlib.sha256(tag + b"-%d" % i).digest() for i in range(n)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"msg-%d" % i for i in range(n)]
    return pubs, msgs, [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]


def _bad_lanes(pubs, msgs, sigs):
    """test_mesh.py's corruptions: lane 2 a bad signature, lane 4 a short key."""
    sigs = list(sigs)
    pubs = list(pubs)
    sigs[2] = sigs[2][:-1] + bytes([sigs[2][-1] ^ 1])
    pubs[4] = pubs[4][:31]
    return pubs, msgs, sigs


# -- the bucket ladder and the routing -------------------------------------------


@pytest.mark.parametrize("floor", [None, "512"])
@pytest.mark.parametrize("w", [1, 5, 6, 8])
def test_bucket_ladder_and_floor_equal_reference(monkeypatch, w, floor):
    if floor is None:
        monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    else:
        monkeypatch.setenv("CMTPU_MESH_FLOOR", floor)
    _width(monkeypatch, w)
    assert ek.mesh_floor() == jek.mesh_floor()
    assert [ek.bucket_for(n) for n in BUCKET_PROBES] == [jek.bucket_for(n) for n in BUCKET_PROBES]
    assert [ek.bucket_for(n, w) for n in BUCKET_PROBES] == [jek.bucket_for(n) for n in BUCKET_PROBES]


def test_cpu_width_is_one():
    assert ek.mesh_width("cpu") == 1 and tbk.mesh_width("cpu") == 1
    assert TorchBackend(device="cpu").mesh_width() == 1
    assert ek.mesh_counters().keys() >= {"devices", "sharded_dispatches", "padded_lanes",
                                         "merkle_sharded_dispatches"}


def _probe_operands(b, bmax=2):
    """Shape-only operands (the router reads the batch and block buckets)."""
    return (np.zeros((8, b), np.int32), None, None, np.zeros((b, bmax * 32), np.uint32), None)


def test_routing_follows_width_and_floor(monkeypatch):
    monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    _width(monkeypatch, 8)
    assert all(ek._route_for(_probe_operands(b), CPU)[1] for b in ek.BUCKETS)
    monkeypatch.setenv("CMTPU_MESH_FLOOR", "512")
    assert not ek._route_for(_probe_operands(128), CPU)[1]
    assert ek._route_for(_probe_operands(512), CPU)[1]
    _width(monkeypatch, 1)
    assert not ek._route_for(_probe_operands(512), CPU)[1]


def test_hosthash_program_never_shards(monkeypatch):
    monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    _width(monkeypatch, 8)
    hh = (np.zeros((8, 128), np.int32), None, None, np.zeros((16, 128), np.int32))
    assert not ek._route_for(hh, CPU)[1]
    assert not jek._route_for(hh)[1]
    with pytest.raises(NotImplementedError):
        sharded.sharded_verify_fn(sharded.make_mesh([CPU] * 2))(*hh)


# -- K1: the lane-split verify ---------------------------------------------------


def test_sharded_bitmap_equals_reference_and_one_device(monkeypatch):
    monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    pubs, msgs, sigs = _bad_lanes(*_signed(6, tag=b"ident"))
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs, 8)
    ref_operands, ref_host_ok = jek.pack_batch(pubs, msgs, sigs)
    assert operands[0].shape[1] == 8  # two padded tail lanes ride along
    for got, want in zip(operands, ref_operands):
        assert np.array_equal(np.asarray(got).view(np.int32), np.asarray(want).view(np.int32))
    assert np.array_equal(host_ok, ref_host_ok)

    ref_w, ref_fn = jek._sharded_verify()
    assert ref_w == 8
    want = np.asarray(ref_fn(*ref_operands))
    mesh = sharded.make_mesh([CPU] * 8)
    got = sharded.sharded_verify_fn(mesh)(*operands)
    one = ek.verify_operands(ek.operands_to_device(operands, CPU))
    assert got.dtype == torch.bool and got.shape == (8,)
    assert np.array_equal(got.numpy(), want) and torch.equal(got, one)
    assert got[6:].all()  # zero-padded lanes verify true on the device
    assert torch.equal(sharded.sharded_verify_replicated_fn(mesh)(*operands), got)

    # End to end: batch_verify routes the bucket over 8 virtual shards; the
    # bitmap (device verdict and host mask) is exact.
    _width(monkeypatch, 8)
    before = ek.mesh_counters()
    ok, bits = ek.batch_verify(pubs, msgs, sigs, device="cpu")
    after = ek.mesh_counters()
    assert not ok and [i for i, b in enumerate(bits) if not b] == [2, 4]
    assert after["sharded_dispatches"] == before["sharded_dispatches"] + 1
    assert after["padded_lanes"] == before["padded_lanes"] + 2


def test_five_wide_mesh_pads_tail_lanes(monkeypatch):
    """bucket_for(6) pads to 10 lanes (2 a shard) on 5 shards; the padded
    tail is vetoed by the host mask and the bitmap stays exact."""
    monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    _width(monkeypatch, 5)
    pubs, msgs, sigs = _signed(6, tag=b"w5")
    sigs[1] = b"\x00" * 64
    assert ek.bucket_for(6) == jek.bucket_for(6) == 10
    before = ek.mesh_counters()
    ok, bits = ek.batch_verify(pubs, msgs, sigs, device="cpu")
    after = ek.mesh_counters()
    assert not ok and [i for i, b in enumerate(bits) if not b] == [1]
    assert bits == [pure.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert after["sharded_dispatches"] == before["sharded_dispatches"] + 1
    assert after["padded_lanes"] == before["padded_lanes"] + 4
    _width(monkeypatch, 1)
    assert ek.batch_verify(pubs, msgs, sigs, device="cpu") == (ok, bits)


# -- K2, K3, K4: the forest and the commit step ----------------------------------


@pytest.fixture(scope="module")
def forest():
    """example_txs(64): the port's leaf digests (equal to the reference's),
    the pre-padded leaf blocks and the host root."""
    txs = sharded.example_txs(64)
    leaves = sharded.make_example_leaves(64, CPU)
    ref_leaves = np.asarray(jsh.make_example_leaves(64))
    assert np.array_equal(leaves.numpy(), ref_leaves.view(np.int32))
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in txs])
    return leaves, ref_leaves, blocks, nblocks, hash_from_byte_slices(txs)


@pytest.fixture(scope="module")
def one_rank_group():
    """A one-process gloo group, so the programs' collectives really run."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def _root(words) -> bytes:
    return jsha.digest_words_to_bytes(np.asarray(words).view(np.uint32))[0]


@pytest.mark.parametrize("grouped", [False, True])
def test_forest_roots_equal_reference(forest, request, grouped):
    leaves, ref_leaves, blocks, nblocks, host_root = forest
    group = request.getfixturevalue("one_rank_group") if grouped else None
    mesh = sharded.make_mesh([CPU] * 8, group=group)
    assert mesh.width == 8 and mesh.processes == 1
    ref_k3 = _root(jsh.sharded_merkle_fn(jsh.make_mesh(jax.devices()))(ref_leaves))
    ref_fused = _root(jmk.leaves_to_root_core(jnp.asarray(blocks), jnp.asarray(nblocks)))
    assert ref_k3 == ref_fused == host_root
    assert _root(sharded.sharded_merkle_fn(mesh)(leaves)) == ref_k3
    assert _root(sharded.sharded_leaves_to_root_fn(mesh)(blocks, nblocks)) == ref_fused
    with pytest.raises(ValueError):
        sharded.sharded_merkle_fn(sharded.make_mesh([CPU] * 3))(leaves)


@pytest.fixture(scope="module")
def commit_operands():
    """make_example_batch(8) as packed operands, and the same batch with
    lane 5's signature corrupted."""
    good = tuple(o.numpy() for o in sharded.make_example_batch(8, CPU))
    pubs, msgs, sigs = [], [], []
    for i in range(8):
        seed = hashlib.sha256(b"bench-%d" % i).digest()
        pubs.append(pure.public_key(seed))
        msgs.append(b"commit-vote-%d" % i)
        sigs.append(pure.sign(seed, pubs[-1], msgs[-1]))
    sigs[5] = sigs[5][:40] + bytes([sigs[5][40] ^ 1]) + sigs[5][41:]
    bad, _ = ek.pack_batch(pubs, msgs, sigs, 1)
    ref_good = tuple(np.asarray(o) for o in jsh.make_example_batch(8))
    for got, want in zip(good, ref_good):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    return good, bad


@pytest.mark.parametrize("grouped", [False, True])
def test_commit_step_equals_reference(forest, commit_operands, request, grouped):
    leaves, ref_leaves, _, _, host_root = forest
    group = request.getfixturevalue("one_rank_group") if grouped else None
    step = sharded.sharded_commit_step_fn(sharded.make_mesh([CPU] * 8, group=group))
    ref_step = jsh.sharded_commit_step_fn(jsh.make_mesh(jax.devices()))
    for operands, valid in zip(commit_operands, (True, False)):
        ref_ops = tuple(jnp.asarray(np.asarray(o).view(np.uint32) if i == 3 else o)
                        for i, o in enumerate(operands))
        ref_ok, ref_valid, ref_root = ref_step(*ref_ops, jnp.asarray(ref_leaves))
        ok, all_valid, root = step(*operands, leaves)
        assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
        assert bool(all_valid) is bool(ref_valid) is valid
        assert _root(root) == _root(ref_root) == host_root
    assert ok.tolist() == [i != 5 for i in range(8)]


# -- the Merkle route --------------------------------------------------------------


def _count(key):
    return ek.mesh_counters()[key]


def test_large_forest_routes_to_subtree_parallel_mesh(monkeypatch):
    monkeypatch.setenv("CMTPU_MESH_MERKLE_FLOOR", "16")
    _width(monkeypatch, 8)
    leaves = [b"leaf-%d" % i for i in range(64)]
    before = _count("merkle_sharded_dispatches")
    assert mk.merkle_root_fused(leaves, device="cpu") == hash_from_byte_slices(leaves)
    assert TorchBackend(device="cpu").merkle_root(leaves) == hash_from_byte_slices(leaves)
    assert _count("merkle_sharded_dispatches") == before + 2
    ragged = leaves[:48]  # not a power of two: the tree entry
    assert mk.merkle_root_fused(ragged, device="cpu") == hash_from_byte_slices(ragged)
    assert _count("merkle_sharded_dispatches") == before + 2


def test_merkle_floor_default_keeps_small_forests_single_device(monkeypatch):
    monkeypatch.delenv("CMTPU_MESH_MERKLE_FLOOR", raising=False)
    _width(monkeypatch, 8)
    leaves = [b"l-%d" % i for i in range(32)]
    before = _count("merkle_sharded_dispatches")
    assert mk._mesh_merkle_floor() == 16_384
    assert mk.merkle_root_fused(leaves, device="cpu") == hash_from_byte_slices(leaves)
    assert _count("merkle_sharded_dispatches") == before


def test_merkle_mesh_gate_requires_pow2_width(monkeypatch):
    monkeypatch.setenv("CMTPU_MESH_MERKLE_FLOOR", "16")
    leaves = [b"g-%d" % i for i in range(64)]
    for w in (6, 1):
        _width(monkeypatch, w)
        assert mk._sharded_root(CPU) is None
        before = _count("merkle_sharded_dispatches")
        assert mk.merkle_root_fused(leaves, device="cpu") == hash_from_byte_slices(leaves)
        assert _count("merkle_sharded_dispatches") == before
    _width(monkeypatch, 4)
    assert mk._sharded_root(CPU)[0] == 4


# -- K6: roots from leaf digests -----------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 64, 1024])
def test_merkle_root_pow2_equals_reference(n):
    digests = sharded.make_example_leaves(n, CPU).numpy().view(np.uint32)
    want = jmk.merkle_root_pow2(digests)
    assert want == hash_from_byte_slices(sharded.example_txs(n))
    assert mk.merkle_root_pow2(digests, device="cpu") == want
    assert mk.merkle_root_pow2(torch.from_numpy(digests.view(np.int32))) == want


@pytest.mark.parametrize("n", [0, 3, 6, 100])
def test_merkle_root_pow2_rejects_other_counts(n):
    with pytest.raises(ValueError, match="power-of-two"):
        mk.merkle_root_pow2(np.zeros((8, n), np.uint32), device="cpu")


@pytest.mark.parametrize("n", [1, 3, 5, 7, 100, 1000])
def test_digest_tree_root_equals_host_tree_at_ragged_counts(n):
    root = mk.digest_tree_root(sharded.make_example_leaves(n, CPU))
    assert root.shape == (8, 1) and root.dtype == torch.int32
    assert mk._root_bytes(root) == hash_from_byte_slices(sharded.example_txs(n))
    assert torch.equal(root, mk.digest_tree_root_plain(sharded.make_example_leaves(n, CPU)))


# -- K7: the BN254 lane mesh ---------------------------------------------------------


@pytest.mark.parametrize("floor", [None, "4096"])
@pytest.mark.parametrize("w", [1, 3, 5, 8])
def test_bn254_bucket_for_equals_reference(monkeypatch, w, floor):
    if floor is None:
        monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    else:
        monkeypatch.setenv("CMTPU_MESH_FLOOR", floor)
    _width(monkeypatch, w)
    probes = (1, 7, 8, 9, 100, 2049, 4096, 8000, 8192, 10_241)
    assert [tbk.bucket_for(n) for n in probes] == [jbk.bucket_for(n) for n in probes]
    assert tbk.mesh_width() == jbk.mesh_width() == w


def test_bn254_sharded_dispatch_equals_one_device_and_reference(monkeypatch):
    monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    p, q = bn.G1, bn.G2
    lanes = []
    for _ in range(6):
        lanes.append((p, q))
        p, q = bn._g1_add(p, bn.G1), bn._g2_add(q, bn.G2)
    _width(monkeypatch, 2)  # bucket 8: two shards of 4 lanes
    before = tbk.counters()
    sharded_vals = tbk._dispatch(lanes, CPU)
    after = tbk.counters()
    assert after["sharded_dispatches"] == before["sharded_dispatches"] + 1
    _width(monkeypatch, 1)
    assert tbk._dispatch(lanes, CPU) == sharded_vals
    assert tbk.counters()["sharded_dispatches"] == after["sharded_dispatches"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CMTPU_BN254_DEVICE", "1")
        assert jbk.device_available()
    assert jbk._dispatch(lanes) == sharded_vals  # the reference at width 1


# -- the mesh itself ----------------------------------------------------------------


def test_make_mesh_checks_its_devices(one_rank_group):
    with pytest.raises(ValueError):
        sharded.make_mesh([])
    with pytest.raises(ValueError):
        sharded.make_mesh([CPU, torch.device("meta")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sharded.make_mesh(["cuda"])
    mesh = sharded.make_mesh([CPU] * 3, group=one_rank_group)
    assert (mesh.rank, mesh.processes, mesh.local_width, mesh.width) == (0, 1, 3, 3)
    with pytest.raises(ValueError, match="split evenly"):
        sharded.split_lanes(mesh, np.zeros((8, 4), np.int32), 1)
