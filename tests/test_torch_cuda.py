"""Kernel-against-plain tests of the port on a CUDA device. Each hand
kernel (ladder at every group width, decompress, sha512, sha256 with its
leaf, inner and tree entries) is held to its plain PyTorch version on the
same card, exactly, at small shapes; the launch counters must count each
launch once (one ladder launch a call, two sha256 launches a root). Without a CUDA device every test here skips
(by the ``cuda`` fixture) with its reason.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import edwards as ed
from cometbft_tpu_torch.ops import field25519 as fe
from cometbft_tpu_torch.ops import ladder
from cometbft_tpu_torch.ops import merkle_kernel as mk
from cometbft_tpu_torch.ops import sha256_kernel as sha
from cometbft_tpu_torch.ops import sha512_kernel as s5
from cometbft_tpu_torch.sidecar.backend import TorchBackend

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    _build.lib()
    return torch.device("cuda")


def _encodings(m, seed):
    rng = np.random.default_rng(seed)
    P = fe.P_INT
    encs = [(1).to_bytes(32, "little"), (1 + P).to_bytes(32, "little"),
            (P - 1).to_bytes(32, "little"), ((1 << 255) - 1).to_bytes(32, "little"),
            (1 | 1 << 255).to_bytes(32, "little"), bytes(32)]
    encs += [rng.bytes(32) for _ in range(m - len(encs))]
    enc = np.stack([np.frombuffer(e, np.uint8) for e in encs])
    return torch.from_numpy(fe.fe_from_bytes_le(enc)), torch.from_numpy((enc[:, 31] >> 7).astype(bool))


def _canon(pt):
    return torch.stack(ed.point_freeze(tuple(c.cpu() for c in pt)))


def test_decompress_kernel_matches_plain(cuda):
    y, sign = _encodings(300, 1)
    before = _build.LAUNCHES["decompress"]
    pt_k, ok_k = ed.decompress_stacked(y.to(cuda), sign.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decompress"] == before + 1
    pt_p, ok_p = ed.decompress_plain(y, sign)
    assert torch.equal(ok_k.cpu(), ok_p)
    assert torch.equal(_canon(pt_k), _canon(pt_p))
    assert ok_p[:4].all() and not ok_p[4]


def _digits(n, seed):
    rng = np.random.default_rng(seed)
    s_dig = torch.from_numpy(rng.integers(-8, 9, (64, n)).astype(np.int32))
    k_dig = torch.from_numpy(rng.integers(-8, 9, (64, n)).astype(np.int32))
    s_dig[:, 0], k_dig[:, 0] = 8, -8
    s_dig[:, 1], k_dig[:, 1] = 0, 0
    return s_dig, k_dig


@pytest.mark.parametrize("group", ladder.GROUPS)
def test_ladder_kernel_matches_plain(cuda, group):
    """Verdict and accumulator against the plain version on random digits
    over A and R encodings of which about half fail to decode (those lanes
    must run through without fault and verify false)."""
    n = 70
    y, sign = _encodings(2 * n, 2)
    pt, ok = ed.decompress_stacked(y.to(cuda), sign.to(cuda))
    s_dig, k_dig = (d.to(cuda) for d in _digits(n, 3))
    before = _build.LAUNCHES["ladder"]
    got, acc = ladder.verify_lanes(s_dig, k_dig, pt, ok, group=group, with_acc=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ladder"] == before + 1
    want, acc_p = ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)
    assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(_canon(acc), _canon(acc_p))
    assert not ok.all() and ok.any()
    assert not got[~(ok[:n] & ok[n:])].any()


@pytest.mark.parametrize("group", ladder.GROUPS)
def test_ladder_verdicts_of_a_signed_batch(cuda, group):
    """Five signatures (one corrupted) in a bucket of 8: the zero-padded
    tail lanes decode and verify true (the host mask vetoes them)."""
    seeds = [hashlib.sha256(b"ladder-key-%d" % i).digest() for i in range(5)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"ladder-vote-%d" % i for i in range(5)]
    sigs = [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 2]) + sigs[2][41:]
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs)
    a_w, r_w, s_w, msg_w, msg_nb = ek.operands_to_device(operands, cuda)
    y2, sg2, s_dig, k_dig = ek.unpack_stage(a_w, r_w, s_w, s5.hash_blocks_core(msg_w, msg_nb))
    pt, ok = ed.decompress_stacked(y2, sg2)
    got = ladder.verify_lanes(s_dig, k_dig, pt, ok, group=group)
    want, _ = ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)
    assert got.tolist() == want.tolist() == [True, True, False] + [True] * 5
    assert host_ok.tolist() == [True] * 5 + [False] * 3


def test_sha512_kernel_matches_plain_and_hashlib(cuda):
    rng = np.random.default_rng(4)
    lens = [0, 111, 112, 113, 240, 32 * 128 - 17] + list(rng.integers(0, 1500, 40))
    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in lens]
    buf, nb = s5.pack_buffer512(msgs)
    nb[2] = 0
    words = torch.from_numpy(buf.view("<u4").view(np.int32))
    got = s5.hash_blocks_core(words.to(cuda), torch.from_numpy(nb).to(cuda)).cpu()
    assert torch.equal(got, s5.hash_blocks_plain(words, torch.from_numpy(nb)))
    digests = s5.digest_words_to_bytes(got.numpy())
    assert all(digests[i] == hashlib.sha512(m).digest() for i, m in enumerate(msgs) if i != 2)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 1000, 1024])
def test_sha256_kernel_roots_match_plain_and_hashlib(cuda, n):
    leaves = [b"cuda-tx-%d" % i * (1 + i % 5) for i in range(n)]
    want = hash_from_byte_slices(leaves)
    before = _build.LAUNCHES["sha256"]
    assert mk.merkle_root(leaves, device=cuda) == want
    assert _build.LAUNCHES["sha256"] == before + 2
    assert mk.merkle_root(leaves, device="cpu") == want
    levels = mk.tree_levels(mk.leaf_core(*(t.to(cuda) for t in _padded_leaves(leaves))))
    assert sha.digest_words_to_bytes(levels[-1].cpu().numpy()) == [want]


def _padded_leaves(leaves):
    blocks, nblocks = sha.pack_messages([b"\x00" + x for x in leaves])
    return torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(nblocks)


TREE_LEAF_LENGTHS = (0, 54, 55, 56, 63, 64, 118, 119, 300)


@pytest.mark.parametrize("chunk", [4, 256])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 255, 256, 257, 1000, 1024, 1025, 2049])
def test_sha256_tree_entry_matches_plain_and_hashlib(cuda, n, chunk):
    """Raw leaves of every length around the one- to two-block edge (the
    0x00 prefix moves it to 55/56 bytes), empty and multi-block leaves."""
    rng = np.random.default_rng(n * 7 + chunk)
    leaves = [rng.bytes(TREE_LEAF_LENGTHS[(i + n) % len(TREE_LEAF_LENGTHS)]) for i in range(n)]
    flat, offsets = mk.pack_leaves(leaves, cuda)
    before = _build.LAUNCHES["sha256"]
    got = mk.tree_root(flat, offsets, chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sha256"] == before + 2
    want = mk.tree_root_plain(flat, offsets, chunk)
    assert torch.equal(got.cpu(), want.cpu())
    assert sha.digest_words_to_bytes(got.cpu().numpy()) == [hash_from_byte_slices(leaves)]


def test_torch_backend_defaults_to_cuda(cuda):
    be = TorchBackend()
    assert be.device.type == "cuda"
    seeds = [hashlib.sha256(b"cuda-key-%d" % i).digest() for i in range(8)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"cuda-vote-%d" % i for i in range(8)]
    sigs = [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]
    sigs[6] = sigs[6][:33] + bytes([sigs[6][33] ^ 4]) + sigs[6][34:]
    assert be.batch_verify(pubs, msgs, sigs) == (False, [True] * 6 + [False, True])
