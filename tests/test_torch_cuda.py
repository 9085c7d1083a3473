"""Kernel-against-plain tests of the port on a CUDA device. Each hand
kernel (ladder at every group width, decompress from raw words, sha512's
challenge_digits and scalar_digits, sha256 with its leaf, inner, tree and
levels entries, the bn254 Miller loop) is held to its plain PyTorch version
on the same card, exactly (bn254: equal mod P), at small shapes and on the
ZIP-215, scalar and field edge inputs, bn254 also at its 8,192-lane chunk
and at counts that leave a warp's last teams without a lane (its launch
with no local bytes), the levels entry also on long leaves (word loads);
the launch counters must count each launch once (one launch a call, two
sha256 launches a root and a proof set, one sha512, decompress and ladder
launch a verify batch, one bn254 launch a chunk of an aggregate). The
digests entry of sha256 is held to its plain version at ragged counts, and
the lane-split programs on two virtual shards of the card to the
one-device path. Every kernel launches on its tensors' device whatever the
calling thread's current device is (on ``cuda:1`` with ``cuda:0`` current
where the host has two cards). Without a CUDA device every test here skips
(by the ``cuda`` fixture) with its reason.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import hashlib
import threading

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import bn254_pure as bn
from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices, proofs_from_byte_slices
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import bn254_kernel as bk
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import edwards as ed
from cometbft_tpu_torch.ops import field25519 as fe
from cometbft_tpu_torch.ops import ladder
from cometbft_tpu_torch.ops import merkle_kernel as mk
from cometbft_tpu_torch.ops import sha256_kernel as sha
from cometbft_tpu_torch.ops import sha512_kernel as s5
from cometbft_tpu_torch.ops import sharded
from cometbft_tpu_torch.ops import unpack
from cometbft_tpu_torch.sidecar.backend import TorchBackend

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    _build.lib()
    return torch.device("cuda")


def _le(v: int, nbytes: int) -> bytes:
    return v.to_bytes(nbytes, "little")


P = fe.P_INT
L = ek.L
# ZIP-215 edge encodings: the identity y = 1 and its alias 1 + p, y = p - 1,
# y = p (an alias of y = 0), y = 2^255 - 1, x = 0 with sign 1, y = 0 with
# sign 1, an all-zero padded lane.
EDGE_ENCODINGS = [_le(1, 32), _le(1 + P, 32), _le(P - 1, 32), _le(P, 32),
                  _le((1 << 255) - 1, 32), _le(1 | 1 << 255, 32), _le(1 << 255, 32), bytes(32)]
EDGE_DIGESTS = [0, 2**512 - 1, L - 1, L, L + 1, 2**252, 7 * L]
EDGE_SCALARS = [0, L - 1, 1, 2**252]


def _encoding_words(m, seed):
    """int32[8, m] words of m encodings: the edge cases, then random bytes."""
    rng = np.random.default_rng(seed)
    encs = EDGE_ENCODINGS + [rng.bytes(32) for _ in range(max(0, m - len(EDGE_ENCODINGS)))]
    encs = encs[:m]
    return torch.from_numpy(unpack.bytes_to_words(np.stack([np.frombuffer(e, np.uint8) for e in encs])))


def _int_words(values, nbytes):
    raw = np.stack([np.frombuffer(_le(v, nbytes), np.uint8) for v in values])
    return torch.from_numpy(unpack.bytes_to_words(raw))


def _digits_value(digits, lane):
    return sum(int(d) << (4 * i) for i, d in enumerate(digits[:, lane].tolist()))


def _canon(pt):
    return torch.stack(ed.point_freeze(tuple(c.cpu() for c in pt)))


@pytest.mark.parametrize("n", [1, 5, 150, 1000])
def test_decompress_kernel_matches_plain(cuda, n):
    """Raw A and R words in, the edge encodings among the A lanes (R
    lanes at n = 1), the rest random; failed decodings included."""
    w = _encoding_words(2 * n, n)
    a, r = w[:, :n], w[:, n:]
    before = _build.LAUNCHES["decompress"]
    pt_k, ok_k = ed.decompress_words(a.to(cuda), r.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decompress"] == before + 1
    pt_p, ok_p = ed.decompress_words_plain(a, r)
    assert torch.equal(ok_k.cpu(), ok_p)
    assert torch.equal(_canon(pt_k), _canon(pt_p))
    if n >= 8:
        want = [pure.point_decompress_zip215(e) is not None for e in EDGE_ENCODINGS]
        assert ok_p[: len(want)].tolist() == want and not want[5]


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
    w = _encoding_words(2 * n, 2).to(cuda)
    pt, ok = ed.decompress_words(w[:, :n], w[:, n:])
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
    s_dig, k_dig = s5.challenge_digits(msg_w, msg_nb, s_w)
    pt, ok = ed.decompress_words(a_w, r_w)
    got = ladder.verify_lanes(s_dig, k_dig, pt, ok, group=group)
    want, _ = ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)
    assert got.tolist() == want.tolist() == [True, True, False] + [True] * 5
    assert host_ok.tolist() == [True] * 5 + [False] * 3
    cpu = [t.cpu() for t in (a_w, r_w, s_w)]
    y2, sg2, s_p, k_p = ek.unpack_stage(*cpu, s5.hash_blocks_plain(msg_w.cpu(), msg_nb.cpu()))
    assert torch.equal(s_dig.cpu(), s_p) and torch.equal(k_dig.cpu(), k_p)
    assert torch.equal(_canon(pt), _canon(ed.decompress_plain(y2, sg2)[0]))


def test_sha512_kernel_matches_plain_and_hashlib(cuda):
    """challenge_digits on a ragged batch up to 32 blocks with a zero-block
    (padding) lane and the edge scalars: equal to the plain version, and k
    equal to hashlib's digest mod L (the IV's at the padding lane)."""
    rng = np.random.default_rng(4)
    lens = [0, 111, 112, 113, 240, 32 * 128 - 17] + list(rng.integers(0, 1500, 40))
    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in lens]
    buf, nb = s5.pack_buffer512(msgs)
    nb[2] = 0
    words = torch.from_numpy(buf.view("<u4").view(np.int32))
    nbt = torch.from_numpy(nb)
    scalars = EDGE_SCALARS + [int(rng.integers(0, 2**62)) * 2**190 % L for _ in lens[4:]]
    s_words = _int_words(scalars, 32)
    before = _build.LAUNCHES["sha512"]
    s_dig, k_dig = s5.challenge_digits(words.to(cuda), nbt.to(cuda), s_words.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sha512"] == before + 1
    s_p, k_p = s5.challenge_digits_plain(words, nbt, s_words)
    assert torch.equal(s_dig.cpu(), s_p) and torch.equal(k_dig.cpu(), k_p)
    iv = b"".join(v.to_bytes(8, "big") for v in s5._IV)
    for i, m in enumerate(msgs):
        digest = iv if i == 2 else hashlib.sha512(m).digest()
        assert _digits_value(k_p, i) == int.from_bytes(digest, "little") % L
        assert _digits_value(s_p, i) == scalars[i]


def test_scalar_digits_kernel_matches_plain(cuda):
    """scalar_digits (the host-hash program's entry) on the edge digests
    (zero, all ones, around multiples of L) and scalars."""
    rng = np.random.default_rng(5)
    digests = EDGE_DIGESTS + [int.from_bytes(rng.bytes(64), "little") for _ in range(57)]
    scalars = (EDGE_SCALARS * 16)[: len(digests)]
    k_words, s_words = _int_words(digests, 64), _int_words(scalars, 32)
    before = _build.LAUNCHES["sha512"]
    s_dig, k_dig = s5.scalar_digits(k_words.to(cuda), s_words.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sha512"] == before + 1
    s_p, k_p = s5.scalar_digits_plain(k_words, s_words)
    assert torch.equal(s_dig.cpu(), s_p) and torch.equal(k_dig.cpu(), k_p)
    assert [_digits_value(k_p, i) for i in range(len(digests))] == [d % L for d in digests]


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


@pytest.mark.parametrize("chunk", [4, 256])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 255, 256, 257, 1000, 1025, 10_000])
def test_sha256_levels_entry_matches_plain(cuda, n, chunk):
    """The levels entry at ragged counts (a ragged last chunk, one chunk,
    n = 2^k + 1): every word of every level equal to the plain version,
    the last level the root, two launches."""
    rng = np.random.default_rng(n * 11 + chunk)
    leaves = [rng.bytes(TREE_LEAF_LENGTHS[(i + n) % len(TREE_LEAF_LENGTHS)]) for i in range(n)]
    flat, offsets = mk.pack_leaves(leaves, cuda)
    before = _build.LAUNCHES["sha256"]
    got = mk.tree_levels_raw(flat, offsets, chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sha256"] == before + 2
    assert got.shape == (mk.level_rows(n)[-1][0] + 1, 8)
    assert torch.equal(got.cpu(), mk.tree_levels_raw_plain(flat, offsets, chunk).cpu())
    assert bytes(mk.levels_to_digests(got)[-1]) == hash_from_byte_slices(leaves)


def _long_leaves(case):
    """A part set at a small size (9 parts of 64 KiB, the last ragged) or a
    mix of short leaves and long ones at unaligned starts."""
    rng = np.random.default_rng(len(case))
    if case == "parts":
        return [rng.bytes(65_536) for _ in range(8)] + [rng.bytes(12_345)]
    long_lengths = (65_536, 65_537, 4_095, 20_000, 65_535)
    return [rng.bytes(long_lengths[i // 4 % 5] if i % 4 == 1 else TREE_LEAF_LENGTHS[i % 9])
            for i in range(40)]


@pytest.mark.parametrize("case", ["parts", "mix"])
def test_sha256_levels_entry_long_leaves(cuda, case):
    """The levels entry's word loads on long leaves (the mix's at unaligned
    starts), at the chunk the wrapper picks (one warp a block): every word
    equal to the plain version (on the CPU: a 64 KiB leaf is 1,025
    compressions in a row), two launches, the root the host's."""
    leaves = _long_leaves(case)
    flat, offsets = mk.pack_leaves(leaves, cuda)
    assert mk.long_leaves(len(leaves), flat.numel())
    before = _build.LAUNCHES["sha256"]
    got = mk.tree_levels_raw(flat, offsets)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sha256"] == before + 2
    assert torch.equal(got.cpu(), mk.tree_levels_raw_plain(flat.cpu(), offsets.cpu()))
    assert bytes(mk.levels_to_digests(got)[-1]) == hash_from_byte_slices(leaves)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000])
def test_proofs_on_cuda_equal_host(cuda, n):
    items = [b"cuda-proof-%d" % i * (1 + i % 3) for i in range(n)]
    root_h, proofs_h = proofs_from_byte_slices(items)
    before = _build.LAUNCHES["sha256"]
    root_d, proofs_d = mk.proofs_from_byte_slices_device(items)
    assert _build.LAUNCHES["sha256"] == before + 2
    assert root_d == root_h and len(proofs_d) == n
    for i in range(n):
        ph, pd = proofs_h[i], proofs_d[i]
        assert (pd.total, pd.index, pd.leaf_hash, pd.aunts) == (ph.total, ph.index, ph.leaf_hash, ph.aunts)
        assert pd.verify(root_d, items[i]) is None


@pytest.mark.parametrize("oversized", [False, True])
def test_batch_verify_is_three_launches(cuda, oversized):
    """One verify batch on the card: one sha512, one decompress and one
    ladder launch, nothing in between (the host-hash program too)."""
    seeds = [hashlib.sha256(b"launch-key-%d" % i).digest() for i in range(5)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"launch-vote-%d" % i for i in range(5)]
    if oversized:
        msgs[3] = b"x" * 5000  # past BLOCK_BUCKETS[-1]: host-hash program
    sigs = [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]
    sigs[1] = sigs[1][:40] + bytes([sigs[1][40] ^ 2]) + sigs[1][41:]
    before = dict(_build.LAUNCHES)
    assert TorchBackend().batch_verify(pubs, msgs, sigs) == (False, [True, False, True, True, True])
    delta = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert delta == {"sha512": 1, "decompress": 1, "ladder": 1, "sha256": 0, "bn254": 0}


def test_torch_backend_defaults_to_cuda(cuda):
    be = TorchBackend()
    assert be.device.type == "cuda"
    seeds = [hashlib.sha256(b"cuda-key-%d" % i).digest() for i in range(8)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"cuda-vote-%d" % i for i in range(8)]
    sigs = [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]
    sigs[6] = sigs[6][:33] + bytes([sigs[6][33] ^ 4]) + sigs[6][34:]
    assert be.batch_verify(pubs, msgs, sigs) == (False, [True] * 6 + [False, True])


def _bn254_lanes(n):
    """n lanes: the padding lane (G1, G2), coordinates 0, 1 and P - 1, and
    off-curve field elements first, then multiples of a seeded (P, Q) by
    repeated addition (the Miller formulas are polynomials, so kernel and
    plain version must agree on every lane)."""
    p_ = bn.P
    rng = np.random.default_rng(n)

    def fe():
        return int.from_bytes(rng.bytes(32), "little") % p_

    edge = [(bn.G1, bn.G2), ((0, 0), ((0, 0), (0, 0))), ((1, 1), ((1, 1), (1, 1))),
            ((p_ - 1, p_ - 1), ((p_ - 1, p_ - 1), (p_ - 1, p_ - 1))),
            ((0, 1), ((p_ - 1, 0), (1, p_ - 1))),
            ((fe(), fe()), ((fe(), fe()), (fe(), fe()))), ((fe(), fe()), bn.G2)]
    lanes = edge[:n]
    pt, q = bn._g1_mul(3, bn.G1), bn._g2_mul(5, bn.G2)
    while len(lanes) < n:
        lanes.append((pt, q))
        pt, q = bn._g1_add(pt, bn.G1), bn._g2_add(q, bn.G2)
    return lanes


@pytest.mark.parametrize("n", [5, 8, 33, 8192])
def test_bn254_kernel_matches_plain(cuda, n):
    """At bucket 8, at the 8,192-lane chunk (MAX_LANES) and at counts that
    leave a warp's last teams without a lane (5, 33: not a multiple of the
    32 / team lanes a warp), edge lanes first: every lane equal mod P, the
    kernel's limbs canonical."""
    ops = bk.operands_to_device(bk._pack(_bn254_lanes(n), n), cuda)
    before = _build.LAUNCHES["bn254"]
    got = bk.miller_values(*ops)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bn254"] == before + 1
    want = bk.miller_values_plain(*ops)
    assert got.shape == want.shape == (n, 6, 2, 13)
    assert bool(((got >= 0) & (got < 2**21) & (got == got.floor())).all())
    k, p = bk.limbs_to_ints(got.cpu().numpy()), bk.limbs_to_ints(want.cpu().numpy())
    assert (k == p).all()


def test_bn254_launch_has_no_spills(cuda):
    """The team kernel at 8,192 lanes: no local (spill) bytes, well under
    255 registers, 8 threads a lane, one wave of blocks on the card."""
    from cometbft_tpu_torch.ops import bn254_schedule as bs

    cfg = bk.launch_config(8192)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cfg["local_bytes"] == 0 and cfg["registers"] <= 128
    assert cfg["team"] == bs.TEAM and cfg["slots"] == bs.slots()
    assert cfg["blocks"] <= sms and cfg["blocks"] * cfg["lanes_per_block"] >= 8192
    assert cfg["threads"] >= cfg["lanes_per_block"] * cfg["team"]


def _bn254_signers(m):
    sks = [int.from_bytes(hashlib.sha256(b"cuda-bn254-%d" % i).digest(), "big") % bn.R
           for i in range(m)]
    msgs = [b"cuda-bn254-vote-%d" % i for i in range(m)]
    return sks, [bn.public_key(sk) for sk in sks], msgs, [bn.sign(sk, x) for sk, x in zip(sks, msgs)]


def test_bn254_aggregate_is_one_launch_a_chunk(cuda, monkeypatch):
    sks, pubs, msgs, sigs = _bn254_signers(7)
    total = None
    for s in sigs:
        total = bn._g2_add(total, bn.g2_unmarshal(s))
    agg = bn.g2_compress(total)
    be = bk.Bn254DeviceBackend()
    before = _build.LAUNCHES["bn254"]
    assert be.aggregate_verify(pubs, msgs, agg) is True
    assert _build.LAUNCHES["bn254"] == before + 1
    monkeypatch.setattr(bk, "MAX_LANES", 3)  # 8 lanes in chunks of 3
    assert be.aggregate_verify(pubs, list(reversed(msgs)), agg) is False
    assert _build.LAUNCHES["bn254"] == before + 1 + 3


def test_bn254_backend_defaults_to_cuda(cuda):
    be = bk.Bn254DeviceBackend()
    assert be.device.type == "cuda" and be.ping()
    sks, pubs, msgs, sigs = _bn254_signers(4)
    sigs[1] = bn.sign(sks[1], b"another-vote")
    before = _build.LAUNCHES["bn254"]
    assert be.batch_verify(pubs, msgs, sigs) == (False, [True, False, True, True])
    assert _build.LAUNCHES["bn254"] == before + 1


@pytest.mark.parametrize("chunk", [4, 256])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 255, 256, 257, 1000, 1025, 65_536])
def test_sha256_digests_entry_matches_plain(cuda, n, chunk):
    """The digests entry (K6) at ragged counts: the root equal to the plain
    version word for word and to the host tree, two launches."""
    dg = sharded.make_example_leaves(n, cuda)
    before = _build.LAUNCHES["sha256"]
    got = mk.digest_tree_root(dg, chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sha256"] == before + 2
    assert torch.equal(got.cpu(), mk.digest_tree_root_plain(dg.cpu()))
    assert mk._root_bytes(got) == hash_from_byte_slices(sharded.example_txs(n))
    if n & (n - 1) == 0:
        assert mk.merkle_root_pow2(dg) == mk._root_bytes(got)


def _each_kernel(dev):
    """Every kernel launched once on ``dev``, each result equal to its plain
    version on the same inputs; returns the launches counted."""
    seeds = [hashlib.sha256(b"device-key-%d" % i).digest() for i in range(5)]
    pubs = [pure.public_key(x) for x in seeds]
    msgs = [b"device-vote-%d" % i for i in range(5)]
    sigs = [pure.sign(x, p, m) for x, p, m in zip(seeds, pubs, msgs)]
    a_w, r_w, s_w, msg_w, msg_nb = ek.operands_to_device(ek.pack_batch(pubs, msgs, sigs, 1)[0], dev)
    dg = sharded.make_example_leaves(300, dev)  # one sha256 leaf launch, before the count
    before = dict(_build.LAUNCHES)
    s_dig, k_dig = s5.challenge_digits(msg_w, msg_nb, s_w)
    assert torch.equal(torch.stack([s_dig, k_dig]),
                       torch.stack(s5.challenge_digits_plain(msg_w, msg_nb, s_w)))
    pt, ok = ed.decompress_words(a_w, r_w)
    assert torch.equal(_canon(pt), _canon(ed.decompress_words_plain(a_w, r_w)[0]))
    verdict = ladder.verify_lanes(s_dig, k_dig, pt, ok)
    assert verdict.tolist() == ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)[0].tolist()
    assert verdict.all()
    flat, offsets = mk.pack_leaves([b"device-tx-%d" % i for i in range(300)], dev)
    assert torch.equal(mk.tree_root(flat, offsets), mk.tree_root_plain(flat, offsets))
    assert torch.equal(mk.digest_tree_root(dg), mk.digest_tree_root_plain(dg))
    ops = bk.operands_to_device(bk._pack(_bn254_lanes(8), 8), dev)
    got, want = bk.miller_values(*ops), bk.miller_values_plain(*ops)
    assert (bk.limbs_to_ints(got.cpu().numpy()) == bk.limbs_to_ints(want.cpu().numpy())).all()
    torch.cuda.synchronize(dev)
    return {k: _build.LAUNCHES[k] - before[k] for k in before}


def _in_thread(current: int, target: int) -> dict:
    """_each_kernel on cuda:target from a new thread whose current device
    is set to cuda:current first."""
    box = {}

    def run():
        try:
            torch.cuda.set_device(current)
            box["launches"] = _each_kernel(torch.device("cuda", target))
            box["current"] = torch.cuda.current_device()
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in box:
        raise box["error"]
    assert box["current"] == current  # the launches left the thread's device as set
    return box["launches"]


WANT_EACH = {"sha512": 1, "decompress": 1, "ladder": 1, "sha256": 4, "bn254": 1}


@pytest.mark.parametrize("placement", ["same", "other"])
def test_every_kernel_launches_on_its_tensors_device(cuda, placement):
    """From a thread whose current device was set explicitly: on that
    device, and (with two cards) on cuda:1 while cuda:0 is current."""
    if placement == "same":
        assert _in_thread(0, 0) == WANT_EACH
        return
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: launching on cuda:1 with cuda:0 current")
    assert _in_thread(0, 1) == WANT_EACH


def test_lane_split_programs_on_two_virtual_shards(cuda):
    """K1 to K4 on make_mesh([cuda:0, cuda:0]): each shard's three verify
    launches and two sha256 launches a subtree root; the same bitmap,
    all-valid bit and root as the one-device path and the host tree."""
    mesh = sharded.make_mesh([cuda, cuda])
    ops = sharded.make_example_batch(16, cuda)
    one = ek.verify_operands(ops)
    before = dict(_build.LAUNCHES)
    ok = sharded.sharded_verify_fn(mesh)(*ops)
    assert {k: _build.LAUNCHES[k] - before[k] for k in ("sha512", "decompress", "ladder")} == {
        "sha512": 2, "decompress": 2, "ladder": 2}
    assert torch.equal(ok, one) and ok.all()
    assert torch.equal(sharded.sharded_verify_replicated_fn(mesh)(*ops), one)
    txs = sharded.example_txs(1024)
    want = hash_from_byte_slices(txs)
    leaves = sharded.make_example_leaves(1024, cuda)
    before = _build.LAUNCHES["sha256"]
    assert mk._root_bytes(sharded.sharded_merkle_fn(mesh)(leaves)) == want
    assert _build.LAUNCHES["sha256"] == before + 6  # two a subtree, two the top
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in txs])
    assert mk._root_bytes(sharded.sharded_leaves_to_root_fn(mesh)(blocks, nblocks)) == want
    ok2, all_valid, root = sharded.sharded_commit_step_fn(mesh)(*ops, leaves)
    assert torch.equal(ok2, one) and bool(all_valid) and mk._root_bytes(root) == want


def test_mesh_routes_over_every_card(cuda, monkeypatch):
    """On a host with two or more cards, the routing width is the card
    count: TorchBackend's verify (one launch of each verify kernel a card),
    its root of a power-of-two forest past CMTPU_MESH_MERKLE_FLOOR (three
    sha256 launches a card and two for the top) and a BN254 aggregate (one
    bn254 launch a card) give the exact answers, and the counters step."""
    w = torch.cuda.device_count()
    if w < 2:
        pytest.skip("needs two CUDA devices: the routing width is 1 on one card")
    monkeypatch.delenv("CMTPU_MESH_FLOOR", raising=False)
    monkeypatch.setenv("CMTPU_MESH_MERKLE_FLOOR", "16")
    be = TorchBackend()
    assert be.mesh_width() == ek.mesh_width() == w and bk.mesh_width() == w
    seeds = [hashlib.sha256(b"cards-key-%d" % i).digest() for i in range(200)]
    pubs = [pure.public_key(x) for x in seeds]
    msgs = [b"cards-vote-%d" % i for i in range(200)]
    sigs = [pure.sign(x, p, m) for x, p, m in zip(seeds, pubs, msgs)]
    sigs[123] = sigs[123][:40] + bytes([sigs[123][40] ^ 1]) + sigs[123][41:]
    counters, before = ek.mesh_counters(), dict(_build.LAUNCHES)
    assert be.batch_verify(pubs, msgs, sigs) == (False, [i != 123 for i in range(200)])
    leaves = [b"cards-tx-%d" % i for i in range(1024)]
    assert be.merkle_root(leaves) == hash_from_byte_slices(leaves)
    pow2 = w & (w - 1) == 0  # the subtree route takes power-of-two widths only
    delta = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert delta == {"sha512": w, "decompress": w, "ladder": w,
                     "sha256": 3 * w + 2 if pow2 else 2, "bn254": 0}
    after = ek.mesh_counters()
    assert after["sharded_dispatches"] == counters["sharded_dispatches"] + 1
    assert after["merkle_sharded_dispatches"] == counters["merkle_sharded_dispatches"] + pow2
    assert after["devices"] == w
    sks, bpubs, bmsgs, bsigs = _bn254_signers(7)
    total = None
    for x in bsigs:
        total = bn._g2_add(total, bn.g2_unmarshal(x))
    split, launches = bk.counters()["sharded_dispatches"], _build.LAUNCHES["bn254"]
    assert bk.Bn254DeviceBackend().aggregate_verify(bpubs, bmsgs, bn.g2_compress(total)) is True
    assert bk.counters()["sharded_dispatches"] == split + 1
    assert _build.LAUNCHES["bn254"] == launches + w
