"""The port's BN254 aggregate-commit path against the JAX package, exactly
(every value here is an integer):

- the host copy (``crypto/bn254_pure``) against ``cometbft_tpu.crypto.bn254``
  on seeded inputs and on the reference's malformed-encoding cases;
- the plain Miller program (``ops/bn254_kernel.miller_values_plain``)
  against the reference's JAX program at bucket 8 on the same packed
  operands (the reference's ``_pack``, carried across by ``convert``):
  limb-identical; the kernel's team schedule (``ops/bn254_schedule``'s
  model) equal mod P; ``multi_miller_values`` equal as ints, a lane at
  infinity included;
- ``Bn254DeviceBackend(device="cpu")`` decisions against the reference host
  engine (``verify_aggregate``, ``batch_verify_signatures``);
- the reference seam: the port's own chain (``crypto/bn254.build_bn254_chain``
  under the port's ``ResilientBackend``, its device tier first) installed by
  the reference's ``bn254.set_bn254_backend``, under
  ``types.validation.verify_commit`` on an aggregate commit.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bn254 as ref
from cometbft_tpu.ops import bn254_kernel as jbk
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bn254_pure as pure
from cometbft_tpu_torch.ops import bn254_kernel as tbk
from cometbft_tpu_torch.ops import bn254_schedule as tbs

pytestmark = pytest.mark.torch_port

P = pure.P


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain program is ~10,000 small tensor ops: one thread runs it
    faster than eight, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scalar(tag: str, i: int) -> int:
    return int.from_bytes(hashlib.sha256(b"bn254-port-%s-%d" % (tag.encode(), i)).digest(), "big") % pure.R


@pytest.fixture(scope="module")
def signers():
    """Seven signers (seeded scalars), distinct messages, port signatures."""
    sks = [_scalar("signer", i) for i in range(7)]
    pubs = [pure.public_key(sk) for sk in sks]
    msgs = [b"bn254-vote-%d" % i for i in range(7)]
    sigs = [pure.sign(sk, m) for sk, m in zip(sks, msgs)]
    return sks, pubs, msgs, sigs


def _off_subgroup_point():
    """An on-curve twist point outside the r-torsion: try-and-increment's
    point before the cofactor is cleared."""
    x = (5, 1)
    while True:
        y = pure._f2_sqrt(pure.f2_add(pure.f2_mul(pure.f2_sqr(x), x), pure.B2))
        if y is not None and pure._g2_mul(pure.R, (x, y)) is not None:
            return (x, y)
        x = (x[0] + 1, 1)


# -- the host copy against the reference --------------------------------------


HOST_FUNCTIONS = ["hash_to_g2", "g1_decompress", "g2_decompress", "g2_unmarshal",
                  "final_exponentiation_fast", "g2_frobenius", "batch_weights", "keys_and_signatures"]


@pytest.mark.parametrize("fn", HOST_FUNCTIONS)
def test_host_copy_matches_reference(signers, fn):
    sks, pubs, msgs, sigs = signers
    if fn == "hash_to_g2":
        for m in (b"", b"bn254-vote-0", bytes(range(200))):
            assert pure._hash_to_g2(m) == ref._hash_to_g2(m)
    elif fn == "g1_decompress":
        for pk in pubs + [pure.g1_compress(None), pure.g1_compress(pure.G1)]:
            assert pure.g1_decompress(pk) == ref.g1_decompress(pk)
        flags = {pk[0] >> 6 for pk in pubs}
        assert flags == {0b10, 0b11}, "seeded keys should carry both y flags"
    elif fn == "g2_decompress":
        comps = [pure.g2_compress(pure.g2_unmarshal(s)) for s in sigs[:4]]
        assert {c[0] >> 6 for c in comps} == {0b10, 0b11}
        for c in comps + [pure.g2_compress(None)]:
            q = pure.g2_decompress(c)
            assert q == ref.g2_decompress(c)
            assert pure.g2_compress(q) == ref.g2_compress(q) == c
    elif fn == "g2_unmarshal":
        for s in sigs[:3] + [bytes(128), pure.g2_marshal(pure.G2)]:
            assert pure.g2_unmarshal(s) == ref.g2_unmarshal(s)
    elif fn == "final_exponentiation_fast":
        rng = np.random.default_rng(11)
        f = tuple((int(rng.integers(0, 2**62)) * 3**90 % P, int(rng.integers(0, 2**62)) * 7**80 % P)
                  for _ in range(6))
        assert pure.final_exponentiation_fast(f) == ref.final_exponentiation_fast(f)
        ml = pure.multi_miller_loop([(pure.G1, pure.G2)])
        assert ml == ref.multi_miller_loop([(ref.G1, ref.G2)])
        assert pure.final_exponentiation_fast(ml) == ref.final_exponentiation_fast(ml)
    elif fn == "g2_frobenius":
        pts = [pure.G2, pure.g2_unmarshal(sigs[0]), ((0, 0), (1, P - 1)), None]
        for q in pts:
            assert pure._g2_frobenius(q) == ref._g2_frobenius(q)
            assert pure._g2_neg(pure._g2_frobenius(pure._g2_frobenius(q))) == ref._g2_neg(
                ref._g2_frobenius(ref._g2_frobenius(q)))
    elif fn == "batch_weights":
        assert pure._batch_weights(pubs, msgs, sigs) == ref._batch_weights(pubs, msgs, sigs)
        assert pure._batch_weights([], [], []) == ref._batch_weights([], [], [])
    else:
        for sk, pk, m, s in list(zip(sks, pubs, msgs, sigs))[:2]:
            priv = ref.PrivKey(sk.to_bytes(32, "big"))
            assert priv.pub_key().bytes() == pk
            assert priv.sign(m) == s


MALFORMED = ["g1-infinity", "g1-length-31", "g1-off-curve", "g1-x-ge-p", "g2-bad-infinity",
             "g2-flag-bare", "g2-flag-flipped", "g2-length-63", "g2-length-65", "g2-x-corrupt",
             "g2u-coordinate-ge-p", "g2u-length-127", "g2u-off-curve", "g2u-off-subgroup"]


@pytest.fixture(scope="module")
def malformed():
    """(function, encoding) for each case: the reference's tampered
    encodings (tests/test_agg_commits.py) and the range, curve and subgroup
    rejections of its decoders."""
    sig = pure.sign(_scalar("malformed", 0), b"m")
    comp = bytes(pure.g2_compress(pure.g2_unmarshal(sig)))

    def flip(b, i, mask):
        out = bytearray(b)
        out[i] ^= mask
        return bytes(out)

    big = (P + 5).to_bytes(32, "big")
    g1_off = next(x for x in range(2, 50) if pow((x**3 + 3) % P, (P - 1) // 2, P) != 1)
    return {
        "g1-infinity": ("g1_decompress", bytes([0x40]) + bytes(31)),
        "g1-length-31": ("g1_decompress", bytes(31)),
        "g1-off-curve": ("g1_decompress", bytes([0x80]) + g1_off.to_bytes(32, "big")[1:]),
        "g1-x-ge-p": ("g1_decompress", bytes([big[0] | 0x80]) + big[1:]),
        "g2-bad-infinity": ("g2_decompress", bytes([0x40]) + bytes(62) + b"\x01"),
        "g2-flag-bare": ("g2_decompress", bytes([comp[0] & 0x3F]) + comp[1:]),
        "g2-flag-flipped": ("g2_decompress", flip(comp, 0, 0x40)),
        "g2-length-63": ("g2_decompress", bytes(63)),
        "g2-length-65": ("g2_decompress", bytes(65)),
        "g2-x-corrupt": ("g2_decompress", flip(comp, 40, 0xFF)),
        "g2u-coordinate-ge-p": ("g2_unmarshal", big + sig[32:]),
        "g2u-length-127": ("g2_unmarshal", bytes(127)),
        "g2u-off-curve": ("g2_unmarshal", flip(sig, 127, 1)),
        "g2u-off-subgroup": ("g2_unmarshal", pure.g2_marshal(_off_subgroup_point())),
    }


@pytest.mark.parametrize("case", MALFORMED)
def test_host_copy_rejects_malformed_encodings_like_reference(malformed, case):
    fn, enc = malformed[case]

    def outcome(mod):
        try:
            return ("value", getattr(mod, fn)(enc))
        except ValueError:
            return ("raises", None)

    got, want = outcome(pure), outcome(ref)
    assert got == want
    if case not in ("g2-flag-flipped", "g1-infinity"):
        assert want == ("raises", None)


# -- the plain program against the JAX program ----------------------------------


def _lanes():
    """Eight lanes: three multiples of (G1, G2), a signer-shaped lane, and
    edge coordinates (0, 1, P - 1, an off-curve pair): the formulas are
    polynomials, so both sides must agree on them too."""
    lanes = []
    p, q = pure.G1, pure.G2
    for _ in range(3):
        lanes.append((p, q))
        p, q = pure._g1_add(p, pure.G1), pure._g2_add(q, pure.G2)
    pk = pure.g1_decompress(pure.public_key(_scalar("lane", 0)))
    lanes.append(((pk[0], (P - pk[1]) % P), pure._hash_to_g2_cached(b"lane-msg")))
    lanes.append(((0, 0), ((0, 0), (0, 0))))
    lanes.append(((1, P - 1), ((P - 1, 1), (1, 0))))
    lanes.append(((P - 1, 1), ((1, 1), (P - 1, P - 1))))
    lanes.append(((5, 7), ((11, 13), (17, 19))))
    return lanes


@pytest.fixture(scope="module")
def jax_program():
    """The reference's packed operands and its program's output at bucket 8
    (XLA:CPU in float64; one compile for the module)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CMTPU_BN254_DEVICE", "1")
        assert jbk.device_available()
    lanes = _lanes()
    operands = jbk._pack(lanes, 8, np)
    with jbk._x64(jbk._tables().jax):
        out = np.asarray(jbk._program(8)(*operands))
    return lanes, operands, out


def test_pack_is_operand_identical(jax_program):
    lanes, operands, _ = jax_program
    for got, want in zip(tbk._pack(lanes, 8), operands):
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    assert tbk._LADDER == jbk._LADDER and tbk.MAX_LANES == jbk.MAX_LANES == 8192
    assert [tbk.bucket_for(n) for n in (1, 8, 9, 2049, 10_241)] == [8, 8, 16, 4096, 8192]


def test_plain_program_is_limb_identical_to_jax(jax_program):
    lanes, operands, want = jax_program
    got = tbk.miller_values_plain(*convert.bn254_operands_from_jax(operands))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape == (8, 6, 2, 13)
    assert np.array_equal(got.numpy(), want)
    values = convert.bn254_values_from_jax(want)
    assert values == [jbk._unpack_lane(want, lane) for lane in range(8)]
    assert values == [tbk._unpack_lane(want, lane) for lane in range(8)]
    back = convert.bn254_values_to_jax(values)
    assert convert.bn254_values_from_jax(back) == values
    # a lane's Miller value is the host loop's up to the Fp2 line scalings,
    # which the final exponentiation kills
    for lane in (0, 3):
        assert pure.final_exponentiation_fast(values[lane]) == pure.final_exponentiation_fast(
            pure.multi_miller_loop([lanes[lane]]))


def test_team_model_equals_reference_program(jax_program):
    """The kernel's team schedule, run over Python ints, against the
    reference's program on the same lanes: equal mod P on every lane."""
    lanes, _, want = jax_program
    assert tbs.miller_values_model(lanes) == convert.bn254_values_from_jax(want)


def test_multi_miller_values_equal_reference_with_a_lane_at_infinity(jax_program, monkeypatch):
    # the reference at mesh width 1, as the port is (the eight virtual
    # devices tests/conftest.py sets up would make it shard the bucket)
    monkeypatch.setattr(jbk, "mesh_width", lambda: 1)
    lanes = _lanes()[:6]
    pairs = lanes[:2] + [(None, pure.G2), (pure.G1, None)] + lanes[2:]
    before = tbk.counters()
    got = tbk.multi_miller_values(pairs, device="cpu")
    assert got == jbk.multi_miller_values(pairs)
    assert got[2] == got[3] == pure.F12_ONE
    after = tbk.counters()
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["lanes"] == before["lanes"] + 6


# -- decisions against the reference host engine ---------------------------------


def test_aggregate_decisions_match_reference(signers):
    sks, pubs, msgs, sigs = signers
    agg = ref.aggregate_signatures_compressed(sigs)
    be = tbk.Bn254DeviceBackend(device="cpu")
    assert be.device.type == "cpu"
    cases = {
        "valid": (pubs, msgs, agg),
        "valid-uncompressed": (pubs, msgs, ref.aggregate_signatures(sigs)),
        "messages-swapped": (pubs, list(reversed(msgs)), agg),
        "signer-left-out": (pubs, msgs, ref.aggregate_signatures_compressed(sigs[:6])),
        "bad-length": (pubs, msgs, agg[:63]),
        "count-mismatch": (pubs[:6], msgs, agg),
    }
    got = {k: be.aggregate_verify(*v) for k, v in cases.items()}
    want = {k: ref.verify_aggregate(*v) for k, v in cases.items()}
    assert got == want
    assert got["valid"] and got["valid-uncompressed"] and sum(got.values()) == 2


def test_batch_verify_bitmap_matches_reference(signers):
    sks, pubs, msgs, sigs = signers
    pubs, msgs, sigs = list(pubs[:5]), list(msgs[:5]), list(sigs[:5])
    sigs[2] = pure.sign(sks[2], b"some-other-vote")  # a valid point, the wrong message
    pubs[4] = pubs[4][:31]  # malformed: a False lane that poisons nothing
    be = tbk.Bn254DeviceBackend(device="cpu")
    got = be.batch_verify(pubs, msgs, sigs)
    assert got == ref.batch_verify_signatures(pubs, msgs, sigs)
    assert got == (False, [True, True, False, True, False])
    assert be.batch_verify(pubs[:2], msgs[:2], sigs[:2]) == (True, [True, True])


# -- the reference seam -----------------------------------------------------------


def test_verify_commit_through_the_reference_seam():
    from cometbft_tpu_torch.crypto.bn254 import build_bn254_chain
    from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend
    from cometbft_tpu.types import BlockID, Commit, Vote
    from cometbft_tpu.types.block import PRECOMMIT_TYPE, aggregate_commit
    from cometbft_tpu.types.cmttime import Time
    from cometbft_tpu.types.part_set import PartSetHeader
    from cometbft_tpu.types.priv_validator import MockPV
    from cometbft_tpu.types.validation import verify_commit
    from cometbft_tpu.types.validator import Validator
    from cometbft_tpu.types.validator_set import ValidatorSet
    from cometbft_tpu.types.vote import vote_to_commit_sig

    chain, height = "torch-bn254-chain", 5
    bid = BlockID(b"h" * 32, PartSetHeader(1, b"p" * 32))
    pvs = [MockPV(ref.PrivKey(_scalar("validator", i).to_bytes(32, "big"))) for i in range(4)]
    vals = ValidatorSet([Validator.new(pv.get_pub_key(), 10) for pv in pvs])
    by_addr = {pv.address(): pv for pv in pvs}
    sigs = []
    for idx, val in enumerate(vals.validators):
        vote = Vote(type=PRECOMMIT_TYPE, height=height, round=0, block_id=bid,
                    timestamp=Time(1700000000 + idx, 0), validator_address=val.address,
                    validator_index=idx)
        sigs.append(vote_to_commit_sig(by_addr[val.address].sign_vote(chain, vote)))
    commit = Commit(height=height, round=0, block_id=bid, signatures=sigs)
    agg = aggregate_commit(commit, vals)
    assert agg.is_aggregate()
    poisoned = copy.deepcopy(agg)
    poisoned.agg_signature = ref.aggregate_signatures([cs.signature for cs in sigs[:3]])

    chain_backend = ResilientBackend(build_bn254_chain(device="cpu"), crosscheck="off")
    assert [t.name for t in chain_backend.tiers] == ["bn254-device", "bn254-host", "cpu"]
    before = tbk.counters()["dispatches"]
    ref.set_bn254_backend(chain_backend)
    try:
        verify_commit(chain, vals, bid, height, agg)
        with pytest.raises(ValueError, match="invalid aggregate signature"):
            verify_commit(chain, vals, bid, height, poisoned)
    finally:
        ref.set_bn254_backend(None)
    assert tbk.counters()["dispatches"] == before + 2
    assert chain_backend.counters_["degraded_calls"] == 0
