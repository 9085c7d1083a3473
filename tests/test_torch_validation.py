"""Commit verification in the port (``cometbft_tpu_torch/types/validation``)
against the reference's ``types/validation`` on the same commits, built in
the reference and carried across by wire bytes. The reference runs on its
``CpuBackend``, the port on ``TorchBackend(device="cpu")`` (the plain
PyTorch versions of the card's kernels); each mode must give the same
verdict, exception type and message, and reach its backend as often with
as many signatures. No tolerance."""

import hashlib

import pytest
import torch

from cometbft_tpu.crypto import bn254 as ref_bn
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import encoding as ref_encoding
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.types import block as rb
from cometbft_tpu.types import validation as ref_validation
from cometbft_tpu.types.cmttime import Time as RefTime
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu.types.vote import Vote as RefVote
from cometbft_tpu.types.vote import vote_to_commit_sig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bn254, ed25519
from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.types import block as pb
from cometbft_tpu_torch.types import validation

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernels are thousands of small tensor ops: one thread runs
    them faster than eight, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CHAIN_ID = "torch-validation-chain"
HEIGHT = 9
N = 8


class _Counting:
    """Records the size of each batch a backend is asked to verify. With a
    ``memo``, a batch this module has already sent is answered from it:
    many cases send the same triples, and each TorchBackend("cpu") call
    costs most of a second."""

    def __init__(self, inner, memo=None):
        self.inner = inner
        self.memo = memo
        self.batches: list[int] = []

    def batch_verify(self, pubs, msgs, sigs):
        self.batches.append(len(pubs))
        if self.memo is None:
            return self.inner.batch_verify(pubs, msgs, sigs)
        key = (tuple(pubs), tuple(msgs), tuple(sigs))
        if key not in self.memo:
            self.memo[key] = self.inner.batch_verify(pubs, msgs, sigs)
        return self.memo[key]

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


_TORCH_RESULTS: dict = {}


@pytest.fixture
def backends():
    """The reference on its CpuBackend, the port on TorchBackend("cpu"), both
    counted, both verified-triple caches empty; restored afterwards."""
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref = _Counting(ref_backend.CpuBackend())
    port = _Counting(backend.TorchBackend(device="cpu"), _TORCH_RESULTS)
    ref_backend.set_backend(ref)
    backend.set_backend(port)
    try:
        yield ref, port
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed._verified.clear()
        ed25519._verified.clear()


def _priv(i: int, kind: str = "ed25519"):
    secret = hashlib.sha256(b"torch-validation-key-%d" % i).digest()
    return ref_bn.PrivKey(secret) if kind == "bn254" else ref_ed.gen_priv_key_from_secret(secret)


def _block_id(tag: bytes = b"block") -> rb.BlockID:
    h = hashlib.sha256(tag).digest()
    return rb.BlockID(h, rb.PartSetHeader(2, hashlib.sha256(h).digest()))


def _fixture(kinds, powers=None, absent=(), height=HEIGHT):
    """A reference validator set of the given key kinds and a commit that
    each validator signs with its own canonical sign bytes (distinct
    nanos, as real precommits have), but the ``absent`` ones."""
    privs = [_priv(i, k) for i, k in enumerate(kinds)]
    powers = powers or [10] * len(kinds)
    vals = RefValidatorSet([RefValidator.new(p.pub_key(), w) for p, w in zip(privs, powers)])
    by_addr = {p.pub_key().address(): p for p in privs}
    block_id = _block_id()
    sigs = []
    for idx, v in enumerate(vals.validators):
        if idx in absent:
            sigs.append(rb.CommitSig.absent())
            continue
        vote = RefVote(type=rb.PRECOMMIT_TYPE, height=height, round=0, block_id=block_id,
                       timestamp=RefTime(1_700_000_000, 1_000 + 37 * idx),
                       validator_address=v.address, validator_index=idx)
        sig = by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
        sigs.append(vote_to_commit_sig(vote.with_signature(sig)))
    return vals, rb.Commit(height=height, round=0, block_id=block_id, signatures=sigs)


def _with_sig(commit: rb.Commit, idx: int, **changes) -> rb.Commit:
    sigs = list(commit.signatures)
    cs = sigs[idx]
    sigs[idx] = rb.CommitSig(changes.get("flag", cs.block_id_flag),
                             changes.get("address", cs.validator_address),
                             cs.timestamp, changes.get("signature", cs.signature))
    return rb.Commit(height=commit.height, round=commit.round, block_id=commit.block_id,
                     signatures=sigs, agg_signature=commit.agg_signature,
                     agg_bitmap=commit.agg_bitmap)


def _flipped(commit: rb.Commit, idx: int) -> rb.Commit:
    bad = bytearray(commit.signatures[idx].signature)
    bad[3] ^= 0x10
    return _with_sig(commit, idx, signature=bytes(bad))


def _port_set(vals: RefValidatorSet):
    return convert.validator_set_from_wire(
        [(ref_encoding.pub_key_to_proto(v.pub_key), v.voting_power) for v in vals.validators])


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def _both(mode: str, vals, commit, height=HEIGHT, block_id=None):
    """One mode on each side, caches cleared first: (reference outcome,
    port outcome)."""
    block_id = commit.block_id if block_id is None else block_id
    port_vals, port_commit = _port_set(vals), convert.commit_from_wire(commit.encode())
    port_bid = pb.BlockID.decode(block_id.encode())
    ref_ed._verified.clear()
    ed25519._verified.clear()
    if mode == "trusting":
        ref = _outcome(lambda: ref_validation.verify_commit_light_trusting(
            CHAIN_ID, vals, commit, ref_validation.Fraction(1, 3)))
        port = _outcome(lambda: validation.verify_commit_light_trusting(
            CHAIN_ID, port_vals, port_commit, validation.Fraction(1, 3)))
    else:
        name = "verify_commit" if mode == "commit" else "verify_commit_light"
        ref = _outcome(lambda: getattr(ref_validation, name)(CHAIN_ID, vals, block_id, height, commit))
        port = _outcome(lambda: getattr(validation, name)(
            CHAIN_ID, port_vals, port_bid, height, port_commit))
    return ref, port


MODES = ("commit", "light", "trusting")
VALS, GOOD = _fixture(["ed25519"] * N)
# 5 of 8 equal powers signed: 50 is not more than 2/3 of 80
_, INSUFFICIENT = _fixture(["ed25519"] * N, absent=(1, 4, 6))


def _case(name: str):
    """(vals, commit, height, block_id) of each case over the 8-validator set."""
    if name == "good":
        return VALS, GOOD, HEIGHT, None
    if name.startswith("bad_"):
        return VALS, _flipped(GOOD, {"bad_first": 0, "bad_middle": N // 2, "bad_last": N - 1}[name]), \
            HEIGHT, None
    if name == "insufficient_power":
        return VALS, INSUFFICIENT, HEIGHT, None
    if name == "wrong_height":
        return VALS, GOOD, HEIGHT + 1, None
    if name == "wrong_block_id":
        return VALS, GOOD, HEIGHT, _block_id(b"other")
    if name == "wrong_set_size":
        return RefValidatorSet([v.copy() for v in VALS.validators[:-1]]), GOOD, HEIGHT, None
    if name == "double_vote":
        return VALS, _with_sig(GOOD, 2, address=VALS.validators[0].address), HEIGHT, None
    raise KeyError(name)


CASES = ("good", "bad_first", "bad_middle", "bad_last", "insufficient_power", "wrong_height",
         "wrong_block_id", "wrong_set_size", "double_vote")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_modes_agree_with_the_reference(backends, case, mode):
    vals, commit, height, block_id = _case(case)
    ref_be, port_be = backends
    ref, port = _both(mode, vals, commit, height, block_id)
    assert port == ref
    # one backend call per uncached commit, with the same lanes
    assert port_be.batches == ref_be.batches
    assert len(port_be.batches) <= 1
    if case == "good":
        assert ref is None and port_be.batches
    if case.startswith("bad_") and ref is not None:
        assert ref[1].startswith("wrong signature (#%d)" % {"bad_first": 0, "bad_middle": N // 2,
                                                            "bad_last": N - 1}[case])


def test_batch_error_names_the_lowest_bad_index(backends):
    """Several bad signatures: the error names the lowest, read from the
    backend's bitmap."""
    bad = _flipped(_flipped(_flipped(GOOD, 6), 2), 5)
    ref, port = _both("commit", VALS, bad)
    assert port == ref and port[1].startswith("wrong signature (#2): ")


def test_light_checks_stop_at_quorum_and_reuse_the_cache(backends):
    """The light mode stops at quorum (6 of 8 at equal power); the trusting
    mode's 3 are then all served by the cache, with no backend call; and
    VerifyCommit, which checks every signature, sends only the other 2."""
    ref_be, port_be = backends
    port_vals, port_commit = _port_set(VALS), convert.commit_from_wire(GOOD.encode())
    ed25519._verified.clear()
    validation.verify_commit_light(CHAIN_ID, port_vals, port_commit.block_id, HEIGHT, port_commit)
    validation.verify_commit_light_trusting(CHAIN_ID, port_vals, port_commit, validation.Fraction(1, 3))
    validation.verify_commit(CHAIN_ID, port_vals, port_commit.block_id, HEIGHT, port_commit)
    assert port_be.batches == [6, 2]


@pytest.mark.parametrize("bad", [False, True])
def test_one_signature_takes_the_single_engine(backends, bad):
    vals, commit = _fixture(["ed25519"])
    if bad:
        commit = _flipped(commit, 0)
    ref_be, port_be = backends
    for mode in MODES:
        ref, port = _both(mode, vals, commit)
        assert port == ref and (ref is None) is not bad
    assert port_be.batches == ref_be.batches == []


@pytest.mark.parametrize("bad", [False, True])
def test_mixed_key_set_takes_the_single_engine(backends, bad):
    """ed25519 and bn254 keys in one set: never the batch engine; a bad
    ed25519 signature is named by its index."""
    vals, commit = _fixture(["ed25519", "bn254", "ed25519", "ed25519"])
    if bad:
        idx = max(i for i, v in enumerate(vals.validators) if v.pub_key.type() == "ed25519")
        commit = _flipped(commit, idx)
    ref_be, port_be = backends
    ref, port = _both("commit", vals, commit)
    assert port == ref and (ref is None) is not bad
    assert port_be.batches == ref_be.batches == []


@pytest.fixture
def bn254_backends():
    ref_prev, port_prev = ref_bn._backend, bn254._backend
    ref_bn.set_bn254_backend(ref_bn.Bn254HostBackend())
    bn254.set_bn254_backend(Bn254DeviceBackend(device="cpu"))
    try:
        yield
    finally:
        ref_bn.set_bn254_backend(ref_prev)
        bn254.set_bn254_backend(port_prev)


def test_aggregate_commit_accepts_and_rejects(bn254_backends):
    """Four BN254 validators, one absent: the aggregate verifies through the
    port's BN254 device backend (its plain Miller program here); one signer
    over the wrong sign bytes makes both sides raise the same error."""
    kinds = ["bn254"] * 4
    vals, per_vote = _fixture(kinds, absent=(2,))
    agg = rb.aggregate_commit(per_vote, vals)
    assert agg.is_aggregate()
    ref, port = _both("commit", vals, agg)
    assert ref is None and port is None
    # a signer that signed other bytes: same bitmap, wrong aggregate
    signer = next(p for p in (_priv(i, "bn254") for i in range(4))
                  if p.pub_key().address() == vals.validators[1].address)
    wrong = signer.sign(b"not the sign bytes")
    bad = rb.aggregate_commit(_with_sig(per_vote, 1, signature=wrong), vals)
    ref, port = _both("commit", vals, bad)
    assert ref is not None and port == ref
    assert port[1] == f"invalid aggregate signature for commit at height {HEIGHT}"
    # the aggregate path's structural rules, on both sides
    absent_signed = rb.Commit(height=HEIGHT, round=0, block_id=agg.block_id,
                              signatures=agg.signatures, agg_signature=agg.agg_signature,
                              agg_bitmap=bytes([agg.agg_bitmap[0] | 0b100]))
    ref, port = _both("light", vals, absent_signed)
    assert port == ref == ("ValueError", "aggregate bitmap set for absent CommitSig #2")
