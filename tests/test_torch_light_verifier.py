"""The port's light verifier (``cometbft_tpu_torch/light/verifier.py``)
against the reference's on a short chain built in the reference and carried
across by wire bytes: adjacent and skipping hops over the same set and over
a changed set, a hop the trusted set cannot trust, an expired trusted
header, a header from another set, and the backwards hash chain. The
reference runs on its ``CpuBackend``, the port on ``TorchBackend("cpu")``;
verdicts, exception types and messages must be equal, and each hop must
send the same batches (the light check of a skipping hop sends only what
the trusting check left out of the cache)."""

import hashlib

import pytest
import torch

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import encoding as ref_encoding
from cometbft_tpu.light import verifier as ref_verifier
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.types import block as rb
from cometbft_tpu.types import validation as ref_validation
from cometbft_tpu.types.cmttime import Time as RefTime
from cometbft_tpu.types.validator import Validator as RefValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RefValidatorSet
from cometbft_tpu.types.vote import Vote as RefVote
from cometbft_tpu.types.vote import vote_to_commit_sig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.types import Time, validation

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernels are thousands of small tensor ops: one thread runs
    them faster than eight, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CHAIN_ID = "torch-light-chain"
T0 = 1_700_000_000
HOUR_NS = 3600 * 10**9
TRUSTING_PERIOD_NS = 24 * HOUR_NS
DRIFT_NS = 10 * 10**9

PRIVS = [ref_ed.gen_priv_key_from_secret(hashlib.sha256(b"torch-light-%d" % i).digest())
         for i in range(14)]
BY_ADDR = {p.pub_key().address(): p for p in PRIVS}


def _set(indices) -> RefValidatorSet:
    return RefValidatorSet([RefValidator.new(PRIVS[i].pub_key(), 10) for i in indices])


SET_A = _set(range(8))
SET_B = _set(list(range(5)) + [8, 9, 10])  # 5 of A's 8 stay: over 1/3 of A
SET_C = _set([0, 1, 11, 12, 13])  # 2 of A's 8 stay: not over 1/3 of A


def _signed_header(height: int, vals, next_vals, last_block_id=None) -> rb.SignedHeader:
    header = rb.Header(
        version=rb.Consensus(11, 1), chain_id=CHAIN_ID, height=height,
        time=RefTime(T0 + 60 * height, 0), last_block_id=last_block_id or rb.BlockID(),
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        app_hash=hashlib.sha256(b"app-%d" % height).digest(),
        proposer_address=vals.get_proposer().address,
    )
    block_id = rb.BlockID(header.hash(), rb.PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
    sigs = []
    for idx, v in enumerate(vals.validators):
        vote = RefVote(type=rb.PRECOMMIT_TYPE, height=height, round=0, block_id=block_id,
                       timestamp=RefTime(T0 + 60 * height + 1, 500 + 11 * idx),
                       validator_address=v.address, validator_index=idx)
        sig = BY_ADDR[v.address].sign(vote.sign_bytes(CHAIN_ID))
        sigs.append(vote_to_commit_sig(vote.with_signature(sig)))
    return rb.SignedHeader(header, rb.Commit(height=height, round=0, block_id=block_id,
                                             signatures=sigs))


H1 = _signed_header(1, SET_A, SET_A)
H2 = _signed_header(2, SET_A, SET_A, H1.commit.block_id)
H5 = _signed_header(5, SET_A, SET_B)
H6 = _signed_header(6, SET_B, SET_B)
H7 = _signed_header(7, SET_C, SET_C)


def _port(sh: rb.SignedHeader):
    return convert.signed_header_from_wire(sh.encode())


def _port_set(vals: RefValidatorSet):
    return convert.validator_set_from_wire(
        [(ref_encoding.pub_key_to_proto(v.pub_key), v.voting_power) for v in vals.validators])


class _Counting:
    def __init__(self, inner):
        self.inner = inner
        self.batches: list[int] = []

    def batch_verify(self, pubs, msgs, sigs):
        self.batches.append(len(pubs))
        return self.inner.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


@pytest.fixture
def backends():
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref, port = _Counting(ref_backend.CpuBackend()), _Counting(backend.TorchBackend(device="cpu"))
    ref_backend.set_backend(ref)
    backend.set_backend(port)
    try:
        yield ref, port
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed._verified.clear()
        ed25519._verified.clear()


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def _hop(trusted, trusted_vals, untrusted, untrusted_vals, now_s: int):
    """``verify`` on both sides with empty caches: (reference, port)."""
    ref_ed._verified.clear()
    ed25519._verified.clear()
    ref = _outcome(lambda: ref_verifier.verify(
        trusted, trusted_vals, untrusted, untrusted_vals, TRUSTING_PERIOD_NS,
        RefTime(now_s, 0), DRIFT_NS))
    args = (_port(trusted), _port_set(trusted_vals), _port(untrusted), _port_set(untrusted_vals))
    port = _outcome(lambda: verifier.verify(
        args[0], args[1], args[2], args[3], TRUSTING_PERIOD_NS, Time(now_s, 0), DRIFT_NS))
    return ref, port


NOW = T0 + 3600

HOPS = {
    # name: (trusted, trusted set, untrusted, untrusted set, now, verdict)
    "adjacent": (H1, SET_A, H2, SET_A, NOW, None),
    "skipping_same_set": (H1, SET_A, H5, SET_A, NOW, None),
    "skipping_changed_set": (H1, SET_A, H6, SET_B, NOW, None),
    "cannot_trust": (H1, SET_A, H7, SET_C, NOW, "ErrNewValSetCantBeTrusted"),
    "expired": (H1, SET_A, H5, SET_A, T0 + 2 * TRUSTING_PERIOD_NS // 10**9, "ErrOldHeaderExpired"),
    "wrong_set": (H1, SET_A, H6, SET_A, NOW, "ErrInvalidHeader"),
    "adjacent_changed_set": (H5, SET_A, H6, SET_B, NOW, None),
    "adjacent_next_mismatch": (H1, SET_A, _signed_header(2, SET_B, SET_B), SET_B, NOW,
                               "ErrInvalidHeader"),
    "from_the_future": (H1, SET_A, H5, SET_A, T0, "ErrInvalidHeader"),
}


@pytest.mark.parametrize("name", list(HOPS))
def test_hops_agree_with_the_reference(backends, name):
    trusted, tvals, untrusted, uvals, now_s, verdict = HOPS[name]
    ref_be, port_be = backends
    ref, port = _hop(trusted, tvals, untrusted, uvals, now_s)
    assert port == ref
    assert (None if ref is None else ref[0]) == verdict
    assert port_be.batches == ref_be.batches
    if name == "skipping_same_set":
        # trusting: 3 of 8 (over 1/3); light: 6 of 8, 3 of them cached
        assert port_be.batches == [3, 3]


def test_verify_backwards_and_trust_level():
    assert _outcome(lambda: verifier.verify_backwards(_port(H1).header, _port(H2).header)) is None
    for older, newer in ((H2, H1), (H5, H2), (_signed_header(1, SET_B, SET_B), H2)):
        ref = _outcome(lambda: ref_verifier.verify_backwards(older.header, newer.header))
        port = _outcome(lambda: verifier.verify_backwards(_port(older).header, _port(newer).header))
        assert ref is not None and port == ref
    for num, den in ((1, 3), (2, 3), (1, 1), (1, 4), (4, 3), (1, 0)):
        ref = _outcome(lambda: ref_verifier.validate_trust_level(ref_verifier.Fraction(num, den)))
        port = _outcome(lambda: verifier.validate_trust_level(verifier.Fraction(num, den)))
        assert port == ref
    now = Time(T0 + TRUSTING_PERIOD_NS // 10**9 + 60, 0)
    assert verifier.header_expired(_port(H1), TRUSTING_PERIOD_NS, now) == ref_verifier.header_expired(
        H1, TRUSTING_PERIOD_NS, RefTime(now.seconds, 0))


@pytest.mark.parametrize("hop", ["skipping_same_set", "skipping_changed_set", "adjacent"])
def test_speculative_triples_equal_the_reference(hop):
    """The prefix of triples a hop's checks will verify, for prewarming the
    cache: the same keys, sign bytes and signatures in the same order."""
    trusted, tvals, untrusted, uvals, _, _ = HOPS[hop]
    level = None if hop == "adjacent" else (1, 3)
    ref = ref_validation.speculative_verify_triples(
        CHAIN_ID, tvals, uvals, untrusted.commit,
        None if level is None else ref_validation.Fraction(*level))
    port = validation.speculative_verify_triples(
        CHAIN_ID, _port_set(tvals), _port_set(uvals), _port(untrusted).commit,
        None if level is None else validation.Fraction(*level))
    assert ref and [(k.bytes(), m, s) for k, m, s in port] == [(k.bytes(), m, s) for k, m, s in ref]
