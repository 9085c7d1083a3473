"""The port's ``crypto/sigbatch.py`` against the JAX package's: the same
bits and counters from ``verify_many`` / ``verify_triples`` on each path
(the private window, ``inline``, window 0, the engine behind the port's
``CoalescingScheduler``, a cache hit, a key that is not ed25519, a
signature of the wrong size), the same degradation to the scalar check
when the backend raises, counted in ``fallbacks``; and the two differences
by design: a window result that times out is counted in the port (not in
the reference), and a process backend that cannot be built raises in the
port (the reference takes its private window and counts a fallback).
Both packages verify on their ``CpuBackend``; one case runs the port's
window on ``TorchBackend(device="cpu")``."""

import threading
import time

import pytest
import torch
import torch_light_chains as lc

from cometbft_tpu.crypto import bn254 as ref_bn254
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import sigbatch as ref_sigbatch
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.sidecar import engine as ref_engine
from cometbft_tpu.sidecar.scheduler import CoalescingScheduler as RefScheduler
from cometbft_tpu.types import block as rb
from cometbft_tpu.types.vote import Vote as RefVote
from cometbft_tpu_torch.crypto import bn254, ed25519, sigbatch
from cometbft_tpu_torch.crypto import bn254_pure
from cometbft_tpu_torch.sidecar import backend, engine
from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler

pytestmark = pytest.mark.torch_port

CHAIN = "torch-sigbatch-chain"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def votes():
    """Six validators' precommits (reference-signed), as (pub, msg, sig)
    bytes; the third signature has a flipped bit."""
    out = []
    for i, pv in enumerate(lc.ref_pool(b"sigbatch", 6)):
        v = RefVote(type=rb.PRECOMMIT_TYPE, height=7, round=0,
                    block_id=rb.BlockID(b"\x01" * 32, rb.PartSetHeader(1, b"\x02" * 32)),
                    timestamp=lc.now("ref", lc.T0), validator_address=pv.address(),
                    validator_index=i)
        signed = pv.sign_vote(CHAIN, v)
        sig = bytearray(signed.signature)
        if i == 2:
            sig[5] ^= 0x01
        out.append((pv.get_pub_key().bytes(), v.sign_bytes(CHAIN), bytes(sig)))
    return out


def _keys(pkg, triples):
    cls = ref_ed.PubKey if pkg == "ref" else ed25519.PubKey
    return [cls(p) for p, _, _ in triples], [m for _, m, _ in triples], [s for _, _, s in triples]


def _run(pkg, batcher, triples, *, keys=None, rounds=1):
    pubs, msgs, sigs = keys or _keys(pkg, triples)
    bits = [batcher.verify_many(pubs, msgs, sigs) for _ in range(rounds)]
    return bits, batcher.counters()


class _Backends:
    """Install one backend in each package (the port's own and the
    reference's) and empty both verified-triple caches."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port

    def __enter__(self):
        self.saved = (ref_backend._backend, backend._backend)
        ref_backend.set_backend(self.ref)
        backend.set_backend(self.port)
        ref_ed._verified.clear()
        ed25519._verified.clear()
        return self

    def __exit__(self, *exc):
        ref_backend.set_backend(self.saved[0])
        backend.set_backend(self.saved[1])
        ref_ed._verified.clear()
        ed25519._verified.clear()


PATHS = {
    # name: (batcher arguments, rounds)
    "private_window": ({"window_ms": 2.0}, 1),
    "inline": ({"inline": True}, 1),
    "window_off": ({"window_ms": 0.0}, 1),
    "cache_hit": ({"window_ms": 2.0}, 2),  # the second round's valid triples hit the cache
}


@pytest.mark.parametrize("name", list(PATHS))
def test_paths_agree_with_the_reference(votes, name):
    kw, rounds = PATHS[name]
    with _Backends(lc.Recording(ref_backend.CpuBackend(), ref_engine),
                   lc.Recording(backend.CpuBackend(), engine)) as be:
        ref = _run("ref", ref_sigbatch.SigBatcher(**kw), votes, rounds=rounds)
        port = _run("port", sigbatch.SigBatcher(**kw), votes, rounds=rounds)
        assert be.port.batches == be.ref.batches
    assert port == ref
    assert ref[0][0] == [True, True, False, True, True, True]
    if name == "cache_hit":
        assert ref[1]["cache_hits"] == 5 and be.ref.batches == [6, 1]
    elif name == "window_off":
        assert be.ref.batches == [] and ref[1]["scalar_direct"] == 6
    else:
        assert be.ref.batches == [6] and ref[1]["dispatches"] == 1


def test_engine_path_under_the_coalescing_scheduler(votes):
    """With the port's CoalescingScheduler installed, engine_of finds its
    engine and the votes go consensus-class through it (the reference's
    scheduler the same in the reference)."""
    ref_sched = RefScheduler(ref_backend.CpuBackend())
    port_sched = CoalescingScheduler(backend.CpuBackend())
    try:
        with _Backends(ref_sched, port_sched):
            assert engine.engine_of(backend.get_backend()) is port_sched.engine
            assert engine.engine_of(ref_sched) is None  # the reference's engine is not the port's
            ref = _run("ref", ref_sigbatch.SigBatcher(window_ms=2.0), votes, rounds=2)
            port = _run("port", sigbatch.SigBatcher(window_ms=2.0), votes, rounds=2)
        assert port == ref and ref[1]["dispatches"] == 2 and ref[1]["fallbacks"] == 0
        cc = port_sched.engine.class_counters_
        assert cc[engine.CLASS_CONSENSUS]["admitted"] == 2
        assert cc[engine.CLASS_CONSENSUS]["dispatched_sigs"] == 7
    finally:
        ref_sched.close()
        port_sched.close()


def test_other_keys_and_sizes(votes):
    """A bn254 key with a malformed signature takes its own scalar verify;
    a 63-byte signature is rejected without a batch."""
    pk = bn254_pure.public_key(12345)
    sk_bytes = b"\x07" * 64
    out = {}
    for pkg, mod, bn_cls, ed_cls in (("ref", ref_sigbatch, ref_bn254.PubKey, ref_ed.PubKey),
                                     ("port", sigbatch, bn254.PubKey, ed25519.PubKey)):
        with _Backends(ref_backend.CpuBackend(), backend.CpuBackend()):
            b = mod.SigBatcher(window_ms=2.0)
            p, m, s = votes[0]
            out[pkg] = _run(pkg, b, None, keys=([bn_cls(pk), ed_cls(p), ed_cls(p)],
                                                [m, m, m], [sk_bytes, s[:63], s]))
    assert out["port"] == out["ref"]
    assert out["ref"][0][0] == [False, False, True] and out["ref"][1]["scalar_direct"] == 1


def test_raising_backend_falls_back_and_counts(votes):
    """The backend raises: each request drops to the scalar check, the same
    bits as the reference's, and ``fallbacks`` counts it in both; the port
    keeps the exception."""
    for kw in ({"window_ms": 2.0}, {"inline": True}):
        with _Backends(lc.Recording(ref_backend.CpuBackend(), ref_engine, {0, 1, 2, 3}),
                       lc.Recording(backend.CpuBackend(), engine, {0, 1, 2, 3})):
            ref = _run("ref", ref_sigbatch.SigBatcher(**kw), votes)
            port_b = sigbatch.SigBatcher(**kw)
            port = _run("port", port_b, votes)
        assert port == ref and ref[1]["fallbacks"] == 1
        assert ref[0][0] == [True, True, False, True, True, True]
        assert "planted backend failure" in str(port_b.last_fallback_error)


def test_engine_failure_falls_back_and_counts(votes):
    ref_sched = RefScheduler(lc.Recording(ref_backend.CpuBackend(), ref_engine, {0, 1, 2, 3}))
    port_sched = CoalescingScheduler(lc.Recording(backend.CpuBackend(), engine, {0, 1, 2, 3}))
    try:
        with _Backends(ref_sched, port_sched):
            ref = _run("ref", ref_sigbatch.SigBatcher(window_ms=2.0), votes)
            port_b = sigbatch.SigBatcher(window_ms=2.0)
            port = _run("port", port_b, votes)
        assert port == ref and ref[1]["fallbacks"] == 1 and ref[1]["dispatches"] == 0
        assert port_b.last_fallback_error is not None
    finally:
        ref_sched.close()
        port_sched.close()


class _Slow:
    """A backend whose answer comes after ``delay_s``."""

    def __init__(self, inner, delay_s):
        self.inner, self.delay_s = inner, delay_s

    def batch_verify(self, pubs, msgs, sigs):
        time.sleep(self.delay_s)
        return self.inner.batch_verify(pubs, msgs, sigs)


def test_timed_out_window_is_counted_in_the_port(votes):
    """A window result that does not arrive in time: both packages check the
    request on the scalar path (the same bits); the port counts it in
    ``fallbacks`` (the reference does not: a difference by design)."""
    out = {}
    for pkg, mod, be in (("ref", ref_sigbatch, ref_backend), ("port", sigbatch, backend)):
        with _Backends(_Slow(ref_backend.CpuBackend(), 0.5), _Slow(backend.CpuBackend(), 0.5)):
            b = mod.SigBatcher(window_ms=1.0)
            b.result_timeout_s = 0.05
            out[pkg] = _run(pkg, b, votes)
            if pkg == "port":
                assert isinstance(b.last_fallback_error, TimeoutError)
            time.sleep(0.6)  # the dispatcher's late answer lands before the caches clear
    assert out["port"][0] == out["ref"][0] == [[True, True, False, True, True, True]]
    assert out["ref"][1]["fallbacks"] == 0 and out["port"][1]["fallbacks"] == 1
    assert {k: v for k, v in out["port"][1].items() if k != "fallbacks"} == \
        {k: v for k, v in out["ref"][1].items() if k != "fallbacks"}


def test_broken_process_backend_raises_in_the_port(votes, monkeypatch):
    """No backend installed and a process default that cannot be built
    (an unknown ``CMTPU_BACKEND``): the reference takes its private window and
    counts a fallback; the port raises the error instead of passing it for
    a missing engine."""
    monkeypatch.setenv("CMTPU_BACKEND", "no-such-tier")
    saved = (ref_backend._backend, backend._backend)
    ref_backend._backend = None
    backend._backend = None
    try:
        ref = _run("ref", ref_sigbatch.SigBatcher(window_ms=2.0), votes)
        with pytest.raises(ValueError, match="unknown CMTPU_BACKEND"):
            _run("port", sigbatch.SigBatcher(window_ms=2.0), votes)
    finally:
        ref_backend.set_backend(saved[0])
        backend.set_backend(saved[1])
        ref_ed._verified.clear()
        ed25519._verified.clear()
    assert ref[0][0] == [True, True, False, True, True, True] and ref[1]["fallbacks"] == 1


def test_concurrent_window_on_the_plain_kernels(votes):
    """Six callers at once through one window over TorchBackend("cpu"):
    each gets its own bit, and the window dispatched every signature once."""
    with _Backends(ref_backend.CpuBackend(), lc.Recording(backend.TorchBackend(device="cpu"),
                                                          engine)) as be:
        b = sigbatch.SigBatcher(window_ms=50.0)
        bits = [None] * len(votes)
        barrier = threading.Barrier(len(votes))

        def one(i):
            barrier.wait(10)
            p, m, s = votes[i]
            bits[i] = b.verify_one(ed25519.PubKey(p), m, s)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(votes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert bits == [True, True, False, True, True, True]
    c = b.counters()
    assert c["dispatched_sigs"] == 6 and c["fallbacks"] == 0 and sum(be.port.batches) == 6


def test_module_singleton_and_counters():
    """Counters without a batcher are the reference's zeros; the singleton
    is built once and reads the window knob."""
    olds = (ref_sigbatch.set_batcher(None), sigbatch.set_batcher(None))
    try:
        assert sigbatch.counters() == ref_sigbatch.counters()
        assert sigbatch.get_batcher() is sigbatch.get_batcher()
        assert sigbatch.get_batcher().window_ms == ref_sigbatch.get_batcher().window_ms
    finally:
        ref_sigbatch.set_batcher(olds[0])
        sigbatch.set_batcher(olds[1])
