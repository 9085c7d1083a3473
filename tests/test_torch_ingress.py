"""The QoS ingress pipeline and its lanes in the port
(``cometbft_tpu_torch/mempool/{ingress,lanes}.py``): every case of the JAX
package's ``tests/test_ingress.py`` run on the port, then the port held to
the reference on the same inputs: envelope bytes, one seeded stream of
legacy, signed, corrupted, malformed, duplicate and rate-limited
submissions fed to both packages' pipelines (codes, codespaces, logs,
lanes at reap, counters), and a backend that raises (the same verdicts,
counted in ``preverify_fallbacks``; on a card, the batch rejected and
counted instead)."""

import random
import threading
import time

import pytest

from cometbft_tpu import mempool as ref_mempool_pkg
from cometbft_tpu.abci import types as ref_abci
from cometbft_tpu.abci.client import LocalClientCreator as RefLocalClientCreator
from cometbft_tpu.config import MempoolConfig as RefMempoolConfig
from cometbft_tpu.crypto import ed25519 as ref_ed25519
from cometbft_tpu.mempool import ingress as ref_ingress
from cometbft_tpu.sidecar import backend as ref_be
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import LocalClientCreator
from cometbft_tpu_torch.config import MempoolConfig
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.mempool.ingress import (
    CODE_BAD_ENVELOPE,
    CODE_INVALID_SIGNATURE,
    CODE_QUEUE_FULL,
    CODE_RATE_LIMITED,
    CODE_REJECTED,
    CODE_TX_IN_CACHE,
    BadEnvelope,
    IngressPipeline,
    decode_envelope,
    encode_envelope,
)
from cometbft_tpu_torch.mempool.lanes import LaneFull, LaneItem, LaneSet, TokenBucket
from cometbft_tpu_torch.sidecar import backend as be
from cometbft_tpu_torch.sidecar.backend import CpuBackend

pytestmark = [pytest.mark.torch_port, pytest.mark.ingress]

# The port's counters beyond the reference's: each a swallowed exception it
# counts (0 on every clean stream).
PORT_ONLY = ("preverify_fallbacks", "dispatcher_errors", "callback_errors")


def _app_cls(abci_mod):
    class CountingApp(abci_mod.Application):
        """Accepts every tx; counts CheckTx calls (invalid-sig rejections
        must never reach the app)."""

        def __init__(self):
            self.check_calls = 0
            self.seen = []
            self._mtx = threading.Lock()

        def check_tx(self, req):
            with self._mtx:
                self.check_calls += 1
                self.seen.append(req.tx)
            return abci_mod.ResponseCheckTx(code=0, gas_wanted=1)

    return CountingApp


CountingApp = _app_cls(abci)
RefCountingApp = _app_cls(ref_abci)


@pytest.fixture(autouse=True)
def _cpu_backend():
    """Pin both packages' process backends to their cpu anchors (tests that
    need a different chain swap it themselves); keep the verify caches
    clean."""
    old, ref_old = be._backend, ref_be._backend
    be.set_backend(CpuBackend())
    ref_be.set_backend(ref_be.CpuBackend())
    ed25519._verified.clear()
    ref_ed25519._verified.clear()
    yield
    ed25519._verified.clear()
    ref_ed25519._verified.clear()
    be._backend = old
    ref_be._backend = ref_old


def _mk(app=None, window_ms=1.0, now=time.monotonic, **cfg_kwargs):
    app = app or CountingApp()
    cli = LocalClientCreator(app).new_abci_client()
    cfg = MempoolConfig(ingress_window_ms=window_ms, **cfg_kwargs)
    mp = CListMempool(cfg, cli)
    ing = IngressPipeline(cfg, mp, now=now)
    return app, mp, ing


def _mk_ref(app=None, window_ms=1.0, now=time.monotonic, **cfg_kwargs):
    app = app or RefCountingApp()
    cli = RefLocalClientCreator(app).new_abci_client()
    cfg = RefMempoolConfig(ingress_window_ms=window_ms, **cfg_kwargs)
    mp = ref_mempool_pkg.CListMempool(cfg, cli)
    ing = ref_ingress.IngressPipeline(cfg, mp, now=now)
    return app, mp, ing


def _key(tag: bytes):
    return ed25519.gen_priv_key_from_secret(tag)


def _wait(cond, what: str) -> None:
    """Wait for the dispatcher (a liveness guard, not a time bound)."""
    deadline = time.monotonic() + 30.0
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


# -- envelope wire format ----------------------------------------------------


def test_envelope_roundtrip():
    priv = _key(b"rt")
    tx = encode_envelope(priv, b"k=v", priority=7, nonce=42)
    env = decode_envelope(tx)
    assert env.pubkey == priv.pub_key().bytes()
    assert env.priority == 7
    assert env.nonce == 42
    assert env.payload == b"k=v"
    assert ed25519.PubKey(env.pubkey).verify_signature(env.sign_bytes(), env.signature)


def test_legacy_passthrough_and_malformed():
    assert decode_envelope(b"plain=tx") is None
    assert decode_envelope(b"") is None
    priv = _key(b"mal")
    tx = encode_envelope(priv, b"k=v")
    with pytest.raises(BadEnvelope):
        decode_envelope(tx[:50])  # truncated envelope is an error...
    with pytest.raises(BadEnvelope):
        decode_envelope(bytes([tx[0], 99]) + tx[2:])  # ...so is a bad version
    # distinct nonces are distinct txs
    assert encode_envelope(priv, b"k=v", nonce=1) != encode_envelope(priv, b"k=v", nonce=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_envelope_bytes_equal_the_reference(seed):
    """The same key, payload, priority and nonce give the same envelope
    bytes; each package decodes the other's to the same fields, and the
    malformed ones raise the same text."""
    rng = random.Random(seed)
    for _ in range(8):
        secret = rng.randbytes(16)
        payload = rng.randbytes(rng.randrange(1, 80))
        priority, nonce = rng.randrange(0, 300), rng.randrange(0, 1 << 64)
        tx = encode_envelope(ed25519.gen_priv_key_from_secret(secret), payload, priority, nonce)
        ref_tx = ref_ingress.encode_envelope(
            ref_ed25519.gen_priv_key_from_secret(secret), payload, priority, nonce)
        assert tx == ref_tx
        got, want = decode_envelope(ref_tx), ref_ingress.decode_envelope(tx)
        assert (got.pubkey, got.priority, got.nonce, got.payload, got.signature) == (
            want.pubkey, want.priority, want.nonce, want.payload, want.signature)
        assert got.sign_bytes() == want.sign_bytes() and got.sender == want.sender
        for bad in (tx[:rng.randrange(1, 108)], bytes([tx[0], 2]) + tx[2:]):
            with pytest.raises(BadEnvelope) as e:
                decode_envelope(bad)
            with pytest.raises(ref_ingress.BadEnvelope) as ref_e:
                ref_ingress.decode_envelope(bad)
            assert str(e.value) == str(ref_e.value)
    with pytest.raises(ValueError, match="non-empty"):
        encode_envelope(_key(b"e"), b"")


# -- admission ---------------------------------------------------------------


def test_signed_and_legacy_admission():
    app, mp, ing = _mk()
    try:
        codes = []
        ing.check_tx(b"legacy=1", callback=lambda r: codes.append(r.code))
        tx = encode_envelope(_key(b"ok"), b"signed=1", priority=2)
        ing.check_tx(tx, callback=lambda r: codes.append(r.code))
        assert ing.flush_queue()
        _wait(lambda: len(codes) == 2, "two answers")
        assert mp.size() == 2
        assert codes == [0, 0]
        lanes = {m.tx: m.lane for m in mp.txs_front()}
        assert lanes[b"legacy=1"] == 0
        assert lanes[tx] == 2
    finally:
        ing.close()


def test_invalid_sig_rejected_without_waking_app():
    app, mp, ing = _mk()
    try:
        tx = bytearray(encode_envelope(_key(b"bad"), b"k=v"))
        tx[-1] ^= 0xFF
        codes = []
        ing.check_tx(bytes(tx), callback=lambda r: codes.append((r.code, r.codespace)))
        assert ing.flush_queue()
        _wait(lambda: len(codes) == 1, "one answer")
        assert codes == [(CODE_INVALID_SIGNATURE, "ingress")]
        assert mp.size() == 0
        assert app.check_calls == 0, "bad-sig tx must never reach the app"
        assert ing.counters["rejected_invalid_sig"] == 1
    finally:
        ing.close()


def test_concurrent_senders_share_preverify_batches():
    """8 senders x 32 envelopes submitted concurrently must coalesce into
    far fewer preverify dispatches than txs (the micro-batch window)."""
    app, mp, ing = _mk(window_ms=5.0, size=1000, cache_size=1000)
    try:
        k, per = 8, 32
        privs = [_key(b"c-%d" % i) for i in range(k)]
        txs = [[encode_envelope(privs[i], b"c/%d/%d=v" % (i, j), nonce=j) for j in range(per)]
               for i in range(k)]
        barrier = threading.Barrier(k)

        def sender(i):
            barrier.wait()
            for tx in txs[i]:
                ing.check_tx(tx)

        threads = [threading.Thread(target=sender, args=(i,)) for i in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert ing.flush_queue(30.0)
        deadline = time.monotonic() + 30.0
        while mp.size() < k * per and time.monotonic() < deadline:
            time.sleep(0.005)
        assert mp.size() == k * per
        assert ing.counters["preverify_batches"] < k * per / 4
        assert ing.counters["preverify_batch_max"] > 1
    finally:
        ing.close()


def test_gossip_duplicate_short_circuit():
    """A tx already in the cache (gossip echo) is answered from the cache
    path: no queue slot, no second preverify dispatch."""
    app, mp, ing = _mk()
    try:
        tx = encode_envelope(_key(b"dup"), b"k=v")
        ing.check_tx(tx, sender="peer-a")
        assert ing.flush_queue()
        _wait(lambda: mp.size() == 1, "the tx admitted")
        batches = ing.counters["preverify_batches"]
        codes = []
        ing.check_tx(tx, callback=lambda r: codes.append(r.code), sender="peer-b")
        assert codes == [CODE_TX_IN_CACHE]
        assert ing.counters["preverify_batches"] == batches
        entry = next(iter(mp.txs_front()))
        assert "peer-b" in entry.senders
    finally:
        ing.close()


# -- lanes / WFQ / token buckets --------------------------------------------


def test_token_bucket_fake_clock():
    t = [0.0]
    b = TokenBucket(rate=2.0, burst=4.0, now=lambda: t[0])
    assert [b.allow() for _ in range(4)] == [True] * 4
    assert not b.allow()  # burst exhausted
    t[0] += 1.0  # +2 tokens
    assert b.allow() and b.allow() and not b.allow()


def test_laneset_wfq_drain_order_and_shed():
    ls = LaneSet(lanes=3, queue_max=4, sender_rps=0)
    for lane in (0, 1, 2):
        for j in range(4):
            ls.push(LaneItem(tx=b"%d-%d" % (lane, j), lane=lane))
    with pytest.raises(LaneFull):
        ls.push(LaneItem(tx=b"overflow", lane=0))
    order = [it.tx for it in ls.drain(12)]
    assert len(order) == 12
    # DRR quantum 2**lane: the first cycle grants lane2 4, lane1 2, lane0 1
    assert order[:4] == [b"2-0", b"2-1", b"2-2", b"2-3"]
    assert order.index(b"1-0") < order.index(b"0-0")
    for lane in (0, 1, 2):
        got = [t for t in order if t.startswith(b"%d-" % lane)]
        assert got == sorted(got)
    assert ls.size() == 0


def test_laneset_per_sender_share_cap():
    ls = LaneSet(lanes=1, queue_max=16, sender_rps=0, sender_share_div=4)
    for j in range(4):  # share = 16 // 4 = 4
        ls.push(LaneItem(tx=b"s%d" % j, sender="squatter"))
    with pytest.raises(LaneFull):
        ls.push(LaneItem(tx=b"s5", sender="squatter"))
    ls.push(LaneItem(tx=b"h0", sender="honest"))  # others still fit


@pytest.mark.parametrize("seed", [3, 4])
def test_laneset_matches_the_reference(seed):
    """A seeded mix of pushes (lanes, senders, over-share and full lanes),
    rate checks on a fake clock, and drains of random budgets: the same
    items in the same order, the same refusals with the same texts."""
    from cometbft_tpu.mempool import lanes as ref_lanes

    rng = random.Random(seed)
    t = [0.0]
    ls = LaneSet(lanes=3, queue_max=8, sender_rps=5.0, now=lambda: t[0])
    ref = ref_lanes.LaneSet(lanes=3, queue_max=8, sender_rps=5.0, now=lambda: t[0])
    for step in range(400):
        op = rng.random()
        if op < 0.6:
            item = dict(tx=b"tx-%d" % step, sender=rng.choice(["", "a", "b", "c"]),
                        lane=rng.randrange(-1, 5))
            outs = []
            for mod, s in ((ref_lanes, ref), (None, ls)):
                try:
                    (s.push(mod.LaneItem(**item)) if mod else s.push(LaneItem(**item)))
                    outs.append("ok")
                except (LaneFull, ref_lanes.LaneFull) as e:
                    outs.append(str(e))
            assert outs[0] == outs[1]
        elif op < 0.8:
            sender = rng.choice(["", "a", "b"])
            assert ls.rate_check(sender) == ref.rate_check(sender)
            t[0] += rng.random() * 0.3
        else:
            budget = rng.randrange(0, 10)
            got = [(i.tx, i.lane, i.sender, i.seq) for i in ls.drain(budget)]
            want = [(i.tx, i.lane, i.sender, i.seq) for i in ref.drain(budget)]
            assert got == want
        assert ls.depths() == ref.depths() and ls.size() == ref.size()


def test_rate_limited_rejection():
    t = [0.0]
    app, mp, ing = _mk(ingress_sender_rps=2.0, now=lambda: t[0])
    try:
        priv = _key(b"rl")
        codes = []
        for j in range(10):
            ing.check_tx(encode_envelope(priv, b"rl/%d=v" % j, nonce=j),
                         callback=lambda r: codes.append(r.code))
        limited = [c for c in codes if c == CODE_RATE_LIMITED]
        assert limited, "burst above rps*2 must be rate limited"
        assert ing.counters["shed_total"] >= len(limited)
        ing.check_tx(b"legacy-unlimited=1")  # legacy txs carry no identity
        assert ing.counters["rejected_rate_limited"] == len(limited)
    finally:
        ing.close()


def test_queue_full_sheds_with_distinct_code():
    app, mp, ing = _mk(window_ms=500.0, ingress_queue_max=4)
    try:
        priv = _key(b"qf")
        codes = []
        for j in range(20):
            ing.check_tx(encode_envelope(priv, b"qf/%d=v" % j, priority=0, nonce=j),
                         callback=lambda r: codes.append(r.code))
        assert CODE_QUEUE_FULL in codes
        assert ing.counters["rejected_queue_full"] > 0
        assert ing.counters["shed_total"] > 0
    finally:
        ing.close()


def test_bad_envelope_rejected():
    app, mp, ing = _mk()
    try:
        codes = []
        tx = encode_envelope(_key(b"bv"), b"k=v")
        ing.check_tx(tx[:60], callback=lambda r: codes.append(r.code))
        assert codes == [CODE_BAD_ENVELOPE]
        assert app.check_calls == 0
    finally:
        ing.close()


# -- lane-aware reap ---------------------------------------------------------


def test_reap_drains_high_priority_lanes_first():
    app, mp, ing = _mk(ingress_lanes=4)
    try:
        txs = {}
        for pri in (0, 3, 1, 2):  # submitted out of priority order
            tx = encode_envelope(_key(b"reap-%d" % pri), b"p%d=v" % pri, priority=pri)
            txs[pri] = tx
            ing.check_tx(tx)
        assert ing.flush_queue()
        deadline = time.monotonic() + 10.0
        while mp.size() < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        reaped = mp.reap_max_bytes_max_gas(-1, -1)
        assert reaped == [txs[3], txs[2], txs[1], txs[0]]
    finally:
        ing.close()


# -- starvation-freedom property ---------------------------------------------


@pytest.mark.parametrize("seed", [1, 7])
def test_spammer_cannot_starve_honest_senders(seed):
    """Seeded 10:1 offered-load property: one spammer offers 10x the load
    of each honest sender into the same lane; every honest tx must be
    reaped within K simulated blocks of its submission, and the spammer's
    excess must be shed."""
    K = 3
    sim_seconds = 6
    block_size = 48
    t = [float(seed)]
    app, mp, ing = _mk(ingress_sender_rps=10.0, ingress_lanes=2, ingress_queue_max=64,
                       window_ms=1.0, size=5000, cache_size=20000, now=lambda: t[0])
    try:
        spammer = _key(b"spam-%d" % seed)
        honest = [_key(b"hon-%d-%d" % (seed, i)) for i in range(3)]
        pending = {}
        height = 0
        answers = []  # one answer a submission: the app's CheckTx or a rejection
        submitted = 0

        def submit(tx):
            nonlocal submitted
            submitted += 1
            ing.check_tx(tx, callback=answers.append)

        def settle():
            # Every submission answered: none still between the lanes and
            # the mempool when the block reaps.
            assert ing.flush_queue(30.0)
            deadline = time.monotonic() + 30.0
            while len(answers) < submitted and time.monotonic() < deadline:
                time.sleep(0.002)
            assert len(answers) == submitted

        def block():
            nonlocal height
            height += 1
            reaped = mp.reap_max_bytes_max_gas(block_size * 200, -1)
            mp.lock()
            try:
                mp.update(height, reaped, [abci.ResponseDeliverTx(code=0)] * len(reaped),
                          None, None)
            finally:
                mp.unlock()
            return reaped

        for sec in range(sim_seconds):
            t[0] += 1.0
            for j in range(100):
                submit(encode_envelope(spammer, b"s/%d/%d/%d=v" % (seed, sec, j),
                                       priority=1, nonce=sec * 1000 + j))
            for i, priv in enumerate(honest):
                for j in range(3):
                    tx = encode_envelope(priv, b"h/%d/%d/%d/%d=v" % (seed, sec, i, j),
                                         priority=1, nonce=sec * 10 + j)
                    submit(tx)
                    pending[tx] = height
            settle()
            for tx in block():
                if tx in pending:
                    assert height - pending[tx] <= K
                    del pending[tx]
        for _ in range(K):
            for tx in block():
                pending.pop(tx, None)
        assert not pending, f"{len(pending)} honest txs starved"
        assert ing.counters["shed_total"] > 0, "the spammer was never shed"
        assert ing.counters["rejected_invalid_sig"] == 0
    finally:
        ing.close()


# -- chaos composition -------------------------------------------------------


@pytest.mark.chaos
def test_wedged_preverify_tier_degrades_to_cpu_anchor():
    """A fully wedged primary preverify tier (chaos wedge > deadline) must
    degrade admission to the cpu anchor — slower, never lossy — and the
    degraded chain answers the batch call: no scalar fallback is counted."""
    from cometbft_tpu_torch.sidecar.chaos import ChaosBackend
    from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend

    chain = ResilientBackend(
        [("tpu", ChaosBackend(CpuBackend(), "wedge:1.0:500", seed=3)), ("cpu", CpuBackend())],
        deadline_ms=50, retries=0, backoff_ms=1, breaker_threshold=1,
        breaker_cooldown_ms=60000, crosscheck="off",
    )
    be.set_backend(chain)
    app, mp, ing = _mk(size=1000, cache_size=1000)
    try:
        privs = [_key(b"chaos-%d" % i) for i in range(4)]
        n = 40
        for j in range(n):
            ing.check_tx(encode_envelope(privs[j % 4], b"ch/%d=v" % j, nonce=j))
        assert ing.flush_queue(30.0)
        deadline = time.monotonic() + 30.0
        while mp.size() < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mp.size() == n, "degraded chain must not drop valid txs"
        assert chain.counters_["degraded_calls"] > 0, "anchor never engaged"
        assert ing.counters["rejected_invalid_sig"] == 0
        assert ing.counters["preverify_fallbacks"] == 0
    finally:
        ing.close()
        chain.close()


class RaisingBackend:
    """A process backend whose every call raises (a broken chain that is not
    ``ChainExhausted``: the BatchVerifier lets it through to the ingress)."""

    name = "raising"

    def batch_verify(self, pubs, msgs, sigs):
        raise RuntimeError("the card is gone")

    def merkle_root(self, leaves):
        raise RuntimeError("the card is gone")


def test_raising_backend_gives_reference_verdicts_and_counts_fallbacks():
    """On a backend that raises, both packages scalar-verify each envelope:
    the same answers (valid ones admitted, the corrupted one refused with
    102), and the port counts each batch that fell back in
    ``preverify_fallbacks`` with the last exception kept."""
    be.set_backend(RaisingBackend())
    ref_be.set_backend(RaisingBackend())
    privs = [(b"raise-%d" % i) for i in range(3)]
    txs = [encode_envelope(ed25519.gen_priv_key_from_secret(s), b"r/%d=v" % i, nonce=i)
           for i, s in enumerate(privs)]
    txs[1] = txs[1][:-1] + bytes([txs[1][-1] ^ 0x01])
    answers = {}
    for name, mk in (("port", _mk), ("ref", _mk_ref)):
        app, mp, ing = mk(window_ms=20.0)
        got = []
        try:
            for tx in txs:
                ing.check_tx(tx, callback=lambda r, tx=tx: got.append(
                    (tx, r.code, r.codespace, r.log)))
            assert ing.flush_queue(30.0)
            deadline = time.monotonic() + 30.0
            while len(got) < len(txs) and time.monotonic() < deadline:
                time.sleep(0.005)
            answers[name] = (sorted(got), sorted(app.seen), {
                k: v for k, v in ing.stats().items() if k not in PORT_ONLY + (
                    "preverify_batches", "preverify_batch_max")})
            if name == "port":
                assert ing.counters["preverify_fallbacks"] == ing.counters["preverify_batches"] >= 1
                assert isinstance(ing.last_preverify_error, RuntimeError)
        finally:
            ing.close()
    assert answers["port"] == answers["ref"]
    assert [c for _, c, _, _ in answers["port"][0]].count(CODE_INVALID_SIGNATURE) == 1


class RaisingCardBackend(RaisingBackend):
    """A raising backend that verifies on a CUDA card (its ``device``)."""

    device = "cuda:0"


@pytest.mark.parametrize("backend_cls", [RaisingCardBackend, CpuBackend])
def test_raising_card_backend_rejects_the_batch_and_counts_it(backend_cls, monkeypatch):
    """Where the process backend is on a card, a batch call that raises is
    not moved to the host: the dispatcher answers every envelope of the
    batch ``CODE_REJECTED`` (the app sees none) and counts it in
    ``dispatcher_errors``, with the exception kept in both ``last_*``; no
    scalar fallback is counted. A ``CpuBackend`` that raises keeps the
    scalar fallback even with a card present."""
    if backend_cls is CpuBackend:
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(CpuBackend, "batch_verify", RaisingBackend.batch_verify)
    be.set_backend(backend_cls())
    txs = [encode_envelope(_key(b"card-%d" % i), b"c/%d=v" % i, nonce=i) for i in range(3)]
    app, mp, ing = _mk(window_ms=20.0)
    got = []
    try:
        for tx in txs:
            ing.check_tx(tx, callback=lambda r: got.append((r.code, r.codespace, r.log)))
        assert ing.flush_queue(30.0)
        _wait(lambda: len(got) == len(txs), "not every envelope was answered")
        assert isinstance(ing.last_preverify_error, RuntimeError)
        if backend_cls is CpuBackend:
            assert sorted(c for c, _, _ in got) == [0, 0, 0]
            assert ing.counters["preverify_fallbacks"] >= 1
            assert ing.counters["dispatcher_errors"] == 0
            return
        assert got == [(CODE_REJECTED, "ingress", "ingress error")] * len(txs)
        assert app.seen == [] and mp.size() == 0
        assert ing.counters["preverify_fallbacks"] == 0
        assert ing.counters["dispatcher_errors"] >= 1
        assert ing.last_dispatcher_error is ing.last_preverify_error
    finally:
        ing.close()


def test_raising_callback_is_counted():
    """A callback that raises is passed over, as in the reference, and
    counted in ``callback_errors`` with the last exception kept."""
    app, mp, ing = _mk()
    try:
        def boom(res):
            raise KeyError("client went away")

        ing.check_tx(b"\xce\x01short", callback=boom)
        assert ing.counters["callback_errors"] == 1
        assert isinstance(ing.last_callback_error, KeyError)
        assert ing.counters["rejected_bad_envelope"] == 1
    finally:
        ing.close()


# -- one seeded stream through both packages ---------------------------------


def _stream(seed: int):
    """Chunks of submissions: (tx, sender) pairs. Legacy txs, signed
    envelopes at priorities 0-5 from 6 senders, corrupted ones, malformed
    ones (truncated, a bad version), duplicates of txs of earlier chunks,
    and one sender flooding past its token bucket."""
    rng = random.Random(seed)
    keys = [ed25519.gen_priv_key_from_secret(b"stream-%d-%d" % (seed, i)) for i in range(6)]
    nonce = [0] * len(keys)
    sent, chunks = [], []
    for c in range(12):
        chunk = []
        for j in range(rng.randrange(4, 16)):
            kind = rng.random()
            if kind < 0.15:
                tx = b"legacy-%d-%d-%d=v" % (seed, c, j)
            elif kind < 0.25 and sent:
                tx = rng.choice(sent)  # a duplicate of an earlier chunk
            else:
                i = 0 if kind < 0.45 else rng.randrange(len(keys))  # key 0 floods
                nonce[i] += 1
                tx = encode_envelope(keys[i], b"s%d-%d-%d=%d" % (seed, c, j, nonce[i]),
                                     priority=rng.randrange(0, 6), nonce=nonce[i])
                if rng.random() < 0.12:
                    tx = tx[:-2] + bytes([tx[-2] ^ 0x40]) + tx[-1:]
                elif rng.random() < 0.05:
                    tx = tx[: rng.randrange(1, 100)]
                elif rng.random() < 0.03:
                    tx = tx[:1] + b"\x07" + tx[2:]
            chunk.append((tx, rng.choice(["", "peer-x"])))
        chunks.append(chunk)
        sent.extend(tx for tx, _ in chunk)
    return chunks


def _run_stream(mk, chunks):
    t = [100.0]
    app, mp, ing = mk(window_ms=1.0, now=lambda: t[0], ingress_sender_rps=2.0,
                      ingress_lanes=4, size=1000, cache_size=1000)
    answers = []
    try:
        for c, chunk in enumerate(chunks):
            t[0] += 0.5
            got = []
            for k, (tx, sender) in enumerate(chunk):
                ing.check_tx(tx, sender=sender, callback=lambda r, k=k: got.append(
                    (k, r.code, r.codespace, r.log)))
            assert ing.flush_queue(30.0)
            deadline = time.monotonic() + 30.0
            while len(got) < len(chunk) and time.monotonic() < deadline:
                time.sleep(0.002)
            answers.append(sorted(got))
        lanes = [(m.tx, m.lane) for m in mp.txs_front()]
        reaped = mp.reap_max_bytes_max_gas(-1, -1)
        stats = ing.stats()
        return answers, lanes, reaped, sorted(app.seen), stats
    finally:
        ing.close()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_seeded_stream_matches_the_reference(seed):
    """Every submission of the stream gets the same code, codespace and log
    from both packages; the mempools hold the same txs in the same lanes,
    reap in the same order, the apps saw the same CheckTx calls, and the
    counters are equal (the port's own, all 0, aside; the batch counts
    depend on the dispatcher's timing and are left out)."""
    chunks = _stream(seed)
    port = _run_stream(_mk, chunks)
    ref = _run_stream(_mk_ref, chunks)
    assert port[:4] == ref[:4]
    timing = ("preverify_batches", "preverify_batch_max")
    assert {k: v for k, v in port[4].items() if k not in PORT_ONLY + timing} == {
        k: v for k, v in ref[4].items() if k not in timing}
    assert all(port[4][k] == 0 for k in PORT_ONLY)
    codes = {c for a in port[0] for _, c, _, _ in a}
    assert {0, CODE_INVALID_SIGNATURE, CODE_TX_IN_CACHE, CODE_RATE_LIMITED} <= codes


# -- RPC ---------------------------------------------------------------------


def test_broadcast_tx_sync_timeout_is_rpc_error():
    """The sync broadcast timeout comes from config.rpc and surfaces as a
    proper RPCError, not a fake code=-1 result."""
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.rpc.core import Environment, routes
    from cometbft_tpu_torch.rpc.jsonrpc.server import RPCError

    class BlackholeMempool:
        def check_tx(self, tx, callback=None, sender=""):
            pass  # never answers

    cfg = test_config()
    cfg.rpc.timeout_broadcast_tx_commit = 0.05
    table = routes(Environment(config=cfg, mempool=BlackholeMempool()))
    with pytest.raises(RPCError) as exc:
        table["broadcast_tx_sync"](tx="0x" + b"ping".hex())
    assert exc.value.code == -32603
    assert "timed out" in exc.value.message


def test_ingress_stats_route():
    from cometbft_tpu_torch.rpc.core import Environment, routes

    app, mp, ing = _mk()
    try:
        table = routes(Environment(mempool=ing, ingress=ing))
        st = table["ingress_stats"]()
        assert st["enabled"] is True
        assert "shed_total" in st and "lane_depths" in st
        assert st["preverify_fallbacks"] == 0
        assert routes(Environment())["ingress_stats"]() == {"enabled": False}
    finally:
        ing.close()


def test_ingress_delegates_to_the_mempool_and_stops_its_dispatcher():
    """Everything that is not admission is the wrapped mempool's (size,
    reap, the cache); ``close`` ends the dispatcher thread."""
    app, mp, ing = _mk()
    ing.check_tx(b"delegated=1")
    assert ing.flush_queue()
    deadline = time.monotonic() + 10.0
    while mp.size() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert ing.size() == mp.size() == 1
    assert ing.reap_max_txs(-1) == [b"delegated=1"]
    assert ing.cache is mp.cache
    assert ing.lane_depths() == [0, 0, 0, 0]
    thread = ing._thread
    ing.close()
    assert not thread.is_alive()
