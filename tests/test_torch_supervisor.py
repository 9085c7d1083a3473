"""The port's supervised chains (``sidecar/supervisor.py``, ``sidecar/chaos.py``,
``crypto/bn254.py``) against the reference's.

Each scenario runs on the port's ``ResilientBackend`` and on the
reference's, over the same scripted or seeded-chaos tiers, and the served
results and every counter must be equal: degradation, the breaker
(threshold, half-open probe, re-open), retries, deadlines, the cross-check
and ``aggregate_verify``'s walk. Breaker cooldowns and retry backoff run on
an injected clock, and a wedged tier is held on a ``threading.Event``: the
tests assert counters, never wall time. Then the chain assembly
(``build_chain``, ``build_resilient``) and the BN254 chain
(``build_bn254_chain``) with their decisions held to the reference's host
engines.
"""

import threading

import pytest

from cometbft_tpu.crypto import bn254 as ref_bn
from cometbft_tpu.crypto import ed25519
from cometbft_tpu.crypto.merkle import hash_from_byte_slices
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.sidecar import chaos as ref_chaos
from cometbft_tpu.sidecar import supervisor as ref_sup
from cometbft_tpu_torch.crypto import bn254 as tbn
from cometbft_tpu_torch.crypto import bn254_pure
from cometbft_tpu_torch.ops import bn254_kernel as tbk
from cometbft_tpu_torch.sidecar import backend as t_backend
from cometbft_tpu_torch.sidecar import chaos as t_chaos
from cometbft_tpu_torch.sidecar import supervisor as t_sup

pytestmark = pytest.mark.torch_port

PORT = (t_backend, t_chaos, t_sup)
REF = (ref_backend, ref_chaos, ref_sup)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain device path is thousands of small tensor operations: one
    thread runs them faster than eight, and leaves the cores to the other
    test workers (eight threads a worker under -n 6 oversubscribe them)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signed(n, tag=b"sup"):
    pvs = [ed25519.gen_priv_key_from_secret(tag + b"-%d" % i) for i in range(n)]
    pubs = [pv.pub_key().bytes() for pv in pvs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [pv.sign(m) for pv, m in zip(pvs, msgs)]
    return pubs, msgs, sigs


class FakeClock:
    """now() moves only when the test advances it; sleep() records."""

    def __init__(self):
        self.t = 1000.0
        self.slept = []

    def now(self):
        return self.t

    def sleep(self, seconds):
        self.slept.append(seconds)

    def advance(self, seconds):
        self.t += seconds


class Scripted:
    """A tier that fails on command: raises ``exc`` while ``failing``, else
    answers from its package's CpuBackend. Counts calls and pings."""

    name = "scripted"

    def __init__(self, pkg, exc=None):
        self._cpu = pkg[0].CpuBackend()
        self.exc = exc or ConnectionError("scripted failure")
        self.failing = True
        self.calls = 0
        self.pings = 0
        self.ping_ok = True

    def batch_verify(self, pubs, msgs, sigs):
        self.calls += 1
        if self.failing:
            raise self.exc
        return self._cpu.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        self.calls += 1
        if self.failing:
            raise self.exc
        return self._cpu.merkle_root(leaves)

    def ping(self):
        self.pings += 1
        if not self.ping_ok:
            raise ConnectionError("ping failed")
        return True


def _supervisor(pkg, primary, clock=None, **kw):
    kw.setdefault("deadline_ms", 0)
    kw.setdefault("retries", 0)
    kw.setdefault("backoff_ms", 1)
    kw.setdefault("breaker_threshold", 2)
    kw.setdefault("breaker_cooldown_ms", 100)
    kw.setdefault("crosscheck", "off")
    return pkg[2].ResilientBackend([("primary", primary), ("cpu", pkg[0].CpuBackend())],
                                   clock=clock or FakeClock(), **kw)


def _both(scenario):
    """Run scenario(pkg) on the port and on the reference; equal outputs."""
    got, want = scenario(PORT), scenario(REF)
    assert got == want
    return got


# -- fault spec ---------------------------------------------------------------


def test_parse_faults():
    spec = "latency:0.5:20,error:0.1,wedge:0.2:1000,flip:1"
    f = t_chaos.parse_faults(spec)
    assert f == ref_chaos.parse_faults(spec)
    assert f["latency"] == (0.5, 20.0) and f["wedge"] == (0.2, 1000.0) and f["flip"][0] == 1.0
    assert t_chaos.parse_faults("wedge:1") == ref_chaos.parse_faults("wedge:1")
    assert t_chaos.parse_faults("wedge:1")["wedge"][1] > 0


@pytest.mark.parametrize("bad", ["jitter:0.5", "error:2", "latency:0.5", "error:0.5:100",
                                 "latency:0.1:5:9", "error"])
def test_parse_faults_rejects_bad_specs(bad):
    with pytest.raises(t_chaos.FaultSpecError):
        t_chaos.parse_faults(bad)
    with pytest.raises(ref_chaos.FaultSpecError):
        ref_chaos.parse_faults(bad)


def test_faults_from_env(monkeypatch):
    monkeypatch.delenv("CMTPU_FAULTS", raising=False)
    assert t_chaos.faults_from_env() is None
    monkeypatch.setenv("CMTPU_FAULTS", "error:0.25,flip:0.5")
    assert t_chaos.faults_from_env() == ref_chaos.faults_from_env() == {
        "error": (0.25, 0.0), "flip": (0.5, 0.0)}


def test_chaos_is_deterministic_per_seed():
    pubs, msgs, sigs = _signed(4)

    def run(pkg, seed):
        b = pkg[1].ChaosBackend(pkg[0].CpuBackend(), "error:0.5", seed=seed)
        outcomes = []
        for _ in range(20):
            try:
                b.batch_verify(pubs, msgs, sigs)
                outcomes.append("ok")
            except ConnectionError:
                outcomes.append("err")
        return outcomes, b.counters()

    assert run(PORT, 7) == run(PORT, 7) == run(REF, 7)
    assert run(PORT, 7) != run(PORT, 8), "different seeds explore different faults"


def test_chaos_flip_is_a_false_accept():
    pubs, msgs, sigs = _signed(4)
    sigs[2] = bytes(64)
    b = t_chaos.ChaosBackend(t_backend.CpuBackend(), "flip:1", seed=0)
    assert b.batch_verify(pubs, msgs, sigs) == (True, [True] * 4)
    assert b.name == "chaos(cpu)" and b.mesh_width() == 1 and b.ping() is True
    assert b.counters() == {"chaos_injected": {"latency": 0, "error": 0, "wedge": 0, "flip": 1}}


# -- degradation chain + breaker ------------------------------------------------


def test_degradation_chain_serves_correct_result():
    pubs, msgs, sigs = _signed(6)

    def scenario(pkg):
        sup = _supervisor(pkg, Scripted(pkg))
        return sup.batch_verify(pubs, msgs, sigs), sup.counters()

    res, c = _both(scenario)
    assert res == (True, [True] * 6)
    assert c["degraded_calls"] == 1 and c["active_tier"] == "primary"  # not tripped yet


def test_breaker_opens_after_threshold_and_fails_fast():
    pubs, msgs, sigs = _signed(4)

    def scenario(pkg):
        primary = Scripted(pkg)
        sup = _supervisor(pkg, primary, breaker_threshold=3, breaker_cooldown_ms=60_000)
        served = [sup.batch_verify(pubs, msgs, sigs) for _ in range(5)]
        return served, sup.counters(), primary.calls

    served, c, primary_calls = _both(scenario)
    assert all(ok for ok, _ in served)
    assert c["trips"] == 1 and c["tiers"]["primary"]["state"] == "open"
    assert c["active_tier"] == "cpu"
    assert primary_calls == 3, "an open tier is not called"


def test_half_open_probe_repromotes_healed_tier():
    pubs, msgs, sigs = _signed(4)

    def scenario(pkg):
        clock = FakeClock()
        primary = Scripted(pkg)
        sup = _supervisor(pkg, primary, clock, breaker_threshold=1, breaker_cooldown_ms=50)
        sup.batch_verify(pubs, msgs, sigs)  # trips at once (threshold 1)
        opened = sup.counters()["tiers"]["primary"]["state"]
        primary.failing = False  # the tier heals while open
        clock.advance(0.049)
        inside = sup.active_tier  # still inside the cooldown
        clock.advance(0.002)  # the cooldown elapsed: the next call half-opens
        res = sup.batch_verify(pubs, msgs, sigs)
        return opened, inside, res, sup.counters(), primary.pings

    opened, inside, res, c, pings = _both(scenario)
    assert opened == "open" and inside == "cpu"
    assert res == (True, [True] * 4)
    assert c["tiers"]["primary"]["state"] == "closed" and c["active_tier"] == "primary"
    assert pings == 1, "half-open recovery probes with Ping"


def test_half_open_failed_probe_reopens():
    pubs, msgs, sigs = _signed(4)

    def scenario(pkg):
        clock = FakeClock()
        primary = Scripted(pkg)
        primary.ping_ok = False
        sup = _supervisor(pkg, primary, clock, breaker_threshold=1, breaker_cooldown_ms=50)
        sup.batch_verify(pubs, msgs, sigs)
        clock.advance(0.08)
        calls_before = primary.calls
        ok, _ = sup.batch_verify(pubs, msgs, sigs)  # the probe fails; cpu serves
        return ok, primary.calls - calls_before, sup.counters()

    ok, admitted, c = _both(scenario)
    assert ok and admitted == 0, "a failed probe does not admit the call"
    assert c["tiers"]["primary"]["state"] == "open" and c["trips"] == 2


def test_retries_with_backoff_then_success():
    pubs, msgs, sigs = _signed(4)

    class FlakyOnce(Scripted):
        def batch_verify(self, pubs, msgs, sigs):
            self.calls += 1
            if self.calls == 1:
                raise ConnectionError("transient")
            return self._cpu.batch_verify(pubs, msgs, sigs)

    def scenario(pkg):
        clock = FakeClock()
        primary = FlakyOnce(pkg)
        sup = _supervisor(pkg, primary, clock, retries=2, backoff_ms=10)
        res = sup.batch_verify(pubs, msgs, sigs)
        (slept,) = clock.slept
        assert 0.010 <= slept <= 0.020  # base 10 ms plus jitter up to the base
        return res, primary.calls, sup.counters()

    res, calls, c = _both(scenario)
    assert res[0] and calls == 2
    assert c["retries"] == 1 and c["degraded_calls"] == 0, "the retry succeeded on the same tier"


def test_retries_exhausted_degrade():
    pubs, msgs, sigs = _signed(4)

    def scenario(pkg):
        clock = FakeClock()
        sup = _supervisor(pkg, Scripted(pkg), clock, retries=3, backoff_ms=4)
        res = sup.batch_verify(pubs, msgs, sigs)
        return res, len(clock.slept), sup.counters()

    res, sleeps, c = _both(scenario)
    assert res == (True, [True] * 4) and sleeps == 3
    assert c["retries"] == 3 and c["degraded_calls"] == 1


def test_chain_exhausted_raises():
    pubs, msgs, sigs = _signed(2)
    for pkg in (PORT, REF):
        sup = pkg[2].ResilientBackend([("a", Scripted(pkg)), ("b", Scripted(pkg))], deadline_ms=0,
                                      retries=0, breaker_threshold=3, breaker_cooldown_ms=100,
                                      crosscheck="off", clock=FakeClock())
        with pytest.raises(pkg[2].ChainExhausted) as info:
            sup.batch_verify(pubs, msgs, sigs)
        assert isinstance(info.value.__cause__, ConnectionError)
    with pytest.raises(ValueError):
        t_sup.ResilientBackend([])
    with pytest.raises(ValueError, match="CMTPU_CROSSCHECK"):
        t_sup.ResilientBackend([("cpu", t_backend.CpuBackend())], crosscheck="some")


def test_merkle_root_degrades_too():
    leaves = [b"leaf-%d" % i for i in range(33)]

    def scenario(pkg):
        sup = _supervisor(pkg, Scripted(pkg))
        return sup.merkle_root(leaves), sup.counters()

    root, c = _both(scenario)
    assert root == hash_from_byte_slices(leaves) and c["degraded_calls"] == 1


# -- deadlines --------------------------------------------------------------------


class Wedged:
    """A tier whose call blocks until ``release`` is set (the watchdog must
    abandon it); ``entered`` is set when a call is inside."""

    name = "wedged"

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def batch_verify(self, pubs, msgs, sigs):
        self.calls += 1
        self.entered.set()
        self.release.wait(timeout=120)
        return True, [True] * len(pubs)

    def merkle_root(self, leaves):
        return b""


def test_wedged_tier_costs_one_deadline_not_liveness():
    """A wedged primary costs one deadline: the call is served correctly
    from the anchor, the next call fails fast on the still-busy worker
    (TierWedged, no second deadline) and trips the breaker. Counters, not
    wall time, carry the claim."""
    pubs, msgs, sigs = _signed(4, tag=b"wedge")
    sigs[1] = bytes(64)

    def scenario(pkg):
        wedged = Wedged()
        sup = pkg[2].ResilientBackend([("tpu", wedged), ("cpu", pkg[0].CpuBackend())],
                                      deadline_ms=50, retries=0, breaker_threshold=2,
                                      breaker_cooldown_ms=60_000, crosscheck="off",
                                      clock=FakeClock())
        try:
            first = sup.batch_verify(pubs, msgs, sigs)
            assert wedged.entered.is_set() and sup.tiers[0].worker.busy
            c1 = sup.counters()
            second = sup.batch_verify(pubs, msgs, sigs)
            c2 = sup.counters()
            return first, c1, second, c2, wedged.calls
        finally:
            wedged.release.set()

    first, c1, second, c2, calls = _both(scenario)
    assert first == second == (False, [True, False, True, True])
    assert c1["deadline_exceeded"] == 1 and c1["degraded_calls"] == 1 and c1["trips"] == 0
    assert c2["deadline_exceeded"] == 1, "the second call spent no deadline"
    assert c2["trips"] == 1 and c2["active_tier"] == "cpu"
    assert calls == 1, "nothing queued behind the wedge"


def test_tier_worker_delivers_errors_and_unwedges():
    worker = t_sup._TierWorker("w")
    assert worker.run(lambda: 7, 60.0) == 7
    with pytest.raises(KeyError):
        worker.run(lambda: {}["missing"], 60.0)
    gate, inside = threading.Event(), threading.Event()

    def blocked():
        inside.set()
        gate.wait(timeout=120)
        return 1

    with pytest.raises(t_sup.DeadlineExceeded):
        worker.run(blocked, 0.01)
    assert inside.wait(timeout=120) and worker.busy
    with pytest.raises(t_sup.TierWedged):
        worker.run(lambda: 2, 60.0)
    gate.set()
    idle = threading.Event()
    for _ in range(6000):  # the abandoned call returns at once; wait for its worker
        if not worker.busy:
            break
        idle.wait(timeout=0.01)
    assert worker.run(lambda: 3, 60.0) == 3


def test_no_deadline_means_inline_calls():
    pubs, msgs, sigs = _signed(4)
    primary = Scripted(PORT)
    primary.failing = False
    sup = _supervisor(PORT, primary, deadline_ms=0)
    assert sup.batch_verify(pubs, msgs, sigs)[0]
    assert all(t.worker._thread is None for t in sup.tiers), "no tier worker started"


# -- cross-check ----------------------------------------------------------------


def test_crosscheck_catches_injected_false_accept():
    """A tier's false-accept (an invalid signature reported valid) is caught
    by the anchor, counted, trips the tier, and the anchor's answer is
    served."""
    pubs, msgs, sigs = _signed(8, tag=b"flip")
    sigs[5] = bytes(64)

    def scenario(pkg):
        flipping = pkg[1].ChaosBackend(pkg[0].CpuBackend(), "flip:1", seed=0)
        sup = pkg[2].ResilientBackend([("tpu", flipping), ("cpu", pkg[0].CpuBackend())],
                                      deadline_ms=0, retries=0, breaker_threshold=1,
                                      breaker_cooldown_ms=60_000, crosscheck="full",
                                      clock=FakeClock())
        return sup.batch_verify(pubs, msgs, sigs), sup.counters()

    (ok, bits), c = _both(scenario)
    assert not ok and bits[5] is False and sum(bits) == 7
    assert c["crosscheck_catches"] == 1 and c["tiers"]["tpu"]["state"] == "open"


@pytest.mark.parametrize("flip", [0.0, 1.0])
def test_crosscheck_sample_is_deterministic(flip):
    """The sampled cross-check picks the same lanes in both packages (a
    hash of the batch seeds it): a clean tier passes, and a flipping tier
    is caught when an invalid lane is in the sample."""
    pubs, msgs, sigs = _signed(64, tag=b"sample")
    for i in range(0, 64, 3):
        sigs[i] = bytes(64)  # a third invalid: the 32-lane sample holds some

    def scenario(pkg):
        tier = pkg[1].ChaosBackend(pkg[0].CpuBackend(), f"flip:{flip}", seed=0)
        sup = pkg[2].ResilientBackend([("tpu", tier), ("cpu", pkg[0].CpuBackend())],
                                      deadline_ms=0, retries=0, breaker_threshold=3,
                                      breaker_cooldown_ms=100, crosscheck="sample",
                                      clock=FakeClock())
        return sup.batch_verify(pubs, msgs, sigs), sup.counters()

    (ok, bits), c = _both(scenario)
    assert not ok and bits == [i % 3 != 0 for i in range(64)]
    assert c["crosscheck_catches"] == int(flip) and c["degraded_calls"] == int(flip)


@pytest.mark.parametrize("spec,seed", [("latency:0.3:2,error:0.4", 42), ("error:0.6", 3),
                                       ("error:0.3,flip:0.3", 9)])
def test_seeded_chaos_chain_matches_reference(spec, seed):
    """The same seeded faults over the same call sequence: every served
    result is the honest one and every counter equals the reference's."""
    pubs, msgs, sigs = _signed(5, tag=b"fault-env")
    sigs[1] = bytes(64)
    leaves = [b"l%d" % i for i in range(9)]

    def scenario(pkg):
        chaos = pkg[1].ChaosBackend(pkg[0].CpuBackend(), spec, seed=seed)
        sup = pkg[2].ResilientBackend([("primary", chaos), ("cpu", pkg[0].CpuBackend())],
                                      deadline_ms=0, retries=2, backoff_ms=1, breaker_threshold=3,
                                      breaker_cooldown_ms=1e9, crosscheck="full",
                                      clock=FakeClock())
        served = [sup.batch_verify(pubs, msgs, sigs) for _ in range(12)]
        roots = [sup.merkle_root(leaves) for _ in range(4)]
        return served, roots, sup.counters()

    served, roots, c = _both(scenario)
    assert all(res == (False, [True, False, True, True, True]) for res in served)
    assert roots == [hash_from_byte_slices(leaves)] * 4
    assert c["calls"] == 16


def test_aggregate_verify_walk_matches_reference():
    """Tiers that do not speak aggregate_verify are skipped, not failed; a
    flipped aggregate accept from a non-anchor tier is caught by the
    anchor's recompute and trips the tier."""

    class Agg:
        def __init__(self, name, answer, fail=False):
            self.name, self.answer, self.fail = name, answer, fail

        def aggregate_verify(self, pubs, msgs, agg):
            if self.fail:
                raise ConnectionError("down")
            return self.answer

        def batch_verify(self, pubs, msgs, sigs):
            return True, [True] * len(pubs)

        def merkle_root(self, leaves):
            return b""

    class Mute:
        name = "mute"

        def batch_verify(self, pubs, msgs, sigs):
            return True, [True] * len(pubs)

        def merkle_root(self, leaves):
            return b""

    def scenario(pkg):
        out = []
        for tiers, crosscheck in (
            ([("mute", Mute()), ("a", Agg("a", True)), ("cpu", Agg("cpu", True))], "off"),
            ([("a", Agg("a", True, fail=True)), ("cpu", Agg("cpu", False))], "sample"),
            ([("a", Agg("a", True)), ("cpu", Agg("cpu", False))], "sample"),
        ):
            sup = pkg[2].ResilientBackend(tiers, retries=0, breaker_threshold=1,
                                          crosscheck=crosscheck, clock=FakeClock())
            out.append((sup.aggregate_verify([b"p"], [b"m"], b"s"), sup.counters()))
        sup = pkg[2].ResilientBackend([("mute", Mute())], clock=FakeClock())
        with pytest.raises(pkg[2].ChainExhausted):
            sup.aggregate_verify([b"p"], [b"m"], b"s")
        return out

    out = _both(scenario)
    assert [r for r, _ in out] == [True, False, False]
    assert out[0][1]["degraded_calls"] == 1 and out[0][1]["tiers"]["mute"]["calls"] == 0
    assert out[2][1]["crosscheck_catches"] == 1 and out[2][1]["tiers"]["a"]["state"] == "open"


def test_metrics_mesh_width_ping_and_close():
    from cometbft_tpu.libs.metrics import Registry

    primary = Scripted(PORT)
    primary.closed = False

    def close():
        primary.closed = True

    primary.close = close
    sup = _supervisor(PORT, primary, breaker_threshold=1, breaker_cooldown_ms=60_000)
    sup.batch_verify(*_signed(2, tag=b"gauge"))
    reg = Registry(namespace="cmt")
    sup.register_metrics(reg)
    out = reg.render()
    assert "cmt_backend_trips 1" in out
    assert "cmt_backend_deadline_exceeded 0" in out
    assert "cmt_backend_retries 0" in out
    assert "cmt_backend_active_tier 1" in out  # degraded to the anchor
    assert sup.active_tier_index == 1 and sup.mesh_width() == 1
    assert sup.ping() is True
    sup.close()
    assert primary.closed


# -- chain assembly ---------------------------------------------------------------


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("CMTPU_SIDECAR_ADDR", "CMTPU_FAULTS", "CMTPU_FAULTS_SEED", "CMTPU_FANOUT_PEERS",
                 "CMTPU_DEADLINE_MS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_build_chain_order(clean_env):
    chain = t_sup.build_chain(device="cpu")
    assert [name for name, _ in chain] == ["hybrid", "cpu"]
    assert isinstance(chain[0][1], t_backend.HybridBackend) and chain[0][1].device.type == "cpu"
    assert isinstance(chain[1][1], t_backend.CpuBackend)
    sup = t_sup.build_resilient(device="cpu")
    assert [t.name for t in sup.tiers] == ["hybrid", "cpu"] and sup.active_tier == "hybrid"


def test_build_chain_puts_the_sidecar_first(clean_env):
    clean_env.setenv("CMTPU_SIDECAR_ADDR", "127.0.0.1:1")
    clean_env.setenv("CMTPU_DEADLINE_MS", "250")
    chain = t_sup.build_chain(device="cpu")
    assert [name for name, _ in chain] == ["grpc", "hybrid", "cpu"]
    from cometbft_tpu_torch.sidecar.service import GrpcBackend

    assert isinstance(chain[0][1], GrpcBackend) and chain[0][1].timeout_s == 0.25


def test_build_chain_wraps_non_anchor_tiers_under_faults(clean_env):
    clean_env.setenv("CMTPU_SIDECAR_ADDR", "127.0.0.1:1")
    clean_env.setenv("CMTPU_FAULTS", "error:0.5")
    clean_env.setenv("CMTPU_FAULTS_SEED", "11")
    chain = t_sup.build_chain(device="cpu")
    assert [name for name, _ in chain] == ["grpc", "hybrid", "cpu"]
    assert [b.seed for _, b in chain[:2]] == [11, 12]
    assert all(isinstance(b, t_chaos.ChaosBackend) for _, b in chain[:2])
    assert isinstance(chain[1][1].inner, t_backend.HybridBackend)
    assert isinstance(chain[2][1], t_backend.CpuBackend), "the anchor stays clean"


def test_build_chain_raises_on_fanout_peers(clean_env):
    """CMTPU_FANOUT_PEERS no longer raises now that the fleet tier is
    ported: it heads the chain, the hybrid its local shard
    (tests/test_torch_fanout.py holds the tier to the reference's)."""
    from cometbft_tpu_torch.sidecar.fanout import FanoutBackend

    clean_env.setenv("CMTPU_FANOUT_PEERS", "127.0.0.1:26671")
    chain = t_sup.build_chain(device="cpu")
    assert [name for name, _ in chain] == ["fanout", "hybrid", "cpu"]
    assert isinstance(chain[0][1], FanoutBackend) and chain[0][1].shards[-1].backend is chain[1][1]
    chain[0][1].close()


def test_chains_raise_without_a_card(clean_env):
    """No construction error is caught: no card means an error, never a
    CPU-only chain."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sup.build_resilient()
    with pytest.raises(RuntimeError, match="CUDA"):
        tbn.build_bn254_chain()


def test_supervised_chain_under_faults_stays_correct(clean_env):
    """The assembled chain with a chaotic hybrid (seeded errors and
    latency): every call returns the honest verdict and root."""
    clean_env.setenv("CMTPU_FAULTS", "latency:0.3:2,error:0.4")
    clean_env.setenv("CMTPU_FAULTS_SEED", "42")
    clean_env.setenv("CMTPU_BACKOFF_MS", "1")
    sup = t_sup.build_resilient(device="cpu")
    pubs, msgs, sigs = _signed(5, tag=b"fault-env")
    sigs[1] = bytes(64)
    for _ in range(12):
        ok, bits = sup.batch_verify(pubs, msgs, sigs)
        assert not ok and bits == [True, False, True, True, True]
    leaves = [b"l%d" % i for i in range(9)]
    for _ in range(4):
        assert sup.merkle_root(leaves) == hash_from_byte_slices(leaves)
    c = sup.counters()
    assert c["tiers"]["hybrid"]["backend"]["chaos_injected"]["error"] > 0
    assert c["calls"] == 16


# -- the BN254 chain ----------------------------------------------------------------


def _scalar(i: int) -> int:
    return (0x5EED + 7919 * i) % bn254_pure.R


@pytest.fixture(scope="module")
def votes():
    """Five signed votes, the third signed over another message."""
    sks = [_scalar(i) for i in range(5)]
    pubs = [bn254_pure.public_key(sk) for sk in sks]
    msgs = [b"bn254-chain-vote-%d" % i for i in range(5)]
    sigs = [bn254_pure.sign(sk, m) for sk, m in zip(sks, msgs)]
    sigs[2] = bn254_pure.sign(sks[2], b"another-vote")
    return sks, pubs, msgs, sigs


def test_bn254_chain_order_and_faults(clean_env):
    chain = tbn.build_bn254_chain(device="cpu")
    assert [name for name, _ in chain] == ["bn254-device", "bn254-host", "cpu"]
    assert isinstance(chain[0][1], tbk.Bn254DeviceBackend) and chain[0][1].device.type == "cpu"
    assert isinstance(chain[1][1], tbn.Bn254HostBackend)
    assert isinstance(chain[2][1], tbn.Bn254ScalarBackend)
    clean_env.setenv("CMTPU_FAULTS", "error:1")
    clean_env.setenv("CMTPU_FAULTS_SEED", "4")
    chain = tbn.build_bn254_chain(device="cpu")
    assert [b.seed for _, b in chain[:2]] == [4, 5]
    assert isinstance(chain[2][1], tbn.Bn254ScalarBackend), "the anchor stays clean"


def test_bn254_host_engines_match_reference(votes):
    _, pubs, msgs, sigs = votes
    bad_pubs = list(pubs)
    bad_pubs[4] = bad_pubs[4][:31]  # malformed: a False lane that poisons nothing
    for cols in ((pubs, msgs, sigs), (bad_pubs, msgs, sigs), (pubs[:2], msgs[:2], sigs[:2])):
        want = ref_bn.batch_verify_signatures(*cols)
        assert tbn.batch_verify_signatures(*cols) == want
        assert tbn.Bn254HostBackend().batch_verify(*cols) == want
        assert tbn.Bn254ScalarBackend().batch_verify(*cols) == ref_bn.Bn254ScalarBackend().batch_verify(*cols)
    assert tbn.batch_verify_signatures([], [], []) == ref_bn.batch_verify_signatures([], [], []) == (False, [])


def test_bn254_aggregate_decisions_match_reference(votes):
    sks, pubs, msgs, sigs = votes
    good = [s for i, s in enumerate(sigs) if i != 2] + [bn254_pure.sign(sks[2], msgs[2])]
    order = [0, 1, 3, 4, 2]
    agg = ref_bn.aggregate_signatures(good)
    cases = [
        ([pubs[i] for i in order], [msgs[i] for i in order], agg),
        ([pubs[i] for i in order], [msgs[i] for i in order], ref_bn.aggregate_signatures(good[:4])),
        ([pubs[i] for i in order][:4], [msgs[i] for i in order], agg),
        ([], [], agg),
        ([pubs[0]], [msgs[0]], b"\x01" * 128),
    ]
    got = [tbn.verify_aggregate(*c) for c in cases]
    assert got == [ref_bn.verify_aggregate(*c) for c in cases] == [True, False, False, False, False]
    assert [tbn.Bn254ScalarBackend().aggregate_verify(*c) for c in cases] == got


def test_bn254_chain_decisions_match_reference(clean_env, votes):
    """The chain over the port's device tier (the plain Miller program on
    the CPU) serves the reference host engine's bitmap and aggregate
    decisions from bn254-device; with the device tier's errors injected,
    from bn254-host."""
    _, pubs, msgs, sigs = votes
    want = ref_bn.batch_verify_signatures(pubs, msgs, sigs)
    assert want == (False, [True, True, False, True, True])
    sup = t_sup.ResilientBackend(tbn.build_bn254_chain(device="cpu"), clock=FakeClock())
    before = tbk.counters()["dispatches"]
    assert sup.batch_verify(pubs, msgs, sigs) == want
    assert tbk.counters()["dispatches"] == before + 1
    c = sup.counters()
    assert c["degraded_calls"] == 0 and c["tiers"]["bn254-device"]["calls"] == 1
    assert c["crosscheck_catches"] == 0

    tiers = tbn.build_bn254_chain(device="cpu")
    tiers[0] = ("bn254-device", t_chaos.ChaosBackend(tiers[0][1], "error:1", seed=0))
    injected = t_sup.ResilientBackend(tiers, backoff_ms=1, clock=FakeClock())
    assert injected.batch_verify(pubs, msgs, sigs) == want
    c = injected.counters()
    assert c["degraded_calls"] == 1 and c["tiers"]["bn254-host"]["calls"] == 1
    assert c["tiers"]["cpu"]["calls"] == 0 and c["retries"] == 2
    assert tbk.counters()["dispatches"] == before + 1, "the injected device tier never ran"


def test_get_bn254_backend(clean_env):
    tbn.set_bn254_backend(None)
    try:
        clean_env.setenv("CMTPU_BACKEND", "cpu")
        assert isinstance(tbn.get_bn254_backend(), tbn.Bn254HostBackend)
        tbn.set_bn254_backend(None)
        clean_env.setenv("CMTPU_BACKEND", "auto")
        import torch

        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tbn.get_bn254_backend()
        sup = t_sup.ResilientBackend(tbn.build_bn254_chain(device="cpu"))
        tbn.set_bn254_backend(sup)
        assert tbn.get_bn254_backend() is sup
    finally:
        tbn.set_bn254_backend(None)
