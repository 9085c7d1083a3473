"""The port's fleet tier (``sidecar/fanout.py``) against the reference's.

Each case runs the port's ``FanoutBackend`` and the reference's over the
same scripted shards and inputs and compares the answers and the counters:
the width-weighted contiguous split, dropped empty slices, exact bitmaps
across shard mixes, one redistribution round, a wedged shard abandoned at
its deadline (held on a ``threading.Event``: no wall-clock assert), all
shards dead, cooldown and rejoin, root failover, chaos errors and flips
under the supervisor's cross-check, the summed width through the supervisor
and the engine, ``CMTPU_FANOUT_PEERS`` parsing, and ``build_chain`` headed
by ``fanout`` in the reference's order.

Then a three-process fleet: this file run as a script is one shard, the
port's ``SidecarServer`` on 127.0.0.1:0 serving the port's ``CpuBackend``
at a width of 1, 2 or 3,

    python tests/test_torch_fanout.py serve WIDTH

printing its address as one JSON line and serving until its stdin closes.
The port's fleet (the port's ``GrpcBackend``) and the reference's (its own
client) drive the same three servers.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

import pytest  # noqa: E402

from cometbft_tpu_torch.sidecar import backend as t_backend  # noqa: E402

if __name__ == "__main__" and sys.argv[1:2] == ["serve"]:
    from cometbft_tpu_torch.sidecar.service import SidecarServer

    width = int(sys.argv[2])

    class _WideCpu(t_backend.CpuBackend):
        """The host verifier with a stated card count, so that the fleet's
        weighted split shows without cards."""

        def mesh_width(self) -> int:
            return width

    server = SidecarServer("127.0.0.1:0", backend=_WideCpu()).start()
    print(json.dumps({"addr": server.bound_addr, "width": width}), flush=True)
    sys.stdin.read()
    server.shutdown()
    sys.exit(0)

from cometbft_tpu.crypto import ed25519  # noqa: E402
from cometbft_tpu.crypto.merkle import hash_from_byte_slices  # noqa: E402
from cometbft_tpu.sidecar import backend as ref_backend  # noqa: E402
from cometbft_tpu.sidecar import chaos as ref_chaos  # noqa: E402
from cometbft_tpu.sidecar import engine as ref_engine  # noqa: E402
from cometbft_tpu.sidecar import fanout as ref_fanout  # noqa: E402
from cometbft_tpu.sidecar import supervisor as ref_sup  # noqa: E402
from cometbft_tpu_torch.sidecar import chaos as t_chaos  # noqa: E402
from cometbft_tpu_torch.sidecar import engine as t_engine  # noqa: E402
from cometbft_tpu_torch.sidecar import fanout as t_fanout  # noqa: E402
from cometbft_tpu_torch.sidecar import supervisor as t_sup  # noqa: E402

pytestmark = pytest.mark.torch_port

PORT = {"fanout": t_fanout, "chaos": t_chaos, "sup": t_sup, "engine": t_engine,
        "cpu": t_backend.CpuBackend}
REF = {"fanout": ref_fanout, "chaos": ref_chaos, "sup": ref_sup, "engine": ref_engine,
       "cpu": ref_backend.CpuBackend}
SIDES = (PORT, REF)
CHILD_TIMEOUT_S = 120


def _signed_triples(n, tag=b"fanout", corrupt=()):
    pv = ed25519.gen_priv_key_from_secret(tag)
    pub = pv.pub_key().bytes()
    msgs = [b"%s-%d" % (tag, i) for i in range(n)]
    sigs = [pv.sign(m) for m in msgs]
    for i in corrupt:
        sigs[i] = sigs[i][:-1] + bytes([sigs[i][-1] ^ 1])
    return [pub] * n, msgs, sigs


class _StubShard:
    """A scriptable shard: a fixed width, a number of failing calls, a wedge
    held on an Event, or a false accept; it answers from its side's
    CpuBackend."""

    name = "stub"

    def __init__(self, cpu, width=1, fail=0, wedge=None, flip=False):
        self.width = width
        self.fail = fail
        self.wedge = wedge
        self.flip = flip
        self.calls = []
        self._cpu = cpu

    def mesh_width(self):
        return self.width

    def ping(self):
        return True

    def batch_verify(self, pubs, msgs, sigs):
        self.calls.append(len(pubs))
        if self.fail > 0:
            self.fail -= 1
            raise ConnectionError("stub: scripted failure")
        if self.wedge is not None:
            self.wedge.wait()
        if self.flip:
            return True, [True] * len(pubs)
        return self._cpu.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        return self._cpu.merkle_root(leaves)


def _fleets(specs, **kw):
    """The same fleet on both sides: specs are (name, stub kwargs)."""
    out = []
    for side in SIDES:
        cpu = side["cpu"]()
        shards = [(name, _StubShard(cpu, **spec)) for name, spec in specs]
        out.append(side["fanout"].FanoutBackend(shards, **kw))
    return out


def _shape(counters):
    """Counters without the error text (its wording is each package's)."""
    out = {k: v for k, v in counters.items() if k != "shards"}
    out["shards"] = {k: {f: v for f, v in s.items() if f != "last_error"}
                     for k, s in counters["shards"].items()}
    return out


# -- split arithmetic --------------------------------------------------------


@pytest.mark.parametrize("widths,n", [((4, 2, 1), 70), ((1, 1, 1), 10), ((3, 5), 97), ((8,), 5)])
def test_split_weighted_contiguous(widths, n):
    ported, ref = _fleets([(f"s{i}", {"width": w}) for i, w in enumerate(widths)], deadline_ms=1000)
    for fan in (ported, ref):
        fan.refresh_widths(dial=False)
    got = [(s.name, lo, hi) for s, lo, hi in ported._split(0, n, ported.shards)]
    assert got == [(s.name, lo, hi) for s, lo, hi in ref._split(0, n, ref.shards)]
    assert got[0][1] == 0 and got[-1][2] == n
    assert all(a[2] == b[1] for a, b in zip(got, got[1:]))
    if widths == (4, 2, 1):
        assert {name: hi - lo for name, lo, hi in got} == {"s0": 40, "s1": 20, "s2": 10}


def test_split_drops_empty_slices_for_narrow_batches():
    ported, ref = _fleets([(c, {"width": 8}) for c in "abc"], deadline_ms=1000)
    for fan in (ported, ref):
        fan.refresh_widths(dial=False)
    got = [(s.name, lo, hi) for s, lo, hi in ported._split(0, 2, ported.shards)]
    assert got == [(s.name, lo, hi) for s, lo, hi in ref._split(0, 2, ref.shards)]
    assert sum(hi - lo for _, lo, hi in got) == 2 and all(hi > lo for _, lo, hi in got)


# -- bit-identity ------------------------------------------------------------


@pytest.mark.parametrize("widths", [(4, 2, 1), (1,), (2, 2), (1, 3, 1, 2)])
def test_bitmap_identical_across_shard_mix(widths):
    n = 97  # not a multiple of any width total
    pubs, msgs, sigs = _signed_triples(n, corrupt=(0, 17, 50, 96))
    want = ref_backend.CpuBackend().batch_verify(pubs, msgs, sigs)
    ported, ref = _fleets([(f"s{i}", {"width": w}) for i, w in enumerate(widths)], deadline_ms=5000)
    got = ported.batch_verify(pubs, msgs, sigs)
    assert got == ref.batch_verify(pubs, msgs, sigs) == want
    assert got[0] is False and sum(got[1]) == n - 4
    assert [s.backend.calls for s in ported.shards] == [s.backend.calls for s in ref.shards]
    assert all(s.backend.calls for s in ported.shards)
    assert ported.batch_verify([], [], []) == ref.batch_verify([], [], []) == (False, [])


# -- failure handling --------------------------------------------------------


def test_erroring_shard_slice_redistributed_to_survivors():
    pubs, msgs, sigs = _signed_triples(64, corrupt=(3,))
    want = ref_backend.CpuBackend().batch_verify(pubs, msgs, sigs)
    ported, ref = _fleets([("ok", {"width": 2}), ("sick", {"width": 2, "fail": 1})],
                          deadline_ms=5000)
    assert ported.batch_verify(pubs, msgs, sigs) == ref.batch_verify(pubs, msgs, sigs) == want
    cn = ported.counters()
    assert _shape(cn) == _shape(ref.counters())
    assert cn["redistributions"] == 1 and cn["redistributed_sigs"] == 32
    assert cn["shards"]["sick"]["failures"] == 1 and cn["shards"]["sick"]["down"] is True


def test_wedged_shard_abandoned_within_deadline():
    """The wedged shard's thread is abandoned at the round's deadline and
    its slice is served by the survivor; the thread is still blocked when
    the call returns (it is released afterwards)."""
    pubs, msgs, sigs = _signed_triples(32)
    results = []
    for side in SIDES:
        release = threading.Event()
        cpu = side["cpu"]()
        wedged = _StubShard(cpu, wedge=release)
        fan = side["fanout"].FanoutBackend([("ok", _StubShard(cpu)), ("wedged", wedged)],
                                           deadline_ms=300)
        try:
            ok, bits = fan.batch_verify(pubs, msgs, sigs)
            alive = [t.name for t in threading.enumerate() if t.name == "fanout-wedged"]
            results.append((ok, bits, fan.counters()["redistributions"], wedged.calls, bool(alive)))
        finally:
            release.set()
    assert results[0] == results[1]
    ok, bits, redistributions, calls, alive = results[0]
    assert ok is True and bits == [True] * 32 and redistributions == 1
    assert calls == [16] and alive


def test_all_shards_dead_raises_connection_error():
    pubs, msgs, sigs = _signed_triples(8)
    for fan in _fleets([("a", {"fail": 9}), ("b", {"fail": 9})], deadline_ms=1000):
        with pytest.raises(ConnectionError, match="unserved after redistribution"):
            fan.batch_verify(pubs, msgs, sigs)
        with pytest.raises(ConnectionError, match="no healthy shard"):
            fan.batch_verify(pubs, msgs, sigs)


def test_cooled_down_shard_rejoins_after_cooldown():
    """A failed shard sits out its cooldown (down_until a cooldown past the
    failure) and the first dispatch after it is its probe. Asserted on the
    shard's own deadline, not on wall time."""
    pubs, msgs, sigs = _signed_triples(16)
    cooldown_ms = 200
    ported, ref = _fleets([("ok", {}), ("sick", {"fail": 1})], deadline_ms=5000,
                          cooldown_ms=cooldown_ms)
    for fan in (ported, ref):
        t0 = time.monotonic()
        assert fan.batch_verify(pubs, msgs, sigs) == (True, [True] * 16)
        sick = fan.shards[1]
        assert sick.down_until >= t0 + cooldown_ms / 1000
        assert not sick.healthy(t0) and sick.healthy(sick.down_until)
    time.sleep(cooldown_ms / 1000 + 0.05)
    for fan in (ported, ref):
        fan.batch_verify(pubs, msgs, sigs)  # the dispatch is the probe
        assert fan.shards[1].down_until == 0.0
        assert len(fan.shards[1].backend.calls) == 2
    assert _shape(ported.counters()) == _shape(ref.counters())


def _raise_oserror(_leaves):
    raise OSError("stub: merkle down")


def test_merkle_root_fails_over_across_shards():
    leaves = [b"leaf-%d" % i for i in range(9)]
    for fan in _fleets([("sick", {}), ("ok", {})], deadline_ms=1000):
        fan.shards[0].backend.merkle_root = _raise_oserror
        assert fan.merkle_root(leaves) == hash_from_byte_slices(leaves)
        assert fan.counters()["shards"]["sick"]["failures"] == 1
        for s in fan.shards:
            s.backend.merkle_root = _raise_oserror
            s.down_until = 0.0
        with pytest.raises(ConnectionError, match="merkle_root failed on every shard"):
            fan.merkle_root(leaves)


# -- chaos on one shard ------------------------------------------------------


def test_chaos_error_on_one_shard_redistributes_with_exact_bits():
    pubs, msgs, sigs = _signed_triples(48, corrupt=(7, 40))
    want = ref_backend.CpuBackend().batch_verify(pubs, msgs, sigs)
    out = []
    for side in SIDES:
        cpu = side["cpu"]()
        chaotic = side["chaos"].ChaosBackend(_StubShard(cpu), "error:1.0", seed=5)
        fan = side["fanout"].FanoutBackend([("ok", _StubShard(cpu)), ("chaos", chaotic)],
                                           deadline_ms=5000)
        # No dial probe: chaos would fail the ping and bench the shard before
        # its first slice; this case wants the dispatch to hit it.
        fan.refresh_widths(dial=False)
        fan._probed = True
        out.append((fan.batch_verify(pubs, msgs, sigs), fan.counters()["redistributions"],
                    dict(chaotic.injected)))
    assert out[0] == out[1]
    assert out[0][0] == want and out[0][1] == 1 and out[0][2]["error"] >= 1


def test_chaos_flip_is_caught_by_supervisor_crosscheck():
    """A shard that false-accepts poisons the merged bitmap; the supervised
    chain's cross-check catches it and serves the anchor's answer."""
    pubs, msgs, sigs = _signed_triples(32, corrupt=(2, 30))
    want = ref_backend.CpuBackend().batch_verify(pubs, msgs, sigs)
    out = []
    for side in SIDES:
        cpu = side["cpu"]()
        flipper = side["chaos"].ChaosBackend(_StubShard(cpu), "flip:1.0", seed=1)
        fan = side["fanout"].FanoutBackend([("a", _StubShard(cpu)), ("flip", flipper)],
                                           deadline_ms=5000)
        sup = side["sup"].ResilientBackend([("fanout", fan), ("cpu", side["cpu"]())],
                                           crosscheck="full", retries=0, backoff_ms=1)
        try:
            out.append((sup.batch_verify(pubs, msgs, sigs), sup.counters_["crosscheck_catches"],
                        sup.counters_["degraded_calls"]))
        finally:
            sup.close()
    assert out[0] == out[1]
    assert out[0][0] == want and out[0][1] >= 1


# -- width algebra -----------------------------------------------------------


def test_fanout_width_is_sum_of_shards():
    for fan in _fleets([("a", {"width": 4}), ("b", {"width": 2}), ("c", {"width": 1})],
                       deadline_ms=1000):
        assert fan.mesh_width() == 3  # cached widths start at 1
        fan.refresh_widths(dial=False)
        assert fan.mesh_width() == 7 and fan._n_dev == 7
        assert fan.shard_widths() == {"a": 4, "b": 2, "c": 1}


def test_ping_learns_widths_and_marks_dead_shards():
    for fan in _fleets([("a", {"width": 4}), ("b", {"width": 2})], deadline_ms=1000):
        fan.shards[1].backend.ping = lambda: False
        assert fan.ping() is True
        assert fan.mesh_width() == 6
        assert fan.counters()["shards"]["b"]["down"] is True
        assert fan.counters()["shard_failures"] == 1


def test_supervisor_width_sums_through_fanout_tier():
    for side, fan in zip(SIDES, _fleets([("a", {"width": 4}), ("b", {"width": 4})],
                                        deadline_ms=1000)):
        fan.refresh_widths(dial=False)
        sup = side["sup"].ResilientBackend([("fanout", fan), ("cpu", side["cpu"]())],
                                           crosscheck="off")
        try:
            assert sup.mesh_width() == 8  # the max over tiers of the fleet's sum
        finally:
            sup.close()


def test_engine_cap_and_rate_model_scale_through_fanout(monkeypatch):
    """The engine's merge cap and dispatch-wall model grow through the
    fleet's combined width, the fanout tier pricing the dispatch."""
    monkeypatch.delenv("CMTPU_ENGINE_MAX", raising=False)
    monkeypatch.setenv("CMTPU_DEV_RATE", "10.0")
    monkeypatch.setenv("CMTPU_DEV_OVERHEAD_MS", "3.0")
    seen = []
    for side in SIDES:
        cpu = side["cpu"]()
        a, b = _StubShard(cpu), _StubShard(cpu)
        fan = side["fanout"].FanoutBackend([("a", a), ("b", b)], deadline_ms=1000)
        fan.refresh_widths(dial=False)
        sup = side["sup"].ResilientBackend([("fanout", fan), ("cpu", side["cpu"]())],
                                           crosscheck="off")
        eng = side["engine"].VerificationEngine(sup)
        try:
            cap0 = eng.refresh_cap()
            rate, overhead = eng._rate_model()
            a.width, b.width = 8, 8
            fan.refresh_widths(dial=False)
            cap1 = eng.refresh_cap()
            rate2, _ = eng._rate_model()
            seen.append((cap0, rate, overhead, cap1, rate2))
        finally:
            eng.close()
            sup.close()
    # The starting cap is each engine's own (the reference's counts its
    # virtual JAX devices); what the fleet moves is equal.
    assert seen[0][1:] == seen[1][1:]
    for cap0, rate, overhead, cap1, rate2 in seen:
        assert cap0 >= 16384 * 2 and rate == pytest.approx(20.0) and overhead == pytest.approx(3.0)
        assert cap1 == 16384 * 16 and rate2 == pytest.approx(160.0)


def test_chaos_wrapped_fleet_reports_and_prices_its_summed_width(monkeypatch):
    """CMTPU_FAULTS wraps the fleet tier: the wrapper reports the fleet's
    summed width without a fault draw, and the engine still finds the
    fleet's rate model under it (rate x the summed width)."""
    monkeypatch.delenv("CMTPU_ENGINE_MAX", raising=False)
    monkeypatch.setenv("CMTPU_DEV_RATE", "10.0")
    monkeypatch.setenv("CMTPU_DEV_OVERHEAD_MS", "3.0")
    seen = []
    for side, fan in zip(SIDES, _fleets([("a", {"width": 4}), ("b", {"width": 2})],
                                        deadline_ms=1000)):
        fan.refresh_widths(dial=False)
        wrapped = side["chaos"].ChaosBackend(fan, "error:1.0", seed=0)
        sup = side["sup"].ResilientBackend([("fanout", wrapped), ("cpu", side["cpu"]())],
                                           crosscheck="off")
        eng = side["engine"].VerificationEngine(sup)
        try:
            seen.append((wrapped.mesh_width(), sup.mesh_width(), eng._rate_model(),
                         wrapped.injected["error"]))
        finally:
            eng.close()
            sup.close()
    assert seen[0] == seen[1] == (6, 6, (pytest.approx(60.0), pytest.approx(3.0)), 0)


def test_rate_seeds_are_the_cards(monkeypatch):
    """Unset, the fleet's engine seeds are the port's measured ones (the
    card's rate and the fleet's dispatch cost), not the reference's."""
    monkeypatch.delenv("CMTPU_DEV_RATE", raising=False)
    monkeypatch.delenv("CMTPU_DEV_OVERHEAD_MS", raising=False)
    fan = _fleets([("a", {})], deadline_ms=1000)[0]
    assert fan._dev_rate == t_backend.CARD_SIGS_PER_MS
    assert fan._dev_overhead == t_fanout.FANOUT_DISPATCH_MS


def test_launch_counts_survive_concurrent_shards():
    """The fleet's shards launch from several threads in one process: the
    launch counters must not lose an increment (a read-modify-write under
    a lock), here with a short switch interval and more threads than
    cores."""
    from cometbft_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.check_launch("ladder", 0)
                                                    for _ in range(2000)])
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["ladder"] - before["ladder"] == 2000 * len(threads)
    _build.LAUNCHES.update(before)


# -- env wiring --------------------------------------------------------------


def test_fanout_peers_parsing(monkeypatch):
    monkeypatch.setenv("CMTPU_FANOUT_PEERS", " 10.0.0.1:7777, 10.0.0.2:7777 ,")
    assert t_fanout.fanout_peers() == ref_fanout.fanout_peers() == ["10.0.0.1:7777",
                                                                    "10.0.0.2:7777"]
    monkeypatch.delenv("CMTPU_FANOUT_PEERS")
    assert t_fanout.fanout_peers() == [] and t_fanout.build_fanout() is None
    assert ref_fanout.build_fanout() is None


def test_build_fanout_makes_one_client_a_peer_and_the_local_shard(monkeypatch):
    from cometbft_tpu_torch.sidecar.service import GrpcBackend

    monkeypatch.setenv("CMTPU_FANOUT_PEERS", "127.0.0.1:1,127.0.0.2:1")
    monkeypatch.setenv("CMTPU_FANOUT_DEADLINE_MS", "1234")
    local = t_backend.CpuBackend()
    fan = t_fanout.build_fanout(local)
    try:
        assert [s.name for s in fan.shards] == ["peer0", "peer1", "local"]
        assert all(isinstance(s.backend, GrpcBackend) for s in fan.shards[:2])
        assert [s.backend.addr for s in fan.shards[:2]] == ["127.0.0.1:1", "127.0.0.2:1"]
        assert fan.shards[0].backend.timeout_s == pytest.approx(1.234)
        assert fan.shards[2].backend is local and fan.deadline_ms == 1234
    finally:
        fan.close()


class _CpuHybrid(t_backend.HybridBackend):
    def __init__(self, device=None):
        super().__init__(device="cpu" if device is None else device)


class _RefCpuHybrid(ref_backend.HybridBackend):
    """The reference's hybrid tier, for its chain's order on a host that has
    an accelerator."""


@pytest.mark.parametrize("sidecar", [False, True])
@pytest.mark.parametrize("faults", [False, True])
def test_build_chain_heads_with_fanout_tier(monkeypatch, sidecar, faults):
    """``build_chain`` no longer raises on CMTPU_FANOUT_PEERS: its tiers are
    the reference's order, fanout -> [grpc] -> hybrid -> cpu, the hybrid is
    the fleet's local shard, and CMTPU_FAULTS wraps every tier but the
    anchor."""
    monkeypatch.setenv("CMTPU_FANOUT_PEERS", "127.0.0.1:1,127.0.0.2:1")
    if sidecar:
        monkeypatch.setenv("CMTPU_SIDECAR_ADDR", "127.0.0.3:1")
    else:
        monkeypatch.delenv("CMTPU_SIDECAR_ADDR", raising=False)
    if faults:
        monkeypatch.setenv("CMTPU_FAULTS", "latency:0.5:1")
    else:
        monkeypatch.delenv("CMTPU_FAULTS", raising=False)
    monkeypatch.setattr(ref_sup, "device_backend", lambda choice: _RefCpuHybrid())
    ref_tiers = ref_sup.build_chain()
    tiers = t_sup.build_chain(device="cpu")
    try:
        names = [n for n, _ in tiers]
        assert names == [n for n, _ in ref_tiers]
        assert names == ["fanout"] + (["grpc"] if sidecar else []) + ["hybrid", "cpu"]
        fan, hybrid = tiers[0][1], tiers[-2][1]
        if faults:
            assert all(isinstance(b, t_chaos.ChaosBackend) for _, b in tiers[:-1])
            assert [b.seed for _, b in tiers[:-1]] == [b.seed for _, b in ref_tiers[:-1]]
            fan, hybrid = fan.inner, hybrid.inner
        assert isinstance(fan, t_fanout.FanoutBackend) and isinstance(hybrid, t_backend.HybridBackend)
        assert [s.name for s in fan.shards] == ["peer0", "peer1", "local"]
        assert fan.shards[-1].backend is hybrid
        assert isinstance(tiers[-1][1], t_backend.CpuBackend)
    finally:
        for _, b in tiers + ref_tiers:
            close = getattr(b, "close", None)
            if close is not None:
                close()


def test_build_chain_without_peers_is_unchanged(monkeypatch):
    monkeypatch.delenv("CMTPU_FANOUT_PEERS", raising=False)
    monkeypatch.delenv("CMTPU_SIDECAR_ADDR", raising=False)
    monkeypatch.delenv("CMTPU_FAULTS", raising=False)
    assert [n for n, _ in t_sup.build_chain(device="cpu")] == ["hybrid", "cpu"]


def test_resilient_chain_over_the_fleet_serves_and_degrades(monkeypatch):
    """The supervised chain headed by a fleet whose shards all fail degrades
    to the hybrid tier with the exact bitmap, on both packages."""
    pubs, msgs, sigs = _signed_triples(20, corrupt=(4,))
    want = ref_backend.CpuBackend().batch_verify(pubs, msgs, sigs)
    out = []
    for side in SIDES:
        cpu = side["cpu"]()
        fan = side["fanout"].FanoutBackend([("a", _StubShard(cpu, fail=9))], deadline_ms=1000)
        sup = side["sup"].ResilientBackend([("fanout", fan), ("cpu", side["cpu"]())],
                                           retries=0, backoff_ms=1)
        try:
            out.append((sup.batch_verify(pubs, msgs, sigs), sup.counters_["degraded_calls"]))
        finally:
            sup.close()
    assert out[0] == out[1] == (want, 1)


# -- real processes ----------------------------------------------------------


def _spawn_shard(width: int):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    return subprocess.Popen(
        [sys.executable, __file__, "serve", str(width)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO,
    )


def test_three_process_fleet_end_to_end():
    """Three shard-server processes (the port's server over the port's
    CpuBackend, widths 1, 2 and 3) behind the port's fleet and the
    reference's: widths learned over the wire, the weighted split, exact
    bitmaps; one server killed, both fleets redistribute once and stay
    exact; the root fails over past it."""
    from cometbft_tpu.sidecar.service import GrpcBackend as RefGrpcBackend
    from cometbft_tpu_torch.sidecar.service import GrpcBackend

    procs = [_spawn_shard(w) for w in (1, 2, 3)]
    fleets = []
    try:
        addrs = []
        for p in procs:
            line = p.stdout.readline()
            assert line, p.stderr.read().decode(errors="replace")[-2000:]
            addrs.append(json.loads(line)["addr"])
        for fanout, client in ((t_fanout, GrpcBackend), (ref_fanout, RefGrpcBackend)):
            fleets.append(fanout.FanoutBackend(
                [(f"proc{i}", client(addr, timeout_s=CHILD_TIMEOUT_S)) for i, addr in enumerate(addrs)],
                deadline_ms=CHILD_TIMEOUT_S * 1000, cooldown_ms=0))
        n = 96
        pubs, msgs, sigs = _signed_triples(n, corrupt=(1, 47, 95))
        want = ref_backend.CpuBackend().batch_verify(pubs, msgs, sigs)
        for fan in fleets:
            assert fan.batch_verify(pubs, msgs, sigs) == want
            assert fan.mesh_width() == 6
            assert fan.shard_widths() == {"proc0": 1, "proc1": 2, "proc2": 3}
            assert fan.counters()["redistributions"] == 0
        procs[0].kill()
        procs[0].wait()
        leaves = [b"tx-%d" % i for i in range(33)]
        for fan in fleets:
            assert fan.batch_verify(pubs, msgs, sigs) == want
            assert fan.counters()["redistributions"] == 1
            failures = fan.counters()["shards"]["proc0"]["failures"]
            assert fan.merkle_root(leaves) == hash_from_byte_slices(leaves)
            assert fan.counters()["shards"]["proc0"]["failures"] == failures + 1
    finally:
        for fan in fleets:
            fan.close()
        for p in procs:
            if p.poll() is None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
