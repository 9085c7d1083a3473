"""The simnet in the port (``simnet/clock.py``, ``byzantine.py``,
``scenario.py``, over the port's whole consensus stack) against the JAX
package's: ``run_scenario`` in both packages must return the same report
for each spec (block hashes, commit times, simulated time, events, the
counters on the reference's keys, the evidence and recovery reports, the
joins and the schedule; wall time aside). The port's counters carry one
key more, ``drain_failures``, which must be 0. The specs are the
reference's own tests' shapes (``tests/test_simnet.py``,
``tests/test_simnet_byzantine.py``): a small mesh, 15 validators with
jitter, a partition that heals, a one-zone 10-validator run with 25 ms vote
buckets (so the drains' prebatch runs), an equivocator whose evidence is
committed, a flooder and a late joiner. The reference runs on its
``CpuBackend``, the port on ``TorchBackend(device="cpu")``. No tolerance."""

import pytest
import torch

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.simnet.scenario import run_scenario as ref_run
from cometbft_tpu_torch import simnet
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.simnet.clock import SimClock
from cometbft_tpu_torch.simnet.scenario import run_scenario

pytestmark = pytest.mark.torch_port

SPECS = {
    "small": dict(validators=4, blocks=3, seed=5, max_sim_s=120),
    "jitter": dict(validators=15, blocks=3, seed=99, max_sim_s=180, jitter_ms=20.0),
    "partition": dict(validators=4, blocks=4, seed=21, max_sim_s=240,
                      partitions=[{"at_s": 8.0, "heal_s": 30.0, "fraction": 0.5}]),
    "vote_window": dict(validators=10, blocks=3, seed=3, zones=1, vote_window_ms=25.0,
                        max_sim_s=240),
    "equivocator": dict(seed=11, validators=4, blocks=8, zones=2, jitter_ms=5.0, max_sim_s=600.0,
                        byzantine=[{"role": "equivocator", "node": 1, "from_s": 5.0,
                                    "until_s": 60.0}]),
    "flooder": dict(seed=9, validators=4, blocks=8, zones=2, jitter_ms=5.0, max_sim_s=600.0,
                    byzantine=[{"role": "flooder", "node": 1, "from_s": 5.0, "until_s": 45.0,
                                "rate_hz": 20.0}]),
    "join": dict(seed=5, validators=6, blocks=12, zones=2, jitter_ms=5.0, max_sim_s=900.0,
                 joins=[{"node": 5, "at_s": 40.0}]),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def backends():
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.TorchBackend(device="cpu"))
    try:
        yield
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed._verified.clear()
        ed25519._verified.clear()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_scenario_equals_the_reference(name, backends, monkeypatch):
    prebatches = []
    orig = ConsensusState._prebatch_vote_signatures

    def prebatch(cs, items):
        prebatches.append(len(items))
        return orig(cs, items)

    monkeypatch.setattr(ConsensusState, "_prebatch_vote_signatures", prebatch)
    ref = ref_run(**SPECS[name])
    port = run_scenario(**SPECS[name])
    assert port["counters"].pop("drain_failures") == 0
    for rep in (ref, port):
        rep.pop("wall_time_s")
        rep.pop("accel")
    assert port == ref
    assert port["ok"] and port["safety_ok"] and port["hash_agreement"]
    if name == "vote_window":
        assert port["counters"]["vote_dispatches"] > 0 and max(prebatches) >= 8
    if name == "equivocator":
        ev = port["evidence"]
        assert ev["detections"] >= 1 and ev["committed_count"] >= 1
    if name == "flooder":
        assert port["counters"]["byz_flooded"] >= 1 and port["evidence"]["committed_count"] == 0
    if name == "join":
        assert port["counters"]["join_completions"] == 1 and port["joins"][0]["synced_blocks"] >= 1
    if name == "partition":
        assert port["recovery"]["applicable"]


def test_same_seed_replays_bit_identically(backends):
    kw = SPECS["jitter"]
    a, b = run_scenario(**kw), run_scenario(**kw)
    assert a["block_hashes"] == b["block_hashes"] and a["events"] == b["events"]


def test_drain_failures_are_counted_and_kept(backends, monkeypatch, capsys):
    """A handler error inside the simnet's drain is printed and passed over
    as the reference does, and counted with the last error kept."""
    from cometbft_tpu_torch.simnet import scenario

    orig = ConsensusState._handle_timeout
    state = {"armed": 1}

    def handle_timeout(cs, ti):
        if state["armed"] and cs.name == "sim1":
            state["armed"] -= 1
            raise RuntimeError("planted handler failure")
        return orig(cs, ti)

    monkeypatch.setattr(ConsensusState, "_handle_timeout", handle_timeout)
    scen = scenario.Scenario(scenario.default_spec(**SPECS["small"]))
    report = scen.run()
    assert report["counters"]["drain_failures"] == 1
    assert "planted handler failure" in str(scen.last_drain_failure)
    assert "sim drain failure" in capsys.readouterr().out
    assert report["ok"]


def test_sim_clock_and_the_transport_not_ported():
    """The clock, and the transport the simnet exports: since the p2p slice
    ``SimNetwork`` and ``SimTransport`` are the port's own
    (``simnet/transport.py``; the name is kept so the count of tests holds)."""
    from cometbft_tpu_torch.p2p.transport import UpgradedConn
    from cometbft_tpu_torch.simnet import transport

    clock = SimClock()
    fired = []
    clock.timer(0.2, fired.append, "b")
    clock.timer(0.1, fired.append, "a")
    h = clock.timer(0.15, fired.append, "x")
    h.cancel()
    clock.timer(0.2, fired.append, "c")
    assert clock.run() == 3 and fired == ["a", "b", "c"] and clock.now() == pytest.approx(0.2)
    for name in ("SimNetwork", "SimTransport"):
        cls = getattr(simnet, name)
        assert cls is getattr(transport, name)
        assert cls.__module__ == "cometbft_tpu_torch.simnet.transport"
    assert transport.UpgradedConn is UpgradedConn
    assert simnet.run_scenario is run_scenario
