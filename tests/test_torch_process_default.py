"""The port's process default (``sidecar/backend._make_backend`` and
``get_backend``) against the reference's.

``CMTPU_BACKEND`` takes the reference's choices with ``torch`` for the
device tier: ``auto`` (the default) serves ``CoalescingScheduler(
build_resilient())``, the bare chain under ``CMTPU_COALESCE=0``; ``grpc``
the port's client; ``cpu`` the host anchor; ``torch`` and ``hybrid`` the card
(they raise without one, as ``auto`` does); ``tpu`` raises and names
``torch``. Here the chains run on the CPU: the port's hybrid tier on the
plain path (``HybridBackend(device="cpu")``), the reference's
``build_resilient`` patched to a chain over the same kind of tiers, and both
defaults serve the same bitmaps. The port warms the default's hybrid tier
(its walls at the warm buckets, its root cost model), and
``set_backend(None)`` closes a default it built.
"""

import threading

import pytest
import torch

from cometbft_tpu.crypto import ed25519
from cometbft_tpu.sidecar import backend as ref_be
from cometbft_tpu.sidecar import scheduler as ref_sched
from cometbft_tpu.sidecar import supervisor as ref_sup
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.sidecar import backend as be
from cometbft_tpu_torch.sidecar import scheduler as t_sched
from cometbft_tpu_torch.sidecar import supervisor as t_sup

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def fresh_default(monkeypatch):
    """No default before or after a case; the knobs of the chain unset, and
    the hybrid's warm-up at small buckets and trees (the plain path)."""
    for name in ("CMTPU_BACKEND", "CMTPU_COALESCE", "CMTPU_FANOUT_PEERS", "CMTPU_SIDECAR_ADDR",
                 "CMTPU_FAULTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(ek, "WARM_BUCKETS", (8, 32))
    monkeypatch.setattr(ek, "WARM_LEAVES", (16, 64))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    be.set_backend(None)
    ref_be.set_backend(None)
    yield
    be.set_backend(None)
    ref_default = ref_be._backend  # the reference's set_backend closes nothing
    if ref_default is not None and hasattr(ref_default, "close"):
        ref_default.close()
    ref_be.set_backend(None)
    torch.set_num_threads(threads)


def _signed(n, corrupt=()):
    pvs = [ed25519.gen_priv_key_from_secret(b"default-%d" % i) for i in range(n)]
    pubs = [pv.pub_key().bytes() for pv in pvs]
    msgs = [b"default-msg-%d" % i for i in range(n)]
    sigs = [pv.sign(m) for pv, m in zip(pvs, msgs)]
    for i in corrupt:
        sigs[i] = sigs[i][:-1] + bytes([sigs[i][-1] ^ 1])
    return pubs, msgs, sigs


class _CpuHybrid(be.HybridBackend):
    def __init__(self, device=None):
        super().__init__(device="cpu" if device is None else device)


def _cpu_chains(monkeypatch):
    """The port's chain with its hybrid on the plain path; the reference's
    build_resilient over its own hybrid tier and anchor."""
    monkeypatch.setattr(t_sup, "HybridBackend", _CpuHybrid)

    def ref_build_resilient():
        hybrid = ref_be.HybridBackend()
        hybrid._n_dev = 1
        return ref_sup.ResilientBackend([("hybrid", hybrid), ("cpu", ref_be.CpuBackend())])

    monkeypatch.setattr(ref_sup, "build_resilient", ref_build_resilient)


@pytest.mark.parametrize("coalesce", ["1", "0"])
def test_auto_serves_the_coalesced_chain_as_the_reference(monkeypatch, coalesce):
    _cpu_chains(monkeypatch)
    monkeypatch.setenv("CMTPU_BACKEND", "auto")
    monkeypatch.setenv("CMTPU_COALESCE", coalesce)
    ported, ref = be.get_backend(), ref_be.get_backend()
    assert be.get_backend() is ported
    if coalesce == "1":
        assert isinstance(ported, t_sched.CoalescingScheduler)
        assert isinstance(ref, ref_sched.CoalescingScheduler)
        chain, ref_chain = ported.inner, ref.inner
    else:
        chain, ref_chain = ported, ref
    assert isinstance(chain, t_sup.ResilientBackend) and isinstance(ref_chain, ref_sup.ResilientBackend)
    assert [t.name for t in chain.tiers] == [t.name for t in ref_chain.tiers] == ["hybrid", "cpu"]
    for n, bad in ((40, (3, 39)), (9, ()), (1, (0,))):
        batch = _signed(n, bad)
        assert ported.batch_verify(*batch) == ref.batch_verify(*batch)
        assert ported.batch_verify(*batch) == (not bad, [i not in bad for i in range(n)])
    c = chain.counters()
    assert c["active_tier"] == "hybrid" and c["degraded_calls"] == 0
    leaves = [b"tx-%d" % i for i in range(33)]
    assert ported.merkle_root(leaves) == ref.merkle_root(leaves)


def test_auto_is_the_default_and_warms_its_hybrid(monkeypatch):
    """Unset CMTPU_BACKEND is auto; the chain's hybrid tier holds a measured
    wall at every warm bucket before the first call, so that a small batch
    is priced from walls, and its root cost model is timed."""
    _cpu_chains(monkeypatch)
    default = be.get_backend()
    hybrid = be._hybrid_tier(default.inner)
    assert isinstance(hybrid, _CpuHybrid)
    assert {(8, 1), (32, 1)} <= set(hybrid._dev_wall)
    assert (hybrid._root_fixed, hybrid._card_leaf_rate, hybrid._host_leaf_rate) != (
        be.CARD_ROOT_MS, be.CARD_LEAVES_PER_MS, be.HOST_LEAVES_PER_MS)


def test_hybrid_tier_is_found_under_a_fault_wrapper(monkeypatch):
    monkeypatch.setattr(t_sup, "HybridBackend", _CpuHybrid)
    monkeypatch.setenv("CMTPU_FAULTS", "latency:0.1:1")
    chain = t_sup.build_resilient()
    try:
        assert type(chain.tiers[0].backend).__name__ == "ChaosBackend"
        assert be._hybrid_tier(chain) is chain.tiers[0].backend.inner
    finally:
        chain.close()
    assert be._hybrid_tier(t_sup.ResilientBackend([("cpu", be.CpuBackend())])) is None


def test_set_backend_closes_the_default_it_built(monkeypatch):
    _cpu_chains(monkeypatch)
    default = be.get_backend()
    assert default.batch_verify(*_signed(2)) == (True, [True, True])
    engine_thread = default.engine._thread  # started by the first request
    assert engine_thread.is_alive()
    be.set_backend(None)
    engine_thread.join(timeout=30)
    assert not engine_thread.is_alive() and be._backend is None


def test_set_backend_leaves_an_installed_backend_open():
    closed = threading.Event()

    class Installed(be.CpuBackend):
        def close(self):
            closed.set()

    mine = Installed()
    be.set_backend(mine)
    assert be.get_backend() is mine
    be.set_backend(None)
    assert not closed.is_set()


def test_cpu_choice_is_the_host_anchor(monkeypatch):
    monkeypatch.setenv("CMTPU_BACKEND", "cpu")
    ported, ref = be.get_backend(), ref_be.get_backend()
    assert type(ported) is be.CpuBackend and type(ref) is ref_be.CpuBackend
    batch = _signed(20, (7,))
    assert ported.batch_verify(*batch) == ref.batch_verify(*batch)


def test_grpc_choice_is_the_ports_client(monkeypatch):
    from cometbft_tpu.sidecar.service import GrpcBackend as RefGrpcBackend
    from cometbft_tpu_torch.sidecar.service import GrpcBackend

    monkeypatch.setenv("CMTPU_BACKEND", "grpc")
    monkeypatch.setenv("CMTPU_SIDECAR_ADDR", "127.0.0.1:1")
    ported, ref = be._make_backend(), ref_be._make_backend()
    assert isinstance(ported, GrpcBackend) and isinstance(ref, RefGrpcBackend)
    assert ported.addr == ref.addr == "127.0.0.1:1"
    monkeypatch.delenv("CMTPU_SIDECAR_ADDR")
    assert be._make_backend().addr == ref_be._make_backend().addr == "127.0.0.1:26670"


def test_unknown_choice_raises_as_the_reference(monkeypatch):
    monkeypatch.setenv("CMTPU_BACKEND", "gpu-please")
    with pytest.raises(ValueError, match="unknown CMTPU_BACKEND"):
        be._make_backend()
    with pytest.raises(ValueError, match="unknown CMTPU_BACKEND"):
        ref_be._make_backend()


def test_tpu_choice_raises_and_names_torch(monkeypatch):
    monkeypatch.setenv("CMTPU_BACKEND", "TPU")
    with pytest.raises(ValueError, match="CMTPU_BACKEND=torch"):
        be.get_backend()
    assert be._backend is None
    assert "tpu" not in be.BACKEND_CHOICES and "torch" in be.BACKEND_CHOICES


@pytest.mark.parametrize("choice", ["auto", "torch", "hybrid"])
def test_device_choices_raise_without_a_card(monkeypatch, choice):
    """No choice that names the card falls back to the CPU: without one,
    each raises (auto through build_resilient's hybrid tier)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback path is not reachable")
    monkeypatch.setenv("CMTPU_BACKEND", choice)
    with pytest.raises(RuntimeError, match="CUDA"):
        be.get_backend()
    assert be._backend is None
