"""A request that a reference surface tags with the reference's
``submission_class`` reaches the port's engine with that class: inside the
reference's ``submission_class(CLASS_CONSENSUS)`` the port's scheduler
admits one all-zero triple as consensus (class 0), as the reference's own
scheduler does, not as blocksync (class 1)."""

import pytest

from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.sidecar import engine as ref_engine
from cometbft_tpu.sidecar.scheduler import CoalescingScheduler as RefScheduler
from cometbft_tpu_torch.sidecar import engine
from cometbft_tpu_torch.sidecar.backend import TorchBackend
from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler

pytestmark = pytest.mark.torch_port

TRIPLE = ([bytes(32)], [b""], [bytes(64)])


def _admitted(sched) -> dict:
    classes = sched.engine.counters()["classes"]
    return {k: classes[name]["admitted"] for k, name in enumerate(engine.CLASS_NAMES)}


@pytest.mark.parametrize("klass", [ref_engine.CLASS_CONSENSUS, ref_engine.CLASS_LIGHT, None])
def test_reference_tag_reaches_the_port_engine(klass):
    want_class = ref_engine.CLASS_BLOCKSYNC if klass is None else klass
    port = CoalescingScheduler(TorchBackend(device="cpu"))
    ref = RefScheduler(ref_backend.CpuBackend())
    try:
        for sched in (port, ref):
            if klass is None:
                assert sched.batch_verify(*TRIPLE) == (True, [True])
            else:
                with ref_engine.submission_class(klass):
                    assert sched.batch_verify(*TRIPLE) == (True, [True])
        want = {k: int(k == want_class) for k in range(4)}
        assert _admitted(port) == want
        assert _admitted(ref) == want
    finally:
        port.close()
        ref.close()


def test_the_port_tag_wins_over_the_reference_tag():
    with ref_engine.submission_class(ref_engine.CLASS_LIGHT):
        assert engine.current_class() == ref_engine.CLASS_LIGHT
        with engine.submission_class(engine.CLASS_CONSENSUS):
            assert engine.current_class() == engine.CLASS_CONSENSUS
    assert engine.current_class() == engine.CLASS_BLOCKSYNC
