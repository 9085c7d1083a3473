"""The port's tooling on the CPU: the profiling endpoints
(``libs/pprof.py``) as the reference's test drives them, and the torch ones
(``/debug/torch/memory`` says there is no card, ``/debug/torch/trace``
writes a Chrome trace); ``entry()`` and ``dryrun_multichip(8,
device="cpu")`` against the reference's example batch and host tree, as
``tests/test_mesh.py`` runs the reference's; and the device probe, which
exits nonzero without a card and says so."""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from cometbft_tpu.libs import pprof as ref_pprof
from cometbft_tpu_torch.libs import pprof

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60).read().decode()


@pytest.fixture
def server():
    srv = pprof.PprofServer(port=0)
    srv.start()
    yield srv
    srv.stop()


def test_pprof_endpoints(server):
    idx = _get(server.port, "/debug/pprof/")
    assert "goroutine" in idx
    assert "/debug/torch/memory" in idx and "/debug/torch/trace" in idx and "jax" not in idx
    stacks = _get(server.port, "/debug/pprof/goroutine")
    assert "MainThread" in stacks and "test_pprof_endpoints" in stacks
    assert "tracemalloc" in _get(server.port, "/debug/pprof/heap")
    assert "samples" in _get(server.port, "/debug/pprof/profile?seconds=0.3")
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server.port, "/debug/jax/memory")
    assert err.value.code == 404


def test_profiles_have_the_references_shape():
    """thread_stacks, sample_profile and heap_profile are the reference's
    (the same headers and markers)."""
    for fn in (pprof.thread_stacks, ref_pprof.thread_stacks):
        assert "MainThread" in fn() and "(ident " in fn()
    stop = threading.Event()

    def hot_spin_loop():
        while not stop.is_set():
            sum(range(500))

    t = threading.Thread(target=hot_spin_loop, daemon=True)
    t.start()
    try:
        for fn in (pprof.sample_profile, ref_pprof.sample_profile):
            prof = fn(seconds=0.3, hz=200)
            assert prof.startswith("# wall-clock samples:") and "hot_spin_loop" in prof
    finally:
        stop.set()
        t.join()


def test_torch_memory_says_there_is_no_card(server):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    body = _get(server.port, "/debug/torch/memory")
    assert body == pprof.torch_memory() == "no CUDA device: torch.cuda.is_available() is False"


def test_torch_trace_writes_a_chrome_trace(server, tmp_path):
    stop = threading.Event()

    def work():
        x = torch.ones(8)
        while not stop.wait(0.01):
            x = x.add(1)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        body = _get(server.port, f"/debug/torch/trace?seconds=0.3&dir={tmp_path}")
    finally:
        stop.set()
        t.join()
    assert body.startswith("trace written to ") and str(tmp_path) in body
    traces = list(tmp_path.glob("torch-trace-*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    if not torch.cuda.is_available():
        assert "no CUDA device: CPU activities only" in body


def test_entry_is_the_references_example_batch():
    """entry(device="cpu"): the port's verify program over the same packed
    operands as the reference's make_example_batch(128), all valid."""
    import __graft_entry__ as ref_entry

    from cometbft_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    ref_fn, ref_args = ref_entry.entry()
    assert fn.__name__ == ref_fn.__name__ == "verify_core"
    assert len(args) == len(ref_args) == 5
    for a, r in zip(args, ref_args):
        assert a.device.type == "cpu"
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(r).view(np.uint32))
    out = fn(*args)
    assert out.shape == (128,) and bool(out.all())


def test_dryrun_multichip_on_eight_virtual_shards(capsys):
    from cometbft_tpu_torch.entry import dryrun_multichip

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        dryrun_multichip(8, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert "dryrun_multichip(8) on cpu: ok" in capsys.readouterr().out


def test_dryrun_multichip_refuses_the_card_without_one():
    from cometbft_tpu_torch.entry import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_device_probe_stops_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable, "-m", "cometbft_tpu_torch.probe.device"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    lines = out.stdout.splitlines()
    assert lines[0].endswith("start") and "imported" in lines[1]
    assert "no CUDA device" in lines[-1] and "PROBE OK" not in out.stdout
