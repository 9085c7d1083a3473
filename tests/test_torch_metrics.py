"""The port's metrics (``libs/metrics.py``, ``consensus/metrics.py``, the
node's ``instrumentation.prometheus`` branch) against the JAX package's,
after ``tests/test_metrics.py``:

- the text exposition is byte-equal for the same operations (counters,
  labelled and escaped gauges, histograms, gauge functions, a sampler that
  raises), and the consensus ``Metrics`` render the same;
- a sampler that raises leaves its sample out in both packages; the port
  counts it on the registry;
- a port node's ``/metrics`` has the reference node's names under the same
  config, and its height advances; the engine gauges read the same counts
  as the reference's over each package's scheduler;
- a scrape never builds the process backend, imports a kernel module or
  initialises CUDA (in a fresh interpreter).

Waits are liveness guards, never time bounds."""

import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from cometbft_tpu.consensus.metrics import Metrics as RefCsMetrics
from cometbft_tpu.libs import metrics as ref_metrics
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu_torch.consensus.metrics import Metrics as CsMetrics
from cometbft_tpu_torch.libs import metrics
from cometbft_tpu_torch.sidecar import backend

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 180.0


def _counters(reg):
    c = reg.counter("cs", "total_txs", "Total txs.")
    c.inc(3)
    c.inc(0.5)
    lc = reg.counter("p2p", "bytes", "Bytes by peer.", labels=("peer", "dir"))
    lc.labels(peer="b", dir="in").inc(10)
    lc.labels(peer="a", dir="out").inc(2)
    lc.labels(peer="a", dir="in").inc()


def _gauges(reg):
    g = reg.gauge("cs", "height", "Height.", labels=("chain",))
    g.labels(chain="a").set(7)
    g.labels(chain='q"uote\\back\nline').set(-1.25)
    u = reg.gauge("", "bare", "")
    u.set(1e21)
    u.inc(2)
    u.dec(0.5)


def _histograms(reg):
    h = reg.histogram("cs", "interval", "Interval.", buckets=(0.1, 1))
    for v in (0.05, 0.5, 5, 1, 0.1):
        h.observe(v)
    d = reg.histogram("cs", "round_duration_seconds", "Rounds.", labels=("r",))
    d.labels(r="0").observe(0.3)
    d.labels(r="1").observe(12)


def _gauge_funcs(reg):
    reg.gauge_func("mempool", "size", "Size.", lambda: 42)
    reg.gauge_func("mempool", "ratio", "Ratio.", lambda: 2 / 3)
    reg.gauge_func("mempool", "broken", "Raises.", lambda: 1 / 0)
    reg.gauge_func("mempool", "inf", "Inf.", lambda: float("inf"))


@pytest.mark.parametrize("ops", [_counters, _gauges, _histograms, _gauge_funcs],
                         ids=["counters", "gauges", "histograms", "gauge_funcs"])
def test_exposition_is_byte_equal_to_the_reference(ops):
    port, ref = metrics.Registry(namespace="cmt"), ref_metrics.Registry(namespace="cmt")
    ops(port)
    ops(ref)
    assert port.render() == ref.render()
    assert port.render().endswith("\n")


def test_consensus_metrics_render_the_same():
    port, ref = metrics.Registry("cometbft"), ref_metrics.Registry("cometbft")
    for m in (CsMetrics(port), RefCsMetrics(ref)):
        m.height.set(5)
        m.rounds.set(1)
        m.validators.set(4)
        m.validators_power.set(40)
        m.num_txs.set(3)
        m.total_txs.inc(3)
        m.block_interval_seconds.observe(1.2)
        m.round_duration_seconds.observe(0.8)
        m.block_parts.labels(peer_id="abc").inc(2)
        m.consensus_stalls_total.inc()
        m.wal_replay_round.set(2)
    assert port.render() == ref.render()
    assert "cometbft_consensus_stalls_total 1" in port.render()


def test_a_raising_sampler_is_left_out_and_counted():
    """Both packages leave the sample out; the port's registry counts the
    exception and keeps the last one (the reference passes over it)."""
    port, ref = metrics.Registry("x"), ref_metrics.Registry("x")
    for reg in (port, ref):
        reg.gauge_func("s", "ok", "", lambda: 1)
        reg.gauge_func("s", "bad", "", lambda: {}["missing"])
    body = port.render()
    assert body == ref.render()
    assert "\nx_s_bad " not in body and "\nx_s_ok 1" in body
    port.render()
    assert port.sample_errors == 2 and isinstance(port.last_sample_error, KeyError)
    assert not hasattr(ref, "sample_errors")


def test_metrics_server_serves_and_joins():
    reg = metrics.Registry("cometbft")
    reg.gauge("t", "v", "V.").set(3)
    srv = metrics.MetricsServer(reg, "127.0.0.1", 0)
    srv.start()
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read()
        assert body.decode() == reg.render()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other", timeout=30)
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


# -- nodes -----------------------------------------------------------------------


def _solo_node(pkg: str, tag: bytes):
    """A one-validator node of either package: memdb, no RPC, no p2p,
    Prometheus on 127.0.0.1:0."""
    from importlib import import_module

    m = lambda name: import_module(f"{pkg}.{name}")  # noqa: E731
    ed = m("crypto.ed25519")
    pv = m("privval").FilePV(ed.gen_priv_key_from_secret(tag))
    g = m("types.genesis")
    gen = g.GenesisDoc(chain_id="metrics-chain", genesis_time=m("types").cmttime.now(),
                       validators=[g.GenesisValidator(pv.get_pub_key().address(),
                                                      pv.get_pub_key(), 10, "v0")])
    gen.validate_and_complete()
    cfg = m("config").test_config()
    cfg.base.db_backend = "memdb"
    cfg.rpc.laddr = ""
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    return m("node.node").Node(cfg, gen, pv, m("abci.client").LocalClientCreator(
        m("abci.example.kvstore").KVStoreApplication()))


def _scrape(node) -> str:
    url = f"http://127.0.0.1:{node.metrics_server.port}/metrics"
    return urllib.request.urlopen(url, timeout=30).read().decode()


def _values(body: str) -> dict:
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, _, v = line.rpartition(" ")
            out[name] = float(v)
    return out


def _names(body: str) -> list:
    return [line.split()[2] for line in body.splitlines() if line.startswith("# TYPE ")]


@pytest.fixture
def cpu_backends():
    old = (backend._backend, ref_backend._backend)
    backend.set_backend(backend.CpuBackend())
    ref_backend.set_backend(ref_backend.CpuBackend())
    yield
    backend._backend, ref_backend._backend = old


def test_node_metrics_names_equal_the_reference_and_height_advances(cpu_backends):
    nodes = {"port": _solo_node("cometbft_tpu_torch", b"metrics-port"),
             "reference": _solo_node("cometbft_tpu", b"metrics-ref")}
    bodies = {}
    try:
        for nd in nodes.values():
            nd.start()
        port = nodes["port"]
        first = _values(_scrape(port))["cometbft_blockstore_height"]
        port.mempool.check_tx(b"metric=1")
        for name, nd in nodes.items():
            deadline = time.monotonic() + WAIT_S
            while nd.block_store.height() < first + 3:
                assert time.monotonic() < deadline, f"{name} node stopped committing"
                time.sleep(0.02)
            bodies[name] = _scrape(nd)
    finally:
        for nd in nodes.values():
            nd.stop()
    assert _names(bodies["port"]) == _names(bodies["reference"])
    vals = _values(bodies["port"])
    assert vals["cometbft_blockstore_height"] >= first + 3
    assert vals["cometbft_consensus_height"] >= first + 2
    assert vals["cometbft_consensus_validators"] == 1
    assert vals["cometbft_consensus_validators_power"] == 10
    assert vals["cometbft_consensus_total_txs"] >= 1
    assert vals["cometbft_p2p_peers"] == 0
    assert "cometbft_consensus_block_interval_seconds_count" in vals
    assert port.metrics_registry.sample_errors == 0
    assert port.threads_left_at_stop == 0 and not port.metrics_server._thread.is_alive()


def test_engine_gauges_read_the_schedulers_counts_as_the_reference(cpu_backends):
    """Over each package's CoalescingScheduler on its CpuBackend, the same
    calls (a blocksync-class batch, a consensus-class one) read the same
    engine_* and scheduler_* gauges."""
    from cometbft_tpu.crypto import ed25519 as ref_ed
    from cometbft_tpu.sidecar import engine as ref_engine
    from cometbft_tpu.sidecar.scheduler import CoalescingScheduler as RefScheduler
    from cometbft_tpu_torch.sidecar import engine
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler

    keys = [ref_ed.gen_priv_key_from_secret(b"eng-%d" % i) for i in range(3)]
    pubs = [k.pub_key().bytes() for k in keys]
    msgs = [b"m%d" % i for i in range(3)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    vals = {}
    for name, be, eng_mod, sched_cls in (
        ("port", backend, engine, CoalescingScheduler),
        ("reference", ref_backend, ref_engine, RefScheduler),
    ):
        sched = sched_cls(be.CpuBackend())
        be.set_backend(sched)
        try:
            nd = _solo_node("cometbft_tpu_torch" if name == "port" else "cometbft_tpu",
                            b"eng-node")
            try:
                nd.metrics_server.start()
                with eng_mod.submission_class(eng_mod.CLASS_BLOCKSYNC):
                    assert sched.batch_verify(pubs, msgs, sigs)[0]
                with eng_mod.submission_class(eng_mod.CLASS_CONSENSUS):
                    assert sched.batch_verify(pubs[:2], msgs[:2], sigs[:2])[0]
                body = _values(_scrape(nd))
                vals[name] = {k: v for k, v in body.items()
                              if k.startswith(("cometbft_engine_", "cometbft_scheduler_"))
                              and not k.endswith("_p95_us")}
                if name == "port":
                    assert nd.metrics_registry.sample_errors == 0
            finally:
                nd.stop()
        finally:
            sched.close()
    assert vals["port"] == vals["reference"]
    assert vals["port"]["cometbft_engine_blocksync_dispatched_sigs"] == 3
    assert vals["port"]["cometbft_engine_consensus_dispatched_sigs"] == 2


def test_an_engine_sampler_that_raises_reads_zero_and_is_counted(cpu_backends):
    """The reference's engine sampler swallows an exception and reads 0;
    the port reads the same 0 and counts it on the registry."""
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler

    sched = CoalescingScheduler(backend.CpuBackend())
    backend.set_backend(sched)
    nd = _solo_node("cometbft_tpu_torch", b"eng-raise")
    try:
        nd.metrics_server.start()
        sched.engine.class_counters_ = None  # every per-class read raises
        body = _values(_scrape(nd))
        assert body["cometbft_engine_blocksync_admitted"] == 0
        assert nd.metrics_registry.sample_errors > 0
        assert isinstance(nd.metrics_registry.last_sample_error, TypeError)
    finally:
        nd.stop()
        sched.engine.class_counters_ = [dict(a=0)] * 4
        sched.close()


def test_a_bare_grpc_backend_reads_tier_zero_and_counts_no_error():
    """F15: under ``CMTPU_BACKEND=grpc`` the installed backend has
    ``counters()`` but no ``active_tier_index``. The reference's sampler
    raises on it at every scrape and drops the sample; the port's reads
    the one tier, 0, and counts no error. Neither dials the sidecar."""
    from cometbft_tpu.sidecar.service import GrpcBackend as RefGrpcBackend
    from cometbft_tpu_torch.sidecar.service import GrpcBackend

    old = (backend._backend, ref_backend._backend)
    backend.set_backend(GrpcBackend("127.0.0.1:1"))
    ref_backend.set_backend(RefGrpcBackend("127.0.0.1:1"))
    bodies = {}
    try:
        for name, pkg in (("port", "cometbft_tpu_torch"), ("reference", "cometbft_tpu")):
            nd = _solo_node(pkg, b"grpc-" + name.encode())
            try:
                nd.metrics_server.start()
                bodies[name] = _values(_scrape(nd))
                if name == "port":
                    assert nd.metrics_registry.sample_errors == 0
            finally:
                nd.stop()
    finally:
        backend._backend, ref_backend._backend = old
    assert bodies["port"]["cometbft_backend_active_tier"] == 0
    assert bodies["port"]["cometbft_backend_trips"] == 0
    assert "cometbft_backend_active_tier" not in bodies["reference"]
    assert bodies["reference"]["cometbft_backend_trips"] == 0


SCRAPE_CODE = r"""
import sys, urllib.request
import torch
from cometbft_tpu_torch.sidecar import backend
def refuse():
    raise AssertionError("a scrape built the process backend")
backend._make_backend = refuse
sys.path.insert(0, "tests")
import test_torch_metrics as t
nd = t._solo_node("cometbft_tpu_torch", b"passive")
kernel_before = "cometbft_tpu_torch.ops.ed25519_kernel" in sys.modules
nd.metrics_server.start()
try:
    body = t._scrape(nd)
finally:
    nd.stop()
print(repr((backend._backend is None, kernel_before,
            "cometbft_tpu_torch.ops.ed25519_kernel" in sys.modules,
            torch.cuda.is_initialized(), nd.metrics_registry.sample_errors,
            "cometbft_mesh_devices 0" in body, "cometbft_backend_trips 0" in body)))
"""


def test_a_scrape_leaves_the_backend_unbuilt():
    """In a fresh interpreter: a port node with Prometheus on, scraped with
    no backend built (``_make_backend`` refuses), leaves the backend
    unbuilt, imports no kernel module that was not imported, initialises no
    CUDA, and counts no sampler error; the device gauges read 0."""
    out = subprocess.run([sys.executable, "-c", SCRAPE_CODE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    built_none, before, after, cuda, errors, mesh0, trips0 = eval(out.stdout.strip().splitlines()[-1])
    assert built_none and after == before and not cuda and errors == 0 and mesh0 and trips0
