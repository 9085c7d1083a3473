"""ABCI over gRPC and the gRPC broadcast API in the port
(``abci/grpc.py``, ``rpc/grpc_server.py``), held to the JAX package's,
modelled on its ``tests/test_abci_grpc.py``:

- each package's ``GrpcClient`` against each package's ``GrpcServer`` over
  TCP: the same responses, byte for byte; over absolute and relative unix
  sockets;
- an app exception surfaces as ``RuntimeError`` with the JAX package's text;
- the CLI over ``grpc://`` prints what the JAX package's prints;
- a port node (``default_new_node`` with a ``grpc://`` proxy_app) whose
  kvstore runs in another process;
- the broadcast API (``rpc.grpc_laddr``) of a live port node, driven by both
  packages' ``broadcast_client``.

Waits are liveness guards (``torch_nodes.wait``), never time bounds."""

import os
import re
import signal
import subprocess
import sys
import types

import pytest

import cometbft_tpu.abci.types as ref_abci
from cometbft_tpu.abci import cli as ref_cli
from cometbft_tpu.abci import grpc as ref_grpc
from cometbft_tpu.abci import wire as ref_aw
from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
from cometbft_tpu.types.block import Header as RefHeader
import cometbft_tpu_torch.abci.types as abci
import torch_nodes as tn
from cometbft_tpu_torch.abci import cli
from cometbft_tpu_torch.abci import grpc as agrpc
from cometbft_tpu_torch.abci import wire as aw
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.types.block import Header

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "port": types.SimpleNamespace(abci=abci, aw=aw, grpc=agrpc, KV=KVStoreApplication,
                                  Header=Header, module="cometbft_tpu_torch"),
    "reference": types.SimpleNamespace(abci=ref_abci, aw=ref_aw, grpc=ref_grpc, KV=RefKV,
                                       Header=RefHeader, module="cometbft_tpu"),
}


def _scenario(side, c):
    a = side.abci
    out = [c.echo("ping"), c.info(a.RequestInfo(version="x")),
           c.check_tx(a.RequestCheckTx(tx=b"a=1")),
           c.begin_block(a.RequestBeginBlock(header=side.Header(height=1))),
           c.deliver_tx(a.RequestDeliverTx(tx=b"a=1")), c.end_block(a.RequestEndBlock(height=1)),
           c.commit(), c.query(a.RequestQuery(path="/store", data=b"a")),
           c.list_snapshots(a.RequestListSnapshots()),
           c.offer_snapshot(a.RequestOfferSnapshot()),
           c.load_snapshot_chunk(a.RequestLoadSnapshotChunk(height=1, format=1, chunk=0)),
           c.prepare_proposal(a.RequestPrepareProposal(max_tx_bytes=100, txs=[b"x=1"])),
           c.process_proposal(a.RequestProcessProposal(txs=[b"x=1"]))]
    c.flush()
    got = []
    c.check_tx_async(a.RequestCheckTx(tx=b"b=2"), callback=got.append)
    tn.wait(lambda: got, "the async CheckTx never called back")
    return [side.aw.encode_response(r) for r in out + got]


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "reference"), ("reference", "port")])
def test_grpc_pairs_answer_as_the_reference(client_pkg, server_pkg):
    answers = []
    for c, s in ((client_pkg, server_pkg), ("reference", "reference")):
        srv = SIDES[s].grpc.GrpcServer(SIDES[s].KV(), "grpc://127.0.0.1:0")
        bound = srv.start()
        try:
            client = SIDES[c].grpc.GrpcClient(bound, connect_timeout=30.0)
            try:
                answers.append(_scenario(SIDES[c], client))
            finally:
                client.close()
        finally:
            srv.stop()
    assert answers[0] == answers[1] and len(answers[0]) == 14


def test_grpc_over_unix_sockets(tmp_path, monkeypatch):
    """The bound address of a unix target dials, for an absolute and a
    relative path, across the packages."""
    srv = agrpc.GrpcServer(KVStoreApplication(), f"unix://{tmp_path}/abci-grpc.sock")
    bound = srv.start()
    try:
        assert bound == f"grpc://unix:{tmp_path}/abci-grpc.sock"
        for side in SIDES.values():
            client = side.grpc.GrpcClient(bound, connect_timeout=30.0)
            assert client.echo("over-unix").message == "over-unix"
            assert client.check_tx(side.abci.RequestCheckTx(tx=b"u=1")).is_ok()
            client.close()
    finally:
        srv.stop()
    monkeypatch.chdir(tmp_path)
    srv = ref_grpc.GrpcServer(RefKV(), "unix://rel-abci.sock")
    bound = srv.start()
    try:
        assert bound == "grpc://unix:rel-abci.sock"
        client = agrpc.GrpcClient(bound, connect_timeout=30.0)
        assert client.echo("rel").message == "rel"
        client.close()
    finally:
        srv.stop()
    for addr in ("unix://a.sock", "grpc:///tmp/x", "tcp://h:1", "grpc://unix:r.sock", "h:2"):
        assert agrpc._strip_scheme(addr) == ref_grpc._strip_scheme(addr)


def test_grpc_app_exception_surfaces_as_runtime_error():
    texts = []
    for server_side in (SIDES["port"], SIDES["reference"]):
        class Boom(server_side.abci.Application):
            def info(self, req):
                raise RuntimeError("boom")

        srv = server_side.grpc.GrpcServer(Boom(), "grpc://127.0.0.1:0")
        bound = srv.start()
        try:
            client = agrpc.GrpcClient(bound, connect_timeout=30.0)
            with pytest.raises(RuntimeError) as e:
                client.info(abci.RequestInfo())
            texts.append(str(e.value))
            client.close()
        finally:
            srv.stop()
    assert texts[0] == texts[1] == "ABCI app exception: RuntimeError: boom"


def test_a_dead_address_raises_as_the_reference():
    for side in SIDES.values():
        with pytest.raises(ConnectionError, match="cannot connect to ABCI app at grpc://"):
            side.grpc.GrpcClient("grpc://127.0.0.1:1", connect_timeout=0.3)


@pytest.fixture
def grpc_app():
    procs = []

    def start(pkg="port"):
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{SIDES[pkg].module}.abci.server", "kvstore",
             "--transport", "grpc", "--addr", "grpc://127.0.0.1:0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        procs.append(proc)
        line = proc.stdout.readline()
        m = re.search(r"listening on (grpc://[\d.]+:\d+)", line)
        assert m, f"no listen line: {line!r}"
        return m.group(1)

    yield start
    for proc in procs:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        proc.stdout.close()


def test_cli_over_grpc_prints_what_the_reference_prints(grpc_app, capsys):
    runs = [["echo", "ping"], ["deliver_tx", "cli=works"], ["commit"], ["query", "cli"]]
    outs = []
    for main in (cli.main, ref_cli.main):
        addr = grpc_app()
        rcs = [main(["--addr", addr, *args]) for args in runs]
        outs.append((rcs, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == [0] * 4 and "value: 0x" + b"works".hex().upper() in outs[0][1]


@pytest.fixture
def cpu_backend():
    port = tn.PKGS["port"].backend
    old = port._backend
    port.set_backend(port.CpuBackend())
    yield
    port._backend = old


def _one_validator_home(tmp_path, name, **fields):
    from cometbft_tpu.crypto import ed25519 as ref_ed
    from cometbft_tpu.types import GenesisDoc, GenesisValidator, Time

    secret = b"torch-grpc-" + name.encode()
    pub = ref_ed.gen_priv_key_from_secret(secret).pub_key()
    gen = GenesisDoc(chain_id="torch-grpc-chain", genesis_time=Time(1_700_000_000, 0),
                     validators=[GenesisValidator(pub.address(), pub, 10, "v0")])
    gen.validate_and_complete()
    p = tn.PKGS["port"]
    os.makedirs(tmp_path / "keys", exist_ok=True)
    key = tn.pv_key_json(p, secret, str(tmp_path / "keys" / f"{name}.json"))
    home = str(tmp_path / name)
    tn.write_home(p, home, tn.node_config(p, p2p__laddr="", **fields), gen.to_json(),
                  pv_key_json=key)
    return home


def test_port_node_with_an_out_of_process_grpc_app(tmp_path, grpc_app, cpu_backend):
    addr = grpc_app("reference")
    node = tn.load_node(tn.PKGS["port"], _one_validator_home(
        tmp_path, "node", base__proxy_app=addr, rpc__laddr=""))
    assert type(node.proxy_app.consensus).__name__ == "GrpcClient"
    node.start()
    try:
        tn.wait(lambda: node.block_store.height() >= 3, "the grpc-app chain stalled")
        node.mempool.check_tx(b"grpc=works")
        tn.wait(lambda: node.proxy_app.query.query(
            abci.RequestQuery(path="/store", data=b"grpc")).value == b"works",
            "the tx never reached the app")
    finally:
        node.stop()
    assert node.threads_left_at_stop == 0


def test_broadcast_api_of_a_live_port_node(tmp_path, cpu_backend):
    """Ping and BroadcastTx (BroadcastTxCommit semantics) on the node's
    ``rpc.grpc_laddr``, from both packages' clients: CheckTx and DeliverTx
    code 0, the tx committed; the request and answer bytes are the JAX
    package's."""
    from cometbft_tpu.rpc import grpc_server as ref_gs
    from cometbft_tpu_torch.rpc import grpc_server as gs

    node = tn.load_node(tn.PKGS["port"], _one_validator_home(
        tmp_path, "bcast", rpc__grpc_laddr="tcp://127.0.0.1:0"))
    node.start()
    try:
        tn.wait(lambda: node.block_store.height() >= 2, "the chain stalled")
        assert node.grpc_server is not None and node.grpc_server.bound.startswith("127.0.0.1:")
        for i, client in enumerate((gs.broadcast_client, ref_gs.broadcast_client)):
            ping, broadcast_tx = client(node.grpc_server.bound, connect_timeout=30.0)
            ping()
            check_tx, deliver_tx = broadcast_tx(b"grpcapi%d=%d" % (i, i))
            assert (check_tx.code, deliver_tx.code) == (0, 0), (check_tx, deliver_tx)
            q = node.proxy_app.query.query(abci.RequestQuery(path="/store", data=b"grpcapi%d" % i))
            assert q.value == b"%d" % i
        ct = {"code": 3, "data": "ZGF0YQ==", "log": "l", "codespace": "c"}
        dt = {"code": 0, "data": "", "log": "", "gas_wanted": "7", "gas_used": "2"}
        assert gs._enc_response_broadcast_tx(ct, dt) == ref_gs._enc_response_broadcast_tx(ct, dt)
    finally:
        node.stop()
    assert node.threads_left_at_stop == 0
