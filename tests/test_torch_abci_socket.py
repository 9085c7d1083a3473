"""The ABCI socket transport of the port (``abci/server.py``,
``abci/client.py``'s ``SocketClient``, ``abci/cli.py``) held to the JAX
package's, modelled on its ``tests/test_abci_socket.py``:

- each package's ``SocketClient`` against each package's ``ABCIServer``
  (four pairs) over a unix socket: the same responses, byte for byte;
- a port node (``default_new_node`` with a ``tcp://`` proxy_app) whose
  kvstore runs in another process, served by either package's
  ``python -m ...abci.server``; an empty-store node against the taller app
  fails its handshake as the JAX package's does;
- the CLI's output and the server's listen line equal the JAX package's;
- ``AppConns.stop()`` closes every client.

Waits are liveness guards (``torch_nodes.wait``), never time bounds."""

import os
import re
import signal
import subprocess
import sys
import threading
import types

import pytest

import cometbft_tpu.abci.types as ref_abci
from cometbft_tpu.abci import cli as ref_cli
from cometbft_tpu.abci import wire as ref_aw
from cometbft_tpu.abci.client import SocketClient as RefSocketClient
from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
from cometbft_tpu.abci.server import ABCIServer as RefServer
from cometbft_tpu.types.block import Header as RefHeader
import cometbft_tpu_torch.abci.types as abci
import torch_nodes as tn
from cometbft_tpu_torch.abci import cli
from cometbft_tpu_torch.abci import wire as aw
from cometbft_tpu_torch.abci.client import SocketClient, SocketClientCreator
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.abci.server import ABCIServer, parse_addr
from cometbft_tpu_torch.types.block import Header

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "port": types.SimpleNamespace(abci=abci, aw=aw, Client=SocketClient, Server=ABCIServer,
                                  KV=KVStoreApplication, Header=Header, module="cometbft_tpu_torch"),
    "reference": types.SimpleNamespace(abci=ref_abci, aw=ref_aw, Client=RefSocketClient,
                                       Server=RefServer, KV=RefKV, Header=RefHeader,
                                       module="cometbft_tpu"),
}


def _scenario(cli_side, cli_obj):
    """test_abci_socket.py's request surface, as encoded responses."""
    a = cli_side.abci
    out = [cli_obj.echo("ping"), cli_obj.info(a.RequestInfo(version="x")),
           cli_obj.check_tx(a.RequestCheckTx(tx=b"a=1")),
           cli_obj.check_tx(a.RequestCheckTx(tx=b"")),
           cli_obj.begin_block(a.RequestBeginBlock(header=cli_side.Header(height=1))),
           cli_obj.deliver_tx(a.RequestDeliverTx(tx=b"a=1")),
           cli_obj.deliver_tx(a.RequestDeliverTx(tx=b"b=2")),
           cli_obj.end_block(a.RequestEndBlock(height=1)), cli_obj.commit(),
           cli_obj.query(a.RequestQuery(path="/store", data=b"a")),
           cli_obj.query(a.RequestQuery(path="/store", data=b"zz")),
           cli_obj.list_snapshots(a.RequestListSnapshots()),
           cli_obj.prepare_proposal(a.RequestPrepareProposal(max_tx_bytes=100, txs=[b"x=1"])),
           cli_obj.process_proposal(a.RequestProcessProposal(txs=[b"x=1"]))]
    cli_obj.flush()
    got = []
    cli_obj.check_tx_async(a.RequestCheckTx(tx=b"c=3"), callback=got.append)
    tn.wait(lambda: got, "the async CheckTx never called back")
    out.append(got[0])
    return [cli_side.aw.encode_response(r) for r in out]


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "port"), ("port", "reference"), ("reference", "port")])
def test_socket_pairs_answer_as_the_reference(tmp_path, client_pkg, server_pkg):
    answers = []
    for c, s in ((client_pkg, server_pkg), ("reference", "reference")):
        srv = SIDES[s].Server(SIDES[s].KV(), f"unix://{tmp_path}/{c}-{s}.sock")
        bound = srv.start()
        try:
            client = SIDES[c].Client(bound)
            try:
                answers.append(_scenario(SIDES[c], client))
            finally:
                client.close()
        finally:
            srv.stop()
    assert answers[0] == answers[1] and len(answers[0]) == 15


def test_app_exception_is_a_runtime_error_with_the_reference_text(tmp_path):
    texts = []
    for name in ("port", "reference"):
        s = SIDES[name]

        class Boom(s.abci.Application):
            def info(self, req):
                raise RuntimeError("boom")

        srv = s.Server(Boom(), f"unix://{tmp_path}/boom-{name}.sock")
        bound = srv.start()
        try:
            client = s.Client(bound)
            with pytest.raises(RuntimeError) as e:
                client.info(s.abci.RequestInfo())
            texts.append(str(e.value))
            assert client.echo("still").message == "still"
            client.close()
        finally:
            srv.stop()
    assert texts[0] == texts[1] == "ABCI app exception: boom"


def test_parse_addr_and_connect_error_match_the_reference(tmp_path):
    from cometbft_tpu.abci.server import parse_addr as ref_parse

    for addr in ("tcp://127.0.0.1:26658", "unix:///tmp/x.sock", "127.0.0.1:9", "tcp://:7"):
        assert parse_addr(addr) == ref_parse(addr)
    for side in SIDES.values():
        with pytest.raises(ConnectionError, match="cannot connect to ABCI app at unix://"):
            side.Client(f"unix://{tmp_path}/none.sock", connect_timeout=0.2)


def _start_app(pkg: str, app: str = "kvstore", *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{SIDES[pkg].module}.abci.server", app,
         "--addr", "tcp://127.0.0.1:0", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = proc.stdout.readline()
    m = re.search(r"listening on (tcp://[\d.]+:\d+)", line)
    assert m, f"no listen line: {line!r}"
    return proc, m.group(1), line


def _end(proc) -> None:
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    proc.stdout.close()


@pytest.fixture
def app_procs():
    procs = []
    yield lambda *a: procs.append(_start_app(*a)) or procs[-1]
    for proc, _, _ in procs:
        _end(proc)


def test_server_main_prints_the_reference_listen_line(app_procs):
    lines = [app_procs(pkg, "persistent_kvstore", "--snapshot-interval", "4")[2]
             for pkg in ("port", "reference")]
    addrs = [re.search(r"tcp://\S+", ln).group(0) for ln in lines]
    assert lines[0].replace(addrs[0], "ADDR") == lines[1].replace(addrs[1], "ADDR")
    assert lines[0].startswith("ABCI server (persistent_kvstore) listening on tcp://127.0.0.1:")


@pytest.fixture
def cpu_backends():
    port = tn.PKGS["port"].backend
    old = port._backend
    port.set_backend(port.CpuBackend())
    yield
    port._backend = old


def _one_validator_home(tmp_path, name, secret, **fields):
    from cometbft_tpu.crypto import ed25519 as ref_ed
    from cometbft_tpu.types import GenesisDoc, GenesisValidator, Time

    pub = ref_ed.gen_priv_key_from_secret(secret).pub_key()
    gen = GenesisDoc(chain_id="torch-socket-chain", genesis_time=Time(1_700_000_000, 0),
                     validators=[GenesisValidator(pub.address(), pub, 10, "v0")])
    gen.validate_and_complete()
    p = tn.PKGS["port"]
    os.makedirs(tmp_path / "keys", exist_ok=True)
    key = tn.pv_key_json(p, secret, str(tmp_path / "keys" / f"{name}.json"))
    home = str(tmp_path / name)
    tn.write_home(p, home, tn.node_config(p, rpc__laddr="", p2p__laddr="", **fields),
                  gen.to_json(), pv_key_json=key)
    return home


@pytest.mark.parametrize("app_pkg", ["port", "reference"])
def test_port_node_with_an_out_of_process_app(tmp_path, app_procs, cpu_backends, app_pkg):
    """A one-validator port node built by ``default_new_node`` with a
    ``tcp://`` proxy_app commits against a kvstore in another process; an
    empty-store node against that taller app fails its handshake, as a JAX
    package node does, with the same error."""
    _, addr, _ = app_procs(app_pkg)
    home = _one_validator_home(tmp_path, "node", b"torch-socket-node", base__proxy_app=addr)
    node = tn.load_node(tn.PKGS["port"], home)
    assert type(node.proxy_app.consensus).__name__ == "SocketClient"
    node.start()
    try:
        tn.wait(lambda: node.block_store.height() >= 3, "the socket-app chain stalled")
        node.mempool.check_tx(b"socket=works")
        tn.wait(lambda: node.proxy_app.query.query(
            abci.RequestQuery(path="/store", data=b"socket")).value == b"works",
            "the tx never reached the app")
    finally:
        node.stop()
    assert node.threads_left_at_stop == 0
    errors = []
    home2 = _one_validator_home(tmp_path, "node2", b"torch-socket-node", base__proxy_app=addr,
                                base__db_backend="memdb")
    with pytest.raises(Exception) as e:
        tn.load_node(tn.PKGS["port"], home2)
    errors.append((type(e.value).__name__, re.sub(r"\d+", "N", str(e.value))))
    from cometbft_tpu.abci.client import SocketClientCreator as RefCreator
    from cometbft_tpu.config.toml import load_toml
    from cometbft_tpu.node.node import Node as RefNode
    from cometbft_tpu.privval import FilePV as RefFilePV
    from cometbft_tpu.types.genesis import GenesisDoc as RefGenesisDoc

    cfg = load_toml(os.path.join(home2, "config", "config.toml"))
    cfg.set_root(home2)
    pv = RefFilePV.load_or_generate(cfg.base.priv_validator_key_path(),
                                    cfg.base.priv_validator_state_path())
    with pytest.raises(Exception) as e:
        RefNode(cfg, RefGenesisDoc.from_file(cfg.base.genesis_path()), pv, RefCreator(addr))
    errors.append((type(e.value).__name__, re.sub(r"\d+", "N", str(e.value))))
    assert errors[0] == errors[1]


CLI_RUNS = [["echo", "ping"], ["info"], ["deliver_tx", "cli=works"], ["check_tx", "0x6b3d76"],
            ["commit"], ["query", "cli"], ["query", "0x6e6f6e65"],
            ["prepare_proposal", "a=1", "b=2"], ["process_proposal", "a=1"], ["bogus"],
            ["query"]]


def test_cli_output_equals_the_reference(app_procs, capsys):
    outs = []
    for main in (cli.main, ref_cli.main):
        _, addr, _ = app_procs("port")
        rcs = [main(["--addr", addr, *args]) for args in CLI_RUNS]
        cap = capsys.readouterr()
        outs.append((rcs, cap.out, cap.err))
    assert outs[0] == outs[1]
    rcs, out, _ = outs[0]
    assert rcs == [0] * 9 + [1, 1]
    assert "message: ping" in out and "value: 0x" + b"works".hex().upper() in out


def test_app_conns_stop_closes_clients(tmp_path):
    """proxy.AppConns.stop() closes every connection (multi_app_conn
    OnStop): no reader thread or socket left."""
    from cometbft_tpu_torch.proxy import new_app_conns

    srv = ABCIServer(KVStoreApplication(), f"unix://{tmp_path}/conns.sock")
    bound = srv.start()
    try:
        conns = new_app_conns(SocketClientCreator(bound))
        before = set(threading.enumerate())
        conns.start()
        assert conns.consensus.echo("x").message == "x"
        assert conns.mempool.check_tx(abci.RequestCheckTx(tx=b"k=v")).is_ok()
        started = [t for t in set(threading.enumerate()) - before
                   if t.is_alive() and t.name == "abci-socket-async"]
        assert len(started) == 4  # one dispatch thread a connection
        sockets = [c._sock for c in (conns.consensus, conns.mempool, conns.query, conns.snapshot)]
        conns.stop()
        for t in started:
            t.join(30)
        assert not [t.name for t in started if t.is_alive()]
        assert all(s.fileno() == -1 for s in sockets)
        assert conns.consensus is None and conns.snapshot is None
    finally:
        srv.stop()


def test_a_failed_async_check_tx_keeps_the_dispatch_thread(tmp_path):
    """AsyncCheckTxMixin: a CheckTx that raised answers code 1 with the
    transport error, as the JAX package's does, and the next one is served."""
    got = {}
    for name, side in SIDES.items():
        class Flaky(side.KV):
            def check_tx(self, req):
                if req.tx == b"bad":
                    raise ValueError("flaky")
                return super().check_tx(req)

        srv = side.Server(Flaky(), f"unix://{tmp_path}/flaky-{name}.sock")
        bound = srv.start()
        try:
            client = side.Client(bound)
            res = []
            for tx in (b"bad", b"good=1"):
                client.check_tx_async(side.abci.RequestCheckTx(tx=tx), callback=res.append)
            tn.wait(lambda: len(res) == 2, "the async CheckTx stopped")
            got[name] = [(r.code, r.log) for r in res]
            client.close()
        finally:
            srv.stop()
    assert got["port"] == got["reference"]
    assert got["port"][0] == (1, "abci transport error: ABCI app exception: flaky")


def test_a_check_tx_answered_during_a_commit_leaves_the_recheck_wave_whole(tmp_path):
    """F10: a first-time CheckTx answered on the socket client's dispatch
    thread while a block commit holds the mempool's update lock. The JAX
    package's callback waits there for the lock, so the recheck answers
    queued behind it never come and the wave keeps every survivor after its
    10 s timeout; the port inserts the answer under the tx map's own lock at
    once, as Go's resCbFirstTime does, and the wave completes under the
    update lock: the tx the app now refuses is dropped."""
    from cometbft_tpu_torch.config import MempoolConfig
    from cometbft_tpu_torch.mempool import CListMempool

    gate = threading.Event()

    class App(KVStoreApplication):
        def check_tx(self, req):
            if req.tx.startswith(b"slow"):
                gate.wait(60)
            if req.type == abci.CHECK_TX_TYPE_RECHECK and req.tx.startswith(b"bad"):
                return abci.ResponseCheckTx(code=1, log="now invalid")
            return super().check_tx(req)

    srv = ABCIServer(App(), f"unix://{tmp_path}/recheck.sock")
    bound = srv.start()
    client = SocketClient(bound)
    try:
        mp = CListMempool(MempoolConfig(), client)
        admitted = threading.Event()
        for tx in (b"bad=1", b"ok=1"):
            mp.check_tx(tx, callback=lambda res: admitted.set())
            tn.wait(admitted.is_set, "a CheckTx never answered")
            admitted.clear()
        assert mp.size() == 2
        answered = threading.Event()
        mp.check_tx(b"slow=1", callback=lambda res: answered.set())
        mp.lock()
        try:
            gate.set()
            tn.wait(answered.is_set, "the slow CheckTx's callback waited for the lock")
            assert [m.tx for m in mp._txs.values()] == [b"bad=1", b"ok=1", b"slow=1"]
            mp.update(1, [], [], None, None)
            assert [m.tx for m in mp._txs.values()] == [b"ok=1", b"slow=1"]
        finally:
            mp.unlock()
        assert [m.tx for m in mp._txs.values()] == [b"ok=1", b"slow=1"]
    finally:
        client.close()
        srv.stop()


def test_a_check_tx_answered_while_the_update_lock_is_held_is_admitted_at_once(tmp_path):
    """First-time CheckTx answers that land while another thread holds the
    mempool's update lock (here inside ``check_tx``'s pre-flight, blocked in
    its pre_check), while a third thread keeps reading the pool through
    ``txs_front`` and ``reap_*`` as the gossip routines and the proposer do:
    the txs are in the pool and ``tx_available_callback`` has fired before
    the holder lets go, with no ``unlock()`` anywhere."""
    from cometbft_tpu_torch.config import MempoolConfig
    from cometbft_tpu_torch.mempool import CListMempool

    gate = threading.Event()

    class App(KVStoreApplication):
        def check_tx(self, req):
            gate.wait(60)
            return super().check_tx(req)

    srv = ABCIServer(App(), f"unix://{tmp_path}/held.sock")
    bound = srv.start()
    client = SocketClient(bound)
    in_pre_check, release = threading.Event(), threading.Event()

    def pre_check(tx):
        if tx.startswith(b"held"):
            in_pre_check.set()
            release.wait(60)

    stop_reading = threading.Event()

    def reader():
        while not stop_reading.is_set():
            mp.txs_front()
            mp.reap_max_bytes_max_gas(-1, -1)
            mp.reap_max_txs(-1)

    try:
        mp = CListMempool(MempoolConfig(), client, pre_check=pre_check)
        fired = threading.Event()
        mp.tx_available_callback = fired.set
        answered = []
        txs = [b"k%d=v" % i for i in range(16)]
        for tx in txs:
            mp.check_tx(tx, callback=answered.append)
        holder = threading.Thread(target=mp.check_tx, args=(b"held=1",))
        holder.start()
        reading = threading.Thread(target=reader)
        reading.start()
        try:
            tn.wait(in_pre_check.is_set, "the pre-flight never reached its pre_check")
            assert not answered
            gate.set()
            tn.wait(lambda: len(answered) == len(txs), "a CheckTx never answered")
            assert in_pre_check.is_set() and not release.is_set()
            assert [m.tx for m in mp.txs_front()] == txs
            assert fired.is_set()
        finally:
            release.set()
            stop_reading.set()
            holder.join(30)
            reading.join(30)
        tn.wait(lambda: mp.size() == len(txs) + 1, "the held tx was never admitted")
        assert [m.tx for m in mp.txs_front()] == txs + [b"held=1"]
    finally:
        client.close()
        srv.stop()
