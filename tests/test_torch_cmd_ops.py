"""The port's CLI (``python -m cometbft_tpu_torch.cmd``), rollback and
inspect against the JAX package's, after ``tests/test_cmd_ops.py``: a home
initialized by the reference's ``init`` and filled by a port node (sqlite
stores), copied once for each package, and each package's offline
tools run on its copy.

- ``rollback`` leaves byte-identical state records in both packages and
  prints the same line; the port's ``replay`` then restores the height,
  app hash and validators;
- ``inspect`` serves ``status``, ``block``, ``commit`` and ``validators``
  as the reference's inspector does, and refuses write routes;
- ``reindex-event`` rebuilds the tx and block index records the live
  indexer wrote (F13: the reference's leaves out the tx meta-events);
- ``compact-db`` and ``replay`` report the store height;
- a home from either package's ``init`` loads and runs in the other;
- ``devnet --backend cpu`` commits; ``--backend tpu``, ``e2e`` and the
  key types not ported are refused with their messages; ``show-*``,
  ``gen-node-key`` and ``version`` (F12: the reference's raises) print the
  same.

Waits are liveness guards, never time bounds."""

import json
import os
import shutil
import time

import pytest

from cometbft_tpu.cmd.__main__ import main as ref_cli
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu_torch.cmd.__main__ import main as cli
from cometbft_tpu_torch.sidecar import backend

pytestmark = pytest.mark.torch_port

WAIT_S = 180.0


@pytest.fixture(scope="module", autouse=True)
def cpu_backends():
    old = (backend._backend, ref_backend._backend)
    backend.set_backend(backend.CpuBackend())
    ref_backend.set_backend(ref_backend.CpuBackend())
    yield
    backend._backend, ref_backend._backend = old


def _run_node(default_config, default_new_node, home, txs, min_height):
    cfg = default_config().set_root(home)
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = ""
    cfg.consensus.timeout_commit = 0.02
    cfg.consensus.skip_timeout_commit = True
    node = default_new_node(cfg)
    node.start()
    try:
        for tx in txs:
            node.mempool.check_tx(tx)
        deadline = time.monotonic() + WAIT_S
        while node.block_store.height() < min_height:
            assert time.monotonic() < deadline, "the node stopped committing"
            time.sleep(0.02)
    finally:
        node.stop()
    return node


@pytest.fixture(scope="module")
def source_home(tmp_path_factory):
    """The reference's init, then a port node: 4+ heights, 2 txs. (The
    port's ``Node.stop()`` joins its threads, so the home does not change
    once it returns; the reference's only clears flags.)"""
    from cometbft_tpu_torch.config import default_config
    from cometbft_tpu_torch.node import default_new_node

    home = str(tmp_path_factory.mktemp("src") / "home")
    assert ref_cli(["--home", home, "init", "--chain-id", "ops-chain"]) == 0
    node = _run_node(default_config, default_new_node, home, [b"ops=1", b"tool=2"], 4)
    return home, node.block_store.height()


def _copy(source_home, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(source_home[0], dst)
    return dst


def _db_items(home, name):
    from cometbft_tpu_torch.libs.db import new_db

    db = new_db(name, "sqlite", os.path.join(home, "data"))
    try:
        return list(db.iterator())
    finally:
        db.close()


def _state(home):
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.state import StateStore

    st = StateStore(new_db("state", "sqlite", os.path.join(home, "data"))).load()
    return st.last_block_height, st.app_hash, st.validators.hash(), st.next_validators.hash()


def test_rollback_leaves_the_reference_state_records(source_home, tmp_path, capsys):
    homes = {"port": _copy(source_home, tmp_path, "port"),
             "ref": _copy(source_home, tmp_path, "ref")}
    capsys.readouterr()
    assert cli(["--home", homes["port"], "rollback"]) == 0
    port_out = capsys.readouterr().out
    assert ref_cli(["--home", homes["ref"], "rollback"]) == 0
    ref_out = capsys.readouterr().out
    assert port_out == ref_out
    assert port_out.startswith(f"Rolled back state to height {source_home[1] - 1} and hash ")
    assert _db_items(homes["port"], "state") == _db_items(homes["ref"], "state")
    assert _db_items(homes["port"], "blockstore") == _db_items(source_home[0], "blockstore")


def test_rollback_then_replay_restores_the_state(source_home, tmp_path, capsys):
    home = _copy(source_home, tmp_path, "port")
    want = _state(source_home[0])
    assert cli(["--home", home, "rollback"]) == 0
    assert _state(home)[0] == want[0] - 1
    assert cli(["--home", home, "replay", "--backend", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"replay done; store height {source_home[1]}" in out
    assert _state(home) == want


def test_compact_db_and_replay(source_home, tmp_path, capsys):
    home = _copy(source_home, tmp_path, "port")
    assert cli(["--home", home, "compact-db"]) == 0
    assert cli(["--home", home, "replay"]) == 0
    out = capsys.readouterr().out
    assert "compacted blockstore" in out and f"store height {source_home[1]}" in out


def test_inspect_serves_the_reference_answers(source_home, tmp_path):
    from cometbft_tpu.config import default_config as ref_default_config
    from cometbft_tpu.inspect import Inspector as RefInspector
    from cometbft_tpu_torch.config import default_config
    from cometbft_tpu_torch.inspect import Inspector
    from cometbft_tpu_torch.rpc.client import HTTPClient, RPCClientError

    answers = {}
    for side, make_cfg, cls in (("port", default_config, Inspector),
                                ("ref", ref_default_config, RefInspector)):
        home = _copy(source_home, tmp_path, side)
        cfg = make_cfg().set_root(home)
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        ins = cls(cfg)
        ins.start()
        try:
            c = HTTPClient(f"http://127.0.0.1:{ins.port}")
            answers[side] = {
                "status": c.call("status"),
                "block": c.call("block", height=2),
                "commit": c.call("commit", height=2),
                "validators": c.call("validators", height=1),
                "blockchain": c.call("blockchain", minHeight=1, maxHeight=3),
            }
            with pytest.raises(RPCClientError):
                c.call("broadcast_tx_sync", tx="00")
        finally:
            ins.stop()
    assert answers["port"] == answers["ref"]
    st = answers["port"]["status"]
    assert int(st["sync_info"]["latest_block_height"]) == source_home[1]
    assert int(answers["port"]["validators"]["total"]) == 1


def test_reindex_event_rebuilds_the_reference_index(source_home, tmp_path, capsys):
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.state.txindex import KVTxIndexer
    from cometbft_tpu_torch.types.tx import tx_hash

    homes = {}
    for side, run in (("port", cli), ("ref", ref_cli)):
        home = homes[side] = _copy(source_home, tmp_path, side)
        db_dir = os.path.join(home, "data")
        for name in os.listdir(db_dir):
            if name.startswith(("tx_index", "block_index")):
                os.unlink(os.path.join(db_dir, name))
        assert run(["--home", home, "reindex-event"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == out[-2] and out[-1].startswith("reindexed ")
    # the txs are in the first blocks; the live header pump may not have
    # indexed the last header before the source node stopped
    assert _db_items(homes["port"], "tx_index") == _db_items(source_home[0], "tx_index")
    assert _db_items(homes["port"], "block_index") == _db_items(homes["ref"], "block_index")
    # F13: the reference's rebuilt tx index lacks the meta-events the bus
    # adds live (tx.hash, tx.height): its records and those keys differ
    live = dict(_db_items(source_home[0], "tx_index"))
    ref = dict(_db_items(homes["ref"], "tx_index"))
    missing = sorted(k for k in live if k not in ref)
    assert missing and all(k.startswith((b"txev:tx.hash=", b"txev:tx.height=")) for k in missing)
    idx = KVTxIndexer(new_db("tx_index", "sqlite", os.path.join(homes["port"], "data")))
    rec = idx.get(tx_hash(b"ops=1"))
    assert rec is not None and rec["tx_result"]["code"] == 0


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_home_from_either_init_runs_in_the_other(tmp_path, writer, capsys):
    """``init`` by one package; the other's node loads the home, commits
    two heights on it, and its CLI prints the same validator and node id
    as the writer's."""
    import importlib

    other = "ref" if writer == "port" else "port"
    pkgs = {"port": "cometbft_tpu_torch", "ref": "cometbft_tpu"}
    runs = {"port": cli, "ref": ref_cli}
    home = str(tmp_path / "home")
    assert runs[writer](["--home", home, "init", "--chain-id", "x-chain"]) == 0
    out = capsys.readouterr().out
    assert f"Initialized node in {home}" in out
    config = importlib.import_module(pkgs[other] + ".config")
    node_mod = importlib.import_module(pkgs[other] + ".node")
    nd = _run_node(config.default_config, node_mod.default_new_node, home, [], 2)
    assert nd.genesis_doc.chain_id == "x-chain"
    shows = {}
    for side in ("port", "ref"):
        for cmd in ("show-validator", "show-node-id", "gen-node-key"):
            assert runs[side](["--home", home, cmd]) == 0
        shows[side] = capsys.readouterr().out
    assert shows["port"] == shows["ref"]


def test_init_writes_the_reference_config_bytes(tmp_path):
    for side, run in (("port", cli), ("ref", ref_cli)):
        assert run(["--home", str(tmp_path / side), "init", "--chain-id", "c"]) == 0
    for rel in (("config", "config.toml"),):
        with open(tmp_path / "port" / os.path.join(*rel)) as f:
            port = f.read()
        with open(tmp_path / "ref" / os.path.join(*rel)) as f:
            ref = f.read()
        assert port.replace(str(tmp_path / "port"), "HOME") == ref.replace(
            str(tmp_path / "ref"), "HOME")
    with open(tmp_path / "port" / "config" / "genesis.json") as f:
        port_gen = json.load(f)
    with open(tmp_path / "ref" / "config" / "genesis.json") as f:
        ref_gen = json.load(f)
    assert sorted(port_gen) == sorted(ref_gen)
    assert sorted(port_gen["validators"][0]) == sorted(ref_gen["validators"][0])


def test_testnet_writes_the_reference_layout(tmp_path, capsys):
    for side, run in (("port", cli), ("ref", ref_cli)):
        out_dir = str(tmp_path / side)
        assert run(["--home", str(tmp_path), "testnet", "--validators", "3",
                    "--non-validators", "1", "--output-dir", out_dir,
                    "--chain-id", "tn"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"Successfully initialized 4 node directories in {tmp_path / s}"
                   for s in ("port", "ref")]
    layout = {side: sorted(os.path.relpath(os.path.join(d, f), tmp_path / side)
                           for d, _, fs in os.walk(tmp_path / side) for f in fs)
              for side in ("port", "ref")}
    assert layout["port"] == layout["ref"]
    from cometbft_tpu_torch.types.genesis import GenesisDoc

    gen = GenesisDoc.from_file(str(tmp_path / "port" / "node3" / "config" / "genesis.json"))
    assert gen.chain_id == "tn" and len(gen.validators) == 3


def test_devnet_on_the_cpu_commits(monkeypatch, capsys):
    monkeypatch.setenv("CMTPU_BACKEND", "cpu")
    assert cli(["devnet", "--backend", "cpu", "--validators", "4", "--blocks", "2",
                "--rpc-port", "0", "--block-interval", "0.05"]) == 0
    out = capsys.readouterr().out
    assert "devnet: 4 validators" in out and "devnet done at height " in out
    assert int(out.rsplit("devnet done at height ", 1)[1].split()[0]) >= 2


def test_refusals_name_what_to_use(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("CMTPU_BACKEND", "cpu")
    assert cli(["devnet", "--backend", "tpu"]) == 2
    err = capsys.readouterr().err
    assert "--backend tpu names the JAX package's TPU tier" in err and "--backend torch" in err
    assert cli(["start", "--backend", "gpu"]) == 2
    with pytest.raises(NotImplementedError, match="e2e needs e2e_runner, which is not ported"):
        cli(["e2e", "--manifest", "m.toml"])
    for kt in ("secp256k1", "sr25519"):
        with pytest.raises(ValueError, match=f"key type {kt} is not ported"):
            cli(["testnet", "--key-types", kt, "--output-dir", str(tmp_path / kt)])
        assert not os.path.exists(tmp_path / kt)
    assert cli([]) == 1


def test_version_prints_the_targeted_cometbft_version(capsys):
    """F12: the reference's ``version`` imports a ``VERSION`` its version
    module lacks and raises; the port prints the CometBFT version it
    targets."""
    assert cli(["version"]) == 0
    assert capsys.readouterr().out == "0.38.0-dev\n"
    with pytest.raises(ImportError, match="VERSION"):
        ref_cli(["version"])


def test_gen_validator_prints_the_reference_fields(capsys):
    assert cli(["gen-validator"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_cli(["gen-validator"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert sorted(port) == sorted(ref) == ["address", "priv_key", "pub_key"]
    assert port["pub_key"]["type"] == ref["pub_key"]["type"]


def test_start_serves_the_operator_tier_and_stops_on_sigint(tmp_path):
    """``init`` then ``start`` in a process of its own on the CPU, with
    Prometheus, the psql sink, pprof, ``CMTPU_WATCHDOG`` and
    ``CMTPU_WAL_GROUP_MS``: ``/metrics`` shows the store's height advance,
    the sink holds the blocks; SIGINT ends it with exit code 0, no thread
    left, no sampler error, no stall; ``replay`` then gives its height."""
    import signal
    import socket
    import sqlite3
    import subprocess
    import sys
    import urllib.request

    from cometbft_tpu_torch.config.toml import load_toml, write_config_file

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    home = str(tmp_path / "home")
    assert cli(["--home", home, "init", "--chain-id", "start-chain"]) == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    path = os.path.join(home, "config", "config.toml")
    cfg = load_toml(path)
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{mport}"
    cfg.tx_index.indexer = "psql"
    cfg.rpc.pprof_laddr = "127.0.0.1:0"
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.consensus.timeout_commit = 0.05
    write_config_file(path, cfg)
    env = {**os.environ, "CMTPU_BACKEND": "cpu", "CMTPU_WATCHDOG": "600",
           "CMTPU_WAL_GROUP_MS": "2", "PYTHONPATH": repo}
    proc = subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.cmd", "--home", home,
                             "start"], cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + WAIT_S
        height = 0
        while height < 3:
            assert time.monotonic() < deadline and proc.poll() is None, "start never reached 3"
            try:
                body = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                              timeout=30).read().decode()
                height = int(float(body.split("\ncometbft_blockstore_height ")[1].split()[0]))
            except OSError:
                pass
            time.sleep(0.05)
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "Node started; RPC on " in out
    assert "Node stopped; threads left 0; metrics sampler errors 0; watchdog stalls 0" in out
    assert "watchdog: no progress" not in out and "Traceback" not in out
    db = sqlite3.connect(os.path.join(home, "data", "event_sink.sqlite"))
    try:
        heights = [r[0] for r in db.execute("SELECT height FROM blocks ORDER BY height")]
    finally:
        db.close()
    assert heights[:3] == [1, 2, 3]
    stored = _state(home)[0]
    assert cli(["--home", home, "replay", "--backend", "cpu"]) == 0
    assert _state(home)[0] == stored
