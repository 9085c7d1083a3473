"""The port's SQL event sink (``state/sink_sql.py``) and the node's ``psql``
branch against the JAX package's, after ``tests/test_sink_sql.py``:

- the same index calls write the same rows in every table (the
  ``created_at`` timestamps aside), with the same duplicate and refusal
  semantics;
- a port node with ``tx_index.indexer = "psql"`` (and the operator's other
  settings: Prometheus, ``CMTPU_WATCHDOG``, ``CMTPU_WAL_GROUP_MS``, pprof)
  writes every tx of its heights once, readable by plain SQL, and stops
  leaving no thread;
- a stop while a large block is being indexed leaves no write after the
  sink's close (the reference's sink closes under a writing pump); a write
  after ``stop()`` raises;
- the port's ``IndexerService`` hands the sink what its pump finds queued
  as one batch, one transaction, with the rows the reference's service
  writes tx by tx; a reader never waits on that transaction.

Waits are liveness guards, never time bounds."""

import os
import sqlite3
import threading
import time
import urllib.request

import pytest

from cometbft_tpu.abci import types as ref_abci
from cometbft_tpu.state import sink_sql as ref_sink_sql
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.state import sink_sql
from cometbft_tpu_torch.types.tx import tx_hash

pytestmark = pytest.mark.torch_port

WAIT_S = 180.0
TABLES = {
    "blocks": "rowid, height, chain_id",
    "tx_results": 'rowid, block_id, "index", tx_hash, tx_result',
    "events": "rowid, block_id, tx_id, type",
    "attributes": "event_id, key, composite_key, value",
}


def _rows(path):
    db = sqlite3.connect(path)
    try:
        out = {t: db.execute(f"SELECT {cols} FROM {t} ORDER BY 1, 2").fetchall()
               for t, cols in TABLES.items()}
        out["tx_events"] = db.execute(
            'SELECT height, "index", chain_id, type, key, composite_key, value '
            "FROM tx_events ORDER BY 1, 2, 6, 7").fetchall()
        out["block_events"] = db.execute(
            "SELECT height, chain_id, type, key, composite_key, value "
            "FROM block_events ORDER BY 1, 5, 6").fetchall()
        return out
    finally:
        db.close()


def _feed(mod, types_mod, sink):
    ev = types_mod.Event(type="transfer", attributes=[
        types_mod.EventAttribute(key="sender", value="alice", index=True)])
    res = types_mod.ResponseDeliverTx(code=0, data=b"ok", log="fine", gas_used=7, events=[ev])
    bad = types_mod.ResponseDeliverTx(code=5, log="refused", codespace="app")
    sink.index_block(5, {"rewards.amount": ["17"], "bare_event": [""]})
    sink.index_tx(5, 0, b"tx-bytes", res, {"transfer.sender": ["alice"]})
    sink.index_tx(5, 0, b"tx-bytes", res, {"transfer.sender": ["alice"]})  # dup: quiet
    sink.index_tx(5, 1, b"tx-two", bad, {})
    sink.index_tx(6, 0, b"early", res, {"a.b": ["1", "2"], "c.d": ["x"]})  # before its header
    sink.index_block(6, {})
    for probe in (lambda: sink.search("tx.height = 5"), lambda: sink.get(b"\x00" * 32),
                  lambda: sink.has_block(5)):
        with pytest.raises(mod.SinkQueryUnsupportedError) as e:
            probe()
        yield str(e.value)


def test_rows_equal_the_reference_sinks(tmp_path):
    """The same calls on both sinks: the same rows in every table and view
    (timestamps aside), the same refusals."""
    out = {}
    for side, mod, types_mod in (("port", sink_sql, abci), ("ref", ref_sink_sql, ref_abci)):
        path = str(tmp_path / f"{side}.sqlite")
        sink = mod.SqlEventSink(path, "unit-chain")
        refusals = list(_feed(mod, types_mod, sink))
        sink.stop()
        out[side] = (_rows(path), refusals)
    assert out["port"] == out["ref"]
    rows = out["port"][0]
    assert [r[1:] for r in rows["blocks"]] == [(5, "unit-chain"), (6, "unit-chain")]
    assert rows["tx_results"][0][3] == tx_hash(b"tx-bytes").hex().upper()
    assert len(rows["tx_results"]) == 3


def test_a_write_after_stop_raises_and_never_reaches_the_connection(tmp_path):
    sink = sink_sql.SqlEventSink(str(tmp_path / "s.sqlite"), "c")
    sink.index_block(1, {})
    sink.stop()
    sink.stop()  # idempotent
    with pytest.raises(sink_sql.SinkClosedError):
        sink.index_block(2, {})
    with pytest.raises(sink_sql.SinkClosedError):
        sink.index_tx(2, 0, b"t", abci.ResponseDeliverTx(), {})
    assert [r[1] for r in _rows(str(tmp_path / "s.sqlite"))["blocks"]] == [1]


def test_stop_during_a_blocks_indexing_leaves_no_write_after_close(tmp_path):
    """1,500 tx events published at once, the indexer service stopped while
    its pump writes them (once the first write has begun), then the sink:
    no write began after the sink's close."""
    from cometbft_tpu_torch.state.txindex import IndexerService
    from cometbft_tpu_torch.types import events as ev
    from cometbft_tpu_torch.types.events import EventBus

    sink = sink_sql.SqlEventSink(str(tmp_path / "race.sqlite"), "race")
    closed = threading.Event()
    late, started, batches = [], threading.Event(), []
    orig = sink.index_txs

    def index_txs(items):
        started.set()
        batches.append(len(items))
        if closed.is_set():
            late.extend(item[1] for item in items)
        return orig(items)

    sink.index_txs = index_txs
    bus = EventBus()
    bus.start()
    svc = IndexerService(sink.tx_indexer(), sink.block_indexer(), bus)
    svc.start()
    res = abci.ResponseDeliverTx(code=0)
    for i in range(1500):
        bus.publish_tx(ev.EventDataTx(height=1, index=i, tx=b"tx-%d" % i, result=res))
    assert started.wait(WAIT_S)
    svc.stop()  # joins the pumps: the write under way finishes first
    bus.stop()
    sink.stop()
    closed.set()
    time.sleep(0.05)
    assert late == []
    n = len(_rows(str(tmp_path / "race.sqlite"))["tx_results"])
    assert 1 <= n <= 1500 and n == sum(batches)


def test_the_indexer_service_hands_the_sink_batches_of_the_same_rows(tmp_path):
    """The port's IndexerService gives the sink the txs queued together as
    one batch (one transaction, as Go's service gives psql.go a block's
    batch): every tx of a 600-tx block indexed once, in fewer batches than
    txs, the rows those the reference's service and sink write tx by tx."""
    from cometbft_tpu.state.txindex import IndexerService as RefIndexerService
    from cometbft_tpu.types import events as ref_ev
    from cometbft_tpu_torch.state.txindex import IndexerService
    from cometbft_tpu_torch.types import events as ev

    batches = []
    sinks = {}
    for side, mod, ev_mod, abci_mod, svc_cls in (
            ("port", sink_sql, ev, abci, IndexerService),
            ("ref", ref_sink_sql, ref_ev, ref_abci, RefIndexerService)):
        sink = sinks[side] = mod.SqlEventSink(str(tmp_path / f"{side}.sqlite"), "b")
        if side == "port":
            orig = sink.index_txs
            sink.index_txs = lambda items, o=orig: (batches.append(len(items)), o(items))
        bus = ev_mod.EventBus()
        bus.start()
        svc = svc_cls(sink.tx_indexer(), sink.block_indexer(), bus)
        svc.start()
        for i in range(600):
            res = abci_mod.ResponseDeliverTx(code=i % 3, events=[abci_mod.Event(
                type="app", attributes=[abci_mod.EventAttribute("key", "v%d" % i, True)])])
            bus.publish_tx(ev_mod.EventDataTx(height=2, index=i, tx=b"b-%d" % i, result=res))
        deadline = time.monotonic() + WAIT_S
        while len(_rows(str(tmp_path / f"{side}.sqlite"))["tx_results"]) < 600:
            assert time.monotonic() < deadline, f"{side}: the pump stopped short of 600"
            time.sleep(0.01)
        svc.stop()
        bus.stop()
        sink.stop()
    assert len(batches) < 600 and sum(batches) == 600
    assert _rows(str(tmp_path / "port.sqlite")) == _rows(str(tmp_path / "ref.sqlite"))


def test_a_reader_never_waits_on_a_batch_being_written(tmp_path):
    """An external SQL consumer reads while the sink's batch transaction is
    open (the sink's journal is WAL): it sees the rows committed before the
    batch, at once, and the batch's once it commits."""
    path = str(tmp_path / "wal.sqlite")
    sink = sink_sql.SqlEventSink(path, "w")
    sink._conn.execute("PRAGMA cache_size=1")  # spill early, as a block's batch does
    res = abci.ResponseDeliverTx(code=0)
    sink.index_tx(1, 0, b"first", res, {})
    halfway, release = threading.Event(), threading.Event()

    def items():
        for i in range(1, 200):
            if i == 100:
                halfway.set()
                assert release.wait(WAIT_S)
            yield (1, i, b"tx-%d" % i, res, {"a.b": ["c"]})

    writer = threading.Thread(target=sink.index_txs, args=(items(),))
    writer.start()
    try:
        assert halfway.wait(WAIT_S)
        db = sqlite3.connect(path, timeout=0.0)
        try:
            assert db.execute("SELECT COUNT(*) FROM tx_results").fetchone() == (1,)
        finally:
            db.close()
    finally:
        release.set()
        writer.join(WAIT_S)
    assert len(_rows(path)["tx_results"]) == 200
    sink.stop()


@pytest.fixture
def cpu_backend():
    from cometbft_tpu_torch.sidecar import backend

    old = backend._backend
    backend.set_backend(backend.CpuBackend())
    yield
    backend._backend = old


def test_operator_node_writes_every_tx_once_to_the_sql_sink(tmp_path, monkeypatch, cpu_backend):
    """A one-validator port node from a home on disk, as an operator runs
    it: psql, Prometheus, pprof, ``CMTPU_WATCHDOG`` and
    ``CMTPU_WAL_GROUP_MS``. 12 txs reach blocks; the sink holds each once
    by plain SQL, ``/metrics`` shows the store's height and no sampler
    error, the watchdog no stall; ``stop()`` leaves no thread and the
    sink closed."""
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.node.node import default_new_node
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    monkeypatch.setenv("CMTPU_WATCHDOG", "600")
    monkeypatch.setenv("CMTPU_WAL_GROUP_MS", "2")
    home = str(tmp_path / "home")
    cfg = test_config().set_root(home)
    os.makedirs(os.path.join(home, "config"))
    os.makedirs(cfg.base.db_path())
    pv = FilePV(ed25519.gen_priv_key_from_secret(b"sink-operator"),
                cfg.base.priv_validator_key_path(), cfg.base.priv_validator_state_path())
    pv.save()
    gen = GenesisDoc(chain_id="sink-chain", genesis_time=cmttime.now(), validators=[
        GenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(), 10, "v0")])
    gen.validate_and_complete()
    gen.save_as(cfg.base.genesis_path())
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = ""
    cfg.tx_index.indexer = "psql"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    cfg.rpc.pprof_laddr = "127.0.0.1:0"
    nd = default_new_node(cfg)
    sink_path = os.path.join(cfg.base.db_path(), "event_sink.sqlite")
    txs = [b"op-%d=v%d" % (i, i) for i in range(12)]
    nd.start()
    try:
        for tx in txs:
            nd.mempool.check_tx(tx)
        deadline = time.monotonic() + WAIT_S
        while True:
            assert time.monotonic() < deadline, "the txs never all reached a block"
            stored = sum(len(nd.block_store.load_block(h).data.txs)
                         for h in range(1, nd.block_store.height() + 1))
            if stored == len(txs) and nd.block_store.height() >= 3:
                break
            time.sleep(0.02)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{nd.metrics_server.port}/metrics", timeout=30).read().decode()
        assert nd.consensus_state.wal._group_ms == 2.0
    finally:
        nd.stop()
    height = nd.block_store.height()
    assert f"\ncometbft_blockstore_height {height}" in body or \
        f"\ncometbft_blockstore_height {height - 1}" in body
    assert nd.metrics_registry.sample_errors == 0
    assert nd.watchdog.stalls == 0 and nd.threads_left_at_stop == 0
    assert nd.event_sink._closed
    db = sqlite3.connect(sink_path)
    try:
        got = db.execute("SELECT tx_hash, COUNT(*) FROM tx_results GROUP BY tx_hash").fetchall()
        heights = [r[0] for r in db.execute("SELECT height FROM blocks ORDER BY height")]
    finally:
        db.close()
    assert dict(got) == {tx_hash(tx).hex().upper(): 1 for tx in txs}
    assert heights == list(range(1, len(heights) + 1)) and heights[-1] >= height - 1
    with pytest.raises(sink_sql.SinkQueryUnsupportedError):
        nd.tx_indexer.search("tx.height = 1")
