"""The tx and block indexers in the port (``state/txindex.py``) against the
JAX package: the eight cases of ``tests/test_txindex.py`` run on both
packages' indexers over the same entries, with equal results and
byte-identical DB items; the port's indexers over the reference's items
(``convert.indexers_from_items``); and the ``IndexerService`` over each
package's event bus: every event of a block indexed, the same items, and
nothing written after ``stop()`` returns. No tolerance, no wall-clock
bound."""

import threading

import pytest

from cometbft_tpu.abci import types as ref_abci
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.state import txindex as ref_txindex
from cometbft_tpu.types import events as ref_events
from cometbft_tpu.types.tx import tx_hash as ref_tx_hash
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.state import txindex
from cometbft_tpu_torch.types import events
from cometbft_tpu_torch.types.tx import tx_hash

pytestmark = pytest.mark.torch_port

ENTRIES = [
    (5, 0, b"tx-a", {"transfer.sender": ["alice"], "transfer.amount": ["10"]}),
    (5, 1, b"tx-b", {"transfer.sender": ["bob"], "transfer.amount": ["7"]}),
    (9, 0, b"tx-c", {"transfer.sender": ["alice", "carol"], "transfer.amount": ["99"]}),
]


def _pair():
    """Both packages' tx indexers over the same entries."""
    port, ref = txindex.KVTxIndexer(MemDB()), ref_txindex.KVTxIndexer(RefMemDB())
    for h, i, tx, ev in ENTRIES:
        port.index(h, i, tx, abci.ResponseDeliverTx(code=0, data=b"", log=""), ev)
        ref.index(h, i, tx, ref_abci.ResponseDeliverTx(code=0, data=b"", log=""), ev)
    return port, ref


def _items(ix):
    return list(ix._db.iterator())


def _search_cases(port, ref):
    """tests/test_txindex.py's calls, each answered by both indexers."""
    h_b, h_c = tx_hash(b"tx-b"), tx_hash(b"tx-c").hex().upper()
    assert h_b == ref_tx_hash(b"tx-b")
    return {
        "get_by_hash": (lambda ix: [ix.get(h_b), ix.get(b"\x00" * 32)]),
        "event_equality": (lambda ix: [ix.search("transfer.sender='alice'"),
                                       ix.search("transfer.sender='nobody'")]),
        "multivalued": (lambda ix: ix.search("transfer.sender='carol'")),
        "height_range_and_and": (lambda ix: [
            ix.search("transfer.sender='alice' AND tx.height>6"), ix.search("tx.height<=5"),
            ix.search("transfer.amount>=10 AND transfer.sender='alice'")]),
        "hash_condition": (lambda ix: [ix.search(f"tx.hash='{h_c}'"),
                                       ix.search(f"tx.hash='{h_c.lower()}'"),
                                       ix.search(f"tx.hash='{h_c}' AND tx.height=999"),
                                       ix.search("tx.hash='zz-not-hex'")]),
        "height_equality_full_scan": (lambda ix: ix.search("tx.height=5")),
    }


@pytest.mark.parametrize("case", ["get_by_hash", "event_equality", "multivalued",
                                  "height_range_and_and", "hash_condition",
                                  "height_equality_full_scan"])
def test_tx_search_matches_the_reference(case):
    port, ref = _pair()
    assert _items(port) == _items(ref)
    fn = _search_cases(port, ref)[case]
    got, want = fn(port), fn(ref)
    assert got == want
    assert got not in ([], [None, None])
    # The port's indexer over the reference's items answers the same.
    carried, _ = convert.indexers_from_items(_items(ref))
    assert fn(carried) == want


def test_ordering_and_reindex_idempotent():
    port, ref = _pair()
    port.index(5, 0, b"tx-a", abci.ResponseDeliverTx(code=0), {"transfer.sender": ["alice"]})
    ref.index(5, 0, b"tx-a", ref_abci.ResponseDeliverTx(code=0), {"transfer.sender": ["alice"]})
    got = port.search("transfer.sender='alice'")
    assert got == ref.search("transfer.sender='alice'")
    assert [(r["height"], r["index"]) for r in got] == [("5", 0), ("9", 0)]
    assert _items(port) == _items(ref)


def test_block_indexer_search():
    port, ref = txindex.KVBlockIndexer(MemDB()), ref_txindex.KVBlockIndexer(RefMemDB())
    for bx in (port, ref):
        bx.index(3, {"block.shape": ["square"]})
        bx.index(8, {"block.shape": ["round"], "block.size": ["12"]})
    for q in ("block.shape='round'", "block.shape='round' AND block.height>8",
              "block.height>=3", "block.size<20", "block.shape='oval'"):
        assert port.search(q) == ref.search(q)
    assert port.search("block.shape='round'") == [8]
    assert _items(port) == _items(ref)
    _, carried = convert.indexers_from_items(_items(ref))
    assert carried.search("block.height>=3") == [3, 8]


def test_null_indexer():
    for ix in (txindex.NullTxIndexer(), ref_txindex.NullTxIndexer()):
        ix.index(1, 0, b"t", None, {})
        assert ix.get(b"h") is None and ix.search("tx.height=1") == []


def _publish_block(ev_mod, abci_mod, bus, height: int, n_txs: int):
    from cometbft_tpu.types.block import Header as RefHeader
    from cometbft_tpu_torch.types.block import Header

    header = (Header if ev_mod is events else RefHeader)(chain_id="c", height=height)
    bus.publish_new_block_header(ev_mod.EventDataNewBlockHeader(header=header),
                                 events=[abci_mod.Event(type="blk", attributes=[
                                     abci_mod.EventAttribute(key="n", value=str(n_txs),
                                                             index=True)])])
    for i in range(n_txs):
        res = abci_mod.ResponseDeliverTx(code=0, log="ok", events=[abci_mod.Event(
            type="app", attributes=[abci_mod.EventAttribute(key="key", value="k%d" % i,
                                                            index=True)])])
        bus.publish_tx(ev_mod.EventDataTx(height=height, tx=b"tx-%d-%d" % (height, i), index=i,
                                          result=res), events=res.events)


class _Gate:
    """Indexers whose first call waits for ``release``: the publisher runs a
    whole block ahead of the pump. ``calls`` counts the txs indexed (the
    reference's pump indexes one a call, the port's a batch of what is
    queued), ``batches`` the port's batches."""

    def __init__(self, inner):
        self.inner, self.release, self.started = inner, threading.Event(), threading.Event()
        self.calls = self.batches = 0

    def index(self, *a, **k):
        self.started.set()
        self.release.wait()
        self.calls += 1
        self.inner.index(*a, **k)

    def index_batch(self, items):
        self.started.set()
        self.release.wait()
        self.inner.index_batch(items)
        self.calls += len(items)
        self.batches += 1


def _service_run(pkg: str, n_txs: int):
    if pkg == "port":
        mods, db, svc_mod = (events, abci), MemDB, txindex
    else:
        mods, db, svc_mod = (ref_events, ref_abci), RefMemDB, ref_txindex
    bus = mods[0].EventBus()
    bus.start()
    tx_ix = _Gate(svc_mod.KVTxIndexer(db()))
    blk_ix = svc_mod.KVBlockIndexer(db())
    svc = svc_mod.IndexerService(tx_ix, blk_ix, bus)
    svc.start()
    _publish_block(mods[0], mods[1], bus, 1, 1)
    assert tx_ix.started.wait(30)
    _publish_block(mods[0], mods[1], bus, 2, n_txs)
    tx_ix.release.set()
    return bus, svc, tx_ix, blk_ix


def _wait_for(cond) -> None:
    """Polls ``cond``; a guard against a hang, not a time bound on the work."""
    idle = threading.Event()
    for _ in range(12_000):
        if cond():
            return
        idle.wait(0.01)
    raise AssertionError("the indexer never caught up")


def test_service_indexes_every_tx_of_a_block_larger_than_the_reference_buffer():
    """A block of 1,200 transactions published while the pump is busy: the
    reference's subscription (1,000 events) is canceled when full and indexes
    none of the rest; the port's indexes all, and its items equal the
    reference indexer's over the same calls."""
    n = 1_200
    port_bus, port_svc, port_tx, port_blk = _service_run("port", n)
    ref_bus, ref_svc, ref_tx, ref_blk = _service_run("ref", n)
    _wait_for(lambda: port_tx.calls == n + 1 and port_blk.search("block.height>=1") == [1, 2])
    assert len(port_tx.inner.search("app.key EXISTS")) == n + 1
    # The reference: its tx subscription was canceled at the 1,001st event.
    ref_sub = ref_bus._server._subs["indexer-tx"]
    assert all(s.canceled.is_set() for s in ref_sub.values())
    assert [s.cancel_reason for s in ref_sub.values()] == [
        "client is not pulling messages fast enough"]
    _wait_for(lambda: ref_tx.calls == 1 + 1_000)
    port_svc.stop()
    ref_svc.stop()
    ref_items = list(ref_tx.inner._db.iterator())
    port_items = list(port_tx.inner._db.iterator())
    assert len(port_items) > len(ref_items)
    assert set(ref_items) <= set(port_items)
    assert list(port_blk._db.iterator()) == list(ref_blk._db.iterator())
    for bus in (port_bus, ref_bus):
        bus.stop()


def test_service_stop_leaves_no_pump_writing():
    """``stop()`` returns only when neither pump can write: the batch
    under way when it is called finishes before it returns, no event
    published after it is indexed, and the subscriptions are gone."""
    bus = events.EventBus()
    bus.start()
    tx_ix = _Gate(txindex.KVTxIndexer(MemDB()))
    svc = txindex.IndexerService(tx_ix, txindex.KVBlockIndexer(MemDB()), bus)
    svc.start()
    assert bus.num_clients() == 2
    _publish_block(events, abci, bus, 1, 3)
    assert tx_ix.started.wait(30)
    stopper = threading.Thread(target=svc.stop)
    stopper.start()
    stopper.join(0.2)
    assert stopper.is_alive()  # held by the index call under way
    tx_ix.release.set()
    stopper.join()
    writes = list(tx_ix.inner._db.iterator())
    assert tx_ix.batches == 1 and tx_ix.calls >= 1 and len(writes) > 0
    assert bus.num_clients() == 0
    calls = tx_ix.calls
    _publish_block(events, abci, bus, 2, 5)
    assert list(tx_ix.inner._db.iterator()) == writes
    assert tx_ix.batches == 1 and tx_ix.calls == calls
    svc.stop()  # a second stop is a no-op
    bus.stop()
