"""Transaction & block event indexing (state/txindex/kv/kv.go,
state/indexer/block/kv/kv.go, state/txindex/indexer_service.go), the port's
copy of ``cometbft_tpu/state/txindex.py``.

The IndexerService subscribes to the EventBus and indexes every committed
tx (by hash, plus composite event keys for /tx_search) and block header
events (for /block_search). The DB keys and values are the reference's
byte for byte, so an index carries across packages
(``convert.indexers_from_items``).

Two differences from the reference's service, both about losing or
writing index entries behind the caller's back:

- its subscriptions hold 1,000 events, and the bus cancels a subscription
  that is full (``libs/pubsub``): a block of more transactions than the
  pump drained meanwhile silently ends all indexing. The port's hold any
  number (Go's indexer service subscribes unbuffered and blocks the
  publisher instead);
- its ``stop()`` only clears a flag, so a pump can still write after it
  returns (the reference's SQL sink crashes on that race when the node
  closes it). The port's ``stop()`` joins both pumps and drops their
  subscriptions.
"""

from __future__ import annotations

import base64
import json
import queue
import threading

from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.libs.db import DB
from cometbft_tpu_torch.libs.pubsub import Query
from cometbft_tpu_torch.types import events as ev
from cometbft_tpu_torch.types.tx import tx_hash


class KVTxIndexer:
    """state/txindex/kv/kv.go: primary record tx.hash -> TxResult, secondary
    records eventkey/value/height/index -> hash."""

    def __init__(self, db: DB):
        self._db = db

    def index(self, height: int, index: int, tx: bytes, result, result_events: dict) -> None:
        h = tx_hash(tx)
        record = {
            "hash": h.hex().upper(),
            "height": str(height),
            "index": index,
            "tx": base64.b64encode(tx).decode(),
            "tx_result": {
                "code": result.code,
                "data": base64.b64encode(result.data).decode(),
                "log": result.log,
                "gas_wanted": str(result.gas_wanted),
                "gas_used": str(result.gas_used),
            },
            "events": {k: [str(x) for x in v] for k, v in result_events.items()},
        }
        self._db.set(b"tx:" + h, json.dumps(record).encode())
        for key, values in result_events.items():
            for v in values:
                self._db.set(
                    b"txev:%s=%s:%016d:%08d" % (key.encode(), str(v).encode(), height, index),
                    h,
                )

    def index_batch(self, items) -> None:
        """(height, index, tx, result, events) tuples, in order (kv.go
        AddBatch)."""
        for item in items:
            self.index(*item)

    def get(self, h: bytes) -> dict | None:
        raw = self._db.get(b"tx:" + h)
        return json.loads(raw) if raw else None

    def search(self, query: str) -> list[dict]:
        """Condition-driven scan (kv.go match): supports key=value AND ... plus
        tx.height ranges via the pubsub Query semantics."""
        q = Query(query)
        results: list[dict] = []
        seen: set[bytes] = set()
        # tx.hash has a PRIMARY record, not a secondary event key: resolve
        # it directly — case-insensitively, and WITHOUT applying the other
        # conditions, exactly like the reference's hash fast path
        # (kv.go:211-224 returns the Get result unconditionally).
        hash_eq = next(
            (c for c in q.conditions if c.op == "=" and c.key == "tx.hash"), None
        )
        if hash_eq is not None:
            try:
                rec = self.get(bytes.fromhex(hash_eq.value))
            except ValueError:
                return []
            return [rec] if rec else []
        # Start from the first condition with a secondary index — tx.height
        # has none (it lives on the primary record), so it cannot drive the
        # scan.
        eq = next(
            (c for c in q.conditions if c.op == "=" and c.key != "tx.height"),
            None,
        )
        if eq is not None:
            prefix = b"txev:%s=%s:" % (eq.key.encode(), eq.value.encode())
            for _, h in self._db.iterator(prefix, prefix + b"\xff"):
                if h in seen:
                    continue
                seen.add(h)
                rec = self.get(h)
                if rec and self._matches(rec, q):
                    results.append(rec)
        else:
            for k, raw in self._db.iterator(b"tx:", b"tx;"):
                rec = json.loads(raw)
                if self._matches(rec, q):
                    results.append(rec)
        results.sort(key=lambda r: (int(r["height"]), r["index"]))
        return results

    def _matches(self, rec: dict, q: Query) -> bool:
        attrs = {
            "tx.hash": [rec["hash"]],
            "tx.height": [rec["height"]],
        }
        for key, values in rec.get("events", {}).items():
            attrs.setdefault(key, []).extend(values)
        # re-materialize indexed event attrs from secondary keys is expensive;
        # store them on the record instead (see index()).
        return q.matches(attrs)


class KVBlockIndexer:
    """state/indexer/block/kv/kv.go: block.height by event attributes."""

    def __init__(self, db: DB):
        self._db = db

    def index(self, height: int, events: dict) -> None:
        self._db.set(b"blk:%016d" % height, json.dumps(events).encode())
        for key, values in events.items():
            for v in values:
                self._db.set(
                    b"blkev:%s=%s:%016d" % (key.encode(), str(v).encode(), height), b"%d" % height
                )

    def search(self, query: str) -> list[int]:
        q = Query(query)
        heights = []
        for k, raw in self._db.iterator(b"blk:", b"blk;"):
            height = int(k.split(b":")[1])
            attrs = {"block.height": [str(height)]}
            for key, values in json.loads(raw).items():
                attrs.setdefault(key, []).extend(values)
            if q.matches(attrs):
                heights.append(height)
        return sorted(heights)


class NullTxIndexer:
    def index(self, *a, **k):
        pass

    def index_batch(self, items):
        pass

    def get(self, h):
        return None

    def search(self, query):
        return []


_TX_SUBSCRIBER = "indexer-tx"
_HDR_SUBSCRIBER = "indexer-hdr"


class IndexerService:
    """state/txindex/indexer_service.go: EventBus → indexers."""

    def __init__(self, tx_indexer, block_indexer, event_bus):
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.event_bus = event_bus
        self._running = False
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        self._running = True
        # Capacity 0: an unbounded queue, never full, never canceled.
        tx_sub = self.event_bus.subscribe(_TX_SUBSCRIBER, ev.EVENT_QUERY_TX, 0)
        hdr_sub = self.event_bus.subscribe(
            _HDR_SUBSCRIBER, ev.EVENT_QUERY_NEW_BLOCK_HEADER, 0
        )

        def tx_pump():
            while self._running:
                try:
                    msgs = [tx_sub.out.get(timeout=0.25)]
                except queue.Empty:
                    continue
                # What else is queued goes with it, as one batch (Go's
                # service hands a block's txs to AddBatch).
                while True:
                    try:
                        msgs.append(tx_sub.out.get_nowait())
                    except queue.Empty:
                        break
                items = []
                for msg in msgs:
                    d = msg.data
                    rec_events = {
                        k: v for k, v in msg.events.items() if k != ev.EVENT_TYPE_KEY
                    }
                    items.append((d.height, d.index, d.tx, d.result, rec_events))
                self.tx_indexer.index_batch(items)

        def hdr_pump():
            while self._running:
                try:
                    msg = hdr_sub.out.get(timeout=0.25)
                except queue.Empty:
                    continue
                d = msg.data
                evs = {k: v for k, v in msg.events.items() if k != ev.EVENT_TYPE_KEY}
                self.block_indexer.index(d.header.height, evs)

        for target in (tx_pump, hdr_pump):
            self._threads.append(threads.spawn(target))

    def stop(self) -> None:
        """Returns once neither pump can write again: both have left their
        loops (an index call under way finishes first)."""
        self._running = False
        for t in self._threads:
            t.join()
        self._threads = []
        for name in (_TX_SUBSCRIBER, _HDR_SUBSCRIBER):
            try:
                self.event_bus.unsubscribe_all(name)
            except KeyError:  # the bus was stopped first, which dropped them
                pass
