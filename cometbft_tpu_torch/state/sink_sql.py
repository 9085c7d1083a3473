"""SQL event sink (state/indexer/sink/psql/psql.go + schema.sql), the port's
copy of ``cometbft_tpu/state/sink_sql.py``: the same tables, rows and
refusals.

CometBFT ships a PostgreSQL event sink selected by ``indexer = "psql"``:
a WRITE-ONLY sink — blocks, tx_results (protobuf-encoded), events, and
indexed attributes land in relational tables for external SQL consumers,
while the node's own /tx_search, /block_search and getTxByHash report
"not supported via the postgres event sink" (psql.go:236-253).

This is that sink on sqlite (the analog available in-image): identical
table/view shapes (schema.sql — BIGSERIAL/BYTEA/TIMESTAMPTZ mapped to their
sqlite spellings), the same meta-events (block.height on blocks, tx.hash +
tx.height on transactions, psql.go:162,216-218), the same
only-indexed-attributes rule (attr.Index gate, psql.go:110-112), the same
quiet-duplicate semantics (ON CONFLICT DO NOTHING, psql.go:155,209), and
the same query refusals.

Two deliberate divergences:
  - IndexTxEvents creates the block row if the header has not been indexed
    yet (the reference errors, psql.go:195 — it can, because its indexer
    service is single-threaded; this node's tx and header pumps are
    independent threads, so ordering is not guaranteed);
  - the event bus hands the sink FLATTENED composite keys ("type.key" ->
    values), so an event with N attributes becomes N single-attribute
    events rows rather than the reference's one events row with N
    attributes rows — external consumers grouping by event instance should
    group on (block_id, tx_id, type) instead of events.rowid.
"""

from __future__ import annotations

import sqlite3
import threading
import time

from cometbft_tpu_torch.types.tx import tx_hash

_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  height     INTEGER NOT NULL,
  chain_id   TEXT NOT NULL,
  created_at TEXT NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain ON blocks(height, chain_id);

CREATE TABLE IF NOT EXISTS tx_results (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id   INTEGER NOT NULL REFERENCES blocks(rowid),
  "index"    INTEGER NOT NULL,
  created_at TEXT NOT NULL,
  tx_hash    TEXT NOT NULL,
  tx_result  BLOB NOT NULL,
  UNIQUE (block_id, "index")
);

CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id INTEGER NOT NULL REFERENCES blocks(rowid),
  tx_id    INTEGER NULL REFERENCES tx_results(rowid),
  type     TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS attributes (
  event_id      INTEGER NOT NULL REFERENCES events(rowid),
  key           TEXT NOT NULL,
  composite_key TEXT NOT NULL,
  value         TEXT NULL,
  UNIQUE (event_id, key)
);

CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes ON (events.rowid = attributes.event_id);

CREATE VIEW IF NOT EXISTS block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key, composite_key, value
  FROM blocks JOIN event_attributes ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;

CREATE VIEW IF NOT EXISTS tx_events AS
  SELECT height, "index", chain_id, type, key, composite_key, value,
         tx_results.created_at
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON (tx_results.rowid = event_attributes.tx_id)
  WHERE event_attributes.tx_id IS NOT NULL;
"""


class SinkQueryUnsupportedError(Exception):
    """The psql sink refuses node-local queries (psql.go:236-253)."""


class SinkClosedError(Exception):
    """A write reached the sink after ``stop()``."""


class SqlEventSink:
    def __init__(self, path: str, chain_id: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        # Readers (external SQL consumers) never wait on a batch's write
        # transaction, as under PostgreSQL; each commit still syncs.
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self._chain_id = chain_id
        self._mtx = threading.Lock()
        self._closed = False

    def _cursor(self):
        """A cursor for a write; the caller holds ``_mtx``."""
        if self._closed:
            raise SinkClosedError("the sql event sink is closed")
        return self._conn.cursor()

    # -- write side ---------------------------------------------------------

    def _block_row(self, cur, height: int) -> int:
        cur.execute(
            "INSERT OR IGNORE INTO blocks (height, chain_id, created_at) "
            "VALUES (?, ?, ?)",
            (height, self._chain_id, _now()),
        )
        cur.execute(
            "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?",
            (height, self._chain_id),
        )
        return cur.fetchone()[0]

    def _insert_events(self, cur, block_id: int, tx_id, events: dict) -> None:
        """events: composite-key dict ("type.key" -> [values]) as carried by
        the event bus; split exactly like makeIndexedEvent (psql.go:128-138).
        Every attribute that reaches the bus was flagged for indexing
        upstream, matching the attr.Index gate."""
        for composite_key, values in events.items():
            dot = composite_key.find(".")
            etype = composite_key if dot < 0 else composite_key[:dot]
            key = None if dot < 0 else composite_key[dot + 1 :]
            if not etype:
                continue  # psql.go:99-101 skips empty types
            for value in values:
                cur.execute(
                    "INSERT INTO events (block_id, tx_id, type) VALUES (?, ?, ?)",
                    (block_id, tx_id, etype),
                )
                eid = cur.lastrowid
                if key is not None:
                    cur.execute(
                        "INSERT OR IGNORE INTO attributes "
                        "(event_id, key, composite_key, value) VALUES (?, ?, ?, ?)",
                        (eid, key, composite_key, str(value)),
                    )

    def index_block(self, height: int, events: dict) -> None:
        """IndexBlockEvents (psql.go:141-176): block row + block.height
        meta-event + the header's begin/end-block events."""
        with self._mtx:
            cur = self._cursor()
            block_id = self._block_row(cur, height)
            self._insert_events(
                cur, block_id, None, {"block.height": [str(height)]}
            )
            self._insert_events(cur, block_id, None, events)
            self._conn.commit()

    def index_tx(self, height: int, index: int, tx: bytes, result, events: dict) -> None:
        """IndexTxEvents (psql.go:178-233): tx_result row (wire-encoded) +
        tx.hash/tx.height meta-events + the tx's own events."""
        self.index_txs([(height, index, tx, result, events)])

    def index_txs(self, items) -> None:
        """IndexTxEvents over a batch, in one transaction as psql.go's
        runInTransaction does: each (height, index, tx, result, events)
        written as ``index_tx`` writes it, in order, duplicates quietly
        skipped, one commit for the batch."""
        from cometbft_tpu_torch.abci.wire import _enc_resp_body
        from cometbft_tpu_torch.wire import proto as wire

        with self._mtx:
            cur = self._cursor()
            for height, index, tx, result, events in items:
                h = tx_hash(tx).hex().upper()
                # abci.TxResult wire shape (abci/types.proto): height=1,
                # index=2, tx=3, result=4 — what the reference proto.Marshal's
                # (psql.go:183).
                result_data = (
                    wire.field_varint(1, height)
                    + wire.field_varint(2, index)
                    + wire.field_bytes(3, tx)
                    + wire.field_message(4, _enc_resp_body(result), emit_empty=True)
                )
                block_id = self._block_row(cur, height)
                cur.execute(
                    'INSERT OR IGNORE INTO tx_results (block_id, "index", '
                    "created_at, tx_hash, tx_result) VALUES (?, ?, ?, ?, ?)",
                    (block_id, index, _now(), h, result_data),
                )
                if cur.rowcount == 0:
                    continue  # duplicate: quietly succeed (psql.go:209-211)
                tx_id = cur.lastrowid
                self._insert_events(
                    cur, block_id, tx_id,
                    {"tx.hash": [h], "tx.height": [str(height)]},
                )
                self._insert_events(cur, block_id, tx_id, events)
            self._conn.commit()

    def stop(self) -> None:
        with self._mtx:
            if not self._closed:
                self._closed = True
                self._conn.close()

    # -- IndexerService adapters (tx_indexer / block_indexer duck types) ----

    def tx_indexer(self) -> "_TxAdapter":
        return _TxAdapter(self)

    def block_indexer(self) -> "_BlockAdapter":
        return _BlockAdapter(self)

    # -- read side: refused, like the reference sink ------------------------

    def search(self, query: str):
        raise SinkQueryUnsupportedError(
            "tx search is not supported via the psql event sink"
        )

    def get(self, h: bytes):
        raise SinkQueryUnsupportedError(
            "getTxByHash is not supported via the psql event sink"
        )

    def has_block(self, height: int):
        raise SinkQueryUnsupportedError(
            "hasBlock is not supported via the psql event sink"
        )


class _TxAdapter:
    def __init__(self, sink: SqlEventSink):
        self._sink = sink

    def index(self, height, index, tx, result, result_events) -> None:
        self._sink.index_tx(height, index, tx, result, result_events)

    def index_batch(self, items) -> None:
        """The IndexerService's batch: (height, index, tx, result, events)
        tuples, one transaction."""
        self._sink.index_txs(items)

    def get(self, h: bytes):
        return self._sink.get(h)

    def search(self, query: str):
        return self._sink.search(query)


class _BlockAdapter:
    def __init__(self, sink: SqlEventSink):
        self._sink = sink

    def index(self, height, events) -> None:
        self._sink.index_block(height, events)

    def search(self, query: str):
        return self._sink.search(query)


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
