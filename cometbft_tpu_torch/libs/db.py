"""Key-value database abstraction (cometbft-db via config/db.go:29),
the port's copy of ``cometbft_tpu/libs/db.py``.

Two backends: MemDB (sorted in-memory dict — the test seam from
consensus/common_test.go's dbm.NewMemDB) and SQLiteDB (stdlib sqlite3, the
persistent default replacing goleveldb; same ordered-iteration contract).
"""

from __future__ import annotations

import bisect
import os
import sqlite3
import threading


class DB:
    """Ordered KV store: Get/Set/Delete/Iterator/Batch (cometbft-db API)."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def set_sync(self, key: bytes, value: bytes) -> None:
        self.set(key, value)

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def delete_sync(self, key: bytes) -> None:
        self.delete(key)

    def compact(self) -> None:
        """Reclaim space (cmd compact-db; goleveldb CompactRange in the
        CometBFT — VACUUM for the sqlite backend, no-op in memory)."""

    def iterator(self, start: bytes | None = None, end: bytes | None = None):
        """Ascending iterator over [start, end) as (key, value) pairs."""
        raise NotImplementedError

    def reverse_iterator(self, start: bytes | None = None, end: bytes | None = None):
        raise NotImplementedError

    def new_batch(self) -> "Batch":
        return Batch(self)

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {}


class Batch:
    """Write batch with atomic-ish apply (cometbft-db Batch)."""

    def __init__(self, db: DB):
        self._db = db
        self._ops: list[tuple[str, bytes, bytes | None]] = []

    def set(self, key: bytes, value: bytes) -> None:
        self._ops.append(("set", bytes(key), bytes(value)))

    def delete(self, key: bytes) -> None:
        self._ops.append(("del", bytes(key), None))

    def write(self) -> None:
        for op, k, v in self._ops:
            if op == "set":
                self._db.set(k, v)
            else:
                self._db.delete(k)
        self._ops.clear()

    def write_sync(self) -> None:
        self.write()

    def close(self) -> None:
        self._ops.clear()


class MemDB(DB):
    """Sorted in-memory store (cometbft-db memdb)."""

    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []
        self._mtx = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            return self._data.get(bytes(key))

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        with self._mtx:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._mtx:
            if key in self._data:
                del self._data[key]
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]

    def _range(self, start, end):
        lo = 0 if start is None else bisect.bisect_left(self._keys, bytes(start))
        hi = len(self._keys) if end is None else bisect.bisect_left(self._keys, bytes(end))
        return lo, hi

    def iterator(self, start=None, end=None):
        with self._mtx:
            lo, hi = self._range(start, end)
            items = [(k, self._data[k]) for k in self._keys[lo:hi]]
        yield from items

    def reverse_iterator(self, start=None, end=None):
        with self._mtx:
            lo, hi = self._range(start, end)
            items = [(k, self._data[k]) for k in reversed(self._keys[lo:hi])]
        yield from items


class SQLiteDB(DB):
    """Persistent KV on stdlib sqlite3 (WAL mode). Plays the role of the
    CometBFT's goleveldb default backend (config/toml.go:92-110)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
        )
        self._conn.commit()
        self._mtx = threading.RLock()

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (bytes(key),)
            ).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._mtx:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                (bytes(key), bytes(value)),
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._mtx:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (bytes(key),))
            self._conn.commit()

    def compact(self) -> None:
        with self._mtx:
            self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            self._conn.execute("VACUUM")
            self._conn.commit()

    def iterator(self, start=None, end=None):
        q, args = "SELECT k, v FROM kv", []
        clauses = []
        if start is not None:
            clauses.append("k >= ?")
            args.append(bytes(start))
        if end is not None:
            clauses.append("k < ?")
            args.append(bytes(end))
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        q += " ORDER BY k ASC"
        with self._mtx:
            rows = self._conn.execute(q, args).fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def reverse_iterator(self, start=None, end=None):
        rows = list(self.iterator(start, end))
        yield from reversed(rows)

    def new_batch(self) -> "Batch":
        return _SQLiteBatch(self)

    def close(self) -> None:
        with self._mtx:
            self._conn.close()


class _SQLiteBatch(Batch):
    def write(self) -> None:
        db = self._db
        with db._mtx:
            for op, k, v in self._ops:
                if op == "set":
                    db._conn.execute(
                        "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (k, v)
                    )
                else:
                    db._conn.execute("DELETE FROM kv WHERE k = ?", (k,))
            db._conn.commit()
        self._ops.clear()


def new_db(name: str, backend: str, db_dir: str) -> DB:
    """config/db.go DefaultDBProvider analog."""
    if backend in ("memdb", "mem"):
        return MemDB()
    return SQLiteDB(os.path.join(db_dir, f"{name}.sqlite"))
