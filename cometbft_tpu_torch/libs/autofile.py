"""Rotating file group (libs/autofile/group.go + autofile.go), the port's
copy of ``cometbft_tpu/libs/autofile.py``: the consensus WAL writes through
it, so the port's WAL files are the reference's, chunk for chunk.

A Group owns a "head" file at `path` plus rotated chunks `path.000`,
`path.001`, ... Writes land in the head; when the head passes
head_size_limit it is renamed to the next index (RotateFile, group.go:220).
When the group's total size passes total_size_limit the oldest chunks are
deleted (checkTotalSizeLimit, group.go:320). GroupReader streams the chunks
oldest-first then the head — the consensus WAL's multi-file catchup scan
rides on it."""

from __future__ import annotations

import os
import re
import threading


class Group:
    """libs/autofile/group.go Group."""

    def __init__(
        self,
        head_path: str,
        head_size_limit: int = 10 * 1024 * 1024,
        total_size_limit: int = 1024 * 1024 * 1024,
    ):
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._mtx = threading.Lock()
        self._head = open(head_path, "ab")
        # Orderly-shutdown intent. Late writers racing close() are benign
        # no-ops ONLY when close() was actually called; any other closed-file
        # state (teardown-order bug, double stop) must keep crashing loudly
        # instead of silently dropping WAL frames or faking durability.
        self._closed = False

    # -- index bookkeeping -----------------------------------------------------

    def chunk_indices(self) -> list[int]:
        return _chunk_indices(self.head_path)

    def max_index(self) -> int:
        idx = self.chunk_indices()
        return (idx[-1] + 1) if idx else 0  # head is one past the last chunk

    def _chunk_path(self, i: int) -> str:
        return f"{self.head_path}.{i:03d}"

    # -- writing ---------------------------------------------------------------

    def write(self, data: bytes) -> None:
        with self._mtx:
            if self._closed:
                return  # orderly shutdown: late writers are no-ops
            self._head.write(data)

    def flush_and_sync(self) -> None:
        with self._mtx:
            if self._closed:
                return  # orderly shutdown
            self._head.flush()
            os.fsync(self._head.fileno())

    def maybe_rotate(self) -> bool:
        """group.go checkHeadSizeLimit: rotate when the head is over limit.
        Called between frames so rotation never splits a record."""
        with self._mtx:
            if self.head_size_limit <= 0 or self._closed:
                return False
            if self._head.tell() < self.head_size_limit:
                return False
            self._head.flush()
            os.fsync(self._head.fileno())
            self._head.close()
            nxt = self.max_index()
            os.replace(self.head_path, self._chunk_path(nxt))
            self._head = open(self.head_path, "ab")
        self._check_total_size()
        return True

    def _check_total_size(self) -> None:
        if self.total_size_limit <= 0:
            return
        with self._mtx:
            sizes = []
            for i in self.chunk_indices():
                p = self._chunk_path(i)
                try:
                    sizes.append((i, os.path.getsize(p)))
                except OSError:
                    continue
            total = sum(sz for _, sz in sizes)
            try:
                total += os.path.getsize(self.head_path)
            except OSError:
                pass
            for i, sz in sizes:
                if total <= self.total_size_limit:
                    break
                try:
                    os.unlink(self._chunk_path(i))
                except OSError:
                    pass
                total -= sz

    def close(self) -> None:
        with self._mtx:
            self._closed = True
            try:
                self._head.flush()
                os.fsync(self._head.fileno())
            except (OSError, ValueError):
                pass
            self._head.close()

    def reopen(self) -> None:
        with self._mtx:
            try:
                self._head.close()
            except OSError:
                pass
            self._head = open(self.head_path, "ab")
            self._closed = False

    def paths_oldest_first(self) -> list[str]:
        return group_paths(self.head_path)

    def reader(self):
        """GroupReader (group.go:480): a single byte stream across chunks."""
        return _GroupReader(self.paths_oldest_first())


def _chunk_indices(head_path: str) -> list[int]:
    d = os.path.dirname(head_path) or "."
    rx = re.compile(re.escape(os.path.basename(head_path)) + r"\.(\d{3,})$")
    out = []
    for name in os.listdir(d):
        m = rx.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def group_paths(head_path: str) -> list[str]:
    """The files of the group at head_path, oldest chunk first, head last,
    without opening the group for writing."""
    return [f"{head_path}.{i:03d}" for i in _chunk_indices(head_path)] + [head_path]


class _GroupReader:
    def __init__(self, paths: list[str]):
        self._paths = paths
        self._i = 0
        self._f = None

    def read(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            if self._f is None:
                if self._i >= len(self._paths):
                    return out
                try:
                    self._f = open(self._paths[self._i], "rb")
                except FileNotFoundError:
                    self._i += 1
                    continue
            chunk = self._f.read(n - len(out))
            if not chunk:
                self._f.close()
                self._f = None
                self._i += 1
                continue
            out += chunk
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
