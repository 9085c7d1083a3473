"""Thread ownership, so that a node's ``stop()`` can wait for its threads.

A ``ThreadGroup`` owns every thread that ``spawn`` (or ``timer``) starts
inside its ``scope()``, and every thread that those threads start in turn:
the group rides on the spawned thread. Objects built in a scope that later
spawn on behalf of outside callers (the ``Switch`` dials for an RPC handler
or a test) capture ``current_group()`` and enter it again. Outside any
scope, ``spawn`` is ``threading.Thread(..., daemon=True).start()``.
"""

from __future__ import annotations

import contextlib
import threading
import time

_local = threading.local()


def current_group() -> "ThreadGroup | None":
    return getattr(_local, "group", None)


class ThreadGroup:
    def __init__(self, name: str = ""):
        self.name = name
        self._mtx = threading.Lock()
        self._threads: list[threading.Thread] = []

    @contextlib.contextmanager
    def scope(self):
        """Threads spawned on this thread inside the block join the group."""
        prev = current_group()
        _local.group = self
        try:
            yield self
        finally:
            _local.group = prev

    def _add(self, t: threading.Thread) -> None:
        with self._mtx:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def threads(self) -> list[threading.Thread]:
        """The group's threads still alive."""
        with self._mtx:
            return [t for t in self._threads if t.is_alive()]

    def join(self, timeout: float) -> list[threading.Thread]:
        """Wait until every thread of the group (but the caller) has ended,
        or ``timeout`` seconds have passed; returns those still alive. A
        thread may start another while the group is joined, so the walk
        repeats until a pass finds none alive."""
        deadline = time.monotonic() + timeout
        me = threading.current_thread()
        while True:
            alive = [t for t in self.threads() if t is not me]
            if not alive:
                return []
            for t in alive:
                t.join(max(0.0, deadline - time.monotonic()))
            if time.monotonic() >= deadline:
                return [t for t in self.threads() if t is not me]


def _bind(group, fn):
    def run(*args, **kwargs):
        _local.group = group
        return fn(*args, **kwargs)

    return run


def spawn(target, args=(), name: str | None = None) -> threading.Thread:
    """Start a daemon thread in the caller's group (if any)."""
    group = current_group()
    t = threading.Thread(target=_bind(group, target), args=args, name=name, daemon=True)
    if group is not None:
        group._add(t)
    t.start()
    return t


def timer(delay: float, fn, args=()) -> threading.Timer:
    """``threading.Timer`` started as a daemon in the caller's group."""
    group = current_group()
    t = threading.Timer(delay, _bind(group, fn), args=args)
    t.daemon = True
    if group is not None:
        group._add(t)
    t.start()
    return t
