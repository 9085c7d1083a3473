"""The port's deadlock and stall tooling (``libs/deadlock.py``) against the
JAX package's, after ``tests/test_profiling_deadlock.py``:

- crosswise waiters on two ``TrackedLock``s are a cycle, with the same
  chain in both packages, and stuck waiters are reported; the cycle clears
  once the waits time out;
- the watchdog, driven by an injected clock one ``check()`` at a time,
  fires on a stall with the reference's report, recovers when the value
  moves, and counts a progress function that raises;
- the watchdog's thread joins the caller's thread group and ends at
  ``stop()``; a node with ``CMTPU_WATCHDOG`` runs it and leaves no thread.

Waits are liveness guards (events, polls to a deadline), never time
bounds."""

import threading
import time

import pytest

from cometbft_tpu.libs import deadlock as ref_deadlock
from cometbft_tpu_torch.libs import deadlock, threads

pytestmark = pytest.mark.torch_port

WAIT_S = 60.0


def _crosswise(mod):
    """Two threads holding A and B and each waiting on the other's lock;
    returns the cycle and the stuck waiters seen while both wait, and the
    cycles left once the waits have timed out."""
    a, b = mod.TrackedLock("A"), mod.TrackedLock("B")
    held = threading.Barrier(3)
    release = threading.Event()

    def run(first, second):
        with first:
            held.wait()
            while not release.is_set():
                if second.acquire(timeout=0.05):
                    second.release()
                    return

    th = [threading.Thread(target=run, args=(a, b), daemon=True),
          threading.Thread(target=run, args=(b, a), daemon=True)]
    for x in th:
        x.start()
    held.wait()
    deadline = time.monotonic() + WAIT_S
    cycles = []
    while not cycles:
        assert time.monotonic() < deadline, "the crosswise waits never showed"
        cycles = mod.detect_cycles()
        time.sleep(0.001)
    stuck = mod.stuck_waiters(threshold=0.0)
    release.set()
    for x in th:
        x.join(WAIT_S)
        assert not x.is_alive()
    return cycles, stuck, mod.detect_cycles()


def _shape(cycles):
    """Each cycle's lock names, sorted."""
    out = []
    for chain in cycles:
        out.append(sorted(link.split(" -> ")[1].split(" (")[0] for link in chain))
    return sorted(out)


@pytest.mark.parametrize("mod", [deadlock, ref_deadlock], ids=["port", "reference"])
def test_deadlock_cycle_detected(mod):
    cycles, stuck, after = _crosswise(mod)
    assert cycles, "crosswise waiters must produce a cycle"
    flat = "\n".join(cycles[0])
    assert "A" in flat and "B" in flat
    assert len(cycles[0]) == 2 and _shape(cycles)[0] == ["A", "B"]
    assert stuck and all(" stuck " in s for s in stuck)
    assert not after, "cycle clears after the waits end"


def test_cycles_and_waiters_have_the_reference_text():
    """The same crosswise waits give the same chains in both packages, but
    for the thread ids."""
    import re

    port = _crosswise(deadlock)[0]
    ref = _crosswise(ref_deadlock)[0]
    strip = lambda cs: sorted(tuple(re.sub(r"\d+", "N", link) for link in c)  # noqa: E731
                              for c in cs)
    assert strip(port) == strip(ref)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_watchdog_fires_on_stall_and_recovers():
    clock, value, reports = _Clock(), {"v": 0}, []
    wd = deadlock.Watchdog(lambda: value["v"], stall_after=10.0, interval=1.0,
                           on_stall=reports.append, clock=clock)
    for _ in range(4):  # progress: no stall however long it takes
        value["v"] += 1
        clock.t += 30.0
        assert wd.check() is False
    clock.t += 9.9
    assert wd.check() is False and not reports
    clock.t += 0.2
    assert wd.check() is True
    assert reports[0].startswith("watchdog: no progress for 10.0s (value 4)\n")
    assert "MainThread" in reports[0] and wd.stalls == 1
    assert wd.check() is False, "a report re-arms the stall budget"
    value["v"] += 1  # recovers
    assert wd.check() is False
    clock.t += 10.0
    assert wd.check() is True and wd.stalls == 2 and len(reports) == 2


def test_watchdog_counts_a_raising_progress_function():
    clock = _Clock()

    def progress():
        raise RuntimeError("planted progress failure")

    wd = deadlock.Watchdog(progress, stall_after=1.0, clock=clock)
    clock.t += 5.0
    assert wd.check() is False and wd.check() is False
    assert wd.sample_errors == 2 and isinstance(wd.last_sample_error, RuntimeError)
    assert wd.stalls == 0


def test_watchdog_thread_joins_the_group_and_ends_at_stop():
    """Started in a group's scope, the thread belongs to the group; its
    checks run each interval (an event counts them); stop() ends it."""
    checks = threading.Event()
    calls = []

    def progress():
        calls.append(1)
        if len(calls) >= 3:
            checks.set()
        return len(calls)

    group = threads.ThreadGroup("t")
    wd = deadlock.Watchdog(progress, stall_after=1e9, interval=0.01)
    with group.scope():
        wd.start()
    assert checks.wait(WAIT_S)
    assert wd._thread in group.threads()
    wd.stop()
    assert not wd._thread.is_alive() and group.join(WAIT_S) == []


@pytest.fixture
def cpu_backend():
    from cometbft_tpu_torch.sidecar import backend

    old = backend._backend
    backend.set_backend(backend.CpuBackend())
    yield
    backend._backend = old


def test_node_with_watchdog_leaves_no_thread(monkeypatch, cpu_backend):
    """CMTPU_WATCHDOG starts the watchdog over the consensus height at
    ``start()``: it samples the advancing height and never reports a
    stall, and ``stop()`` leaves no thread of the node."""
    import test_torch_metrics as tm

    monkeypatch.setenv("CMTPU_WATCHDOG", "600")
    nd = tm._solo_node("cometbft_tpu_torch", b"watchdog-node")
    nd.start()
    try:
        wd = nd.watchdog
        deadline = time.monotonic() + 180
        while nd.block_store.height() < 3:
            assert time.monotonic() < deadline, "the node stopped committing"
            time.sleep(0.02)
    finally:
        nd.stop()
    assert wd.stalls == 0 and wd.sample_errors == 0
    assert nd.threads_left_at_stop == 0 and not wd._thread.is_alive()
