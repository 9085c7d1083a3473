"""Deterministic kill-points for crash-recovery testing
(libs/fail/fail.go:9-39), the port's copy of ``cometbft_tpu/libs/fail.py``.

Every `fail()` call site hit increments a process-wide counter; when the
counter reaches the integer in $FAIL_TEST_INDEX the process hard-exits
(os._exit — no cleanup, no flushing), simulating a crash at exactly that
point between the non-atomic persistence steps of finalizeCommit/ApplyBlock
(call sites mirror consensus/state.go:787,1656,1670,1693,1712,1720 and
state/execution.go:212,219,255,263).
"""

from __future__ import annotations

import os

_call_index = -1


def fail() -> None:
    global _call_index
    env = os.environ.get("FAIL_TEST_INDEX")
    if env is None:
        return
    _call_index += 1
    if _call_index == int(env):
        os._exit(99)
