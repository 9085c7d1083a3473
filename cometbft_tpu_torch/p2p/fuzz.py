"""Fuzzed p2p connections (p2p/fuzz.go FuzzedConnection + config.go
FuzzConnConfig), the port's copy of ``cometbft_tpu/p2p/fuzz.py``:
probabilistic delay/drop injected between the MConnection and the (secret)
transport stream, for soak-testing reactor resilience to a flaky network.

Modes (fuzz.go:16-20): "drop" randomly swallows writes or kills the
connection; "delay" randomly sleeps before IO. Swallowed writes corrupt the
framed stream by design — the peer's receive loop errors and the switch's
reconnect/redial machinery is what's actually under test. Enabled via
config.p2p.test_fuzz — never in production paths."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass


@dataclass
class FuzzConnConfig:
    """config.go FuzzConnConfig defaults (config.go:1130)."""

    mode: str = "delay"  # "drop" | "delay"
    max_delay: float = 0.2
    prob_drop_rw: float = 0.2
    prob_drop_conn: float = 0.0
    prob_sleep: float = 0.0
    seed: int | None = None


class FuzzedConn:
    """Wraps the upgraded (secret) connection's write/read surface
    (fuzz.go:66 FuzzedConnection)."""

    def __init__(self, conn, config: FuzzConnConfig | None = None):
        self._conn = conn
        self.config = config or FuzzConnConfig()
        self._rand = random.Random(self.config.seed)

    def _fuzz_write(self) -> bool:
        """True when this write should be swallowed."""
        c = self.config
        if c.mode == "drop":
            r = self._rand.random()
            if r < c.prob_drop_rw:
                return True
            if r < c.prob_drop_rw + c.prob_drop_conn:
                self._conn.close()
                return True
            if r < c.prob_drop_rw + c.prob_drop_conn + c.prob_sleep:
                time.sleep(self._rand.random() * c.max_delay)
        elif c.mode == "delay":
            time.sleep(self._rand.random() * c.max_delay)
        return False

    def write(self, data: bytes) -> int:
        if self._fuzz_write():
            return len(data)  # lied about: bytes vanish like a lossy link
        return self._conn.write(data)

    def read(self, max_bytes: int = 65536) -> bytes:
        if self.config.mode == "delay":
            time.sleep(self._rand.random() * self.config.max_delay)
        return self._conn.read(max_bytes)

    def read_exact(self, n: int) -> bytes:
        if self.config.mode == "delay":
            time.sleep(self._rand.random() * self.config.max_delay)
        return self._conn.read_exact(n)

    def close(self) -> None:
        self._conn.close()

    def __getattr__(self, name):
        return getattr(self._conn, name)
