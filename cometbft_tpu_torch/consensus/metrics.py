"""Consensus metrics (consensus/metrics.go:23 Metrics struct), the port's
copy of the no-op default of ``cometbft_tpu/consensus/metrics.py``: each
metric the state machine records, a no-op, so that
``ConsensusState`` never branches on instrumentation being enabled (the
reference's NopMetrics pattern). Metrics bound to a registry wait for the
port of ``libs/metrics.py``; the node raises for
``instrumentation.prometheus`` until then."""

from __future__ import annotations


class _Nop:
    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def labels(self, **k):
        return self


_NOP = _Nop()


class Metrics:
    """consensus/metrics.go Metrics (the load-bearing subset), no-op."""

    def __init__(self):
        self.height = _NOP
        self.rounds = _NOP
        self.validators = _NOP
        self.validators_power = _NOP
        self.num_txs = _NOP
        self.total_txs = _NOP
        self.block_size_bytes = _NOP
        self.latest_block_height = _NOP
        self.block_interval_seconds = _NOP
        self.consensus_stalls_total = _NOP
        self.wal_replay_round = _NOP
        self.round_catchup_votes_sent = _NOP

