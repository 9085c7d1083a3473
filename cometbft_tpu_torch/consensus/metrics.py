"""Consensus metrics (reference: consensus/metrics.go:23 Metrics struct),
the port's copy of ``cometbft_tpu/consensus/metrics.py``.

Real instances bind to a libs.metrics.Registry; the default is a no-op so
ConsensusState never branches on instrumentation being enabled (the
reference's NopMetrics pattern).
"""

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
    """consensus/metrics.go Metrics (the load-bearing subset)."""

    def __init__(self, registry=None):
        if registry is None:
            self.height = _NOP
            self.rounds = _NOP
            self.round_duration_seconds = _NOP
            self.validators = _NOP
            self.validators_power = _NOP
            self.num_txs = _NOP
            self.total_txs = _NOP
            self.block_size_bytes = _NOP
            self.latest_block_height = _NOP
            self.block_interval_seconds = _NOP
            self.block_parts = _NOP
            self.consensus_stalls_total = _NOP
            self.round_catchup_votes_sent = _NOP
            self.wal_replay_round = _NOP
            return
        sub = "consensus"
        self.height = registry.gauge(sub, "height", "Height of the chain.")
        self.rounds = registry.gauge(sub, "rounds", "Number of rounds at this height.")
        self.round_duration_seconds = registry.histogram(
            sub, "round_duration_seconds", "Time spent in a round.",
            buckets=(0.1, 0.27, 0.72, 1.9, 5.2, 14, 37, 100),
        )
        self.validators = registry.gauge(sub, "validators", "Number of validators.")
        self.validators_power = registry.gauge(
            sub, "validators_power", "Total voting power of validators."
        )
        self.num_txs = registry.gauge(sub, "num_txs", "Txs in the latest block.")
        self.total_txs = registry.counter(sub, "total_txs", "Total committed txs.")
        self.block_size_bytes = registry.gauge(
            sub, "block_size_bytes", "Size of the latest block."
        )
        self.latest_block_height = registry.gauge(
            sub, "latest_block_height", "Latest committed block height."
        )
        self.block_interval_seconds = registry.histogram(
            sub, "block_interval_seconds", "Time between this and the last block.",
        )
        self.block_parts = registry.counter(
            sub, "block_parts", "Block parts transmitted per peer.", labels=("peer_id",)
        )
        # Liveness hardening: stall watchdog + round-catchup gossip + WAL
        # round restore (consensus/reactor.py pick cascade, state.py watchdog).
        self.consensus_stalls_total = registry.counter(
            sub, "stalls_total",
            "Stall-watchdog firings: no round-step progress for the "
            "escalated-timeout budget.",
        )
        self.round_catchup_votes_sent = registry.counter(
            sub, "round_catchup_votes_sent",
            "Votes gossiped to peers lagging in rounds (peer-round prevotes/"
            "precommits, POL prevotes, last-commit precommits).",
        )
        self.wal_replay_round = registry.gauge(
            sub, "wal_replay_round",
            "Round restored from the WAL on the last mid-height restart.",
        )


NOP_METRICS = Metrics()
