"""Node configuration (config/config.go), the port's copy of what the ported
modules read of ``cometbft_tpu/config/config.py``: ``RPCConfig``,
``P2PConfig``, ``MempoolConfig`` and ``ConsensusConfig``, their fields and
defaults, a ``Config`` of those sections and ``test_config``. The other
sections (``TxIndexConfig`` among them: nothing in the port selects an
indexer yet) wait for the node."""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.p2p.conn.connection import (
    DEFAULT_MAX_PACKET_MSG_PAYLOAD_SIZE,
    DEFAULT_RECV_RATE,
    DEFAULT_SEND_RATE,
)


@dataclass
class RPCConfig:
    """config/config.go:330-480: the fields the port reads. ``laddr`` is
    where a node serves ``rpc/jsonrpc/server.JSONRPCServer``;
    ``timeout_broadcast_tx_commit`` bounds the waits of
    ``broadcast_tx_sync`` and ``broadcast_tx_commit`` (seconds); ``unsafe``
    adds the dial and flush routes (``rpc/core.routes``). The CORS, TLS,
    gRPC and connection limits wait for the node slice, which reads them."""

    laddr: str = "tcp://127.0.0.1:26657"
    unsafe: bool = False
    timeout_broadcast_tx_commit: float = 10.0


@dataclass
class P2PConfig:
    """config/config.go:490-620: the fields the port reads. The ``Switch``
    hands them to each peer's ``MConnection``; their defaults are that
    module's constants. The listener, the peer lists, PEX and the fuzzing
    knobs wait for the node slice, which reads them."""

    max_packet_msg_payload_size: int = DEFAULT_MAX_PACKET_MSG_PAYLOAD_SIZE
    send_rate: int = DEFAULT_SEND_RATE
    recv_rate: int = DEFAULT_RECV_RATE


@dataclass
class MempoolConfig:
    """config/config.go:640-720."""

    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = ""
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1048576
    max_batch_bytes: int = 0
    # QoS ingress (mempool/ingress.py, not ported); its CMTPU_INGRESS_* knobs
    # are read there.
    ingress_enable: bool = True
    ingress_lanes: int = 4
    ingress_sender_rps: float = 0.0  # 0 = per-sender rate limit off
    ingress_queue_max: int = 2048
    ingress_window_ms: float = 2.0


@dataclass
class ConsensusConfig:
    """config/config.go:925-1080: the consensus timeouts (seconds), the
    fields the state machine reads and the reactor's maj23 query sleep (its
    gossip sleep is the reactor's own argument); the WAL's path waits for
    the node slice."""

    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_query_maj23_sleep_duration: float = 2.0
    # Stall watchdog: if no round-step progress for this many multiples of
    # the current round's full escalated timeout budget, re-announce our
    # round step and re-arm the step's timeout (0 disables).
    # CMTPU_STALL_FACTOR overrides it when the state machine is built.
    stall_watchdog_factor: float = 10.0

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def round_timeout_budget(self, round_: int) -> float:
        """Worst-case wall time one full round can legitimately take at this
        escalation level: the stall watchdog's unit of patience."""
        return (
            self.propose_timeout(round_)
            + self.prevote_timeout(round_)
            + self.precommit_timeout(round_)
            + self.timeout_commit
        )


@dataclass
class Config:
    """The sections of config/config.go:67-120 that the port reads."""

    rpc: RPCConfig = dfield(default_factory=RPCConfig)
    p2p: P2PConfig = dfield(default_factory=P2PConfig)
    mempool: MempoolConfig = dfield(default_factory=MempoolConfig)
    consensus: ConsensusConfig = dfield(default_factory=ConsensusConfig)


def test_config() -> Config:
    """config/config.go TestConfig: tight timeouts for in-process testing."""
    c = Config()
    c.consensus = ConsensusConfig(
        timeout_propose=0.4,
        timeout_propose_delta=0.002,
        timeout_prevote=0.01,
        timeout_prevote_delta=0.002,
        timeout_precommit=0.01,
        timeout_precommit_delta=0.002,
        timeout_commit=0.01,
        skip_timeout_commit=True,
        peer_query_maj23_sleep_duration=0.25,
    )
    c.rpc.laddr = "tcp://127.0.0.1:36657"
    return c
