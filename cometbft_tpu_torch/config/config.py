"""Node configuration (config/config.go), the port's copy of
``cometbft_tpu/config/config.py``: every section and field with the
reference's defaults, ``validate_basic``, ``default_config`` and
``test_config``. ``config/toml.py`` renders and loads all of them, so a
``config.toml`` written by either package loads in the other."""

from __future__ import annotations

import os
from dataclasses import dataclass, field as dfield, replace


@dataclass
class BaseConfig:
    """config/config.go:187-320 BaseConfig."""

    root_dir: str = ""
    # CometBFT defaults to tcp://127.0.0.1:26658 (an external app); here the
    # in-process kvstore is the default so a node starts standalone. A socket
    # or grpc:// address needs the ABCI transports, not ported yet.
    proxy_app: str = "kvstore"
    moniker: str = "anonymous"
    block_sync: bool = True
    db_backend: str = "sqlite"
    db_dir: str = "data"
    log_level: str = "info"
    log_format: str = "plain"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    priv_validator_laddr: str = ""
    node_key_file: str = "config/node_key.json"
    abci: str = "socket"
    filter_peers: bool = False
    # In-process kvstore apps only (CometBFT keeps this app-side, in the
    # e2e app's own config — test/e2e/app/app.go): take a state snapshot
    # every N heights so peers can statesync from this node.  0 = off.
    snapshot_interval: int = 0

    def genesis_path(self) -> str:
        return os.path.join(self.root_dir, self.genesis_file)

    def priv_validator_key_path(self) -> str:
        return os.path.join(self.root_dir, self.priv_validator_key_file)

    def priv_validator_state_path(self) -> str:
        return os.path.join(self.root_dir, self.priv_validator_state_file)

    def node_key_path(self) -> str:
        return os.path.join(self.root_dir, self.node_key_file)

    def db_path(self) -> str:
        return os.path.join(self.root_dir, self.db_dir)


@dataclass
class RPCConfig:
    """config/config.go:330-480."""

    laddr: str = "tcp://127.0.0.1:26657"
    cors_allowed_origins: tuple = ()
    cors_allowed_methods: tuple = ("HEAD", "GET", "POST")
    cors_allowed_headers: tuple = ("Origin", "Accept", "Content-Type", "X-Requested-With", "X-Server-Time")
    grpc_laddr: str = ""
    grpc_max_open_connections: int = 900
    unsafe: bool = False
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    experimental_subscription_buffer_size: int = 200
    timeout_broadcast_tx_commit: float = 10.0
    max_body_bytes: int = 1000000
    max_header_bytes: int = 1 << 20
    tls_cert_file: str = ""
    tls_key_file: str = ""
    pprof_laddr: str = ""


@dataclass
class P2PConfig:
    """config/config.go:490-620."""

    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    addr_book_file: str = "config/addrbook.json"
    addr_book_strict: bool = True
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    unconditional_peer_ids: str = ""
    persistent_peers_max_dial_period: float = 0.0
    flush_throttle_timeout: float = 0.1
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5120000
    recv_rate: int = 5120000
    pex: bool = True
    seed_mode: bool = False
    private_peer_ids: str = ""
    test_fuzz: bool = False  # wrap connections in FuzzedConn (p2p/fuzz.go)
    test_fuzz_mode: str = "delay"
    test_fuzz_max_delay: float = 0.2
    test_fuzz_prob_drop_rw: float = 0.2
    allow_duplicate_ip: bool = False
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0


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
    # QoS ingress (mempool/ingress.py); CMTPU_INGRESS_* env knobs override.
    ingress_enable: bool = True
    ingress_lanes: int = 4
    ingress_sender_rps: float = 0.0  # 0 = per-sender rate limit off
    ingress_queue_max: int = 2048
    ingress_window_ms: float = 2.0


@dataclass
class StateSyncConfig:
    """config/config.go:740-830."""

    enable: bool = False
    temp_dir: str = ""
    rpc_servers: tuple = ()
    trust_period: float = 168 * 3600.0
    trust_height: int = 0
    trust_hash: str = ""
    discovery_time: float = 15.0
    chunk_request_timeout: float = 10.0
    chunk_fetchers: int = 4


@dataclass
class BlockSyncConfig:
    """config/config.go:850-880 (+ the top-level BlockSyncMode toggle,
    config.go:85)."""

    enable: bool = True
    version: str = "v0"


@dataclass
class ConsensusConfig:
    """config/config.go:925-1080: all consensus timeouts (seconds)."""

    wal_file: str = "data/cs.wal/wal"
    root_dir: str = ""
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
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0
    double_sign_check_height: int = 0
    # Stall watchdog: if no round-step progress for this many multiples of
    # the current round's full escalated timeout budget, re-announce our
    # round step and re-fire maj23 queries (0 disables). CMTPU_STALL_FACTOR
    # env overrides at node start.
    stall_watchdog_factor: float = 10.0

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit_time(self, t: float) -> float:
        return t + self.timeout_commit

    def round_timeout_budget(self, round_: int) -> float:
        """Worst-case wall time one full round can legitimately take at this
        escalation level — the stall watchdog's unit of patience."""
        return (
            self.propose_timeout(round_)
            + self.prevote_timeout(round_)
            + self.precommit_timeout(round_)
            + self.timeout_commit
        )

    def wal_path(self) -> str:
        return os.path.join(self.root_dir, self.wal_file)


@dataclass
class StorageConfig:
    discard_abci_responses: bool = False


@dataclass
class TxIndexConfig:
    indexer: str = "kv"  # "null" | "kv" | "psql"
    psql_conn: str = ""


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    max_open_connections: int = 3
    namespace: str = "cometbft"


@dataclass
class Config:
    """config/config.go:67-120 top-level."""

    base: BaseConfig = dfield(default_factory=BaseConfig)
    rpc: RPCConfig = dfield(default_factory=RPCConfig)
    p2p: P2PConfig = dfield(default_factory=P2PConfig)
    mempool: MempoolConfig = dfield(default_factory=MempoolConfig)
    statesync: StateSyncConfig = dfield(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = dfield(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = dfield(default_factory=ConsensusConfig)
    storage: StorageConfig = dfield(default_factory=StorageConfig)
    tx_index: TxIndexConfig = dfield(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = dfield(default_factory=InstrumentationConfig)

    def set_root(self, root: str) -> "Config":
        self.base.root_dir = root
        self.consensus.root_dir = root
        return self

    def validate_basic(self) -> None:
        if self.base.db_backend not in ("sqlite", "memdb", "mem"):
            raise ValueError(f"unknown db_backend {self.base.db_backend}")
        for name, v in (
            ("timeout_propose", self.consensus.timeout_propose),
            ("timeout_prevote", self.consensus.timeout_prevote),
            ("timeout_precommit", self.consensus.timeout_precommit),
            ("timeout_commit", self.consensus.timeout_commit),
        ):
            if v < 0:
                raise ValueError(f"consensus.{name} can't be negative")
        if self.mempool.size < 0:
            raise ValueError("mempool.size can't be negative")
        if self.mempool.ingress_lanes < 1:
            raise ValueError("mempool.ingress_lanes must be >= 1")
        if self.mempool.ingress_sender_rps < 0:
            raise ValueError("mempool.ingress_sender_rps can't be negative")
        if self.mempool.ingress_queue_max < 1:
            raise ValueError("mempool.ingress_queue_max must be >= 1")


def default_config() -> Config:
    return Config()


def test_config() -> Config:
    """config/config.go TestConfig: tight timeouts for in-process testing."""
    c = Config()
    c.base.proxy_app = "kvstore"
    c.base.db_backend = "memdb"
    c.consensus = ConsensusConfig(
        timeout_propose=0.4,
        timeout_propose_delta=0.002,
        timeout_prevote=0.01,
        timeout_prevote_delta=0.002,
        timeout_precommit=0.01,
        timeout_precommit_delta=0.002,
        timeout_commit=0.01,
        skip_timeout_commit=True,
        peer_gossip_sleep_duration=0.005,
        peer_query_maj23_sleep_duration=0.25,
    )
    c.rpc.laddr = "tcp://127.0.0.1:36657"
    # No p2p listener by default: unit tests wire in-process meshes (or
    # explicitly set an ephemeral tcp://127.0.0.1:0 when they want sockets);
    # a fixed shared port would collide across the multi-node tests.
    c.p2p.laddr = ""
    return c
