"""Node: dependency assembly + lifecycle (node/node.go:137 NewNode, :371
OnStart, node/setup.go:64 DefaultNewNode), the port's copy of
``cometbft_tpu/node/node.py``.

Assembly order mirrors CometBFT's: DBs → state → ABCI conns → handshake
replay → event bus + indexers → mempool/evidence/executor → consensus →
P2P switch + reactors → RPC.

Boot phasing (node/node.go:423-433): when statesync is enabled and the
store is empty, OnStart runs the light-client-verified snapshot restore
first, hands the bootstrapped state to blocksync (SwitchToBlockSync), and
blocksync's caught-up hook starts consensus. Without statesync, blocksync
runs from the store head unless this node is the only validator
(onlyValidatorIsUs, node/node.go:174), in which case consensus starts
immediately.

The node's outer interfaces: an app behind a socket (``tcp://``,
``unix://``) or ``grpc://`` ``base.proxy_app`` (``abci/client``,
``abci/grpc``), a remote signer at ``base.priv_validator_laddr``
(``privval/signer``), the gRPC broadcast API at ``rpc.grpc_laddr``
(``rpc/grpc_server``) and statesync into an empty store
(``statesync/syncer``). ``grpc`` is imported only on its two branches. A
failed statesync falls back to blocksync from genesis, as the JAX package's
node does; the port counts it (``statesync_errors``,
``last_statesync_error``).

Branches that stand on modules not ported yet raise ``NotImplementedError``
naming the module, before anything is opened or started:
``instrumentation.prometheus`` (``libs/metrics``), ``tx_index.indexer =
"psql"`` (``state/sink_sql``) and ``CMTPU_WATCHDOG`` at start
(``libs/deadlock``).

Every thread the node starts, and every thread those start, is in the
node's ``threads`` group (``libs/threads``): ``stop()`` ends with a join of
the group, so no thread of the node outlives it, then waits for the
process's vote window (``crypto/sigbatch``) to answer what it holds.
``threads_left_at_stop`` counts the threads that did not end within
``STOP_JOIN_S``.
"""

from __future__ import annotations

import os
import threading

from cometbft_tpu_torch.abci.client import LocalClientCreator
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.consensus.wal import WAL
from cometbft_tpu_torch.evidence import EvidencePool
from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.libs.db import new_db
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.privval import FilePV
from cometbft_tpu_torch.proxy import AppConns
from cometbft_tpu_torch.rpc.core import Environment, routes
from cometbft_tpu_torch.rpc.jsonrpc.server import JSONRPCServer
from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
from cometbft_tpu_torch.state.txindex import (
    IndexerService,
    KVBlockIndexer,
    KVTxIndexer,
    NullTxIndexer,
)
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc

# How long stop() waits for the node's threads to end.
STOP_JOIN_S = 30.0
# How long the statesync boot looks for a restorable snapshot before it falls
# back to blocksync from genesis (the JAX package's node.py:1087, Go's
# SyncAny with its discovery loop).
STATESYNC_TIMEOUT_S = 600.0


def _not_ported(branch: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{branch} needs {module}, which is not ported to cometbft_tpu_torch yet"
    )


def _refuse_unported(config: Config) -> None:
    """The node's branches that wait for a later slice of the port."""
    if config.instrumentation.prometheus:
        raise _not_ported("instrumentation.prometheus", "libs/metrics")
    if config.tx_index.indexer == "psql":
        raise _not_ported('tx_index.indexer = "psql"', "state/sink_sql")


class Node:
    """node/node.go Node."""

    def __init__(
        self,
        config: Config,
        genesis_doc: GenesisDoc,
        priv_validator,
        client_creator,
        logger=None,
        custom_reactors: dict | None = None,
        transport_factory=None,
        clock=None,
    ):
        _refuse_unported(config)
        self.threads = threads.ThreadGroup("node")
        self.threads_left_at_stop = 0
        # stop() against blocksync's hook: consensus never starts once the
        # node is stopping.
        self._lifecycle = threading.Lock()
        self._stopping = False
        with self.threads.scope():
            self._assemble(
                config, genesis_doc, priv_validator, client_creator, logger,
                custom_reactors, transport_factory, clock,
            )

    def _assemble(
        self, config, genesis_doc, priv_validator, client_creator, logger,
        custom_reactors, transport_factory, clock,
    ) -> None:
        from cometbft_tpu_torch.simnet.clock import MonotonicClock

        self.config = config
        self.genesis_doc = genesis_doc
        self.priv_validator = priv_validator
        self.logger = logger
        # Injected time source, threaded into consensus + p2p + blocksync so
        # a simulated deployment (simnet) controls every timer from one
        # virtual clock. Default: wall clock, behavior unchanged.
        self.clock = clock or MonotonicClock()
        # fn(node_info, node_key, fuzz_config) -> transport duck-typing
        # MultiplexTransport (listen/dial/close). None = real TCP transport;
        # simnet injects SimTransport here.
        self._transport_factory = transport_factory
        # node/node.go CustomReactors option: name -> Reactor, added to the
        # switch after the built-ins (same-name entries replace built-ins in
        # CometBFT; here extra names only — replacement would need the
        # channel table rebuilt).
        self._custom_reactors = custom_reactors or {}

        # Storage (node/node.go:147 initDBs).
        db_dir = config.base.db_path()
        self.block_store = BlockStore(new_db("blockstore", config.base.db_backend, db_dir))
        self.state_store = StateStore(
            new_db("state", config.base.db_backend, db_dir),
            discard_abci_responses=config.storage.discard_abci_responses,
        )

        # State from DB or genesis (node/node.go:156).
        state = self.state_store.load()
        if state is None:
            state = make_genesis_state(genesis_doc)
            self.state_store.save(state)

        # ABCI connections (node/node.go:164).
        self.proxy_app = AppConns(client_creator)
        self.proxy_app.start()

        # Event bus + indexers are created AND started before the handshake
        # (node/node.go:173-182 precede :210 doHandshake) so a block applied
        # during crash-recovery replay is published and indexed.
        self.event_bus = EventBus()
        if config.tx_index.indexer == "kv":
            self.tx_indexer = KVTxIndexer(new_db("tx_index", config.base.db_backend, db_dir))
            self.block_indexer = KVBlockIndexer(
                new_db("block_index", config.base.db_backend, db_dir)
            )
        else:
            self.tx_indexer = NullTxIndexer()
            self.block_indexer = NullTxIndexer()
        self.indexer_service = IndexerService(
            self.tx_indexer, self.block_indexer, self.event_bus
        )
        self.event_bus.start()
        self.indexer_service.start()

        # Handshake: full replay.go height-case analysis so consensus state,
        # block store, and app advance together (node/node.go:210).
        from cometbft_tpu_torch.consensus.replay import Handshaker

        handshaker = Handshaker(
            self.state_store,
            state,
            self.block_store,
            genesis_doc,
            event_bus=self.event_bus,
            logger=logger,
        )
        state = handshaker.handshake(self.proxy_app)

        # Mempool + evidence + executor (node/node.go:230-248).
        self.mempool = CListMempool(config.mempool, self.proxy_app.mempool)
        # QoS ingress: admission pipeline (envelope preverify, lanes,
        # rate limits, shedding) fronting the clist mempool. RPC and the
        # gossip reactor submit through it; consensus/executor keep the
        # raw mempool (reap/update are not admission).
        self.ingress = None
        if getattr(config.mempool, "ingress_enable", True):
            from cometbft_tpu_torch.mempool.ingress import IngressPipeline

            self.ingress = IngressPipeline(config.mempool, self.mempool)
        self.evidence_pool = EvidencePool(
            new_db("evidence", config.base.db_backend, db_dir),
            self.state_store,
            self.block_store,
            logger,
        )
        self.block_executor = BlockExecutor(
            self.state_store,
            self.proxy_app.consensus,
            self.mempool,
            self.evidence_pool,
            self.block_store,
            self.event_bus,
            logger,
        )

        # Metrics (node/node.go:385-387): instrumentation.prometheus waits for
        # libs/metrics (refused above); consensus keeps its no-op Metrics.
        self.metrics_registry = None
        self.metrics_server = None
        cs_metrics = None

        # Consensus (node/node.go:256).
        wal = WAL(config.consensus.wal_path()) if config.base.root_dir else None
        self.consensus_state = ConsensusState(
            config.consensus,
            state,
            self.block_executor,
            self.block_store,
            self.mempool,
            self.evidence_pool,
            self.event_bus,
            wal=wal,
            metrics=cs_metrics,
            clock=self.clock,
        )
        if priv_validator is not None:
            self.consensus_state.set_priv_validator(priv_validator)

        self._boot_height = state.last_block_height
        # The statesync boot (node/node.go:423-433): its syncer while it runs,
        # and the failures it fell back to blocksync from (the JAX package's
        # node swallows them).
        self.syncer = None
        self.statesync_errors = 0
        self.last_statesync_error: BaseException | None = None
        # Boot mode (node/node.go:174 onlyValidatorIsUs + :423 stateSync
        # gating: statesync only ever runs into an empty store).
        self._state_sync = bool(config.statesync.enable) and state.last_block_height == 0
        self._block_sync = (
            config.base.block_sync
            and config.blocksync.enable
            and not _only_validator_is_us(state, priv_validator)
        )

        # P2P switch + reactors (node/node.go:285-345), assembled whenever a
        # p2p listen address is configured; in-process meshes (devnet) leave
        # it empty and wire consensus broadcast directly.
        self.switch = None
        self.p2p_laddr = ""
        if config.p2p.laddr:
            from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
            from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
            from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
            from cometbft_tpu_torch.mempool.reactor import MempoolReactor
            from cometbft_tpu_torch.p2p.key import NodeKey
            from cometbft_tpu_torch.p2p.node_info import NodeInfo
            from cometbft_tpu_torch.p2p.switch import Switch
            from cometbft_tpu_torch.p2p.transport import MultiplexTransport
            from cometbft_tpu_torch.statesync import StatesyncReactor

            if config.base.root_dir:
                self.node_key = NodeKey.load_or_gen(config.base.node_key_path())
            else:
                self.node_key = NodeKey()
            self.node_info = NodeInfo(
                node_id=self.node_key.id,
                network=genesis_doc.chain_id,
                moniker=config.base.moniker,
            )
            fuzz_config = None
            if config.p2p.test_fuzz:
                from cometbft_tpu_torch.p2p.fuzz import FuzzConnConfig

                fuzz_config = FuzzConnConfig(
                    mode=config.p2p.test_fuzz_mode,
                    max_delay=config.p2p.test_fuzz_max_delay,
                    prob_drop_rw=config.p2p.test_fuzz_prob_drop_rw,
                )
            make_transport = self._transport_factory or (
                lambda ni, nk, fz: MultiplexTransport(ni, nk, fz)
            )
            self.switch = Switch(
                self.node_info,
                make_transport(self.node_info, self.node_key, fuzz_config),
                config=config.p2p,
                clock=self.clock,
            )
            self.consensus_reactor = ConsensusReactor(
                self.consensus_state,
                gossip_sleep=config.consensus.peer_gossip_sleep_duration,
                wait_sync=self._block_sync,
            )
            # Gossiped txs enter the same admission path as RPC submissions
            # (preverify + lanes), with the peer id recorded as sender.
            self.mempool_reactor = MempoolReactor(
                config.mempool, self.ingress or self.mempool, clock=self.clock
            )
            self.evidence_reactor = EvidenceReactor(self.evidence_pool)
            self.blocksync_reactor = BlocksyncReactor(
                self.consensus_state.state,
                self.block_executor,
                self.block_store,
                block_sync=self._block_sync and not self._state_sync,
                on_caught_up=self._on_blocksync_caught_up,
                clock=self.clock,
            )
            self.statesync_reactor = StatesyncReactor(
                snapshot_conn=self.proxy_app.snapshot
            )
            self.switch.add_reactor("MEMPOOL", self.mempool_reactor)
            self.switch.add_reactor("EVIDENCE", self.evidence_reactor)
            self.switch.add_reactor("CONSENSUS", self.consensus_reactor)
            self.switch.add_reactor("BLOCKSYNC", self.blocksync_reactor)
            self.switch.add_reactor("STATESYNC", self.statesync_reactor)

            # PEX + address book (node/setup.go createPEXReactorAndAddToSwitch),
            # unless discovery is disabled (config.go PexReactor).
            self.pex_reactor = None
            if config.p2p.pex:
                from cometbft_tpu_torch.p2p.pex import AddrBook, PexReactor

                book_path = (
                    os.path.join(config.base.root_dir, config.p2p.addr_book_file)
                    if config.base.root_dir
                    else ""
                )
                self.addr_book = AddrBook(book_path, strict=config.p2p.addr_book_strict)
                self.addr_book.add_our_address(self.node_key.id)
                self.addr_book.add_private_ids(
                    [i for i in config.p2p.private_peer_ids.split(",") if i]
                )
                self.pex_reactor = PexReactor(
                    self.addr_book,
                    seeds=[s.strip() for s in config.p2p.seeds.split(",") if s.strip()],
                    seed_mode=config.p2p.seed_mode,
                    max_outbound=config.p2p.max_num_outbound_peers,
                )
                self.switch.add_reactor("PEX", self.pex_reactor)

            for name, reactor in self._custom_reactors.items():
                self.switch.add_reactor(name, reactor)

        # RPC (node/node.go:392 startRPC).
        self.rpc_server = None
        self.grpc_server = None
        self._rpc_env = None

        # Light-client gateway (light/gateway.py): built on first
        # light_sync/light_proof RPC, never at boot — the lazy accessor is
        # what the RPC env carries and the metrics gauges deliberately
        # bypass (they read _light_gateway directly, so a scrape never
        # constructs it).
        self._light_gateway = None
        self._light_gateway_lock = threading.Lock()

        # Checkpoint-bundle origin (light/origin.py): same lazy contract —
        # built on the first light_bundle RPC / export, never at boot, and
        # the bundle gauges read _bundle_origin directly.
        self._bundle_origin = None
        self._bundle_origin_lock = threading.Lock()

    def _mmr_state_path(self) -> str:
        """One persisted accumulator state file under the node's db dir,
        shared by the gateway and the bundle origin (identical content at
        any size; writes are atomic replaces)."""
        return os.path.join(self.config.base.db_path(), "light_mmr.state")

    def light_gateway(self):
        """The node's LightGateway over its local stores; None when
        CMTPU_LIGHTGW=0 disables serving."""
        if os.environ.get("CMTPU_LIGHTGW", "1").strip().lower() in (
            "0", "false", "off",
        ):
            return None
        with self._light_gateway_lock:
            if self._light_gateway is None:
                from cometbft_tpu_torch.light.gateway import LightGateway
                from cometbft_tpu_torch.light.provider import BlockStoreProvider

                self._light_gateway = LightGateway(
                    self.genesis_doc.chain_id,
                    BlockStoreProvider(
                        self.genesis_doc.chain_id,
                        self.block_store,
                        self.state_store,
                    ),
                    state_path=self._mmr_state_path(),
                    logger=self.logger,
                )
            return self._light_gateway

    def bundle_origin(self, build: bool = True):
        """The node's BundleOrigin over its local stores; None when
        CMTPU_BUNDLE=0 disables the subsystem.  build=False peeks at the
        already-constructed origin (stats/metrics paths) without ever
        constructing one."""
        from cometbft_tpu_torch.light.origin import bundles_enabled

        if not bundles_enabled():
            return None
        if not build:
            return self._bundle_origin
        with self._bundle_origin_lock:
            if self._bundle_origin is None:
                from cometbft_tpu_torch.light.origin import BundleOrigin
                from cometbft_tpu_torch.light.provider import BlockStoreProvider

                self._bundle_origin = BundleOrigin(
                    self.genesis_doc.chain_id,
                    BlockStoreProvider(
                        self.genesis_doc.chain_id,
                        self.block_store,
                        self.state_store,
                    ),
                    state_path=self._mmr_state_path(),
                    logger=self.logger,
                )
            return self._bundle_origin

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """node/node.go:371 OnStart (event bus/indexer already run from
        __init__, as in NewNode): p2p listen + dial, then the blocksync →
        consensus phase chain."""
        if os.environ.get("CMTPU_WATCHDOG"):
            raise _not_ported("CMTPU_WATCHDOG", "libs/deadlock")
        with self.threads.scope():
            self._start()

    def _start(self) -> None:
        if self.switch is not None:
            host, port = _parse_laddr(self.config.p2p.laddr)
            self.p2p_laddr = self.switch.start(f"{host}:{port}")
            if self.logger:
                self.logger.info(
                    "p2p listening", module="p2p", addr=self.p2p_laddr,
                    node_id=self.node_key.id,
                )
            # Persistent peers ride the switch's backoff redial loop
            # (switch.go reconnectToPeer): peers that aren't up yet — the
            # normal case when a testnet launches in parallel — must not
            # fail OnStart.
            self.switch.add_persistent_peers(
                [a.strip() for a in self.config.p2p.persistent_peers.split(",") if a.strip()]
            )
            self.switch.dial_persistent_peers()

        if self.metrics_server is not None:
            self.metrics_server.start()
        if self.config.rpc.pprof_laddr:
            from cometbft_tpu_torch.libs.pprof import PprofServer

            host, _, port = self.config.rpc.pprof_laddr.split("://")[-1].rpartition(":")
            self.pprof_server = PprofServer(
                host or "127.0.0.1",
                int(port),
                trace_dir=os.path.join(self.config.base.root_dir or ".", "torch-trace"),
            )
            self.pprof_server.start()

        if self._state_sync and self.switch is not None:
            threads.spawn(self._statesync_routine, name="statesync")
        elif self._block_sync and self.switch is not None:
            pass  # blocksync reactor's pool routine runs; caught-up hook
            # starts consensus (_on_blocksync_caught_up)
        else:
            self.consensus_state.start()
        rpc_laddr = self.config.rpc.laddr
        if rpc_laddr:
            host, port = _parse_laddr(rpc_laddr)
            pub = None
            if self.priv_validator is not None:
                pub = self.priv_validator.get_pub_key()
            env = Environment(
                config=self.config,
                state_store=self.state_store,
                block_store=self.block_store,
                consensus_state=self.consensus_state,
                consensus_reactor=getattr(self, "consensus_reactor", None),
                mempool=self.ingress or self.mempool,
                ingress=self.ingress,
                evidence_pool=self.evidence_pool,
                event_bus=self.event_bus,
                genesis_doc=self.genesis_doc,
                priv_validator_pub_key=pub,
                node_info={"moniker": self.config.base.moniker, "network": self.genesis_doc.chain_id},
                tx_indexer=self.tx_indexer,
                block_indexer=self.block_indexer,
                proxy_app_query=self.proxy_app.query,
                p2p_peers=self.switch,
                light_gateway=self.light_gateway,
                bundle_origin=self.bundle_origin,
            )
            self._rpc_env = env
            routes_map = routes(env)
            self.rpc_server = JSONRPCServer(routes_map, host, port)
            self.rpc_server.start()
            if self.config.rpc.grpc_laddr:
                # node/node.go startRPC grpcListener branch: the minimal
                # BroadcastAPI (Ping/BroadcastTx) on its own port.
                from cometbft_tpu_torch.rpc.grpc_server import GrpcBroadcastServer

                self.grpc_server = GrpcBroadcastServer(
                    routes_map, self.config.rpc.grpc_laddr
                )
                self.grpc_server.start()

    def stop(self) -> None:
        from cometbft_tpu_torch.crypto import sigbatch

        with self.threads.scope():
            self._stop()
        self.threads_left_at_stop = len(self.threads.join(STOP_JOIN_S))
        # The process's vote window may still hold this node's last votes.
        sigbatch.drain(STOP_JOIN_S)

    def _stop(self) -> None:
        with self._lifecycle:
            self._stopping = True
            syncer = self.syncer
        if syncer is not None:
            syncer.stop()
        self.consensus_state.stop()
        if self.ingress is not None:
            self.ingress.close()
        if getattr(self, "pprof_server", None) is not None:
            self.pprof_server.stop()
        if self.switch is not None:
            self.switch.stop()
        self.indexer_service.stop()
        self.event_bus.stop()
        if self.rpc_server:
            self.rpc_server.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        # A remote signer's endpoint (Go's OnStop stops a privValidator that
        # is a service).
        close_pv = getattr(self.priv_validator, "close", None)
        if close_pv is not None:
            close_pv()
        # last: RPC handlers reach ABCI through these clients — close them
        # only after no request can arrive
        self.proxy_app.stop()

    @property
    def rpc_port(self) -> int:
        return self.rpc_server.port if self.rpc_server else 0

    # -- boot phases (node/node.go:423-433) -----------------------------------

    def _on_blocksync_caught_up(self, state) -> None:
        """blocksync's SwitchToConsensus hook (blocksync/reactor.go:392). As
        Go's SwitchToConsensus(state, skipWAL) does, once blocksync applied
        blocks the WAL catch-up is skipped: the WAL holds nothing of the
        height consensus starts at (its replay would fail with "cannot replay
        height N", which the JAX package's node prints and goes on); and, as
        Go's reactor does, the consensus reactor leaves its wait for sync."""
        with self._lifecycle:
            if self._stopping:
                return
            if state.last_block_height > self._boot_height:
                self.consensus_state.do_wal_catchup = False
            self.consensus_state.update_to_state(state)
            if self.switch is not None:
                self.consensus_reactor.switch_to_consensus()
            self.consensus_state.start()

    def _make_state_provider(self):
        """node/setup.go-style light StateProvider over the configured RPC
        servers (config.go StateSyncConfig.RPCServers)."""
        from cometbft_tpu_torch.light.provider import HTTPProvider
        from cometbft_tpu_torch.rpc.client import HTTPClient
        from cometbft_tpu_torch.statesync import LightClientStateProvider
        from cometbft_tpu_torch.types import cmttime

        cfg = self.config.statesync
        if not cfg.rpc_servers:
            raise ValueError("statesync.rpc_servers must be set when statesync is enabled")
        providers = [
            HTTPProvider(self.genesis_doc.chain_id, HTTPClient(s))
            for s in cfg.rpc_servers
        ]
        return LightClientStateProvider(
            self.genesis_doc.chain_id,
            providers[0],
            providers[1:],
            trust_height=cfg.trust_height,
            trust_hash=bytes.fromhex(cfg.trust_hash),
            trust_period_ns=int(cfg.trust_period * 10**9),
            consensus_params=self.consensus_state.state.consensus_params,
            now=cmttime.now,
        )

    def _statesync_routine(self) -> None:
        """node/node.go:423-433 startStateSync: snapshot restore verified by
        the light client, store bootstrap, then SwitchToBlockSync — whose
        caught-up hook starts consensus. A failure falls back to blocksync
        from genesis, counted in ``statesync_errors``; a stop ends it."""
        from cometbft_tpu_torch.statesync import Syncer

        cfg = self.config.statesync
        try:
            provider = self._make_state_provider()
            syncer = Syncer(
                self.proxy_app.snapshot,
                self.proxy_app.query,
                provider,
                self.statesync_reactor.request_chunk,
                chunk_timeout=cfg.chunk_request_timeout,
                chunk_fetchers=cfg.chunk_fetchers,
            )
            with self._lifecycle:
                if self._stopping:
                    return
                self.syncer = syncer
            self.statesync_reactor.set_syncer(syncer)
            if self.logger:
                self.logger.info("starting statesync", module="statesync")
            # Go's reactor.Sync asks the peers already connected for their
            # snapshots, and again at each empty discovery round (F9).
            state, commit = syncer.sync_any(
                discovery_time=cfg.discovery_time, timeout=STATESYNC_TIMEOUT_S,
                request_hook=self.statesync_reactor.request_snapshots,
            )
            if self.logger:
                self.logger.info(
                    "snapshot restored; switching to blocksync",
                    module="statesync", height=state.last_block_height,
                )
            self.state_store.bootstrap(state)
            self.block_store.save_seen_commit(state.last_block_height, commit)
            self.blocksync_reactor.switch_to_block_sync(state, self.block_executor)
        except Exception as e:
            # Fall back to blocksync-from-genesis rather than leaving a
            # zombie node (consensus only starts via blocksync's caught-up
            # hook, and the reactor was built with block_sync=False while
            # statesync was armed).
            with self._lifecycle:
                if self._stopping:
                    return
                self.statesync_errors += 1
                self.last_statesync_error = e
            if self.logger:
                self.logger.error(
                    "statesync failed; falling back to blocksync",
                    module="statesync", err=str(e),
                )
            else:
                print(f"statesync failed ({e}); falling back to blocksync")
            self.blocksync_reactor.switch_to_block_sync(
                self.consensus_state.state, self.block_executor
            )


def _only_validator_is_us(state, priv_validator) -> bool:
    """node/node.go:174: a 1-validator net that IS us must not wait for
    blocksync peers before producing blocks."""
    if priv_validator is None:
        return False
    if state.validators.size() != 1:
        return False
    return state.validators.validators[0].address == priv_validator.get_pub_key().address()


def _parse_laddr(laddr: str) -> tuple[str, int]:
    addr = laddr.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def default_new_node(config: Config, logger=None, app=None) -> Node:
    """node/setup.go:64 DefaultNewNode: files from config; the app comes
    from proxy_app — "kvstore"/"noop" in-process, otherwise a socket address
    served by an external ABCI app (proxy/client.go DefaultClientCreator);
    a remote signer when priv_validator_laddr is set (node/node.go:181
    createAndStartPrivValidator SocketVal branch)."""
    if logger is None:
        from cometbft_tpu_torch.libs.log import new_logger

        logger = new_logger(level=config.base.log_level, fmt=config.base.log_format)
    genesis = GenesisDoc.from_file(config.base.genesis_path())
    if config.base.priv_validator_laddr:
        from cometbft_tpu_torch.privval.signer import (
            RetrySignerClient,
            SignerClient,
            SignerListenerEndpoint,
        )

        endpoint = SignerListenerEndpoint(config.base.priv_validator_laddr)
        pv = RetrySignerClient(SignerClient(endpoint, genesis.chain_id))
    else:
        pv = FilePV.load_or_generate(
            config.base.priv_validator_key_path(),
            config.base.priv_validator_state_path(),
        )
    if app is not None:
        creator = LocalClientCreator(app)
    elif config.base.proxy_app == "kvstore":
        creator = LocalClientCreator(
            KVStoreApplication(snapshot_interval=config.base.snapshot_interval)
        )
    elif config.base.proxy_app == "persistent_kvstore":
        from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication

        creator = LocalClientCreator(
            PersistentKVStoreApplication(
                snapshot_interval=config.base.snapshot_interval
            )
        )
    elif config.base.proxy_app == "noop":
        from cometbft_tpu_torch.abci import types as abci_types

        creator = LocalClientCreator(abci_types.Application())
    elif config.base.proxy_app.startswith("grpc://"):
        from cometbft_tpu_torch.abci.grpc import GrpcClientCreator

        creator = GrpcClientCreator(config.base.proxy_app)
    else:
        from cometbft_tpu_torch.abci.client import SocketClientCreator

        creator = SocketClientCreator(config.base.proxy_app)
    try:
        return Node(config, genesis, pv, creator, logger)
    except BaseException:
        close_pv = getattr(pv, "close", None)
        if close_pv is not None:
            close_pv()
        raise
