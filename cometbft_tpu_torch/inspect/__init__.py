"""Inspect: a read-only RPC server over a STOPPED node's data directory
(inspect/inspect.go:29 + rpc/core routes subset), the port's copy of
``cometbft_tpu/inspect/__init__.py`` over the port's routes and stores.

Used for crash forensics: no p2p, no consensus, no app — just the stores
and indexers behind the data RPC endpoints."""

from __future__ import annotations

from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.libs.db import new_db
from cometbft_tpu_torch.rpc.core import Environment, routes
from cometbft_tpu_torch.rpc.jsonrpc.server import JSONRPCServer
from cometbft_tpu_torch.state import StateStore
from cometbft_tpu_torch.state.txindex import KVBlockIndexer, KVTxIndexer, NullTxIndexer
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc

# Routes that only touch storage/indexers (inspect/rpc/rpc.go Routes).
INSPECT_ROUTES = (
    "health",
    "status",
    "genesis",
    "blockchain",
    "block",
    "block_by_hash",
    "block_results",
    "commit",
    "header",
    "header_by_hash",
    "validators",
    "consensus_params",
    "tx",
    "tx_search",
    "block_search",
)


class Inspector:
    """inspect.Inspect: stores + indexers behind a JSONRPC listener."""

    def __init__(self, config: Config):
        self.config = config
        db_dir = config.base.db_path()
        self.block_store = BlockStore(new_db("blockstore", config.base.db_backend, db_dir))
        self.state_store = StateStore(new_db("state", config.base.db_backend, db_dir))
        if config.tx_index.indexer == "kv":
            tx_indexer = KVTxIndexer(new_db("tx_index", config.base.db_backend, db_dir))
            block_indexer = KVBlockIndexer(
                new_db("block_index", config.base.db_backend, db_dir)
            )
        else:
            tx_indexer = NullTxIndexer()
            block_indexer = NullTxIndexer()
        genesis = GenesisDoc.from_file(config.base.genesis_path())
        env = Environment(
            config=config,
            state_store=self.state_store,
            block_store=self.block_store,
            consensus_state=None,
            mempool=None,
            evidence_pool=None,
            event_bus=EventBus(),
            genesis_doc=genesis,
            priv_validator_pub_key=None,
            node_info={"moniker": config.base.moniker, "network": genesis.chain_id},
            tx_indexer=tx_indexer,
            block_indexer=block_indexer,
            proxy_app_query=None,
        )
        all_routes = routes(env)
        self._routes = {k: v for k, v in all_routes.items() if k in INSPECT_ROUTES}
        host, _, port = config.rpc.laddr.split("://")[-1].rpartition(":")
        self.server = JSONRPCServer(self._routes, host or "127.0.0.1", int(port))

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    @property
    def port(self) -> int:
        return self.server.port
