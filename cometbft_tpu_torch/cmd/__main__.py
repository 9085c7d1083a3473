"""`python -m cometbft_tpu_torch.cmd` — the node CLI
(cmd/cometbft/main.go:16-36 command registry), the port's copy of
``cometbft_tpu/cmd/__main__.py``: the same subcommands, options, home
layout and output.

Subcommands: init, start, devnet, testnet, gen-validator, gen-node-key,
show-validator, show-node-id, rollback, reset-state, unsafe-reset-all,
version, inspect, compact-db, reindex-event, replay, replay-console, debug,
loadtime, bundle, light; ``e2e`` raises as not ported (``e2e_runner``).

The verification backend is the process default (``CMTPU_BACKEND``; ``auto``
unless set): ``devnet``, ``start``, ``replay`` and ``loadtime`` run on the
card unless asked for the CPU (``--backend cpu`` or ``CMTPU_BACKEND=cpu``).
The JAX package's ``devnet`` defaults to ``cpu``. ``--backend`` takes
``cpu``, ``torch``, ``hybrid`` and ``auto`` and refuses ``tpu``, naming
``torch``. Where no backend is installed yet, ``devnet``, ``start`` and
``loadtime`` build the process default first (the pre-warm: ``auto``
warms its card tier as it is built, a bare ``torch`` or ``hybrid``
verifies one batch; the kernels are built and launched once); a failure
there exits non-zero with the error, and nothing carries on on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time


BACKEND_CHOICES = ("cpu", "torch", "hybrid", "auto")


def _not_ported(command: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{command} needs {module}, which is not ported to cometbft_tpu_torch yet"
    )


def _select_backend(choice) -> int:
    """Set CMTPU_BACKEND from --backend (None keeps the process default).
    Returns 0, or 2 with the refusal on stderr."""
    if choice is None:
        return 0
    if choice == "tpu":
        print(
            "--backend tpu names the JAX package's TPU tier; the port's device "
            "tier is --backend torch",
            file=sys.stderr,
        )
        return 2
    if choice not in BACKEND_CHOICES:
        print(f"unknown backend {choice!r} (want one of {BACKEND_CHOICES})",
              file=sys.stderr)
        return 2
    os.environ["CMTPU_BACKEND"] = choice
    return 0


def _prewarm() -> int:
    """Build the process default backend, where none is installed, so that
    the kernels are built and launched before a node runs: ``auto`` warms
    its hybrid tier as it is built (``_make_backend``); a bare ``torch`` or
    ``hybrid`` backend verifies one batch of 8, outside any engine, so no
    lane of it reaches the engine's counters. Returns 0, or 1 with the
    error."""
    from cometbft_tpu_torch.sidecar import backend as backend_mod

    if backend_mod._backend is not None:
        return 0
    choice = os.environ.get("CMTPU_BACKEND", "auto").lower()
    if choice not in ("cpu", "grpc"):
        print(f"pre-warming the {choice} backend's verify kernels...")
    try:
        b = backend_mod.get_backend()
        if choice in ("torch", "hybrid"):
            b.batch_verify([b"\x00" * 32] * 8, [b""] * 8, [b"\x00" * 64] * 8)
    except Exception as e:
        print(f"backend {choice!r} failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


def _default_home() -> str:
    # The JAX package's default home: either package's home loads in the
    # other.
    return os.environ.get("CMTHOME", os.path.expanduser("~/.cometbft_tpu"))


def _load_config(home: str):
    """default_config + config.toml (if present) + CMT_* env overrides —
    the reference's viper layering (cmd/cometbft/main.go ParseConfig)."""
    from cometbft_tpu_torch.config import default_config
    from cometbft_tpu_torch.config.toml import apply_env_overrides, load_toml

    cfg = default_config()
    toml_path = os.path.join(home, "config", "config.toml")
    if os.path.exists(toml_path):
        cfg = load_toml(toml_path, cfg)
    cfg.set_root(home)
    return apply_env_overrides(cfg)


def _genesis_pop(pv) -> bytes:
    """Proof of possession for a genesis validator's key: required for
    bn254 (rogue-key defence at registration), empty for everything else."""
    from cometbft_tpu_torch.crypto import bn254

    if pv.priv_key.type() != bn254.KEY_TYPE:
        return b""
    return bn254.prove_possession(pv.priv_key)


def cmd_version(args) -> int:
    """cmd/cometbft/commands/version.go: the CometBFT version targeted. (The
    JAX package's imports a VERSION its version module lacks, and raises.)"""
    from cometbft_tpu_torch.version import CMT_SEM_VER

    print(CMT_SEM_VER)
    return 0


def cmd_init(args) -> int:
    """cmd/cometbft/commands/init.go: genesis + validator key + node key."""
    from cometbft_tpu_torch.config import default_config
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    home = args.home
    cfg = default_config().set_root(home)
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    pv = FilePV.load_or_generate(
        cfg.base.priv_validator_key_path(), cfg.base.priv_validator_state_path()
    )
    genesis_path = cfg.base.genesis_path()
    if not os.path.exists(genesis_path):
        pub = pv.get_pub_key()
        doc = GenesisDoc(
            chain_id=args.chain_id or f"test-chain-{os.urandom(3).hex()}",
            genesis_time=cmttime.now(),
            validators=[
                GenesisValidator(pub.address(), pub, 10, "", _genesis_pop(pv))
            ],
        )
        doc.validate_and_complete()
        doc.save_as(genesis_path)
        print(f"Generated genesis file: {genesis_path}")
    _write_node_key(cfg.base.node_key_path())
    toml_path = os.path.join(home, "config", "config.toml")
    if not os.path.exists(toml_path):
        from cometbft_tpu_torch.config.toml import write_config_file

        write_config_file(toml_path, cfg)
        print(f"Generated config file: {toml_path}")
    print(f"Initialized node in {home}")
    return 0


def _write_node_key(path: str) -> None:
    if os.path.exists(path):
        return
    from cometbft_tpu_torch.crypto import ed25519

    key = ed25519.gen_priv_key()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            {
                "priv_key": {
                    "type": "tendermint/PrivKeyEd25519",
                    "value": base64.b64encode(key.bytes()).decode(),
                }
            },
            f,
        )


def cmd_start(args) -> int:
    """cmd/cometbft/commands/run_node.go: run one node until interrupted."""
    from cometbft_tpu_torch.node import default_new_node

    rc = _select_backend(args.backend) or _prewarm()
    if rc:
        return rc
    cfg = _load_config(args.home)
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    node = default_new_node(cfg)
    node.start()
    print(f"Node started; RPC on {cfg.rpc.laddr}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        node.stop()
        print(_stop_line(node), flush=True)
    return 0


def _stop_line(node) -> str:
    """What ``start`` prints once the node has stopped: the threads left,
    and the operator tier's counts where it runs."""
    parts = [f"Node stopped; threads left {node.threads_left_at_stop}"]
    if node.metrics_registry is not None:
        parts.append(f"metrics sampler errors {node.metrics_registry.sample_errors}")
    wd = getattr(node, "watchdog", None)
    if wd is not None:
        parts.append(f"watchdog stalls {wd.stalls}")
    return "; ".join(parts)


def cmd_devnet(args) -> int:
    """In-process multi-validator devnet — the minimum end-to-end slice
    (SURVEY.md §7): N validators over an in-memory switch, RPC on node 0."""
    # The process default (the card unless asked for the CPU), built and
    # warmed before the nodes start: building the kernels in the middle of a
    # live consensus round would stall block production.
    rc = _select_backend(args.backend)
    if rc:
        return rc
    if getattr(args, "faults", None):
        # Chaos devnet: inject seeded backend faults and let the supervised
        # chain (CMTPU_BACKEND=auto is the only mode that supervises) prove
        # the devnet keeps committing through them.
        from cometbft_tpu_torch.sidecar.chaos import parse_faults

        parse_faults(args.faults)  # fail on a bad spec before boot, not mid-run
        os.environ["CMTPU_BACKEND"] = "auto"
        os.environ["CMTPU_FAULTS"] = args.faults
        os.environ.setdefault("CMTPU_FAULTS_SEED", "0")
        os.environ.setdefault("CMTPU_DEADLINE_MS", "2000")
        print(f"devnet: backend faults armed ({args.faults}), supervised auto chain")
    rc = _prewarm()
    if rc:
        return rc

    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.abci.client import LocalClientCreator
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.crypto.encoding import not_ported
    from cometbft_tpu_torch.privval.file import _BY_KEY_TYPE, _NOT_PORTED, KEY_TYPES

    n = args.validators
    key_types = [
        k.strip() for k in getattr(args, "key_types", "ed25519").split(",")
        if k.strip()
    ]
    for k in key_types:
        if k not in KEY_TYPES:
            print(
                f"unknown key type {k!r} (want one of {KEY_TYPES})",
                file=sys.stderr,
            )
            return 1
        if k in _NOT_PORTED:
            raise not_ported(_NOT_PORTED[k])
    pvs = [
        FilePV(_BY_KEY_TYPE[key_types[i % len(key_types)]].gen_priv_key())
        for i in range(n)
    ]
    doc = GenesisDoc(
        chain_id="devnet",
        genesis_time=cmttime.now(),
        validators=[
            GenesisValidator(
                pv.get_pub_key().address(),
                pv.get_pub_key(),
                10,
                f"v{i}",
                _genesis_pop(pv),
            )
            for i, pv in enumerate(pvs)
        ],
    )
    doc.validate_and_complete()
    nodes = []
    for i, pv in enumerate(pvs):
        cfg = test_config()
        cfg.p2p.laddr = ""  # in-memory broadcast mesh, no sockets
        cfg.base.db_backend = "memdb"
        cfg.consensus.timeout_commit = args.block_interval
        cfg.consensus.skip_timeout_commit = False
        cfg.rpc.laddr = f"tcp://127.0.0.1:{args.rpc_port}" if i == 0 else ""
        node = Node(cfg, doc, pv, LocalClientCreator(KVStoreApplication()))
        nodes.append(node)

    def make_broadcast(src):
        def bcast(msg):
            for j, other in enumerate(nodes):
                if j != src:
                    other.consensus_state.send_peer_message(msg, peer_id=f"node{src}")
        return bcast

    for i, node in enumerate(nodes):
        node.consensus_state.set_broadcast(make_broadcast(i))
    for node in nodes:
        node.start()
    print(f"devnet: {n} validators, RPC http://127.0.0.1:{args.rpc_port}")
    cs0 = nodes[0].consensus_state
    target = args.blocks
    t0 = time.time()
    try:
        last = 0
        while target <= 0 or cs0.rs.height <= target:
            time.sleep(0.2)
            if cs0.rs.height != last:
                last = cs0.rs.height
                print(f"height={last - 1} committed  ({(last - 1) / max(time.time() - t0, 1e-9):.2f} blocks/s)")
            if target > 0 and cs0.rs.height > target:
                break
    except KeyboardInterrupt:
        pass
    for node in nodes:
        node.stop()
    print(f"devnet done at height {cs0.rs.height - 1}")
    from cometbft_tpu_torch.sidecar import backend as _backend_mod

    live = _backend_mod._backend
    if live is not None and hasattr(live, "counters"):
        print(f"backend counters: {live.counters()}")
    return 0


def cmd_light(args) -> int:
    """cmd/cometbft/commands/light.go: run a verifying light-client proxy
    against a full node's RPC."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import HTTPProvider
    from cometbft_tpu_torch.light.proxy import LightProxy
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.rpc.client import HTTPClient

    primary = HTTPProvider(args.chain_id, HTTPClient(args.primary))
    witnesses = [
        HTTPProvider(args.chain_id, HTTPClient(w))
        for w in args.witnesses.split(",")
        if w
    ]
    if args.trusted_height > 0 and args.trusted_hash:
        trust = TrustOptions(
            period_ns=int(args.trust_period * 10**9),
            height=args.trusted_height,
            hash=bytes.fromhex(args.trusted_hash),
        )
    else:
        # Trust-on-first-use bootstrap from the primary's latest header.
        lb = primary.light_block(0)
        trust = TrustOptions(
            period_ns=int(args.trust_period * 10**9), height=lb.height, hash=lb.hash()
        )
        print(f"trusting header {lb.height} ({lb.hash().hex().upper()}) from primary")
    client = Client(
        args.chain_id, trust, primary, witnesses, LightStore(MemDB()),
        skip_verification="sequential" if args.sequential else "skipping",
    )
    host, _, port = args.laddr.split("://")[-1].rpartition(":")
    proxy = LightProxy(client, HTTPClient(args.primary), host or "127.0.0.1", int(port))
    proxy.start()
    print(f"light proxy for {args.chain_id} on http://{host or '127.0.0.1'}:{proxy.port}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        proxy.stop()
    return 0


def cmd_show_validator(args) -> int:
    from cometbft_tpu_torch.privval import FilePV

    cfg = _load_config(args.home)
    pv = FilePV.load(
        cfg.base.priv_validator_key_path(), cfg.base.priv_validator_state_path()
    )
    pub = pv.get_pub_key()
    print(
        json.dumps(
            {"type": "tendermint/PubKeyEd25519", "value": base64.b64encode(pub.bytes()).decode()}
        )
    )
    return 0


def cmd_show_node_id(args) -> int:
    cfg = _load_config(args.home)
    with open(cfg.base.node_key_path()) as f:
        d = json.load(f)
    from cometbft_tpu_torch.crypto import ed25519

    key = ed25519.PrivKey(base64.b64decode(d["priv_key"]["value"]))
    print(key.pub_key().address().hex())
    return 0


def cmd_gen_validator(args) -> int:
    from cometbft_tpu_torch.crypto import ed25519

    key = ed25519.gen_priv_key()
    pub = key.pub_key()
    print(
        json.dumps(
            {
                "address": pub.address().hex().upper(),
                "pub_key": {"type": "tendermint/PubKeyEd25519", "value": base64.b64encode(pub.bytes()).decode()},
                "priv_key": {"type": "tendermint/PrivKeyEd25519", "value": base64.b64encode(key.bytes()).decode()},
            },
            indent=2,
        )
    )
    return 0


def cmd_rollback(args) -> int:
    """cmd rollback (state/rollback.go): undo one height of state."""
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.state.rollback import rollback_state
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store import BlockStore

    cfg = _load_config(args.home)
    state_store = StateStore(new_db("state", cfg.base.db_backend, cfg.base.db_path()))
    block_store = BlockStore(new_db("blockstore", cfg.base.db_backend, cfg.base.db_path()))
    height, app_hash = rollback_state(state_store, block_store)
    print(f"Rolled back state to height {height} and hash {app_hash.hex().upper()}")
    return 0


def cmd_reset_state(args) -> int:
    import shutil

    data = os.path.join(args.home, "data")
    if os.path.isdir(data):
        shutil.rmtree(data)
    os.makedirs(data, exist_ok=True)
    print(f"Removed all blockchain data in {data}")
    return 0


def cmd_gen_node_key(args) -> int:
    """cmd gen_node_key.go: print a fresh node key (and persist if absent)."""
    from cometbft_tpu_torch.p2p.key import NodeKey

    cfg = _load_config(args.home)
    nk = NodeKey.load_or_gen(cfg.base.node_key_path())
    print(nk.id)
    return 0


def cmd_inspect(args) -> int:
    """cmd inspect (inspect/inspect.go): read-only RPC over a stopped node's
    data directory."""
    from cometbft_tpu_torch.inspect import Inspector

    cfg = _load_config(args.home)
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    ins = Inspector(cfg)
    ins.start()
    print(f"inspect RPC on http://127.0.0.1:{ins.port} (read-only)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        ins.stop()
    return 0


def cmd_compact_db(args) -> int:
    """cmd compact_goleveldb.go analog: compact every data-dir database."""
    from cometbft_tpu_torch.libs.db import new_db

    cfg = _load_config(args.home)
    if cfg.base.db_backend == "memdb":
        print("memdb backend: nothing to compact")
        return 0
    for name in ("blockstore", "state", "tx_index", "block_index", "evidence"):
        db = new_db(name, cfg.base.db_backend, cfg.base.db_path())
        db.compact()
        print(f"compacted {name}")
    return 0


def cmd_reindex_event(args) -> int:
    """cmd reindex_event.go: rebuild tx + block indexes from the block store
    and the persisted ABCI responses. A tx's record carries the meta-events
    the event bus adds when the node indexes it live (``tx.hash``,
    ``tx.height``), so the rebuilt index answers the same searches; the JAX
    package's leaves them out (F13)."""
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.state import StateStore
    from cometbft_tpu_torch.state.execution import decode_responses
    from cometbft_tpu_torch.state.txindex import KVBlockIndexer, KVTxIndexer
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.events import _abci_events_to_attrs

    cfg = _load_config(args.home)
    db_dir = cfg.base.db_path()
    block_store = BlockStore(new_db("blockstore", cfg.base.db_backend, db_dir))
    state_store = StateStore(new_db("state", cfg.base.db_backend, db_dir))
    tx_indexer = KVTxIndexer(new_db("tx_index", cfg.base.db_backend, db_dir))
    block_indexer = KVBlockIndexer(new_db("block_index", cfg.base.db_backend, db_dir))
    start = args.start_height or max(block_store.base(), 1)
    end = args.end_height or block_store.height()
    if end < start:
        print(f"nothing to reindex (base {start}, height {end})")
        return 1
    n = 0
    for h in range(start, end + 1):
        block = block_store.load_block(h)
        raw = state_store.load_abci_responses(h)
        if block is None or raw is None:
            continue
        resp = decode_responses(raw)
        begin, end_blk = resp["begin_block"], resp["end_block"]
        block_indexer.index(
            h, _abci_events_to_attrs(list(begin.events) + list(end_blk.events))
        )
        for i, tx in enumerate(block.data.txs):
            res = resp["deliver_txs"][i]
            tx_indexer.index(h, i, tx, res, _tx_event_attrs(h, tx, res))
        n += 1
    print(f"reindexed {n} blocks ({start}..{end})")
    return 0


def _tx_event_attrs(height: int, tx: bytes, res) -> dict:
    """A tx's indexed attributes as ``EventBus.publish_tx`` gives them to
    the indexer service."""
    from cometbft_tpu_torch.types.events import (
        TX_HASH_KEY,
        TX_HEIGHT_KEY,
        _abci_events_to_attrs,
    )
    from cometbft_tpu_torch.types.tx import tx_hash

    attrs = _abci_events_to_attrs(res.events)
    attrs.setdefault(TX_HASH_KEY, []).append(tx_hash(tx).hex().upper())
    attrs.setdefault(TX_HEIGHT_KEY, []).append(str(height))
    return attrs


def cmd_replay(args, console: bool = False) -> int:
    """cmd replay.go / replay_console.go: re-apply the WAL tail for the
    latest height against the app (through the normal handshake machinery),
    optionally stepping message-by-message."""
    from cometbft_tpu_torch.consensus.wal import WAL
    from cometbft_tpu_torch.node import default_new_node

    rc = _select_backend(args.backend)
    if rc:
        return rc
    cfg = _load_config(args.home)
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = ""
    wal_path = cfg.consensus.wal_path()
    if console and os.path.exists(wal_path):
        wal = WAL(wal_path)
        count = 0
        for tm in wal.iter_messages():
            count += 1
            print(f"#{count}: {type(tm.msg).__name__} {tm.msg}")
            try:
                input("> press enter to continue (ctrl-d to finish)...")
            except EOFError:
                break
        wal.stop()
    # The handshake inside Node construction IS the replay (replay.go
    # height-case analysis + WAL catchup).
    node = default_new_node(cfg)
    h = node.block_store.height()
    node.stop()
    print(f"replay done; store height {h}")
    return 0


def cmd_debug(args) -> int:
    """cmd debug kill/dump (cmd/cometbft/commands/debug): collect a node's
    status/net_info/consensus state + config into a debug archive; `kill`
    also terminates the process."""
    import urllib.request
    import zipfile

    def fetch(method):
        url = f"{args.rpc_laddr.replace('tcp://', 'http://')}"
        body = json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": method, "params": {}}
        ).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.read()

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with zipfile.ZipFile(args.output, "w") as z:
        for method in ("status", "net_info", "consensus_state", "dump_consensus_state"):
            try:
                z.writestr(f"{method}.json", fetch(method))
            except Exception as e:
                z.writestr(f"{method}.err", str(e))
        cfg_path = os.path.join(args.home, "config")
        if os.path.isdir(cfg_path):
            for name in os.listdir(cfg_path):
                p = os.path.join(cfg_path, name)
                if os.path.isfile(p) and "priv_validator_key" not in name:
                    z.write(p, f"config/{name}")
    print(f"wrote debug archive {args.output}")
    if args.debug_cmd == "kill":
        pid = int(args.pid)
        if pid <= 0:
            # os.kill(0, ...) would signal OUR OWN process group.
            print("debug kill requires the node's pid", file=sys.stderr)
            return 1
        os.kill(pid, 15)
        print(f"sent SIGTERM to {pid}")
    return 0


def cmd_testnet(args) -> int:
    """cmd/cometbft/commands/testnet.go: generate validator (+ optional
    non-validator) homes with a shared genesis.  --key-types is a comma
    list cycled across nodes (testnet.go's --key-type, generalized so the
    e2e generator can mix consensus key types in one net)."""
    from cometbft_tpu_torch.config import default_config
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.crypto.encoding import not_ported
    from cometbft_tpu_torch.privval.file import _NOT_PORTED, KEY_TYPES
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    n = args.validators
    total = n + getattr(args, "non_validators", 0)
    key_types = [k.strip() for k in args.key_types.split(",") if k.strip()]
    for k in key_types:
        if k not in KEY_TYPES:
            print(f"unknown key type {k!r} (want one of {KEY_TYPES})",
                  file=sys.stderr)
            return 1
        if k in _NOT_PORTED:
            raise not_ported(_NOT_PORTED[k])
    pvs = []
    for i in range(total):
        home = os.path.join(args.output_dir, f"node{i}")
        cfg = default_config().set_root(home)
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pv = FilePV.load_or_generate(
            cfg.base.priv_validator_key_path(),
            cfg.base.priv_validator_state_path(),
            key_type=key_types[i % len(key_types)],
        )
        _write_node_key(cfg.base.node_key_path())
        pvs.append(pv)
    doc = GenesisDoc(
        chain_id=args.chain_id or "testnet",
        genesis_time=cmttime.now(),
        validators=[
            GenesisValidator(
                pv.get_pub_key().address(),
                pv.get_pub_key(),
                1,
                f"node{i}",
                _genesis_pop(pv),
            )
            for i, pv in enumerate(pvs[:n])
        ],
    )
    doc.validate_and_complete()
    for i in range(total):
        doc.save_as(os.path.join(args.output_dir, f"node{i}", "config", "genesis.json"))
    print(f"Successfully initialized {total} node directories in {args.output_dir}")
    return 0


def cmd_loadtime(args) -> int:
    """Load generator + saturation report (reference: test/loadtime +
    test/e2e/runner/benchmark.go): sustained tx load against an in-process
    devnet, mean/σ/min/max block interval and tx latency over the window."""
    from cometbft_tpu_torch.loadtime import run_load

    rc = _select_backend(args.backend) or _prewarm()
    if rc:
        return rc
    rep = run_load(
        n_vals=args.validators,
        rate=args.rate,
        min_blocks=args.blocks,
        connections=args.connections,
        signed=args.signed,
        log=lambda s: print(s, file=sys.stderr),
    )
    print(rep.to_json())
    print(f"loadtime: submitted {rep.submitted}; submit errors {rep.submit_errors}; "
          f"stop errors {rep.stop_errors}"
          + (f"; last submit error {rep.last_submit_error!r}" if rep.submit_errors else ""),
          file=sys.stderr)
    return 0


def cmd_bundle(args) -> int:
    """Checkpoint-bundle origin tooling (light/origin.py): export a
    stopped node's data dir into the flat directory any dumb HTTP cache
    replicates, serve such a directory, or verify one."""
    sub = getattr(args, "bundle_cmd", None)
    if sub == "export":
        from cometbft_tpu_torch.libs.db import new_db
        from cometbft_tpu_torch.light.origin import BundleOrigin
        from cometbft_tpu_torch.light.provider import BlockStoreProvider
        from cometbft_tpu_torch.state.store import StateStore
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types.genesis import GenesisDoc

        cfg = _load_config(args.home)
        doc = GenesisDoc.from_file(cfg.base.genesis_path())
        db_dir = cfg.base.db_path()
        block_store = BlockStore(new_db("blockstore", cfg.base.db_backend, db_dir))
        state_store = StateStore(new_db("state", cfg.base.db_backend, db_dir))
        origin = BundleOrigin(
            doc.chain_id,
            BlockStoreProvider(doc.chain_id, block_store, state_store),
            interval=args.interval or None,
            keep=args.keep or None,
            state_path=os.path.join(db_dir, "light_mmr.state"),
        )
        index = origin.export(args.out)
        print(json.dumps({"out": args.out, **index}, sort_keys=True))
        return 0
    if sub == "serve":
        import functools
        from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

        handler = functools.partial(
            SimpleHTTPRequestHandler, directory=args.dir
        )
        httpd = ThreadingHTTPServer(("127.0.0.1", args.port), handler)
        print(f"serving bundles from {args.dir} on "
              f"http://127.0.0.1:{httpd.server_address[1]}")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            httpd.server_close()
        return 0
    if sub == "verify":
        from cometbft_tpu_torch.light.bundle import (
            Bundle, BundleError, DirBundleSource, check_name,
        )

        src = DirBundleSource(args.dir)
        idx = src._index()
        bad = 0
        for h, name in sorted(
            idx.get("bundles", {}).items(), key=lambda kv: int(kv[0])
        ):
            try:
                with open(os.path.join(args.dir, f"{name}.bundle"), "rb") as f:
                    data = f.read()
                check_name(name, data)
                b = Bundle.decode(data)
                b.self_check(idx.get("chain_id"))
                if b.anchor.height != int(h):
                    raise BundleError(
                        f"indexed height {h} != anchor {b.anchor.height}"
                    )
                print(f"ok   {h:>10} {name[:16]}… {len(data)} bytes")
            except (OSError, BundleError) as e:
                bad += 1
                print(f"BAD  {h:>10} {name[:16]}… {e}")
        return 1 if bad else 0
    print("bundle: expected export | serve | verify", file=sys.stderr)
    return 1


def cmd_e2e(args) -> int:
    """Manifest-driven e2e testnet runs (CometBFT's test/e2e/runner +
    test/e2e/generator): the port's runner is not ported yet."""
    raise _not_ported("e2e", "e2e_runner")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cometbft_tpu_torch")
    p.add_argument("--home", default=_default_home())
    sub = p.add_subparsers(dest="command")

    sub.add_parser("version")
    sp = sub.add_parser("init")
    sp.add_argument("--chain-id", default="")
    sp = sub.add_parser("start")
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="")
    sp.add_argument("--backend", default=None,
                    help="cpu, torch, hybrid or auto (default: CMTPU_BACKEND, else auto)")
    sp = sub.add_parser("devnet")
    sp.add_argument("--validators", type=int, default=4)
    sp.add_argument("--blocks", type=int, default=10)
    sp.add_argument("--rpc-port", type=int, default=26657)
    sp.add_argument("--block-interval", type=float, default=1.0)
    sp.add_argument("--backend", default=None,
                    help="cpu, torch, hybrid or auto (default: CMTPU_BACKEND, else auto)")
    sp.add_argument(
        "--key-types",
        default="ed25519",
        dest="key_types",
        help="comma list of consensus key types cycled across validators "
        "(e.g. ed25519,bn254); with CMTPU_AGG_COMMITS=1 an all-bn254 net "
        "ships aggregate commits",
    )
    sp.add_argument(
        "--faults",
        default=None,
        metavar="SPEC",
        help="chaos devnet: CMTPU_FAULTS spec (latency:p:ms,error:p,wedge:p,"
        "flip:p) injected into the supervised auto backend chain",
    )
    sp = sub.add_parser("light")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True, help="primary node RPC URL")
    sp.add_argument("--witnesses", default="", help="comma-separated witness RPC URLs")
    sp.add_argument("--trusted-height", type=int, default=0)
    sp.add_argument("--trusted-hash", default="")
    sp.add_argument("--trust-period", type=float, default=168 * 3600.0)
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--sequential", action="store_true")
    sub.add_parser("show-validator")
    sub.add_parser("show-node-id")
    sub.add_parser("gen-validator")
    sub.add_parser("rollback")
    sub.add_parser("reset-state")
    sub.add_parser("unsafe-reset-all")
    sub.add_parser("gen-node-key")
    sp = sub.add_parser("inspect")
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="")
    sub.add_parser("compact-db")
    sp = sub.add_parser("reindex-event")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    for name in ("replay", "replay-console"):
        sp = sub.add_parser(name)
        sp.add_argument("--backend", default=None,
                        help="cpu, torch, hybrid or auto (default: CMTPU_BACKEND, else auto)")
    sp = sub.add_parser("debug")
    sp.add_argument("debug_cmd", choices=["kill", "dump"])
    sp.add_argument("pid", nargs="?", default="0")
    sp.add_argument("--output", default="debug.zip")
    sp.add_argument("--rpc-laddr", dest="rpc_laddr", default="tcp://127.0.0.1:26657")
    sp = sub.add_parser("testnet")
    sp.add_argument("--validators", type=int, default=4)
    sp.add_argument("--non-validators", type=int, default=0,
                    help="extra full-node homes not in the genesis valset")
    sp.add_argument("--key-types", default="ed25519",
                    help="comma list of consensus key types, cycled per node")
    sp.add_argument("--output-dir", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp = sub.add_parser("loadtime")
    sp.add_argument("--rate", type=int, default=200, help="target tx/s")
    sp.add_argument("--connections", type=int, default=1)
    sp.add_argument("--blocks", type=int, default=100)
    sp.add_argument("--validators", type=int, default=4)
    sp.add_argument("--signed", action="store_true",
                    help="emit SignedTxEnvelopes through the QoS ingress")
    sp.add_argument("--backend", default=None,
                    help="cpu, torch, hybrid or auto (default: CMTPU_BACKEND, else auto)")
    sp = sub.add_parser("bundle")
    bundle_sub = sp.add_subparsers(dest="bundle_cmd")
    bp = bundle_sub.add_parser(
        "export", help="export checkpoint bundles from a node data dir"
    )
    bp.add_argument("--out", required=True, help="flat output directory")
    bp.add_argument("--interval", type=int, default=0,
                    help="checkpoint interval (default CMTPU_BUNDLE_INTERVAL)")
    bp.add_argument("--keep", type=int, default=0,
                    help="newest checkpoints to export (default CMTPU_BUNDLE_KEEP)")
    bp = bundle_sub.add_parser(
        "serve", help="dumb HTTP file server over an exported directory"
    )
    bp.add_argument("--dir", required=True)
    bp.add_argument("--port", type=int, default=0)
    bp = bundle_sub.add_parser(
        "verify", help="content-address + self-check every indexed bundle"
    )
    bp.add_argument("--dir", required=True)
    sp = sub.add_parser("e2e")
    # Flat flags keep `e2e --manifest m.toml` working; the nested
    # subcommands mirror the reference's runner/generator split.
    sp.add_argument("--manifest", default="", help="TOML testnet manifest")
    sp.add_argument("--output-dir", default="")
    e2e_sub = sp.add_subparsers(dest="e2e_cmd")
    ep = e2e_sub.add_parser("run", help="run one manifest through the runner")
    ep.add_argument("--manifest", required=True, help="TOML testnet manifest")
    ep.add_argument("--output-dir", default="")
    ep = e2e_sub.add_parser(
        "generate", help="emit a seeded randomized testnet manifest"
    )
    ep.add_argument("--seed", type=int, required=True)
    ep.add_argument("--profile", default="full", choices=["full", "small", "sim"])
    ep.add_argument("--out", default="", help="output path (default stdout)")
    ep = e2e_sub.add_parser(
        "matrix", help="generate + run a seed range, collect repro artifacts"
    )
    ep.add_argument("--seeds", required=True,
                    help="seed spec: N, 'A..B' (inclusive) or comma list")
    ep.add_argument("--profile", default="small", choices=["full", "small", "sim"])
    ep.add_argument("--output-dir", default="")

    args = p.parse_args(argv)
    handlers = {
        "version": cmd_version,
        "init": cmd_init,
        "start": cmd_start,
        "devnet": cmd_devnet,
        "light": cmd_light,
        "show-validator": cmd_show_validator,
        "show-node-id": cmd_show_node_id,
        "gen-validator": cmd_gen_validator,
        "rollback": cmd_rollback,
        "reset-state": cmd_reset_state,
        "unsafe-reset-all": cmd_reset_state,
        "testnet": cmd_testnet,
        "gen-node-key": cmd_gen_node_key,
        "inspect": cmd_inspect,
        "compact-db": cmd_compact_db,
        "reindex-event": cmd_reindex_event,
        "replay": cmd_replay,
        "replay-console": lambda a: cmd_replay(a, console=True),
        "debug": cmd_debug,
        "loadtime": cmd_loadtime,
        "bundle": cmd_bundle,
        "e2e": cmd_e2e,
    }
    if args.command is None:
        p.print_help()
        return 1
    return handlers[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
