"""The node in the port (``cometbft_tpu_torch/node``), held to the JAX
package's ``Node``. Modelled on the package's ``tests/test_node_rpc.py``,
``test_validator_updates.py`` and ``test_restart_under_load.py``:

- a mixed network: a reference node and a port node are the two validators
  of one chain over TCP, fed transactions through both RPC servers, and
  agree on every block hash and app hash to height 5; the port node's
  routes answer with the reference's JSON;
- a node stopped and rebuilt from its home resumes at its height (WAL,
  Handshaker), in either package;
- a validator promoted, then demoted, on port nodes;
- a fresh node catching up over TCP from a node whose stores hold a
  reference-built chain, in either package: blocksync to the chain's last
  height but one, then consensus;
- each branch that waited for a later slice (Prometheus, the psql sink,
  the watchdog) and each branch ported since builds what the JAX package's
  node builds;
- ``stop()`` leaves no thread of the node alive.

Nodes listen on 127.0.0.1:0 and every wait is a liveness guard, never a
time bound. Homes are written by each package's own functions
(``tests/torch_nodes.py``)."""

import base64
import os
import threading

import pytest

import torch_nodes as tn
from torch_chains import build_ref_chain
from cometbft_tpu_torch.rpc.client import HTTPClient

pytestmark = pytest.mark.torch_port

CHAIN_ID = "torch-node-chain"


@pytest.fixture(autouse=True)
def cpu_backends():
    """Both packages' process backends on their cpu anchors (the port's
    ``TorchBackend(device="cpu")`` takes ~1 s a call, which times a live
    network's rounds out)."""
    port, ref = tn.PKGS["port"].backend, tn.PKGS["reference"].backend
    old = (port._backend, ref._backend)
    port.set_backend(port.CpuBackend())
    ref.set_backend(ref.CpuBackend())
    yield
    port._backend, ref._backend = old


def _genesis(pubs, chain_id=CHAIN_ID, power=10) -> str:
    """The reference's genesis JSON over the given (address, pub key) pairs."""
    from cometbft_tpu.types import GenesisDoc, GenesisValidator, Time

    gen = GenesisDoc(chain_id=chain_id, genesis_time=Time(1_700_000_000, 0), validators=[
        GenesisValidator(addr, pub, power, f"v{i}") for i, (addr, pub) in enumerate(pubs)])
    gen.validate_and_complete()
    return gen.to_json()


def _ref_pub(secret: bytes):
    from cometbft_tpu.crypto import ed25519 as ref_ed

    pub = ref_ed.gen_priv_key_from_secret(secret).pub_key()
    return pub.address(), pub


def _home(p, tmp_path, name, gen_json, secret=None, **fields):
    home = str(tmp_path / name)
    key = None
    if secret is not None:
        os.makedirs(tmp_path / "keys", exist_ok=True)
        key = tn.pv_key_json(p, secret, str(tmp_path / "keys" / f"{name}.json"))
    tn.write_home(p, home, tn.node_config(p, **fields), gen_json, pv_key_json=key)
    return home


# -- a mixed network ------------------------------------------------------------


@pytest.fixture
def mixed(tmp_path):
    """One reference node and one port node, the chain's two validators of
    equal power (a block needs both), PEX on, dialled over TCP."""
    secrets = [b"torch-node-ref", b"torch-node-port"]
    gen_json = _genesis([_ref_pub(s) for s in secrets])
    ref = tn.load_node(tn.PKGS["reference"], _home(tn.PKGS["reference"], tmp_path, "ref",
                                                   gen_json, secrets[0]))
    port = tn.load_node(tn.PKGS["port"], _home(tn.PKGS["port"], tmp_path, "port", gen_json,
                                               secrets[1]))
    try:
        ref.start()
        port.start()
        port.switch.dial_peer(f"{ref.node_key.id}@{ref.p2p_laddr}")
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def test_mixed_network_agrees_to_height_5(mixed):
    ref, port = mixed
    clients = [HTTPClient(f"http://127.0.0.1:{n.rpc_port}", timeout=60) for n in mixed]
    txs = [b"mixed-%d-%d=value-%d" % (i, j, j) for i in range(2) for j in range(6)]
    for k, tx in enumerate(txs):
        res = clients[k % 2].broadcast_tx_sync(tx)
        assert res["code"] == 0, res
    tn.wait(lambda: min(ref.block_store.height(), port.block_store.height()) >= 6,
            f"the mixed network stalled at {ref.block_store.height()} / "
            f"{port.block_store.height()}")
    committed = []
    for h in range(1, 6):
        rb, pb = ref.block_store.load_block(h), port.block_store.load_block(h)
        assert pb.hash() == rb.hash(), f"height {h}: block hashes differ"
        assert pb.header.app_hash == rb.header.app_hash
        assert port.block_store.load_block(h + 1).header.app_hash == \
            ref.block_store.load_block(h + 1).header.app_hash
        committed += [bytes(tx) for tx in pb.data.txs]
    assert port.consensus_state.prebatch_errors == port.consensus_state.consensus_failures == 0
    assert port.ingress.stats()["preverify_fallbacks"] == 0
    seen = set(committed)
    for h in range(6, port.block_store.height() + 1):
        seen.update(bytes(tx) for tx in port.block_store.load_block(h).data.txs)
    assert set(txs) <= seen


def _shape(v):
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(x) for x in v[:1]]
    return type(v).__name__


def test_routes_answer_with_the_reference_json(mixed):
    """Over the same chain, the port node's routes answer as the reference
    node's: equal JSON where the answer is the chain's (blocks, commits,
    validators, results, the genesis), the same JSON shape where it is the
    node's own (status, net_info, the ingress stats, the consensus
    state)."""
    ref, port = mixed
    rc, pc = (HTTPClient(f"http://127.0.0.1:{n.rpc_port}", timeout=60) for n in mixed)
    rc.broadcast_tx_sync(b"routes=1")
    tn.wait(lambda: min(ref.block_store.height(), port.block_store.height()) >= 4,
            "the mixed network made no height 4")
    for method, params in (("block", {"height": 2}), ("commit", {"height": 2}),
                           ("header", {"height": 3}), ("validators", {"height": 2}),
                           ("block_results", {"height": 2}), ("consensus_params", {"height": 2}),
                           ("blockchain", {"minHeight": 1, "maxHeight": 3}), ("genesis", {}),
                           ("health", {}), ("abci_query", {"path": "", "data": b"routes".hex()})):
        got, want = pc.call(method, **params), rc.call(method, **params)
        if method == "abci_query":  # each node's latest height
            got["response"].pop("height"), want["response"].pop("height")
        if method == "blockchain":  # each store's height
            assert int(got.pop("last_height")) >= 3 and int(want.pop("last_height")) >= 3
        assert got == want, method
    for method in ("status", "net_info", "abci_info", "num_unconfirmed_txs", "consensus_state",
                   "ingress_stats"):
        got, want = pc.call(method), rc.call(method)
        if method == "ingress_stats":  # the port's counted exceptions, all 0
            assert all(got.pop(k) == 0 for k in
                       ("preverify_fallbacks", "dispatcher_errors", "callback_errors"))
        assert _shape(got) == _shape(want), method


# -- restart from the home --------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_node_rebuilt_from_its_home_resumes_at_its_height(tmp_path, pkg):
    """A one-validator node on a sqlite home makes a few heights, stops, and
    is built again from the same home (config.toml, the FilePV and its
    state, the WAL, the stores): the Handshaker levels the app, and the
    chain goes on from where it stopped with the same app hash."""
    p = tn.PKGS[pkg]
    secret = b"torch-node-restart"
    gen_json = _genesis([_ref_pub(secret)])
    home = _home(p, tmp_path, "home", gen_json, secret, base__db_backend="sqlite",
                 base__proxy_app="persistent_kvstore", rpc__laddr="")
    n = tn.load_node(p, home)
    n.start()
    try:
        for i in range(5):
            n.mempool.check_tx(b"restart-%d=%d" % (i, i))
        tn.wait(lambda: n.block_store.height() >= 4, "no height 4 before the restart")
    finally:
        n.stop()
    stopped_at = n.block_store.height()
    app_hash = n.block_store.load_block(stopped_at).header.app_hash
    state_app_hash = n.consensus_state.state.app_hash
    again = tn.load_node(p, home)
    assert again.block_store.height() == stopped_at
    assert again.consensus_state.state.last_block_height == stopped_at
    assert again.consensus_state.state.app_hash == state_app_hash
    again.start()
    try:
        tn.wait(lambda: again.block_store.height() >= stopped_at + 2,
                "the rebuilt node made no new height")
        assert again.block_store.load_block(stopped_at).header.app_hash == app_hash
        nxt = again.block_store.load_block(stopped_at + 1)
        assert nxt.header.last_block_id.hash == again.block_store.load_block(stopped_at).hash()
    finally:
        again.stop()


# -- validator updates -----------------------------------------------------------


def test_promote_then_demote_validator(tmp_path):
    """A running port full node is promoted to validator by a
    ``val:pubkey!power`` tx, signs blocks, and is demoted again (the
    package's own case, on port nodes)."""
    from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication

    secrets = [b"torch-valupd-%d" % i for i in range(4)]
    gen_json = _genesis([_ref_pub(s) for s in secrets[:3]], chain_id="torch-valupd")
    p = tn.PKGS["port"]
    nodes = []
    for i, s in enumerate(secrets):
        home = _home(p, tmp_path, f"n{i}", gen_json, s, p2p__pex=False, rpc__laddr="",
                     consensus__timeout_commit=0.1, consensus__skip_timeout_commit=False)
        nodes.append(tn.load_node(p, home, app=PersistentKVStoreApplication()))
    try:
        for n in nodes:
            n.start()
        for i, n in enumerate(nodes):
            for m in nodes[i + 1:]:
                n.switch.dial_peer(f"{m.node_key.id}@{m.p2p_laddr}")
        cs0 = nodes[0].consensus_state
        tn.wait(lambda: cs0.rs.height >= 2, f"stuck at {cs0.rs.height}")
        assert cs0.state.validators.size() == 3
        pub3 = nodes[3].priv_validator.get_pub_key()
        nodes[0].mempool.check_tx(b"val:" + base64.b64encode(pub3.bytes()) + b"!15")
        tn.wait(lambda: cs0.state.validators.size() == 4, "the validator set never grew")
        _, val3 = cs0.state.validators.get_by_address(pub3.address())
        assert val3 is not None and val3.voting_power == 15
        # Power 45 needs more than 30: the three originals are not enough.
        h_after = cs0.rs.height
        tn.wait(lambda: cs0.rs.height >= h_after + 4, f"stuck at {cs0.rs.height}")
        commit = nodes[0].block_store.load_seen_commit(h_after + 2)
        signers = {sig.validator_address for sig in commit.signatures if sig.for_block_flag()}
        assert pub3.address() in signers, "the promoted validator never signed"
        nodes[1].mempool.check_tx(b"val:" + base64.b64encode(pub3.bytes()) + b"!0")
        tn.wait(lambda: cs0.state.validators.size() == 3, "the validator set never shrank")
        h_after = cs0.rs.height
        tn.wait(lambda: cs0.rs.height >= h_after + 2, f"stuck at {cs0.rs.height}")
    finally:
        for n in nodes:
            n.stop()


# -- catch-up over TCP ----------------------------------------------------------


@pytest.fixture(scope="module")
def catchup_chain():
    from cometbft_tpu.sidecar import backend as ref_be

    old = ref_be._backend
    ref_be.set_backend(ref_be.CpuBackend())
    try:
        return build_ref_chain(b"torch-node-catchup", n_vals=4, n_blocks=6, txs_per_block=5)
    finally:
        ref_be._backend = old


def _catch_up(p, chain, tmp_path):
    """The server: a non-validator node whose sqlite stores hold the chain,
    PEX on, RPC off; its Handshaker replays the app at build. The follower:
    a fresh node from a home holding only the genesis, the server its
    persistent peer. Returns both, started; the caller stops them."""
    server_home = str(tmp_path / f"{p.name}-server")
    tn.write_home(p, server_home, tn.node_config(
        p, base__db_backend="sqlite", base__proxy_app="persistent_kvstore", rpc__laddr=""),
        chain.gen_json, chain.db_items)
    server = tn.load_node(p, server_home)
    _fast_pex(server)
    server.start()
    follower_home = str(tmp_path / f"{p.name}-follower")
    tn.write_home(p, follower_home, tn.node_config(
        p, base__proxy_app="persistent_kvstore", rpc__laddr="",
        p2p__persistent_peers=f"{server.node_key.id}@{server.p2p_laddr}"), chain.gen_json)
    follower = tn.load_node(p, follower_home)
    _fast_pex(follower)
    follower.start()
    return server, follower


def _fast_pex(node) -> None:
    """Discovery rounds every 0.25 s (30 s by default), as the reference's
    own PEX test sets them: a request lost with a duplicate connection is
    asked again at the next round."""
    node.pex_reactor.ensure_interval = node.pex_reactor.request_interval = 0.25


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_fresh_node_catches_up_over_tcp(catchup_chain, tmp_path, pkg):
    """Blocksync takes the follower to the chain's last height but one (the
    last block has no next block's LastCommit), with the chain's blocks and
    state; then the caught-up hook starts consensus, and the reactor's
    catch-up may commit the last block. In both packages that last step
    can stall: the server's catch-up gossip sends the block's parts before
    the follower has the part set header from the commit's precommits, the
    follower drops them, and the parts stay marked as sent (ROADMAP §3). So
    the gate is the last height but one; each address book holds the other
    node."""
    p = tn.PKGS[pkg]
    chain = catchup_chain
    last = len(chain.blocks)
    server, follower = _catch_up(p, chain, tmp_path)
    try:
        assert server.consensus_state.state.last_block_height == last
        assert server.consensus_state.state.app_hash == chain.states[-1].app_hash
        tn.wait(lambda: follower.block_store.height() >= last - 1
                and follower.consensus_state.state.last_block_height >= last - 1,
                f"the follower stopped at {follower.block_store.height()}")
        tn.wait(lambda: follower.addr_book.has_address(server.node_key.id)
                and server.addr_book.has_address(follower.node_key.id),
                "the address books never held each other")
        reached = follower.consensus_state.state.last_block_height
        for h in range(1, reached + 1):
            assert follower.block_store.load_block(h).hash() == chain.blocks[h - 1].hash()
        assert follower.consensus_state.state.app_hash == chain.states[reached].app_hash
        if pkg == "port":
            assert (follower.blocksync_reactor.sync_errors,
                    follower.blocksync_reactor.prefetch_errors) == (0, 0)
            # F7: no WAL catch-up after blocks were synced, so nothing to fail.
            assert follower.consensus_state.wal_catchup_errors == 0
    finally:
        follower.stop()
        server.stop()


# -- branches that waited for later slices ---------------------------------------


BRANCHES = [
    ("instrumentation.prometheus", {"instrumentation__prometheus": True,
                                    "instrumentation__prometheus_listen_addr": "127.0.0.1:0"},
     "libs/metrics"),
    ('tx_index.indexer = "psql"', {"tx_index__indexer": "psql"}, "state/sink_sql"),
]


@pytest.mark.parametrize("branch,fields,module", BRANCHES,
                         ids=[m.replace("/", "-") for _, _, m in BRANCHES])
def test_unported_branch_raises_and_names_its_module(tmp_path, branch, fields, module):
    """These branches raised until their modules were ported: now the node
    builds on each as the reference's does (a metrics registry and its
    server, or the SQL event sink behind both indexers), with the same
    classes by name, and stops leaving no thread and the sink closed."""
    gen_json = _genesis([_ref_pub(b"torch-node-branch")])
    shapes, nodes = {}, {}
    for name in ("port", "reference"):
        p = tn.PKGS[name]
        nodes[name] = n = tn.load_node(p, _home(p, tmp_path, name, gen_json,
                                                b"torch-node-branch", **fields))
        shapes[name] = (type(n.metrics_registry).__name__, type(n.metrics_server).__name__,
                        type(getattr(n, "event_sink", None)).__name__,
                        type(n.tx_indexer).__name__, type(n.block_indexer).__name__)
    try:
        assert shapes["port"] == shapes["reference"]
        port = nodes["port"]
        if module == "libs/metrics":
            port.start()
            assert port.metrics_server.port > 0 and port.metrics_registry.sample_errors == 0
        else:
            assert port.event_sink is not None and not port.event_sink._closed
    finally:
        for n in nodes.values():
            n.stop()
    assert nodes["port"].threads_left_at_stop == 0
    if module == "state/sink_sql":
        assert nodes["port"].event_sink._closed


# The branches ported since: ``default_new_node`` builds what the JAX
# package's builds (the Node's arguments are taken before it is built).
PORTED = [
    ("statesync.enable", {"statesync__enable": True}),
    ("rpc.grpc_laddr", {"rpc__grpc_laddr": "tcp://127.0.0.1:0"}),
    ("base.priv_validator_laddr", {"base__priv_validator_laddr": "tcp://127.0.0.1:0"}),
    ("proxy_app-socket", {"base__proxy_app": "tcp://127.0.0.1:26658"}),
    ("proxy_app-unix", {"base__proxy_app": "unix:///tmp/none.sock"}),
    ("proxy_app-grpc", {"base__proxy_app": "grpc://127.0.0.1:26658"}),
]


@pytest.mark.parametrize("branch,fields", PORTED, ids=[b for b, _ in PORTED])
def test_ported_branch_builds_what_the_reference_builds(tmp_path, monkeypatch, branch, fields):
    """The priv validator's and the ABCI client creator's classes, by name,
    and their addresses; a remote signer's endpoint is closed again."""
    gen_json = _genesis([_ref_pub(b"torch-node-branch")])
    built = {}
    for name in ("port", "reference"):
        p = tn.PKGS[name]
        home = _home(p, tmp_path, name, gen_json, b"torch-node-branch", **fields)
        monkeypatch.setattr(p.node, "Node", lambda cfg, gen, pv, creator, logger, _n=name: (
            built.__setitem__(_n, (cfg, pv, creator))))
        tn.load_node(p, home)
    shapes = {}
    for name, (cfg, pv, creator) in built.items():
        shapes[name] = (type(pv).__name__, type(getattr(pv, "client", pv)).__name__,
                        type(creator).__name__, getattr(creator, "_addr", None),
                        cfg.statesync.enable, cfg.rpc.grpc_laddr)
        endpoint = getattr(getattr(pv, "client", None), "endpoint", None)
        if endpoint is not None:
            endpoint.close()
    assert shapes["port"] == shapes["reference"]


def test_statesync_node_is_armed_on_an_empty_store(tmp_path):
    p = tn.PKGS["port"]
    home = _home(p, tmp_path, "home", _genesis([_ref_pub(b"torch-node-ss")]),
                 b"torch-node-ss", statesync__enable=True)
    n = tn.load_node(p, home)
    try:
        assert n._state_sync and not n.blocksync_reactor.block_sync_enabled
        assert (n.statesync_errors, n.last_statesync_error, n.syncer) == (0, None, None)
    finally:
        n.stop()
    assert n.threads_left_at_stop == 0


def test_watchdog_branch_raises_at_start(tmp_path, monkeypatch):
    """``CMTPU_WATCHDOG`` raised at ``start()`` until ``libs/deadlock`` was
    ported: now ``start()`` runs the watchdog over the consensus height in
    the node's thread group, and ``stop()`` ends it."""
    p = tn.PKGS["port"]
    home = _home(p, tmp_path, "home", _genesis([_ref_pub(b"torch-node-wd")]), b"torch-node-wd")
    n = tn.load_node(p, home)
    monkeypatch.setenv("CMTPU_WATCHDOG", "5")
    try:
        n.start()
        assert n.watchdog.stall_after == 5.0 and n.watchdog._thread in n.threads.threads()
    finally:
        n.stop()
    assert not n.watchdog._thread.is_alive() and n.threads_left_at_stop == 0


# -- stop ------------------------------------------------------------------------


def test_stop_leaves_no_thread_of_the_node_alive(tmp_path):
    """Two port nodes over TCP (PEX, the ingress, RPC, blocksync and
    consensus all running, a websocket-free RPC call served): every thread
    either node started, held before ``stop()``, has ended after it."""
    secrets = [b"torch-node-stop-0", b"torch-node-stop-1"]
    gen_json = _genesis([_ref_pub(s) for s in secrets])
    p = tn.PKGS["port"]
    before = set(threading.enumerate())
    a = tn.load_node(p, _home(p, tmp_path, "a", gen_json, secrets[0]))
    b = tn.load_node(p, _home(p, tmp_path, "b", gen_json, secrets[1]))
    a.start()
    b.start()
    a.switch.dial_peer(f"{b.node_key.id}@{b.p2p_laddr}")
    HTTPClient(f"http://127.0.0.1:{a.rpc_port}", timeout=60).broadcast_tx_sync(b"stop=1")
    tn.wait(lambda: a.block_store.height() >= 3, "no height 3")
    held = [t for t in threading.enumerate() if t not in before]
    names = {t.name for t in held}
    assert any(t.name == "tx-ingress" for t in held) and any(t.name == "pex-ensure" for t in held)
    assert len(held) >= 20, names
    assert {t for n in (a, b) for t in n.threads.threads()} <= set(held)
    a.stop()
    b.stop()
    alive = [t.name for t in held if t.is_alive()]
    assert alive == []
    assert a.threads_left_at_stop == b.threads_left_at_stop == 0


def test_stop_ends_a_websocket_subscriptions_pump(tmp_path):
    """A websocket subscription's pump is a thread of the node's group, so
    ``stop()`` returns only once it has ended, with the client still
    connected (F14: the pump was outside the group, and could outlive
    ``stop()`` by up to a poll)."""
    from cometbft_tpu_torch.rpc.jsonrpc.ws_client import WSClient

    secret = b"torch-node-ws-pump"
    p = tn.PKGS["port"]
    node = tn.load_node(p, _home(p, tmp_path, "ws", _genesis([_ref_pub(secret)]), secret))
    node.start()
    ws = WSClient(node.rpc_port)
    # Pumps this subscription starts (another test's may be alive in this
    # process).
    before = set(threading.enumerate())

    def new_pumps():
        return [t for t in threading.enumerate() if "pump" in t.name and t not in before]

    try:
        ws.send({"jsonrpc": "2.0", "id": 0, "method": "subscribe",
                 "params": {"query": "tm.event='NewBlock'"}})
        tn.wait(lambda: new_pumps(), "no pump")
        pumps = new_pumps()
        assert set(pumps) <= set(node.threads.threads())
        node.stop()
        assert [t for t in pumps if t.is_alive()] == []
        assert node.threads_left_at_stop == 0
    finally:
        ws.close()


# -- the consensus reactor's wait for sync (F8) and stop against the hook ---------


class _Peer:
    id = "ab" * 20

    def __init__(self):
        self.sent = []
        self._kv = {}

    def send(self, chan_id, msg):
        self.sent.append(chan_id)
        return True

    try_send = send

    def set(self, key, value):
        self._kv[key] = value


def test_reactor_waits_for_sync_as_go_does():
    """While a node blocksyncs, its consensus reactor announces no round
    step to a new peer and hands no consensus data, vote or vote-set bits
    to the state machine; ``switch_to_consensus`` ends the wait. The
    reference's reactor has no such wait (ROADMAP §3, F8)."""
    from cometbft_tpu_torch.consensus import messages as cmsg
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.p2p.reactor import CONSENSUS_STATE_CHANNEL, CONSENSUS_VOTE_CHANNEL
    from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.vote import Vote

    class CS:
        rs = type("RS", (), {"height": 1, "round": 0, "step": 1, "last_commit": None})()

        def __init__(self):
            self.got = []

        def set_broadcast(self, fn):
            pass

        def send_peer_message(self, msg, peer_id=""):
            self.got.append(msg)

    cs = CS()
    reactor = ConsensusReactor(cs, wait_sync=True)
    peer = _Peer()
    reactor.add_peer(peer)
    assert peer.sent == []
    vote = cmsg.encode_consensus_message(cmsg.VoteMessage(Vote(
        type=PRECOMMIT_TYPE, height=1, round=0, validator_address=b"\x01" * 20,
        validator_index=0, signature=b"\x02" * 64)))
    reactor.receive(CONSENSUS_VOTE_CHANNEL, peer, vote)
    assert cs.got == []
    step = cmsg.encode_consensus_message(cmsg.NewRoundStepMessage(
        height=3, round=0, step=1, seconds_since_start_time=0, last_commit_round=0))
    reactor.receive(CONSENSUS_STATE_CHANNEL, peer, step)
    assert reactor.peer_states[peer.id].height == 3  # the peer is still tracked
    reactor.remove_peer(peer, "done")
    reactor.switch_to_consensus()
    other = _Peer()
    reactor.add_peer(other)
    assert other.sent == [CONSENSUS_STATE_CHANNEL]
    reactor.receive(CONSENSUS_VOTE_CHANNEL, other, vote)
    assert len(cs.got) == 1
    reactor.remove_peer(other, "done")


def test_blocksync_hook_after_stop_starts_nothing(tmp_path):
    """A blocksync caught-up hook that lands after ``stop()`` began starts
    no consensus, so no thread outlives the stop."""
    p = tn.PKGS["port"]
    secrets = [b"torch-node-hook-0", b"torch-node-hook-1"]
    gen_json = _genesis([_ref_pub(s) for s in secrets])
    n = tn.load_node(p, _home(p, tmp_path, "n", gen_json, secrets[0]))
    assert n._block_sync and n.consensus_reactor.wait_sync
    n.start()
    n.stop()
    n._on_blocksync_caught_up(n.consensus_state.state)
    assert n.consensus_reactor.wait_sync
    assert n.threads.threads() == [] and n.threads_left_at_stop == 0
