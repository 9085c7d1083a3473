"""Statesync's syncing side in the port (``statesync/syncer.py``,
``statesync/stateprovider.py`` and the node's statesync boot) held to the
JAX package's, modelled on its ``tests/test_statesync.py``:

- ``Syncer`` over ``LightClientStateProvider`` restores, from the same
  chain, the same ``State`` (its state-store bytes), commit and app as the
  JAX package's;
- a tip snapshot (no header H+2 yet) is retried, not rejected, in both
  packages, and restores once the header exists;
- statesync over TCP: a port node's switch restores from a JAX package
  node's switch, then blocksyncs to the tip's height but one;
- a fresh port node joins a live port network by statesync
  (``statesync.enable``), bootstraps, blocksyncs and follows by consensus;
- a failed statesync falls back to blocksync from genesis, with
  ``statesync_errors == 1``.

Every wait is on an event or a height with a liveness guard, never a
wall-clock speed bound; every node and switch is stopped."""

import hashlib
import os
import threading
import types

import pytest

import cometbft_tpu.abci.types as ref_abci
import cometbft_tpu_torch.abci.types as abci
import torch_nodes as tn
from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
from cometbft_tpu.blocksync.reactor import BlocksyncReactor as RefBlocksync
from cometbft_tpu.config import test_config as ref_test_config
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.light.provider import MockProvider as RefMockProvider
from cometbft_tpu.mempool import CListMempool as RefMempool
from cometbft_tpu.p2p.key import NodeKey as RefNodeKey
from cometbft_tpu.p2p.node_info import NodeInfo as RefNodeInfo
from cometbft_tpu.p2p.switch import Switch as RefSwitch
from cometbft_tpu.p2p.transport import MultiplexTransport as RefTransport
from cometbft_tpu.proxy import AppConns as RefAppConns
from cometbft_tpu.proxy import local_client_creator as ref_creator
from cometbft_tpu.state import BlockExecutor as RefExecutor
from cometbft_tpu.state import StateStore as RefStateStore
from cometbft_tpu.state import make_genesis_state as ref_genesis_state
from cometbft_tpu.state.store import _encode_state as ref_encode_state
from cometbft_tpu.statesync import LightClientStateProvider as RefProvider
from cometbft_tpu.statesync import StatesyncReactor as RefReactor
from cometbft_tpu.statesync import Syncer as RefSyncer
from cometbft_tpu.statesync import messages as ref_m
from cometbft_tpu.store import BlockStore as RefBlockStore
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import Commit as RefCommit
from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
from cometbft_tpu.types import GenesisValidator as RefGenesisValidator
from cometbft_tpu.types import Time as RefTime
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.block import SignedHeader as RefSignedHeader
from cometbft_tpu.types.light_block import LightBlock as RefLightBlock
from cometbft_tpu.types.priv_validator import MockPV as RefMockPV
from cometbft_tpu.types.vote import vote_to_commit_sig as ref_commit_sig
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
from cometbft_tpu_torch.config import test_config as make_test_config
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light.provider import MockProvider
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.node import node as node_mod
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import MultiplexTransport
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
from cometbft_tpu_torch.state.store import _encode_state
from cometbft_tpu_torch.statesync import LightClientStateProvider, StatesyncReactor, Syncer
from cometbft_tpu_torch.statesync import messages as m
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types import BlockID, Commit, Time, Vote
from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE, SignedHeader
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.vote import vote_to_commit_sig

pytestmark = pytest.mark.torch_port

CHAIN_ID = "torch-ssync-join"
N_BLOCKS = 10
NOW_S = 1_700_000_000 + 3_600

PORT = types.SimpleNamespace(
    abci=abci, KV=KVStoreApplication, AppConns=AppConns, creator=local_client_creator, Mempool=CListMempool,
    cfg=make_test_config, StateStore=StateStore, BlockStore=BlockStore, MemDB=MemDB,
    Executor=BlockExecutor, genesis_state=make_genesis_state, BlockID=BlockID, Commit=Commit,
    Vote=Vote, commit_sig=vote_to_commit_sig, SignedHeader=SignedHeader, LightBlock=LightBlock,
    MockProvider=MockProvider, Provider=LightClientStateProvider, Syncer=Syncer, m=m, Time=Time,
    encode_state=_encode_state, Reactor=StatesyncReactor, Blocksync=BlocksyncReactor,
    NodeKey=NodeKey, NodeInfo=NodeInfo, Switch=Switch, Transport=MultiplexTransport)
REF = types.SimpleNamespace(
    abci=ref_abci, KV=RefKV, AppConns=RefAppConns, creator=ref_creator, Mempool=RefMempool, cfg=ref_test_config,
    StateStore=RefStateStore, BlockStore=RefBlockStore, MemDB=RefMemDB, Executor=RefExecutor,
    genesis_state=ref_genesis_state, BlockID=RefBlockID, Commit=RefCommit, Vote=RefVote,
    commit_sig=ref_commit_sig, SignedHeader=RefSignedHeader, LightBlock=RefLightBlock,
    MockProvider=RefMockProvider, Provider=RefProvider, Syncer=RefSyncer, m=ref_m, Time=RefTime,
    encode_state=ref_encode_state, Reactor=RefReactor, Blocksync=RefBlocksync,
    NodeKey=RefNodeKey, NodeInfo=RefNodeInfo, Switch=RefSwitch, Transport=RefTransport)


@pytest.fixture(autouse=True)
def cpu_backends():
    port, ref = tn.PKGS["port"].backend, tn.PKGS["reference"].backend
    old = (port._backend, ref._backend)
    port.set_backend(port.CpuBackend())
    ref.set_backend(ref.CpuBackend())
    yield
    port._backend, ref._backend = old


def _secret(i: int) -> bytes:
    return hashlib.sha256(b"torch-ssync-join-%d" % i).digest()


def _genesis_json() -> str:
    pubs = [ref_ed.gen_priv_key_from_secret(_secret(i)).pub_key() for i in range(3)]
    gen = RefGenesisDoc(chain_id=CHAIN_ID, genesis_time=RefTime(1_700_000_000, 0), validators=[
        RefGenesisValidator(p.address(), p, 10, f"v{i}") for i, p in enumerate(pubs)])
    gen.validate_and_complete()
    return gen.to_json()


def _chain(p, gen, pvs, snapshot_interval=4, chunk=64):
    """test_statesync.py's _populated_node in package ``p``: N_BLOCKS blocks
    through the executor, two kvstore txs a block, the app snapshotting every
    ``snapshot_interval`` heights in ``chunk``-byte chunks."""
    state = p.genesis_state(gen)
    app = p.KV(snapshot_interval=snapshot_interval, snapshot_chunk_size=chunk)
    conns = p.AppConns(p.creator(app))
    conns.start()
    mempool = p.Mempool(p.cfg().mempool, conns.mempool)
    ss, bs = p.StateStore(p.MemDB()), p.BlockStore(p.MemDB())
    ss.save(state)
    ex = p.Executor(ss, conns.consensus, mempool, None, bs)
    by_addr = {pv.address(): pv for pv in pvs}
    last = p.Commit(height=0, round=0)
    for h in range(1, N_BLOCKS + 1):
        mempool.check_tx(b"key%d=val%d" % (h, h))
        mempool.check_tx(b"other%d=%d" % (h, h * h))
        block = ex.create_proposal_block(h, state, last, state.validators.get_proposer().address)
        parts = block.make_part_set()
        bid = p.BlockID(block.hash(), parts.header())
        sigs = [p.commit_sig(by_addr[v.address].sign_vote(CHAIN_ID, p.Vote(
            type=PRECOMMIT_TYPE, height=h, round=0, block_id=bid,
            timestamp=block.header.time.add_nanos(10**9 * (i + 1)),
            validator_address=v.address, validator_index=i)))
            for i, v in enumerate(state.validators.validators)]
        last = p.Commit(height=h, round=0, block_id=bid, signatures=sigs)
        bs.save_block(block, parts, last)
        state, _ = ex.apply_block(state, bid, block)
    lbs = {h: p.LightBlock(signed_header=p.SignedHeader(bs.load_block_meta(h).header,
                                                         bs.load_seen_commit(h)),
                           validator_set=ss.load_validators(h)) for h in range(1, N_BLOCKS + 1)}
    return types.SimpleNamespace(state=state, conns=conns, app=app, ss=ss, bs=bs, lbs=lbs)


@pytest.fixture(scope="module")
def chains():
    """The same chain built by each package's own executor."""
    from cometbft_tpu.sidecar import backend as ref_be
    from cometbft_tpu_torch.sidecar import backend as be

    old = (be._backend, ref_be._backend)
    be.set_backend(be.CpuBackend())
    ref_be.set_backend(ref_be.CpuBackend())
    try:
        gen_json = _genesis_json()
        ref = _chain(REF, RefGenesisDoc.from_json(gen_json),
                     [RefMockPV(ref_ed.gen_priv_key_from_secret(_secret(i))) for i in range(3)])
        port = _chain(PORT, GenesisDoc.from_json(gen_json),
                      [MockPV(ed25519.gen_priv_key_from_secret(_secret(i))) for i in range(3)])
    finally:
        be._backend, ref_be._backend = old
    assert port.state.app_hash == ref.state.app_hash
    return {"port": port, "reference": ref, "gen_json": gen_json}


class Served:
    """A syncer's request_chunk answered at once from a source app of
    package ``p`` (no p2p), counting the requests."""

    def __init__(self, p, src):
        self.p, self.src, self.syncer, self.asked = p, src, None, []

    def __call__(self, peer_id, height, fmt, index):
        self.asked.append(index)
        res = self.src.conns.snapshot.load_snapshot_chunk(
            self.p.abci.RequestLoadSnapshotChunk(height=height, format=fmt, chunk=index))
        self.syncer.add_chunk(height, fmt, index, res.chunk)


class Gated:
    """A MockProvider that has no light block above ``top`` until released
    (a tip snapshot's header H+2 not made yet), counting refusals."""

    def __init__(self, p, lbs, top):
        self.inner, self.top, self.refused = p.MockProvider(CHAIN_ID, lbs), top, 0
        self.released = threading.Event()

    def chain_id(self):
        return CHAIN_ID

    def light_block(self, height):
        if height > self.top and not self.released.is_set():
            self.refused += 1
            raise LookupError(f"no light block at {height} yet")
        return self.inner.light_block(height)

    def report_evidence(self, ev):
        pass


def _restore(pkg, src, chains, top=None, on_retry=None):
    """Package ``pkg``'s Syncer over its LightClientStateProvider (a
    MockProvider of ``src``'s light blocks, trusting height 1) restores a
    fresh kvstore from ``src``'s newest snapshot. Returns the state, commit,
    app, syncer and the chunks asked for."""
    p = PORT if pkg == "port" else REF
    provider = Gated(p, src.lbs, top if top is not None else N_BLOCKS)
    if top is None:
        provider.released.set()
    sp = p.Provider(CHAIN_ID, provider, [], trust_height=1, trust_hash=src.lbs[1].hash(),
                    consensus_params=src.state.consensus_params, now=lambda: p.Time(NOW_S, 0))
    app = p.KV()
    conns = p.AppConns(p.creator(app))
    conns.start()
    served = Served(p, src)
    syncer = p.Syncer(conns.snapshot, conns.query, sp, served, chunk_timeout=5.0)
    served.syncer = syncer
    snaps = src.conns.snapshot.list_snapshots(p.abci.RequestListSnapshots())
    for s in snaps.snapshots:
        syncer.add_snapshot("peer-a", p.m.SnapshotsResponse(
            height=s.height, format=s.format, chunks=s.chunks, hash=s.hash, metadata=s.metadata))
    if on_retry is not None:
        threading.Thread(target=on_retry, args=(provider,), daemon=True).start()
    state, commit = syncer.sync_any(discovery_time=0.0, timeout=120)
    return types.SimpleNamespace(state=state, commit=commit, app=app, syncer=syncer,
                                 asked=served.asked, provider=provider, conns=conns)


def test_syncer_restores_the_reference_state(chains):
    got = {pkg: _restore(pkg, chains[pkg], chains) for pkg in ("port", "reference")}
    port, ref = got["port"], got["reference"]
    assert port.state.last_block_height == ref.state.last_block_height == 8
    assert _encode_state(port.state) == ref_encode_state(ref.state)
    assert port.commit.encode() == ref.commit.encode()
    # The reference's restored State, carried across by its store bytes.
    carried = convert.state_from_store_bytes(ref_encode_state(ref.state))
    assert convert.state_to_store_bytes(carried) == _encode_state(port.state)
    assert (port.app.height, port.app.app_hash) == (ref.app.height, ref.app.app_hash)
    assert port.app.db.get(b"kvPairKey:key5") == b"val5"
    assert port.asked == ref.asked and len(port.asked) > 1
    assert port.syncer.retry_errors == 0
    # The snapshot the source lists, carried across as proto bytes.
    from cometbft_tpu.abci import wire as ref_aw

    snap = chains["reference"].app._snapshots[(8, 1)][0]
    assert convert.snapshot_from_wire(ref_aw._enc_snapshot(snap)) == \
        chains["port"].app._snapshots[(8, 1)][0]


def test_tip_snapshot_is_retried_not_rejected(chains):
    """Snapshot 8 needs header 10 (H+2): withheld at first, as at the tip;
    the syncer keeps the candidate and retries it (syncer.go SyncAny), then
    restores once the header exists. Both packages do the same."""
    out = {}
    for pkg in ("port", "reference"):
        def release(provider):
            tn.wait(lambda: provider.refused >= 2, "the syncer never asked for header 10")
            provider.released.set()

        r = _restore(pkg, chains[pkg], chains, top=9, on_retry=release)
        out[pkg] = (r.state.last_block_height, r.provider.refused >= 2,
                    r.app.height, r.app.app_hash)
        if pkg == "port":
            assert r.syncer.retry_errors >= 2
            assert "no light block at 10 yet" in str(r.syncer.last_retry_error)
    assert out["port"] == out["reference"]
    assert out["port"][:3] == (8, True, 8)


def test_syncer_stop_ends_sync_any_with_abort(chains):
    from cometbft_tpu_torch.statesync import ErrAbort

    src = chains["port"]
    sp = LightClientStateProvider(CHAIN_ID, MockProvider(CHAIN_ID, src.lbs), [],
                                  trust_height=1, trust_hash=src.lbs[1].hash(),
                                  now=lambda: Time(NOW_S, 0))
    conns = AppConns(local_client_creator(KVStoreApplication()))
    conns.start()
    syncer = Syncer(conns.snapshot, conns.query, sp, lambda *a: None)
    threading.Timer(0.2, syncer.stop).start()
    with pytest.raises(ErrAbort, match="statesync stopped"):
        syncer.sync_any(discovery_time=60.0, timeout=600)


def _switch(p, moniker, reactors):
    nk = p.NodeKey()
    ni = p.NodeInfo(node_id=nk.id, network=CHAIN_ID, moniker=moniker)
    sw = p.Switch(ni, p.Transport(ni, nk))
    for name, r in reactors.items():
        sw.add_reactor(name, r)
    return sw, nk


def test_statesync_over_tcp_from_a_reference_node(chains):
    """test_statesync.py's TCP case across the packages: a JAX package
    node's switch serves snapshots and blocks; a port switch's Syncer
    restores height 8 and its BlocksyncReactor then syncs to 9."""
    src = chains["reference"]
    sw_a, nk_a = _switch(REF, "A", {
        "STATESYNC": RefReactor(snapshot_conn=src.conns.snapshot),
        "BLOCKSYNC": RefBlocksync(src.state, None, src.bs, block_sync=False)})
    addr_a = sw_a.start("127.0.0.1:0")
    app_c = KVStoreApplication()
    conns_c = AppConns(local_client_creator(app_c))
    conns_c.start()
    ss_c, bs_c = StateStore(MemDB()), BlockStore(MemDB())
    port_lbs = {h: convert.light_block_from_wire(lb.encode()) for h, lb in src.lbs.items()}
    sp = LightClientStateProvider(CHAIN_ID, MockProvider(CHAIN_ID, port_lbs), [],
                                  trust_height=1, trust_hash=port_lbs[1].hash(),
                                  consensus_params=chains["port"].state.consensus_params,
                                  now=lambda: Time(NOW_S, 0))
    reactor_c = StatesyncReactor()
    syncer = Syncer(conns_c.snapshot, conns_c.query, sp, reactor_c.request_chunk,
                    chunk_timeout=5.0)
    reactor_c.set_syncer(syncer)
    gen = GenesisDoc.from_json(chains["gen_json"])
    ex_c = BlockExecutor(ss_c, conns_c.consensus, CListMempool(make_test_config().mempool,
                                                               conns_c.mempool), None, bs_c)
    bs_reactor = BlocksyncReactor(make_genesis_state(gen), ex_c, bs_c, block_sync=False)
    sw_c, _ = _switch(PORT, "C", {"STATESYNC": reactor_c, "BLOCKSYNC": bs_reactor})
    sw_c.start("127.0.0.1:0")
    try:
        sw_c.dial_peer(f"{nk_a.id}@{addr_a}")
        tn.wait(lambda: sw_c.peers(), "the port switch never connected")
        state, commit = syncer.sync_any(discovery_time=0.5, timeout=120)
        assert state.last_block_height == 8 and commit.height == 8
        assert _encode_state(state) == _encode_state(_restore("port", chains["port"], chains).state)
        assert app_c.height == 8 and app_c.db.get(b"kvPairKey:key5") == b"val5"
        ss_c.bootstrap(state)
        bs_c.save_seen_commit(8, commit)
        for peer in sw_c.peers():
            bs_reactor.pool.set_peer_range(peer.id, 1, N_BLOCKS)
        bs_reactor.switch_to_block_sync(state)
        tn.wait(lambda: app_c.height == 9, f"blocksync stuck at {app_c.height}")
        assert app_c.db.get(b"kvPairKey:key9") == b"val9"
        tn.wait(bs_reactor.pool.is_caught_up, "the pool never caught up")
        bs_reactor.stop()
    finally:
        sw_c.stop()
        sw_a.stop()


# -- nodes ---------------------------------------------------------------------------


def _live_home(tmp_path, name, gen_json, secret=None, **fields):
    p = tn.PKGS["port"]
    key = None
    if secret is not None:
        os.makedirs(tmp_path / "keys", exist_ok=True)
        key = tn.pv_key_json(p, secret, str(tmp_path / "keys" / f"{name}.json"))
    cfg = tn.node_config(p, **fields)
    cfg.consensus.peer_gossip_sleep_duration = 0.02
    # A paced chain, as the JAX package's test has it: the joiner restores,
    # blocksyncs and joins while the tip moves.
    cfg.consensus.timeout_commit = 0.25
    cfg.consensus.skip_timeout_commit = False
    return tn.write_home(p, str(tmp_path / name), cfg, gen_json, pv_key_json=key)


@pytest.fixture(scope="module")
def live_net(tmp_path_factory):
    """One port validator (snapshots every 2 heights in 256-byte chunks, RPC
    on) whose genesis is at the wall clock, so that the default trusting
    period holds; it makes blocks from the start."""
    from cometbft_tpu.types import GenesisDoc as G
    from cometbft_tpu.types import GenesisValidator as GV
    from cometbft_tpu.types import cmttime as ref_cmttime
    from cometbft_tpu_torch.sidecar import backend as be

    old = be._backend
    be.set_backend(be.CpuBackend())
    tmp = tmp_path_factory.mktemp("ssync-net")
    secret = b"torch-ssync-live"
    pub = ref_ed.gen_priv_key_from_secret(secret).pub_key()
    gen = G(chain_id=CHAIN_ID, genesis_time=ref_cmttime.now(),
            validators=[GV(pub.address(), pub, 10, "v0")])
    gen.validate_and_complete()
    home = _live_home(tmp, "v0", gen.to_json(), secret)
    node = tn.load_node(tn.PKGS["port"], home, app=KVStoreApplication(
        snapshot_interval=2, snapshot_chunk_size=256))
    node.start()
    try:
        for i in range(12):
            node.mempool.check_tx(b"live%d=v%d" % (i, i))
        tn.wait(lambda: node.block_store.height() >= 6, "the live net stalled")
        yield types.SimpleNamespace(node=node, gen_json=gen.to_json(), tmp=tmp)
    finally:
        node.stop()
        be._backend = old


def _joiner(net, name, **statesync):
    """A fresh port node with statesync on, the live validator its
    persistent peer; its blocksync handoff sets ``node.handed_off``."""
    fields = {f"statesync__{k}": v for k, v in
              {"enable": True, "discovery_time": 0.5, "chunk_request_timeout": 2.0,
               **statesync}.items()}
    home = _live_home(net.tmp, name, net.gen_json, rpc__laddr="",
                      p2p__persistent_peers=f"{net.node.node_key.id}@{net.node.p2p_laddr}",
                      **fields)
    app = KVStoreApplication()
    node = tn.load_node(tn.PKGS["port"], home, app=app)
    node.handed_off = threading.Event()
    hook = node.blocksync_reactor.on_caught_up

    def on_caught_up(state):
        hook(state)
        node.handed_off.set()

    node.blocksync_reactor.on_caught_up = on_caught_up
    return node, app


def _caught_up(node, tip: int) -> bool:
    """Blocksync handed off to consensus at the tip's height but one or
    later (consensus's own catch-up of the next height can stall in both
    packages, ROADMAP §3)."""
    return node.handed_off.is_set() and node.consensus_state.state.last_block_height >= tip - 1


def test_fresh_node_joins_a_live_net_by_statesync(live_net):
    from cometbft_tpu_torch.light.provider import HTTPProvider
    from cometbft_tpu_torch.rpc.client import HTTPClient

    v0 = live_net.node
    url = f"http://127.0.0.1:{v0.rpc_port}"
    lb1 = HTTPProvider(CHAIN_ID, HTTPClient(url)).light_block(1)
    node, app = _joiner(live_net, "joiner", rpc_servers=(url,), trust_height=1,
                        trust_hash=lb1.hash().hex())
    assert node._state_sync
    restored = []
    orig_bootstrap = node.state_store.bootstrap
    node.state_store.bootstrap = lambda st: restored.append(st) or orig_bootstrap(st)
    tip = v0.block_store.height()
    node.start()
    try:
        tn.wait(lambda: restored, "the joiner never restored a snapshot")
        boot = restored[0].last_block_height
        assert boot >= 2 and boot % 2 == 0
        tn.wait(lambda: _caught_up(node, tip)
                and node.consensus_state.state.last_block_height > boot,
                f"the joiner stuck at {node.consensus_state.state.last_block_height}")
        h = node.block_store.height()
        assert h > boot
        assert node.block_store.load_block(h).hash() == v0.block_store.load_block(h).hash()
        assert node.block_store.load_block(boot) is None  # restored, not replayed
        assert app.height >= node.consensus_state.state.last_block_height
        assert (node.statesync_errors, node.last_statesync_error) == (0, None)
        assert node.consensus_state.wal_catchup_errors == 0  # F7 on the statesync path
    finally:
        node.stop()
    assert node.threads_left_at_stop == 0


def test_failed_statesync_falls_back_to_blocksync(live_net):
    """Nothing listens at the RPC server: the state provider cannot be
    made, the boot counts the failure and blocksyncs from genesis, and the
    node reaches and follows the tip."""
    v0 = live_net.node
    node, app = _joiner(live_net, "fallback", rpc_servers=("http://127.0.0.1:1",),
                        trust_height=1, trust_hash="00" * 32)
    tip = v0.block_store.height()
    node.start()
    try:
        tn.wait(lambda: _caught_up(node, tip),
                f"the fallback node stuck at {node.consensus_state.state.last_block_height}")
        assert node.statesync_errors == 1
        assert "Connection refused" in str(node.last_statesync_error)
        assert node.block_store.load_block(1) is not None  # blocksynced from genesis
        assert app.height >= tip - 1
    finally:
        node.stop()
    assert node.threads_left_at_stop == 0


def test_stop_while_statesync_waits_ends_its_thread(live_net):
    """A joiner stopped during discovery: the syncer ends, no fallback is
    counted, and no thread of the node is left."""
    url = f"http://127.0.0.1:{live_net.node.rpc_port}"
    from cometbft_tpu_torch.light.provider import HTTPProvider
    from cometbft_tpu_torch.rpc.client import HTTPClient

    lb1 = HTTPProvider(CHAIN_ID, HTTPClient(url)).light_block(1)
    node, _ = _joiner(live_net, "stopped", rpc_servers=(url,), trust_height=1,
                      trust_hash=lb1.hash().hex(), discovery_time=600.0)
    node.start()
    tn.wait(lambda: node.syncer is not None, "the statesync routine never made its syncer")
    node.stop()
    assert node.threads_left_at_stop == 0, [t.name for t in node.threads.threads()]
    assert node.statesync_errors == 0


def test_a_peer_connected_before_the_syncer_is_asked_for_snapshots(live_net, monkeypatch):
    """F9: the snapshot peer is connected before the statesync routine
    attaches its syncer (here the state provider is built only once the
    peer is up, as a 10,240-validator provider's first light block takes
    long enough for). The JAX package's reactor asks a peer for snapshots
    only as it is added, so such a node never hears of one and falls back
    after its deadline; the port's syncer asks the connected peers at the
    start, as Go's does, and restores."""
    from cometbft_tpu_torch.light.provider import HTTPProvider
    from cometbft_tpu_torch.rpc.client import HTTPClient

    url = f"http://127.0.0.1:{live_net.node.rpc_port}"
    lb1 = HTTPProvider(CHAIN_ID, HTTPClient(url)).light_block(1)
    node, app = _joiner(live_net, "late-syncer", rpc_servers=(url,), trust_height=1,
                        trust_hash=lb1.hash().hex())
    monkeypatch.setattr(node_mod, "STATESYNC_TIMEOUT_S", 60.0)
    make_provider = node._make_state_provider

    def after_the_peer():
        tn.wait(lambda: node.switch.peers(), "the snapshot peer never connected")
        return make_provider()

    node._make_state_provider = after_the_peer
    restored = []
    orig_bootstrap = node.state_store.bootstrap
    node.state_store.bootstrap = lambda st: restored.append(st) or orig_bootstrap(st)
    node.start()
    try:
        tn.wait(lambda: restored or node.statesync_errors,
                "the joiner neither restored nor gave up")
        assert restored and node.statesync_errors == 0, node.last_statesync_error
        assert app.height >= restored[0].last_block_height >= 2
    finally:
        node.stop()
    assert node.threads_left_at_stop == 0
