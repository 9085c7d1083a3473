"""The RPC tier in the port (``rpc/jsonrpc/server``, ``rpc/core``,
``rpc/client``) against the JAX package. One small chain (4 validators, 5
heights, a ``val:`` promotion) is served by both packages from the same
stores (the reference's DB items carried across), the same indexes (rebuilt
from the stored ABCI responses) and an app brought level by each package's
Handshaker. Every route of the table is called through ``LocalClient`` and
through ``HTTPClient`` on 127.0.0.1:0, in the same order on both sides, and
each answer (JSON, or RPC error code, message and data) equals the
reference's. Then: a websocket subscription on each server; the port's
client against the reference's server and the reference's client against
the port's; the port's light client over HTTP, whose trace equals the one
over ``BlockStoreProvider``; and a one-validator chain of the port served
over HTTP (``broadcast_tx_*``, a websocket on ``NewBlock``, proven ``tx``
and ``abci_query`` answers). No tolerance, no wall-clock bound."""

import base64
import hashlib
import http.client
import json
import threading
import urllib.error
from types import SimpleNamespace

import pytest
import torch_chains as tc

import cometbft_tpu.abci.example.kvstore as ref_kvstore
import cometbft_tpu.config as ref_config
import cometbft_tpu.consensus.replay as ref_replay
import cometbft_tpu.consensus.state as ref_cs
import cometbft_tpu.crypto.ed25519 as ref_ed
import cometbft_tpu.evidence.pool as ref_evpool
import cometbft_tpu.libs.db as ref_db
import cometbft_tpu.light.gateway as ref_gateway
import cometbft_tpu.light.provider as ref_provider
import cometbft_tpu.mempool as ref_mempool
import cometbft_tpu.proxy as ref_proxy
import cometbft_tpu.rpc.client as ref_client
import cometbft_tpu.rpc.core as ref_core
import cometbft_tpu.rpc.jsonrpc.server as ref_server
import cometbft_tpu.sidecar.backend as ref_backend
import cometbft_tpu.state as ref_state
import cometbft_tpu.state.execution as ref_execution
import cometbft_tpu.state.txindex as ref_txindex
import cometbft_tpu.store as ref_store
import cometbft_tpu.types as ref_types
import cometbft_tpu.types.cmttime as ref_cmttime
import cometbft_tpu.types.events as ref_events
import cometbft_tpu.types.evidence as ref_evidence
import cometbft_tpu.types.genesis as ref_genesis
import cometbft_tpu_torch.abci.example.kvstore as kvstore
import cometbft_tpu_torch.config as config
import cometbft_tpu_torch.consensus.replay as replay
import cometbft_tpu_torch.consensus.state as cs_mod
import cometbft_tpu_torch.crypto.ed25519 as ed
import cometbft_tpu_torch.evidence.pool as evpool
import cometbft_tpu_torch.libs.db as db
import cometbft_tpu_torch.light.gateway as gateway
import cometbft_tpu_torch.light.provider as provider
import cometbft_tpu_torch.mempool as mempool
import cometbft_tpu_torch.proxy as proxy
import cometbft_tpu_torch.rpc.client as client
import cometbft_tpu_torch.rpc.core as core
import cometbft_tpu_torch.rpc.jsonrpc.server as server
import cometbft_tpu_torch.sidecar.backend as backend
import cometbft_tpu_torch.state as state
import cometbft_tpu_torch.state.execution as execution
import cometbft_tpu_torch.state.txindex as txindex
import cometbft_tpu_torch.store as store
import cometbft_tpu_torch.types as types
import cometbft_tpu_torch.types.cmttime as cmttime
import cometbft_tpu_torch.types.events as events
import cometbft_tpu_torch.types.evidence as evidence
import cometbft_tpu_torch.types.genesis as genesis
from cometbft_tpu_torch.rpc.jsonrpc.ws_client import WSClient

pytestmark = pytest.mark.torch_port

REF = SimpleNamespace(
    kv=ref_kvstore, config=ref_config, replay=ref_replay, cs=ref_cs, ed=ref_ed,
    evpool=ref_evpool, db=ref_db, gateway=ref_gateway, provider=ref_provider,
    mempool=ref_mempool, proxy=ref_proxy, client=ref_client, core=ref_core,
    server=ref_server, backend=ref_backend, state=ref_state, execution=ref_execution,
    txindex=ref_txindex, store=ref_store, types=ref_types, cmttime=ref_cmttime,
    events=ref_events, evidence=ref_evidence, genesis=ref_genesis)
PORT = SimpleNamespace(
    kv=kvstore, config=config, replay=replay, cs=cs_mod, ed=ed, evpool=evpool, db=db,
    gateway=gateway, provider=provider, mempool=mempool, proxy=proxy, client=client,
    core=core, server=server, backend=backend, state=state, execution=execution,
    txindex=txindex, store=store, types=types, cmttime=cmttime, events=events,
    evidence=evidence, genesis=genesis)

N_BLOCKS = 5
NOW_S = tc.GENESIS_TIME.seconds + 3_600
TX_TIMEOUT_S = 0.2  # rpc.timeout_broadcast_tx_commit of the served chain
# Counters the port adds where the reference swallows an exception (ROADMAP
# §3, "Counted exceptions"): dropped from the port's answer once seen at 0.
PORT_COUNTERS = {"light_gateway_stats": ("speculate_errors",)}


@pytest.fixture(autouse=True)
def backends():
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.CpuBackend())
    try:
        yield
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed._verified.clear()
        ed._verified.clear()


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"rpc", n_vals=4, n_blocks=N_BLOCKS, promote_at=2)


def reindex(p, bs, ss, tx_indexer, block_indexer) -> None:
    """The reference's ``reindex-event`` (cmd/__main__.py): the indexes from
    the block store and the stored ABCI responses."""
    for h in range(max(bs.base(), 1), bs.height() + 1):
        blk, resp = bs.load_block(h), p.execution.decode_responses(ss.load_abci_responses(h))
        block_indexer.index(h, p.events._abci_events_to_attrs(
            list(resp["begin_block"].events) + list(resp["end_block"].events)))
        for i, tx in enumerate(blk.data.txs):
            res = resp["deliver_txs"][i]
            tx_indexer.index(h, i, tx, res, p.events._abci_events_to_attrs(res.events))


def serve_chain(p, chain):
    """Package ``p``'s node handles over the chain's stores, and its route
    table, under a fixed clock."""
    mem = p.db.MemDB()
    for k, v in chain.db_items:
        mem.set(k, v)
    bs, ss = p.store.BlockStore(mem), p.state.StateStore(mem)
    gen = p.genesis.GenesisDoc.from_json(chain.gen_json)
    conns = p.proxy.AppConns(p.proxy.local_client_creator(p.kv.PersistentKVStoreApplication()))
    conns.start()
    st = p.replay.Handshaker(ss, ss.load(), bs, gen).handshake(conns)
    cfg = p.config.test_config()
    cfg.rpc.unsafe = True
    cfg.rpc.timeout_broadcast_tx_commit = TX_TIMEOUT_S
    pool = p.mempool.CListMempool(cfg.mempool, conns.mempool)
    bus = p.events.EventBus()
    bus.start()
    ev_pool = p.evpool.EvidencePool(p.db.MemDB(), ss, bs)
    tx_ix = p.txindex.KVTxIndexer(p.db.MemDB())
    blk_ix = p.txindex.KVBlockIndexer(p.db.MemDB())
    reindex(p, bs, ss, tx_ix, blk_ix)
    p.cmttime.set_now_source(lambda: p.types.Time(NOW_S, 0))
    try:
        executor = p.state.BlockExecutor(ss, conns.consensus, pool, ev_pool, bs, event_bus=bus)
        cs = p.cs.ConsensusState(cfg.consensus, st, executor, bs, pool, event_bus=bus)
    finally:
        p.cmttime.set_now_source(None)
    gw = p.gateway.LightGateway(tc.CHAIN_ID, p.provider.BlockStoreProvider(tc.CHAIN_ID, bs, ss))
    pub = st.validators.validators[0].pub_key
    env = p.core.Environment(
        config=cfg, state_store=ss, block_store=bs, consensus_state=cs, mempool=pool,
        evidence_pool=ev_pool, event_bus=bus, genesis_doc=gen, priv_validator_pub_key=pub,
        node_info={"moniker": "rpc-test", "network": tc.CHAIN_ID}, tx_indexer=tx_ix,
        block_indexer=blk_ix, proxy_app_query=conns.query, light_gateway=lambda: gw)
    return SimpleNamespace(p=p, env=env, routes=p.core.routes(env), bs=bs, ss=ss, bus=bus,
                           tx_ix=tx_ix, blk_ix=blk_ix, app=conns.query._app)


def start_server(side):
    srv = side.p.server.JSONRPCServer(side.routes, host="127.0.0.1", port=0)
    srv.start()
    return srv


def _txs(chain):
    return [tx for blk in chain.blocks for tx in blk.data.txs]


def route_calls(chain) -> list:
    """(method, params) in the order both sides take them: every route of
    the table, its edges and errors."""
    b2 = chain.blocks[1]
    txs = _txs(chain)
    tx_hash = hashlib.sha256(txs[4]).hexdigest()
    dup_ev = tc._duplicate_vote(chain.states[3], chain.pvs[1], 3)
    key = txs[0].split(b"=")[0]
    return [
        ("health", {}), ("status", {}), ("net_info", {}), ("genesis", {}),
        ("genesis_chunked", {}), ("genesis_chunked", {"chunk": "1"}),
        ("blockchain", {}), ("blockchain", {"minHeight": "2", "maxHeight": "4"}),
        ("blockchain", {"minHeight": "5", "maxHeight": "2"}),
        ("block", {}), ("block", {"height": "2"}), ("block", {"height": "0"}),
        ("block", {"height": "99"}), ("block", {"height": "x"}), ("block", {"bogus": "1"}),
        ("block_by_hash", {"hash": "0x" + b2.hash().hex()}),
        ("block_by_hash", {"hash": "00" * 32}),
        ("header", {"height": "3"}), ("header_by_hash", {"hash": b2.hash().hex().upper()}),
        ("block_results", {"height": "2"}), ("commit", {"height": "3"}), ("commit", {}),
        ("validators", {"height": "4"}),
        ("validators", {"height": "4", "page": "2", "per_page": "3"}),
        ("validators", {"height": "1", "page": "1", "per_page": "500"}),
        ("consensus_params", {"height": "1"}),
        ("dump_consensus_state", {}), ("consensus_state", {}),
        ("unconfirmed_txs", {}), ("num_unconfirmed_txs", {}),
        ("tx", {"hash": "0x" + tx_hash}), ("tx", {"hash": tx_hash.upper()}),
        ("tx", {"hash": "00" * 32}),
        ("tx_search", {"query": "tx.height>=2"}),
        ("tx_search", {"query": "tx.height>=2", "page": "2", "per_page": "2",
                       "order_by": "desc"}),
        ("tx_search", {"query": f"tx.hash='{tx_hash}'"}),
        ("block_search", {"query": "block.height>2"}),
        ("block_search", {"query": "block.height>=1", "page": "2", "per_page": "2",
                          "order_by": "desc"}),
        ("check_tx", {"tx": "0x" + b"rpc-check=1".hex()}),
        ("ingress_stats", {}), ("recvq_stats", {}),
        ("light_sync", {"trusted_height": "1", "target_height": "5"}),
        ("light_sync", {"trusted_height": "4", "target_height": "2"}),
        ("light_proof", {"height": "4", "anchor_height": "1"}),
        ("light_proof", {"height": "9"}),
        ("light_bundle", {}), ("light_gateway_stats", {}),
        ("abci_info", {}), ("abci_query", {"data": key.hex()}),
        ("abci_query", {"data": "0x" + key.hex(), "prove": True, "height": "0"}),
        ("broadcast_tx_async", {"tx": "0x" + b"rpc-a=1".hex()}),
        ("broadcast_tx_sync", {"tx": base64.b64encode(b"rpc-b=2").decode()}),
        ("broadcast_tx_sync", {"tx": base64.b64encode(b"rpc-b=2").decode()}),
        ("unconfirmed_txs", {"limit": "1"}), ("num_unconfirmed_txs", {}),
        ("broadcast_tx_commit", {"tx": "0x" + b"rpc-c=3".hex()}),
        ("broadcast_evidence", {"evidence": base64.b64encode(
            ref_evidence.encode_evidence(dup_ev)).decode()}),
        ("dump_consensus_state", {}),
        ("unsafe_flush_mempool", {}), ("num_unconfirmed_txs", {}),
        ("dial_seeds", {"seeds": ["x@127.0.0.1:1"]}), ("dial_peers", {"peers": []}),
        ("subscribe", {"query": "tm.event='NewBlock'"}), ("unsubscribe", {"query": "x"}),
        ("unsubscribe_all", {}), ("no_such_method", {}),
    ]


def local_answer(side, method, params):
    """A route's answer through ``LocalClient``: its result, or the error's
    code, message and data (a traceback's text left out)."""
    c = side.p.client.LocalClient(side.routes)
    try:
        return ("result", json.loads(json.dumps(c.call(method, **params))))
    except side.p.server.RPCError as e:
        return ("rpc_error", e.code, e.message, e.data)
    except side.p.client.RPCClientError as e:
        return ("client_error", e.code, str(e))
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return (type(e).__name__, str(e))


def http_answer(side, url, method, params):
    """The same through ``HTTPClient``: the JSON-RPC result, or the error
    object's code, message and data (a traceback's text left out)."""
    c = side.p.client.HTTPClient(url)
    try:
        return ("result", c.call(method, **params))
    except side.p.client.RPCClientError as e:
        text = e.args[0]
        message = text[len(f"RPC error {e.code}: "):len(text) - len(f" {e.data or ''}")]
        data = e.data
        if isinstance(data, str) and data.startswith("Traceback"):
            data = "<traceback>"
        return ("rpc_error", e.code, message, data)


def port_view(method, answer):
    """The port's answer without the counters only it keeps (each 0)."""
    keys = PORT_COUNTERS.get(method, ())
    if not keys or answer[0] != "result":
        return answer
    assert all(answer[1].pop(k) == 0 for k in keys)
    return answer


def _both(chain):
    return serve_chain(PORT, chain), serve_chain(REF, chain)


def test_every_route_through_local_client_equals_the_reference(chain):
    port, ref = _both(chain)
    calls = route_calls(chain)
    assert {m for m, _ in calls} >= set(port.routes) == set(ref.routes)
    assert len(port.routes) == len(ref.routes) == 40
    for method, params in calls:
        got = port_view(method, local_answer(port, method, params))
        assert got == local_answer(ref, method, params), method
    assert list(port.tx_ix._db.iterator()) == list(ref.tx_ix._db.iterator())
    assert list(port.blk_ix._db.iterator()) == list(ref.blk_ix._db.iterator())
    assert port.env.evidence_pool.stats_snapshot()["pending"] == 1


def test_every_route_over_http_equals_the_reference(chain):
    port, ref = _both(chain)
    port_srv, ref_srv = start_server(port), start_server(ref)
    try:
        urls = (f"http://127.0.0.1:{port_srv.port}", f"tcp://127.0.0.1:{ref_srv.port}")
        for method, params in route_calls(chain):
            got = port_view(method, http_answer(port, urls[0], method, params))
            assert got == http_answer(ref, urls[1], method, params), method
        # The method listing, and a GET with URI parameters.
        for path in ("/", "/block?height=2", '/check_tx?tx="k=v"', "/tx_search?query=%22"
                     "tx.height%3E%3D2%22&prove=false", "/nope"):
            bodies = []
            for srv in (port_srv, ref_srv):
                conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
                conn.request("GET", path)
                resp = conn.getresponse()
                bodies.append((resp.status, resp.getheader("Content-Type"), resp.read()))
                conn.close()
            assert bodies[0] == bodies[1], path
    finally:
        port_srv.stop()
        ref_srv.stop()


def test_cross_package_clients_and_servers(chain):
    """The port's HTTPClient against the reference's server and the
    reference's against the port's: the same answers as each server gives
    its own package's client."""
    port, ref = _both(chain)
    port_srv, ref_srv = start_server(port), start_server(ref)
    try:
        for c_pkg, srv in ((PORT, ref_srv), (REF, port_srv)):
            url = f"http://127.0.0.1:{srv.port}"
            for c, own in ((c_pkg.client.HTTPClient(url),
                            (REF if c_pkg is PORT else PORT).client.HTTPClient(url)),):
                assert c.status() == own.status()
                assert c.block(2) == own.block(2)
                assert c.commit(3) == own.commit(3)
                assert c.validators(4, page=1, per_page=2) == own.validators(4, page=1, per_page=2)
                assert c.blockchain(1, 5) == own.blockchain(1, 5)
                assert c.tx_search("tx.height>=1") == own.tx_search("tx.height>=1")
                assert c.block_search("block.height>=1") == own.block_search("block.height>=1")
                key = _txs(chain)[0].split(b"=")[0]
                assert c.abci_query("", key) == own.abci_query("", key)
                with pytest.raises(c_pkg.client.RPCClientError) as e:
                    c.block(99)
                assert e.value.code == -32603 and "must be less than or equal" in str(e.value)
    finally:
        port_srv.stop()
        ref_srv.stop()


def test_tx_prove_answers_json(chain):
    """``tx`` with ``prove``: the port answers JSON whose proof verifies
    against the block's data hash, through LocalClient and over HTTP. The
    reference's proof carries raw bytes (the same values): its server cannot
    serialize it, so over HTTP the connection closes with no answer."""
    port, ref = _both(chain)
    blk = chain.blocks[2]
    txs = list(blk.data.txs)
    port_srv, ref_srv = start_server(port), start_server(ref)
    try:
        for i, tx in enumerate(txs):
            h = "0x" + hashlib.sha256(tx).hexdigest()
            local = client.LocalClient(port.routes).tx(bytes.fromhex(h[2:]), prove=True)
            over_http = client.HTTPClient(f"http://127.0.0.1:{port_srv.port}").tx(
                bytes.fromhex(h[2:]), prove=True)
            assert json.loads(json.dumps(local)) == over_http
            want = ref_client.LocalClient(ref.routes).tx(bytes.fromhex(h[2:]), prove=True)
            rp = want["proof"]["proof"]
            assert over_http["proof"]["proof"] == {
                "total": rp["total"], "index": rp["index"],
                "leaf_hash": base64.b64encode(rp["leaf_hash"]).decode(),
                "aunts": [base64.b64encode(a).decode() for a in rp["aunts"]]}
            assert {k: v for k, v in over_http.items() if k != "proof"} == \
                {k: v for k, v in want.items() if k != "proof"}
            verify_tx_proof(over_http, blk.header.data_hash, tx)
        with pytest.raises((http.client.RemoteDisconnected, urllib.error.URLError,
                            ConnectionError)):
            ref_client.HTTPClient(f"http://127.0.0.1:{ref_srv.port}").tx(
                hashlib.sha256(txs[0]).digest(), prove=True)
    finally:
        port_srv.stop()
        ref_srv.stop()


def verify_tx_proof(answer: dict, data_hash: bytes, tx: bytes) -> None:
    from cometbft_tpu_torch.rpc.json_codec import tx_proof_from_json

    tp = tx_proof_from_json(answer["proof"])
    assert tp.data == tx
    tp.validate(data_hash)


def test_config_sections_match_the_reference():
    """``RPCConfig`` has every field of the reference's, with its defaults,
    and ``test_config()`` its RPC address."""
    import dataclasses

    port_fields = dataclasses.asdict(config.RPCConfig())
    ref_fields = dataclasses.asdict(ref_config.RPCConfig())
    assert port_fields == ref_fields
    assert config.test_config().rpc.laddr == ref_config.test_config().rpc.laddr
    assert config.Config().rpc == config.RPCConfig()


# -- the websocket ----------------------------------------------------------------


def test_websocket_subscription_equals_the_reference(chain):
    """Each server's websocket: subscribe to NewBlock and Tx, the events
    published on the node's bus arrive as the reference's, a ping answers a
    pong, an unsubscribe drops them, a bad call answers its error."""
    port, ref = _both(chain)
    seen = []
    for side in (port, ref):
        srv = start_server(side)
        ws = WSClient(srv.port)
        try:
            got = []
            for q in ("tm.event='NewBlock'", "tm.event='Tx'"):
                ws.send({"jsonrpc": "2.0", "id": 1, "method": "subscribe", "params": {"query": q}})
                got.append(ws.recv())
            blk = side.bs.load_block(3)
            side.bus.publish_new_block(side.p.events.EventDataNewBlock(block=blk))
            got.append(ws.recv())  # each subscription has its own pump: one at a time
            res = side.p.execution.decode_responses(side.ss.load_abci_responses(3))
            side.bus.publish_tx(side.p.events.EventDataTx(
                height=3, tx=blk.data.txs[1], index=1, result=res["deliver_txs"][1]),
                events=res["deliver_txs"][1].events)
            got.append(ws.recv())
            ws.send(b"ping", opcode=0x9)
            got.append(ws.frame())
            ws.send({"jsonrpc": "2.0", "id": 2, "method": "unsubscribe",
                     "params": {"query": "tm.event='NewBlock'"}})
            got.append(ws.recv())
            ws.send({"jsonrpc": "2.0", "id": 3, "method": "block", "params": {"height": "2"}})
            got.append(ws.recv())
            ws.send({"jsonrpc": "2.0", "id": 4, "method": "unsubscribe_all"})
            got.append(ws.recv())
            ws.send({"jsonrpc": "2.0", "id": 5, "method": "unsubscribe_all"})
            err = ws.recv()
            assert err["error"]["data"].startswith("Traceback")
            err["error"]["data"] = "<traceback>"
            got.append(err)
            ws.send(b"", opcode=0x8)
            seen.append(got)
        finally:
            ws.close()
            srv.stop()
    assert seen[0] == seen[1]
    assert seen[0][2]["result"]["data"]["type"] == "tendermint/event/NewBlock"
    assert seen[0][4] == (0xA, b"ping")


# -- the light client over HTTP ------------------------------------------------------


def test_light_client_over_http_traces_as_over_the_block_store(chain):
    """The port's light client syncing 1 -> 5 over ``HTTPProvider`` and the
    port's ``HTTPClient`` (primary and witness) against the port's server,
    and the same client over ``BlockStoreProvider``: the same heights,
    signed headers and validator sets (by hash: ``HTTPProvider`` rebuilds a
    set from the JSON, whose proposer priorities ``ValidatorSet`` recomputes,
    as the reference's provider does: its light blocks are the port's byte for
    byte)."""
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.store import LightStore

    port = serve_chain(PORT, chain)
    srv = start_server(port)
    url = f"http://127.0.0.1:{srv.port}"
    anchor = provider.BlockStoreProvider(tc.CHAIN_ID, port.bs, port.ss).light_block(1)
    traces = []
    try:
        for make in (lambda: provider.HTTPProvider(tc.CHAIN_ID, client.HTTPClient(url)),
                     lambda: provider.BlockStoreProvider(tc.CHAIN_ID, port.bs, port.ss)):
            c = Client(tc.CHAIN_ID, TrustOptions(14 * 24 * 3600 * 10**9, 1, anchor.hash()),
                       make(), [make()], LightStore(db.MemDB()))
            ed._verified.clear()
            lb = c.verify_light_block_at_height(N_BLOCKS, types.Time(NOW_S, 0))
            traces.append([(h, c.store.light_block(h).signed_header.encode(),
                            c.store.light_block(h).validator_set.hash())
                           for h in c.store._heights()])
            assert lb.height == N_BLOCKS and c.detector_errors == 0
        for h in range(1, N_BLOCKS + 1):
            assert provider.HTTPProvider(tc.CHAIN_ID, client.HTTPClient(url)).light_block(
                h).encode() == ref_provider.HTTPProvider(
                tc.CHAIN_ID, ref_client.HTTPClient(url)).light_block(h).encode()
        remote = gateway.RemoteGateway(client.HTTPClient(url))
        local = port.env.light_gateway()
        assert [lb.encode() for lb in remote.sync_plan(1, N_BLOCKS)] == \
            [lb.encode() for lb in local.sync_plan(1, N_BLOCKS)]
    finally:
        srv.stop()
    assert traces[0] == traces[1] and len(traces[0]) >= 2


@pytest.mark.parametrize("n_vals", [4, 20])
def test_doctored_tip_commit_is_refused_as_by_the_reference(chain, n_vals):
    """A server whose tip commit carries one flipped signature bit, served
    by each package to its own light client over HTTP: both refuse it with
    the same error. On the 4-validator chain (a validator promoted) the
    light check names it (ErrInvalidHeader); on 20 validators that never
    change, the trusting check does first (its ValueError)."""
    import importlib

    if n_vals != 4:
        chain = tc.build_ref_chain(b"rpc-doctored", n_vals=n_vals, n_blocks=N_BLOCKS)
    outcomes = []
    for p in (PORT, REF):
        side = serve_chain(p, chain)
        honest = side.routes["commit"]

        def doctored(height=None, honest=honest, side=side):
            out = honest(height=height)
            if int(out["signed_header"]["header"]["height"]) == side.bs.height():
                sig = out["signed_header"]["commit"]["signatures"][0]
                raw = base64.b64decode(sig["signature"])
                sig["signature"] = base64.b64encode(bytes([raw[0] ^ 1]) + raw[1:]).decode()
            return out

        side.routes["commit"] = doctored
        srv = start_server(side)
        pkg = "cometbft_tpu_torch" if p is PORT else "cometbft_tpu"
        lc = importlib.import_module(pkg + ".light.client")
        ls = importlib.import_module(pkg + ".light.store")
        anchor = p.provider.BlockStoreProvider(tc.CHAIN_ID, side.bs, side.ss).light_block(1)
        c = lc.Client(tc.CHAIN_ID, lc.TrustOptions(14 * 24 * 3600 * 10**9, 1, anchor.hash()),
                      p.provider.HTTPProvider(tc.CHAIN_ID, p.client.HTTPClient(
                          f"http://127.0.0.1:{srv.port}")), [], ls.LightStore(p.db.MemDB()))
        try:
            outcomes.append(local_outcome(
                lambda: c.verify_light_block_at_height(N_BLOCKS, p.types.Time(NOW_S, 0))))
        finally:
            srv.stop()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("ErrInvalidHeader" if n_vals == 4 else "ValueError")
    assert outcomes[0][1].startswith("wrong signature (#0): ")


def local_outcome(fn):
    try:
        return ("ok", fn().height)
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return (type(e).__name__, str(e))


# -- a one-validator chain of the port served over HTTP ------------------------------


def test_one_validator_chain_served_over_http(tmp_path):
    """A node assembled as the reference's node.py does (ConsensusState with
    a validator, a provable kvstore, CListMempool, the event bus, KV indexers
    behind IndexerService, JSONRPCServer): transactions through
    ``broadcast_tx_async`` and ``broadcast_tx_commit`` over HTTP, a websocket
    on NewBlock sees every height, every ``tx`` proof verifies against its
    block's data hash and a proven ``abci_query`` through
    ``default_proof_runtime()`` against the next header's app hash."""
    from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOp, ProofOps, default_proof_runtime
    from cometbft_tpu_torch.types.priv_validator import MockPV

    pv = MockPV(ed.gen_priv_key_from_secret(b"rpc-one-validator"))
    gen = genesis.GenesisDoc(chain_id="rpc-one", genesis_time=types.Time(1_700_000_000, 0),
                             validators=[genesis.GenesisValidator(pv.address(), pv.get_pub_key(),
                                                                  10, "v0")])
    gen.validate_and_complete()
    st = state.make_genesis_state(gen)
    conns = proxy.AppConns(proxy.local_client_creator(kvstore.KVStoreApplication(provable=True)))
    conns.start()
    cfg = config.test_config()
    cfg.rpc.timeout_broadcast_tx_commit = 120.0  # a guard under a loaded host, not a bound
    pool = mempool.CListMempool(cfg.mempool, conns.mempool)
    ss, bs = state.StateStore(db.MemDB()), store.BlockStore(db.MemDB())
    ss.save(st)
    bus = events.EventBus()
    bus.start()
    tx_ix, blk_ix = txindex.KVTxIndexer(db.MemDB()), txindex.KVBlockIndexer(db.MemDB())
    indexer = txindex.IndexerService(tx_ix, blk_ix, bus)
    indexer.start()
    executor = state.BlockExecutor(ss, conns.consensus, pool, None, bs, event_bus=bus)
    cs = cs_mod.ConsensusState(cfg.consensus, st, executor, bs, pool, event_bus=bus)
    cs.set_priv_validator(pv)
    env = core.Environment(config=cfg, state_store=ss, block_store=bs, consensus_state=cs,
                           mempool=pool, event_bus=bus, genesis_doc=gen,
                           priv_validator_pub_key=pv.get_pub_key(), tx_indexer=tx_ix,
                           block_indexer=blk_ix, proxy_app_query=conns.query)
    srv = server.JSONRPCServer(core.routes(env), host="127.0.0.1", port=0)
    srv.start()
    rpc = client.HTTPClient(f"http://127.0.0.1:{srv.port}")
    ws = WSClient(srv.port)
    try:
        # Subscribed before the first height: the route starts its pump
        # before it answers (as the reference's does), so on a running chain
        # a NewBlock event can reach the socket ahead of the answer.
        ws.send({"jsonrpc": "2.0", "id": 0, "method": "subscribe",
                 "params": {"query": "tm.event='NewBlock'"}})
        assert ws.recv()["result"] == {}
        cs.start()
        txs = [b"one-%03d=v%d" % (i, i) for i in range(24)]
        for tx in txs:
            assert rpc.broadcast_tx_async(tx)["code"] == 0
        last = rpc.broadcast_tx_commit(b"one-last=done")
        assert last["check_tx"]["code"] == 0 and last["deliver_tx"]["code"] == 0
        height = int(last["height"])
        heights = []
        while not heights or heights[-1] < height + 1:
            msg = ws.recv()
            heights.append(int(msg["result"]["data"]["value"]["block"]["header"]["height"]))
        assert heights == list(range(1, heights[-1] + 1))
        committed = txs + [b"one-last=done"]
        for tx in committed:
            h = hashlib.sha256(tx).digest()
            ans = None
            while ans is None:  # the indexer runs behind the Tx event
                try:
                    ans = rpc.tx(h, prove=True)
                except client.RPCClientError as e:
                    assert "not found" in str(e)
            blk = rpc.block(int(ans["height"]))["block"]
            verify_tx_proof(ans, bytes.fromhex(blk["header"]["data_hash"]), tx)
        q = rpc.abci_query("", b"one-007", prove=True)["response"]
        assert base64.b64decode(q["value"]) == b"v7"
        ops = ProofOps(ops=[ProofOp(o["type"], base64.b64decode(o["key"]),
                                    base64.b64decode(o["data"])) for o in q["proofOps"]["ops"]])
        qh = int(q["height"])
        while bs.height() < qh + 1:
            ws.recv()
        app_hash = bytes.fromhex(rpc.header(qh + 1)["header"]["app_hash"])
        default_proof_runtime().verify_value(ops, app_hash, "/x:" + b"one-007".hex(), b"v7")
        assert cs.prebatch_errors == 0 and cs.consensus_failures == 0
    finally:
        ws.close()
        cs.stop()
        indexer.stop()
        srv.stop()
        bus.stop()
