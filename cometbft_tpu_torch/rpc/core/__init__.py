"""RPC core routes (rpc/core/routes.go + rpc/core/*.go), the port's copy of
``cometbft_tpu/rpc/core/__init__.py``.

The Environment carries node handles (rpc/core/env.go:199); `routes(env)`
builds the 30+ method table served by the JSON-RPC server. JSON shapes
mirror CometBFT's response objects (heights as strings, hashes as
upper-hex, bytes base64 where CometBFT uses base64), and are the
reference's key for key.

One difference: ``tx`` with ``prove`` answers the proof in JSON (``leaf_hash``
and ``aunts`` base64, as Go encodes []byte). The reference puts the proof's
raw bytes in its result, which its server cannot serialize: over HTTP the
connection drops with no answer (ROADMAP §3).
"""

from __future__ import annotations

import base64
import contextlib
from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.rpc.jsonrpc.server import RPCError
from cometbft_tpu_torch.types import cmttime
from cometbft_tpu_torch.types.events import (
    EVENT_TYPE_KEY,
    EventBus,
)
from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.libs.pubsub import Query


@dataclass
class Environment:
    """rpc/core/env.go Environment: every handle RPC needs."""

    config: object = None
    state_store: object = None
    block_store: object = None
    consensus_state: object = None
    consensus_reactor: object = None  # peer round-state introspection
    mempool: object = None
    ingress: object = None  # mempool/ingress.IngressPipeline, as the node wires it
    evidence_pool: object = None
    event_bus: EventBus | None = None
    genesis_doc: object = None
    priv_validator_pub_key: object = None
    node_info: dict = dfield(default_factory=dict)
    tx_indexer: object = None
    block_indexer: object = None
    proxy_app_query: object = None
    p2p_peers: object = None  # switch-like: .peers() / .node_info()
    # Light-client gateway accessor: a zero-arg callable returning the
    # node's LightGateway (constructing it on first use) or None when
    # disabled — lazy so serving unrelated RPC never builds the gateway.
    light_gateway: object = None
    # Checkpoint-bundle origin accessor: callable(build=True) returning
    # the node's BundleOrigin (build=False peeks without constructing) or
    # None when CMTPU_BUNDLE=0.
    bundle_origin: object = None
    is_listening: bool = True


def _hexu(b: bytes) -> str:
    return b.hex().upper()


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _block_id_json(bid) -> dict:
    return {
        "hash": _hexu(bid.hash),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": _hexu(bid.part_set_header.hash),
        },
    }


def _header_json(h) -> dict:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": h.time.rfc3339(),
        "last_block_id": _block_id_json(h.last_block_id),
        "last_commit_hash": _hexu(h.last_commit_hash),
        "data_hash": _hexu(h.data_hash),
        "validators_hash": _hexu(h.validators_hash),
        "next_validators_hash": _hexu(h.next_validators_hash),
        "consensus_hash": _hexu(h.consensus_hash),
        "app_hash": _hexu(h.app_hash),
        "last_results_hash": _hexu(h.last_results_hash),
        "evidence_hash": _hexu(h.evidence_hash),
        "proposer_address": _hexu(h.proposer_address),
    }


def _commit_json(c) -> dict:
    out = {
        "height": str(c.height),
        "round": c.round,
        "block_id": _block_id_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": s.block_id_flag,
                "validator_address": _hexu(s.validator_address),
                "timestamp": s.timestamp.rfc3339(),
                "signature": _b64(s.signature) if s.signature else None,
            }
            for s in c.signatures
        ],
    }
    if c.agg_signature:
        out["agg_signature"] = _b64(c.agg_signature)
        out["agg_bitmap"] = _b64(c.agg_bitmap)
    return out


def _block_json(b) -> dict:
    from cometbft_tpu_torch.types.evidence import encode_evidence

    return {
        "header": _header_json(b.header),
        "data": {"txs": [_b64(tx) for tx in b.data.txs]},
        "evidence": {"evidence": [len(b.evidence) and None or None] and []},
        "last_commit": _commit_json(b.last_commit) if b.last_commit else None,
    }


def _proof_json(p) -> dict:
    """A ``crypto/merkle.Proof`` as the reference's ``Proof.to_proto`` keys it,
    its bytes base64."""
    return {
        "total": p.total,
        "index": p.index,
        "leaf_hash": _b64(p.leaf_hash),
        "aunts": [_b64(a) for a in p.aunts],
    }


def _validator_json(v) -> dict:
    return {
        "address": _hexu(v.address),
        "pub_key": {
            "type": "tendermint/PubKeyEd25519",
            "value": _b64(v.pub_key.bytes()),
        },
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }


def routes(env: Environment) -> dict:
    """rpc/core/routes.go: the 31-route table. A websocket subscription's
    pump joins the thread group the table was built in (a node's), so that
    the node's ``stop()`` waits for it; the event bus's stop ends it."""
    group = threads.current_group()

    # ---- info routes -------------------------------------------------------

    def health():
        return {}

    def status():
        """rpc/core/status.go."""
        bs = env.block_store
        latest_height = bs.height() if bs else 0
        latest_meta = bs.load_block_meta(latest_height) if latest_height else None
        pub = env.priv_validator_pub_key
        val_info = {}
        if pub is not None:
            val_info = {
                "address": _hexu(pub.address()),
                "pub_key": {
                    "type": "tendermint/PubKeyEd25519",
                    "value": _b64(pub.bytes()),
                },
                "voting_power": "0",
            }
            if env.consensus_state is not None:
                vals = env.consensus_state.rs.validators
                if vals is not None:
                    _, val = vals.get_by_address(pub.address())
                    if val:
                        val_info["voting_power"] = str(val.voting_power)
        return {
            "node_info": env.node_info,
            "sync_info": {
                "latest_block_hash": _hexu(latest_meta.block_id.hash) if latest_meta else "",
                "latest_app_hash": _hexu(latest_meta.header.app_hash) if latest_meta else "",
                "latest_block_height": str(latest_height),
                "latest_block_time": latest_meta.header.time.rfc3339() if latest_meta else "",
                "earliest_block_height": str(bs.base() if bs else 0),
                "catching_up": False,
            },
            "validator_info": val_info,
        }

    def net_info():
        peers = env.p2p_peers.peers() if env.p2p_peers else []
        return {
            "listening": env.is_listening,
            "listeners": [],
            "n_peers": str(len(peers)),
            "peers": [
                {
                    "node_info": getattr(p, "node_info_json", lambda: {})(),
                    "is_outbound": getattr(p, "is_outbound", False),
                    "remote_ip": getattr(p, "remote_ip", ""),
                }
                for p in peers
            ],
        }

    def genesis():
        import json as _json

        return {"genesis": _json.loads(env.genesis_doc.to_json())}

    def genesis_chunked(chunk="0"):
        import json as _json

        data = env.genesis_doc.to_json().encode()
        chunk_size = 16 * 1024 * 1024
        chunks = [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)] or [b""]
        idx = int(chunk)
        if idx < 0 or idx >= len(chunks):
            raise RPCError(INTERNAL := -32603, f"there are {len(chunks)} chunks", None)
        return {"chunk": str(idx), "total": str(len(chunks)), "data": _b64(chunks[idx])}

    # ---- block routes ------------------------------------------------------

    def _normalize_height(height) -> int:
        bs = env.block_store
        if height is None or height == "":
            return bs.height()
        h = int(height)
        if h <= 0:
            raise RPCError(-32603, "height must be greater than 0", None)
        if h > bs.height():
            raise RPCError(
                -32603,
                f"height {h} must be less than or equal to the current blockchain height {bs.height()}",
                None,
            )
        if h < bs.base():
            raise RPCError(
                -32603, f"height {h} is not available, lowest height is {bs.base()}", None
            )
        return h

    def block(height=None):
        h = _normalize_height(height)
        blk = env.block_store.load_block(h)
        meta = env.block_store.load_block_meta(h)
        if blk is None:
            return {"block_id": None, "block": None}
        return {"block_id": _block_id_json(meta.block_id), "block": _block_json(blk)}

    def block_by_hash(hash=""):
        raw = _parse_hash(hash)
        blk = env.block_store.load_block_by_hash(raw)
        if blk is None:
            return {"block_id": None, "block": None}
        meta = env.block_store.load_block_meta(blk.header.height)
        return {"block_id": _block_id_json(meta.block_id), "block": _block_json(blk)}

    def header(height=None):
        h = _normalize_height(height)
        meta = env.block_store.load_block_meta(h)
        return {"header": _header_json(meta.header) if meta else None}

    def header_by_hash(hash=""):
        raw = _parse_hash(hash)
        blk = env.block_store.load_block_by_hash(raw)
        return {"header": _header_json(blk.header) if blk else None}

    def commit(height=None):
        h = _normalize_height(height)
        meta = env.block_store.load_block_meta(h)
        if meta is None:
            return {"signed_header": None, "canonical": False}
        if h == env.block_store.height():
            c = env.block_store.load_seen_commit(h)
            canonical = False
        else:
            c = env.block_store.load_block_commit(h)
            canonical = True
        return {
            "signed_header": {
                "header": _header_json(meta.header),
                "commit": _commit_json(c) if c else None,
            },
            "canonical": canonical,
        }

    def block_results(height=None):
        h = _normalize_height(height)
        resp = env.state_store.load_abci_responses(h)
        if resp is None:
            raise RPCError(-32603, f"could not find results for height #{h}", None)
        return {
            "height": str(h),
            "txs_results": resp.get("deliver_txs", []),
            "begin_block_events": [],
            "end_block_events": [],
            "validator_updates": [],
            "consensus_param_updates": None,
        }

    def blockchain(minHeight=None, maxHeight=None):
        """rpc/core/blocks.go BlockchainInfo: metas in [min, max], newest first,
        max 20."""
        bs = env.block_store
        max_h = int(maxHeight) if maxHeight else bs.height()
        max_h = min(max_h, bs.height())
        min_h = int(minHeight) if minHeight else max(1, max_h - 19)
        min_h = max(min_h, bs.base())
        min_h = max(min_h, max_h - 19)
        if min_h > max_h:
            raise RPCError(
                -32603, f"min height {min_h} can't be greater than max height {max_h}", None
            )
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = bs.load_block_meta(h)
            if m:
                metas.append(
                    {
                        "block_id": _block_id_json(m.block_id),
                        "block_size": str(m.block_size),
                        "header": _header_json(m.header),
                        "num_txs": str(m.num_txs),
                    }
                )
        return {"last_height": str(bs.height()), "block_metas": metas}

    def validators(height=None, page="1", per_page="30"):
        h = _normalize_height(height)
        vals = env.state_store.load_validators(h)
        page_i, per_page_i = max(1, int(page)), min(100, max(1, int(per_page)))
        start = (page_i - 1) * per_page_i
        sel = vals.validators[start : start + per_page_i]
        return {
            "block_height": str(h),
            "validators": [_validator_json(v) for v in sel],
            "count": str(len(sel)),
            "total": str(vals.size()),
        }

    def consensus_params(height=None):
        h = _normalize_height(height)
        p = env.state_store.load_consensus_params(h)
        return {
            "block_height": str(h),
            "consensus_params": {
                "block": {"max_bytes": str(p.block.max_bytes), "max_gas": str(p.block.max_gas)},
                "evidence": {
                    "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
                    "max_age_duration": str(p.evidence.max_age_duration_ns),
                    "max_bytes": str(p.evidence.max_bytes),
                },
                "validator": {"pub_key_types": list(p.validator.pub_key_types)},
                "version": {"app": str(p.version.app)},
            },
        }

    def dump_consensus_state():
        from cometbft_tpu_torch.consensus.cstypes import STEP_NAMES

        cs = env.consensus_state
        rs = cs.rs
        # Per-round vote-set bitmaps up to the live round: the stall
        # forensics dump — which validators' votes each node holds per
        # round — is what makes a round-livelock diagnosable from a
        # repro.json alone (rpc/core/consensus.go DumpConsensusState).
        votes = []
        if rs.votes is not None:
            for r in range(rs.round + 1):
                pv = rs.votes.prevotes(r)
                pc = rs.votes.precommits(r)
                votes.append(
                    {
                        "round": r,
                        "prevotes_bit_array": repr(pv.bit_array()) if pv else "",
                        "precommits_bit_array": repr(pc.bit_array()) if pc else "",
                    }
                )
        peers = []
        reactor = env.consensus_reactor
        if reactor is not None:
            for peer_id, ps in list(
                getattr(reactor, "peer_states", {}).items()
            ):
                peers.append(
                    {
                        "node_address": peer_id,
                        "peer_state": {
                            "height": str(ps.height),
                            "round": ps.round,
                            "step": STEP_NAMES.get(ps.step, ps.step),
                            "proposal": ps.proposal,
                            "proposal_pol_round": ps.proposal_pol_round,
                        },
                    }
                )
        return {
            "round_state": {
                "height": str(rs.height),
                "round": rs.round,
                "step": rs.step,
                "step_name": STEP_NAMES.get(rs.step, str(rs.step)),
                "start_time": rs.start_time.rfc3339(),
                "proposal_block_hash": _hexu(rs.proposal_block.hash()) if rs.proposal_block else "",
                "locked_block_hash": _hexu(rs.locked_block.hash()) if rs.locked_block else "",
                "locked_round": rs.locked_round,
                "valid_block_hash": _hexu(rs.valid_block.hash()) if rs.valid_block else "",
                "valid_round": rs.valid_round,
                "height_vote_set": votes,
                "validators": {
                    "validators": [_validator_json(v) for v in rs.validators.validators]
                    if rs.validators
                    else [],
                },
            },
            # Stall forensics: a proposal that arrives on time at the
            # switch but seconds late at the state machine shows up here
            # as a deep message queue.
            "msg_queue_depth": cs._queue.qsize(),
            "peers": peers,
            # Accountability forensics: same counters as the evidence_*
            # gauges, so a soak assertion and a live dump read one source.
            "evidence_stats": (
                env.evidence_pool.stats_snapshot()
                if env.evidence_pool is not None else None
            ),
        }

    def consensus_state():
        cs = env.consensus_state
        rs = cs.rs
        return {
            "round_state": {
                "height/round/step": f"{rs.height}/{rs.round}/{rs.step}",
                "start_time": rs.start_time.rfc3339(),
                "proposal_block_hash": _hexu(rs.proposal_block.hash()) if rs.proposal_block else "",
                "locked_block_hash": _hexu(rs.locked_block.hash()) if rs.locked_block else "",
                "valid_block_hash": _hexu(rs.valid_block.hash()) if rs.valid_block else "",
            }
        }

    # ---- tx routes ---------------------------------------------------------

    def _decode_tx_param(tx) -> bytes:
        from cometbft_tpu_torch.rpc.jsonrpc.server import QuotedStr

        if isinstance(tx, (bytes, bytearray)):
            return bytes(tx)
        if isinstance(tx, QuotedStr):
            # URI `tx="k1=v1"`: raw string bytes (http_uri_handler.go).
            return str(tx).encode()
        if isinstance(tx, str):
            if tx.startswith("0x"):
                return bytes.fromhex(tx[2:])
            return base64.b64decode(tx)
        raise RPCError(-32602, "invalid tx param", None)

    def broadcast_tx_async(tx=""):
        raw = _decode_tx_param(tx)
        env.mempool.check_tx(raw)
        from cometbft_tpu_torch.types.tx import tx_hash

        return {"code": 0, "data": "", "log": "", "codespace": "", "hash": _hexu(tx_hash(raw))}

    def broadcast_tx_sync(tx=""):
        raw = _decode_tx_param(tx)
        result = {}
        done = __import__("threading").Event()

        def cb(res):
            result["res"] = res
            done.set()

        env.mempool.check_tx(raw, callback=cb)
        # Same deadline source as broadcast_tx_commit (config/config.go
        # TimeoutBroadcastTxCommit) instead of a hard-coded 5s.
        timeout = (
            env.config.rpc.timeout_broadcast_tx_commit if env.config else 10.0
        )
        if not done.wait(timeout):
            raise RPCError(
                -32603,
                f"timed out waiting for tx to be included in the mempool "
                f"(after {timeout}s)",
                None,
            )
        res = result["res"]
        from cometbft_tpu_torch.types.tx import tx_hash

        return {
            "code": res.code,
            "data": _b64(res.data),
            "log": res.log,
            "codespace": res.codespace,
            "hash": _hexu(tx_hash(raw)),
        }

    def broadcast_tx_commit(tx=""):
        """rpc/core/mempool.go BroadcastTxCommit: subscribe to EventTx, submit,
        wait for DeliverTx."""
        import queue as _q

        raw = _decode_tx_param(tx)
        from cometbft_tpu_torch.types.tx import tx_hash

        txh = tx_hash(raw)
        q = Query(f"{EVENT_TYPE_KEY}='Tx' AND tx.hash='{_hexu(txh)}'")
        sub = env.event_bus.subscribe(f"mempool-{_hexu(txh)[:16]}", q, 16)
        try:
            sync_res = broadcast_tx_sync(tx=tx)
            if sync_res["code"] != 0:
                return {
                    "check_tx": sync_res,
                    "deliver_tx": {},
                    "hash": _hexu(txh),
                    "height": "0",
                }
            timeout = env.config.rpc.timeout_broadcast_tx_commit if env.config else 10.0
            try:
                msg = sub.out.get(timeout=timeout)
                data = msg.data
                return {
                    "check_tx": sync_res,
                    "deliver_tx": {
                        "code": data.result.code,
                        "data": _b64(data.result.data),
                        "log": data.result.log,
                        "gas_wanted": str(data.result.gas_wanted),
                        "gas_used": str(data.result.gas_used),
                    },
                    "hash": _hexu(txh),
                    "height": str(data.height),
                }
            except _q.Empty:
                raise RPCError(-32603, "timed out waiting for tx to be included in a block", None)
        finally:
            try:
                env.event_bus.unsubscribe(f"mempool-{_hexu(txh)[:16]}", q)
            except KeyError:  # the bus was stopped, which dropped it
                pass

    def unconfirmed_txs(limit="30"):
        txs = env.mempool.reap_max_txs(int(limit))
        return {
            "n_txs": str(len(txs)),
            "total": str(env.mempool.size()),
            "total_bytes": str(env.mempool.size_bytes()),
            "txs": [_b64(t) for t in txs],
        }

    def num_unconfirmed_txs():
        return {
            "n_txs": str(env.mempool.size()),
            "total": str(env.mempool.size()),
            "total_bytes": str(env.mempool.size_bytes()),
        }

    def check_tx(tx=""):
        raw = _decode_tx_param(tx)
        from cometbft_tpu_torch.abci import types as abci

        res = env.proxy_app_query.check_tx(abci.RequestCheckTx(tx=raw))
        return {"code": res.code, "data": _b64(res.data), "log": res.log,
                "gas_wanted": str(res.gas_wanted)}

    def ingress_stats():
        """QoS ingress counters (admission/rejection/shed/preverify) for
        operators and the e2e tx_flood perturbation's delta checks."""
        if env.ingress is None:
            return {"enabled": False}
        return {"enabled": True, **env.ingress.stats()}

    def recvq_stats():
        """Recv-demux counters (per-class deliveries, sheds, promotions,
        queue depth) aggregated across peer connections — operators and
        the e2e recv_flood perturbation's delta checks."""
        fn = getattr(env.p2p_peers, "recvq_stats", None)
        if fn is None:
            return {"enabled": False}
        return fn()

    # ---- light-client gateway (light/gateway.py) ---------------------------

    def _light_gateway():
        accessor = env.light_gateway
        g = accessor() if callable(accessor) else accessor
        if g is None:
            raise RPCError(-32603, "light gateway disabled", None)
        return g

    def light_sync(trusted_height="0", target_height="0"):
        """Descent plan (pivot + target light blocks, wire-encoded) for a
        skipping verification the CLIENT re-runs locally — the gateway is
        an untrusted accelerator, never an arbiter."""
        from cometbft_tpu_torch.light.gateway import GatewayError

        g = _light_gateway()
        try:
            blocks = g.sync_plan(int(trusted_height), int(target_height))
        except GatewayError as e:
            raise RPCError(-32603, f"light_sync: {e}", None)
        return {
            "heights": [str(b.height) for b in blocks],
            "blocks": [_b64(b.encode()) for b in blocks],
        }

    def light_proof(height="0", anchor_height="0"):
        """Target light block + MMR inclusion proofs for the target header
        and the caller's trust anchor under one accumulator root."""
        from cometbft_tpu_torch.light.gateway import GatewayError

        g = _light_gateway()
        try:
            p = g.prove(int(height), anchor_height=int(anchor_height))
        except GatewayError as e:
            raise RPCError(-32603, f"light_proof: {e}", None)
        out = {
            "size": str(p["size"]),
            "root": _hexu(p["root"]),
            "light_block": _b64(p["light_block"].encode()),
            "target": {
                "index": str(p["target"]["index"]),
                "aunts": [_hexu(a) for a in p["target"]["aunts"]],
            },
            "proof_bytes": str(p["bytes"]),
        }
        if "anchor" in p:
            out["anchor"] = {
                "index": str(p["anchor"]["index"]),
                "aunts": [_hexu(a) for a in p["anchor"]["aunts"]],
            }
        return out

    def light_bundle(height="0"):
        """Latest checkpoint bundle at or below `height` (0 = newest),
        content-addressed: `name` is the hex SHA-256 of the returned
        bytes, so any cache between this origin and the client is
        verifiable end-to-end."""
        from cometbft_tpu_torch.light.bundle import BundleError

        accessor = env.bundle_origin
        o = accessor() if callable(accessor) else accessor
        if o is None:
            return {"enabled": False}
        try:
            name, data, boundary = o.get_encoded(int(height))
        except BundleError as e:
            raise RPCError(-32603, f"light_bundle: {e}", None)
        return {
            "enabled": True,
            "name": name,
            "height": str(boundary),
            "bundle": _b64(data),
        }

    def light_gateway_stats():
        """Gateway counters (sessions, plan cache, proofs) for operators
        and the e2e swarm perturbations' delta checks.  Bundle-origin
        counters ride along when the origin already exists — peeked, not
        built: a stats scrape never constructs the origin."""
        accessor = env.light_gateway
        g = accessor() if callable(accessor) else accessor
        if g is None:
            out = {"enabled": False}
        else:
            out = {"enabled": True, **g.stats()}
        peek = env.bundle_origin
        o = peek(build=False) if callable(peek) else None
        if o is not None:
            out["bundle"] = o.stats()
        return out

    def tx(hash="", prove=False):
        if env.tx_indexer is None:
            raise RPCError(-32603, "transaction indexing is disabled", None)
        raw = _parse_hash(hash)
        res = env.tx_indexer.get(raw)
        if res is None:
            raise RPCError(-32603, f"tx ({_hexu(raw)}) not found", None)
        out = dict(res)
        if prove:
            from cometbft_tpu_torch.types.tx import txs_proof

            blk = env.block_store.load_block(int(out["height"]))
            idx = int(out["index"])
            proof = txs_proof(blk.data.txs, idx)
            out["proof"] = {
                "root_hash": _hexu(proof.root_hash),
                "data": _b64(proof.data),
                "proof": _proof_json(proof.proof),
            }
        return out

    def tx_search(query="", prove=False, page="1", per_page="30", order_by="asc"):
        if env.tx_indexer is None:
            raise RPCError(-32603, "transaction indexing is disabled", None)
        results = env.tx_indexer.search(query)
        if order_by == "desc":
            results = list(reversed(results))
        page_i, per_page_i = max(1, int(page)), min(100, max(1, int(per_page)))
        start = (page_i - 1) * per_page_i
        sel = results[start : start + per_page_i]
        return {"txs": sel, "total_count": str(len(results))}

    def block_search(query="", page="1", per_page="30", order_by="asc"):
        if env.block_indexer is None:
            raise RPCError(-32603, "block indexing is disabled", None)
        heights = env.block_indexer.search(query)
        if order_by == "desc":
            heights = list(reversed(heights))
        page_i, per_page_i = max(1, int(page)), min(100, max(1, int(per_page)))
        sel = heights[(page_i - 1) * per_page_i :][:per_page_i]
        blocks = []
        for h in sel:
            m = env.block_store.load_block_meta(h)
            blk = env.block_store.load_block(h)
            if m and blk:
                blocks.append({"block_id": _block_id_json(m.block_id), "block": _block_json(blk)})
        return {"blocks": blocks, "total_count": str(len(heights))}

    # ---- abci --------------------------------------------------------------

    def abci_info():
        from cometbft_tpu_torch.abci import types as abci

        res = env.proxy_app_query.info(abci.RequestInfo())
        return {
            "response": {
                "data": res.data,
                "version": res.version,
                "app_version": str(res.app_version),
                "last_block_height": str(res.last_block_height),
                "last_block_app_hash": _b64(res.last_block_app_hash),
            }
        }

    def abci_query(path="", data="", height="0", prove=False):
        from cometbft_tpu_torch.abci import types as abci

        raw = bytes.fromhex(data[2:]) if isinstance(data, str) and data.startswith("0x") else (
            bytes.fromhex(data) if isinstance(data, str) else bytes(data)
        )
        res = env.proxy_app_query.query(
            abci.RequestQuery(data=raw, path=path, height=int(height), prove=bool(prove))
        )
        out = {
            "response": {
                "code": res.code,
                "log": res.log,
                "info": res.info,
                "index": str(res.index),
                "key": _b64(res.key),
                "value": _b64(res.value),
                "height": str(res.height),
                "codespace": res.codespace,
            }
        }
        if res.proof_ops:
            out["response"]["proofOps"] = {
                "ops": [
                    {"type": op.type, "key": _b64(op.key), "data": _b64(op.data)}
                    for op in res.proof_ops
                ]
            }
        return out

    # ---- evidence ----------------------------------------------------------

    def broadcast_evidence(evidence=""):
        from cometbft_tpu_torch.types.evidence import decode_evidence

        raw = base64.b64decode(evidence) if isinstance(evidence, str) else bytes(evidence)
        ev = decode_evidence(raw)
        env.evidence_pool.add_evidence(ev)
        return {"hash": _hexu(ev.hash())}

    # ---- events (websocket) ------------------------------------------------

    def subscribe(query="", ws=None):
        """rpc/core/events.go Subscribe — websocket-only."""
        if ws is None:
            raise RPCError(-32603, "subscribe requires a websocket connection", None)
        q = Query(query)
        sub = env.event_bus.subscribe(ws.remote, q, 100)

        import queue as _q

        def pump():
            while ws.open and not sub.canceled.is_set():
                try:
                    msg = sub.out.get(timeout=0.25)
                except _q.Empty:
                    continue
                ws.send_json(
                    {
                        "jsonrpc": "2.0",
                        "id": f"{query}#event",
                        "result": {
                            "query": query,
                            "data": {"type": _event_type(msg), "value": _event_value(msg)},
                            "events": msg.events,
                        },
                    }
                )

        with group.scope() if group is not None else contextlib.nullcontext():
            threads.spawn(pump, name="rpc-ws-pump")
        return {}

    def unsubscribe(query="", ws=None):
        if ws is None:
            raise RPCError(-32603, "unsubscribe requires a websocket connection", None)
        env.event_bus.unsubscribe(ws.remote, Query(query))
        return {}

    def unsubscribe_all(ws=None):
        if ws is None:
            raise RPCError(-32603, "unsubscribe_all requires a websocket connection", None)
        env.event_bus.unsubscribe_all(ws.remote)
        return {}

    table = {
        "health": health,
        "status": status,
        "net_info": net_info,
        "genesis": genesis,
        "genesis_chunked": genesis_chunked,
        "blockchain": blockchain,
        "block": block,
        "block_by_hash": block_by_hash,
        "header": header,
        "header_by_hash": header_by_hash,
        "block_results": block_results,
        "commit": commit,
        "validators": validators,
        "consensus_params": consensus_params,
        "dump_consensus_state": dump_consensus_state,
        "consensus_state": consensus_state,
        "unconfirmed_txs": unconfirmed_txs,
        "num_unconfirmed_txs": num_unconfirmed_txs,
        "tx": tx,
        "tx_search": tx_search,
        "block_search": block_search,
        "broadcast_tx_async": broadcast_tx_async,
        "broadcast_tx_sync": broadcast_tx_sync,
        "broadcast_tx_commit": broadcast_tx_commit,
        "check_tx": check_tx,
        "ingress_stats": ingress_stats,
        "recvq_stats": recvq_stats,
        "light_sync": light_sync,
        "light_proof": light_proof,
        "light_bundle": light_bundle,
        "light_gateway_stats": light_gateway_stats,
        "abci_info": abci_info,
        "abci_query": abci_query,
        "broadcast_evidence": broadcast_evidence,
        "subscribe": subscribe,
        "unsubscribe": unsubscribe,
        "unsubscribe_all": unsubscribe_all,
    }

    # ---- unsafe dev routes (routes.go AddUnsafeRoutes, rpc/core/dev.go +
    # net.go UnsafeDialSeeds/UnsafeDialPeers) — only with config.rpc.unsafe.
    if getattr(getattr(env.config, "rpc", None), "unsafe", False):

        def dial_seeds(seeds=()):
            if env.p2p_peers is None:
                raise RPCError(-32603, "p2p layer unavailable", None)
            for s in seeds:
                env.p2p_peers.dial_peer(s)
            return {"log": "Dialing seeds in progress. See /net_info for details"}

        def dial_peers(peers=(), persistent=False, **_kw):
            if env.p2p_peers is None:
                raise RPCError(-32603, "p2p layer unavailable", None)
            for p in peers:
                if persistent:
                    env.p2p_peers.add_persistent_peers([p])
                env.p2p_peers.dial_peer(p)
            return {"log": "Dialing peers in progress. See /net_info for details"}

        def unsafe_flush_mempool():
            env.mempool.flush()
            return {}

        table["dial_seeds"] = dial_seeds
        table["dial_peers"] = dial_peers
        table["unsafe_flush_mempool"] = unsafe_flush_mempool
    return table


def _parse_hash(h) -> bytes:
    if isinstance(h, (bytes, bytearray)):
        return bytes(h)
    if isinstance(h, str):
        if h.startswith("0x"):
            return bytes.fromhex(h[2:])
        try:
            return bytes.fromhex(h)
        except ValueError:
            return base64.b64decode(h)
    raise RPCError(-32602, "invalid hash param", None)


def _event_type(msg) -> str:
    types = msg.events.get(EVENT_TYPE_KEY, [])
    return f"tendermint/event/{types[0]}" if types else ""


def _event_value(msg):
    data = msg.data
    if hasattr(data, "height") and hasattr(data, "tx"):
        return {
            "TxResult": {
                "height": str(data.height),
                "index": data.index,
                "tx": base64.b64encode(data.tx).decode(),
                "result": {"code": data.result.code, "log": data.result.log},
            }
        }
    if hasattr(data, "block"):
        blk = data.block
        return {"block": {"header": _header_json(blk.header)}} if blk else {}
    return {}
