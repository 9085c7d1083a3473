"""Light-client RPC proxy (CometBFT's light/proxy/proxy.go + routes.go +
light/rpc/client.go for the verifying wrappers).

Serves a subset of the node RPC, where every piece of returned data is
verified through the light client before being handed to the caller: headers
and commits come from the verified store; ABCI query results must carry
merkle ProofOps, which are checked against the app hash of the verified
header at height+1 (light/rpc/client.go:132-190). The port's copy of
``cometbft_tpu/light/proxy.py``."""

from __future__ import annotations

import base64

from cometbft_tpu_torch.rpc.jsonrpc.server import JSONRPCServer, RPCError


def _hexu(b: bytes) -> str:
    return b.hex().upper()


def default_merkle_key_path_fn(path: str, key: bytes) -> str:
    """light/rpc/client.go:72 DefaultMerkleKeyPathFn for cosmos-style
    '/store/<name>/key' paths, falling back to a single-segment key path for
    flat single-store apps (the provable kvstore)."""
    from cometbft_tpu_torch.crypto.merkle.proof_key_path import KeyEncoding, KeyPath

    kp = KeyPath()
    parts = path.split("/")
    if len(parts) >= 3 and parts[1] == "store" and parts[-1] == "key":
        kp = kp.append_key("/".join(parts[2:-1]).encode(), KeyEncoding.URL)
    return str(kp.append_key(key, KeyEncoding.HEX))


def proxy_routes(client, rpc_client, key_path_fn=default_merkle_key_path_fn) -> dict:
    """light/proxy/routes.go: verified subset + passthrough."""

    def status():
        latest = client.latest_trusted()
        return {
            "node_info": {"network": client.chain_id},
            "sync_info": {
                "latest_block_height": str(latest.height) if latest else "0",
                "latest_block_hash": _hexu(latest.hash()) if latest else "",
                "latest_app_hash": (
                    _hexu(latest.header.app_hash) if latest else ""
                ),
            },
            "light_client": True,
        }

    def header(height=None):
        lb = _verified(height)
        from cometbft_tpu_torch.rpc.core import _header_json

        return {"header": _header_json(lb.header)}

    def commit(height=None):
        lb = _verified(height)
        from cometbft_tpu_torch.rpc.core import _commit_json, _header_json

        return {
            "signed_header": {
                "header": _header_json(lb.header),
                "commit": _commit_json(lb.signed_header.commit),
            },
            "canonical": True,
        }

    def validators(height=None, page="1", per_page="30"):
        lb = _verified(height)
        from cometbft_tpu_torch.rpc.core import _validator_json

        vals = lb.validator_set
        page_i, per_page_i = max(1, int(page)), min(100, max(1, int(per_page)))
        start = (page_i - 1) * per_page_i
        sel = vals.validators[start : start + per_page_i]
        return {
            "block_height": str(lb.height),
            "validators": [_validator_json(v) for v in sel],
            "count": str(len(sel)),
            "total": str(vals.size()),
        }

    def abci_query(path="", data="", height=None, prove=True):
        """light/rpc/client.go:132 ABCIQueryWithOptions: force prove,
        require proof ops, and verify the value (or absence) proof against
        the app hash of the verified header at resp.height + 1."""
        res = rpc_client.call(
            "abci_query", path=path, data=data, height=height or "0", prove=True
        )
        resp = res.get("response", {})
        if int(resp.get("code", 0)) != 0:
            raise RPCError(-32603, f"err response code: {resp.get('code')}", None)
        key = base64.b64decode(resp.get("key") or "")
        if not key:
            raise RPCError(-32603, "empty key", None)
        ops_json = (resp.get("proofOps") or {}).get("ops") or []
        if not ops_json:
            # Also the shape of a verified-absence gap: SimpleMap value ops
            # cannot prove non-membership (CometBFT's DefaultProofRuntime
            # has the same limit — absence needs range/IAVL ops), so an
            # absent key and a proof-stripping node are indistinguishable
            # here and both must be rejected.
            raise RPCError(
                -32603,
                "no proof ops (value-op apps cannot prove absence; query an "
                "existing key or use an app with range proofs)",
                None,
            )
        resp_height = int(resp.get("height", 0))
        if resp_height <= 0:
            raise RPCError(-32603, "negative or zero height", None)
        # App hash for H is in header H+1, which on a live chain lands one
        # block interval after the query's height: retry briefly
        # (light/rpc/client.go's updateLightClientIfNeededTo equivalent).
        import time as _time

        lb = None
        deadline = _time.monotonic() + 5.0
        while True:
            try:
                lb = _verified(resp_height + 1)
                break
            except Exception:
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.1)

        from cometbft_tpu_torch.crypto.merkle.proof_op import (
            ProofOp,
            ProofOps,
            default_proof_runtime,
        )

        ops = ProofOps(
            ops=[
                ProofOp(
                    type=o["type"],
                    key=base64.b64decode(o.get("key") or ""),
                    data=base64.b64decode(o.get("data") or ""),
                )
                for o in ops_json
            ]
        )
        value = base64.b64decode(resp.get("value") or "")
        prt = default_proof_runtime()
        try:
            if value:
                prt.verify_value(
                    ops, lb.header.app_hash, key_path_fn(path, key), value
                )
            else:
                prt.verify_absence(ops, lb.header.app_hash, key_path_fn(path, key))
        except Exception as e:
            raise RPCError(-32603, f"proof verification failed: {e}", None)
        return res

    def broadcast_tx_commit(tx=""):
        return rpc_client.call("broadcast_tx_commit", tx=tx)

    def broadcast_tx_sync(tx=""):
        return rpc_client.call("broadcast_tx_sync", tx=tx)

    def broadcast_tx_async(tx=""):
        return rpc_client.call("broadcast_tx_async", tx=tx)

    def _verified(height):
        h = int(height) if height not in (None, "") else 0
        if h == 0:
            lb = client.update()
            if lb is None:
                lb = client.latest_trusted()
        else:
            lb = client.verify_light_block_at_height(h)
        if lb is None:
            raise RPCError(-32603, f"no verified header at height {height}", None)
        return lb

    return {
        "status": status,
        "header": header,
        "commit": commit,
        "validators": validators,
        "abci_query": abci_query,
        "broadcast_tx_commit": broadcast_tx_commit,
        "broadcast_tx_sync": broadcast_tx_sync,
        "broadcast_tx_async": broadcast_tx_async,
        "health": lambda: {},
    }


class LightProxy:
    """light/proxy/proxy.go Proxy: light client + RPC server."""

    def __init__(self, client, rpc_client, host: str = "127.0.0.1", port: int = 8888):
        self.client = client
        self.rpc_client = rpc_client
        self.server = JSONRPCServer(proxy_routes(client, rpc_client), host, port)

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    @property
    def port(self) -> int:
        return self.server.port
