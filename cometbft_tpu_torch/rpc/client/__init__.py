"""RPC client library (rpc/client/{http,local,mock}), the port's copy of
``cometbft_tpu/rpc/client/__init__.py``.

HTTPClient speaks JSON-RPC 2.0 over HTTP POST to a node's RPC server;
LocalClient calls a node's route table in-process (rpc/client/local — zero
serialization overhead, used by the light proxy and tests); MockClient wraps
canned responses."""

from __future__ import annotations

import itertools
import json
import urllib.request


class RPCClientError(Exception):
    def __init__(self, code, message, data=None):
        self.code = code
        self.data = data
        super().__init__(f"RPC error {code}: {message} {data or ''}")


class BaseClient:
    """Route-method surface shared by all clients (rpc/client/interface.go)."""

    def call(self, method: str, **params):
        raise NotImplementedError

    # -- info ---------------------------------------------------------------
    def status(self):
        return self.call("status")

    def health(self):
        return self.call("health")

    def net_info(self):
        return self.call("net_info")

    def genesis(self):
        return self.call("genesis")

    def abci_info(self):
        return self.call("abci_info")

    def abci_query(self, path: str, data: bytes, height: int = 0, prove: bool = False):
        return self.call(
            "abci_query", path=path, data=data.hex(), height=str(height), prove=prove
        )

    # -- history ------------------------------------------------------------
    def block(self, height: int | None = None):
        return self.call("block", **_h(height))

    def block_by_hash(self, block_hash: bytes):
        return self.call("block_by_hash", hash="0x" + block_hash.hex())

    def block_results(self, height: int | None = None):
        return self.call("block_results", **_h(height))

    def commit(self, height: int | None = None):
        return self.call("commit", **_h(height))

    def header(self, height: int | None = None):
        return self.call("header", **_h(height))

    def blockchain(self, min_height: int, max_height: int):
        return self.call(
            "blockchain", minHeight=str(min_height), maxHeight=str(max_height)
        )

    def validators(self, height: int | None = None, page: int = 1, per_page: int = 30):
        return self.call(
            "validators", **_h(height), page=str(page), per_page=str(per_page)
        )

    def consensus_params(self, height: int | None = None):
        return self.call("consensus_params", **_h(height))

    def tx(self, tx_hash: bytes, prove: bool = False):
        return self.call("tx", hash="0x" + tx_hash.hex(), prove=prove)

    def tx_search(self, query: str, prove: bool = False, page: int = 1, per_page: int = 30):
        return self.call(
            "tx_search", query=query, prove=prove, page=str(page), per_page=str(per_page)
        )

    def block_search(self, query: str, page: int = 1, per_page: int = 30):
        return self.call("block_search", query=query, page=str(page), per_page=str(per_page))

    # -- tx submission -------------------------------------------------------
    def broadcast_tx_async(self, tx: bytes):
        return self.call("broadcast_tx_async", tx="0x" + tx.hex())

    def broadcast_tx_sync(self, tx: bytes):
        return self.call("broadcast_tx_sync", tx="0x" + tx.hex())

    def broadcast_tx_commit(self, tx: bytes):
        return self.call("broadcast_tx_commit", tx="0x" + tx.hex())

    def broadcast_evidence(self, ev):
        import base64

        from cometbft_tpu_torch.types.evidence import encode_evidence

        raw = ev if isinstance(ev, (bytes, bytearray)) else encode_evidence(ev)
        return self.call("broadcast_evidence", evidence=base64.b64encode(bytes(raw)).decode())

    # -- consensus introspection ---------------------------------------------
    def consensus_state(self):
        return self.call("consensus_state")

    def dump_consensus_state(self):
        return self.call("dump_consensus_state")

    def unconfirmed_txs(self, limit: int = 30):
        return self.call("unconfirmed_txs", limit=str(limit))

    def num_unconfirmed_txs(self):
        return self.call("num_unconfirmed_txs")


def _h(height):
    return {} if height is None else {"height": str(height)}


class HTTPClient(BaseClient):
    """rpc/client/http: JSON-RPC 2.0 over HTTP POST."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        if base_url.startswith("tcp://"):
            base_url = "http://" + base_url[len("tcp://"):]
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._ids = itertools.count(1)

    def call(self, method: str, **params):
        payload = json.loads(self._post(method, params))
        if payload.get("error"):
            err = payload["error"]
            raise RPCClientError(err.get("code"), err.get("message"), err.get("data"))
        return payload["result"]

    def _post(self, method: str, params: dict) -> bytes:
        """The HTTP exchange of one call: the request, the server's work and
        the body read, undecoded."""
        body = json.dumps(
            {
                "jsonrpc": "2.0",
                "id": next(self._ids),
                "method": method,
                "params": params,
            }
        ).encode()
        req = urllib.request.Request(
            self.base_url,
            data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()


class LocalClient(BaseClient):
    """rpc/client/local: direct route-table dispatch against a Node."""

    def __init__(self, routes_or_node):
        if hasattr(routes_or_node, "rpc_routes"):
            self._routes = routes_or_node.rpc_routes()
        else:
            self._routes = routes_or_node

    def call(self, method: str, **params):
        fn = self._routes.get(method)
        if fn is None:
            raise RPCClientError(-32601, f"method {method} not found")
        return fn(**params)


class MockClient(BaseClient):
    """rpc/client/mock: canned per-method results for tests."""

    def __init__(self, responses: dict):
        self.responses = responses
        self.calls = []

    def call(self, method: str, **params):
        self.calls.append((method, params))
        res = self.responses.get(method)
        if callable(res):
            return res(**params)
        if res is None:
            raise RPCClientError(-32601, f"no mock for {method}")
        return res
