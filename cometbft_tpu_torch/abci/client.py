"""ABCI clients (abci/client/ in CometBFT), the port's copy of the local
transport of ``cometbft_tpu/abci/client.py``.

LocalClient mirrors abci/client/local_client.go:356 — in-process calls to
the Application behind one shared mutex (the application sees requests from
the four logical connections serialized exactly as in CometBFT). The socket
and gRPC transports are not ported yet.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.abci import types as abci


class Client:
    """Sync client surface used by proxy.AppConns."""

    def echo(self, msg: str) -> abci.ResponseEcho:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        raise NotImplementedError

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        raise NotImplementedError

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        raise NotImplementedError

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        raise NotImplementedError

    def check_tx_async(self, req: abci.RequestCheckTx, callback=None):
        """Async CheckTx (mempool pipeline). The local client executes
        inline and invokes the callback synchronously — same observable
        ordering as local_client.go's CheckTxAsync."""
        raise NotImplementedError

    def begin_block(self, req: abci.RequestBeginBlock) -> abci.ResponseBeginBlock:
        raise NotImplementedError

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        raise NotImplementedError

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        raise NotImplementedError

    def commit(self) -> abci.ResponseCommit:
        raise NotImplementedError

    def prepare_proposal(self, req: abci.RequestPrepareProposal) -> abci.ResponsePrepareProposal:
        raise NotImplementedError

    def process_proposal(self, req: abci.RequestProcessProposal) -> abci.ResponseProcessProposal:
        raise NotImplementedError

    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        raise NotImplementedError


class LocalClient(Client):
    """abci/client/local_client.go: shared-mutex in-process client."""

    def __init__(self, app: abci.Application, mtx: threading.RLock | None = None):
        self._app = app
        self._mtx = mtx or threading.RLock()

    def echo(self, msg: str) -> abci.ResponseEcho:
        return abci.ResponseEcho(message=msg)

    def flush(self) -> None:
        return None

    def info(self, req):
        with self._mtx:
            return self._app.info(req)

    def init_chain(self, req):
        with self._mtx:
            return self._app.init_chain(req)

    def query(self, req):
        with self._mtx:
            return self._app.query(req)

    def check_tx(self, req):
        with self._mtx:
            return self._app.check_tx(req)

    def check_tx_async(self, req, callback=None):
        with self._mtx:
            res = self._app.check_tx(req)
        if callback is not None:
            callback(res)
        return res

    def begin_block(self, req):
        with self._mtx:
            return self._app.begin_block(req)

    def deliver_tx(self, req):
        with self._mtx:
            return self._app.deliver_tx(req)

    def end_block(self, req):
        with self._mtx:
            return self._app.end_block(req)

    def commit(self):
        with self._mtx:
            return self._app.commit()

    def prepare_proposal(self, req):
        with self._mtx:
            return self._app.prepare_proposal(req)

    def process_proposal(self, req):
        with self._mtx:
            return self._app.process_proposal(req)

    def list_snapshots(self, req):
        with self._mtx:
            return self._app.list_snapshots(req)

    def offer_snapshot(self, req):
        with self._mtx:
            return self._app.offer_snapshot(req)

    def load_snapshot_chunk(self, req):
        with self._mtx:
            return self._app.load_snapshot_chunk(req)

    def apply_snapshot_chunk(self, req):
        with self._mtx:
            return self._app.apply_snapshot_chunk(req)


class ClientCreator:
    """proxy.ClientCreator (proxy/client.go): builds clients per connection."""

    def new_abci_client(self) -> Client:
        raise NotImplementedError


class LocalClientCreator(ClientCreator):
    """One shared mutex across all four connections (proxy/client.go
    NewLocalClientCreator)."""

    def __init__(self, app: abci.Application):
        self._app = app
        self._mtx = threading.RLock()

    def new_abci_client(self) -> Client:
        return LocalClient(self._app, self._mtx)
