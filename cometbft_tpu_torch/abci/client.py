"""ABCI clients (abci/client/ in CometBFT), the port's copy of
``cometbft_tpu/abci/client.py``.

LocalClient mirrors abci/client/local_client.go:356 — in-process calls to
the Application behind one shared mutex (the application sees requests from
the four logical connections serialized exactly as in CometBFT).
SocketClient is the socket transport (abci/client/socket_client.go); the
gRPC one is ``abci/grpc.py``, which alone imports ``grpc``.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import threads


class AsyncCheckTxMixin:
    """Single-dispatch-thread CheckTxAsync, shared by the remote transports
    (socket, grpc): preserves the mempool's pipelined ordering, and a failed
    CheckTx must NOT kill the dispatch thread — the mempool would silently
    stop admitting txs forever. Transports implement _do_check_tx(req) and
    call _start_async()/_stop_async() around their connection lifetime."""

    def _start_async(self, name: str) -> None:
        self._async_queue: list = []
        self._async_cv = threading.Condition()
        self._async_running = True
        # In the caller's thread group: a node's stop() joins it.
        threads.spawn(self._async_loop, name=name)

    def _stop_async(self) -> None:
        self._async_running = False
        with self._async_cv:
            self._async_cv.notify_all()

    def _do_check_tx(self, req) -> "abci.ResponseCheckTx":
        raise NotImplementedError

    def _async_error_response(self, e: Exception) -> "abci.ResponseCheckTx":
        return abci.ResponseCheckTx(code=1, log=f"abci transport error: {e}")

    def check_tx_async(self, req, callback=None):
        with self._async_cv:
            self._async_queue.append((req, callback))
            self._async_cv.notify()

    def _async_loop(self) -> None:
        while self._async_running:
            with self._async_cv:
                while self._async_running and not self._async_queue:
                    self._async_cv.wait()
                if not self._async_running:
                    return
                req, callback = self._async_queue.pop(0)
            try:
                res = self._do_check_tx(req)
            except Exception as e:
                res = self._async_error_response(e)
            if callback is not None:
                try:
                    callback(res)
                except Exception:
                    pass


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


class SocketClient(AsyncCheckTxMixin, Client):
    """abci/client/socket_client.go over the gogoproto-framed stream, in
    synchronous form: the node's four proxy connections each own one
    SocketClient, every call writes Request+Flush and reads Response+Flush
    under the connection lock — the observable per-connection ordering of
    Go's send/receive goroutine pair, without the pending queue
    (callers here block on the result anyway). CheckTxAsync keeps the
    mempool's pipelined ordering with a single dispatch thread."""

    def __init__(self, addr: str, connect_timeout: float = 10.0):
        import socket as socketlib
        import time

        from cometbft_tpu_torch.abci.server import parse_addr

        scheme, target = parse_addr(addr)
        deadline = time.monotonic() + connect_timeout
        last_err = None
        while time.monotonic() < deadline:
            try:
                if scheme == "unix":
                    s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
                else:
                    s = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
                s.connect(target)
                break
            except OSError as e:  # app process may still be booting
                last_err = e
                time.sleep(0.05)
        else:
            raise ConnectionError(f"cannot connect to ABCI app at {addr}: {last_err}")
        if scheme == "tcp":
            s.setsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY, 1)
        self._sock = s
        self._rf = s.makefile("rb")
        self._wf = s.makefile("wb")
        self._mtx = threading.Lock()
        self._start_async("abci-socket-async")

    def close(self) -> None:
        self._stop_async()
        try:
            self._sock.close()
        except OSError:
            pass

    def _call(self, req):
        from cometbft_tpu_torch.abci import wire as abci_wire

        with self._mtx:
            abci_wire.write_message(self._wf, abci_wire.encode_request(req))
            abci_wire.write_message(
                self._wf, abci_wire.encode_request(abci.RequestFlush())
            )
            self._wf.flush()
            data = abci_wire.read_message(self._rf)
            if data is None:
                raise ConnectionError("ABCI app closed the connection")
            resp = abci_wire.decode_response(data)
            flush = abci_wire.read_message(self._rf)
            if flush is None:
                raise ConnectionError("ABCI app closed the connection mid-flush")
        if isinstance(resp, abci.ResponseException):
            raise RuntimeError(f"ABCI app exception: {resp.error}")
        return resp

    def _do_check_tx(self, req):
        return self._call(req)

    def echo(self, msg: str):
        return self._call(abci.RequestEcho(message=msg))

    def flush(self) -> None:
        self._call(abci.RequestFlush())

    def info(self, req):
        return self._call(req)

    def init_chain(self, req):
        return self._call(req)

    def query(self, req):
        return self._call(req)

    def check_tx(self, req):
        return self._call(req)

    def begin_block(self, req):
        return self._call(req)

    def deliver_tx(self, req):
        return self._call(req)

    def end_block(self, req):
        return self._call(req)

    def commit(self):
        return self._call(abci.RequestCommit())

    def prepare_proposal(self, req):
        return self._call(req)

    def process_proposal(self, req):
        return self._call(req)

    def list_snapshots(self, req):
        return self._call(req)

    def offer_snapshot(self, req):
        return self._call(req)

    def load_snapshot_chunk(self, req):
        return self._call(req)

    def apply_snapshot_chunk(self, req):
        return self._call(req)


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


class SocketClientCreator(ClientCreator):
    """proxy/client.go NewRemoteClientCreator: one fresh socket connection
    per logical app connection."""

    def __init__(self, addr: str):
        self._addr = addr

    def new_abci_client(self) -> Client:
        return SocketClient(self._addr)
