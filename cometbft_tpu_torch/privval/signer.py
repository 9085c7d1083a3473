"""Remote signer: validator key isolation in a separate process
(CometBFT's privval/signer_client.go:133, signer_listener_endpoint.go:223,
signer_dialer_endpoint.go, signer_server.go, retry_signer_client.go:96).

Topology matches CometBFT's: the NODE listens on
config.base.priv_validator_laddr (SignerListenerEndpoint); the SIGNER
process dials in (SignerDialerEndpoint) and then serves PubKey/SignVote/
SignProposal requests over that single long-lived connection. The signer
owns the key AND the last-sign-state, so the double-sign guard survives
node crashes and signer restarts alike.

Wire: varint-length-delimited privval Message oneof
(proto/tendermint/privval/types.proto:65) over unix/TCP.

The port's copy of ``cometbft_tpu/privval/signer.py``: the same frames,
error codes and texts.
"""

from __future__ import annotations

import socket
import threading
import time

from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.types.priv_validator import PrivValidator
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import proto as wire

# privval Message oneof field numbers (types.proto:65-76).
PUB_KEY_REQUEST = 1
PUB_KEY_RESPONSE = 2
SIGN_VOTE_REQUEST = 3
SIGNED_VOTE_RESPONSE = 4
SIGN_PROPOSAL_REQUEST = 5
SIGNED_PROPOSAL_RESPONSE = 6
PING_REQUEST = 7
PING_RESPONSE = 8


class RemoteSignerError(Exception):
    def __init__(self, code: int, description: str):
        super().__init__(description)
        self.code = code
        self.description = description


def _enc_signer_error(e: RemoteSignerError | None) -> bytes | None:
    if e is None:
        return None
    return wire.field_varint(1, e.code) + wire.field_string(2, e.description)


def _dec_signer_error(data: bytes) -> RemoteSignerError | None:
    if not data:
        return None
    f = wire.decode_fields(data)
    return RemoteSignerError(wire.get_varint(f, 1), wire.get_string(f, 2))


def _frame(num: int, body: bytes) -> bytes:
    msg = wire.field_message(num, body, emit_empty=True)
    return wire.encode_uvarint(len(msg)) + msg


def _read_frame(rf) -> tuple[int, bytes] | None:
    shift = 0
    length = 0
    while True:
        b = rf.read(1)
        if not b:
            return None
        length |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
        if shift > 35:
            raise ValueError("privval frame length overflow")
    if length > 1 << 20:
        raise ValueError("privval message too large")
    data = b""
    while len(data) < length:
        chunk = rf.read(length - len(data))
        if not chunk:
            raise EOFError("short privval frame")
        data += chunk
    f = wire.decode_fields(data)
    for num in range(1, 9):
        if num in f:
            return num, wire.get_bytes(f, num)
    raise ValueError("empty privval message")


def _enc_pub_key(pub) -> bytes:
    from cometbft_tpu_torch.abci.wire import _enc_pub_key as enc

    return enc(pub)


def _dec_pub_key(data: bytes):
    from cometbft_tpu_torch.abci.wire import _dec_pub_key as dec

    return dec(data)


def _shutdown_close(conn: socket.socket) -> None:
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


# -- node side ----------------------------------------------------------------


class SignerListenerEndpoint:
    """privval/signer_listener_endpoint.go: the node's accept side. Holds at
    most one live signer connection; requests block until one is present (or
    the accept deadline passes)."""

    def __init__(self, laddr: str, accept_timeout: float = 30.0):
        from cometbft_tpu_torch.abci.server import parse_addr

        self.laddr = laddr
        self.accept_timeout = accept_timeout
        scheme, target = parse_addr(laddr)
        if scheme == "unix":
            import os

            if os.path.exists(target):
                os.unlink(target)
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(target)
            self.bound = laddr
        else:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(target)
            self.bound = f"tcp://{target[0]}:{ls.getsockname()[1]}"
        ls.listen(1)
        self._listener = ls
        self._conn: socket.socket | None = None
        self._rf = None
        self._wf = None
        self._mtx = threading.Lock()
        self._have_conn = threading.Condition(self._mtx)
        self._running = True
        self._accept_thread = threads.spawn(self._accept_loop, name="privval-endpoint")

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                if not self._running:
                    return
                # Transient accept failure (ECONNABORTED from a signer that
                # hung up while queued, EMFILE pressure): the endpoint must
                # keep accepting or the validator misses votes until a
                # process restart.
                time.sleep(0.05)
                continue
            # Bound reads on the signer connection: request() holds the
            # endpoint mutex across write+read, and an untimed read on a
            # half-open connection (peer power loss, partition without RST)
            # would hold it forever — blocking this accept loop from ever
            # installing a reconnecting signer.
            conn.settimeout(10.0)
            with self._mtx:
                if not self._running:
                    # A thread parked in accept() keeps the kernel listener
                    # alive past listener.close(), so a redialing signer can
                    # still connect and land HERE after close() — installing
                    # it would strand the signer on a dead endpoint.
                    _shutdown_close(conn)
                    return
                self._drop_conn_locked()
                self._conn = conn
                self._rf = conn.makefile("rb")
                self._wf = conn.makefile("wb")
                self._have_conn.notify_all()

    def close(self) -> None:
        self._running = False
        # shutdown() (inside the helper) wakes a thread parked in accept()
        # (close() alone does not on Linux), so the accept loop exits and
        # the kernel listener actually dies — otherwise a tcp:// endpoint
        # would keep its port bound forever and a same-port re-create would
        # fail with EADDRINUSE.
        _shutdown_close(self._listener)
        with self._mtx:
            self._drop_conn_locked()
            self._have_conn.notify_all()  # wake request() waiters to fail fast

    def _drop_conn_locked(self) -> None:
        if self._conn is not None:
            # shutdown() before close(): the makefile() reader/writer keep
            # the fd alive past close(), so no FIN would reach the signer
            # and it would never notice the endpoint is gone.
            _shutdown_close(self._conn)
        self._conn = None
        self._rf = self._wf = None

    def request(self, num: int, body: bytes) -> tuple[int, bytes]:
        """One request/response exchange; waits for a signer connection."""
        with self._mtx:
            deadline = time.monotonic() + self.accept_timeout
            while self._conn is None:
                if not self._running:
                    raise ConnectionError("signer endpoint closed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("no signer connected")
                self._have_conn.wait(left)
            try:
                self._wf.write(_frame(num, body))
                self._wf.flush()
                out = _read_frame(self._rf)
            except (OSError, EOFError, ValueError) as e:
                self._drop_conn_locked()
                raise ConnectionError(f"signer connection failed: {e}") from e
            if out is None:
                self._drop_conn_locked()
                raise ConnectionError("signer closed the connection")
            return out


class SignerClient(PrivValidator):
    """privval/signer_client.go: PrivValidator over a listener endpoint."""

    def __init__(self, endpoint: SignerListenerEndpoint, chain_id: str = ""):
        self.endpoint = endpoint
        self.chain_id = chain_id

    def ping(self) -> bool:
        num, _ = self.endpoint.request(PING_REQUEST, b"")
        return num == PING_RESPONSE

    def get_pub_key(self):
        num, body = self.endpoint.request(
            PUB_KEY_REQUEST, wire.field_string(1, self.chain_id)
        )
        if num != PUB_KEY_RESPONSE:
            raise RemoteSignerError(0, f"unexpected response {num}")
        f = wire.decode_fields(body)
        err = _dec_signer_error(wire.get_bytes(f, 2))
        if err is not None:
            raise err
        return _dec_pub_key(wire.get_bytes(f, 1))

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        body = wire.field_message(1, vote.encode(), emit_empty=True)
        body += wire.field_string(2, chain_id)
        num, out = self.endpoint.request(SIGN_VOTE_REQUEST, body)
        if num != SIGNED_VOTE_RESPONSE:
            raise RemoteSignerError(0, f"unexpected response {num}")
        f = wire.decode_fields(out)
        err = _dec_signer_error(wire.get_bytes(f, 2))
        if err is not None:
            raise err
        return Vote.decode(wire.get_bytes(f, 1))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        body = wire.field_message(1, proposal.encode(), emit_empty=True)
        body += wire.field_string(2, chain_id)
        num, out = self.endpoint.request(SIGN_PROPOSAL_REQUEST, body)
        if num != SIGNED_PROPOSAL_RESPONSE:
            raise RemoteSignerError(0, f"unexpected response {num}")
        f = wire.decode_fields(out)
        err = _dec_signer_error(wire.get_bytes(f, 2))
        if err is not None:
            raise err
        return Proposal.decode(wire.get_bytes(f, 1))

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def close(self) -> None:
        """Closes the endpoint (Go's node stops its SignerClient service at
        OnStop)."""
        self.endpoint.close()


class RetrySignerClient(PrivValidator):
    """privval/retry_signer_client.go: bounded retries over transient
    endpoint failures (signer restarting, connection mid-flap). Signing
    errors from the signer itself (double-sign guard!) are NOT retried."""

    def __init__(self, client: SignerClient, retries: int = 5, timeout: float = 1.0):
        self.client = client
        self.retries = retries
        self.timeout = timeout

    def _retry(self, fn):
        last = None
        for _ in range(self.retries):
            try:
                return fn()
            except RemoteSignerError:
                raise  # the signer answered: a real refusal, not a flake
            except Exception as e:
                last = e
                time.sleep(self.timeout)
        raise last

    def get_pub_key(self):
        return self._retry(self.client.get_pub_key)

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        return self._retry(lambda: self.client.sign_vote(chain_id, vote))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        return self._retry(lambda: self.client.sign_proposal(chain_id, proposal))

    def address(self) -> bytes:
        return self._retry(self.client.address)

    def close(self) -> None:
        self.client.close()


# -- signer side ---------------------------------------------------------------


class SignerServer:
    """privval/signer_server.go + signer_dialer_endpoint.go: dial the node,
    serve signing requests with the wrapped FilePV. Reconnects with backoff
    until stopped."""

    def __init__(self, node_addr: str, chain_id: str, privval):
        self.node_addr = node_addr
        self.chain_id = chain_id
        self.privval = privval
        self._running = False
        self._thread: threading.Thread | None = None
        self._sock: socket.socket | None = None
        self._stopped = threading.Event()

    def start(self) -> None:
        self._running = True
        self._stopped.clear()
        self._thread = threads.spawn(self._run, name="privval-signer")

    def stop(self) -> None:
        """Ends the serving thread: its connection is shut down, so that no
        request is answered after ``stop()`` (the JAX package's only clears
        a flag, and its thread answers the request it is blocked on)."""
        self._running = False
        self._stopped.set()
        sock = self._sock
        if sock is not None:
            _shutdown_close(sock)
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(5.0)

    def _run(self) -> None:
        from cometbft_tpu_torch.abci.server import parse_addr

        scheme, target = parse_addr(self.node_addr)
        backoff = 0.1
        while self._running:
            try:
                if scheme == "unix":
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                else:
                    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.connect(target)
                backoff = 0.1
                self._sock = s
                if not self._running:
                    s.close()
                    return
                self._serve(s)
            except OSError:
                self._stopped.wait(backoff)
                backoff = min(backoff * 2, 5.0)
            finally:
                self._sock = None

    def _serve(self, s: socket.socket) -> None:
        rf = s.makefile("rb")
        wf = s.makefile("wb")
        try:
            while self._running:
                out = _read_frame(rf)
                if out is None:
                    return
                num, body = out
                wf.write(self._handle(num, body))
                wf.flush()
        except (OSError, EOFError, ValueError):
            pass
        finally:
            try:
                s.close()
            except OSError:
                pass

    def _handle(self, num: int, body: bytes) -> bytes:
        if num == PING_REQUEST:
            return _frame(PING_RESPONSE, b"")
        if num == PUB_KEY_REQUEST:
            resp = wire.field_message(
                1, _enc_pub_key(self.privval.get_pub_key()), emit_empty=True
            )
            return _frame(PUB_KEY_RESPONSE, resp)
        if num == SIGN_VOTE_REQUEST:
            f = wire.decode_fields(body)
            chain_id = wire.get_string(f, 2)
            try:
                vote = Vote.decode(wire.get_bytes(f, 1))
                signed = self.privval.sign_vote(chain_id, vote)
                resp = wire.field_message(1, signed.encode(), emit_empty=True)
            except Exception as e:
                resp = wire.field_message(
                    2, _enc_signer_error(RemoteSignerError(2, str(e))), emit_empty=True
                )
            return _frame(SIGNED_VOTE_RESPONSE, resp)
        if num == SIGN_PROPOSAL_REQUEST:
            f = wire.decode_fields(body)
            chain_id = wire.get_string(f, 2)
            try:
                proposal = Proposal.decode(wire.get_bytes(f, 1))
                signed = self.privval.sign_proposal(chain_id, proposal)
                resp = wire.field_message(1, signed.encode(), emit_empty=True)
            except Exception as e:
                resp = wire.field_message(
                    2, _enc_signer_error(RemoteSignerError(2, str(e))), emit_empty=True
                )
            return _frame(SIGNED_PROPOSAL_RESPONSE, resp)
        return _frame(
            PUB_KEY_RESPONSE,
            wire.field_message(
                2,
                _enc_signer_error(RemoteSignerError(1, f"unexpected request {num}")),
                emit_empty=True,
            ),
        )


def main(argv=None) -> int:
    """`python -m cometbft_tpu_torch.privval.signer`: the external signer daemon."""
    import argparse

    from cometbft_tpu_torch.privval.file import FilePV

    p = argparse.ArgumentParser(prog="cometbft_tpu_torch.privval.signer")
    p.add_argument("--addr", required=True, help="node's priv_validator_laddr to dial")
    p.add_argument("--chain-id", required=True)
    p.add_argument("--key-file", required=True)
    p.add_argument("--state-file", required=True)
    args = p.parse_args(argv)
    pv = FilePV.load_or_generate(args.key_file, args.state_file)
    srv = SignerServer(args.addr, args.chain_id, pv)
    srv.start()
    print(f"remote signer serving {args.addr}", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
