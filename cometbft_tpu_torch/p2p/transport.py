"""TCP transport: listen/dial + handshake (p2p/transport.go
MultiplexTransport), the port's copy of ``cometbft_tpu/p2p/transport.py``.

Connection upgrade: TCP → SecretConnection (authenticated encryption) →
NodeInfo exchange (length-delimited proto) → compatibility filtering.

A close that raised is counted (``close_errors``, ``last_close_error``); the
reference passes over it.
"""

from __future__ import annotations

import socket

from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.key import NodeKey, node_id_from_pub_key
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.wire import proto as wire

HANDSHAKE_TIMEOUT = 20.0
DIAL_TIMEOUT = 3.0


class TransportError(Exception):
    pass


class UpgradedConn:
    """A fully-handshaken connection ready for MConnection."""

    def __init__(self, secret_conn: SecretConnection, node_info: NodeInfo, outbound: bool, remote_addr: str):
        self.conn = secret_conn
        self.node_info = node_info
        self.outbound = outbound
        self.remote_addr = remote_addr

    @property
    def peer_id(self) -> str:
        return node_id_from_pub_key(self.conn.rem_pub_key)


class MultiplexTransport:
    """p2p/transport.go."""

    def __init__(self, node_info: NodeInfo, node_key: NodeKey, fuzz_config=None):
        self.fuzz_config = fuzz_config
        self.node_info = node_info
        self.node_key = node_key
        self._listener: socket.socket | None = None
        self._accept_cb = None
        self._running = False
        self.close_errors = 0
        self.last_close_error = None

    # -- listening ------------------------------------------------------------

    def listen(self, addr: str, accept_cb) -> str:
        """Start accepting; accept_cb(UpgradedConn | Exception)."""
        host, port = _split_addr(addr)
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.5)
        actual = f"{host}:{self._listener.getsockname()[1]}"
        self.node_info.listen_addr = actual
        self._accept_cb = accept_cb
        self._running = True
        threads.spawn(self._accept_loop)
        return actual

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threads.spawn(self._upgrade_inbound, (sock, addr))

    def _upgrade_inbound(self, sock: socket.socket, addr) -> None:
        try:
            up = self._upgrade(sock, outbound=False, remote=f"{addr[0]}:{addr[1]}")
            self._accept_cb(up)
        except Exception as e:
            try:
                sock.close()
            except Exception as close_err:
                self._close_failed(close_err)
            self._accept_cb(e)

    # -- dialing --------------------------------------------------------------

    def dial(self, addr: str, expected_id: str = "") -> UpgradedConn:
        host, port = _split_addr(addr)
        sock = socket.create_connection((host, port), timeout=DIAL_TIMEOUT)
        sock.settimeout(HANDSHAKE_TIMEOUT)
        up = self._upgrade(sock, outbound=True, remote=f"{host}:{port}")
        if expected_id and up.peer_id != expected_id:
            up.conn.close()
            raise TransportError(
                f"conn.ID ({up.peer_id}) dialed ID ({expected_id}) mismatch"
            )
        return up

    # -- upgrade pipeline (transport.go upgrade) ------------------------------

    def _upgrade(self, sock: socket.socket, outbound: bool, remote: str) -> UpgradedConn:
        sc = SecretConnection(sock, self.node_key.priv_key)
        # Fuzzing wraps AFTER the secret handshake (documented deviation
        # from fuzz.go's raw-conn wrap: with drop-mode probabilities the
        # handshake itself would rarely complete; the churn under test is
        # the message layer + reconnect machinery).
        # NodeInfo swap: length-delimited (transport.go handshake).
        sc.write(wire.length_delimited(self.node_info.encode()))
        their_info = _read_delimited_node_info(sc)
        their_info.validate_basic()
        self.node_info.compatible_with(their_info)
        # The authenticated key must match the claimed node ID (transport.go).
        authed_id = node_id_from_pub_key(sc.rem_pub_key)
        if their_info.node_id != authed_id:
            raise TransportError(
                f"nodeInfo.ID ({their_info.node_id}) doesn't match authenticated key ({authed_id})"
            )
        sock.settimeout(None)
        if self.fuzz_config is not None:
            from cometbft_tpu_torch.p2p.fuzz import FuzzedConn

            sc = FuzzedConn(sc, self.fuzz_config)
        return UpgradedConn(sc, their_info, outbound, remote)

    def close(self) -> None:
        self._running = False
        if self._listener:
            try:
                self._listener.close()
            except Exception as e:
                self._close_failed(e)

    def _close_failed(self, e: Exception) -> None:
        self.close_errors += 1
        self.last_close_error = e


def _read_delimited_node_info(sc: SecretConnection) -> NodeInfo:
    buf = sc.read(1024)
    ln, pos = wire.decode_uvarint(buf, 0)
    while len(buf) - pos < ln:
        buf += sc.read(1024)
    return NodeInfo.decode(buf[pos : pos + ln])


def _split_addr(addr: str) -> tuple[str, int]:
    addr = addr.split("://", 1)[-1]
    if "@" in addr:
        addr = addr.split("@", 1)[1]
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)
