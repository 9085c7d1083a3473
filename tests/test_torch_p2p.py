"""The port's p2p layer (``libs/flowrate``, ``crypto/{strobe,merlin,compat}``,
``p2p/{key,node_info,fuzz,transport,switch}``, ``p2p/conn/{secret_connection,
recvq,connection}``, ``config.P2PConfig``) against the JAX package's.

- Strobe and merlin transcripts byte-identical to the reference's on
  ``tests/test_merlin.py``'s vectors and on seeded inputs; X25519 and
  ChaCha20-Poly1305 equal to the reference's under the ``libcrypto`` and the
  forced pure tier (each package's shim loaded with the ``cryptography``
  wheel hidden), and to RFC 8439's vector.
- ``derive_secrets_and_challenge`` equal to the reference's in both roles.
- Over a socketpair, a port ``SecretConnection`` handshakes with a
  reference one in both roles, and each refuses a tampered frame; a port
  ``MConnection`` and a reference one exchange messages on several
  channels, each channel in order; the receive demux's DRR order on one
  sequence equals the reference's.
- A port ``Switch`` and a reference ``Switch`` connect over 127.0.0.1 TCP
  in both directions, and a network mismatch is refused (and counted on
  the listening port switch).
- Each exception the port counts where the reference passes over it is
  planted and counted.

Every socket test has its own timeout; nothing asserts a wall-clock time."""

from __future__ import annotations

import dataclasses
import importlib.util
import random
import socket
import sys
import threading
import time

import pytest

from cometbft_tpu.config.config import P2PConfig as RefP2PConfig
from cometbft_tpu.crypto import compat as ref_compat
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import merlin as ref_merlin
from cometbft_tpu.crypto import strobe as ref_strobe
from cometbft_tpu.libs import flowrate as ref_flowrate
from cometbft_tpu.p2p import fuzz as ref_fuzz
from cometbft_tpu.p2p.conn import connection as ref_conn
from cometbft_tpu.p2p.conn import recvq as ref_recvq
from cometbft_tpu.p2p.conn import secret_connection as ref_sc
from cometbft_tpu.p2p.key import NodeKey as RefNodeKey
from cometbft_tpu.p2p.node_info import NodeInfo as RefNodeInfo
from cometbft_tpu.p2p.reactor import Reactor as RefReactor
from cometbft_tpu.p2p.switch import Switch as RefSwitch
from cometbft_tpu.p2p.transport import MultiplexTransport as RefTransport
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.config import P2PConfig
from cometbft_tpu_torch.crypto import compat, ed25519, merlin, strobe
from cometbft_tpu_torch.libs import flowrate
from cometbft_tpu_torch.p2p import fuzz
from cometbft_tpu_torch.p2p.conn import connection, recvq
from cometbft_tpu_torch.p2p.conn import secret_connection as sc
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.reactor import ChannelDescriptor, Reactor
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import MultiplexTransport

pytestmark = pytest.mark.torch_port

SOCKET_TIMEOUT = 20.0


# -- strobe and merlin --------------------------------------------------------


def _sha3_256(keccak, msg: bytes) -> bytes:
    rate = 136
    st = bytearray(200)
    padded = bytearray(msg) + b"\x06"
    while len(padded) % rate:
        padded.append(0)
    padded[-1] |= 0x80
    for i in range(0, len(padded), rate):
        for j in range(rate):
            st[j] ^= padded[i + j]
        keccak(st)
    return bytes(st[:32])


def test_keccak_equals_the_reference_and_sha3():
    import hashlib

    rng = random.Random(3)
    for m in (b"", b"abc", b"x" * 135, b"y" * 136, b"z" * 137, bytes(rng.randbytes(1000))):
        assert _sha3_256(strobe.keccak_f1600, m) == _sha3_256(ref_strobe.keccak_f1600, m) \
            == hashlib.sha3_256(m).digest()


def _transcript_ops(mod, rng_seed: int) -> list:
    """One transcript's outputs under a seeded mix of operations."""
    rng = random.Random(rng_seed)
    t = mod.Transcript(b"proto-%d" % rng_seed)
    out = []
    for _ in range(12):
        op = rng.randrange(4)
        if op == 0:
            t.append_message(rng.randbytes(rng.randrange(1, 20)), rng.randbytes(rng.randrange(0, 400)))
        elif op == 1:
            t.append_u64(b"u64", rng.getrandbits(64))
        elif op == 2:
            out.append(t.challenge_bytes(b"c", rng.randrange(1, 200)))
        else:
            c = t.clone()
            out.append(c.extract_bytes(b"clone", 32))
    rng_out = t.build_rng().rekey_with_witness_bytes(b"w", b"witness" * 9).finalize(
        bytes(range(32))).fill_bytes(64)
    return out + [rng_out]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_merlin_transcripts_equal_the_reference(seed):
    assert _transcript_ops(merlin, seed) == _transcript_ops(ref_merlin, seed)


def test_merlin_vectors():
    """merlin.rs equivalence_simple, the handshake's transcript, and the
    split absorb across the STROBE rate (tests/test_merlin.py)."""
    t = merlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    hs = []
    for mod in (merlin, ref_merlin):
        t = mod.Transcript(b"TENDERMINT_SECRET_CONNECTION_TRANSCRIPT_HASH")
        t.append_message(b"EPHEMERAL_LOWER_PUBLIC_KEY", b"\x01" * 32)
        t.append_message(b"EPHEMERAL_UPPER_PUBLIC_KEY", b"\x02" * 32)
        t.append_message(b"DH_SECRET", b"\x03" * 32)
        hs.append(t.extract_bytes(b"SECRET_CONNECTION_MAC", 32))
    assert hs[0] == hs[1]
    outs = []
    for mod in (strobe, ref_strobe):
        s = mod.Strobe128(b"big")
        s.ad(b"q" * 200, False)
        s.ad(b"q" * 300, True)
        s2 = mod.Strobe128(b"big")
        s2.ad(b"q" * 500, False)
        outs.append((s.prf(32), s2.prf(32)))
    assert outs[0] == outs[1] and outs[0][0] == outs[0][1]


# -- the AEAD and X25519 tiers ------------------------------------------------

_KEY = bytes(range(0x80, 0xA0))
_NONCE = bytes.fromhex("070000004041424344454647")
_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
       b"only one tip for the future, sunscreen would be it.")
_CT_TAG = bytes.fromhex(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
    "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
    "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
    "3ff4def08e4b7a9de576d26586cec64b6116" "1ae10b594f09e26a7e902ecbd0600691")


def _shim_without_wheel(module, pure: bool, monkeypatch):
    """A fresh copy of a package's ``crypto/compat.py`` loaded with the
    ``cryptography`` wheel hidden, so that its ``libcrypto`` tier (or, with
    ``pure``, its RFC 8439 tier) is the one it picks."""
    for name in list(sys.modules):
        if name == "cryptography" or name.startswith("cryptography."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    if pure:
        monkeypatch.setenv("CMTPU_PURE_AEAD", "1")
    else:
        monkeypatch.delenv("CMTPU_PURE_AEAD", raising=False)
    spec = importlib.util.spec_from_file_location(f"_shim_{id(module)}_{pure}", module.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wheel_answers():
    """Seeded AEAD, X25519 and Ed25519 cases with the reference's answers
    through the ``cryptography`` wheel (taken before any shim hides it)."""
    rng = random.Random(7)
    aead = []
    for n in (0, 1, 15, 16, 17, 1028, 3000):
        key, nonce, msg, aad = rng.randbytes(32), rng.randbytes(12), rng.randbytes(n), rng.randbytes(n % 13)
        aead.append((key, nonce, msg, aad, ref_compat.ChaCha20Poly1305(key).encrypt(nonce, msg, aad)))
    x = []
    for _ in range(4):
        a, b = rng.randbytes(32), rng.randbytes(32)
        ra = ref_compat.X25519PrivateKey.from_private_bytes(a)
        pub_b = ref_compat.X25519PrivateKey.from_private_bytes(b).public_key()
        x.append((a, pub_b.public_bytes_raw(), ra.public_key().public_bytes_raw(), ra.exchange(pub_b)))
    seed = rng.randbytes(32)
    sig = ref_compat.Ed25519PrivateKey.from_private_bytes(seed).sign(b"msg")
    assert ref_compat.ChaCha20Poly1305(_KEY).decrypt(_NONCE, _CT_TAG, _AAD) == _PT
    return aead, x, (seed, sig)


@pytest.mark.parametrize("tier", ["libcrypto", "pure"])
def test_aead_and_x25519_equal_the_reference(tier, monkeypatch):
    aead, x, (seed, sig) = _wheel_answers()
    port = _shim_without_wheel(compat, tier == "pure", monkeypatch)
    ref = _shim_without_wheel(ref_compat, tier == "pure", monkeypatch)
    assert port.AEAD_PROVIDER == ref.AEAD_PROVIDER == tier
    assert not port.HAVE_CRYPTOGRAPHY
    assert port.ChaCha20Poly1305(_KEY).encrypt(_NONCE, _PT, _AAD) == _CT_TAG
    for key, nonce, msg, aad, want in aead:
        sealed = port.ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
        assert sealed == ref.ChaCha20Poly1305(key).encrypt(nonce, msg, aad) == want
        assert port.ChaCha20Poly1305(key).decrypt(nonce, sealed, aad) == msg
        bad = sealed[:-1] + bytes([sealed[-1] ^ 1])
        with pytest.raises(port.InvalidTag):
            port.ChaCha20Poly1305(key).decrypt(nonce, bad, aad)
    for a, pub_b, pub_a, shared in x:
        pa = port.X25519PrivateKey.from_private_bytes(a)
        assert pa.public_key().public_bytes_raw() == pub_a
        assert pa.exchange(port.X25519PublicKey.from_public_bytes(pub_b)) == shared
    signer = port.Ed25519PrivateKey.from_private_bytes(seed)
    assert signer.sign(b"msg") == sig
    signer.public_key().verify(sig, b"msg")
    with pytest.raises(port.InvalidSignature):
        signer.public_key().verify(sig, b"msh")


def test_derive_secrets_and_challenge_equals_the_reference():
    rng = random.Random(11)
    for _ in range(16):
        secret = rng.randbytes(32)
        for least in (True, False):
            assert sc.derive_secrets_and_challenge(secret, least) == \
                ref_sc.derive_secrets_and_challenge(secret, least)
    recv_lo, send_lo, chal = sc.derive_secrets_and_challenge(bytes(range(32)), True)
    assert sc.derive_secrets_and_challenge(bytes(range(32)), False) == (send_lo, recv_lo, chal)


# -- SecretConnection across the packages -------------------------------------


def _handshake_pair(port_first: bool):
    """A port and a reference SecretConnection over one socketpair; returns
    (port_conn, ref_conn, port_key, ref_key)."""
    a, b = socket.socketpair()
    for s in (a, b):
        s.settimeout(SOCKET_TIMEOUT)
    pk, rk = ed25519.gen_priv_key_from_secret(b"port"), ref_ed.gen_priv_key_from_secret(b"ref")
    out = {}

    def other():
        out["ref" if port_first else "port"] = (ref_sc.SecretConnection(b, rk) if port_first
                                                else sc.SecretConnection(b, pk))

    t = threading.Thread(target=other, daemon=True)
    t.start()
    if port_first:
        out["port"] = sc.SecretConnection(a, pk)
    else:
        out["ref"] = ref_sc.SecretConnection(a, rk)
    t.join(SOCKET_TIMEOUT)
    assert not t.is_alive()
    return out["port"], out["ref"], pk, rk


@pytest.mark.parametrize("port_first", [True, False])
def test_secret_connection_talks_to_the_reference(port_first):
    pc, rc, pk, rk = _handshake_pair(port_first)
    try:
        assert pc.rem_pub_key.bytes() == rk.pub_key().bytes()
        assert rc.rem_pub_key.bytes() == pk.pub_key().bytes()
        assert pc.handshake_ms > 0 and pc.frames_sent == pc.frames_recv == 1  # the AuthSig
        big = bytes(range(256)) * 20
        pc.write(b"hello" + big)
        assert rc.read_exact(5 + len(big)) == b"hello" + big
        rc.write(big[::-1])
        assert pc.read_exact(len(big)) == big[::-1]
        assert pc.frames_sent == 1 + 6 and pc.frames_recv == 1 + 5
    finally:
        pc.close()
        rc.close()
    assert pc.close_errors == 0


@pytest.mark.parametrize("tamper_port", [True, False])
def test_each_side_refuses_a_tampered_frame(tamper_port):
    pc, rc, _, _ = _handshake_pair(True)
    writer, reader, err = (pc, rc, ref_sc.SecretConnectionError) if tamper_port else \
        (rc, pc, sc.SecretConnectionError)
    raw = writer._write_raw

    def flip(data):
        raw(data[:100] + bytes([data[100] ^ 0x04]) + data[101:])

    writer._write_raw = flip
    try:
        writer.write(b"tampered frame")
        with pytest.raises(err, match="failed to decrypt frame"):
            reader.read()
    finally:
        pc.close()
        rc.close()


# -- MConnection across the packages ------------------------------------------

CHANNELS = ((0x20, 6), (0x21, 10), (0x22, 7), (0x30, 5), (0x40, 5))


def test_mconnection_talks_to_the_reference_in_order():
    pc, rc, _, _ = _handshake_pair(False)
    got = {"port": [], "ref": []}
    done = {k: threading.Event() for k in got}
    errors = []
    rng = random.Random(5)
    msgs = [(CHANNELS[rng.randrange(len(CHANNELS))][0], rng.randbytes(rng.choice((1, 40, 1023, 1024, 1025, 5000))))
            for _ in range(60)]

    def on_receive(side):
        def f(ch, msg):
            got[side].append((ch, msg))
            if len(got[side]) == len(msgs):
                done[side].set()
        return f

    pm = connection.MConnection(pc, [ChannelDescriptor(c, p) for c, p in CHANNELS],
                                on_receive("port"), errors.append)
    rm = ref_conn.MConnection(rc, [ref_conn.ChannelDescriptor(c, p) for c, p in CHANNELS],
                              on_receive("ref"), errors.append)
    pm.start()
    rm.start()
    try:
        for ch, m in msgs:
            assert pm.send(ch, m) and rm.send(ch, m[::-1])
        for side in got:
            assert done[side].wait(SOCKET_TIMEOUT), (side, len(got[side]))
        for c, _ in CHANNELS:
            want = [m for ch, m in msgs if ch == c]
            assert [m for ch, m in got["ref"] if ch == c] == want
            assert [m for ch, m in got["port"] if ch == c] == [m[::-1] for m in want]
        assert not errors
        assert pm.send_monitor.status()["bytes"] == rm.recv_monitor.status()["bytes"] > 0
        st = pm.recvq_stats()
        assert st["delivered_total"] == len(msgs) and st["shed_total"] == 0
        assert set(st) == set(rm.recvq_stats())
    finally:
        pm.stop()
        rm.stop()
    assert pm.close_errors == 0


class _StepClock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


@pytest.mark.parametrize("starve", [False, True])
def test_recvq_drr_order_equals_the_reference(starve):
    rng = random.Random(21)
    chans = [0x00, 0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40, 0x60]
    seq = [(rng.choice(chans), b"m%d" % i, rng.random() * 0.3) for i in range(300)]
    orders = []
    for mod in (recvq, ref_recvq):
        clock = _StepClock()
        out = []
        q = mod.RecvQueues(lambda ch, m: out.append((ch, m)), chans, clock=clock, max_depth=10_000,
                           starvation_ms=100.0 if starve else 1e9, quanta=(8, 4, 2, 1))
        for ch, m, t in sorted(seq, key=lambda x: x[2]):
            clock.t = t
            assert q.push(ch, m)
        clock.t = 0.35
        with q._cv:
            while True:
                item = q._select_locked()
                if item is None:
                    break
                q._depth -= 1
                out.append((item[0], item[1], item[3]))
        orders.append(out)
    assert orders[0] == orders[1] and len(orders[0]) == len(seq)
    assert any(p for *_, p in orders[0]) == starve


def test_recvq_knobs_and_classes_equal_the_reference(monkeypatch):
    for ch in range(256):
        assert recvq.classify(ch) == ref_recvq.classify(ch)
    for raw in ("", "1,1,1,1", "3,2,x,1", "9,9"):
        monkeypatch.setenv("CMTPU_RECVQ_QUANTA", raw)
        assert recvq._env_quanta() == ref_recvq._env_quanta()
    for raw in ("0", "off", "1", "FALSE", "yes"):
        monkeypatch.setenv("CMTPU_RECVQ", raw)
        assert recvq.enabled() == ref_recvq.enabled()


# -- the Switch across the packages -------------------------------------------


class _Echo:
    def __init__(self):
        self.received = []
        self.event = threading.Event()

    def get_channels(self):
        return [self.desc(0x77, 1)]

    def receive(self, chan_id, peer, msg):
        self.received.append((peer.id, msg))
        self.event.set()


class PortEcho(_Echo, Reactor):
    desc = ChannelDescriptor

    def __init__(self):
        Reactor.__init__(self, "echo")
        _Echo.__init__(self)


class RefEcho(_Echo, RefReactor):
    desc = ref_conn.ChannelDescriptor

    def __init__(self):
        RefReactor.__init__(self, "echo")
        _Echo.__init__(self)


def _switch(port: bool, network: str, name: str):
    if port:
        nk = NodeKey()
        ni = NodeInfo(node_id=nk.id, network=network, moniker=name)
        sw = Switch(ni, MultiplexTransport(ni, nk))
        r = PortEcho()
    else:
        nk = RefNodeKey()
        ni = RefNodeInfo(node_id=nk.id, network=network, moniker=name)
        sw = RefSwitch(ni, RefTransport(ni, nk))
        r = RefEcho()
    sw.add_reactor("echo", r)
    return sw, nk, r


def _wait(cond, timeout=SOCKET_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize("port_dials", [True, False])
def test_switch_connects_to_the_reference_over_tcp(port_dials):
    dialer, _, rd = _switch(port_dials, "p2p-test", "dialer")
    listener, nk_l, rl = _switch(not port_dials, "p2p-test", "listener")
    addr = listener.start("127.0.0.1:0")
    dialer.start("")
    try:
        peer = dialer.dial_peer(f"{nk_l.id}@{addr}")
        assert peer is not None and peer.id == nk_l.id
        assert _wait(lambda: listener.num_peers() == 1)
        assert peer.send(0x77, b"gossip-1")
        assert rl.event.wait(SOCKET_TIMEOUT) and rl.received[0][1] == b"gossip-1"
        listener.broadcast(0x77, b"reply")
        assert rd.event.wait(SOCKET_TIMEOUT) and rd.received[0][1] == b"reply"
        port_sw = dialer if port_dials else listener
        assert port_sw.errors() == {"inbound_errors": 0, "redial_errors": 0, "recvq_errors": 0,
                                    "peer_errors": 0}
        assert port_sw.recvq_stats()["delivered_total"] == 1
        assert port_sw.node_info.channels == bytes([0x77])
        info = port_sw.peers()[0].node_info
        assert info.encode() == (listener if port_dials else dialer).node_info.encode()
    finally:
        dialer.stop()
        listener.stop()


@pytest.mark.parametrize("port_dials", [True, False])
def test_network_mismatch_is_refused(port_dials):
    dialer, _, _ = _switch(port_dials, "chain-A", "dialer")
    listener, nk_l, _ = _switch(not port_dials, "chain-B", "listener")
    addr = listener.start("127.0.0.1:0")
    dialer.start("")
    try:
        with pytest.raises(ValueError, match="different network"):
            dialer.dial_peer(f"{nk_l.id}@{addr}")
        assert dialer.num_peers() == 0
        if not port_dials:  # the listening port switch counts the refused upgrade
            assert _wait(lambda: listener.inbound_errors == 1)
            assert "different network" in str(listener.last_inbound_error)
            assert listener.num_peers() == 0
    finally:
        dialer.stop()
        listener.stop()


def test_switch_hands_its_p2p_config_to_each_connection():
    cfg = P2PConfig(max_packet_msg_payload_size=64, send_rate=1_000_000, recv_rate=2_000_000)
    nk = NodeKey()
    ni = NodeInfo(node_id=nk.id, network="p2p-test", moniker="dialer")
    dialer = Switch(ni, MultiplexTransport(ni, nk), config=cfg)
    dialer.add_reactor("echo", PortEcho())
    listener, nk_l, rl = _switch(False, "p2p-test", "listener")
    addr = listener.start("127.0.0.1:0")
    dialer.start("")
    try:
        peer = dialer.dial_peer(f"{nk_l.id}@{addr}")
        m = peer.mconn
        assert (m.max_payload, m._send_rate, m._recv_rate) == (64, 1_000_000, 2_000_000)
        msg = bytes(range(256)) * 4  # sixteen packets of 64 bytes
        assert peer.send(0x77, msg)
        assert rl.event.wait(SOCKET_TIMEOUT) and rl.received[0][1] == msg
        assert Switch(ni, MultiplexTransport(ni, nk)).config == P2PConfig()
    finally:
        dialer.stop()
        listener.stop()


# -- counted exceptions ---------------------------------------------------------


class _BadClose:
    def close(self):
        raise OSError("planted close failure")

    def shutdown(self, how):
        pass


def test_close_failures_are_counted():
    m = connection.MConnection(_BadClose(), [ChannelDescriptor(0x20)], lambda *a: None,
                               lambda e: None)
    m.stop()
    assert m.close_errors == 1 and "planted" in str(m.last_close_error)
    s = object.__new__(sc.SecretConnection)
    s._conn, s.close_errors, s.last_close_error = _BadClose(), 0, None
    s.close()
    assert s.close_errors == 1 and "planted" in str(s.last_close_error)
    nk = NodeKey()
    t = MultiplexTransport(NodeInfo(node_id=nk.id), nk)
    t._listener = _BadClose()
    t.close()
    assert t.close_errors == 1 and "planted" in str(t.last_close_error)


def test_switch_errors_are_counted():
    sw, _, _ = _switch(True, "p2p-test", "errors")

    class Peer:
        id = "ab" * 20

        class mconn:
            @staticmethod
            def recvq_stats():
                raise RuntimeError("planted stats failure")

            @staticmethod
            def stop():
                pass

        def stop(self):
            pass

    peer = Peer()
    sw._peers[peer.id] = peer
    assert sw.recvq_stats()["enabled"] is False
    assert sw.recvq_errors == 1 and "planted" in str(sw.last_recvq_error)
    sw.stop_peer_for_error(peer, ConnectionError("planted peer error"))
    assert sw.peer_errors == 1 and sw.recvq_errors == 2 and sw.num_peers() == 0
    sw.stop_peer_for_error(peer, "switch stopping")  # a reason, not an error
    assert sw.peer_errors == 1
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port_no = probe.getsockname()[1]
    probe.close()  # nothing listens there now
    sw._running = True
    sw.add_persistent_peers([f"{'cd' * 20}@127.0.0.1:{port_no}"])
    sw.dial_persistent_peers()
    try:
        assert _wait(lambda: sw.redial_errors >= 1)
        assert isinstance(sw.last_redial_error, OSError)
    finally:
        sw.stop()


# -- keys, node info, config, flowrate, fuzz -----------------------------------


def test_node_keys_and_info_carry_across(tmp_path):
    ref = RefNodeKey()
    path = str(tmp_path / "node_key.json")
    ref.save_as(path)
    nk = convert.node_key_from_file(path)
    assert nk.id == ref.id and nk.priv_key.bytes() == ref.priv_key.bytes()
    nk.save_as(str(tmp_path / "port.json"))
    assert RefNodeKey.load(str(tmp_path / "port.json")).id == ref.id
    from cometbft_tpu.crypto import ed25519_pure as ref_pure

    seed = bytes(range(32))
    ref_seeded = RefNodeKey(ref_ed.PrivKey(seed + ref_pure.public_key(seed)))
    assert convert.node_key_from_seed(seed).id == ref_seeded.id
    info = RefNodeInfo(node_id=ref.id, listen_addr="127.0.0.1:26656", network="chain",
                       channels=bytes([0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40]), moniker="m",
                       rpc_address="tcp://127.0.0.1:26657")
    port_info = convert.node_info_from_wire(info.encode())
    assert port_info.encode() == info.encode() and port_info.to_json() == info.to_json()
    assert NodeInfo().encode() == RefNodeInfo().encode()
    with pytest.raises(ValueError, match="different Block version") as e1:
        port_info.compatible_with(NodeInfo(protocol_version=type(port_info.protocol_version)(block=10),
                                           node_id="x", network="chain"))
    with pytest.raises(ValueError, match="different Block version") as e2:
        info.compatible_with(RefNodeInfo(protocol_version=type(info.protocol_version)(block=10),
                                         node_id="x", network="chain"))
    assert str(e1.value) == str(e2.value)
    ref_cfg = dataclasses.asdict(RefP2PConfig())
    cfg = convert.p2p_config_from_fields(ref_cfg)
    assert cfg == P2PConfig() and dataclasses.asdict(cfg).items() <= ref_cfg.items()
    assert (cfg.send_rate, cfg.recv_rate, cfg.max_packet_msg_payload_size) == (
        ref_conn.DEFAULT_SEND_RATE, ref_conn.DEFAULT_RECV_RATE,
        ref_conn.DEFAULT_MAX_PACKET_MSG_PAYLOAD_SIZE)


def test_flowrate_monitor_equals_the_reference():
    ms = [flowrate.Monitor(sample_period=0.01), ref_flowrate.Monitor(sample_period=0.01)]
    for m in ms:
        for n in (10, 2000, 0, 5):
            assert m.update(n) == n
        assert m.limit(12345, 0) == 12345  # rate 0: unlimited
        assert m.limit(10, 10_000_000) == 10
    st = [m.status() for m in ms]
    assert st[0].keys() == st[1].keys() and st[0]["bytes"] == st[1]["bytes"] == 2015


def test_fuzzed_conn_swallows_the_reference_writes():
    class Sink:
        def __init__(self):
            self.data = []
            self.closed = 0

        def write(self, d):
            self.data.append(d)
            return len(d)

        def close(self):
            self.closed += 1

    outs = []
    for mod in (fuzz, ref_fuzz):
        sink = Sink()
        f = mod.FuzzedConn(sink, mod.FuzzConnConfig(mode="drop", prob_drop_rw=0.3, prob_drop_conn=0.1,
                                                    seed=4))
        for i in range(50):
            assert f.write(b"%d" % i) == len(b"%d" % i)
        outs.append((sink.data, sink.closed))
    assert outs[0] == outs[1] and 0 < len(outs[0][0]) < 50 and outs[0][1] > 0
