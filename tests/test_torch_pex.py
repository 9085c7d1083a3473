"""PEX in the port (``cometbft_tpu_torch/p2p/pex``) held to the JAX
package's: the address book's mechanics (every case of the package's
``tests/test_pex.py`` on the port), the PEX messages byte-identical both
ways, an address book file written by either package loading in the other
to the same entries and buckets, the seed-discovery mesh of port nodes, and
a port node and a reference node finding each other through PEX over TCP."""

import os
import random
import time

import pytest

from cometbft_tpu.p2p.pex import AddrBook as RefAddrBook
from cometbft_tpu.p2p.pex import NetAddress as RefNetAddress
from cometbft_tpu.p2p.pex import reactor as ref_reactor
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.p2p.pex import AddrBook, NetAddress
from cometbft_tpu_torch.p2p.pex.reactor import (
    PexReactor,
    decode_pex_message,
    encode_pex_addrs,
    encode_pex_request,
)

pytestmark = pytest.mark.torch_port

WAIT_S = 120.0  # a liveness guard under a loaded host, not a time bound


def na(i: int, port: int = 26656, cls=NetAddress):
    return cls(id=f"{i:040x}", ip=f"8.8.{i // 256}.{i % 256}", port=port)


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


# -- the address book (the package's own cases, on the port) ----------------


def test_addrbook_add_pick_promote():
    book = AddrBook(strict=True, key=b"\x07" * 24)
    book._rand.seed(42)
    src = na(999)
    for i in range(50):
        assert book.add_address(na(i), src)
    assert book.size() == 50
    assert book.need_more_addrs()
    picked = book.pick_address()
    assert picked is not None and book.has_address(picked.id)
    book.mark_good(picked.id)
    assert book.pick_address(bias_towards_new=0) is not None
    victim = na(7)
    for _ in range(12):
        book.mark_attempt(victim)
    seen = {book.pick_address().id for _ in range(200)}
    assert victim.id not in seen


def test_addrbook_rejects_unroutable_self_private():
    strict = AddrBook(strict=True)
    assert not strict.add_address(NetAddress(id="ab", ip="127.0.0.1", port=1))
    assert not strict.add_address(NetAddress(id="ab", ip="10.0.0.1", port=1))
    loose = AddrBook(strict=False)
    assert loose.add_address(NetAddress(id="ab", ip="127.0.0.1", port=1))
    loose.add_our_address("cd")
    assert not loose.add_address(NetAddress(id="cd", ip="127.0.0.1", port=2))
    loose.add_private_ids(["ef"])
    assert not loose.add_address(NetAddress(id="ef", ip="127.0.0.1", port=3))


def test_addrbook_persistence_roundtrip(tmp_path):
    path = str(tmp_path / "addrbook.json")
    book = AddrBook(path, strict=True)
    for i in range(10):
        book.add_address(na(i), na(999))
    book.mark_good(na(3).id)
    book.save()
    loaded = AddrBook(path, strict=True)
    assert loaded.size() == 10
    assert loaded.has_address(na(3).id)
    assert loaded._addrs[na(3).id].bucket_type == "old"


@pytest.mark.parametrize("blob", [b"{", b"[1, 2]", b'{"key": "zz-not-hex"}',
                                  b'{"addrs": {"not": "a list"}}', b'{"addrs": [42]}'])
def test_addrbook_corrupt_file_does_not_stop_boot(tmp_path, blob):
    """A corrupt book yields an empty book and a .corrupt file, as in the
    reference; the port counts it in ``load_errors``."""
    path = str(tmp_path / "book.json")
    for cls in (AddrBook, RefAddrBook):
        with open(path, "wb") as f:
            f.write(blob)
        book = cls(path, strict=True)
        assert book.size() == 0
        corrupt = blob != b'{"addrs": [42]}'  # [42] is a valid dump, the entry skipped
        assert os.path.exists(path + ".corrupt") == corrupt
        if cls is AddrBook:
            assert book.load_errors == int(corrupt)
        for p in (path, path + ".corrupt"):
            if os.path.exists(p):
                os.unlink(p)


def test_net_address_equals_the_reference():
    for s in ("AB" * 20 + "@1.2.3.4:26656", "cd" * 20 + "@[::1]:1", "ef@10.0.0.1:0"):
        got, want = NetAddress.parse(s), RefNetAddress.parse(s)
        assert vars(got) == vars(want)
        assert got.dial_string() == want.dial_string()
        assert (got.routable(), got.valid(), got.group_key()) == (
            want.routable(), want.valid(), want.group_key())
    with pytest.raises(ValueError) as got:
        NetAddress.parse("1.2.3.4:1")
    with pytest.raises(ValueError) as want:
        RefNetAddress.parse("1.2.3.4:1")
    assert str(got.value) == str(want.value)


# -- the wire ------------------------------------------------------------------


def test_pex_wire_codec():
    kind, _ = decode_pex_message(encode_pex_request())
    assert kind == "request"
    addrs = [na(1), na(2, port=999)]
    kind, got = decode_pex_message(encode_pex_addrs(addrs))
    assert kind == "addrs" and got == addrs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pex_messages_byte_identical_both_ways(seed):
    rng = random.Random(seed)
    n = rng.randrange(0, 40)
    ids = [rng.randbytes(20).hex() for _ in range(n)]
    ips = [f"{rng.randrange(1, 255)}.{rng.randrange(256)}.{rng.randrange(256)}.1"
           for _ in range(n)]
    ports = [rng.randrange(1, 65536) for _ in range(n)]
    mine = [NetAddress(i, p_, q) for i, p_, q in zip(ids, ips, ports)]
    theirs = [RefNetAddress(i, p_, q) for i, p_, q in zip(ids, ips, ports)]
    assert encode_pex_request() == ref_reactor.encode_pex_request()
    assert encode_pex_addrs(mine) == ref_reactor.encode_pex_addrs(theirs)
    kind, got = decode_pex_message(ref_reactor.encode_pex_addrs(theirs))
    assert kind == "addrs" and [vars(a) for a in got] == [vars(a) for a in theirs]
    ref_kind, ref_got = ref_reactor.decode_pex_message(encode_pex_addrs(mine))
    assert ref_kind == "addrs" and [vars(a) for a in ref_got] == [vars(a) for a in mine]
    with pytest.raises(ValueError) as e:
        decode_pex_message(b"\x1a\x00")
    with pytest.raises(ValueError) as ref_e:
        ref_reactor.decode_pex_message(b"\x1a\x00")
    assert str(e.value) == str(ref_e.value)


# -- the address book's file, across packages ----------------------------------


def _entries(book) -> dict:
    return {aid: (vars(ka.addr), ka.src_id, ka.attempts, ka.last_success, ka.bucket_type,
                  sorted(ka.buckets)) for aid, ka in book._addrs.items()}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_addrbook_file_loads_in_the_other_package(tmp_path, monkeypatch, writer):
    # Loading an old entry marks it good again, at the clock's time: pin it.
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.5)
    path = str(tmp_path / "addrbook.json")
    cls, addr = (AddrBook, NetAddress) if writer == "port" else (RefAddrBook, RefNetAddress)
    book = cls(path, strict=True, key=b"\x05" * 24)
    for i in range(40):
        book.add_address(na(i, cls=addr), na(900 + i % 3, cls=addr))
    for i in (3, 7, 11):
        book.mark_good(na(i, cls=addr).id)
    for _ in range(4):
        book.mark_attempt(na(20, cls=addr))
    book.save()
    port_book, ref_book = convert.addr_book_from_file(path), RefAddrBook(path, strict=True)
    assert port_book._key == ref_book._key == b"\x05" * 24
    assert _entries(port_book) == _entries(ref_book)
    assert [sorted(b) for b in port_book._old_buckets] == [sorted(b) for b in ref_book._old_buckets]
    assert [sorted(b) for b in port_book._new_buckets] == [sorted(b) for b in ref_book._new_buckets]
    assert port_book.load_errors == 0


# -- the reactor -----------------------------------------------------------------


class FakePeer:
    id = "aa" * 20
    is_outbound = False
    remote_ip = "127.0.0.1"

    class node_info:
        listen_addr = "tcp://127.0.0.1:26656"

    def __init__(self):
        self.sent = []

    def try_send(self, *a):
        self.sent.append(a)
        return True


def test_rate_limit_clock_dies_with_the_connection():
    """A peer that disconnects and reconnects within request_interval is
    not punished for its first address request (the clock is per
    connection, pex_reactor.go RemovePeer)."""
    r = PexReactor(AddrBook(strict=False, key=b"\x01" * 24), request_interval=10.0)
    peer, req = FakePeer(), encode_pex_request()
    r.receive(0x00, peer, req)
    with pytest.raises(ValueError, match="too often"):
        r.receive(0x00, peer, req)
    r.remove_peer(peer, "conn dropped")
    r.receive(0x00, peer, req)


def test_receive_answers_as_the_reference():
    """The same book and the same requests: the same answers sent, the same
    refusals (an unsolicited list, an inbound peer learned)."""
    out = {}
    for name, book_cls, reactor_cls in (("port", AddrBook, PexReactor),
                                        ("ref", RefAddrBook, ref_reactor.PexReactor)):
        book = book_cls(strict=False, key=b"\x02" * 24)
        book._rand.seed(5)
        r = reactor_cls(book, request_interval=10.0)
        peer = FakePeer()
        r.add_peer(peer)  # inbound: its self-reported address learned
        r.receive(0x00, peer, encode_pex_request())
        with pytest.raises(ValueError) as e:
            r.receive(0x00, peer, ref_reactor.encode_pex_addrs([]))
        out[name] = (peer.sent, str(e.value), sorted(book._addrs))
    assert out["port"] == out["ref"]


def test_stop_ends_the_ensure_loop():
    """``stop`` wakes the ensure-peers loop at once (30 s between rounds by
    default) and saves the book."""
    from cometbft_tpu_torch.libs import threads

    r = PexReactor(AddrBook(strict=False))
    group = threads.ThreadGroup()
    with group.scope():
        r.start()
    assert len(group.threads()) == 1
    r.stop()
    assert group.join(5.0) == []


# -- nodes ---------------------------------------------------------------------


def _port_node(gen, pv, **p2p):
    from cometbft_tpu_torch.abci.client import LocalClientCreator
    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import test_config as make_test_config
    from cometbft_tpu_torch.node import Node

    cfg = make_test_config()
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.addr_book_strict = False  # loopback net
    cfg.rpc.laddr = ""
    cfg.consensus.timeout_commit = 0.1
    cfg.consensus.skip_timeout_commit = False
    for k, v in p2p.items():
        setattr(cfg.p2p, k, v)
    node = Node(cfg, gen, pv, LocalClientCreator(KVStoreApplication()))
    if node.pex_reactor is not None:  # fast discovery (30 s by default)
        node.pex_reactor.ensure_interval = 0.25
        node.pex_reactor.request_interval = 0.25
    return node


@pytest.fixture
def cpu_backends():
    from cometbft_tpu.sidecar import backend as ref_be
    from cometbft_tpu_torch.sidecar import backend as be

    old, ref_old = be._backend, ref_be._backend
    be.set_backend(be.CpuBackend())
    ref_be.set_backend(ref_be.CpuBackend())
    yield
    be._backend, ref_be._backend = old, ref_old


def test_seed_discovery_full_mesh_consensus(cpu_backends):
    """Three port validators and a port seed; every validator knows only the
    seed's address. PEX discovers the other validators and consensus
    commits over the discovered mesh (the package's own case, on port
    nodes)."""
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.priv_validator import MockPV

    pvs = [MockPV() for _ in range(3)]
    gen = GenesisDoc(chain_id="pex-chain", genesis_time=cmttime.now(), validators=[
        GenesisValidator(pv.address(), pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(pvs)])
    gen.validate_and_complete()
    seed = _port_node(gen, None, seed_mode=True)
    nodes = []
    try:
        seed.start()
        seed_addr = f"{seed.node_key.id}@{seed.p2p_laddr}"
        nodes = [_port_node(gen, pv, seeds=seed_addr) for pv in pvs]
        for n in nodes:
            n.start()
        ids = {n.node_key.id for n in nodes}

        def mesh_ok():
            return all(len({p.id for p in n.switch.peers()} & (ids - {n.node_key.id})) == 2
                       for n in nodes)

        _wait(mesh_ok, "the validators did not find each other through the seed")
        cs0 = nodes[0].consensus_state
        _wait(lambda: cs0.rs.height >= 4, f"the discovered net stuck at {cs0.rs.height}")
    finally:
        for n in nodes:
            n.stop()
        seed.stop()


def test_port_and_reference_nodes_find_each_other_over_tcp(cpu_backends, tmp_path):
    """A reference node and a port node, PEX on both: the port node dials
    the reference node as its only seed-free persistent peer, asks it for
    addresses, and each address book ends up holding the other (the port's
    saved to its home in the reference's file format)."""
    from cometbft_tpu.abci.client import LocalClientCreator as RefCreator
    from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
    from cometbft_tpu.config import test_config as ref_test_config
    from cometbft_tpu.node.node import Node as RefNode
    from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
    from cometbft_tpu.types import GenesisValidator as RefGenesisValidator
    from cometbft_tpu.types import Time as RefTime
    from cometbft_tpu.types.priv_validator import MockPV as RefMockPV
    from cometbft_tpu_torch.types.genesis import GenesisDoc

    absent = RefMockPV()  # the chain's validator runs nowhere: both nodes follow
    ref_gen = RefGenesisDoc(chain_id="pex-mixed", genesis_time=RefTime(1_700_000_000, 0),
                            validators=[RefGenesisValidator(absent.address(),
                                                            absent.get_pub_key(), 10, "v")])
    ref_gen.validate_and_complete()
    cfg = ref_test_config()
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.addr_book_strict = False
    cfg.rpc.laddr = ""
    ref = RefNode(cfg, ref_gen, None, RefCreator(RefKV()))
    ref.pex_reactor.ensure_interval = ref.pex_reactor.request_interval = 0.25
    port = None
    try:
        ref.start()
        home = str(tmp_path / "home")
        port = _port_node(GenesisDoc.from_json(ref_gen.to_json()), None,
                          persistent_peers=f"{ref.node_key.id}@{ref.p2p_laddr}")
        port.config.set_root(home)
        port.addr_book.file_path = os.path.join(home, port.config.p2p.addr_book_file)
        port.start()
        _wait(lambda: port.addr_book.has_address(ref.node_key.id)
              and ref.addr_book.has_address(port.node_key.id),
              "the two nodes' books never held each other")
        assert port.switch.get_peer(ref.node_key.id) is not None
        assert 0x00 in port.node_info.channels and 0x60 in port.node_info.channels
        assert bytes(port.node_info.channels) == bytes(ref.node_info.channels)
    finally:
        if port is not None:
            port.stop()
        ref.stop()
    assert port.threads_left_at_stop == 0
    book = RefAddrBook(port.addr_book.file_path, strict=False)
    assert book.has_address(ref.node_key.id)
