"""The port's ``simnet/transport.py`` (``SimConn``, ``SimNetwork``,
``SimTransport``) against the JAX package's.

- On a seeded ``SimClock`` each, the port's and the reference's networks,
  driven by the same script (three nodes with keys from fixed secrets, a
  WAN link model with jitter, bandwidth and drops, a partition and a heal,
  an adversarial send tap), deliver the same bytes to the same endpoints at
  the same simulated times, in the same order, with the same counters: FIFO
  per directed link under jitter, whole writes dropped, nothing across the
  cut.
- Dial errors (no listener, a wrong expected ID, a closed listener, a
  partition, an incompatible network) raise the reference's error types
  and texts.
- Four port validators, each a ``ConsensusState`` with its reactors on a
  ``Switch`` over ``SimTransport`` (wall clock, the simnet's WAN link
  defaults: a latency matrix synthesized from the seed over four zones and
  10 ms of jitter), commit to height 3, stop for a 2|2 partition, and after
  the heal (the cut's connections dropped and dialed again) commit to
  height 6, the same blocks on every node. ``python
  tests/test_torch_simnet_transport.py SEED ...`` runs both packages'
  meshes with ``heal()`` alone (``heal_only``), a JSON line a run.

Nothing asserts a wall-clock time; every wait has its own timeout."""

from __future__ import annotations

import random
import time
import types

import pytest

from cometbft_tpu.p2p.key import NodeKey as RefNodeKey
from cometbft_tpu.p2p.node_info import NodeInfo as RefNodeInfo
from cometbft_tpu.p2p.transport import TransportError as RefTransportError
from cometbft_tpu.simnet.clock import SimClock as RefSimClock
from cometbft_tpu.simnet.transport import SimNetwork as RefSimNetwork
from cometbft_tpu.simnet.transport import SimTransport as RefSimTransport
from cometbft_tpu_torch import simnet
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.transport import TransportError
from cometbft_tpu_torch.simnet import transport as port_transport
from cometbft_tpu_torch.simnet.clock import MonotonicClock, SimClock
from cometbft_tpu_torch.simnet.transport import SimNetwork, SimTransport

pytestmark = pytest.mark.torch_port

WAIT_S = 60.0


def side(port: bool):
    from cometbft_tpu.crypto import ed25519 as ref_ed

    if port:
        return types.SimpleNamespace(clock=SimClock, net=SimNetwork, transport=SimTransport,
                                     key=lambda s: NodeKey(ed25519.gen_priv_key_from_secret(s)),
                                     info=NodeInfo, error=TransportError)
    return types.SimpleNamespace(clock=RefSimClock, net=RefSimNetwork, transport=RefSimTransport,
                                 key=lambda s: RefNodeKey(ref_ed.gen_priv_key_from_secret(s)),
                                 info=RefNodeInfo, error=RefTransportError)


def make_node(S, net, name: str, port: int, network: str = "simnet-test"):
    key = S.key(b"simnet-transport-" + name.encode())
    info = S.info(node_id=key.id, listen_addr=f"127.0.0.1:{port}", network=network,
                  moniker=name, channels=bytes([0x20]))
    accepted = []
    t = S.transport(info, key, net)
    t.listen(info.listen_addr, accepted.append)
    return t, accepted


def run_script(port: bool) -> dict:
    """Drive one package's network with the script; return its trace."""
    S = side(port)
    clock = S.clock()
    net = S.net(clock, seed=13, latency_s=0.02, jitter_s=0.05, bandwidth_bps=400_000.0,
                drop_p=0.1)
    nodes = {n: make_node(S, net, n, i + 1) for i, n in enumerate("abc")}
    ids = {n: t.node_key.id for n, (t, _) in nodes.items()}
    trace = []
    conns = {}

    def record(label, conn):
        orig = conn._deliver

        def deliver(data):
            trace.append((round(clock.now(), 9), label, bytes(data)))
            orig(data)

        conn._deliver = deliver

    for src, dst in (("a", "b"), ("a", "c"), ("b", "c")):
        up = nodes[src][0].dial(nodes[dst][0].node_info.listen_addr, expected_id=ids[dst])
        inbound = nodes[dst][1][-1]
        conns[(src, dst)], conns[(dst, src)] = up.conn, inbound.conn
        record(f"{src}->{dst}", inbound.conn)
        record(f"{dst}->{src}", up.conn)
    net.set_link(ids["b"], ids["c"], latency_s=0.15, drop_p=0.0)
    rng = random.Random(99)
    links = sorted(conns)

    def burst(k: int, tag: bytes):
        for i in range(k):
            link = links[rng.randrange(len(links))]
            conns[link].write(tag + b"-%03d-" % i + bytes(rng.randrange(0, 300)))
            if rng.random() < 0.3:
                clock.run(until=clock.now() + rng.uniform(0.0, 0.04))

    burst(60, b"open")
    clock.run()
    net.partition([[ids["a"]], [ids["b"], ids["c"]]])
    burst(40, b"cut")
    clock.run()
    net.heal()
    net.set_send_tap(ids["c"], lambda dst, data: (
        None if data[-1] % 3 else [(0.0, data), (0.07, data[::-1])]))
    burst(40, b"healed")
    clock.run()
    net.set_send_tap(ids["c"], None)
    burst(10, b"untapped")
    clock.run()
    buffered = {f"{s}->{d}": bytes(c._buf) for (d, s), c in sorted(conns.items())}
    return {"trace": trace, "stats": dict(net.stats), "now": clock.now(), "buffered": buffered}


def test_delivery_trace_equals_the_reference():
    port, ref = run_script(True), run_script(False)
    assert port == ref
    st = port["stats"]
    assert st["dropped"] > 0 and st["partitioned"] > 0 and st["tapped"] > 0
    for label in ("a->b", "b->a", "b->c"):  # FIFO per directed link
        times = [t for t, lab, _ in port["trace"] if lab == label]
        assert times == sorted(times) and times


def test_dial_errors_equal_the_reference():
    outs = []
    for port in (True, False):
        S = side(port)
        net = S.net(S.clock(), seed=1)
        a, _ = make_node(S, net, "a", 1)
        b, _ = make_node(S, net, "b", 2)
        c, _ = make_node(S, net, "c", 3, network="other-chain")
        errs = []
        for addr, want in (("127.0.0.1:99", ""), (b.node_info.listen_addr, "deadbeef"),
                           (c.node_info.listen_addr, "")):
            with pytest.raises(S.error) as e:
                a.dial(addr, expected_id=want)
            errs.append(str(e.value))
        net.partition([[a.node_key.id], [b.node_key.id]])
        with pytest.raises(S.error) as e:
            a.dial(b.node_info.listen_addr)
        errs.append(str(e.value))
        net.heal()
        b.close()
        with pytest.raises(S.error) as e:
            a.dial(b.node_info.listen_addr)
        errs.append(str(e.value))
        with pytest.raises(ValueError, match="unknown link params"):
            net.set_link("x", "y", speed=1)
        outs.append(errs)
    assert outs[0] == outs[1]
    assert "partitioned" in outs[0][3] and "incompatible peer" in outs[0][2]


def test_simnet_names_the_ports_transport():
    assert simnet.SimNetwork is port_transport.SimNetwork is SimNetwork
    assert simnet.SimTransport is port_transport.SimTransport is SimTransport
    assert port_transport.UpgradedConn.__module__ == "cometbft_tpu_torch.p2p.transport"


def sim_mesh(side: str, seed: int):
    """Four validators of one package (``test_torch_consensus_reactor``'s
    nodes), each with its consensus and mempool reactors on a ``Switch``
    over that package's ``SimTransport``: one ``SimNetwork`` on the wall
    clock, the simnet's WAN link defaults from ``seed``."""
    import test_torch_consensus_reactor as tcr

    if side == "ref":
        from cometbft_tpu.simnet.clock import MonotonicClock as Clock
        from cometbft_tpu.simnet.scenario import _synth_zone_latency
    else:
        from cometbft_tpu_torch.simnet.clock import MonotonicClock as Clock
        from cometbft_tpu_torch.simnet.scenario import _synth_zone_latency
    Net, Transport = (RefSimNetwork, RefSimTransport) if side == "ref" else (SimNetwork,
                                                                           SimTransport)
    P = tcr.pkg(side)
    pvs = tcr.pvs_of(P, b"sim")
    gen = tcr.genesis_of(P, pvs)
    net = Net(Clock(), seed=seed, jitter_s=0.010)
    zl = _synth_zone_latency(random.Random(seed), 4)
    nodes = []
    for i, pv in enumerate(pvs):
        n = tcr.node_of(P, gen, pv, f"sim{i}")
        n.cs.config.timeout_propose = 1.0  # WAN links of up to 150 ms
        nk = P.NodeKey(P.ed.gen_priv_key_from_secret(b"simnk-%d" % i))
        ni = P.NodeInfo(node_id=nk.id, network=tcr.CHAIN_ID, moniker=n.cs.name)
        n.sw, n.nk = P.Switch(ni, Transport(ni, nk, net)), nk
        n.reactor = P.ConsensusReactor(n.cs, gossip_sleep=0.02)
        n.sw.add_reactor("CONSENSUS", n.reactor)
        n.sw.add_reactor("MEMPOOL", P.MempoolReactor(n.cfg.mempool, n.mempool))
        nodes.append(n)
    for i in range(4):
        for j in range(i + 1, 4):
            net.set_link(nodes[i].nk.id, nodes[j].nk.id, latency_s=zl[i][j] / 1000.0)
    addrs = [f"{n.nk.id}@{n.sw.start(f'10.0.0.{i}:26656')}" for i, n in enumerate(nodes)]
    return net, nodes, addrs


def sim_mesh_to_the_cut(net, nodes, addrs) -> list:
    """Connect, start, cut 2|2 at height 3 and hold 2.5 s; returns the
    heights held."""
    for i, n in enumerate(nodes):
        for j in range(i + 1, 4):
            assert n.sw.dial_peer(addrs[j]) is not None
    deadline = time.monotonic() + WAIT_S
    while any(n.sw.num_peers() < 3 for n in nodes):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    for n in nodes:
        n.cs.start()
    assert nodes[0].cs.wait_for_height(3, timeout=WAIT_S)
    net.partition([[nodes[0].nk.id, nodes[1].nk.id], [nodes[2].nk.id, nodes[3].nk.id]])
    time.sleep(0.5)  # what was in flight at the cut lands
    held = [n.cs.block_store.height() for n in nodes]
    time.sleep(2.0)
    assert [n.cs.block_store.height() for n in nodes] == held
    return held


def heal_only(side: str, seed: int, wait_s: float) -> dict:
    """``sim_mesh`` to the cut, then ``heal()`` alone: whether every node
    reaches height 6 within ``wait_s``, and each node's height, round and
    step at the end (ROADMAP §3: a heal alone can leave the chain
    stalled, in both packages)."""
    from cometbft_tpu.sidecar import backend as ref_backend
    from cometbft_tpu_torch.sidecar import backend

    prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.CpuBackend())
    net, nodes, addrs = sim_mesh(side, seed)
    try:
        sim_mesh_to_the_cut(net, nodes, addrs)
        net.heal()
        t0 = time.monotonic()
        ok = all(n.cs.wait_for_height(7, timeout=max(0.0, wait_s - (time.monotonic() - t0)))
                 for n in nodes)
        return {"side": side, "seed": seed, "reached_6": ok,
                "s": round(time.monotonic() - t0, 2),
                "end": [[n.cs.rs.height, n.cs.rs.round, int(n.cs.rs.step)] for n in nodes]}
    finally:
        for n in nodes:
            n.cs.stop()
            n.sw.stop()
        ref_backend.set_backend(prev[0])
        backend.set_backend(prev[1])


def test_port_mesh_on_simtransport_halts_in_a_partition_and_heals():
    from cometbft_tpu_torch.sidecar import backend

    prev = backend._backend
    backend.set_backend(backend.CpuBackend())
    net, nodes, addrs = sim_mesh("port", 17)
    try:
        sim_mesh_to_the_cut(net, nodes, addrs)
        net.heal()
        # The cut's connections stayed open but silent, and their PeerState
        # marks count the votes lost in the cut as delivered, which a heal
        # alone may not undo (``heal_only``): drop them from one side and
        # dial again, as a real network's dead TCP sessions are.
        for i in (0, 1):
            for j in (2, 3):
                nodes[i].sw.stop_peer_for_error(nodes[i].sw.get_peer(nodes[j].nk.id),
                                                "partition healed: reconnect")
        deadline = time.monotonic() + WAIT_S
        while any(n.sw.num_peers() > 1 for n in nodes):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        for i in (0, 1):
            for j in (2, 3):
                assert nodes[i].sw.dial_peer(addrs[j]) is not None
        for n in nodes:
            assert n.cs.wait_for_height(7, timeout=WAIT_S), (n.cs.name, n.cs.rs.height)
        for h in range(1, 7):
            assert len({n.cs.block_store.load_block(h).hash() for n in nodes}) == 1
        assert net.stats["partitioned"] > 0
        # Each dropped connection is one error on the side that did not drop it.
        assert [n.sw.peer_errors for n in nodes] == [0, 0, 2, 2]
        for n in nodes:
            assert n.reactor.gossip_errors == 0 and n.sw.inbound_errors == 0
    finally:
        for n in nodes:
            n.cs.stop()
            n.sw.stop()
        backend.set_backend(prev)


if __name__ == "__main__":
    # python tests/test_torch_simnet_transport.py SEED [SEED ...]: both
    # packages' meshes, heal() alone, 45 s each; one JSON line a run.
    import json
    import sys

    import torch

    torch.set_num_threads(1)
    for seed in map(int, sys.argv[1:]):
        for side in ("ref", "port"):
            print(json.dumps(heal_only(side, seed, 45.0)), flush=True)
