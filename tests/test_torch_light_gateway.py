"""The port's MMR, checkpoint bundles, bundle origin and light gateway
(``light/mmr.py``, ``bundle.py``, ``origin.py``, ``gateway.py``) and its
providers against the JAX package's (test_light_gateway.py and
test_bundle.py, ported): MMR roots and proofs equal the RFC-6962 tree and
the reference's byte for byte, and a state file either package writes
resumes in the other; the golden bundle encodes and names identically;
clients syncing through bundles, gateway plans and gateway proofs store the
same bytes and count the same as the reference's, refusals and fallbacks
included; the gateway's plans and stats are the reference's, its swarm of 8
threads computes one plan; a failed prewarm is counted. The providers serve
the reference's light blocks from a node's stores and from the reference's
RPC JSON. Both packages verify on their ``CpuBackend``."""

import base64
import json
import threading

import pytest
import torch
import torch_chains as tc
import torch_light_chains as lc
from test_bundle import GOLDEN_NAME, _golden_chain

from cometbft_tpu.crypto.merkle import proofs_from_byte_slices as ref_proofs
from cometbft_tpu.light import bundle as ref_bundle
from cometbft_tpu.light import gateway as ref_gateway
from cometbft_tpu.light import mmr as ref_mmr
from cometbft_tpu.light import origin as ref_origin
from cometbft_tpu.light import provider as ref_provider
from cometbft_tpu.rpc.core import Environment, routes
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.sidecar import engine as ref_engine
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices_pure, proofs_from_byte_slices_pure
from cometbft_tpu_torch.light import bundle, gateway, mmr, origin, provider
from cometbft_tpu_torch.sidecar import backend, engine
from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler

pytestmark = pytest.mark.torch_port

NOW_S = lc.T0 + 1000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chains():
    made = {
        "static24": lc.chain(b"gw-static", n_vals=3, heights=24),
        "static32": lc.chain(b"gw-static32", n_vals=3, heights=32),
        "rotating40": lc.chain(b"gw-rotating", n_vals=6, heights=40, rotate=2),
        "diluted24": lc.chain(b"gw-diluted", n_vals=4, heights=24, rotate=1),
        "forged24": lc.chain(b"gw-forged", n_vals=3, heights=24),
        "golden": _golden_chain(),
    }
    return {name: {"ref": c.blocks, "port": lc.port_blocks(c.blocks)} for name, c in made.items()}


def _mods(pkg):
    if pkg == "ref":
        return ref_mmr, ref_bundle, ref_origin, ref_gateway, ref_provider
    return mmr, bundle, origin, gateway, provider


# -- the MMR ----------------------------------------------------------------------


def test_mmr_equals_the_rfc6962_tree_and_the_reference():
    items = [b"leaf-%d" % i for i in range(40)]
    port, ref = mmr.MMR(), ref_mmr.MMR()
    for n in range(1, len(items) + 1):
        port.append(items[n - 1])
        ref.append(items[n - 1])
        assert port.root() == ref.root() == hash_from_byte_slices_pure(items[:n])
        assert port.peaks() == ref.peaks()
    _, want = proofs_from_byte_slices_pure(items)
    _, ref_want = ref_proofs(items)
    for i in range(len(items)):
        assert port.prove(i).aunts == want[i].aunts == ref.prove(i).aunts == ref_want[i].aunts
        mmr.verify_inclusion(port.root(), len(items), i, port.prove(i).aunts, items[i])
    for size in (1, 2, 7, 16, 24, 25, 40):
        assert port.root_at(size) == ref.root_at(size)
        assert port.peaks_at(size) == ref.peaks_at(size)
        for idx in range(0, size, 3):
            assert port.prove_at(idx, size).aunts == ref.prove_at(idx, size).aunts
    assert mmr.MMR().root() == ref_mmr.MMR().root() == mmr.bag_peaks([])
    # a corrupted proof fails the same way in both
    p = port.prove(5)
    bad = [b"\x00" * 32] + list(p.aunts[1:])
    outs = [lc.outcome(lambda m=m, a=a, d=d: m.verify_inclusion(port.root(), 40, 5, a, d))
            for m in (mmr, ref_mmr) for a, d in ((p.aunts, b"not-the-leaf"), (bad, items[5]))]
    assert outs[:2] == outs[2:] and all(o is not None for o in outs)
    assert lc.outcome(lambda: port.prove(40)) == lc.outcome(lambda: ref.prove(40))


def test_state_file_resumes_across_packages(tmp_path):
    """The reference's save_state resumes in the port and the port's in the
    reference, byte for byte; a tampered file, a file of another chain and
    a missing file give the same outcomes."""
    ref = ref_mmr.MMR()
    for i in range(13):
        ref.append(bytes([i]) * 32)
    a, b = str(tmp_path / "ref.state"), str(tmp_path / "port.state")
    ref_mmr.save_state(ref, a)
    port = convert.mmr_from_state_file(a)
    assert port.size == 13 and port.root() == ref.root() and port.prove(5).aunts == ref.prove(5).aunts
    convert.mmr_to_state_file(port, b)
    assert open(b, "rb").read() == open(a, "rb").read()
    assert ref_mmr.load_state(b).root() == ref.root()
    hashes = {h: bytes([h - 1]) * 32 for h in range(1, 14)}
    assert mmr.resume_or_new(b, hashes.get).root() == ref_mmr.resume_or_new(a, hashes.get).root()
    wrong = {13: b"\x99" * 32}
    assert lc.outcome(lambda: mmr.resume_or_new(b, wrong.get)) == \
        lc.outcome(lambda: ref_mmr.resume_or_new(a, wrong.get))
    assert mmr.resume_or_new(str(tmp_path / "missing"), hashes.get).size == 0
    raw = bytearray(open(a, "rb").read())
    raw[-1] ^= 1
    open(a, "wb").write(bytes(raw))
    assert lc.outcome(lambda: mmr.load_state(a)) == lc.outcome(lambda: ref_mmr.load_state(a))
    open(a, "wb").write(b"not an mmr")
    assert lc.outcome(lambda: mmr.load_state(a)) == lc.outcome(lambda: ref_mmr.load_state(a))


# -- bundles and the origin -------------------------------------------------------


def test_golden_bundle_encodes_and_names_identically(chains):
    blocks = chains["golden"]
    port = origin.BundleOrigin(lc.CHAIN_ID, provider.MockProvider(lc.CHAIN_ID, blocks["port"]),
                               interval=8)
    ref = ref_origin.BundleOrigin(lc.CHAIN_ID, ref_provider.MockProvider(lc.CHAIN_ID,
                                                                         blocks["ref"]), interval=8)
    name, data, boundary = port.get_encoded(0)
    assert (name, data, boundary) == ref.get_encoded(0) and name == GOLDEN_NAME
    b = bundle.Bundle.decode(data)
    assert b.encode() == data and b.name == name
    b.self_check(lc.CHAIN_ID)
    bundle.check_name(name, data)
    for h in (1, 8, 24, 1000):
        assert bundle.ladder_heights(h) == ref_bundle.ladder_heights(h)
    assert lc.outcome(lambda: bundle.ladder_heights(0)) == \
        lc.outcome(lambda: ref_bundle.ladder_heights(0))
    assert lc.outcome(lambda: bundle.check_name(name, data + b"x")) == \
        lc.outcome(lambda: ref_bundle.check_name(name, data + b"x"))


def _flip_commit_bit(b_mod, data):
    b = b_mod.Bundle.decode(data)
    sig = b.anchor.signed_header.commit.signatures[0].signature
    out = bytearray(data)
    out[data.find(sig)] ^= 1
    return bytes(out)


def _truncated(b_mod, data):
    b = b_mod.Bundle.decode(data)
    return b_mod.Bundle(chain_id=b.chain_id, anchor=b.anchor, mmr_size=b.mmr_size,
                        peaks=b.peaks, ladder=b.ladder[:-1]).encode()


BUNDLE_CASES = {
    # name: (tamper or None, interval, target)
    "cold_sync": (None, 8, 24),
    "below_target": (None, 8, 21),
    "flipped_commit_bit": (_flip_commit_bit, 8, 24),
    "truncated_ladder": (_truncated, 8, 24),
    "garbage": (lambda b_mod, data: b"\xde\xad" * 40, 8, 24),
}


@pytest.mark.parametrize("name", list(BUNDLE_CASES))
def test_bundle_sync_agrees_with_the_reference(chains, name):
    tamper, interval, target = BUNDLE_CASES[name]
    out = {}
    with lc.Pair() as be:
        for pkg in ("ref", "port"):
            _, b_mod, o_mod, _, p_mod = _mods(pkg)
            blocks = chains["static24"][pkg]
            o = o_mod.BundleOrigin(lc.CHAIN_ID, p_mod.MockProvider(lc.CHAIN_ID, blocks),
                                   interval=interval)
            data = o.bundle(target)
            if tamper is not None:
                data = tamper(b_mod, data)
            c = lc.make_client(pkg, blocks)
            c.bundle_source = b_mod.MemoryBundleSource(data)
            got = lc.outcome(lambda: c.verify_light_block_at_height(target, lc.now(pkg, NOW_S)))
            out[pkg] = (got, dict(c.gateway_stats), lc.store_items(c), c.bundle(0),
                        list(c.primary.fetched), o.stats())
            if pkg == "port":
                assert (c.last_bundle_error is None) == (tamper is None)
        assert be.port.batches == be.ref.batches
    assert out["port"] == out["ref"] and out["ref"][0] is None
    assert out["ref"][1]["bundle_syncs"] == (1 if tamper is None else 0)


def test_origin_export_and_sources_agree(chains, tmp_path):
    """The exported directory (index and blobs) is the reference's; a
    client syncs off it; the RPC source checks the content address."""
    dirs = {}
    for pkg in ("ref", "port"):
        _, b_mod, o_mod, _, p_mod = _mods(pkg)
        o = o_mod.BundleOrigin(lc.CHAIN_ID, p_mod.MockProvider(lc.CHAIN_ID,
                                                               chains["static32"][pkg]),
                               interval=8, keep=3)
        dirs[pkg] = (o.export(str(tmp_path / pkg)), o.stats(),
                     [o.get(h).anchor.height for h in (0, 17, 8)])
    assert dirs["port"] == dirs["ref"]
    index = dirs["port"][0]
    for name in index["bundles"].values():
        assert (tmp_path / "port" / f"{name}.bundle").read_bytes() == \
            (tmp_path / "ref" / f"{name}.bundle").read_bytes()
    with lc.Pair():
        c = lc.make_client("port", chains["static32"]["port"])
        c.bundle_source = bundle.DirBundleSource(str(tmp_path / "ref"))
        assert c.verify_light_block_at_height(32, lc.now("port", NOW_S)).hash() == \
            chains["static32"]["port"][32].hash()
        assert c.gateway_stats["bundle_syncs"] == 1
    name = index["latest"]
    data = (tmp_path / "port" / f"{name}.bundle").read_bytes()

    class StubRPC:
        def __init__(self, res):
            self.res = res

        def call(self, method, **kw):
            assert method == "light_bundle"
            return self.res

    good = {"enabled": True, "name": name, "bundle": base64.b64encode(data).decode()}
    bad = dict(good, bundle=base64.b64encode(b"x" + data[1:]).decode())
    for mod in (bundle, ref_bundle):
        assert mod.RemoteBundleSource(StubRPC(good)).bundle(0) == data
        assert mod.RemoteBundleSource(StubRPC({"enabled": False})).bundle(0) is None
    assert lc.outcome(lambda: bundle.RemoteBundleSource(StubRPC(bad)).bundle(0)) == \
        lc.outcome(lambda: ref_bundle.RemoteBundleSource(StubRPC(bad)).bundle(0))


def test_gateway_and_origin_share_the_state_file(chains, tmp_path):
    """The reference's origin writes the state file; the port's gateway
    resumes from it without refetching history, and proves as the
    reference's gateway proves."""
    state = str(tmp_path / "mmr.state")
    ref_origin.BundleOrigin(lc.CHAIN_ID, ref_provider.MockProvider(
        lc.CHAIN_ID, chains["static24"]["ref"]), interval=8, state_path=state).get_encoded(0)
    prov = lc.make_provider("port", chains["static24"]["port"])
    gw = gateway.LightGateway(lc.CHAIN_ID, prov, state_path=state)
    p = gw.prove(5, anchor_height=1)
    ref_p = ref_gateway.LightGateway(lc.CHAIN_ID, ref_provider.MockProvider(
        lc.CHAIN_ID, chains["static24"]["ref"])).prove(5, anchor_height=1)
    assert len(prov.fetched) <= 4 and p["size"] == 24
    assert {k: v for k, v in p.items() if k != "light_block"} == \
        {k: v for k, v in ref_p.items() if k != "light_block"}
    assert p["light_block"].encode() == ref_p["light_block"].encode()
    assert gw.stats()["proof_bytes_served"] == gw.stats()["proof_bytes"] > 0
    assert gw.header_errors == 0


# -- the gateway ------------------------------------------------------------------


def _gw_sync(chains, pkg, which, target, proofs, gw_factory=None):
    _, _, _, g_mod, p_mod = _mods(pkg)
    blocks = chains[which][pkg]
    gw = (gw_factory or (lambda: g_mod.LightGateway(lc.CHAIN_ID, p_mod.MockProvider(
        lc.CHAIN_ID, blocks))))()
    c = lc.make_client(pkg, blocks, gateway=gw, gateway_proofs=proofs)
    got = lc.outcome(lambda: c.verify_light_block_at_height(target, lc.now(pkg, NOW_S)))
    stats = gw.stats() if hasattr(gw, "stats") else None
    return c, gw, (got, dict(c.gateway_stats), lc.store_items(c), list(c.primary.fetched),
                   None if stats is None else {k: v for k, v in stats.items()
                                               if k != "speculate_errors"})


GATEWAY_CASES = {
    # name: (chain, target, proofs first, stats the client must show)
    "plan_sync": ("rotating40", 40, False, {"plan_syncs": 1, "fallbacks": 0}),
    "proof_sync": ("static24", 24, True, {"proof_syncs": 1, "proof_rejects": 0}),
    "diluted_proof_falls_back_to_plan": ("diluted24", 24, True,
                                         {"proof_syncs": 0, "proof_rejects": 1, "plan_syncs": 1}),
}


@pytest.mark.parametrize("name", list(GATEWAY_CASES))
def test_gateway_sync_agrees_with_the_reference(chains, name):
    which, target, proofs, want = GATEWAY_CASES[name]
    with lc.Pair() as be:
        _, _, ref = _gw_sync(chains, "ref", which, target, proofs)
        port_c, port_gw, port = _gw_sync(chains, "port", which, target, proofs)
        assert be.port.batches == be.ref.batches and be.port.classes == be.ref.classes
    assert port == ref and ref[0] is None
    assert {k: ref[1][k] for k in want} == want
    assert port_gw.stats()["speculate_errors"] == 0 and port_gw.header_errors == 0
    assert (port_c.last_gateway_error is None) == (ref[1]["proof_rejects"] == 0)


class _EvilGateway:
    """Proofs under a forged root, and no plan: the client refuses both."""

    def __init__(self, inner, err):
        self.inner, self.err = inner, err

    def sync_plan(self, *a, **kw):
        raise self.err("no plans today")

    def prove(self, height, anchor_height=0):
        out = self.inner.prove(height, anchor_height=anchor_height)
        out["root"] = b"\xde\xad" * 16
        return out


class _PoisonGateway:
    """A plan whose first pivot carries the set of the height below."""

    def __init__(self, inner, blocks, lb_cls, err):
        self.inner, self.blocks, self.lb_cls, self.err = inner, blocks, lb_cls, err

    def sync_plan(self, trusted_height, target_height, now=None):
        plan = self.inner.sync_plan(trusted_height, target_height, now)
        for i, lb in enumerate(plan):
            if lb.height not in (trusted_height, target_height):
                plan[i] = self.lb_cls(signed_header=lb.signed_header,
                                      validator_set=self.blocks[lb.height - 1].validator_set)
                break
        return plan

    def prove(self, *a, **kw):
        raise self.err("mmr disabled")


def test_lying_gateways_never_move_the_decision(chains):
    """A forged proof root and a poisoned plan: both clients refuse, fall
    back, and store what plain bisection stores."""
    out = {}
    with lc.Pair():
        for pkg in ("ref", "port"):
            _, _, _, g_mod, p_mod = _mods(pkg)
            for which, target, proofs, wrap in (
                    ("static24", 24, True, lambda gw, b: _EvilGateway(gw, g_mod.GatewayError)),
                    ("rotating40", 40, False, lambda gw, b: _PoisonGateway(
                        gw, b, type(b[1]), g_mod.GatewayError))):
                blocks = chains[which][pkg]
                real = g_mod.LightGateway(lc.CHAIN_ID, p_mod.MockProvider(lc.CHAIN_ID, blocks))
                _, _, res = _gw_sync(chains, pkg, which, target, proofs,
                                     lambda real=real, blocks=blocks: wrap(real, blocks))
                out.setdefault(pkg, []).append(res)
    assert out["port"] == out["ref"]
    evil, poison = out["ref"]
    assert evil[1]["proof_rejects"] == 1 and evil[1]["fallbacks"] == 1 and evil[0] is None
    assert poison[1]["fallbacks"] == 1 and poison[1]["plan_syncs"] == 0 and poison[0] is None


def test_forged_history_is_never_accepted(chains):
    """A gateway whose MMR holds the real anchor and a forged chain that
    signs itself: both inclusion proofs hold, the trusting overlap does
    not, and the sync fails the same way in both packages."""
    out = {}
    with lc.Pair():
        for pkg in ("ref", "port"):
            m_mod, _, _, g_mod, p_mod = _mods(pkg)
            real, forged = chains["static24"][pkg], chains["forged24"][pkg]
            acc = m_mod.MMR()
            acc.append(real[1].hash())
            for h in range(2, 25):
                acc.append(forged[h].hash())

            class Forging:
                def sync_plan(self, *a, **kw):
                    raise g_mod.GatewayError("no plan")

                def prove(self, height, anchor_height=0, acc=acc, forged=forged):
                    t, a = acc.prove(height - 1), acc.prove(anchor_height - 1)
                    return {"size": acc.size, "root": acc.root(), "light_block": forged[height],
                            "target": {"index": t.index, "aunts": list(t.aunts)},
                            "anchor": {"index": a.index, "aunts": list(a.aunts)}, "bytes": 1}

            prov = p_mod.MockProvider(lc.CHAIN_ID, {1: real[1], **{h: forged[h]
                                                                   for h in range(2, 25)}})
            c = lc.make_client(pkg, real, provider=prov, gateway=Forging(), gateway_proofs=True)
            got = lc.outcome(lambda: c.verify_light_block_at_height(24, lc.now(pkg, NOW_S)))
            out[pkg] = (got, dict(c.gateway_stats), lc.store_items(c))
    assert out["port"] == out["ref"] and out["ref"][0] is not None
    assert out["ref"][1]["proof_syncs"] == 0 and out["ref"][1]["proof_rejects"] == 1


def test_gateway_internals_agree(chains):
    """Session cap, plan LRU, the pruned source, the single-flight claim,
    a degenerate range: the same plans, errors and stats."""
    out = {}
    with lc.Pair():
        for pkg in ("ref", "port"):
            _, _, _, g_mod, p_mod = _mods(pkg)
            blocks = chains["rotating40"][pkg]
            gw = g_mod.LightGateway(lc.CHAIN_ID, p_mod.MockProvider(lc.CHAIN_ID, blocks),
                                    plan_cache=2)
            steps = [lambda: gw.sync_plan(1, 40), lambda: gw.sync_plan(1, 40),
                     lambda: gw.sync_plan(1, 30), lambda: gw.sync_plan(1, 40),
                     lambda: gw.sync_plan(1, 20), lambda: gw.sync_plan(5, 5),
                     lambda: gw._claim((1, 40))]
            res = [lc.outcome(s) for s in steps]
            plans = [tuple(lb.height for lb in gw.sync_plan(1, 40))]
            capped = g_mod.LightGateway(lc.CHAIN_ID, p_mod.MockProvider(lc.CHAIN_ID, blocks),
                                        max_sessions=1)
            capped._enter()
            shed = lc.outcome(lambda: capped.sync_plan(1, 8))
            capped._exit()

            class Pruned(p_mod.MockProvider):
                def base_height(self):
                    return 5

            pruned = g_mod.LightGateway(lc.CHAIN_ID, Pruned(lc.CHAIN_ID, blocks))
            out[pkg] = (res, plans, sorted(gw._plans), gw._claim((1, 40)),
                        {k: v for k, v in gw.stats().items() if k != "speculate_errors"},
                        shed, capped.stats()["sessions_rejected"],
                        lc.outcome(lambda: pruned.prove(12, anchor_height=1)),
                        [b.height for b in pruned.sync_plan(6, 12)], g_mod.proof_mode())
    assert out["port"] == out["ref"]
    assert out["ref"][5][0] == "GatewayError" and "pruned" in out["ref"][7][1]


def _swarm(chains, pkg, n_clients, proofs):
    _, _, _, g_mod, p_mod = _mods(pkg)
    blocks = chains["rotating40"][pkg]
    gw = g_mod.LightGateway(lc.CHAIN_ID, p_mod.MockProvider(lc.CHAIN_ID, blocks))
    results = [None] * n_clients
    barrier = threading.Barrier(n_clients)

    def sync(i):
        try:
            barrier.wait(timeout=30)
            c = lc.make_client(pkg, blocks, gateway=gw, gateway_proofs=proofs)
            lb = c.verify_light_block_at_height(40, lc.now(pkg, NOW_S))
            results[i] = ("ok", lb.hash(), lc.trace(c), dict(c.gateway_stats))
        except Exception as exc:  # noqa: BLE001 - reported by the assert below
            results[i] = ("error", repr(exc), None, None)

    threads = [threading.Thread(target=sync, args=(i,), daemon=True) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return gw, results


@pytest.mark.parametrize("proofs", [False, True], ids=["plan", "mmr"])
def test_swarm_of_8_shares_one_plan(chains, proofs):
    """8 clients at once through one gateway: every trace the same and the
    reference's, one plan computed and 7 shared, in both modes."""
    out = {}
    with lc.Pair():
        for pkg in ("ref", "port"):
            gw, results = _swarm(chains, pkg, 8, proofs)
            assert all(r is not None and r[0] == "ok" for r in results), results
            st = gw.stats()
            out[pkg] = ({r[1] for r in results}, {tuple(r[2]) for r in results},
                        [r[3] for r in results], st["plan_misses"],
                        st["plan_hits"] + st["plan_waits"], st["plan_share_ratio"],
                        st["proofs_served"])
            if pkg == "port":
                assert st["speculate_errors"] == 0
    assert out["port"] == out["ref"]
    assert len(out["ref"][0]) == 1 and len(out["ref"][1]) == 1
    assert out["ref"][3:6] == (1, 7, 8.0)


def test_distinct_targets_coalesce_in_the_scheduler(chains):
    """6 clients with distinct targets over the port's CoalescingScheduler:
    each plan computation's prewarm merges with the others' (the
    reference's test_gateway_concurrent_distinct_targets_coalesce)."""
    blocks = chains["rotating40"]["port"]
    targets = [40 - 2 * i for i in range(6)]
    sched = CoalescingScheduler(backend.CpuBackend(), window_ms=60)
    saved = backend._backend
    backend.set_backend(sched)
    lc.ed25519._verified.clear()
    try:
        gw = gateway.LightGateway(lc.CHAIN_ID, provider.MockProvider(lc.CHAIN_ID, blocks))
        results = [None] * len(targets)
        barrier = threading.Barrier(len(targets))

        def sync(i):
            barrier.wait(timeout=30)
            c = lc.make_client("port", blocks, gateway=gw, gateway_proofs=False)
            results[i] = (c.verify_light_block_at_height(targets[i], lc.now("port", NOW_S)).hash(),
                          c.gateway_stats["fallbacks"])

        threads = [threading.Thread(target=sync, args=(i,)) for i in range(len(targets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert results == [(blocks[t].hash(), 0) for t in targets]
        assert gw.stats()["plan_misses"] == len(targets)
        c = sched.counters()
        assert c["batched_requests"] > 0 and c["requests"] / max(1, c["dispatches"]) > 1.0, c
        assert sched.engine.class_counters_[engine.CLASS_LIGHT]["admitted"] > 0
    finally:
        backend.set_backend(saved)
        sched.close()
        lc.ed25519._verified.clear()


def test_failed_gateway_prewarm_is_counted(chains):
    """A backend that raises on light-class calls: the gateway's prewarms
    fail and are counted with the last exception kept; plans, traces and
    the reference's stats are unchanged."""
    with lc.Pair(fail_classes={engine.CLASS_LIGHT}) as be:
        _, _, ref = _gw_sync(chains, "ref", "rotating40", 40, False)
        port_c, port_gw, port = _gw_sync(chains, "port", "rotating40", 40, False)
        assert be.port.batches == be.ref.batches
    assert port == ref and ref[0] is None
    st = port_gw.stats()
    assert st["speculate_errors"] >= 1 and "planted backend failure" in str(
        port_gw.last_speculate_error)
    # every light-class call raised: each is counted, by the gateway or the client
    light_calls = sum(1 for k in be.port.classes if k == engine.CLASS_LIGHT)
    assert light_calls == st["speculate_errors"] + port_c.speculation["errors"]


def test_engine_keeps_the_class_order_and_the_starvation_hatch():
    """Both packages' engines drain a queue of one request a class in the
    same order: consensus, blocksync, ingress, light; and, once every
    request is older than the starvation age, oldest first (the light
    prewarm is not starved)."""

    class Gate:
        def __init__(self):
            self.busy = threading.Event()
            self.release = threading.Event()
            self.order = []

        def batch_verify(self, pubs, msgs, sigs):
            if pubs == [b"blocker"]:
                self.busy.set()
                self.release.wait(10)
            else:
                self.order.append(list(pubs))
            return True, [True] * len(pubs)

    def drain(eng_mod, starvation_ms):
        gate = Gate()
        eng = eng_mod.VerificationEngine(gate, hold_ms=0, max_sigs=64, starvation_ms=starvation_ms)
        try:
            first = eng.submit([b"blocker"], [b""], [b""], klass=eng_mod.CLASS_BLOCKSYNC)
            assert gate.busy.wait(10)  # the dispatcher holds the blocker
            futs = [eng.submit([bytes([k])], [b""], [b""], klass=k)
                    for k in (eng_mod.CLASS_LIGHT, eng_mod.CLASS_INGRESS,
                              eng_mod.CLASS_BLOCKSYNC, eng_mod.CLASS_CONSENSUS)]
            threading.Event().wait(0.05)
            gate.release.set()
            first.result(10)
            for f in futs:
                f.result(10)
            return gate.order
        finally:
            eng.close()

    for starvation_ms in (10_000.0, 1.0):
        port = drain(engine, starvation_ms)
        assert port == drain(ref_engine, starvation_ms)
    # (a queued consensus request caps the dispatch it rides: the deadline)
    assert sum(drain(engine, 10_000.0), []) == [b"\x00", b"\x01", b"\x02", b"\x03"]
    assert sum(drain(engine, 1.0), []) == [b"\x03", b"\x02", b"\x01", b"\x00"]


# -- the providers ----------------------------------------------------------------


@pytest.fixture(scope="module")
def node_chain():
    return tc.build_ref_chain(b"light-provider", n_vals=4, n_blocks=5, promote_at=2)


def test_block_store_provider_serves_the_reference_blocks(node_chain):
    bs, ss = convert.stores_from_items(node_chain.db_items)
    port = provider.BlockStoreProvider(tc.CHAIN_ID, bs, ss)
    ref = ref_provider.BlockStoreProvider(tc.CHAIN_ID, node_chain.block_store,
                                          node_chain.state_store)
    assert port.base_height() == ref.base_height() == 1
    for h in range(0, 6):
        assert port.light_block(h).encode() == ref.light_block(h).encode()
        assert port.header_hash(max(h, 1)) == ref.header_hash(max(h, 1))
    assert port.header_hash(99) is None
    assert lc.outcome(lambda: port.light_block(9)) == lc.outcome(lambda: ref.light_block(9))


class _FakeRPC:
    """An RPC client double over the reference's own route handlers: the
    JSON a reference node answers (through a JSON round trip)."""

    def __init__(self, env):
        self.routes = routes(env)

    def _call(self, method, **kw):
        return json.loads(json.dumps(self.routes[method](**kw)))

    def commit(self, height=None):
        return self._call("commit", height=height)

    def validators(self, height, page=1, per_page=30):
        return self._call("validators", height=height, page=str(page), per_page=str(per_page))

    def call(self, method, **kw):
        return self._call(method, **kw)

    def broadcast_evidence(self, ev):
        self.evidence = ev


def test_http_provider_and_remote_gateway_decode_the_reference_json(node_chain):
    """HTTPProvider over the reference's /commit and /validators JSON (paged
    at 100 a page), and RemoteGateway over its light_sync and light_proof
    routes, give the reference's light blocks and proofs."""
    ref_gw = ref_gateway.LightGateway(tc.CHAIN_ID, ref_provider.BlockStoreProvider(
        tc.CHAIN_ID, node_chain.block_store, node_chain.state_store))
    env = Environment(block_store=node_chain.block_store, state_store=node_chain.state_store,
                      light_gateway=lambda: ref_gw)
    rpc = _FakeRPC(env)
    port = provider.HTTPProvider(tc.CHAIN_ID, rpc)
    ref = ref_provider.HTTPProvider(tc.CHAIN_ID, rpc)
    for h in (0, 1, 3, 5):
        assert port.light_block(h).encode() == ref.light_block(h).encode()
    assert lc.outcome(lambda: port.light_block(9)) == lc.outcome(lambda: ref.light_block(9))
    port.report_evidence("ev")
    assert rpc.evidence == "ev"
    remote, ref_remote = gateway.RemoteGateway(rpc), ref_gateway.RemoteGateway(rpc)
    assert [lb.encode() for lb in remote.sync_plan(1, 5)] == \
        [lb.encode() for lb in ref_remote.sync_plan(1, 5)]
    p, q = remote.prove(4, anchor_height=1), ref_remote.prove(4, anchor_height=1)
    assert p["light_block"].encode() == q["light_block"].encode()
    assert {k: v for k, v in p.items() if k != "light_block"} == \
        {k: v for k, v in q.items() if k != "light_block"}
    assert remote.stats() == ref_remote.stats()
    assert ref_backend is not None and ref_engine.CLASS_LIGHT == engine.CLASS_LIGHT
