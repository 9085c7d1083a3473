"""The port's light client (``light/client.py``, ``store.py``,
``provider.py``, ``detector.py``) against the JAX package's: both take the
same light blocks (the reference's, and the port's decoded from their wire
bytes) from chains of 4 validators and 20 heights built by the package's
own ``test_light.ChainMaker`` over keys from fixed secrets, static and
rotating one validator a height. For each case of ``test_light.py`` both
clients give the same outcome (exception type and text), fetch the same
heights, store the same bytes and count the same descents; a recording
backend shows the same batches and that the hop checks after a descent's
prewarm send no lane. The detector's cases give byte-identical evidence; a
backend that fails inside the witness check or the prewarm keeps the
reference's verdicts and is counted. Both packages verify on their host
backend (``CpuBackend``); one case runs the port on
``TorchBackend(device="cpu")``, the plain versions of the card's kernels."""

import pytest
import torch
import torch_light_chains as lc

from cometbft_tpu.light import detector as ref_detector
from cometbft_tpu.light import provider as ref_provider
from cometbft_tpu.light import verifier as ref_verifier
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.light.store import LightStore as RefLightStore
from cometbft_tpu.sidecar import engine as ref_engine
from cometbft_tpu.types.evidence import encode_evidence as ref_encode_evidence
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light import detector, provider, verifier
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.sidecar import backend as port_backend
from cometbft_tpu_torch.sidecar import engine
from cometbft_tpu_torch.types import Time
from cometbft_tpu_torch.types.evidence import encode_evidence

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
    static = lc.chain(b"light-static", heights=20)
    rotating = lc.chain(b"light-rotating", heights=20, rotate=1)
    # the same validators sign a second chain with another app hash (an
    # attack), and unrelated validators a third (a bad witness)
    evil = lc.chain(b"light-static", heights=20, pool=static.pool, app_hash=b"\xff" * 32)
    other = lc.chain(b"light-other", heights=20)
    out = {}
    for name, c in (("static", static), ("rotating", rotating), ("evil", evil), ("other", other)):
        out[name] = {"ref": c.blocks, "port": lc.port_blocks(c.blocks)}
    return out


def _sync(pkg, blocks, target, now_s=NOW_S, trust_height=1, **kw):
    c = lc.make_client(pkg, blocks, trust_height=trust_height, **kw)
    got = lc.outcome(lambda: c.verify_light_block_at_height(target, lc.now(pkg, now_s)))
    return c, {"outcome": got, "fetched": list(c.primary.fetched), "store": lc.store_items(c),
               "trace": lc.trace(c),
               "speculation": {k: c.speculation[k] for k in ("descents", "prewarmed_sigs")}}


CASES = {
    # name: (chain, target, trust height, now, client options, outcome type)
    "static_one_jump": ("static", 20, 1, NOW_S, {}, None),
    "rotation_bisects": ("rotating", 20, 1, NOW_S, {}, None),
    "sequential": ("rotating", 10, 1, NOW_S, {"skip_verification": "sequential"}, None),
    "backwards": ("static", 3, 8, NOW_S, {}, None),
    "expired": ("static", 5, 1, lc.T0 + 3 * 3600, {}, "ErrOldHeaderExpired"),
    "within_trusted_range": ("rotating", 20, 1, NOW_S, {}, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_client_agrees_with_the_reference(chains, name):
    which, target, trust_h, now_s, kw, want = CASES[name]
    blocks = chains[which]
    with lc.Pair() as be:
        ref_c, ref = _sync("ref", blocks["ref"], target, now_s, trust_h, **kw)
        port_c, port = _sync("port", blocks["port"], target, now_s, trust_h, **kw)
        if name == "within_trusted_range":
            # a height between two stored ones verifies forward from below
            for c, pkg, out in ((ref_c, "ref", ref), (port_c, "port", port)):
                out["outcome"] = lc.outcome(lambda: c.verify_light_block_at_height(
                    11, lc.now(pkg, now_s)))
                out["fetched"], out["store"] = list(c.primary.fetched), lc.store_items(c)
        assert port == ref
        assert (None if ref["outcome"] is None else ref["outcome"][0]) == want
        assert be.port.batches == be.ref.batches
        assert port_c.speculation["errors"] == 0 and port_c.detector_errors == 0
    if name == "rotation_bisects":
        assert ref["speculation"]["descents"] >= 2 and len(ref["fetched"]) > 2
    if name == "sequential":
        assert [h for h, _ in port["trace"]] == list(range(1, 11))


def test_bad_validator_sets_agree(chains):
    """A provider that serves a block with another height's set (the
    header's validators hash no longer matches), and verify_adjacent on a
    hop that skips a height (test_light's bad next set), raise the same."""
    outs = {}
    with lc.Pair():
        for pkg in ("ref", "port"):
            blocks = dict(chains["rotating"][pkg])
            lb3, lb4 = blocks[3], blocks[4]
            blocks[3] = type(lb3)(signed_header=lb3.signed_header, validator_set=lb4.validator_set)
            c = lc.make_client(pkg, blocks, skip_verification="sequential")
            seq = lc.outcome(lambda: c.verify_light_block_at_height(5, lc.now(pkg, NOW_S)))
            v = ref_verifier if pkg == "ref" else verifier
            b1, b3 = chains["rotating"][pkg][1], chains["rotating"][pkg][3]
            adj = lc.outcome(lambda: v.verify_adjacent(
                b1.signed_header, b3.signed_header, b3.validator_set, lc.TRUSTING_NS,
                lc.now(pkg, NOW_S), 10 * 10**9))
            outs[pkg] = (seq, adj, lc.store_items(c))
    assert outs["port"] == outs["ref"]
    assert outs["ref"][0][0] == "ValueError" and outs["ref"][1] is not None


def test_update_to_latest(chains):
    with lc.Pair():
        got = {}
        for pkg in ("ref", "port"):
            blocks = {h: lb for h, lb in chains["static"][pkg].items() if h <= 7}
            c = lc.make_client(pkg, blocks)
            first = c.update(lc.now(pkg, NOW_S))
            second = c.update(lc.now(pkg, NOW_S))
            got[pkg] = (first.height, first.hash(), second, lc.store_items(c))
    assert got["port"] == got["ref"] and got["ref"][0] == 7 and got["ref"][2] is None


def test_descent_prewarms_and_cached_hops(chains):
    """test_speculative_descent_is_bit_identical, ported: with and without
    the prewarm both clients store the same trace; the prewarm calls (light
    class) have the same sizes in the same order in both packages, and once
    the first prewarm has run every backend call is a prewarm: the hop
    checks that decide send no lane."""
    blocks = chains["rotating"]
    runs = {}
    with lc.Pair() as be:
        for pkg in ("ref", "port"):
            _, runs[pkg] = _sync(pkg, blocks[pkg], 20)
        for rec in (be.ref, be.port):
            light = [i for i, k in enumerate(rec.classes) if k == engine.CLASS_LIGHT]
            assert light and all(k == engine.CLASS_LIGHT for k in rec.classes[light[0]:])
        assert be.port.batches == be.ref.batches and be.port.classes == be.ref.classes
    saved = lc.port_client.Client._speculate_descent
    lc.port_client.Client._speculate_descent = lambda self, current, stack: None
    try:
        with lc.Pair() as be:
            _, unspeculated = _sync("port", blocks["port"], 20)
            assert engine.CLASS_LIGHT not in be.port.classes
    finally:
        lc.port_client.Client._speculate_descent = saved
    assert runs["port"] == runs["ref"]
    assert unspeculated["trace"] == runs["port"]["trace"]
    assert unspeculated["speculation"] == {"descents": 0, "prewarmed_sigs": 0}
    assert runs["port"]["speculation"]["descents"] >= 2


def test_failed_prewarm_is_counted_and_changes_nothing(chains):
    """A backend that raises on every prewarm (light class): both clients
    reach the same trace through the hop checks themselves; the port counts
    each failed prewarm and keeps the last exception."""
    blocks = chains["rotating"]
    with lc.Pair(fail_classes={engine.CLASS_LIGHT}) as be:
        _, ref = _sync("ref", blocks["ref"], 20)
        port_c, port = _sync("port", blocks["port"], 20)
        assert be.port.batches == be.ref.batches
    assert port == ref and ref["outcome"] is None
    assert port_c.speculation["errors"] == port_c.speculation["descents"] >= 2
    assert "planted backend failure" in str(port_c.last_speculation_error)


def test_store_bytes_load_across(chains):
    """A light store the reference wrote loads in the port (same keys and
    values), and the cache knob reads as the reference's."""
    with lc.Pair():
        ref_c, _ = _sync("ref", chains["rotating"]["ref"], 20)
    items = lc.store_items(ref_c)
    db = MemDB()
    for k, v in items:
        db.set(k, v)
    store = LightStore(db)
    assert store._heights() == ref_c.store._heights()
    for h in store._heights():
        assert store.light_block(h).encode() == ref_c.store.light_block(h).encode()
        assert convert.light_block_from_wire(ref_c.store.light_block(h).encode()).hash() == \
            ref_c.store.light_block(h).hash()
    assert store.light_block_before(6).height == ref_c.store.light_block_before(6).height
    store.prune(3)
    ref_c.store.prune(3)
    assert [(bytes(k), bytes(v)) for k, v in db.iterator()] == lc.store_items(ref_c)
    for cap in ("3", "junk"):
        import os

        os.environ["CMTPU_LIGHT_STORE_CACHE"] = cap
        try:
            assert LightStore(MemDB())._cache_blocks == RefLightStore(RefMemDB())._cache_blocks
        finally:
            del os.environ["CMTPU_LIGHT_STORE_CACHE"]


# -- the detector -------------------------------------------------------------


def _detect(chains, pkg, witness_chains, **kw):
    mock = ref_provider.MockProvider if pkg == "ref" else provider.MockProvider
    witnesses = []
    for name in witness_chains:
        blocks = dict(chains[name][pkg])
        blocks[1] = chains["static"][pkg][1]
        witnesses.append(mock(lc.CHAIN_ID, blocks))
    primary = lc.make_provider(pkg, chains["static"][pkg])
    c = lc.make_client(pkg, chains["static"][pkg], provider=primary, witnesses=witnesses, **kw)
    got = lc.outcome(lambda: c.verify_light_block_at_height(10, lc.now(pkg, NOW_S)))
    enc = ref_encode_evidence if pkg == "ref" else encode_evidence
    return c, {
        "outcome": got,
        "to_witnesses": [[enc(ev) for ev in w.evidences] for w in witnesses],
        "to_primary": [enc(ev) for ev in primary.evidences],
        "witnesses_left": [witnesses.index(w) for w in c.witnesses],
        "store": lc.store_items(c),
    }


DETECTOR_CASES = {
    # name: (witness chains, outcome type)
    "conflicting_witness": (["evil"], "ErrLightClientAttack"),
    "unverifiable_witness_dropped": (["other", "static"], None),
    "no_witnesses_left": (["other"], "ErrNoWitnesses"),
    "honest_witness": (["static"], None),
}


@pytest.mark.parametrize("name", list(DETECTOR_CASES))
def test_detector_agrees_with_the_reference(chains, name):
    witness_chains, want = DETECTOR_CASES[name]
    with lc.Pair() as be:
        _, ref = _detect(chains, "ref", witness_chains)
        port_c, port = _detect(chains, "port", witness_chains)
        assert be.port.batches == be.ref.batches
    assert port == ref
    assert (None if ref["outcome"] is None else ref["outcome"][0]) == want
    if name == "conflicting_witness":
        # evidence of the primary's block to the witness and of the
        # witness's block to the primary, byte for byte the reference's
        assert ref["to_witnesses"][0] and ref["to_primary"]
        assert port_c.detector_errors == 0
    elif name in ("unverifiable_witness_dropped", "no_witnesses_left"):
        # the bad witness's chain fails to verify from the common header:
        # tolerated as the reference does, and counted
        assert not any(ref["to_witnesses"]) and not ref["to_primary"]
        assert port_c.detector_errors == 1
        assert port_c.last_detector_error is not None
    else:
        assert port_c.detector_errors == 0


def test_failed_witness_check_keeps_the_verdict_and_is_counted(chains, monkeypatch):
    """A backend that raises inside _witness_chain_verifies, facing a real
    attack: the reference drops the witness as bad and, with no witness
    left, raises ErrNoWitnesses; the port gives the same verdict, and counts
    the failure once with the planted exception kept."""
    recs = {}

    def armed(mod, rec_of):
        orig = mod._witness_chain_verifies

        def wrapped(*args, **kw):
            rec = rec_of()
            rec.armed = True
            try:
                return orig(*args, **kw)
            finally:
                rec.armed = False

        monkeypatch.setattr(mod, "_witness_chain_verifies", wrapped)

    with lc.Pair() as be:
        recs["ref"], recs["port"] = be.ref, be.port
        armed(ref_detector, lambda: recs["ref"])
        armed(detector, lambda: recs["port"])
        _, ref = _detect(chains, "ref", ["evil"])
        port_c, port = _detect(chains, "port", ["evil"])
        assert be.port.batches == be.ref.batches
    assert port == ref and ref["outcome"][0] == "ErrNoWitnesses"
    assert port_c.detector_errors == 1
    assert "planted backend failure" in str(port_c.last_detector_error)


def test_detector_on_the_plain_kernels(chains):
    """The conflicting witness again, the port on TorchBackend("cpu"): the
    same evidence bytes as on the host backend."""
    with lc.Pair():
        _, host = _detect(chains, "port", ["evil"])
    saved = port_backend._backend
    port_backend.set_backend(lc.Recording(port_backend.TorchBackend(device="cpu"), engine))
    lc.ed25519._verified.clear()
    try:
        _, plain = _detect(chains, "port", ["evil"])
    finally:
        port_backend.set_backend(saved)
        lc.ed25519._verified.clear()
    assert plain == host and plain["outcome"][0] == "ErrLightClientAttack"
    assert ref_engine.CLASS_LIGHT == engine.CLASS_LIGHT


def test_light_client_verifies_on_the_card_by_default(chains, monkeypatch):
    """With no backend installed, the light client's checks and a
    duplicate-vote check go to the process default (``CMTPU_BACKEND=auto``),
    which needs a card: without one they raise, they do not drop to the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback path is not reachable")
    from cometbft_tpu_torch.crypto import ed25519, sigbatch

    monkeypatch.delenv("CMTPU_BACKEND", raising=False)
    prev = port_backend._backend
    port_backend._backend = None
    ed25519._verified.clear()
    try:
        c = lc.make_client("port", chains["rotating"]["port"])
        with pytest.raises(RuntimeError, match="CUDA"):
            c.verify_light_block_at_height(20, Time(NOW_S, 0))
        assert c.speculation["errors"] >= 1  # the failed prewarms, counted
        lb = chains["static"]["port"][2]
        sig = lb.signed_header.commit.signatures[0]
        msg = lb.signed_header.commit.vote_sign_bytes(lc.CHAIN_ID, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            sigbatch.SigBatcher(window_ms=2.0).verify_many(
                [lb.validator_set.validators[0].pub_key], [msg], [sig.signature])
    finally:
        port_backend._backend = prev
        ed25519._verified.clear()
