"""Blocksync's sync loop in the port (``blocksync/pool.py``,
``blocksync/reactor.py``) against the JAX package's reactor. Both reactors
sync a fresh node from the same in-process peer doubles, which serve a chain
that package built (4 validators, one promoted at height 3 so that the set
changes at height 5, a duplicate-vote evidence at height 6) as encoded
``block_response`` messages through ``receive``. Both must apply the same
heights and end with the same database items (blocks, parts, commits,
metas, states, ABCI responses: byte for byte), with the verify/apply
pipeline on and off; a peer that serves a block with one flipped commit
signature is stopped once by both, and the other peer completes the sync.
A recording backend shows the window's batches and that the later checks
land on the verified-triple cache. The reference runs on its
``CpuBackend``, the port on ``TorchBackend(device="cpu")``, the plain
versions of the card's kernels. No tolerance."""

import threading

import pytest
import torch
import torch_chains as tc

from cometbft_tpu.blocksync import reactor as ref_reactor
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.types.block import Block as RefBlock
from cometbft_tpu.types.block import Commit as RefCommit
from cometbft_tpu.types.block import CommitSig as RefCommitSig
from cometbft_tpu_torch.blocksync import reactor as port_reactor
from cometbft_tpu_torch.blocksync.pool import _Requester
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.p2p.reactor import BLOCKSYNC_CHANNEL
from cometbft_tpu_torch.sidecar import backend, engine
from cometbft_tpu_torch.types.block import Block

pytestmark = pytest.mark.torch_port

N_BLOCKS = 10
BAD_HEIGHT = 7  # the block whose LastCommit carries the flipped signature


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chain():
    return tc.build_ref_chain(b"bsync", n_vals=4, n_blocks=N_BLOCKS, promote_at=3, evidence_at=6)


class _Recording:
    """Records each batch a backend is asked to verify (its size, the
    engine class and the thread it came from). With a ``memo``, a batch
    already answered is answered from it (each TorchBackend("cpu") call
    costs most of a second)."""

    def __init__(self, inner, memo=None, fail_calls=()):
        self.inner = inner
        self.memo = memo
        self.fail_calls = set(fail_calls)
        self.batches: list[int] = []
        self.classes: list[int] = []
        self.threads: list[str] = []
        self._lock = threading.Lock()

    def batch_verify(self, pubs, msgs, sigs):
        with self._lock:
            call = len(self.batches)
            self.batches.append(len(pubs))
            self.classes.append(engine.current_class())
            self.threads.append(threading.current_thread().name)
        if call in self.fail_calls or "all" in self.fail_calls:
            raise RuntimeError(f"planted backend failure at call {call}")
        if self.memo is None:
            return self.inner.batch_verify(pubs, msgs, sigs)
        key = (tuple(pubs), tuple(msgs), tuple(sigs))
        if key not in self.memo:
            self.memo[key] = self.inner.batch_verify(pubs, msgs, sigs)
        return self.memo[key]

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


_TORCH_RESULTS: dict = {}


@pytest.fixture
def backends():
    ref_prev, port_prev = ref_backend._backend, backend._backend

    def install(fail_calls=()):
        ref = _Recording(ref_backend.CpuBackend())
        port = _Recording(backend.TorchBackend(device="cpu"), _TORCH_RESULTS, fail_calls)
        ref_backend.set_backend(ref)
        backend.set_backend(port)
        return ref, port

    try:
        yield install
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_ed._verified.clear()
        ed25519._verified.clear()


def _pipeline(monkeypatch, on: bool):
    monkeypatch.setenv("CMTPU_BLOCKSYNC_PIPELINE", "1" if on else "0")


def _sync_both(chain, peers_of):
    """Sync a reference node and a port node from fresh peer doubles;
    clears both verified-triple caches first."""
    ref_ed._verified.clear()
    ed25519._verified.clear()
    out = {}
    for name in ("ref", "port"):
        node = tc.ref_node(chain) if name == "ref" else tc.port_node(chain)
        reactor, switch, applied = tc.sync(tc.REACTORS[name], node, peers_of())
        out[name] = (node, reactor, switch, applied)
    return out


@pytest.mark.parametrize("pipeline", [False, True], ids=["pipeline_off", "pipeline_on"])
def test_sync_matches_reference(chain, backends, monkeypatch, pipeline):
    _pipeline(monkeypatch, pipeline)
    ref_be, port_be = backends()
    out = _sync_both(chain, lambda: [tc.Peer("p1", chain), tc.Peer("p2", chain)])
    (ref_node, ref_r, ref_sw, ref_applied), (node, r, sw, applied) = out["ref"], out["port"]
    assert applied == ref_applied == list(range(1, N_BLOCKS))
    assert list(node.db.iterator()) == list(ref_node.db.iterator())
    assert node.state_store._db.get(b"stateKey") == ref_node.state_store._db.get(b"stateKey")
    for h in range(1, N_BLOCKS):
        assert node.block_store.load_block(h).encode() == chain.blocks[h - 1].encode()
    assert r.state.validators.size() == 5
    assert sw.stops == ref_sw.stops == []
    assert (r.prefetch_errors, r.sync_errors) == (0, 0)
    assert (r.last_prefetch_error, r.last_sync_error) == (None, None)
    assert r._pipeline_enabled == pipeline
    if pipeline:
        assert r.pipeline_overlap_ms > 0
        assert any(t != threading.current_thread().name for t in port_be.threads)
    else:
        assert r.pipeline_overlap_ms == 0
        assert port_be.batches == ref_be.batches
    # Every window call is tagged blocksync, on whichever thread it ran.
    assert set(port_be.classes) == {engine.CLASS_BLOCKSYNC}


def test_window_batches_and_cache_hits(chain, backends, monkeypatch):
    """Pipeline off: the window verifies heights 1-4 (the 4-validator set,
    16 signatures) and then 5-9 (the 5-validator set, 25) in two backend
    calls; every light check and validate_block's full check after them is
    answered by the verified-triple cache, so no other lane reaches the
    backend. The reference sends the same batches."""
    _pipeline(monkeypatch, False)
    ref_be, port_be = backends()
    _sync_both(chain, lambda: [tc.Peer("p1", chain)])
    assert port_be.batches == ref_be.batches == [16, 25]
    assert sum(port_be.batches) == 4 * 4 + 5 * 5


def test_window_prefetch_survives_valset_change(chain, backends, monkeypatch):
    """The port of the reference's test of the same name: blocks placed in
    the pool directly, the set change mid-window must not stall the sync."""
    _pipeline(monkeypatch, True)
    backends()
    node = tc.port_node(chain)
    reactor = port_reactor.BlocksyncReactor(
        state=node.state, block_exec=node.executor, block_store=node.block_store, block_sync=True)
    for h in range(1, N_BLOCKS + 1):
        req = _Requester(h)
        req.block = Block.decode(chain.blocks[h - 1].encode())
        req.peer_id = "p1"
        reactor.pool._requesters[h] = req
    applied = 0
    while reactor._try_sync_one():
        applied += 1
    reactor._pipeline_wait()
    assert applied == N_BLOCKS - 1, f"applied {applied}; the set change must not stall sync"
    assert reactor.state.validators.size() == 5
    assert reactor.state.validators.has_address(chain.new_pv.address())
    assert (reactor.prefetch_errors, reactor.sync_errors) == (0, 0)


def _flipped_block(chain, height: int) -> bytes:
    """The block at ``height`` with its LastCommit's first signature
    flipped in one bit, as a block_response."""
    block = chain.blocks[height - 1]
    sigs = list(block.last_commit.signatures)
    cs = sigs[0]
    bad = bytearray(cs.signature)
    bad[0] ^= 0x01
    sigs[0] = RefCommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, bytes(bad))
    commit = RefCommit(height=block.last_commit.height, round=block.last_commit.round,
                       block_id=block.last_commit.block_id, signatures=sigs)
    tampered = RefBlock(header=block.header, data=block.data, evidence=block.evidence,
                        last_commit=commit)
    return ref_reactor.encode_block_response(tampered)


@pytest.mark.parametrize("pipeline", [False, True], ids=["pipeline_off", "pipeline_on"])
def test_bad_peer_is_stopped_once(chain, backends, monkeypatch, pipeline):
    _pipeline(monkeypatch, pipeline)
    backends()
    bad = _flipped_block(chain, BAD_HEIGHT)
    out = _sync_both(chain, lambda: [tc.Peer("p1", chain, {BAD_HEIGHT: bad}),
                                     tc.Peer("p2", chain)])
    (ref_node, _, ref_sw, ref_applied), (node, r, sw, applied) = out["ref"], out["port"]
    assert [p for p, _ in sw.stops] == [p for p, _ in ref_sw.stops] == ["p1"]
    assert sw.stops == ref_sw.stops
    assert applied == ref_applied == list(range(1, N_BLOCKS))
    assert list(node.db.iterator()) == list(ref_node.db.iterator())
    assert r.sync_errors == 1 and r.prefetch_errors == 0
    assert "wrong signature (#0)" in str(r.last_sync_error)


def test_errors_are_counted_not_hidden(chain, backends, monkeypatch):
    """A backend that fails once, on the window's call: the prefetch counts
    it and keeps it, and the sync completes through the per-block checks.
    A backend that always fails: every trySync failure is counted, kept,
    and stops the peer, as the reference does, without a word otherwise."""
    _pipeline(monkeypatch, False)
    _, port_be = backends(fail_calls=(0,))
    node = tc.port_node(chain)
    r, sw, applied = tc.sync(port_reactor.BlocksyncReactor, node, [tc.Peer("p1", chain)])
    assert applied == list(range(1, N_BLOCKS))
    assert (r.prefetch_errors, r.sync_errors) == (1, 0)
    assert "planted backend failure at call 0" in str(r.last_prefetch_error)
    assert sw.stops == []

    backends(fail_calls=("all",))
    ed25519._verified.clear()
    node = tc.port_node(chain)
    r, sw, applied = tc.sync(port_reactor.BlocksyncReactor, node, [tc.Peer("p1", chain)],
                             max_rounds=3)
    assert applied == []
    assert r.sync_errors == 1 and r.prefetch_errors >= 1
    assert "planted backend failure" in str(r.last_sync_error)
    assert [p for p, _ in sw.stops] == ["p1"]


def test_pipeline_overlap_counts_as_the_reference(chain):
    """The same job times and apply window give the same overlap."""
    values = []
    for cls, node in ((ref_reactor.BlocksyncReactor, tc.ref_node(chain)),
                      (port_reactor.BlocksyncReactor, tc.port_node(chain))):
        r = cls(state=node.state, block_exec=node.executor, block_store=node.block_store,
                block_sync=False)
        for started, ended, done, t0, t1 in ((10.0, 10.5, True, 10.2, 10.9),
                                             (20.0, 0.0, False, 20.1, 20.4),
                                             (30.0, 30.1, True, 30.2, 30.3)):
            ev = threading.Event()
            if done:
                ev.set()
            r._pf_job = (ev, [started, ended])
            r._pipeline_account(t0, t1)
        values.append(r.pipeline_overlap_ms)
    assert values[0] == values[1]
    assert round(values[1], 6) == 300.0 + 300.0


def test_reactor_serves_its_store(chain):
    """A serving port reactor answers block, status and missing-block
    requests with the reference's bytes."""
    from cometbft_tpu_torch import convert

    bs, _ = convert.stores_from_items(chain.db_items)
    node = tc.port_node(chain)
    r = port_reactor.BlocksyncReactor(state=node.state, block_exec=None, block_store=bs,
                                      block_sync=False)

    class Sink:
        id = "sink"

        def __init__(self):
            self.sent = []

        def try_send(self, chan_id, msg):
            self.sent.append((chan_id, msg))
            return True

    peer = Sink()
    r.add_peer(peer)
    r.receive(BLOCKSYNC_CHANNEL, peer, ref_reactor.encode_block_request(4))
    r.receive(BLOCKSYNC_CHANNEL, peer, ref_reactor.encode_block_request(N_BLOCKS + 3))
    r.receive(BLOCKSYNC_CHANNEL, peer, ref_reactor.encode_status_request())
    assert peer.sent == [
        (BLOCKSYNC_CHANNEL, ref_reactor.encode_status_response(N_BLOCKS, 1)),
        (BLOCKSYNC_CHANNEL, ref_reactor.encode_status_request()),
        (BLOCKSYNC_CHANNEL, ref_reactor.encode_block_response(chain.blocks[3])),
        (BLOCKSYNC_CHANNEL, ref_reactor.encode_no_block_response(N_BLOCKS + 3)),
        (BLOCKSYNC_CHANNEL, ref_reactor.encode_status_response(N_BLOCKS, 1)),
    ]
    assert [c.id for c in r.get_channels()] == [BLOCKSYNC_CHANNEL]
    assert r.get_channels()[0].recv_message_capacity == 50 * 1024 * 1024
