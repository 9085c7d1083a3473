"""The WAL's group commit in the port (``consensus/wal.py``,
``CMTPU_WAL_GROUP_MS``) against the JAX package's, after
``tests/test_vote_batch.py``'s four WAL tests:

- concurrent ``write_sync`` callers share fsyncs and every frame lands; the
  files one package wrote under group commit read the same in the other;
- a ``write_sync`` returns only once its own frame is in the file, while a
  background writer keeps the group windows busy;
- a WAL written under group commit (by either package) restores the round
  it records in a port node and a reference node alike;
- a prevote that only the privval's state file remembers (the WAL lost it)
  is re-published at round 0 and at round 2 with group commit armed, in
  both packages alike.

Waits are liveness guards, never time bounds."""

import os
import shutil
import threading

import pytest

import test_torch_consensus as ttc
from cometbft_tpu.consensus.wal import WAL as RefWAL
from cometbft_tpu.consensus.wal import EndHeightMessage as RefEndHeight
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import sigbatch as ref_sigbatch
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import Time as RefTime
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.block import PREVOTE_TYPE
from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage
from cometbft_tpu_torch.crypto import ed25519, sigbatch
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.types import Vote

pytestmark = pytest.mark.torch_port

PKG = {"port": (WAL, EndHeightMessage), "reference": (RefWAL, RefEndHeight)}


@pytest.fixture
def backends():
    ref_prev, port_prev = ref_backend._backend, backend._backend
    ref_backend.set_backend(ref_backend.CpuBackend())
    backend.set_backend(backend.CpuBackend())
    ref_sigbatch.reset()
    sigbatch.reset()
    try:
        yield
    finally:
        ref_backend.set_backend(ref_prev)
        backend.set_backend(port_prev)
        ref_sigbatch.reset()
        sigbatch.reset()
        ref_ed._verified.clear()
        ed25519._verified.clear()


def _heights(wal) -> list[int]:
    return sorted(tm.msg.height for tm in wal.iter_messages() if hasattr(tm.msg, "height"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_group_commit_coalesces_fsyncs_and_both_read_the_file(tmp_path, monkeypatch, writer):
    """8 threads x 3 ``write_sync`` under a 5 ms window: strictly fewer
    fsyncs than frames, ``group_commits`` > 0, every frame intact; the
    other package reads the same frames from the file."""
    monkeypatch.setenv("CMTPU_WAL_GROUP_MS", "5")
    wal_cls, end_height = PKG[writer]
    path = str(tmp_path / "wal")
    w = wal_cls(path)
    syncs = []
    orig = w.group.flush_and_sync

    def counting():
        syncs.append(1)
        orig()

    w.group.flush_and_sync = counting
    w.start()
    n_threads, per = 8, 3
    barrier = threading.Barrier(n_threads)

    def write(k):
        barrier.wait()
        for j in range(per):
            w.write_sync(end_height(100 + k * per + j))

    threads = [threading.Thread(target=write, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    total = n_threads * per
    assert len(syncs) < total + 1, "group commit never coalesced an fsync"
    assert w.group_commits > 0 and w.group_syncs == len(syncs)
    w.stop()
    want = [0] + list(range(100, 100 + total))
    for reader_cls, _ in PKG.values():
        r = reader_cls(path)
        try:
            assert _heights(r) == want
        finally:
            r.stop()


def test_group_commit_frame_durable_before_return(tmp_path, monkeypatch):
    """Re-read the file right after each return, while a background
    writer keeps the group windows busy: the frame is always there."""
    monkeypatch.setenv("CMTPU_WAL_GROUP_MS", "2")
    w = WAL(str(tmp_path / "wal"))
    w.start()
    stop = threading.Event()

    def noise():
        k = 0
        while not stop.is_set():
            w.write_sync(EndHeightMessage(5000 + k))
            k += 1

    t = threading.Thread(target=noise, daemon=True)
    t.start()
    try:
        for h in range(200, 210):
            w.write_sync(EndHeightMessage(h))
            heights = {
                tm.msg.height for ok, tm in w._scan_frames()
                if ok and isinstance(tm.msg, EndHeightMessage)
            }
            assert h in heights, f"write_sync returned before frame {h} was durable"
        assert w.group_syncs > 0
    finally:
        stop.set()
        t.join(30)
        w.stop()


def test_serial_path_stays_the_default(tmp_path, monkeypatch):
    """Without CMTPU_WAL_GROUP_MS every write_sync syncs alone, as in the
    reference: one fsync a frame, no group counters."""
    monkeypatch.delenv("CMTPU_WAL_GROUP_MS", raising=False)
    w = WAL(str(tmp_path / "wal"))
    syncs = []
    orig = w.group.flush_and_sync
    w.group.flush_and_sync = lambda: (syncs.append(1), orig())
    w.start()
    for h in range(1, 6):
        w.write_sync(EndHeightMessage(h))
    w.stop()
    assert len(syncs) == 6 and w.group_syncs == 0 and w.group_commits == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wal_replay_restores_round_with_group_commit(tmp_path, monkeypatch, backends, writer):
    """A WAL written under group commit (the node's own prevotes at rounds
    0-2 and a ticker timeout) restarts a port node and a reference node at
    round 2 in its prevote step, the own vote back in the vote set."""
    from cometbft_tpu.consensus.cstypes import STEP_PROPOSE as REF_PROPOSE
    from cometbft_tpu.consensus.messages import TimeoutInfo as RefTimeoutInfo
    from cometbft_tpu.consensus.messages import VoteMessage as RefVoteMsg
    from cometbft_tpu.state import make_genesis_state as ref_genesis_state
    from cometbft_tpu_torch.consensus.cstypes import STEP_PROPOSE
    from cometbft_tpu_torch.consensus.messages import TimeoutInfo, VoteMessage

    monkeypatch.setenv("CMTPU_WAL_GROUP_MS", "2")
    gen, ref_pvs, pvs = ttc._restart_genesis()
    idx0, _ = ref_genesis_state(gen).validators.get_by_address(ref_pvs[0].address())
    src = str(tmp_path / "src" / "wal")
    wal = PKG[writer][0](src)
    wal.start()
    for r in range(3):
        signed = ref_pvs[0].sign_vote(ttc.RESTART_CHAIN, RefVote(
            type=PREVOTE_TYPE, height=1, round=r, block_id=RefBlockID(),
            timestamp=RefTime(1700000001, 0), validator_address=ref_pvs[0].address(),
            validator_index=idx0))
        if writer == "reference":
            wal.write_sync(RefVoteMsg(signed))
        else:
            wal.write_sync(VoteMessage(Vote.decode(signed.encode())))
    if writer == "reference":
        wal.write_sync(RefTimeoutInfo(0.4, 1, 2, REF_PROPOSE))
    else:
        wal.write_sync(TimeoutInfo(0.4, 1, 2, STEP_PROPOSE))
    assert wal.group_syncs >= 1
    wal.stop()
    out = {}
    for side, pv in (("ref", ref_pvs[0]), ("port", pvs[0])):
        os.makedirs(tmp_path / side)
        shutil.copy(src, tmp_path / side / "wal")
        cs = ttc._solo(side, gen, pv, str(tmp_path / side / "wal"))
        out[side] = ttc._restarted(cs, 2, pv.address())
        if side == "port":
            assert cs.wal_catchup_errors == 0 and cs.consensus_failures == 0
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (1, 2, True) and out["port"][3] is not None


@pytest.mark.parametrize("lost_round", [0, 2])
def test_privval_recovery_with_group_commit(tmp_path, monkeypatch, backends, lost_round):
    """The privval's sign state holds a prevote at ``lost_round`` that the
    WAL (only its anchor, written under group commit) lost: a port node and
    a reference node restarted over the reference's key and state files
    re-publish the same vote at that round."""
    from cometbft_tpu.privval.file import FilePV as RefFilePV
    from cometbft_tpu.state import make_genesis_state as ref_genesis_state
    from cometbft_tpu.types import GenesisDoc as RefGenesisDoc
    from cometbft_tpu.types import GenesisValidator as RefGenesisValidator
    from cometbft_tpu_torch import convert

    monkeypatch.setenv("CMTPU_WAL_GROUP_MS", "2")
    key = ref_ed.gen_priv_key_from_secret(b"restart-filepv-group")
    src = tmp_path / "src"
    src.mkdir()
    ref_pv = RefFilePV(key, str(src / "key.json"), str(src / "state.json"))
    ref_pv.save()
    others = ttc._restart_genesis()[1][1:]
    gen = RefGenesisDoc(chain_id=ttc.RESTART_CHAIN, genesis_time=RefTime(1700000000, 0),
                        validators=[
                            RefGenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(),
                                                10, f"v{i}")
                            for i, pv in enumerate([ref_pv] + others)])
    gen.validate_and_complete()
    idx, _ = ref_genesis_state(gen).validators.get_by_address(ref_pv.address())
    signed = ref_pv.sign_vote(ttc.RESTART_CHAIN, RefVote(
        type=PREVOTE_TYPE, height=1, round=lost_round, block_id=RefBlockID(),
        timestamp=RefTime(1700000001, 0), validator_address=ref_pv.address(),
        validator_index=idx))
    out = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(src / "key.json", d / "key.json")
        shutil.copy(src / "state.json", d / "state.json")
        if side == "ref":
            pv, w = RefFilePV.load(str(d / "key.json"), str(d / "state.json")), RefWAL(str(d / "wal"))
        else:
            pv = convert.file_pv_from_state_files(str(d / "key.json"), str(d / "state.json"))
            w = WAL(str(d / "wal"))
        w.start()
        assert w.group_syncs == 1
        w.stop()
        cs = ttc._solo(side, gen, pv, str(d / "wal"))
        out[side] = ttc._restarted(cs, lost_round, ref_pv.address())
    assert out["port"] == out["ref"]
    assert out["port"][:3] == (1, lost_round, True)
    assert Vote.decode(out["port"][3]).signature == signed.signature


def test_group_commit_leader_failure_propagates_and_releases(tmp_path, monkeypatch):
    """An fsync that raises reaches the leader's caller, as on the serial
    path, and leaves the leadership free: the next write_sync syncs."""
    monkeypatch.setenv("CMTPU_WAL_GROUP_MS", "1")
    w = WAL(str(tmp_path / "wal"))
    w.start()
    orig = w.group.flush_and_sync
    calls = []

    def failing():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("planted fsync failure")
        orig()

    w.group.flush_and_sync = failing
    with pytest.raises(OSError, match="planted fsync failure"):
        w.write_sync(EndHeightMessage(7))
    w.write_sync(EndHeightMessage(8))
    assert w._sync_leader is False and len(calls) == 2
    w.stop()
    r = WAL(str(tmp_path / "wal"))
    try:
        assert _heights(r) == [0, 7, 8]
    finally:
        r.stop()
