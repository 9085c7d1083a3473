"""The port's multi-process programs (``ops/multihost.py``) on the CPU: two
real OS processes, each with 2 virtual CPU shards, join one ``gloo`` group
(rendezvous through a file store under the test's tmp_path) and form one
4-wide mesh.

- ``multihost_commit_step`` on 32 signatures and 64 leaf digests: both
  processes read the same root, equal to the host tree and to the
  reference's ``sharded_merkle_fn``, and the same all-valid bit; each sees
  only its half of the bitmap.
- ``multihost_verify`` with a bad lane, a shape-invalid lane and a count
  that is not a multiple of the width: the exact bitmap on every process.
- Serve mode: the leader serves ``MultihostShardBackend`` behind the port's
  ``SidecarServer`` on 127.0.0.1:0, driven by the reference's
  ``GrpcBackend``; Ping reports width 4, a commit's bitmap is exact, and
  the follower reports the batches it served when the shutdown frame comes.
- On a host with two or more cards (skipped otherwise): one ``nccl`` rank a
  card (up to 4), the same step and verify, every rank agreeing with the
  host tree and the exact bitmap. It imports no jax, so it also runs on a
  GPU host: ``python -m pytest --noconftest -p no:cacheprovider
  tests/test_torch_multihost.py -k nccl``.

Run as a script, this file is one worker process (the tests start them):

    python tests/test_torch_multihost.py step|step-nccl|serve RANK NPROC RDZV_FILE [SIDE_PORT]

``step`` and ``serve`` hold 2 virtual CPU shards a process over gloo;
``step-nccl`` holds the one card the process sees over nccl.

No wall-clock bound is asserted: each child has its own generous timeout,
and its peers are killed when one fails.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from cometbft_tpu_torch.crypto import ed25519_pure as pure  # noqa: E402
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices  # noqa: E402
from cometbft_tpu_torch.ops import ed25519_kernel as ek  # noqa: E402
from cometbft_tpu_torch.ops import sharded  # noqa: E402
from cometbft_tpu_torch.ops import sha256_kernel as sha  # noqa: E402

pytestmark = pytest.mark.torch_port

LOCAL_SHARDS = 2
N_SIGS = 32
N_LEAVES = 64
N_VERIFY = 11  # not a multiple of the 4-wide mesh
BAD_SIG, BAD_SHAPE = 3, 7
CHILD_TIMEOUT_S = 300


def _signed(n, tag):
    seeds = [hashlib.sha256(b"%s-%d" % (tag, i)).digest() for i in range(n)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"%s-vote-%d" % (tag, i) for i in range(n)]
    sigs = [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]
    return pubs, msgs, sigs


def _verify_case():
    """N_VERIFY triples, lane BAD_SIG with a flipped signature bit and lane
    BAD_SHAPE with a short key; the expected bitmap."""
    pubs, msgs, sigs = _signed(N_VERIFY, b"mh-verify")
    sigs[BAD_SIG] = sigs[BAD_SIG][:40] + bytes([sigs[BAD_SIG][40] ^ 1]) + sigs[BAD_SIG][41:]
    pubs[BAD_SHAPE] = pubs[BAD_SHAPE][:31]
    return pubs, msgs, sigs, [i not in (BAD_SIG, BAD_SHAPE) for i in range(N_VERIFY)]


# -- the worker -------------------------------------------------------------


def _worker_step(mesh) -> dict:
    """This process's columns of the commit and of the leaf digests through
    multihost_commit_step, then multihost_verify on the verify case."""
    from cometbft_tpu_torch.ops import multihost

    pubs, msgs, sigs = _signed(N_SIGS, b"mh")
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs, 1)
    assert all(host_ok[:N_SIGS]) and operands[0].shape[1] == N_SIGS
    leaves = sharded.make_example_leaves(N_LEAVES, mesh.devices[0])
    local = tuple(multihost.process_local_columns(mesh, dim, op)
                  for op, dim in zip(operands, sharded.VERIFY_LANE_DIMS))
    local_leaves = multihost.process_local_columns(mesh, 1, leaves)
    ok_local, all_valid, root = multihost.multihost_commit_step(mesh, local, local_leaves)
    vp, vm, vs, _ = _verify_case()
    ok, bits = multihost.multihost_verify(mesh, vp, vm, vs)
    return {
        "rank": mesh.rank, "processes": mesh.processes, "width": mesh.width,
        "ok_local": [bool(b) for b in ok_local], "all_valid": all_valid,
        "root": sha.digest_words_to_bytes(root)[0].hex(), "verify_ok": ok, "verify_bits": bits,
    }


def _worker(argv) -> int:
    mode, rank, nproc, rdzv = argv[0], int(argv[1]), int(argv[2]), argv[3]
    side_port = int(argv[4]) if len(argv) > 4 else 0
    torch.set_num_threads(1)
    listener = None
    if mode == "serve" and rank == 0:
        # Bind the follower rendezvous first and announce its real port.
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(nproc - 1)
        print(json.dumps({"rank": 0, "side_port": listener.getsockname()[1]}), flush=True)

    from cometbft_tpu_torch.ops import multihost

    shards = None if mode == "step-nccl" else LOCAL_SHARDS
    mesh = multihost.distributed_init(f"file://{rdzv}", nproc, rank, local_devices=shards)
    if mode.startswith("step"):
        print(json.dumps(_worker_step(mesh)), flush=True)
    elif rank == 0:
        from cometbft_tpu_torch.sidecar.service import SidecarServer

        followers = [listener.accept()[0] for _ in range(nproc - 1)]
        listener.close()
        backend = multihost.MultihostShardBackend(mesh, followers)
        server = SidecarServer("127.0.0.1:0", backend=backend).start()
        print(json.dumps({"rank": 0, "addr": server.bound_addr, "width": backend.mesh_width()}),
              flush=True)
        sys.stdin.read()  # serve until the parent closes stdin
        server.shutdown()
        backend.close()
        print(json.dumps({"rank": 0, "closed": True}), flush=True)
    else:
        side = socket.create_connection(("127.0.0.1", side_port), timeout=CHILD_TIMEOUT_S)
        side.settimeout(None)
        served = multihost.follow_verify_loop(mesh, side)
        print(json.dumps({"rank": rank, "served": served}), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))


# -- the tests ----------------------------------------------------------------


def _spawn(mode, rank, rdzv, side_port=0, nproc=2, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, __file__, mode, str(rank), str(nproc), str(rdzv), str(side_port)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=REPO,
    )


def _finish(procs) -> list:
    """Each child's last stdout line as JSON; every child is killed if one
    fails, so none outlives the test."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, err.decode(errors="replace")[-3000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    rdzv = tmp_path_factory.mktemp("mh_step") / "rdzv"
    return _finish([_spawn("step", r, rdzv) for r in (0, 1)])


def test_two_process_commit_step_agrees_on_root_and_verdict(step_runs):
    import jax

    from cometbft_tpu.ops import sharded as ref_sharded
    from cometbft_tpu.ops import sha256_kernel as ref_sha

    want_root = hash_from_byte_slices(sharded.example_txs(N_LEAVES))
    ref_mesh = ref_sharded.make_mesh(jax.devices())
    ref_root = ref_sharded.sharded_merkle_fn(ref_mesh)(ref_sharded.make_example_leaves(N_LEAVES))
    assert ref_sha.digest_words_to_bytes(ref_root)[0] == want_root
    for rank, rec in enumerate(step_runs):
        assert rec["rank"] == rank and rec["processes"] == 2 and rec["width"] == 4
        assert rec["all_valid"] is True
        assert rec["ok_local"] == [True] * (N_SIGS // 2)  # its half of the bitmap
        assert rec["root"] == want_root.hex()


def test_two_process_verify_gives_the_exact_bitmap_on_every_rank(step_runs):
    pubs, msgs, sigs, want = _verify_case()
    assert ek.batch_verify(pubs, msgs, sigs, device="cpu") == (False, want)
    for rec in step_runs:
        assert rec["verify_ok"] is False and rec["verify_bits"] == want


def test_two_process_mesh_serves_as_one_shard(tmp_path):
    from cometbft_tpu.sidecar.service import GrpcBackend as RefGrpcBackend

    rdzv = tmp_path / "rdzv"
    leader = _spawn("serve", 0, rdzv)
    procs, client = [leader], None
    try:
        line = leader.stdout.readline()
        assert line, leader.stderr.read().decode(errors="replace")[-3000:]
        procs.append(_spawn("serve", 1, rdzv, json.loads(line)["side_port"]))
        line = leader.stdout.readline()
        assert line, leader.stderr.read().decode(errors="replace")[-3000:]
        rec = json.loads(line)
        assert rec["width"] == 4
        client = RefGrpcBackend(rec["addr"], timeout_s=CHILD_TIMEOUT_S)
        assert client.ping() and client.mesh_width() == 4
        pubs, msgs, sigs, want = _verify_case()
        assert client.batch_verify(pubs, msgs, sigs) == (False, want)
        good = _signed(6, b"mh-serve")
        assert client.batch_verify(*good) == (True, [True] * 6)
        assert client.merkle_root(sharded.example_txs(5)) == hash_from_byte_slices(
            sharded.example_txs(5))
    finally:
        if client is not None:
            client.close()
        outs = _finish(procs)  # closes the leader's stdin first: its shutdown
    assert outs == [{"rank": 0, "closed": True}, {"rank": 1, "served": 2}]


def test_nccl_ranks_one_card_each_agree(tmp_path):
    """One nccl rank a card (CUDA_VISIBLE_DEVICES), up to four: the commit
    step's root and all-valid bit equal on every rank and to the host tree,
    each rank its share of the bitmap, and the verify case's exact bitmap."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one nccl rank a card")
    nproc = min(4, torch.cuda.device_count())
    rdzv = tmp_path / "rdzv"
    outs = _finish([_spawn("step-nccl", r, rdzv, nproc=nproc,
                           env_extra={"CUDA_VISIBLE_DEVICES": str(r)}) for r in range(nproc)])
    want_root = hash_from_byte_slices(sharded.example_txs(N_LEAVES)).hex()
    want_bits = _verify_case()[3]
    for rank, rec in enumerate(outs):
        assert (rec["rank"], rec["processes"], rec["width"]) == (rank, nproc, nproc)
        assert rec["all_valid"] is True and rec["root"] == want_root
        assert rec["ok_local"] == [True] * (N_SIGS // nproc)
        assert rec["verify_ok"] is False and rec["verify_bits"] == want_bits
