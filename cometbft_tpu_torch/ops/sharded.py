"""Lane-split multi-device programs: one verification step spread over
several devices, and over processes through ``torch.distributed``.

Counterpart of ``cometbft_tpu/ops/sharded.py``. A mesh (``make_mesh``) is
this process's list of devices plus, optionally, a ``torch.distributed``
group that joins the meshes of several processes into one 1-D mesh. Its
global shards are in process-major order, then local index: the order of
the reference's global device list. The list may name one device more
than once; such virtual shards run one after another on it (the CPU
tests, and a one-card host holding the split).

Every program takes this process's columns of its operands (in a
one-process mesh, the whole batch) and gives each local shard one
contiguous run of them:

- ``sharded_verify_fn``: ``ed25519_kernel.verify_core`` a shard (its
  three launches, on the shard's device), no collective; the verdicts of
  this process's lanes. ``sharded_verify_replicated_fn`` all-gathers them,
  so that every process holds the whole bitmap.
- ``sharded_merkle_fn``: leaf digests int32[8, n]; each shard reduces its
  subtree (``_local_tree_root``: the ``sha256`` kernel's digests entry),
  the subtree roots join in global shard order (one all-gather across
  processes), and the digests entry finishes the top.
- ``sharded_leaves_to_root_fn``: the same from pre-padded leaf blocks,
  leaf-hashed on each shard first (the ``sha256`` kernel's leaf entry).
- ``sharded_commit_step_fn``: the verify and the digest-forest root in one
  step, with the all-valid bit summed over every shard (an all-reduce).

Collectives run on ``torch.distributed``: ``nccl`` for a CUDA mesh and
``gloo`` for a CPU mesh, and a group of another backend raises. Bitmaps
and bits cross as uint8 and int32 (NCCL has no bool). Lanes padded with
zeros verify true on the device (ZIP-215); the caller's host mask vetoes
them, as in the reference.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import merkle_kernel as mk
from cometbft_tpu_torch.ops import sha256_kernel as sha

# The lane axis of each verify operand: A, R, S words [8, N], the challenge
# buffer [N, B*32], block counts [N].
VERIFY_LANE_DIMS = (1, 1, 1, 0, 0)
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """This process's shards of a 1-D mesh: ``devices`` (local order),
    ``group`` (None for a one-process mesh), ``rank`` and ``processes``
    within it."""

    def __init__(self, devices, axis: str, group):
        self.devices = tuple(devices)
        self.axis = axis
        self.group = group
        self.processes = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0

    @property
    def local_width(self) -> int:
        return len(self.devices)

    @property
    def width(self) -> int:
        """Shards across every process of the mesh."""
        return self.local_width * self.processes

    def __repr__(self) -> str:
        return (f"Mesh({self.axis}: {[str(d) for d in self.devices]}, "
                f"rank {self.rank} of {self.processes})")


def make_mesh(devices, axis: str = "sig", group=None) -> Mesh:
    """A mesh over this process's ``devices`` (one type; a device may
    repeat), joined with the other processes of ``group`` when given: it
    must be a ``nccl`` group for CUDA devices and ``gloo`` for the CPU, and
    every process must hold as many shards (checked with one all-gather).
    A CUDA device on a host without CUDA raises."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    kind = devs[0].type
    if kind not in _BACKEND_FOR or any(d.type != kind for d in devs):
        raise ValueError(f"make_mesh: devices must all be cuda or all cpu, got {devs}")
    if kind == "cuda":
        resolve(kind)
        devs = [torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
                for d in devs]
        count = torch.cuda.device_count()
        if any(d.index >= count for d in devs):
            raise ValueError(f"make_mesh: {devs} on a host with {count} CUDA devices")
    if group is not None:
        want, got = _BACKEND_FOR[kind], dist.get_backend(group)
        if got != want:
            raise RuntimeError(f"make_mesh: a {kind} mesh needs a {want} group, got {got}")
    mesh = Mesh(devs, axis, group)
    if group is not None:
        here = torch.full((1, 1), len(devs), dtype=torch.int32, device=devs[0])
        if (_gather_columns(mesh, here) != len(devs)).any():
            raise ValueError("make_mesh: every process must hold as many shards")
    return mesh


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _gather_columns(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[rows, k] on devices[0] -> [rows, k x processes], rank order (one
    all-gather; the tensor itself in a one-process mesh)."""
    if mesh.group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.processes)]
    with _on(t.device):
        dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=1)


def _sum_over_processes(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    if mesh.group is not None:
        with _on(t.device):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def as_tensor(op) -> torch.Tensor:
    """A tensor as it is; a numpy array as a CPU tensor (uint32 words as
    int32 with the same bits)."""
    if isinstance(op, torch.Tensor):
        return op
    arr = np.ascontiguousarray(op)
    return torch.from_numpy(arr.view(np.int32) if arr.dtype == np.uint32 else arr)


def split_lanes(mesh: Mesh, op, dim: int) -> list[torch.Tensor]:
    """op's lanes on ``dim`` cut into one contiguous run a local shard,
    each copied to its shard's device."""
    t = as_tensor(op)
    n, k = t.shape[dim], mesh.local_width
    if n % k:
        raise ValueError(f"{n} lanes do not split evenly over {k} shards")
    per = n // k
    return [t.narrow(dim, i * per, per).contiguous().to(d) for i, d in enumerate(mesh.devices)]


def _verify_shards(mesh: Mesh, operands) -> list[torch.Tensor]:
    if len(operands) != 5:
        raise NotImplementedError("the host-hash program (4 operands) is never mesh-sharded")
    per_shard = zip(*(split_lanes(mesh, op, d) for op, d in zip(operands, VERIFY_LANE_DIMS)))
    return [ek.verify_core(*ops) for ops in per_shard]


def _local_columns(mesh: Mesh, shard_outputs, dim: int = 0) -> torch.Tensor:
    d0 = mesh.devices[0]
    return torch.cat([o.to(d0) for o in shard_outputs], dim=dim)


def sharded_verify_fn(mesh: Mesh):
    """Batch verify with the lanes split over the mesh, no collective:
    (A, R, S, challenge buffer, block counts) of this process's lanes ->
    bool[N] verdicts of those lanes, on ``mesh.devices[0]``."""

    def run(*operands):
        return _local_columns(mesh, _verify_shards(mesh, operands))

    return run


def sharded_verify_replicated_fn(mesh: Mesh):
    """``sharded_verify_fn`` with the bitmap all-gathered: every process
    gets bool[N x processes], every lane of the mesh in global order."""
    local = sharded_verify_fn(mesh)

    def run(*operands):
        ok = local(*operands).to(torch.uint8)[None, :]
        return _gather_columns(mesh, ok)[0].bool()

    return run


def _local_tree_root(leaves: torch.Tensor) -> torch.Tensor:
    """int32[8, m] leaf digests -> their subtree root int32[8, 1] (the
    ``sha256`` kernel's digests entry on CUDA)."""
    return mk.digest_tree_root(leaves)


def _check_forest(n: int, mesh: Mesh) -> None:
    k = mesh.local_width
    per = n // k
    if n % k or per < 1 or per & (per - 1):
        raise ValueError(f"{n} leaves do not split into {k} power-of-two subtrees")


def _forest_root(mesh: Mesh, subtree_roots) -> torch.Tensor:
    """This process's subtree roots ([8, 1] each) joined with every other
    process's in global shard order, the top finished: int32[8, 1]."""
    roots = _gather_columns(mesh, _local_columns(mesh, subtree_roots, dim=1))
    return _local_tree_root(roots)


def sharded_merkle_fn(mesh: Mesh):
    """Subtree-parallel root: int32[8, n] leaf digests of this process (n
    split into power-of-two subtrees, one a shard) -> the root of the whole
    mesh's forest int32[8, 1], the same on every process."""

    def run(leaves):
        t = as_tensor(leaves)
        _check_forest(t.shape[1], mesh)
        return _forest_root(mesh, [_local_tree_root(s) for s in split_lanes(mesh, t, 1)])

    return run


def sharded_leaves_to_root_fn(mesh: Mesh):
    """Fused leaves-to-root over the mesh: pre-padded leaf messages (blocks
    uint32[B, 16, n] big-endian words, nblocks int32[n]; ``sha256_kernel.
    pack_messages`` of 0x00 || leaf) leaf-hashed on each shard, each
    subtree reduced there, the roots joined, the top finished ->
    int32[8, 1]."""

    def run(blocks, nblocks):
        blk = as_tensor(blocks)
        _check_forest(blk.shape[2], mesh)
        digests = [mk.leaf_core(b, nb) for b, nb in zip(split_lanes(mesh, blk, 2),
                                                          split_lanes(mesh, nblocks, 0))]
        return _forest_root(mesh, [_local_tree_root(d) for d in digests])

    return run


def sharded_commit_step_fn(mesh: Mesh):
    """Verify and root in one step: the verify operands and int32[8, n]
    leaf digests of this process -> (bool[N] verdicts of its lanes, the
    all-valid bit as a bool tensor: every lane of every shard verified,
    the forest's root int32[8, 1]); bit and root are the same on every
    process."""
    forest = sharded_merkle_fn(mesh)

    def run(a_words, r_words, s_words, msg_words, msg_nblocks, leaf_digests):
        oks = _verify_shards(mesh, (a_words, r_words, s_words, msg_words, msg_nblocks))
        root = forest(leaf_digests)
        d0 = mesh.devices[0]
        full = torch.stack([ok.all().to(d0) for ok in oks]).sum(dtype=torch.int32).reshape(1)
        all_valid = _sum_over_processes(mesh, full)[0] == mesh.width
        return _local_columns(mesh, oks), all_valid, root

    return run


def make_example_batch(n: int, device=None) -> tuple:
    """A deterministic signed batch (key i from the secret b"bench-%d",
    message b"commit-vote-%d"), packed for ``verify_core``: int32 tensors
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        seed = hashlib.sha256(b"bench-%d" % i).digest()
        pub = pure.public_key(seed)
        msg = b"commit-vote-%d" % i
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(pure.sign(seed, pub, msg))
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs)
    if not all(host_ok[:n]):
        raise RuntimeError("example batch fails the host checks")
    return ek.operands_to_device(operands, device)


def example_txs(n: int) -> list[bytes]:
    """The deterministic transactions behind the example leaves."""
    return [b"tx-%d" % i for i in range(n)]


def make_example_leaves(n: int, device=None) -> torch.Tensor:
    """Leaf digests int32[8, n] of ``example_txs(n)`` (the ``sha256``
    kernel's leaf entry on CUDA)."""
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in example_txs(n)])
    dev = resolve(device)
    return mk.leaf_core(torch.from_numpy(blocks.view(np.int32)).to(dev),
                        torch.from_numpy(nblocks).to(dev))
