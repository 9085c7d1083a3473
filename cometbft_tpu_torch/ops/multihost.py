"""One verification step across processes (hosts), over
``torch.distributed``.

Counterpart of ``cometbft_tpu/ops/multihost.py``. Each process joins a
group (``distributed_init``: ``nccl`` for the CUDA devices it sees,
``gloo`` for virtual CPU shards) and gets its part of one 1-D mesh
(``sharded.make_mesh``): its devices, in global shard order process-major.
Packing is columnar (a packed lane depends on its own signature only), so
a process contributes exactly its contiguous columns of the batch, and the
step's collectives (one all-reduce, all-gathers in the list form that
``gloo`` and ``nccl`` both take) give every process the same root and
all-valid bit. Every process must enter the collectives in the same order.

``MultihostShardBackend`` lets such a group serve as one shard of a fanout
fleet: the leader (rank 0) serves it through an ordinary ``SidecarServer``
and, for each batch, sends the triples to its followers over framed side
sockets (the sidecar's own framing and wire fields); then every process
runs the same ``multihost_verify``, whose replicated bitmap lets the
leader answer alone. Followers run ``follow_verify_loop``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import sharded
from cometbft_tpu_torch.sidecar.service import read_frame, write_frame
from cometbft_tpu_torch.wire import proto


def distributed_init(coordinator, num_processes: int, process_id: int,
                     local_devices: int | None = None) -> sharded.Mesh:
    """Join (or form) the verification group and return this process's
    part of its mesh (axis ``sig``).

    coordinator: an init-method URL (``tcp://host:port``, ``file:///path``),
    a bare ``host:port`` (taken as TCP), or a ``torch.distributed.Store``.
    local_devices: the number of virtual CPU shards this process holds (a
    CPU mesh over ``gloo``); None takes every CUDA device this process sees
    (a CUDA mesh over ``nccl``), and raises without CUDA or NCCL."""
    if local_devices is not None:
        backend, devices = "gloo", ["cpu"] * local_devices
        if not dist.is_gloo_available():
            raise RuntimeError("distributed_init: this PyTorch has no gloo backend")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: a CUDA mesh was requested but "
                               "torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("distributed_init: this PyTorch has no nccl backend")
        backend = "nccl"
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        torch.cuda.set_device(devices[0])
    kw = {"backend": backend, "world_size": num_processes, "rank": process_id}
    if isinstance(coordinator, dist.Store):
        kw["store"] = coordinator
    else:
        kw["init_method"] = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(**kw)
    return sharded.make_mesh(devices, group=dist.group.WORLD)


def process_local_columns(mesh: sharded.Mesh, dim: int, cols):
    """This process's share of a mesh-wide operand (numpy or tensor): the
    contiguous [rank x share, (rank + 1) x share) slice of its lanes on
    ``dim``, share = lanes / processes."""
    n = cols.shape[dim]
    if n % mesh.processes:
        raise ValueError(f"{n} lanes do not split over {mesh.processes} processes")
    share = n // mesh.processes
    return _lanes(cols, dim, mesh.rank * share, share)


def _lanes(op, dim: int, start: int, count: int):
    return op[(slice(None),) * dim + (slice(start, start + count),)]


def multihost_commit_step(mesh, local_operands, local_leaf_digests):
    """``sharded.sharded_commit_step_fn`` with this process's inputs: its
    lanes of the packed verify operands (``ed25519_kernel.pack_batch``'s
    layout, ``process_local_columns`` of the whole batch) and its
    uint32[8, n_local] leaf-digest columns. Returns (its bool bitmap as
    numpy, all_valid, the root uint32[8, 1]); all_valid and the root are the
    same on every process."""
    step = sharded.sharded_commit_step_fn(mesh)
    ok, all_valid, root = step(*local_operands, local_leaf_digests)
    return ok.cpu().numpy(), bool(all_valid), root.cpu().numpy().view(np.uint32)


# -- fanout-serving seam -----------------------------------------------------


def multihost_verify(mesh, pubs, msgs, sigs):
    """One collective batch verify; every process calls it with the same
    triples in the same order (the leader's broadcast sees to it on the
    serving path). Every process packs the whole batch and contributes its
    contiguous columns. A process's share is rounded up the bucket ladder
    (``ed25519_kernel.bucket_for`` at its shard count) and to a multiple of
    its shards; padded lanes are zeros, and the host mask vetoes them.
    Returns (ok, bits), the whole bitmap on every process."""
    n = len(pubs)
    per = ek.bucket_for(max(1, -(-n // mesh.processes)), mesh.local_width)
    per += -per % mesh.local_width
    total = per * mesh.processes
    if total > n:
        pad = total - n
        pubs = list(pubs) + [b"\x00" * 32] * pad
        msgs = list(msgs) + [b""] * pad
        sigs = list(sigs) + [b"\x00" * 64] * pad
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs, 1)
    if len(operands) != 5:
        raise NotImplementedError(
            "host-hash packing (oversized messages) cannot serve the multi-host verify step"
        )
    local = [_lanes(op, dim, mesh.rank * per, per)
             for op, dim in zip(operands, sharded.VERIFY_LANE_DIMS)]
    dev_ok = sharded.sharded_verify_replicated_fn(mesh)(*local).cpu().numpy()
    bits = [bool(host_ok[i] and dev_ok[i]) for i in range(n)]
    return all(bits), bits


def _encode_triples(pubs, msgs, sigs) -> bytes:
    """The leader-to-follower body: BatchVerifyReq's fields, so the side
    channel carries nothing the sidecar's wire does not."""
    return (
        b"".join(proto.field_bytes(1, p, emit_default=True) for p in pubs)
        + b"".join(proto.field_bytes(2, m, emit_default=True) for m in msgs)
        + b"".join(proto.field_bytes(3, s, emit_default=True) for s in sigs)
    )


def _decode_triples(body: bytes):
    fields = proto.decode_fields(body)
    return (
        proto.get_repeated_bytes(fields, 1),
        proto.get_repeated_bytes(fields, 2),
        proto.get_repeated_bytes(fields, 3),
    )


class MultihostShardBackend:
    """The VerifyBackend the leader of a multi-process mesh serves through
    its SidecarServer when the whole mesh is one fanout shard.

    ``batch_verify`` writes the triples to every follower's side socket (one
    frame each; an empty frame means shutdown), then joins the collective
    verify itself. The lock keeps the frame order the collective order.
    ``merkle_root`` is the host tree: one tree a call has nothing to split
    across hosts."""

    name = "multihost"

    def __init__(self, mesh, followers):
        self.mesh = mesh
        self._followers = list(followers)
        self._lock = threading.Lock()

    def mesh_width(self) -> int:
        """Shards across every process of the mesh."""
        return self.mesh.width

    def batch_verify(self, pubs, msgs, sigs):
        if len(pubs) == 0:
            return False, []
        with self._lock:
            body = _encode_triples(pubs, msgs, sigs)
            for sock in self._followers:
                write_frame(sock, body)
            return multihost_verify(self.mesh, pubs, msgs, sigs)

    def merkle_root(self, leaves):
        return hash_from_byte_slices(list(leaves))

    def ping(self) -> bool:
        return True

    def close(self) -> None:
        """Send every follower the shutdown frame and close its socket."""
        with self._lock:
            for sock in self._followers:
                try:
                    write_frame(sock, b"")
                    sock.close()
                except OSError:
                    pass
            self._followers = []


def follow_verify_loop(mesh, sock) -> int:
    """A follower: mirror every batch the leader sends into the collective
    verify (its result is the leader's to answer with); return the number
    of batches served once the leader sends the empty frame or closes."""
    served = 0
    while True:
        body = read_frame(sock)
        if not body:
            return served
        multihost_verify(mesh, *_decode_triples(body))
        served += 1
