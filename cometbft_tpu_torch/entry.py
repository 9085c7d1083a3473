"""Entry points of the port: a one-card compile check and a multi-shard dry
run (the counterpart of the JAX package's ``__graft_entry__.py``).

``entry()`` returns the port's verification program and a 128-signature
example batch for it. ``dryrun_multichip(n)`` runs the whole commit step
(the signature batch split over the ``sig`` axis, the Merkle forest one
subtree a shard, the all-valid sum) on n virtual shards of one device at a
tiny size, and checks it.

    python -m cometbft_tpu_torch.entry [N]     # on the card, N = 2 by default
"""

from __future__ import annotations

import sys


def entry(device=None):
    """(the verify program, its operands): ``ed25519_kernel.verify_core`` and
    ``sharded.make_example_batch(128)`` on ``device`` (``cuda`` unless the
    caller asks for the CPU); four operands (pre-hashed digests) take
    ``verify_core_hosthash``. ``fn(*args)`` is bool[128], all true."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops.sharded import make_example_batch

    example_args = make_example_batch(128, device)
    fn = ek.verify_core_hosthash if len(example_args) == 4 else ek.verify_core
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """``sharded_commit_step_fn`` on ``n_devices`` virtual shards of
    ``device`` (``cuda`` unless the caller asks for the CPU), 8 signatures
    and 8 leaves a shard: asserts the all-valid bit, every lane, and the
    forest's root against the host tree."""
    from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
    from cometbft_tpu_torch.device import resolve
    from cometbft_tpu_torch.ops import sha256_kernel as sha
    from cometbft_tpu_torch.ops.sharded import (
        example_txs,
        make_example_batch,
        make_example_leaves,
        make_mesh,
        sharded_commit_step_fn,
    )

    dev = resolve(device)
    mesh = make_mesh([dev] * n_devices)
    n_sigs = 8 * n_devices  # one bucket-8 shard a device
    n_leaves = 8 * n_devices
    operands = make_example_batch(n_sigs, dev)
    leaves = make_example_leaves(n_leaves, dev)
    ok, all_valid, root = sharded_commit_step_fn(mesh)(*operands, leaves)
    assert bool(all_valid), "dryrun batch must verify"
    assert bool(ok[:n_sigs].all()), "dryrun lanes must verify"  # padded to the batch bucket
    want = hash_from_byte_slices(example_txs(n_leaves))
    got = sha.digest_words_to_bytes(root.cpu().numpy())[0]
    assert got == want, "sharded merkle root mismatch"
    print(f"dryrun_multichip({n_devices}) on {dev}: ok, verify + merkle + all-valid sum sharded",
          flush=True)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    assert bool(out.all()), "entry() example batch must verify"
    print(f"entry(): ok, {tuple(out.shape)} all valid", flush=True)
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
