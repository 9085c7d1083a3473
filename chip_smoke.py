"""Smoke run of the PyTorch/CUDA port (cometbft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --bn254-lanes   # only the bn254 kernel's times
    python3 chip_smoke.py --light         # only the light path (and what it needs)

Drives the port's paths at the repo's headline sizes. The Ed25519 / Merkle
path is the ``VerifyBackend`` contract through ``TorchBackend()``: one
10,240-signature commit (vote-shaped challenges) plus the RFC-6962 root of
a 65,536-leaf block. The proofs path is ``proofs_from_byte_slices_device``
(one inclusion proof a transaction or block part) at that block, at 10,000
leaves and at a 21 MiB block's 336 parts of 64 KiB. The sidecar path is the
port's entry point, ``SidecarServer`` over a local socket. The BN254 path is
the aggregate-commit contract through ``Bn254DeviceBackend()``: one
10,240-validator aggregate commit (README "Aggregate BLS commits") and a
16-vote bitmap batch. The hybrid path is ``HybridBackend()`` (the card and
the native host MSM) at the commit and block, and the chain path the
supervised chains (``build_resilient()``, ``build_bn254_chain()``) with and
without an injected fault. The auto path is the process default
(``get_backend()`` under ``CMTPU_BACKEND=auto``), the fanout path the fleet
tier (two port sidecars, one in another process, and the local hybrid), the
proofs paths ``crypto/merkle``'s selection, the tooling path the
profiling endpoints, ``entry.py`` and the device probe, the commit path
commit verification (``types/validation``, ``light/verifier``) of a
10,240-validator set's commits and hops, the blocksync path a fresh
node syncing a 10,240-validator chain (and a 150-validator one) from peers
through ``blocksync/reactor.BlocksyncReactor``, which verifies each window
of commits in one backend call and applies each block through
``state/execution.BlockExecutor``, the kvstore application and the mempool,
and the light path the light client (``light/client.Client``: bisection
whose descent prewarms a whole hop chain's commits in one backend call),
its gateway, the detector and the evidence pool over those chains.
In order:

  1. prints the PyTorch version and the card (name, power limit);
  2. builds the CUDA kernels from ``cometbft_tpu_torch/ops/csrc``; then
     (after the issue rates of step 4 are measured) starts two processes
     that load them: ``python -m cometbft_tpu_torch.sidecar`` on
     127.0.0.1:0 (the fleet's remote shard, warmed) and ``python -m
     cometbft_tpu_torch.probe.device``, and waits for both to be done with
     their first use of the card before anything is timed;
  3. makes the fixtures from fixed seeds (keys, signatures, leaves, parts);
  4. holds each kernel against its plain PyTorch version on the card at the
     main path's shapes (exact equality; bn254 equal mod P), and times both
     (the kernel by CUDA events over back-to-back launches and by its own
     device time in a torch.profiler trace, ``kernel_ms``): sha512's
     ``challenge_digits`` on the commit and on a ragged batch up to 32
     blocks with a zero-block lane (k also against hashlib), and its
     ``scalar_digits`` with the all-ones and zero digests, s = L - 1 and
     s = 0; ``decompress_words`` on the commit's A and R words with the
     ZIP-215 edge encodings mixed in; the ladder (fused with the
     cofactored epilogue) at every group width it is built for, timed in
     turns, verdict and accumulator; the sha256 tree entry at the 65,536-
     and 10,000-leaf roots, its leaf and inner entries level by level, and
     its levels entry (every tree level, what the proofs run) at 65,536 and
     10,000 leaves, at the part set, its ragged form and a short/long mix,
     and the part set's block cut into leaves of several lengths under each
     leaf load and chunk; the bn254 Miller loop at 8,192, 4,096 and 32
     lanes (the aggregate's two chunks, the vote batch) with edge lanes (the padding lane, coordinates 0, 1 and
     P - 1, off-curve field elements); prints ptxas's registers and spills,
     the ladder's and bn254's launch shapes and, where cuobjdump exists,
     the ladder's SASS instruction mix, the measured issue rates of the
     instructions it runs on (``cometbft_tpu_torch/probe``) and the
     issue-time estimate they give;
  5. runs the Ed25519 / Merkle path (launch counters zeroed just before):
     the valid commit, the commit with localized corruptions, the ZIP-215
     edge batch, an oversized message (host-hash program), the 65,536- and
     10,000-leaf roots, each against its expected answer, and asserts one
     sha512, one decompress and one ladder launch a batch and two sha256
     launches a root; then times ``verify_10k_commit_plus_64k_merkle_ms``
     and its stage split, and traces one such call (``torch.profiler``:
     each kernel's device time, and the device's busy time over the call);
  6. runs the proofs path (counters zeroed just before): at each size the
     root and every proof equal the host's ``proofs_from_byte_slices_pure``,
     every 97th proof and the last verify, two sha256 launches a proof set;
     then times ``proofs_64k_ms``, its stage split and the host's time;
  7. runs the sidecar path: ``SidecarServer`` on 127.0.0.1:0 in this
     process serving ``TorchBackend()``, warmed; the port's ``GrpcBackend``
     sends every request of step 5 through the socket (the commit streamed
     in chunks) and the commit once more unary, each answer held as in step
     5, three launches a verify dispatch and two a root; then times
     ``sidecar_verify_10k_commit_plus_64k_merkle_ms`` beside the in-process
     headline, with the warm-up's seconds and the scheduler's counters; the
     server's and client's threads end at shutdown;
  8. runs the BN254 path (counters zeroed just before): the 10,240-validator
     aggregate accepts, the aggregate with one signer's share left out
     rejects, each in two bn254 launches (8,192 lanes + a bucket of 4,096),
     and the 16-vote batch with one bad signature gives the exact bitmap in
     one launch; then the aggregate's stage split (parse and decompress,
     hash, pack, kernel, unpack, Fp12 product, final exponentiation);
  9. runs the hybrid path (counters zeroed after TorchBackend's answers):
     ``HybridBackend()`` warmed as the sidecar warms it (the native host
     library built, the card's walls at 128, 1,024 and 10,240), three forced
     shares through ``_routed_call`` (0, all host; HYBRID_SPLIT, which puts
     the corrupted commit's bad indices on both sides; the whole commit)
     on the valid and the corrupted commit, each bitmap equal to
     TorchBackend's, ``verify_and_root`` equal to TorchBackend's bitmap and
     root, then HYBRID_CALLS planned calls; three launches a call with a
     device share, none else; prints the planner's shares, ``last_timing``
     and learned rates, then the medians of the hybrid, TorchBackend and
     CpuBackend at the commit, the roots and ``verify_and_root``, the rate
     seeds this run gives (``sidecar/backend.HOST_SIGS_PER_MS`` and the
     card's two), and the same three medians (and the native MSM's) at the
     smaller batches of HYBRID_SMALL_SIGS, each bitmap checked, with the
     share the planner gave the card; the roots at HYBRID_ROOT_LEAVES, the
     native tree against the card (bytes equal, medians of 5), and the root
     cost model's seeds they give (``CARD_ROOT_MS``, ``CARD_LEAVES_PER_MS``,
     ``HOST_LEAVES_PER_MS``); the warmed hybrid's 65,536-leaf root must go
     to the card (two sha256 launches);
 10. runs the chain path (counters zeroed): ``build_resilient()`` serves
     the commit, the corrupted commit and the root from ``hybrid`` with no
     degradation; the hybrid wrapped in a ChaosBackend at error rate 1.0
     degrades to ``cpu`` with the same bitmaps;
     ``ResilientBackend(build_bn254_chain())`` serves the 16-vote batch's
     exact bitmap from ``bn254-device`` (one bn254 launch), then, its
     device tier wrapped at error rate 1.0, from ``bn254-host``;
 11. runs the auto path: a fresh ``get_backend()`` under
     ``CMTPU_BACKEND=auto`` (the coalesced chain, its hybrid warmed), then,
     counts zeroed, the commit, the corrupted commit and AUTO_SIGS' smaller
     batches, each bitmap equal to TorchBackend's, served by ``hybrid`` with
     no degradation, the first 150-signature call with a share on the card;
     medians of 5 beside TorchBackend's; ``set_backend(None)`` closes it;
 12. runs the fanout path: medians of the fleet's commit beside
     TorchBackend's and its walls at FANOUT_FIT_SIGS (its fixed cost,
     ``fanout.FANOUT_DISPATCH_MS``); counts zeroed, ``build_resilient()``
     headed by ``fanout`` of width 3, exact bitmaps; the other process
     killed, one redistribution and exact bits, the root failed over;
 13. runs the proofs paths (counts zeroed): the card and the native host
     pass at the 65,536-leaf block and the part set, equal to the pure pass
     on every 97th proof, medians of 3, and the default's path
     (``crypto/merkle.DEVICE_PROOFS_DEFAULT``);
 14. runs the tooling (counts zeroed): ``PprofServer`` on port 0,
     ``/debug/torch/memory`` after a headline call (allocated bytes on
     cuda:0) and ``/debug/torch/trace?seconds=1`` during headline calls (a
     trace written; whether it holds the ladder's record);
     ``dryrun_multichip(2)``; ``entry()``; the device probe's PROBE OK;
 15. runs the commit path: the commit fixtures, built with the port's
     types alone (``commit_fixtures``: the 10,240-validator ed25519 set of
     step 3's keys, headers at COMMIT_HEIGHT, +1 and +5 and their commits of
     canonical precommits, each signed by its validator in a pool of
     processes; a hop the trusted set cannot trust; a 150-validator commit;
     a 16-validator BN254 aggregate commit), their build time; then, counts
     zeroed, ``types/validation`` and ``light/verifier`` under
     ``set_backend(TorchBackend())``: verify_commit and verify_commit_light
     of the commit, the adjacent and the skipping hop pass, the commit with
     5 corrupted signatures names the lowest (the backend's bitmap false at
     exactly the 5), the commit with just over 1/3 of the power absent gives
     the exact got and needed, the untrustable hop raises
     ErrNewValSetCantBeTrusted, and the BN254 aggregate (and a copy with one
     wrong signer) goes through ``get_bn254_backend()``; one sha512 /
     decompress / ladder set a commit verification that reaches the backend
     (two for the skipping hop), one bn254 launch an aggregate, no
     ChainExhausted fallback; then ``verify_commit_10k_ms``: medians of 5 of
     each commit check at 10,240 and 150 validators and of both hops, under
     ``TorchBackend()`` and the process default in turns, each call from
     freshly decoded objects and an empty verified-triple cache, and one
     call's stage split (sign bytes, tally and ``bv.add``, cache filter, the
     backend call with its pack and kernels, the hop's hashes);
 16. runs the blocksync path: a source node (the port's BlockExecutor,
     CListMempool and PersistentKVStoreApplication over a MemDB) builds
     BSYNC_HEIGHTS blocks of the 10,240-validator set of step 3's keys
     (BSYNC_TXS kvstore transactions of BSYNC_TX_BYTES a block, every
     validator signing its precommit in the process pool) and
     BSYNC_SMALL_HEIGHTS blocks of a BSYNC_SMALL-validator set; then a
     fresh node syncs each through ``BlocksyncReactor`` from two peer
     doubles that answer block requests through ``receive``. Counts zeroed,
     pipeline off, the part sets' proofs on the card
     (``CMTPU_DEVICE_PROOFS=1``), under a recording backend around
     ``TorchBackend()``, each stage timed: the synced state and stored
     blocks equal the source's; the window calls carry the window
     arithmetic's batches (20,480 signatures at 10,240 validators, 4,650 at
     150) and the later checks send only what no window covered (counted by
     lanes); each part set took the path its size gives; one sha512 /
     decompress / ladder set a backend call and two sha256 launches a part
     set on the card; no error counted. A peer serving one block with a
     flipped commit signature bit is stopped exactly once and the other
     completes the sync (``sync_errors`` 1, ``prefetch_errors`` 0). Then
     ``blocksync_10k_ms_per_block`` and ``blocksync_150_ms_per_block``:
     the default (pipeline on, the native proofs pass) under
     ``TorchBackend()`` and the process default in turns, BSYNC_REPS rounds,
     the pipeline off beside it, ``pipeline_overlap_ms``, the stage split
     of each height; no ChainExhausted fallback. Last, the three verify
     kernels at each batch shape the path gave them (both windows, one
     commit, both light checks: 20,480, 10,240, 6,827, 4,650 and 101 lanes,
     four lanes of each corrupted), each against its plain version on the
     same operands with max abs err 0 and the verdicts false at exactly the
     corrupted lanes, then timed by events;
 17. runs the light path (``light/``, ``evidence/``, ``crypto/sigbatch``):
     fixtures built with the port's types (``light_fixtures``): a
     10,240-validator chain of LIGHT_HEIGHTS heights whose set rotates
     LIGHT_ROTATE keys a height (height 1's set is step 3's keys; only the
     heights the walk fetches, LIGHT_SIGNED, are signed), a 150-validator
     chain of LIGHT_SMALL_HEIGHTS rotating LIGHT_SMALL_ROTATE a height, and
     conflicting tips of step 16's two source chains, every signature in the
     process pool; then, counts zeroed, under a recording backend around
     ``TorchBackend()``: a client syncs the 10,240-validator chain from
     height 1 to 9 (skipping, trust level 1/3, an honest witness), and the
     150-validator chain's skipping (1 to 100), sequential (1 to 20) and
     backwards (50 to 40) clients; each trace equals the same client's
     under ``CpuBackend()`` and the walk's arithmetic (``light_walk``: the
     pivots fetched, the descents, the lanes of every backend call, so that
     the hop checks after a prewarm send none); LIGHT_SWARM clients on
     threads cold-sync the 150-validator chain through one ``LightGateway``
     under the port's ``CoalescingScheduler``, in plan mode and in MMR proof
     mode (one plan computed, the rest shared, one trace, at most one lone
     client's lanes plus the gateway's prewarm, every launch from the one
     device-owner thread); a witness serving a conflicting tip of step 16's
     150-validator source is caught (ErrLightClientAttack), the evidence
     reaches an ``EvidencePool`` over the source's stores and the source's
     executor commits it in the next block; a 10,240-validator attack
     evidence verifies (3,414 lanes); a duplicate vote verifies through
     sigbatch under ``TorchBackend()`` (its private window) and the process
     default (its engine), a flipped copy is refused; every error counter
     as planted (none), one sha512 / decompress / ladder set a card call.
     Then ``light_sync_10k_ms``, ``light_sync_150_ms`` and
     ``evidence_verify_10k_ms`` (medians of LIGHT_REPS, ``TorchBackend()``
     and the process default in turns, cold caches), ``light_gateway_64_ms``
     in each mode, the 10,240 sync's stage split, the lanes of every call by
     its caller; last, the three verify kernels at the path's own batches
     (the largest prewarm at each size, the evidence check), four lanes of
     each corrupted, held to their plain versions and timed;
 18. runs the mesh path (the lane-split programs) on two virtual shards of
     the card: first the sha256 digests entry against its plain version on
     every word at the block's 65,536 leaf digests and at 10,000, 3 and 1
     (timed beside its bound), then, counters zeroed, TorchBackend and
     Bn254DeviceBackend routed over the mesh (the commit, the corrupted
     commit, the 65,536-leaf root, the 10,240-validator aggregate and the
     one with a share left out), the sharded and replicated verify, the
     digest forest, the fused leaves-to-root and the commit step called
     directly, and multihost_commit_step, multihost_verify and
     MultihostShardBackend on a one-rank NCCL group: each bitmap equal to
     TorchBackend's on one device, each root the host's, each step's
     launches exact; then ``mesh_commit_step_10k_64k_ms`` (two virtual
     shards on one card, not a multi-GPU figure);
 19. prints the ``kernels`` line (launches summed over the paths, and by
     path), the card line and, last, the result line.

Any failure raises and exits nonzero, and ends the processes it started.
Without CUDA it exits nonzero before printing any result. It imports
nothing of JAX or of ``cometbft_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_SIGS = 10_240
N_LEAVES = 65_536
N_RAGGED_LEAVES = 10_000
SEED = 20_260_417
# A block cut into parts of BLOCK_PART_SIZE_BYTES (the reference's
# types/block.py:26): 336 parts of 64 KiB, a 21 MiB block.
N_PARTS = 336
PART_BYTES = 65_536

# Hopper's 32-bit integer add / multiply-add / logic / shift rate per SM
# per clock (CUDA C Programming Guide, arithmetic throughput, cc 9.0).
INT32_OPS_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# Operation counts behind each kernel's bound (see PERF.md).
# 32x32->64 multiply-adds of one radix-2^25.5 field multiply (10 x 10
# limb products) and of one squaring (10 squares + 45 doubled cross terms)
FE_MUL_OPS = 100
FE_SQ_OPS = 55
# Ladder, a lane: the [1..8](-A) table (to_precomp, then 7 x (add_precomp 8
# + to_precomp 1)); 64 windows of 4 doublings (4 squarings and 3
# multiplies each, 4 in the last), add_precomp (8) and add_precomp_z1 (7);
# the epilogue's point_add (9) and 3 doublings without T.
LADDER_FE_MULS = 1 + 7 * 9 + 64 * (3 * 3 + 4 + 8 + 7) + 9 + 3 * 3
LADDER_FE_SQS = 64 * 4 * 4 + 3 * 4
# Decompress, a lane: the (p-5)/8 chain (251 squarings, 11 multiplies) and
# 4 squarings and 9 multiplies around it.
DECOMPRESS_FE_MULS = 11 + 9
DECOMPRESS_FE_SQS = 251 + 4
DECOMPRESS_GROUP = 1  # threads a lane (kGroup in decompress.cu)
SHA512_BLOCK_OPS = 2 * (80 * 25 + 64 * 13 + 8)  # 64-bit ops, two 32-bit ops each
# What sha512 does a lane after hashing, in 32-bit operations: k mod L
# (three folds: 18 products of 64-bit words, 4 multiply-adds and 4 adds
# each; 9 high words of 3 shifts and an or, twice; 16 words of
# add-then-subtract with carries, 16; the 4-word conditional subtraction,
# 14 a word) and the recodes of k and s (4 words of add with carry, 8
# each, and 64 digits of shift, mask and subtract).
SCALAR_LANE_OPS = 18 * 8 + 9 * 6 + 16 * 16 + 4 * 14 + 2 * (4 * 8 + 64 * 3)
SHA256_BLOCK_OPS = 64 * 25 + 48 * 13 + 8
# BN254 Miller loop, a lane, by the reference program's formulas
# (cometbft_tpu/ops/bn254_kernel.py:352): 64 doubling steps of 157 Fp
# multiplies (f^2 63: 21 Fp2 products of 3; the doubling 40, its line 54),
# 38 addition steps of 97 (the addition 43, its line 54) and 26 conversions
# into and out of Montgomery form; 136 32x32->64 products a multiply (CIOS
# over eight words: 64 for a*b, 8 quotient words, 64 for m*p). The bound
# holds to this count whatever the kernel's schedule does: that schedule's
# own count (bn254_schedule.lane_muls(), fewer, with Fp2 squares in 2
# products) is printed beside it. Bytes: P, Q, pi(Q), -pi^2(Q) in and the
# Fp12 value out, 13 float64 limbs an Fp element.
BN254_FP_MULS = 64 * 157 + 38 * 97 + 26
BN254_FP_MUL_OPS = 136
BN254_LANE_BYTES = (2 + 3 * 4 + 12) * 13 * 8
# The bn254 launches of the BN254 path: the aggregate's chunks (8,192 lanes
# and the bucket of 4,096 its 2,049 left-over lanes take) and the 16-vote
# batch (32 lanes). The earlier one-thread-a-lane kernel's time at each, by
# CUDA events on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, the kernel
# table): the team kernel fails the run where it is not faster.
BN254_LANE_COUNTS = (8192, 4096, 32)
ONE_THREAD_BN254_MS = {8192: 21.24, 4096: 21.80, 32: 17.96}
# The part set's ragged form (a block whose size is not a multiple of 64
# KiB: its last part shorter) and a mix of short leaves and long ones (every
# 5th; long on average, so the long-leaf levels launch).
RAGGED_LAST_PART = 12_345
# The levels entry's leaf loads and chunk, timed apart: the part set's block
# cut into leaves of each length, under byte loads in chunks of CHUNK (the
# short-leaf launch), byte loads in chunks of LONG_LEAF_CHUNK, and word
# loads in chunks of LONG_LEAF_CHUNK (the long-leaf launch); the lengths
# span merkle_kernel.LONG_LEAF_BYTES, where the wrapper switches.
SWEEP_LEAF_BYTES = (256, 1024, 2048, 4096, 16_384, 65_536)
N_MIX = 100
MIX_LONG = (65_536, 65_537, 4_095, 20_000, 65_535, 8_191)
N_VALIDATORS = 10_240
N_VOTES = 16
BAD_VOTE = 9


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# -- fixtures ----------------------------------------------------------------


class FixedBase:
    """[k]B by a precomputed table of j * 16^w * B (64 windows of 16):
    64 point additions a scalar instead of double-and-add's ~380, so
    20,480 fixture scalar multiplications take seconds."""

    def __init__(self, pure):
        self.pure = pure
        self.rows = []
        step = pure.BASE
        for _ in range(64):
            row = [pure.IDENTITY]
            for _ in range(15):
                row.append(pure.point_add(row[-1], step))
            self.rows.append(row)
            step = pure.point_add(row[15], step)

    def mult(self, k: int):
        acc = self.pure.IDENTITY
        for w in range(64):
            nib = (k >> (4 * w)) & 15
            if nib:
                acc = self.pure.point_add(acc, self.rows[w][nib])
        return acc


def sign_known(pure, fb: FixedBase, seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """The RFC 8032 signature of msg under seed, whose key pub is known
    (the pure module's sign, with [r]B from the fixed-base table)."""
    a, prefix = pure.secret_expand(seed)
    r = pure.sha512_mod_l(prefix, msg)
    rs = pure.point_compress(fb.mult(r))
    k = pure.sha512_mod_l(rs, pub, msg)
    return rs + ((r + k * a) % pure.L).to_bytes(32, "little")


def sign_batch(pure, fb: FixedBase, seeds, msgs):
    """RFC 8032 keys and signatures ([a]B from the fixed-base table too)."""
    pubs = [pure.point_compress(fb.mult(pure.secret_expand(seed)[0])) for seed in seeds]
    return pubs, [sign_known(pure, fb, *job) for job in zip(seeds, pubs, msgs)]


def make_fixtures(pure, n_sigs: int, n_leaves: int):
    fb = FixedBase(pure)
    seeds = [hashlib.sha256(b"chip-smoke-key-%d-%d" % (SEED, i)).digest() for i in range(n_sigs)]
    msgs = [b"commit-vote-%d" % i for i in range(n_sigs)]
    pubs, sigs = sign_batch(pure, fb, seeds, msgs)
    leaves = [b"bench-tx-%08d" % i for i in range(n_leaves)]
    block = np.random.default_rng(SEED).bytes(N_PARTS * PART_BYTES)
    parts = [block[i * PART_BYTES : (i + 1) * PART_BYTES] for i in range(N_PARTS)]
    return fb, seeds, pubs, msgs, sigs, leaves, parts


def _enc_int(y: int, sign: int = 0) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def zip215_edge_batch(pure, pub, msg, good):
    """Non-canonical A/R, small order, s-range boundaries, malformed
    inputs and corruption in one mixed batch."""
    P, L = pure.P, pure.L
    small_order = (1).to_bytes(32, "little")
    return [
        (pub, msg, good),
        (pub, b"tampered", good),
        (pub, msg, good[:10] + bytes([good[10] ^ 1]) + good[11:]),
        (pub, msg, good[:32] + L.to_bytes(32, "little")),
        (pub, msg, b"\x11" * 32 + (L - 1).to_bytes(32, "little")),
        (small_order, msg, small_order + bytes(32)),
        (pub[:31], msg, good),
        (pub, msg, good[:63]),
        (_enc_int(P - 1), msg, good),
        (_enc_int(1 + P), msg, small_order + bytes(32)),
        (_enc_int((1 << 255) - 1), msg, good),
        (_enc_int(1, 1), msg, good),
    ]


# -- timing ------------------------------------------------------------------


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_queued(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls queued behind a sleep kernel, by CUDA
    events: the host enqueues every call while the device sleeps, so the
    kernels run back to back, without the gaps a host slower than them
    leaves (the device time of a short kernel that the profiler's trace
    does not hold whole)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound_ms(ops: float, nbytes: float, sms: int, clock_hz: float):
    t_ops = ops / (INT32_OPS_PER_SM_CLOCK * sms * clock_hz) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# SASS opcodes by the pipe that runs them, for the ladder's issue estimate
ALU_OPS = ("IADD3", "LOP3", "SHF", "LEA", "SEL", "ISETP", "MOV", "PRMT", "VIADD", "IMNMX",
           "VIMNMX", "IABS", "PLOP3", "P2R", "R2P", "FLO", "POPC")


def sass_mix(so) -> dict:
    """Static SASS instruction counts of the ladder kernel per group width
    (cuobjdump, where the toolkit has it; else empty), by class: the
    32x32->64 multiplies (IMAD.WIDE, .U32), other IMADs, shuffles, ALU
    operations and the rest (memory, branches; NOPs left out)."""
    from cometbft_tpu_torch.probe import issue_rates

    out = {}
    for g, c in sorted(issue_rates.sass_counts(so, r"ladder_verify_kernelILi(\d+)E").items()):
        c.pop("NOP", None)
        wide = {k: c[k] for k in ("IMAD.WIDE", "IMAD.WIDE.U32")}
        imad = sum(v for k, v in c.items() if k.startswith("IMAD") and k not in wide)
        shfl = sum(v for k, v in c.items() if k.startswith("SHFL"))
        alu = sum(v for k, v in c.items() if k.split(".")[0] in ALU_OPS)
        out[g] = {"instructions": sum(c.values()), **wide, "imad_other": imad, "shfl": shfl,
                  "alu": alu, "top": c.most_common(8)}
    return out


def ladder_issue_estimate(mix, rates, g, n, sms, clock_hz) -> dict:
    """Least time the ladder's instruction stream could issue in, if the
    loop runs the static mix: each lane issues the kernel's limb products
    (100 a multiply or squaring: g_sq is a g_mul) as IMAD.WIDE(.U32), and
    every other class in its static ratio to them; a warp's threads past
    its last whole group (G = 5: 2 of 32) issue too. Each class over its
    measured rate (thread-instructions a clock per SM); IMADs share one
    pipe; dispatch at 4 warps a clock per SM."""
    per_wide = n * (LADDER_FE_MULS + LADDER_FE_SQS) * FE_MUL_OPS * 32 / (32 // g * g) / (
        mix["IMAD.WIDE"] + mix["IMAD.WIDE.U32"])

    def ms(count, rate):
        return count * per_wide / (rate * sms * clock_hz) * 1e3

    t = {
        "imad_pipe": ms(mix["IMAD.WIDE"], rates["IMAD.WIDE"]["rate"])
        + ms(mix["IMAD.WIDE.U32"], rates["IMAD.WIDE.U32"]["rate"])
        + ms(mix["imad_other"], rates["IMAD"]["rate"]),
        "alu": ms(mix["alu"], rates["LOP3.LUT"]["rate"]),
        "shfl": ms(mix["shfl"], rates["SHFL.IDX"]["rate"]),
        "dispatch": ms(mix["instructions"], 128),
    }
    t["estimate"] = max(t.values())
    return t


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# -- phases ------------------------------------------------------------------


def digits_values(digits: torch.Tensor) -> list:
    """int32[64, N] signed radix-16 digits -> the N integers they encode."""
    d = digits.cpu().numpy().astype(object)
    return [sum(int(x) << (4 * i) for i, x in enumerate(d[:, lane])) for lane in range(d.shape[1])]


def words_of(values, nbytes: int) -> np.ndarray:
    """Integers -> int32[nbytes / 4, N] little-endian words (the operand layout)."""
    from cometbft_tpu_torch.ops import unpack

    return unpack.bytes_to_words(np.stack([np.frombuffer(v.to_bytes(nbytes, "little"), np.uint8)
                                           for v in values]))


def compare_kernels(fixtures, merkle_oracle, dev, sms, clock_hz, rates):
    """Phase 4: each kernel against its plain version at the main path's
    shapes; returns the per-kernel records (without launches)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import field25519 as fe
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import sha256_kernel as sha
    from cometbft_tpu_torch.ops import sha512_kernel as s5
    from cometbft_tpu_torch.ops import unpack

    L = ek.L

    _, _, pubs, msgs, sigs, leaves, parts = fixtures
    records = {}
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs)
    check(host_ok[: len(pubs)].all(), "fixture batch fails host checks")
    a_w, r_w, s_w, msg_w, msg_nb = ek.operands_to_device(operands, dev)
    n = a_w.shape[1]

    # sha512: the main path's challenge_digits, a ragged batch up to 32
    # blocks with a zero-block lane, scalar_digits on edge digests and s
    s_dig, k_dig = s5.challenge_digits(msg_w, msg_nb, s_w)
    err = max_abs_err(torch.stack([s_dig, k_dig]),
                      torch.stack(s5.challenge_digits_plain(msg_w, msg_nb, s_w)))
    rng = np.random.default_rng(SEED)
    lens = rng.integers(0, 32 * 128 - 17, 1024)
    lens[:4] = [111, 112, 0, 32 * 128 - 17]
    ragged = [rng.integers(0, 256, int(x), dtype=np.uint8).tobytes() for x in lens]
    buf, nb = s5.pack_buffer512(ragged)
    nb[5] = 0
    rw = torch.from_numpy(buf.view("<u4").view(np.int32)).to(dev)
    rnb = torch.from_numpy(nb).to(dev)
    rs = torch.from_numpy(words_of([int.from_bytes(rng.bytes(32), "little") % L for _ in ragged],
                                   32)).to(dev)
    got = torch.stack(s5.challenge_digits(rw, rnb, rs))
    err = max(err, max_abs_err(got, torch.stack(s5.challenge_digits_plain(rw, rnb, rs))))
    iv = b"".join(v.to_bytes(8, "big") for v in s5._IV)
    want_k = [int.from_bytes(iv if i == 5 else hashlib.sha512(m).digest(), "little") % L
              for i, m in enumerate(ragged)]
    check(digits_values(got[1]) == want_k, "sha512 kernel: k != hashlib digest mod L")
    k_words = s5.hash_blocks_plain(msg_w, msg_nb)
    edge_k = [2**512 - 1, 0, L - 1, L]
    k_words[:, : len(edge_k)] = torch.from_numpy(words_of(edge_k, 64)).to(dev)
    s_edge = s_w.clone()
    s_edge[:, :3] = torch.from_numpy(words_of([L - 1, 0, L - 1], 32)).to(dev)
    got = torch.stack(s5.scalar_digits(k_words, s_edge))
    err = max(err, max_abs_err(got, torch.stack(s5.scalar_digits_plain(k_words, s_edge))))
    check(digits_values(got[1][:, : len(edge_k)]) == [v % L for v in edge_k]
          and digits_values(got[0][:, :3]) == [L - 1, 0, L - 1],
          "sha512 scalar_digits: edge digests or scalars decoded wrong")
    check(err == 0, f"sha512 kernel != plain (max abs err {err})")
    blocks_hashed = int(msg_nb.sum().item())
    t_b = bound_ms(blocks_hashed * SHA512_BLOCK_OPS + n * SCALAR_LANE_OPS,
                   blocks_hashed * 128 + n * (4 + 32 + 2 * 64 * 4), sms, clock_hz)
    records["sha512"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: s5.challenge_digits(msg_w, msg_nb, s_w), 50),
        kernel_ms=kernel_ms(lambda: s5.challenge_digits(msg_w, msg_nb, s_w)),
        plain_ms=time_cuda(lambda: s5.challenge_digits_plain(msg_w, msg_nb, s_w), 2),
        bound_ms=t_b[0], bound_by=t_b[1],
        shape=f"{n} lanes x {msg_w.shape[1] // 32} blocks ({blocks_hashed} hashed)",
    )

    # decompress: the main path's A and R words with the ZIP-215 edge
    # encodings fed as raw words in the first lanes
    edge = [(1).to_bytes(32, "little"), _enc_int(1 + fe.P_INT), _enc_int(fe.P_INT - 1),
            _enc_int(fe.P_INT), _enc_int((1 << 255) - 1), _enc_int(1, 1), _enc_int(0, 1),
            b"\x11" * 32, bytes(32)]
    a_mix = a_w.clone()
    a_mix[:, : len(edge)] = torch.from_numpy(
        unpack.bytes_to_words(np.stack([np.frombuffer(e, np.uint8) for e in edge]))).to(dev)
    pt_k, ok_k = ed.decompress_words(a_mix, r_w)
    pt_p, ok_p = ed.decompress_words_plain(a_mix, r_w)
    err = max(max_abs_err(torch.stack(ed.point_freeze(pt_k)), torch.stack(ed.point_freeze(pt_p))),
              max_abs_err(ok_k, ok_p))
    check(err == 0, f"decompress kernel != plain (max abs err {err})")
    check(ok_k[: len(edge)].tolist() == [pure.point_decompress_zip215(e) is not None for e in edge],
          "decompress: an edge encoding decoded against ZIP-215")
    check(ok_k[len(edge):].all().item(), "a fixture encoding failed to decode")
    m = 2 * n
    products = m * (DECOMPRESS_FE_MULS * FE_MUL_OPS + DECOMPRESS_FE_SQS * FE_SQ_OPS)
    t_b = bound_ms(products, m * (32 + 273), sms, clock_hz)
    lpb = -(-m // sms)  # grid.cuh's balanced grid (one wave at this size)
    records["decompress"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: ed.decompress_words(a_w, r_w), 50),
        kernel_ms=kernel_ms(lambda: ed.decompress_words(a_w, r_w)),
        plain_ms=time_cuda(lambda: ed.decompress_words_plain(a_w, r_w), 2),
        bound_ms=t_b[0], bound_by=t_b[1],
        bound_ms_at_imad_wide_rate=products / (rates["IMAD.WIDE"]["rate"] * sms * clock_hz) * 1e3,
        shape=f"{m} lanes, {-(-m // lpb)} blocks of {lpb} lanes x {DECOMPRESS_GROUP} threads",
    )

    # ladder (fused with the epilogue): the main path's digits and decoded
    # A, R, at every group width; widths timed in turns
    pt, ok = ed.decompress_words(a_w, r_w)
    want, acc_p = ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)
    acc_p = torch.stack(ed.point_freeze(acc_p))
    check(bool(want.all()), "plain ladder rejects a fixture signature")
    err = 0
    for g in ladder.GROUPS:
        got, acc = ladder.verify_lanes(s_dig, k_dig, pt, ok, group=g, with_acc=True)
        err = max(err, max_abs_err(got, want),
                  max_abs_err(torch.stack(ed.point_freeze(acc)), acc_p))
    check(err == 0, f"ladder kernel != plain (max abs err {err})")
    runs = {g: [] for g in ladder.GROUPS}
    for rep in range(3):
        for g in ladder.GROUPS[:: 1 if rep % 2 == 0 else -1]:
            runs[g].append(time_cuda(lambda: ladder.verify_lanes(s_dig, k_dig, pt, ok, group=g), 20))
    ms_by_group = {g: statistics.median(v) for g, v in runs.items()}
    configs = {g: ladder.launch_config(n, g) for g in ladder.GROUPS}
    print(f"ladder ms by threads a lane (median of 3 turns of 20 launches): {ms_by_group}; "
          f"runs {runs}", flush=True)
    for g, cfg in configs.items():
        print(f"ladder launch at {g} threads a lane: {cfg}", flush=True)
    t_b = bound_ms(n * (LADDER_FE_MULS * FE_MUL_OPS + LADDER_FE_SQS * FE_SQ_OPS),
                   n * (2 * 64 * 4 + 2 * 4 * 17 * 4 + 2 + 1), sms, clock_hz)
    records["ladder"] = dict(
        max_abs_err=err, ms=ms_by_group[ladder.GROUP], ms_by_group=ms_by_group,
        kernel_ms=kernel_ms(lambda: ladder.verify_lanes(s_dig, k_dig, pt, ok)),
        threads_per_lane=ladder.GROUP,
        plain_ms=time_cuda(lambda: ladder.verify_lanes_plain(s_dig, k_dig, pt, ok), 1, warmup=0),
        bound_ms=t_b[0], bound_by=t_b[1], shape=f"{n} lanes x 64 windows + epilogue",
    )

    # sha256: the 65,536-leaf block, leaf pass and every inner level
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in leaves])
    blk = torch.from_numpy(blocks.view(np.int32)).to(dev)
    nbk = torch.from_numpy(nblocks).to(dev)
    cur_k, cur_p = mk.leaf_core(blk, nbk), mk.leaf_core_plain(blk, nbk)
    err = max_abs_err(cur_k, cur_p)
    while cur_k.shape[1] > 1:
        cur_k = mk.inner_core(cur_k[:, 0::2], cur_k[:, 1::2])
        cur_p = mk.inner_core_plain(cur_p[:, 0::2], cur_p[:, 1::2])
        err = max(err, max_abs_err(cur_k, cur_p))
    check(err == 0, f"sha256 kernel != plain (max abs err {err})")

    # the tree entry (what the root path runs): two launches a root
    for part in (leaves, leaves[:N_RAGGED_LEAVES]):
        flat, offsets = mk.pack_leaves(part, dev)
        got = mk.tree_root(flat, offsets)
        err = max(err, max_abs_err(got, mk.tree_root_plain(flat, offsets)))
        check(sha.digest_words_to_bytes(got.cpu().numpy())[0] == merkle_oracle(part),
              f"sha256 tree entry: {len(part)}-leaf root != hash_from_byte_slices")
    check(err == 0, f"sha256 kernel != plain (max abs err {err})")
    flat, offsets = mk.pack_leaves(leaves, dev)
    nl = len(leaves)
    lens = np.diff(offsets.cpu().numpy())
    compressions = int(((lens + 1 + 8) // 64 + 1).sum()) + 2 * (nl - 1)
    t_b = bound_ms(compressions * SHA256_BLOCK_OPS, flat.numel() + 8 * (nl + 1) + 32,
                   sms, clock_hz)
    records["sha256"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: mk.tree_root(flat, offsets), 50),
        kernel_ms=kernel_ms(lambda: mk.tree_root(flat, offsets), launches=2),
        queued_ms=time_queued(lambda: mk.tree_root(flat, offsets), 50),
        plain_ms=time_cuda(lambda: mk.tree_root_plain(flat, offsets), 1, warmup=0),
        bound_ms=t_b[0], bound_by=t_b[1],
        chain_floor_ms=chain_floor_ms(longest_leaf_blocks(offsets), nl, clock_hz),
        shape=f"{nl} leaves, 2 launches ({-(-nl // mk.CHUNK)} chunks of {mk.CHUNK})",
    )
    rec = records["sha256"]
    rec.update(compare_levels(leaves, parts, dev, sms, clock_hz))
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["levels_max_abs_err"])
    print(f"sha256 root path (tree entry, 65,536 leaves): {rec['kernel_ms']} ms CUPTI, "
          f"{rec['queued_ms']} queued, {rec['ms']} by events (before: 0.0747-0.0753 CUPTI, 0.0780 "
          f"events); levels entry at 65,536 leaves: {rec['levels_kernel_ms']} CUPTI, "
          f"{rec['levels_queued_ms']} queued, {rec['levels_ms']} by events (before: 0.0755 CUPTI, "
          f"0.0782-0.0783 events); bound {rec['bound_ms']}, chain floor {rec['chain_floor_ms']} "
          f"(levels {rec['levels_chain_floor_ms']}); at the part set: {rec['levels_partset_kernel_ms']} CUPTI, "
          f"{rec['levels_partset_queued_ms']} queued, {rec['levels_partset_ms']} by events (before: "
          f"9.001-9.055 events), bound {rec['levels_partset_bound_ms']}, chain floor "
          f"{rec['levels_partset_chain_floor_ms']}", flush=True)
    return records


def levels_bound(mk, flat, offsets, sms, clock_hz):
    """The levels entry's bound: every compression (each leaf's blocks of
    0x00 || leaf, two an inner node) at SHA256_BLOCK_OPS; the leaves and
    offsets read once, every level's 32-byte nodes written once."""
    n = offsets.shape[0] - 1
    lens = np.diff(offsets.cpu().numpy())
    compressions = int(((lens + 1 + 8) // 64 + 1).sum()) + 2 * (n - 1)
    total = mk.level_rows(n)[-1][0] + 1
    return bound_ms(compressions * SHA256_BLOCK_OPS, flat.numel() + 8 * (n + 1) + 32 * total,
                    sms, clock_hz)


def long_leaf_sets(leaves, parts) -> dict:
    """The part set, its ragged form (the last part RAGGED_LAST_PART bytes)
    and N_MIX leaves, every 5th a long one (MIX_LONG bytes of the block in
    turn) and the others short, so the long ones start at unaligned offsets
    of the joined leaves."""
    block = b"".join(parts)
    mix = [block[i * 4099 : i * 4099 + MIX_LONG[i // 5 % len(MIX_LONG)]] if i % 5 == 2
           else leaves[i % len(leaves)] for i in range(N_MIX)]
    return {"partset": parts, "partset_ragged": parts[:-1] + [parts[-1][:RAGGED_LAST_PART]],
            "mix": mix}


def levels_launch(mk, flat, offsets, chunk: int, words: bool) -> torch.Tensor:
    """The levels entry's two launches at the given chunk and leaf loads."""
    n = offsets.shape[0] - 1
    levels = torch.empty((mk.level_rows(n)[-1][0] + 1, 8), dtype=torch.int32, device=flat.device)
    mk._launch_tree(flat, offsets, n, chunk, levels, words)
    return levels


def levels_by_leaf_bytes(mk, parts, dev) -> dict:
    """{leaf bytes: {variant: [ms, ms]}}: each SWEEP_LEAF_BYTES cut of the
    part set's block under each variant, queued, in two passes in opposite
    orders; the three variants' levels must agree word for word."""
    block = b"".join(parts)
    variants = {"bytes_chunk_%d" % mk.CHUNK: (mk.CHUNK, False),
                "bytes_chunk_%d" % mk.LONG_LEAF_CHUNK: (mk.LONG_LEAF_CHUNK, False),
                "words_chunk_%d" % mk.LONG_LEAF_CHUNK: (mk.LONG_LEAF_CHUNK, True)}
    out = {}
    for nbytes in SWEEP_LEAF_BYTES:
        flat, offsets = mk.pack_leaves([block[i : i + nbytes]
                                        for i in range(0, len(block), nbytes)], dev)
        got = [levels_launch(mk, flat, offsets, *v) for v in variants.values()]
        check(all(torch.equal(got[0], g) for g in got[1:]),
              f"sha256 levels entry: the loads or chunks disagree at {nbytes}-byte leaves")
        times = {k: [] for k in variants}
        for order in (list(variants), list(variants)[::-1]):
            for k in order:
                times[k].append(time_queued(lambda: levels_launch(mk, flat, offsets, *variants[k]), 5))
        out[nbytes] = times
        print(f"sha256 levels entry, {offsets.shape[0] - 1} leaves of {nbytes} bytes (ms queued, "
              f"two passes): {times}", flush=True)
    return out


def longest_leaf_blocks(offsets) -> int:
    """SHA-256 blocks of the longest leaf's 0x00 || leaf."""
    lens = np.diff(offsets.cpu().numpy())
    return int(((lens + 1 + 8) // 64 + 1).max())


def chain_floor_ms(leaf_blocks: int, n: int, clock_hz) -> float:
    """The compressions a root of n leaves waits on one after another, on
    one warp, which issues at most one instruction a clock
    (SHA256_BLOCK_OPS each): the longest leaf's blocks, then 2 for each of
    the ceil(log2 n) levels above the leaves."""
    return (leaf_blocks + 2 * (n - 1).bit_length()) * SHA256_BLOCK_OPS / clock_hz * 1e3


def compare_levels(leaves, parts, dev, sms, clock_hz) -> dict:
    """The sha256 kernel's levels entry (the counterpart of
    merkle_kernel._leaves_to_levels_core) against tree_levels_raw_plain,
    every word, at the 65,536-leaf block, the 10,000-leaf ragged count, the
    part set, the ragged part set and the short/long mix, each at the chunk
    the wrapper picks; times at 65,536 leaves and at the part set, with the
    part set's chain floor. The plain version runs on the card, but for the
    long leaves on the CPU, on copies of the same inputs: its 1,025
    compressions a part run one after another, each ~2,600 tiny tensor
    operations, which cost ~66 ms a compression on the card (launch-bound;
    68 s for the part set) against a few ms on the CPU."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    out, err = {}, 0
    sets = {"64k": leaves, "10k": leaves[:N_RAGGED_LEAVES], **long_leaf_sets(leaves, parts)}
    for name, items in sets.items():
        flat, offsets = mk.pack_leaves(items, dev)
        long = mk.long_leaves(len(items), flat.numel())
        chunk = mk.LONG_LEAF_CHUNK if long else mk.CHUNK
        got = mk.tree_levels_raw(flat, offsets)
        plain_dev = dev if name in ("64k", "10k") else "cpu"
        t0 = time.perf_counter()
        want = mk.tree_levels_raw_plain(flat.to(plain_dev), offsets.to(plain_dev))
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(got.cpu(), want.cpu()))
        check(got.shape == want.shape == (mk.level_rows(len(items))[-1][0] + 1, 8),
              f"sha256 levels entry: {name} levels have shape {tuple(got.shape)}")
        print(f"sha256 levels entry, {name}: {len(items)} leaves, chunk {chunk}, word loads {long}, "
              f"equal to the plain version: {err == 0}", flush=True)
        if name not in ("64k", "partset"):
            continue
        t_b = levels_bound(mk, flat, offsets, sms, clock_hz)
        key = "levels" if name == "64k" else "levels_partset"
        out.update({
            f"{key}_ms": time_cuda(lambda: mk.tree_levels_raw(flat, offsets), 50 if name == "64k" else 5),
            f"{key}_queued_ms": time_queued(lambda: mk.tree_levels_raw(flat, offsets),
                                            50 if name == "64k" else 5),
            f"{key}_kernel_ms": kernel_ms(lambda: mk.tree_levels_raw(flat, offsets),
                                          20 if name == "64k" else 5, launches=2),
            f"{key}_plain_ms": plain, f"{key}_plain_device": str(plain_dev),
            f"{key}_bound_ms": t_b[0], f"{key}_bound_by": t_b[1],
            f"{key}_chain_floor_ms": chain_floor_ms(longest_leaf_blocks(offsets), len(items), clock_hz),
            f"{key}_shape": f"{len(items)} leaves of {len(items[0])} bytes, 2 launches (chunks of "
                            f"{chunk}), {got.shape[0]} nodes out",
        })
    check(err == 0, f"sha256 levels entry != plain (max abs err {err})")
    out["levels_max_abs_err"] = err
    out["levels_by_leaf_bytes"] = levels_by_leaf_bytes(mk, parts, dev)
    return out


def corrupted_commit(pure, msgs, sigs):
    """The commit with 5 localized corruptions: three signatures with a bit
    flipped, one s >= L, one tampered message. Returns (msgs, sigs, the
    sorted bad indices)."""
    n = len(sigs)
    bad_sigs, bad_msgs = list(sigs), list(msgs)
    flipped = [17, n // 2 + 3, n - 1]
    for i in flipped:
        s = bytearray(bad_sigs[i])
        s[40] ^= 0x08
        bad_sigs[i] = bytes(s)
    s_ge_l, wrong_msg = n // 5, n * 7 // 8
    bad_sigs[s_ge_l] = bad_sigs[s_ge_l][:32] + (pure.L + 3).to_bytes(32, "little")
    bad_msgs[wrong_msg] = b"commit-vote-tampered"
    return bad_msgs, bad_sigs, sorted(flipped + [s_ge_l, wrong_msg])


def drive_main_path(fixtures, pure, merkle_oracle, backend):
    """Phase 5: the requests a user sends, each held to its expected answer."""
    fb, seeds, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)

    ok, bits = backend.batch_verify(pubs, msgs, sigs)
    check(ok and len(bits) == n and all(bits), "valid commit did not verify")

    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    ok, bits = backend.batch_verify(pubs, bad_msgs, bad_sigs)
    check(not ok and [i for i, b in enumerate(bits) if not b] == want_bad,
          "corrupted commit: bitmap does not localize exactly the bad signatures")

    edge = zip215_edge_batch(pure, pubs[0], msgs[0], sigs[0])
    _, bits = backend.batch_verify(*(list(c) for c in zip(*edge)))
    want = [len(p) == 32 and len(s) == 64 and pure.verify_zip215(p, m, s) for p, m, s in edge]
    check(bits == want, f"ZIP-215 edge batch: {bits} != pure {want}")

    big = b"oversized-app-message:" + bytes(range(256)) * 20
    o_pubs, o_sigs = sign_batch(pure, fb, seeds[:2], [big, msgs[1]])
    o_sigs[1] = o_sigs[1][:5] + bytes([o_sigs[1][5] ^ 1]) + o_sigs[1][6:]
    _, bits = backend.batch_verify(o_pubs + pubs[2:8], [big, msgs[1]] + msgs[2:8], o_sigs + sigs[2:8])
    check(bits == [True, False] + [True] * 6, f"oversized (host-hash) batch: {bits}")

    check(backend.merkle_root(leaves) == merkle_oracle(leaves), "65,536-leaf root mismatch")
    ragged = leaves[:N_RAGGED_LEAVES]
    check(backend.merkle_root(ragged) == merkle_oracle(ragged), "10,000-leaf root mismatch")


def trace_call(fn) -> dict:
    """One call of fn under torch.profiler: its wall ms (traced, so slower
    than untraced), the device time of each kernel and copy by name, and
    their sum (one stream, so the sum is the device's busy time). Empty
    device times mean the profiler saw no kernel: nothing is claimed then."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = time_host(fn)
    device, counts = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type.name == "CUDA":
            device[e.key] += t / 1e3
            counts[e.key] += e.count
    return {"wall_ms": wall, "device_ms": sum(device.values()),
            "kernels_ms": dict(device.most_common()), "counts": dict(counts)}


def kernel_ms(fn, reps: int = 20, launches: int = 1):
    """Mean device time of fn's kernels a call (torch.profiler, CUPTI): the
    kernels' own time, without the gaps that the host's enqueue leaves
    between launches and that CUDA events around back-to-back launches
    count. None when the trace does not hold every launch (reps x
    launches kernel records): the profiler has been seen to drop some."""
    fn()
    tr = trace_call(lambda: [fn() for _ in range(reps)])
    kernels = [k for k in tr["kernels_ms"] if not k.startswith(("Memcpy", "Memset"))]
    seen = sum(tr["counts"][k] for k in kernels)
    if seen != reps * launches:
        print(f"kernel_ms: the trace holds {seen} of {reps * launches} launches: not measured",
              flush=True)
        return None
    return sum(tr["kernels_ms"][k] for k in kernels) / reps


def stage_split(fixtures, dev):
    """One verify + root, stage by stage, each ended by a synchronize."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import sha512_kernel as s5

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    st, box = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[name] = fn()
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3

    run("pack", lambda: ek.operands_to_device(ek.pack_batch(pubs, msgs, sigs)[0], dev))
    a_w, r_w, s_w, msg_w, msg_nb = box["pack"]
    run("sha512", lambda: s5.challenge_digits(msg_w, msg_nb, s_w))
    s_dig, k_dig = box["sha512"]
    run("decompress", lambda: ed.decompress_words(a_w, r_w))
    pt, ok = box["decompress"]
    run("ladder_epilogue", lambda: ladder.verify_lanes(s_dig, k_dig, pt, ok).cpu())
    run("merkle_pack", lambda: mk.pack_leaves(leaves, dev))
    run("merkle_tree", lambda: mk.tree_root(*box["merkle_pack"]).cpu())
    check(bool(box["ladder_epilogue"].all()), "stage-split verify failed")
    return st


# -- the proofs path -----------------------------------------------------------


def proof_sets(fixtures) -> dict:
    _, _, _, _, _, leaves, parts = fixtures
    return {"64k": leaves, "10k": leaves[:N_RAGGED_LEAVES], "partset": parts}


def drive_proofs(fixtures, host) -> None:
    """The proofs path: proofs_from_byte_slices_device (on the card by
    default) at the three sizes, each root and every proof's total, index,
    leaf hash and aunts equal to the host's proofs_from_byte_slices_pure; every
    97th proof and the last verify against the root; two sha256 launches a
    proof set."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    for name, items in proof_sets(fixtures).items():
        before = _build.LAUNCHES["sha256"]
        root, proofs = mk.proofs_from_byte_slices_device(items)
        check(_build.LAUNCHES["sha256"] - before == 2, f"{name} proofs: not two sha256 launches")
        root_h, proofs_h = host.proofs_from_byte_slices_pure(items)
        check(root == root_h and len(proofs) == len(proofs_h) == len(items),
              f"{name} proofs: root or count differs from the host's")
        for i, (pd, ph) in enumerate(zip(proofs, proofs_h)):
            if (pd.total, pd.index, pd.leaf_hash, pd.aunts) != (ph.total, ph.index, ph.leaf_hash,
                                                                ph.aunts):
                fail(f"{name} proofs: proof {i} differs from the host's")
        for i in list(range(0, len(items), 97)) + [len(items) - 1]:
            proofs[i].verify(root, items[i])


def proofs_stage_split(leaves, dev) -> dict:
    """One 65,536-leaf proof set, stage by stage (each ended by a
    synchronize): pack, the two launches, the levels' device-to-host copy,
    the aunt gather, DeviceProofs."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    st, box = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[name] = fn()
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return box[name]

    flat, offsets = run("pack", lambda: mk.pack_leaves(leaves, dev))
    levels = run("levels_launches", lambda: mk.tree_levels_raw(flat, offsets))
    digests = run("levels_d2h", lambda: mk.levels_to_digests(levels))
    split = mk.split_levels(digests, len(leaves))
    aunts, counts = run("aunt_gather", lambda: mk.gather_aunts(split))
    run("device_proofs", lambda: mk.DeviceProofs(bytes(split[-1][0]), split[0], aunts, counts))
    return st


def proofs_metrics(fixtures, host, dev) -> dict:
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    leaves = fixtures[5]
    runs = [time_host(lambda: mk.proofs_from_byte_slices_device(leaves)) for _ in range(5)]
    oracle = [time_host(lambda: host.proofs_from_byte_slices_pure(leaves)) for _ in range(3)]
    splits = [proofs_stage_split(leaves, dev) for _ in range(3)]
    return {
        "metric": "proofs_64k_ms", "value": statistics.median(runs), "runs_ms": runs,
        "stages_ms": {k: statistics.median(sp[k] for sp in splits) for k in splits[0]},
        "host_oracle_ms": statistics.median(oracle), "host_oracle_runs_ms": oracle,
        "parts": {"count": N_PARTS, "bytes": PART_BYTES},
    }


# -- the sidecar path ----------------------------------------------------------


def drive_sidecar(fixtures, pure, merkle_oracle) -> dict:
    """The port's entry point: SidecarServer in this process on
    127.0.0.1:0, serving TorchBackend() on the card, warmed; the port's
    GrpcBackend drives every request of drive_main_path through the socket
    (the commit streamed in chunks), then the commit unary. Three launches a
    verify dispatch and two a root; then the headline through the socket."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.backend import TorchBackend
    from cometbft_tpu_torch.sidecar.service import GrpcBackend, SidecarServer

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    t0 = time.perf_counter()
    server = SidecarServer("127.0.0.1:0", backend=TorchBackend())
    server.warmup()
    warm_s = time.perf_counter() - t0
    server.start()
    client = GrpcBackend(server.bound_addr, timeout_s=600)
    try:
        _build.reset_launches()
        d0 = server.scheduler_counters()["dispatches"]
        drive_main_path(fixtures, pure, merkle_oracle, client)
        os.environ["CMTPU_SIDECAR_CHUNK"] = str(N_SIGS)
        try:
            ok, bits = client.batch_verify(pubs, msgs, sigs)
        finally:
            del os.environ["CMTPU_SIDECAR_CHUNK"]
        check(ok and all(bits) and len(bits) == N_SIGS, "sidecar: the unary commit did not verify")
        launches = dict(_build.LAUNCHES)
        dispatches = server.scheduler_counters()["dispatches"] - d0
        c = client.counters()
        check(c["streamed_calls"] >= 2 and c["unary_calls"] >= 3,
              f"sidecar: expected streamed and unary verifies, client counters {c}")
        check(launches == {"ladder": dispatches, "decompress": dispatches, "sha512": dispatches,
                           "sha256": 4, "bn254": 0},
              f"sidecar: expected three launches a verify dispatch ({dispatches}) and two a "
              f"root (2 roots): {launches}")
        totals = [time_host(lambda: (client.batch_verify(pubs, msgs, sigs),
                                     client.merkle_root(leaves))) for _ in range(5)]
        counters = server.scheduler_counters()
    finally:
        client.close()
        server.shutdown()
    ours = [t for t in threading.enumerate()
            if t.name in ("verify-engine", "sidecar-reader") or "process_request" in t.name]
    for t in ours:
        t.join(timeout=30)
    left = [t.name for t in ours if t.is_alive()]
    check(not left, f"sidecar: threads left after shutdown: {left}")
    return {"launches": launches, "dispatches": dispatches, "warmup_s": warm_s, "totals": totals,
            "client": c, "scheduler": counters}


# -- the BN254 path ------------------------------------------------------------


def bn254_lanes(bn, n: int):
    """n Miller lanes: the padding lane (G1, G2), coordinates 0, 1 and P - 1
    and off-curve field elements first (the formulas are polynomials, so
    kernel and plain version must agree on them too), then multiples of a
    seeded (P, Q) by repeated addition."""
    p_ = bn.P
    rng = np.random.default_rng(SEED)

    def fe():
        return int.from_bytes(rng.bytes(32), "little") % p_

    lanes = [(bn.G1, bn.G2), ((0, 0), ((0, 0), (0, 0))), ((1, 1), ((1, 1), (1, 1))),
             ((p_ - 1, p_ - 1), ((p_ - 1, p_ - 1), (p_ - 1, p_ - 1))),
             ((0, 1), ((p_ - 1, 0), (1, p_ - 1))),
             ((fe(), fe()), ((fe(), fe()), (fe(), fe()))), ((fe(), fe()), bn.G2)]
    pt = bn._g1_mul(SEED, bn.G1)
    q = bn._g2_mul(SEED + 1, bn.G2)
    while len(lanes) < n:
        lanes.append((pt, q))
        pt, q = bn._g1_add(pt, bn.G1), bn._g2_add(q, bn.G2)
    return lanes[:n]


def bn254_fixtures(bn):
    """The 10,240-validator aggregate commit: sk_i = s0 + i, so pk_i is one
    G1 addition from pk_(i-1), and the aggregate is one G2 multiply by the
    sum of the sk_i; every validator signs one shared message (the cut:
    distinct sign bytes would cost the host 10,240 hash-to-G2 runs); the
    poisoned aggregate leaves one signer's share out. Then 16 distinct
    signed votes, vote BAD_VOTE signed over another message."""
    s0 = int.from_bytes(hashlib.sha256(b"chip-smoke-bn254-%d" % SEED).digest(), "big") % (bn.R // 2)
    pk, pubs = bn._g1_mul(s0, bn.G1), []
    for _ in range(N_VALIDATORS):
        pubs.append(bn.g1_compress(pk))
        pk = bn._g1_add(pk, bn.G1)
    msg = b"chip-smoke-commit-%d" % SEED
    hm = bn._hash_to_g2_cached(msg)
    total = sum(s0 + i for i in range(N_VALIDATORS)) % bn.R
    left_out = N_VALIDATORS // 3
    v_sks = [s0 + 2 * N_VALIDATORS + i for i in range(N_VOTES)]
    v_msgs = [b"chip-smoke-vote-%d" % i for i in range(N_VOTES)]
    v_sigs = [bn.sign(sk, m) for sk, m in zip(v_sks, v_msgs)]
    v_sigs[BAD_VOTE] = bn.sign(v_sks[BAD_VOTE], b"chip-smoke-vote-other")
    return {
        "pubs": pubs, "msgs": [msg] * N_VALIDATORS,
        "agg": bn.g2_compress(bn._g2_mul(total, hm)),
        "poisoned": bn.g2_compress(bn._g2_mul((total - (s0 + left_out)) % bn.R, hm)),
        "votes": ([bn.public_key(sk) for sk in v_sks], v_msgs, v_sigs),
    }


def compare_bn254(bn, dev, sms, clock_hz, rates):
    """Phase 4 for bn254: the kernel against its plain version at each of
    BN254_LANE_COUNTS (the aggregate's 8,192-lane chunk, the 4,096-lane
    bucket of its second, the 32-lane vote batch), edge lanes first, every
    lane equal mod P; each count timed by events and held under the
    one-thread-a-lane kernel's time; the launch's registers, local bytes
    (which must be 0) and team shape printed, and the schedule's Fp
    multiplies a lane beside the bound's. Returns its record, at 8,192
    lanes (MAX_LANES)."""
    from cometbft_tpu_torch.ops import bn254_kernel as bk
    from cometbft_tpu_torch.ops import bn254_schedule as bs

    lanes = bn254_lanes(bn, max(BN254_LANE_COUNTS))
    rec = {"max_abs_err": 0, "ms_by_lanes": {}, "plain_ms_by_lanes": {}, "bound_ms_by_lanes": {},
           "fp_muls_a_lane": {"bound": BN254_FP_MULS, "schedule": bs.lane_muls()}}
    print(f"bn254 Fp multiplies a lane: {rec['fp_muls_a_lane']}", flush=True)
    for n in BN254_LANE_COUNTS:
        ops = bk.operands_to_device(bk._pack(lanes[:n], n), dev)
        got = bk.miller_values(*ops)
        want = bk.miller_values_plain(*ops)
        torch.cuda.synchronize()
        check(bool(((got >= 0) & (got < 2**21) & (got == got.floor())).all()),
              f"bn254 kernel at {n} lanes: output limbs are not canonical 21-bit limbs")
        k, p = bk.limbs_to_ints(got.cpu().numpy()), bk.limbs_to_ints(want.cpu().numpy())
        err = max(abs(int(a) - int(b)) for a, b in zip(k.ravel(), p.ravel()))
        check(err == 0, f"bn254 kernel != plain mod P at {n} lanes on "
                        f"{int((k != p).any(axis=(1, 2)).sum())} lanes")
        cfg = bk.launch_config(n)
        check(cfg["local_bytes"] == 0, f"bn254 kernel spills: {cfg}")
        ms = time_cuda(lambda: bk.miller_values(*ops), 5)
        print(f"bn254 at {n} lanes: {ms:.4f} ms by events (one thread a lane: "
              f"{ONE_THREAD_BN254_MS[n]}); launch {cfg}", flush=True)
        check(ms < ONE_THREAD_BN254_MS[n], f"bn254 at {n} lanes: {ms:.3f} ms, not faster than one "
                                           f"thread a lane's {ONE_THREAD_BN254_MS[n]} ms")
        products = n * BN254_FP_MULS * BN254_FP_MUL_OPS
        t_b = bound_ms(products, n * BN254_LANE_BYTES, sms, clock_hz)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["ms_by_lanes"][n] = ms
        rec["plain_ms_by_lanes"][n] = time_cuda(lambda: bk.miller_values_plain(*ops), 1, warmup=0)
        rec["bound_ms_by_lanes"][n] = t_b[0]
        if n == bk.MAX_LANES:
            rec.update(
                ms=ms, kernel_ms=kernel_ms(lambda: bk.miller_values(*ops), reps=5),
                plain_ms=rec["plain_ms_by_lanes"][n], bound_ms=t_b[0], bound_by=t_b[1],
                bound_ms_at_imad_wide_rate=products / (rates["IMAD.WIDE"]["rate"] * sms * clock_hz) * 1e3,
                shape=f"{n} lanes x 102 steps, {cfg['team']} threads a lane ({cfg['blocks']} blocks of "
                      f"{cfg['lanes_per_block']} lanes in {cfg['threads']} threads; {cfg['registers']} "
                      f"registers, {cfg['local_bytes']} local bytes a thread; {cfg['shared_bytes']} "
                      f"shared bytes a block, {cfg['slots']} slots a lane)",
            )
    return rec


def drive_bn254_path(fix, backend) -> dict:
    """Phase 6: the aggregate accepts, the poisoned aggregate rejects, two
    bn254 launches each; the vote batch's bitmap is exact, one launch."""
    from cometbft_tpu_torch.ops import _build

    times = {}

    def run(name, fn, launches):
        before = _build.LAUNCHES["bn254"]
        t0 = time.perf_counter()
        out = fn()
        times[name] = (time.perf_counter() - t0) * 1e3
        got = _build.LAUNCHES["bn254"] - before
        check(got == launches, f"{name}: {got} bn254 launches, expected {launches}")
        return out

    ok = run("aggregate_accept", lambda: backend.aggregate_verify(fix["pubs"], fix["msgs"], fix["agg"]), 2)
    check(ok is True, "the 10,240-validator aggregate did not verify")
    ok = run("aggregate_poisoned",
             lambda: backend.aggregate_verify(fix["pubs"], fix["msgs"], fix["poisoned"]), 2)
    check(ok is False, "the aggregate with one share left out verified")
    ok, bits = run("batch_16_votes", lambda: backend.batch_verify(*fix["votes"]), 1)
    want = [i != BAD_VOTE for i in range(N_VOTES)]
    check(not ok and bits == want, f"16-vote batch bitmap {bits} != {want}")
    return times


def bn254_stage_split(fix, bn, dev) -> dict:
    """One 10,240-validator aggregate check, stage by stage (each ended by
    a synchronize); the hash cache is emptied first, so the one shared
    message is hashed once."""
    from cometbft_tpu_torch.ops import bn254_kernel as bk

    st, box = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[name] = fn()
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return box[name]

    bn._HM_CACHE.clear()
    s, pks = run("parse_decompress", lambda: (bn.g2_unmarshal(fix["agg"]),
                                              [bn.g1_decompress(pk) for pk in fix["pubs"]]))
    hms = run("hash", lambda: [bn._hash_to_g2_cached(m) for m in fix["msgs"]])
    pairs = [((pk[0], (bn.P - pk[1]) % bn.P), hm) for pk, hm in zip(pks, hms)] + [(bn.G1, s)]
    chunks = [pairs[i: i + bk.MAX_LANES] for i in range(0, len(pairs), bk.MAX_LANES)]
    ops = run("pack", lambda: [bk.operands_to_device(bk._pack(c, bk.bucket_for(len(c))), dev)
                               for c in chunks])
    outs = run("kernel", lambda: [bk.miller_values(*o) for o in ops])
    vals = run("unpack", lambda: [v for c, o in zip(chunks, outs)
                                  for v in bk.unpack_values(o.cpu().numpy()[: len(c)])])
    f = run("f12_product", lambda: bk.f12_product(vals))
    ok = run("final_exponentiation", lambda: bn.final_exponentiation_fast(f) == bn.F12_ONE)
    check(ok, "stage-split aggregate did not verify")
    return st


# -- the mesh path -------------------------------------------------------------

# Virtual shards of the one card the mesh phase runs on: NCCL puts no two
# ranks on one card, so the split is held on repeats of one device.
# The hybrid phase: the device share forced at the split (it puts 2 of the
# corrupted commit's 5 bad indices on the device side, 3 on the host's), the
# run of planned calls the rate model learns from, and the two commit sizes
# the device's affine cost (a fixed ms plus a slope a signature) is fitted
# through for the rate seeds.
HYBRID_SPLIT = 4096
HYBRID_CALLS = 8
HYBRID_FIT_SIGS = (1024, N_SIGS)
# Batches under the commit that the planner prices too: one signature (a
# vote, a light-client header), a commit of a typical validator set, and a
# large one.
HYBRID_SMALL_SIGS = (1, 150, 1024)


def drive_hybrid_path(fixtures, pure, torch_backend):
    """The hybrid phase's checks (launches counted by the caller):
    ``_routed_call`` at shares 0, HYBRID_SPLIT and the whole commit, on the
    valid and the corrupted commit, each bitmap equal to TorchBackend's;
    ``verify_and_root`` equal to TorchBackend's bitmap and root; then
    HYBRID_CALLS planned calls; launch counts zeroed after TorchBackend's
    answers and checked: three launches a call with a device share, none
    else. Returns (the backend, the root, the plan record, the launches)."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.backend import HybridBackend
    from cometbft_tpu_torch.sidecar.service import DEFAULT_BUCKETS

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    check(min(want_bad) < HYBRID_SPLIT <= max(want_bad),
          f"the split {HYBRID_SPLIT} leaves the bad indices {want_bad} on one side")
    commits = {"valid": (msgs, sigs), "corrupted": (bad_msgs, bad_sigs)}
    want = {k: torch_backend.batch_verify(pubs, m, s) for k, (m, s) in commits.items()}
    check(want["corrupted"] == (False, [i not in want_bad for i in range(n)]),
          "TorchBackend's corrupted-commit bitmap is not the expected one")
    want_root = torch_backend.merkle_root(leaves)
    hybrid = HybridBackend()
    # As the sidecar serving it does: the native build (the hybrid routes to
    # the card alone until it is done) and the card's walls at its buckets.
    hybrid.warmup(DEFAULT_BUCKETS)
    _build.reset_launches()
    launched = 0
    for share in (0, HYBRID_SPLIT, n):
        for name, (m, s) in commits.items():
            got, _ = hybrid._routed_call(pubs, m, s, share)
            check(got == want[name], f"hybrid at share {share}, {name} commit: bitmap != TorchBackend's")
            launched += share > 0
    got, root = hybrid.verify_and_root(pubs, msgs, sigs, leaves)
    launched += hybrid.last_share > 0
    roots = hybrid.last_root == "card"
    check(got == want["valid"] and root == want_root,
          "hybrid verify_and_root: bitmap or root != TorchBackend's")
    check(hybrid.last_root == "card", f"the warmed hybrid put the {len(leaves)}-leaf root on the "
                                      f"{hybrid.last_root}, not the card")
    shares = []
    for _ in range(HYBRID_CALLS):
        check(hybrid.batch_verify(pubs, msgs, sigs) == want["valid"], "hybrid planned call: bitmap")
        shares.append(hybrid.last_share)
        launched += hybrid.last_share > 0
    plan = {"shares": shares, "plan_now": hybrid._plan(n), "last_timing": hybrid.last_timing,
            "dev_rate": hybrid._dev_rate, "host_rate": hybrid._host_rate,
            "dev_overhead_ms": hybrid._dev_overhead, "bias": hybrid._bias,
            "dev_wall_ms": {f"{b}x{w}": v for (b, w), v in hybrid._dev_wall.items()},
            "root_model": {"card_fixed_ms": hybrid._root_fixed,
                           "card_leaves_per_ms": hybrid._card_leaf_rate,
                           "host_leaves_per_ms": hybrid._host_leaf_rate}}
    return hybrid, want_root, plan, expect_launches(launched, roots, 0)


def medians_in_turns(fns: dict, reps: int = 21) -> dict:
    """Median ms of each function, the functions called in turns (one of
    each a round), so that a drift of the host's speed hits all alike; and
    how many rounds the first function won."""
    runs = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            runs[name].append(time_host(fn))
    first, *rest = runs.values()
    out = {name: statistics.median(r) for name, r in runs.items()}
    out["rounds_first_won"] = sum(all(a < r[i] for r in rest) for i, a in enumerate(first))
    out["rounds"] = reps
    return out


def hybrid_metrics(fixtures, hybrid, torch_backend) -> dict:
    """Medians of 5 at the headline commit and block: the hybrid, TorchBackend
    and CpuBackend verify; medians of 21 in turns: the hybrid's and
    TorchBackend's root, the hybrid's verify_and_root beside TorchBackend's
    verify then root; the hybrid forced to the HYBRID_SPLIT share (it moves
    the model); the rate
    model's seeds from this run (host sigs/ms from CpuBackend; the device's
    fixed ms and sigs/ms from TorchBackend's walls at HYBRID_FIT_SIGS, the
    affine fit the planner assumes); and at each of HYBRID_SMALL_SIGS the
    hybrid (bitmap checked, the card's share), TorchBackend, CpuBackend
    and the native MSM alone."""
    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.sidecar.backend import CpuBackend

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    cpu = CpuBackend()

    def median_ms(fn, reps=5):
        return statistics.median(time_host(fn) for _ in range(reps))

    out = {
        "verify_ms": {
            "hybrid": median_ms(lambda: hybrid.batch_verify(pubs, msgs, sigs)),
            "torch": median_ms(lambda: torch_backend.batch_verify(pubs, msgs, sigs)),
            "cpu": median_ms(lambda: cpu.batch_verify(pubs, msgs, sigs)),
        },
        # Pairs compared in turns, 21 each: their difference is smaller than
        # the host's drift over a phase.
        "root_ms": {
            **medians_in_turns({"hybrid": lambda: hybrid.merkle_root(leaves),
                                "torch": lambda: torch_backend.merkle_root(leaves)}),
            "hybrid_root_on": hybrid.last_root,
        },
        "verify_and_root_ms": medians_in_turns({
            "hybrid": lambda: hybrid.verify_and_root(pubs, msgs, sigs, leaves),
            "torch": lambda: (torch_backend.batch_verify(pubs, msgs, sigs),
                              torch_backend.merkle_root(leaves))}),
        "hybrid_share_after": hybrid.last_share,
        "hybrid_last_timing": hybrid.last_timing,
    }
    out["verify_ms"]["hybrid_forced_split"] = median_ms(
        lambda: hybrid._routed_call(pubs, msgs, sigs, HYBRID_SPLIT))
    out["forced_split_last_timing"] = hybrid.last_timing
    (n1, n2) = HYBRID_FIT_SIGS
    w1 = median_ms(lambda: torch_backend.batch_verify(pubs[:n1], msgs[:n1], sigs[:n1]))
    w2 = median_ms(lambda: torch_backend.batch_verify(pubs[:n2], msgs[:n2], sigs[:n2]))
    slope = (w2 - w1) / (n2 - n1)
    out["rate_seeds"] = {
        "host_rate": n / out["verify_ms"]["cpu"],
        "dev_rate": 1.0 / slope if slope > 0 else None,
        "dev_overhead_ms": w1 - n1 * slope,
        "torch_wall_ms": {n1: w1, n2: w2},
    }
    small = {}
    for k in HYBRID_SMALL_SIGS:
        p, m, s = pubs[:k], msgs[:k], sigs[:k]
        check(hybrid.batch_verify(p, m, s) == (True, [True] * k),
              f"hybrid at {k} signatures: bitmap")
        small[k] = {"hybrid": median_ms(lambda: hybrid.batch_verify(p, m, s)),
                    "hybrid_share": hybrid.last_share,
                    "torch": median_ms(lambda: torch_backend.batch_verify(p, m, s)),
                    "cpu": median_ms(lambda: cpu.batch_verify(p, m, s)),
                    "native": median_ms(lambda: native.batch_verify(p, m, s))}
    out["small_batches_ms"] = small
    out["rates_after"] = {"dev_rate": hybrid._dev_rate, "host_rate": hybrid._host_rate}
    out["roots_by_leaves"] = hybrid_roots(leaves, hybrid, torch_backend, median_ms)
    return out


# Root sizes the root cost model is measured at: a small block, a mid-size
# one and the headline block.
HYBRID_ROOT_LEAVES = (1_000, 10_000, N_LEAVES)


def hybrid_roots(leaves, hybrid, torch_backend, median_ms) -> dict:
    """The root cost model's data: at each of HYBRID_ROOT_LEAVES the native
    tree's and the card's (TorchBackend's) root, medians of 5, bytes equal,
    and the hybrid's choice; the seeds they give (the host's leaves/ms at
    the largest tree; the card's fixed ms and leaves/ms from the line
    through the smallest and the largest)."""
    from cometbft_tpu_torch import native

    rows = {}
    for k in HYBRID_ROOT_LEAVES:
        ls = leaves[:k]
        check(native.merkle_root(ls) == torch_backend.merkle_root(ls),
              f"{k}-leaf root: the native tree and the card differ")
        hybrid.merkle_root(ls)
        rows[k] = {"native": median_ms(lambda: native.merkle_root(ls)),
                   "card": median_ms(lambda: torch_backend.merkle_root(ls)),
                   "hybrid_chose": hybrid.last_root}
    lo, hi = min(rows), max(rows)
    slope = (rows[hi]["card"] - rows[lo]["card"]) / (hi - lo)
    seeds = {"HOST_LEAVES_PER_MS": hi / rows[hi]["native"],
             "CARD_LEAVES_PER_MS": 1.0 / slope if slope > 0 else None,
             "CARD_ROOT_MS": rows[lo]["card"] - lo * slope}
    return {"rows": rows, "seeds": seeds}


def drive_chain_path(fixtures, pure, bn_fix, want_root):
    """The chain phase's checks, launch counts zeroed first and checked:
    ``build_resilient()`` serves the valid and the corrupted commit and the
    root from ``hybrid``, nothing degraded; the hybrid wrapped in a
    ChaosBackend at error rate 1.0 degrades to ``cpu`` with the same
    bitmaps and root (the native tree); ``ResilientBackend(build_bn254_chain())`` serves the 16-vote
    batch's exact bitmap from ``bn254-device``, then, the device tier
    wrapped at error rate 1.0, from ``bn254-host``. Returns (the launches,
    a record)."""
    from cometbft_tpu_torch.crypto.bn254 import build_bn254_chain
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.chaos import ChaosBackend
    from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend, build_resilient

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    want_bits = {"valid": [True] * n, "corrupted": [i not in want_bad for i in range(n)]}
    commits = {"valid": (msgs, sigs), "corrupted": (bad_msgs, bad_sigs)}
    rec, launched, times = {}, 0, {}

    _build.reset_launches()
    chain = build_resilient()
    names = [t.name for t in chain.tiers]
    check(names == ["hybrid", "cpu"], f"build_resilient() chain {names}: unset CMTPU_SIDECAR_ADDR "
                                      f"and CMTPU_FAULTS for this phase")
    hybrid = chain.tiers[0].backend
    check(chain.active_tier == "hybrid", f"active tier {chain.active_tier}, not hybrid")
    for name, (m, s) in commits.items():
        t0 = time.perf_counter()
        ok, bits = chain.batch_verify(pubs, m, s)
        times[f"chain_{name}"] = (time.perf_counter() - t0) * 1e3
        launched += hybrid.last_share > 0
        check(bits == want_bits[name] and ok == all(bits), f"chain, {name} commit: bitmap")
    check(chain.merkle_root(leaves) == want_root, "chain root != TorchBackend's")
    roots = hybrid.last_root == "card"
    c = chain.counters()
    check(c["active_tier"] == "hybrid" and c["degraded_calls"] == 0 and c["trips"] == 0
          and c["deadline_exceeded"] == 0 and c["crosscheck_catches"] == 0
          and c["tiers"]["hybrid"]["calls"] == 3,
          f"the chain degraded with no fault injected: {c}")
    rec["chain"] = c

    chaos = ChaosBackend(hybrid, "error:1", seed=0)
    injected = ResilientBackend([("hybrid", chaos), ("cpu", chain.tiers[1].backend)], backoff_ms=1)
    for name, (m, s) in commits.items():
        t0 = time.perf_counter()
        ok, bits = injected.batch_verify(pubs, m, s)
        times[f"injected_{name}"] = (time.perf_counter() - t0) * 1e3
        check(bits == want_bits[name] and ok == all(bits), f"injected chain, {name} commit: bitmap")
    from cometbft_tpu_torch.crypto import merkle

    t0 = time.perf_counter()
    check(injected.merkle_root(leaves) == want_root, "injected chain: the degraded root")
    times["injected_root"] = (time.perf_counter() - t0) * 1e3
    check(merkle.last_root_path == "host-native", f"the degraded root took {merkle.last_root_path}")
    c = injected.counters()
    check(c["degraded_calls"] == 3 and chaos.injected["error"] >= 2 and c["crosscheck_catches"] == 0,
          f"the injected chain did not degrade to cpu on each call: {c}")
    rec["injected"] = c

    votes = bn_fix["votes"]
    want_votes = [i != BAD_VOTE for i in range(N_VOTES)]
    bn_chain = ResilientBackend(build_bn254_chain())
    check([t.name for t in bn_chain.tiers] == ["bn254-device", "bn254-host", "cpu"],
          f"build_bn254_chain() tiers {[t.name for t in bn_chain.tiers]}")
    t0 = time.perf_counter()
    ok, bits = bn_chain.batch_verify(*votes)
    times["bn254_chain_votes"] = (time.perf_counter() - t0) * 1e3
    c = bn_chain.counters()
    check(not ok and bits == want_votes and c["degraded_calls"] == 0
          and c["tiers"]["bn254-device"]["calls"] == 1,
          f"BN254 chain: bitmap {bits} or served by another tier than bn254-device: {c}")
    rec["bn254_chain"] = c
    tiers = build_bn254_chain()
    bn_injected = ResilientBackend([("bn254-device", ChaosBackend(tiers[0][1], "error:1", seed=0)),
                                    *tiers[1:]], backoff_ms=1)
    t0 = time.perf_counter()
    ok, bits = bn_injected.batch_verify(*votes)
    times["bn254_injected_votes"] = (time.perf_counter() - t0) * 1e3
    c = bn_injected.counters()
    check(not ok and bits == want_votes and c["degraded_calls"] == 1
          and c["tiers"]["bn254-host"]["calls"] == 1 and c["tiers"]["cpu"]["calls"] == 0,
          f"injected BN254 chain: bitmap {bits} or not served by bn254-host: {c}")
    rec["bn254_injected"] = c
    rec["times_ms"] = times
    return expect_launches(launched, roots, 1), rec


# -- the process default, the fleet, the proofs paths, the tooling ---------------

# Batches the process default serves: the commit, a typical validator set's
# commit, one vote.
AUTO_SIGS = (N_SIGS, 150, 1)


@contextlib.contextmanager
def environ(**values):
    """Set (a str) or unset (None) environment variables for the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def count_shares(hybrid) -> list:
    """Record the hybrid's device share after each of its batch_verify calls
    (three launches a call with a share): the calls of the chains' and the
    fleet's threads."""
    shares, inner = [], hybrid.batch_verify

    def counted(pubs, msgs, sigs):
        out = inner(pubs, msgs, sigs)
        shares.append(hybrid.last_share)
        return out

    hybrid.batch_verify = counted
    return shares


def drive_auto_path(fixtures, pure, torch_backend) -> dict:
    """The process default: a fresh ``get_backend()`` under
    ``CMTPU_BACKEND=auto`` (built and warmed first, outside the launch
    count), then, counts zeroed, the commit, the corrupted commit and the
    batches of AUTO_SIGS, each bitmap equal to TorchBackend's; every call
    served by the hybrid tier with no degradation; the first 150-signature
    call with a share on the card; three launches a call with a device
    share. Then medians of 5 beside the bare chain's, its hybrid tier's and
    TorchBackend's, and set_backend(None) closes it (its dispatcher thread
    ends)."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler
    from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend

    _, _, pubs, msgs, sigs, _, _ = fixtures
    bad_msgs, bad_sigs, _ = corrupted_commit(pure, msgs, sigs)
    with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                 CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
        be.set_backend(None)
        t0 = time.perf_counter()
        auto = be.get_backend()
        setup_s = time.perf_counter() - t0
    check(isinstance(auto, CoalescingScheduler) and isinstance(auto.inner, ResilientBackend),
          f"CMTPU_BACKEND=auto served {type(auto).__name__}, not the coalesced chain")
    chain = auto.inner
    check([t.name for t in chain.tiers] == ["hybrid", "cpu"], f"auto chain {chain.counters()['chain']}")
    hybrid = be._hybrid_tier(chain)
    warm = {(ek.bucket_for(b, hybrid._n_dev), hybrid._n_dev) for b in ek.WARM_BUCKETS}
    check(warm <= set(hybrid._dev_wall), f"the default's hybrid was not warmed: {hybrid._dev_wall}")
    shares = count_shares(hybrid)
    cases = {"commit": (pubs, msgs, sigs), "corrupted": (pubs, bad_msgs, bad_sigs)}
    cases.update({f"sigs_{k}": (pubs[:k], msgs[:k], sigs[:k]) for k in AUTO_SIGS[1:]})
    want = {name: torch_backend.batch_verify(*case) for name, case in cases.items()}
    _build.reset_launches()
    first_share = {}
    for name, (p, m, s) in cases.items():
        check(auto.batch_verify(p, m, s) == want[name], f"auto, {name}: bitmap != TorchBackend's")
        first_share[name] = hybrid.last_share
    typical = f"sigs_{AUTO_SIGS[1]}"
    check(first_share[typical] > 0,
          f"the default's first {typical} call had no share on the card: {first_share}")
    c = chain.counters()
    check(c["active_tier"] == "hybrid" and c["degraded_calls"] == 0 and c["trips"] == 0
          and c["crosscheck_catches"] == 0 and c["tiers"]["hybrid"]["calls"] == len(cases),
          f"the default's chain degraded with no fault injected: {c}")
    launches = expect_launches(sum(1 for sh in shares if sh > 0), 0, 0)

    def median_ms(fn, reps=5):
        return statistics.median(time_host(fn) for _ in range(reps))

    # Where the default's time goes: the scheduler (auto against the bare
    # chain), the supervisor's cross-check (the chain against its hybrid).
    times = {}
    for k in AUTO_SIGS:
        p, m, s = pubs[:k], msgs[:k], sigs[:k]
        times[k] = {"auto": median_ms(lambda: auto.batch_verify(p, m, s)),
                    "auto_share": hybrid.last_share,
                    "chain": median_ms(lambda: chain.batch_verify(p, m, s)),
                    "hybrid": median_ms(lambda: hybrid.batch_verify(p, m, s)),
                    "torch": median_ms(lambda: torch_backend.batch_verify(p, m, s))}
    engine = auto.engine
    be.set_backend(None)
    check(be._backend is None and not engine._thread.is_alive(),
          "set_backend(None) left the default's dispatcher running")
    return {"launches": launches, "setup_s": setup_s, "first_share": first_share,
            "times_ms": times, "counters": c,
            "root_model": {"card_fixed_ms": hybrid._root_fixed,
                           "card_leaves_per_ms": hybrid._card_leaf_rate,
                           "host_leaves_per_ms": hybrid._host_leaf_rate}}


def start_sidecar_process(device: str = "torch"):
    """``python -m cometbft_tpu_torch.sidecar`` on 127.0.0.1:0, serving
    ``CMTPU_SIDECAR_DEVICE=device`` (``TorchBackend()`` on the card) and
    warmed, in a process of its own: started after this process built the
    kernels (it loads the same library), read with ``sidecar_process_addr``."""
    env = dict(os.environ, CMTPU_SIDECAR_ADDR="127.0.0.1:0", CMTPU_SIDECAR_DEVICE=device,
               CMTPU_SIDECAR_WARM="1")
    return subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.sidecar"],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sidecar_process_addr(proc) -> str:
    """The address the process printed, once its warm-up is complete."""
    addr, lines = None, []
    for line in proc.stdout:
        lines.append(line)
        m = re.search(r"sidecar: serving on (\S+)", line)
        if m:
            addr = m.group(1)
        if "warmup complete" in line:
            break
    check(addr is not None and proc.poll() is None,
          f"the sidecar process did not come up: {''.join(lines)[-3000:]}")
    threading.Thread(target=proc.stdout.read, daemon=True).start()  # drain the rest
    return addr


# Fleet walls at these batch sizes give the dispatch's fixed cost.
FANOUT_FIT_SIGS = (1024, N_SIGS)


def drive_fanout_path(fixtures, pure, torch_backend, proc, remote, want_root) -> dict:
    """The fleet tier on one card: two port sidecars (``proc``, another
    process serving on ``remote``, and one in this process on 127.0.0.1:0,
    both serving TorchBackend()) named by CMTPU_FANOUT_PEERS, and the local
    hybrid.
    ``build_resilient()`` is headed by ``fanout``. First the commit's median
    of 5 beside TorchBackend's and the fleet's walls at FANOUT_FIT_SIGS;
    then, counts zeroed, the commit's and the corrupted commit's bitmaps
    equal TorchBackend's, the fleet's width the sum of its shards'; then
    the other process is killed: the next commit
    shows exactly one redistribution and exact bits, and the root fails
    over past it (CMTPU_FANOUT_COOLDOWN_MS=0, so the dead shard is tried
    again). Launches counted in this process: three a verify dispatch of
    the in-process sidecar and a hybrid call with a device share, two a
    root."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.backend import TorchBackend
    from cometbft_tpu_torch.sidecar.service import SidecarServer
    from cometbft_tpu_torch.sidecar.supervisor import build_resilient

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    want = {"valid": (True, [True] * n), "corrupted": (False, [i not in want_bad for i in range(n)])}
    server = SidecarServer("127.0.0.1:0", backend=TorchBackend()).start()
    chain = None
    try:
        with environ(CMTPU_FANOUT_PEERS=f"{remote},{server.bound_addr}",
                     CMTPU_FANOUT_COOLDOWN_MS="0", CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            chain = build_resilient()
        names = [t.name for t in chain.tiers]
        check(names == ["fanout", "hybrid", "cpu"], f"fanout chain {names}")
        fan, hybrid = chain.tiers[0].backend, chain.tiers[1].backend
        check([s.name for s in fan.shards] == ["peer0", "peer1", "local"]
              and fan.shards[2].backend is hybrid, f"fleet shards {fan.shard_widths()}")
        rec, times = {}, {}
        times["fanout_commit"] = [time_host(lambda: chain.batch_verify(pubs, msgs, sigs))
                                  for _ in range(5)]
        times["torch_commit"] = [time_host(lambda: torch_backend.batch_verify(pubs, msgs, sigs))
                                 for _ in range(5)]
        walls = {k: statistics.median(time_host(lambda: fan.batch_verify(pubs[:k], msgs[:k], sigs[:k]))
                                      for _ in range(3)) for k in FANOUT_FIT_SIGS}
        (k1, k2) = FANOUT_FIT_SIGS
        slope = (walls[k2] - walls[k1]) / (k2 - k1)
        rec["fit"] = {"walls_ms": walls, "fixed_ms": walls[k1] - k1 * slope,
                      "sigs_per_ms_a_card": 1.0 / slope / fan.mesh_width() if slope > 0 else None}
        shares = count_shares(hybrid)
        _build.reset_launches()
        d0 = server.scheduler_counters()["dispatches"]
        for name, (m, s) in {"valid": (msgs, sigs), "corrupted": (bad_msgs, bad_sigs)}.items():
            check(chain.batch_verify(pubs, m, s) == want[name], f"fanout chain, {name}: bitmap")
        check(fan.mesh_width() == 3 and chain.mesh_width() == 3,
              f"fleet width {fan.mesh_width()}, chain {chain.mesh_width()}: not the sum 3")
        c = chain.counters()
        check(c["active_tier"] == "fanout" and c["degraded_calls"] == 0
              and fan.counters()["redistributions"] == 0, f"the fleet degraded unprovoked: {c}")
        proc.kill()
        proc.wait()
        r0 = fan.counters()["redistributions"]
        check(chain.batch_verify(pubs, msgs, sigs) == want["valid"],
              "fanout chain after a shard died: bitmap")
        fc = fan.counters()
        check(fc["redistributions"] - r0 == 1 and chain.counters()["degraded_calls"] == 0,
              f"a dead shard: expected one redistribution, fanout counters {fc}")
        f0 = fc["shards"]["peer0"]["failures"]
        check(chain.merkle_root(leaves) == want_root, "fanout root after failover")
        fc = fan.counters()
        check(fc["shards"]["peer0"]["failures"] == f0 + 1,
              f"the root did not fail over past the dead shard: {fc}")
        dispatches = server.scheduler_counters()["dispatches"] - d0
        launches = expect_launches(dispatches + sum(1 for sh in shares if sh > 0), 1, 0)
        rec.update({"launches": launches, "sidecar_dispatches": dispatches, "fanout": fc,
                    "chain": chain.counters(), "times_ms": times})
        return rec
    finally:
        if chain is not None:
            chain.close()
        server.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


PROOF_PATH_SETS = ("64k", "partset")


def drive_proofs_paths(fixtures, host) -> dict:
    """crypto/merkle's proofs path selection at the 65,536-leaf block and
    the part set: the card (CMTPU_DEVICE_PROOFS=1, two sha256 launches a
    set) and the native host pass (=0, none), each root and every 97th
    proof and the last equal to the pure pass, medians of 3 each; then the
    default (unset) takes DEVICE_PROOFS_DEFAULT's path."""
    from cometbft_tpu_torch.ops import _build

    sets = proof_sets(fixtures)
    out, device_calls = {}, 0
    _build.reset_launches()
    for name in PROOF_PATH_SETS:
        items = sets[name]
        root_p, proofs_p = host.proofs_from_byte_slices_pure(items)
        row = {}
        for path, env in (("device", "1"), ("host-native", "0")):
            with environ(CMTPU_DEVICE_PROOFS=env):
                root, proofs = host.proofs_from_byte_slices(items)
                check(host.last_proofs_path == path,
                      f"{name}: CMTPU_DEVICE_PROOFS={env} took {host.last_proofs_path}")
                check(root == root_p and len(proofs) == len(items), f"{name}, {path}: root or count")
                for i in list(range(0, len(items), 97)) + [len(items) - 1]:
                    a, b = proofs[i], proofs_p[i]
                    check((a.total, a.index, a.leaf_hash, list(a.aunts))
                          == (b.total, b.index, b.leaf_hash, b.aunts), f"{name}, {path}: proof {i}")
                row[path] = statistics.median(time_host(lambda: host.proofs_from_byte_slices(items))
                                              for _ in range(3))
                device_calls += 4 if path == "device" else 0
        with environ(CMTPU_DEVICE_PROOFS=None):
            host.proofs_from_byte_slices(items)
            row["default"] = host.last_proofs_path
            device_calls += host.last_proofs_path == "device"
        out[name] = row
    launches = expect_launches(0, device_calls, 0)
    want = "device" if host.DEVICE_PROOFS_DEFAULT else "host-native"
    check(all(r["default"] == want for r in out.values()), f"default proofs path: {out}")
    return {"launches": launches, "ms": out, "default": want}


def http_get(port: int, path: str) -> str:
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120).read().decode()


def drive_tooling(fixtures, backend, probe_rc: int, probe_out: str) -> dict:
    """The port's tooling, counts zeroed: PprofServer on port 0 (its index,
    /debug/torch/memory after a headline call: allocated bytes on cuda:0,
    /debug/torch/trace?seconds=1 taken during headline calls: a trace
    written, and whether it holds the ladder's record);
    ``dryrun_multichip(2)`` on the card; ``entry()``; and the device probe's
    process (run after the build: its exit code and output) ended with PROBE
    OK."""
    import tempfile

    from cometbft_tpu_torch.entry import dryrun_multichip, entry
    from cometbft_tpu_torch.libs.pprof import PprofServer
    from cometbft_tpu_torch.ops import _build

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    rec = {}
    _build.reset_launches()
    headlines = 0

    def headline():
        nonlocal headlines
        backend.batch_verify(pubs, msgs, sigs)
        backend.merkle_root(leaves)
        headlines += 1

    srv = PprofServer(port=0)
    srv.start()
    tdir = tempfile.mkdtemp(prefix="torch-trace-")
    try:
        index = http_get(srv.port, "/debug/pprof/")
        check("/debug/torch/memory" in index and "/debug/torch/trace" in index, f"index: {index}")
        headline()
        mem = http_get(srv.port, "/debug/torch/memory")
        m = re.search(r"^cuda:0 .*allocated_bytes\.all\.current=(\d+)", mem, re.M)
        check(m is not None and int(m.group(1)) > 0, f"/debug/torch/memory: {mem[:500]}")
        rec["allocated_bytes_cuda0"] = int(m.group(1))
        box = {}
        t = threading.Thread(target=lambda: box.update(
            body=http_get(srv.port, f"/debug/torch/trace?seconds=1&dir={tdir}")))
        t.start()
        time.sleep(0.1)
        while t.is_alive():
            headline()
        t.join()
        body = box.get("body", "")
        m = re.search(r"trace written to (\S+):", body)
        check(m is not None and os.path.exists(m.group(1)), f"/debug/torch/trace: {body}")
        with open(m.group(1)) as f:
            names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])
                     if e.get("cat") == "kernel"}
        rec["trace"] = {"reply": body, "kernel_names": len(names),
                        "ladder_record": any("ladder_verify_kernel" in k for k in names)
                        or "not measured"}
    finally:
        srv.stop()
        import shutil

        shutil.rmtree(tdir, ignore_errors=True)
    dryrun_multichip(2)
    fn, args = entry()
    check(bool(fn(*args).all()), "entry(): the example batch did not verify")
    got = dict(_build.LAUNCHES)
    # headline calls, the dry run's two shards and entry(): three launches a
    # verify; two sha256 a headline root, the dry run's leaf hash and forest
    want_verify = headlines + 2 + 1
    check(all(got[k] == want_verify for k in ("ladder", "decompress", "sha512"))
          and got["sha256"] >= 2 * headlines + 1 and got["bn254"] == 0,
          f"tooling launches {got}: expected {want_verify} verify launch sets")
    rec["launches"] = got
    check(probe_rc == 0 and "PROBE OK" in probe_out, f"the device probe failed: {probe_out[-2000:]}")
    rec["probe"] = [line for line in probe_out.splitlines() if line.startswith("[")]
    return rec


def expect_launches(verify_calls: int, roots: int, bn254: int) -> dict:
    """The launch counts since the last reset, checked against a path's
    verify dispatches (three launches each), roots (two sha256 each) and
    bn254 launches."""
    from cometbft_tpu_torch.ops import _build

    got = dict(_build.LAUNCHES)
    want = {"ladder": verify_calls, "decompress": verify_calls, "sha512": verify_calls,
            "sha256": 2 * roots, "bn254": bn254}
    check(got == want, f"launches {got}, expected {want}")
    return got


# -- the commit path -------------------------------------------------------------

COMMIT_CHAIN_ID = "chip-smoke-chain"
COMMIT_HEIGHT = 1_000
COMMIT_T0 = 1_700_000_000
COMMIT_POWER = 10
COMMIT_SMALL = 150  # a typical validator set's commit
# Signers of the hop the trusted set cannot trust: they hold 100 of the new
# set's power each (the others 1), but only COMMIT_POWER of the trusted set's.
CANT_TRUST_SIGNERS = 3_000
N_BN254_COMMIT = 16
TRUSTING_PERIOD_NS = 14 * 24 * 3600 * 10**9
CLOCK_DRIFT_NS = 10 * 10**9
COMMIT_REPS = 5
SIGN_PROCESSES = min(8, os.cpu_count() or 1)

_worker_fb = None


def sign_jobs(jobs) -> list:
    """Pool worker: the signatures of ("ed25519", seed, pub, msg) and
    ("bn254", sk, msg) jobs and the public keys of ("pub", seed) jobs, by
    the pure modules."""
    global _worker_fb
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.crypto import ed25519_pure as pure

    out = []
    for kind, *args in jobs:
        if kind == "bn254":
            out.append(bn.sign(*args))
            continue
        if _worker_fb is None:
            _worker_fb = FixedBase(pure)
        if kind == "pub":  # the public key of a seed
            out.append(pure.point_compress(_worker_fb.mult(pure.secret_expand(args[0])[0])))
            continue
        out.append(sign_known(pure, _worker_fb, *args))
    return out


def commit_fixtures(fixtures) -> dict:
    """The commit phase's chain, as wire bytes, built with the port's types
    alone: the 10,240-validator ed25519 set of make_fixtures' seeds at equal
    power; headers at COMMIT_HEIGHT (h), h + 1 and h + 5 over it and their
    commits, where each validator signs its own canonical sign bytes
    (BlockIDFlagCommit, seconds equal, nanos differing, as real precommits
    are); a header at h + 6 over the same keys with CANT_TRUST_SIGNERS
    validators holding most of its power and signing, the rest absent; the
    commit of a COMMIT_SMALL-validator set; and an N_BN254_COMMIT-validator
    BN254 set's commit in aggregate form, with a copy in which one signer
    signed other bytes. Every signature is made in a pool of
    SIGN_PROCESSES processes (spawned; ended when it returns)."""
    import multiprocessing

    from cometbft_tpu_torch.crypto import bn254, ed25519
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.types import (BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig,
                                          Consensus, Header, PartSetHeader, SignedHeader, Time,
                                          Validator, ValidatorSet)
    from cometbft_tpu_torch.types.block import aggregate_commit

    _, seeds, pubs, *_ = fixtures
    secret = {ed25519.PubKey(p).address(): (s, p) for s, p in zip(seeds, pubs)}
    vals = ValidatorSet([Validator.new(ed25519.PubKey(p), COMMIT_POWER) for p in pubs])
    cant = ValidatorSet([Validator.new(v.pub_key, 100 if i < CANT_TRUST_SIGNERS else 1)
                         for i, v in enumerate(vals.validators)])
    small = ValidatorSet([Validator.new(ed25519.PubKey(p), COMMIT_POWER)
                          for p in pubs[:COMMIT_SMALL]])
    bn_sks = [int.from_bytes(hashlib.sha256(b"chip-smoke-bn254-commit-%d" % i).digest(), "big")
              % bn.R for i in range(N_BN254_COMMIT)]
    bn_sk = {bn254.PubKey(bn.public_key(sk)).address(): sk for sk in bn_sks}
    bn_vals = ValidatorSet([Validator.new(bn254.PubKey(bn.public_key(sk)), COMMIT_POWER)
                            for sk in bn_sks])

    def unsigned(height, vset, next_set, last_block_id, signers):
        header = Header(
            version=Consensus(11, 1), chain_id=COMMIT_CHAIN_ID, height=height,
            time=Time(COMMIT_T0 + 6 * height, 0), last_block_id=last_block_id,
            validators_hash=vset.hash(), next_validators_hash=next_set.hash(),
            app_hash=hashlib.sha256(b"app-%d" % height).digest(),
            proposer_address=vset.get_proposer().address)
        block_id = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
        sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                          Time(COMMIT_T0 + 6 * height + 1, 1_000 + 977 * i), b"")
                if i < signers else CommitSig.absent() for i, v in enumerate(vset.validators)]
        return header, Commit(height=height, round=0, block_id=block_id, signatures=sigs)

    h = COMMIT_HEIGHT
    plan = {"h": unsigned(h, vals, vals, BlockID(), N_SIGS)}
    plan["h1"] = unsigned(h + 1, vals, vals, plan["h"][1].block_id, N_SIGS)
    plan["h5"] = unsigned(h + 5, vals, vals, BlockID(), N_SIGS)
    plan["cant"] = unsigned(h + 6, cant, cant, BlockID(), CANT_TRUST_SIGNERS)
    plan["small"] = unsigned(h, small, small, BlockID(), COMMIT_SMALL)
    plan["bn254"] = unsigned(h, bn_vals, bn_vals, BlockID(), N_BN254_COMMIT)
    jobs, spans = [], {}
    for name, (_, commit) in plan.items():
        sign_bytes = commit.vote_sign_bytes_all(COMMIT_CHAIN_ID)
        start = len(jobs)
        for cs, msg in zip(commit.signatures, sign_bytes):
            if not cs.for_block_flag():
                continue
            if name == "bn254":
                jobs.append(("bn254", bn_sk[cs.validator_address], msg))
            else:
                jobs.append(("ed25519", *secret[cs.validator_address], msg))
        spans[name] = (start, len(jobs))
    wrong_at = N_BN254_COMMIT // 2
    jobs.append(("bn254", bn_sk[plan["bn254"][1].signatures[wrong_at].validator_address],
                 b"chip-smoke-not-the-sign-bytes"))
    # one chunk a bn254 job (each a hash-to-G2 and a G2 multiply), first;
    # then chunks of 512 ed25519 jobs
    bn_idx = [i for i, job in enumerate(jobs) if job[0] == "bn254"]
    ed_idx = [i for i, job in enumerate(jobs) if job[0] != "bn254"]
    chunks = [[i] for i in bn_idx] + [ed_idx[i : i + 512] for i in range(0, len(ed_idx), 512)]
    with multiprocessing.get_context("spawn").Pool(SIGN_PROCESSES) as pool:
        results = pool.map(sign_jobs, [[jobs[i] for i in c] for c in chunks], chunksize=1)
    sig_of = {i: sig for c, res in zip(chunks, results) for i, sig in zip(c, res)}

    def signed(name):
        header, commit = plan[name]
        start, _ = spans[name]
        sigs, k = [], start
        for cs in commit.signatures:
            if cs.for_block_flag():
                cs = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, sig_of[k])
                k += 1
            sigs.append(cs)
        return SignedHeader(header, Commit(height=commit.height, round=0,
                                           block_id=commit.block_id, signatures=sigs))

    out = {name: signed(name).encode() for name in plan if name != "bn254"}
    bn_sh = signed("bn254")
    out["bn254"] = SignedHeader(bn_sh.header, aggregate_commit(bn_sh.commit, bn_vals)).encode()
    wrong = list(bn_sh.commit.signatures)
    cs = wrong[wrong_at]
    wrong[wrong_at] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                                sig_of[len(jobs) - 1])
    out["bn254_wrong"] = aggregate_commit(
        Commit(height=h, round=0, block_id=bn_sh.commit.block_id, signatures=wrong),
        bn_vals).encode()
    for name, vset in (("vals", vals), ("cant_vals", cant), ("small_vals", small),
                       ("bn254_vals", bn_vals)):
        out[name] = vset.encode()

    good = SignedHeader.decode(out["h"]).commit
    n = len(good.signatures)
    bad_at = sorted({17, n // 5, n // 2 + 3, n * 7 // 8, n - 1})
    sigs = list(good.signatures)
    for i in bad_at:
        s = bytearray(sigs[i].signature)
        s[40] ^= 0x08
        sigs[i] = CommitSig(sigs[i].block_id_flag, sigs[i].validator_address, sigs[i].timestamp,
                            bytes(s))
    out["corrupted"] = Commit(height=h, round=0, block_id=good.block_id, signatures=sigs).encode()
    out["corrupted_at"] = bad_at
    # just over 1/3 of the power absent: the last n // 3 + 1 signers
    absent = n // 3 + 1
    out["insufficient"] = Commit(height=h, round=0, block_id=good.block_id,
                                 signatures=good.signatures[: n - absent]
                                 + [CommitSig.absent()] * absent).encode()
    out["insufficient_power"] = ((n - absent) * COMMIT_POWER, n * COMMIT_POWER * 2 // 3)
    return out


class BitmapRecorder:
    """A backend that records each bitmap its inner backend returns."""

    def __init__(self, inner):
        self.inner = inner
        self.bitmaps: list[list] = []

    def batch_verify(self, pubs, msgs, sigs):
        ok, bits = self.inner.batch_verify(pubs, msgs, sigs)
        self.bitmaps.append(list(bits))
        return ok, bits

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


def raises(exc_type, fn):
    """The exception of type exc_type that fn() raises; fails otherwise."""
    try:
        fn()
    except exc_type as e:
        return e
    fail(f"{getattr(fn, '__name__', fn)} did not raise {exc_type.__name__}")


def commit_workloads(cf) -> dict:
    """name -> (prepare, call): prepare() decodes the workload's objects
    afresh from cf's bytes (no memo of an earlier call survives) and clears
    the verified-triple cache; call(objects) runs the user's entry point."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.types import Fraction, SignedHeader, Time, ValidatorSet, validation

    h = COMMIT_HEIGHT
    now = Time(COMMIT_T0 + 6 * h + 3600, 0)

    def commit_of(key, vals_key):
        def prepare():
            ed25519._verified.clear()
            return ValidatorSet.decode(cf[vals_key]), SignedHeader.decode(cf[key]).commit
        return prepare

    def hop_of(key, vals_key):
        def prepare():
            ed25519._verified.clear()
            return (SignedHeader.decode(cf["h"]), ValidatorSet.decode(cf["vals"]),
                    SignedHeader.decode(cf[key]), ValidatorSet.decode(cf[vals_key]))
        return prepare

    def full(args):
        vals, commit = args
        validation.verify_commit(COMMIT_CHAIN_ID, vals, commit.block_id, h, commit)

    def light(args):
        vals, commit = args
        validation.verify_commit_light(COMMIT_CHAIN_ID, vals, commit.block_id, h, commit)

    def adjacent(args):
        trusted, _, untrusted, uvals = args
        verifier.verify_adjacent(trusted, untrusted, uvals, TRUSTING_PERIOD_NS, now,
                                 CLOCK_DRIFT_NS)

    def non_adjacent(args):
        verifier.verify_non_adjacent(*args, TRUSTING_PERIOD_NS, now, CLOCK_DRIFT_NS,
                                     Fraction(1, 3))

    return {
        "verify_commit_10k": (commit_of("h", "vals"), full),
        "verify_commit_light_10k": (commit_of("h", "vals"), light),
        f"verify_commit_{COMMIT_SMALL}": (commit_of("small", "small_vals"), full),
        f"verify_commit_light_{COMMIT_SMALL}": (commit_of("small", "small_vals"), light),
        "hop_adjacent_10k": (hop_of("h1", "vals"), adjacent),
        "hop_non_adjacent_10k": (hop_of("h5", "vals"), non_adjacent),
    }


def drive_commit_path(cf, torch_backend) -> dict:
    """The commit phase's gates, launch counts zeroed first: under
    ``set_backend(TorchBackend())``, verify_commit and verify_commit_light
    of the good 10,240-validator commit, the adjacent hop (h -> h + 1) and
    the skipping hop (h -> h + 5, trust level 1/3) pass; the commit with 5
    corrupted signatures raises "wrong signature (#i)" for the lowest, the
    backend's bitmap false exactly at the 5; the commit with just over 1/3
    of the power absent raises ErrNotEnoughVotingPowerSigned with the exact
    got and needed; the hop to h + 6 raises ErrNewValSetCantBeTrusted; then
    the BN254 aggregate commit verifies through ``get_bn254_backend()``
    (the process default, its device tier first) and the copy with one
    wrong signer raises. One sha512 / decompress / ladder set a commit
    verification that reaches the backend (two for the skipping hop: its
    light check sends what the trusting check left uncached), one bn254
    launch an aggregate, no ChainExhausted fallback."""
    from cometbft_tpu_torch.crypto import bn254, ed25519
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import (Commit, Fraction, SignedHeader, Time, ValidatorSet,
                                          validation)

    h = COMMIT_HEIGHT
    work = commit_workloads(cf)
    recorder = BitmapRecorder(torch_backend)
    fallbacks = ed25519.scalar_fallbacks
    be.set_backend(recorder)
    _build.reset_launches()
    try:
        for name in ("verify_commit_10k", "verify_commit_light_10k", "hop_adjacent_10k",
                     "hop_non_adjacent_10k"):
            prepare, call = work[name]
            call(prepare())
        sizes = [len(b) for b in recorder.bitmaps]
        light_n = N_SIGS * 2 // 3 + 1
        trusting_n = N_SIGS // 3 + 1
        check(sizes == [N_SIGS, light_n, light_n, trusting_n, light_n - trusting_n]
              and all(all(b) for b in recorder.bitmaps), f"good commit batches {sizes}")

        vals = ValidatorSet.decode(cf["vals"])
        ed25519._verified.clear()
        bad = Commit.decode(cf["corrupted"])
        e = raises(ValueError, lambda: validation.verify_commit(
            COMMIT_CHAIN_ID, vals, bad.block_id, h, bad))
        first = cf["corrupted_at"][0]
        check(str(e).startswith(f"wrong signature (#{first}): "), f"corrupted commit: {e}")
        bits = recorder.bitmaps[-1]
        check([i for i, b in enumerate(bits) if not b] == cf["corrupted_at"],
              "corrupted commit: the bitmap is not false exactly at the corrupted indices")

        short = Commit.decode(cf["insufficient"])
        e = raises(validation.ErrNotEnoughVotingPowerSigned, lambda: validation.verify_commit(
            COMMIT_CHAIN_ID, vals, short.block_id, h, short))
        check((e.got, e.needed) == cf["insufficient_power"],
              f"insufficient power: got {e.got}, needed {e.needed}")

        now = Time(COMMIT_T0 + 6 * h + 3600, 0)
        raises(verifier.ErrNewValSetCantBeTrusted, lambda: verifier.verify_non_adjacent(
            SignedHeader.decode(cf["h"]), vals, SignedHeader.decode(cf["cant"]),
            ValidatorSet.decode(cf["cant_vals"]), TRUSTING_PERIOD_NS, now, CLOCK_DRIFT_NS,
            Fraction(1, 3)))
        check(len(recorder.bitmaps) == 6, f"{len(recorder.bitmaps)} backend calls, expected 6")

        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FAULTS=None):
            bn254.set_bn254_backend(None)
            bn_backend = bn254.get_bn254_backend()
        bn_vals = ValidatorSet.decode(cf["bn254_vals"])
        agg = SignedHeader.decode(cf["bn254"]).commit
        check(agg.is_aggregate(), "the BN254 commit is not in aggregate form")
        t0 = time.perf_counter()
        validation.verify_commit(COMMIT_CHAIN_ID, bn_vals, agg.block_id, h, agg)
        agg_ms = (time.perf_counter() - t0) * 1e3
        wrong = Commit.decode(cf["bn254_wrong"])
        e = raises(ValueError, lambda: validation.verify_commit(
            COMMIT_CHAIN_ID, bn_vals, wrong.block_id, h, wrong))
        check(str(e) == f"invalid aggregate signature for commit at height {h}",
              f"wrong BN254 signer: {e}")
        counters = bn_backend.inner.counters()
        check(counters["tiers"]["bn254-device"]["calls"] == 2 and counters["degraded_calls"] == 0,
              f"the BN254 aggregates were not served by bn254-device: {counters}")
        launches = expect_launches(6, 0, 2)
    finally:
        be.set_backend(None)
        bn254.set_bn254_backend(None)
    check(ed25519.scalar_fallbacks == fallbacks, "a verification took the ChainExhausted fallback")
    return {"launches": launches, "batches": [len(b) for b in recorder.bitmaps],
            "bn254_aggregate_ms": agg_ms, "bn254_chain": counters}


def commit_stage_split(cf, torch_backend, dev) -> dict:
    """One verify_commit of the 10,240-validator commit under
    ``TorchBackend()``, from a freshly decoded commit and an empty cache,
    stage by stage, each ended by a synchronize: the sign bytes
    (``vote_sign_bytes_all``), the tally loop and ``bv.add`` (with the
    basic checks before it), the cache filter, the backend call (then its
    pack and kernels, each stage_split's way, on the same triples), the
    merge into the cache; and the hop's ``ValidatorSet.hash`` and
    ``Header.hash`` of freshly decoded objects."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Commit, Header, SignedHeader, ValidatorSet, validation

    marks, box = {}, {}

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    class Marked:
        def batch_verify(self, pubs, msgs, sigs):
            mark("backend_in")
            out = torch_backend.batch_verify(pubs, msgs, sigs)
            mark("backend_out")
            box["triples"] = (pubs, msgs, sigs)
            return out

    sign_bytes_all, verify = Commit.vote_sign_bytes_all, ed25519.BatchVerifier.verify

    def timed_sign_bytes(commit, chain_id):
        mark("sign_bytes_in")
        out = sign_bytes_all(commit, chain_id)
        mark("sign_bytes_out")
        return out

    def timed_verify(bv):
        mark("verify_in")
        out = verify(bv)
        mark("verify_out")
        return out

    vals = ValidatorSet.decode(cf["vals"])
    commit = SignedHeader.decode(cf["h"]).commit
    ed25519._verified.clear()
    be.set_backend(Marked())
    Commit.vote_sign_bytes_all, ed25519.BatchVerifier.verify = timed_sign_bytes, timed_verify
    try:
        mark("start")
        validation.verify_commit(COMMIT_CHAIN_ID, vals, commit.block_id, COMMIT_HEIGHT, commit)
        mark("end")
    finally:
        Commit.vote_sign_bytes_all, ed25519.BatchVerifier.verify = sign_bytes_all, verify
        be.set_backend(None)
    ms = lambda a, b: (marks[b] - marks[a]) * 1e3  # noqa: E731
    st = {"total": ms("start", "end"), "sign_bytes": ms("sign_bytes_in", "sign_bytes_out"),
          "tally_and_add": ms("start", "verify_in") - ms("sign_bytes_in", "sign_bytes_out"),
          "cache_filter": ms("verify_in", "backend_in"),
          "backend_call": ms("backend_in", "backend_out"),
          "merge_and_cache_put": ms("backend_out", "verify_out"),
          "after_verify": ms("verify_out", "end")}
    pubs, msgs, sigs = box["triples"]
    inner = stage_split((None, None, pubs, msgs, sigs, [b"\x00"], None), dev)
    st.update({f"backend_{k}": v for k, v in inner.items() if not k.startswith("merkle")})
    fresh_vals = ValidatorSet.decode(cf["vals"])
    fresh_header = Header.decode(SignedHeader.decode(cf["h1"]).header.encode())
    st["hop_validator_set_hash"] = time_host(fresh_vals.hash)
    st["hop_header_hash"] = time_host(fresh_header.hash)
    return st


def commit_metrics(cf, torch_backend, auto, dev) -> dict:
    """Medians of COMMIT_REPS of each workload of ``commit_workloads``
    under ``set_backend(TorchBackend())`` and under the process default
    (``auto``, the backend ``CMTPU_BACKEND=auto`` builds), in turns, each
    call from freshly decoded objects and an empty cache; and the median
    stage split of 3 calls."""
    from cometbft_tpu_torch.sidecar import backend as be

    work = commit_workloads(cf)
    runs = {name: {"torch": [], "auto": []} for name in work}
    try:
        for rep in range(COMMIT_REPS):
            tiers = [("torch", torch_backend), ("auto", auto)]
            for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
                be.set_backend(backend)
                for name, (prepare, call) in work.items():
                    args = prepare()
                    runs[name][tier].append(time_host(lambda: call(args)))
    finally:
        be.set_backend(None)
    medians = {name: {tier: statistics.median(v) for tier, v in r.items()}
               for name, r in runs.items()}
    splits = [commit_stage_split(cf, torch_backend, dev) for _ in range(3)]
    stages = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    return {"medians_ms": medians, "runs_ms": runs, "stages_ms": stages}


# -- the blocksync path ----------------------------------------------------------

BSYNC_CHAIN_ID = "chip-smoke-bsync"
BSYNC_T0 = 1_700_000_000
BSYNC_POWER = 10
# The 10,240-validator chain: the source builds BSYNC_HEIGHTS heights, a
# fresh node syncs BSYNC_HEIGHTS - 1 of them (the last block's LastCommit
# verifies the one before it). The 150-validator chain is long enough for one
# full window of PREFETCH_WINDOW (32) blocks.
BSYNC_HEIGHTS = 6
BSYNC_SMALL = COMMIT_SMALL
BSYNC_SMALL_HEIGHTS = 33
BSYNC_TXS = 4_096  # within the default mempool.size of 5,000: the proposer reaps them all
BSYNC_TX_BYTES = 250
BSYNC_BAD_HEIGHT = 10  # the bad peer's block at this height carries a flipped commit signature
BSYNC_REPS = 1  # timed rounds: one keeps the whole run, light phase included, near 630 s
BSYNC_SIGN_CHUNK = 512


def bsync_tx(height: int, i: int) -> bytes:
    """A kvstore transaction of BSYNC_TX_BYTES bytes, ``key=value``; keys
    rise with the height and index (the app's sorted store appends)."""
    head = b"h%04d-tx%05d=" % (height, i)
    return (head + hashlib.sha256(head).hexdigest().encode() * 4)[:BSYNC_TX_BYTES]


class BsyncPeer:
    """A peer double that serves a source chain's blocks: a block request
    is answered at once, through the syncing reactor's ``receive``, by the
    encoded ``block_response`` (``corrupt`` maps a height to other bytes)."""

    def __init__(self, peer_id: str, responses: list, corrupt=None):
        self.id = peer_id
        self.responses = responses
        self.corrupt = dict(corrupt or {})
        self.reactor = None
        self.stopped = False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        from cometbft_tpu_torch.blocksync import reactor as br

        if self.stopped:
            return False
        kind, payload = br.decode_message(msg)
        if kind == "block_request":
            if payload in self.corrupt:
                reply = self.corrupt[payload]
            elif payload <= len(self.responses):
                reply = self.responses[payload - 1]
            else:
                reply = br.encode_no_block_response(payload)
            self.reactor.receive(chan_id, self, reply)
        elif kind == "status_request":
            self.reactor.receive(chan_id, self, br.encode_status_response(len(self.responses), 1))
        return True


class BsyncSwitch:
    """A switch double: peers by id, and the peers it stopped."""

    def __init__(self, reactor):
        self.reactor = reactor
        self.peers: dict = {}
        self.stops: list = []

    def get_peer(self, peer_id):
        return self.peers.get(peer_id)

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        for p in list(self.peers.values()):
            p.try_send(chan_id, msg)

    def stop_peer_for_error(self, peer, reason) -> None:
        self.stops.append(peer.id)
        peer.stopped = True
        self.peers.pop(peer.id, None)
        self.reactor.remove_peer(peer, reason)


def bsync_node(gen):
    """A fresh node from genesis: the port's PersistentKVStoreApplication
    behind the local ABCI client, CListMempool, a MemDB under BlockStore and
    StateStore, and BlockExecutor (no evidence pool, no event bus)."""
    from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication
    from cometbft_tpu_torch.config import MempoolConfig
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.proxy import AppConns, local_client_creator
    from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
    from cometbft_tpu_torch.store import BlockStore

    state = make_genesis_state(gen)
    conns = AppConns(local_client_creator(PersistentKVStoreApplication()))
    conns.start()
    mempool = CListMempool(MempoolConfig(), conns.mempool)
    db = MemDB()
    ss, bs = StateStore(db), BlockStore(db)
    ss.save(state)
    return {"state": state, "executor": BlockExecutor(ss, conns.consensus, mempool, None, bs),
            "block_store": bs, "state_store": ss, "mempool": mempool, "db": db}


def bsync_source(seeds, pubs, n_heights: int, n_txs: int, pool) -> dict:
    """A source node's chain: a genesis of the given keys at equal power,
    then n_heights blocks, each proposed by the port's BlockExecutor from
    n_txs kvstore transactions admitted to its CListMempool, applied to its
    PersistentKVStoreApplication, and committed by every validator (each
    signs its canonical precommit in the process pool). Returns the genesis,
    each block's encoded block_response, the source's state after each
    height (store bytes), its blocks' bytes and its part counts, and the
    node itself (its stores and executor) with its last state, which the
    light phase goes on with."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.state import store as state_store
    from cometbft_tpu_torch.types import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, Time
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    secret = {ed25519.PubKey(p).address(): (s, p) for s, p in zip(seeds, pubs)}
    gen = GenesisDoc(chain_id=BSYNC_CHAIN_ID, genesis_time=Time(BSYNC_T0, 0), validators=[
        GenesisValidator(ed25519.PubKey(p).address(), ed25519.PubKey(p), BSYNC_POWER, "")
        for p in pubs])
    gen.validate_and_complete()
    node = bsync_node(gen)
    state, ex, mempool = node["state"], node["executor"], node["mempool"]
    last_commit = Commit(height=0, round=0)
    responses, states, blocks, parts_count = [], [], [], []
    for h in range(1, n_heights + 1):
        for i in range(n_txs):
            mempool.check_tx(bsync_tx(h, i))
        block = ex.create_proposal_block(h, state, last_commit,
                                         state.validators.get_proposer().address)
        check(len(block.data.txs) == n_txs, f"height {h}: the proposer reaped "
              f"{len(block.data.txs)} of {n_txs} transactions")
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        unsigned = Commit(height=h, round=0, block_id=bid, signatures=[
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, block.header.time.add_nanos(
                10**9 + 977 * i), b"") for i, v in enumerate(state.validators.validators)])
        msgs = unsigned.vote_sign_bytes_all(BSYNC_CHAIN_ID)
        jobs = [("ed25519", *secret[cs.validator_address], m)
                for cs, m in zip(unsigned.signatures, msgs)]
        chunks = [jobs[i : i + BSYNC_SIGN_CHUNK] for i in range(0, len(jobs), BSYNC_SIGN_CHUNK)]
        sigs = [s for chunk in pool.map(sign_jobs, chunks, chunksize=1) for s in chunk]
        commit = Commit(height=h, round=0, block_id=bid, signatures=[
            CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, sig)
            for cs, sig in zip(unsigned.signatures, sigs)])
        node["block_store"].save_block(block, parts, commit)
        state, _ = ex.apply_block(state, bid, block)
        responses.append(br.encode_block_response(block))
        blocks.append(block.encode())
        states.append(state_store._encode_state(state))
        parts_count.append(parts.total)
        last_commit = commit
    return {"gen": gen, "responses": responses, "states": states, "blocks": blocks,
            "parts": parts_count, "n_vals": len(pubs), "node": node, "state": state}


def bsync_flipped(source, height: int) -> bytes:
    """The source's block at height as a block_response whose LastCommit's
    first signature has one bit flipped (the header left as it was)."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.types.block import Block, Commit, CommitSig

    block = Block.decode(source["blocks"][height - 1])
    sigs = list(block.last_commit.signatures)
    cs = sigs[0]
    sigs[0] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                        bytes([cs.signature[0] ^ 0x01]) + cs.signature[1:])
    block.last_commit = Commit(height=block.last_commit.height, round=block.last_commit.round,
                               block_id=block.last_commit.block_id, signatures=sigs)
    return br.encode_block_response(block)


class BsyncRecorder:
    """A backend that records the size of each batch it is asked to verify
    and which check asked (``BsyncStages.check``): the window, the light
    check or validate_block's full check."""

    def __init__(self, inner, stages=None):
        self.inner = inner
        self.stages = stages
        self.calls: list = []

    def batch_verify(self, pubs, msgs, sigs):
        who = self.stages.check if self.stages is not None else None
        self.calls.append((who, len(pubs)))
        return self.inner.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


class BsyncStages:
    """Wraps the sync loop's stages with timers, each stage ended by a
    synchronize: a block_response's decode (in ``receive``), then per applied height
    ``make_part_set`` (with the proofs path it took), the window
    (``_prefetch_verify_window``, its sign bytes, ``bv.add`` and the backend
    call), ``verify_commit_light``, ``validate_block`` (twice a height: the
    reactor's, then ``apply_block``'s) with its set hashes and its
    ``verify_commit``, ``save_block`` and ``apply_block``. It also counts the
    lanes each check sends (through a BsyncRecorder). Installed on the
    port's classes for one run (``with``)."""

    def __init__(self):
        self.decode: list = []
        self.heights: list = []
        self.check = None
        self.lanes: list = []  # (height index, check, lanes) of each backend call
        self._cur = None
        self._saved = []

    def _wrap(self, owner, name, stage, check=None):
        orig = getattr(owner, name)
        timer = self

        def wrapper(*args, **kwargs):
            prev = timer.check
            if check is not None:
                timer.check = check
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                timer.check = prev
                timer.add(stage, ms)
                if stage == "make_part_set" and timer._cur is not None:
                    from cometbft_tpu_torch.crypto import merkle

                    timer._cur["proofs_path"] = merkle.last_proofs_path

        self._saved.append((owner, name, orig))
        setattr(owner, name, wrapper)

    def add(self, stage, ms):
        if self._cur is not None:
            self._cur.setdefault(stage, []).append(ms)

    def __enter__(self):
        from cometbft_tpu_torch.blocksync import reactor as br
        from cometbft_tpu_torch.state import BlockExecutor
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types import ValidatorSet
        from cometbft_tpu_torch.types.block import Block

        timer = self
        orig_try = br.BlocksyncReactor._try_sync_one

        def try_sync_one(reactor):
            timer._cur = {}
            ok = orig_try(reactor)
            if ok:
                timer.heights.append(timer._cur)
            timer._cur = None
            return ok

        self._saved.append((br.BlocksyncReactor, "_try_sync_one", orig_try))
        br.BlocksyncReactor._try_sync_one = try_sync_one
        orig_decode = br.decode_message

        def decode_message(data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig_decode(data)
            torch.cuda.synchronize()
            if out[0] == "block_response":
                timer.decode.append((time.perf_counter() - t0) * 1e3)
            return out

        self._saved.append((br, "decode_message", orig_decode))
        br.decode_message = decode_message
        self._wrap(Block, "make_part_set", "make_part_set")
        self._wrap(br.BlocksyncReactor, "_prefetch_verify_window", "window", "window")
        self._wrap(ValidatorSet, "verify_commit_light", "verify_commit_light", "light")
        self._wrap(BlockExecutor, "validate_block", "validate_block")
        self._wrap(ValidatorSet, "hash", "validator_set_hash")
        self._wrap(ValidatorSet, "verify_commit", "verify_commit", "full")
        self._wrap(BlockStore, "save_block", "save_block")
        self._wrap(BlockExecutor, "apply_block", "apply_block")
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def bsync_run(source, backend, pipeline: bool, corrupt=None) -> dict:
    """Sync a fresh node from two peer doubles serving the source (``p1``
    with ``corrupt``'s blocks in place of the source's), through the port's
    BlocksyncReactor under ``set_backend(backend)``, driven on this thread:
    make the requests, try sync steps until none applies, until caught up.
    Returns the wall time over the applied heights, the heights, the stops,
    the reactor's counters and the node."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.sidecar import backend as be

    node = bsync_node(source["gen"])
    peers = [BsyncPeer("p1", source["responses"], corrupt), BsyncPeer("p2", source["responses"])]
    applied = []
    with environ(CMTPU_BLOCKSYNC_PIPELINE="1" if pipeline else "0"):
        reactor = br.BlocksyncReactor(state=node["state"], block_exec=node["executor"],
                                      block_store=node["block_store"], block_sync=True)
    switch = BsyncSwitch(reactor)
    reactor.set_switch(switch)
    be.set_backend(backend)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in peers:
            p.reactor = reactor
            switch.peers[p.id] = p
            reactor.add_peer(p)
        while True:
            reactor.pool.make_requests()
            progressed = False
            while True:
                h = reactor.pool.height
                if not reactor._try_sync_one():
                    break
                applied.append(h)
                progressed = True
            if reactor.pool.is_caught_up() or not progressed:
                break
        reactor._pipeline_wait()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    return {"wall_ms": wall, "ms_per_block": wall / max(1, len(applied)), "applied": applied,
            "stops": list(switch.stops), "prefetch_errors": reactor.prefetch_errors,
            "sync_errors": reactor.sync_errors, "last_sync_error": repr(reactor.last_sync_error),
            "last_prefetch_error": repr(reactor.last_prefetch_error),
            "pipeline_overlap_ms": reactor.pipeline_overlap_ms, "node": node,
            "state": reactor.state}


def bsync_same_chain(source, run, upto: int) -> None:
    """The synced node's state is the source's after height upto, and its
    stored blocks, metas and commits are the source's bytes."""
    from cometbft_tpu_torch.state import store as state_store
    from cometbft_tpu_torch.types.block import Block

    check(run["applied"] == list(range(1, upto + 1)), f"applied heights {run['applied']}")
    check(state_store._encode_state(run["state"]) == source["states"][upto - 1],
          f"the synced state differs from the source's at height {upto}")
    stored = run["node"]["state_store"]._db.get(b"stateKey")
    check(stored == source["states"][upto - 1], "the synced node's stored state differs")
    bs = run["node"]["block_store"]
    for h in range(1, upto + 1):
        check(bs.load_block(h).encode() == source["blocks"][h - 1],
              f"stored block {h} differs from the source's")
        check(bs.load_block_meta(h).block_id.hash == Block.decode(source["blocks"][h - 1]).hash(),
              f"stored meta {h} differs")


def bsync_gates(source, torch_backend, stages: BsyncStages) -> dict:
    """The counted run of one chain: pipeline off (the batches are then
    deterministic), under a BsyncRecorder around ``TorchBackend()``, stages
    timed. Gates: the chain synced whole; the window's batches are the
    window arithmetic (PREFETCH_MAX_SIGS // n blocks a window, a window
    covers one block fewer than it holds: at 10,240 validators two commits,
    20,480 lanes, at heights 1 and 3, and none at 5 where two blocks are left;
    at 150 one window of 31 commits, 4,650 lanes); the checks after a window
    send nothing (the verified-triple cache), but the last height's light
    check, which no window covered (2/3 of the set + 1 lanes); no error."""
    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor

    n, heights = source["n_vals"], len(source["blocks"])
    recorder = BsyncRecorder(torch_backend, stages)
    with stages:
        run = bsync_run(source, recorder, pipeline=False)
    bsync_same_chain(source, run, heights - 1)
    check((run["prefetch_errors"], run["sync_errors"], run["stops"]) == (0, 0, []),
          f"errors in a clean sync: {run['prefetch_errors']}, {run['sync_errors']}, "
          f"{run['stops']}, {run['last_prefetch_error']}, {run['last_sync_error']}")
    # The window arithmetic, height by height as the reactor goes.
    wb = min(BlocksyncReactor.PREFETCH_WINDOW, BlocksyncReactor.PREFETCH_MAX_SIGS // n)
    light_n = n * 2 // 3 + 1
    want_windows, covered, sent = [], set(), {}
    want_later = {"light": [], "full": []}
    prefetched_to = 0
    for h in range(1, heights):
        if h >= prefetched_to and heights - h + 1 >= 3:  # a window needs 3 blocks
            k = min(wb, heights - h + 1) - 1
            want_windows.append(k * n)
            covered.update(range(h, h + k))
            prefetched_to = h + k
        if h not in covered:  # the light check of commit h, second.LastCommit
            want_later["light"].append(light_n)
            sent[h] = light_n
        if h >= 2 and h - 1 not in covered and sent.get(h - 1, 0) < n:
            want_later["full"].append(n - sent.get(h - 1, 0))  # commit h - 1, once
            sent[h - 1] = n
    windows = [k for who, k in recorder.calls if who == "window"]
    later = {who: [k for w, k in recorder.calls if w == who] for who in ("light", "full")}
    check(windows == want_windows, f"window batches {windows}, expected {want_windows}")
    check(later == want_later, f"the checks after the windows sent {later}; the window "
          f"arithmetic leaves {want_later}")
    checks = sum(len(h.get("verify_commit_light", [])) + len(h.get("verify_commit", []))
                 for h in stages.heights)
    paths = [h.get("proofs_path") for h in stages.heights]
    want_paths = ["device" if p >= 32 else "pure-python" for p in source["parts"][:-1]]
    check(paths == want_paths, f"proofs paths {paths}, expected {want_paths}")
    return {"run": run, "calls": recorder.calls, "windows": windows, "later_lanes": later,
            "lanes_sent": sum(k for _, k in recorder.calls), "checks": checks,
            "checks_answered_by_the_cache": checks - sum(len(v) for v in later.values()),
            "proofs_paths": paths}


def bsync_stage_table(stages: BsyncStages) -> dict:
    """Per applied height: ms by stage (summed where a stage ran more than
    once a height, with its count), and the medians over the heights."""
    rows = [{k: sum(v) for k, v in h.items() if k != "proofs_path"} for h in stages.heights]
    counts = [{k: len(v) for k, v in h.items() if k != "proofs_path"} for h in stages.heights]
    keys = sorted({k for r in rows for k in r})
    med = {k: statistics.median(r.get(k, 0.0) for r in rows) for k in keys}
    return {"per_height_ms": rows, "counts": counts, "median_ms": med,
            "proofs_paths": [h.get("proofs_path") for h in stages.heights],
            "decode_ms": stages.decode, "decode_median_ms": statistics.median(stages.decode)}


def bsync_window_triples(source, heights):
    """(pubs, msgs, sigs) of the source's commits at the given heights, each
    as the next block's LastCommit carries it."""
    from cometbft_tpu_torch.state import make_genesis_state
    from cometbft_tpu_torch.types.block import Block

    vals = make_genesis_state(source["gen"]).validators.validators
    pubs, msgs, sigs = [], [], []
    for h in heights:
        commit = Block.decode(source["blocks"][h]).last_commit
        for v, cs, m in zip(vals, commit.signatures, commit.vote_sign_bytes_all(BSYNC_CHAIN_ID)):
            pubs.append(v.pub_key.bytes())
            msgs.append(bytes(m))
            sigs.append(cs.signature)
    return pubs, msgs, sigs


def bsync_batches(big, small) -> dict:
    """The batch shapes the blocksync path gives the verify kernels: the
    10,240-validator window (commits 1-2, 20,480 lanes in the 32,768
    bucket), one commit, the light check no window covers (2/3 of the set +
    1 lanes), the 150-validator window (commits 1-31, 4,650 lanes) and its
    light check. Each batch has four lanes corrupted (``corrupt_four``).
    Returns label -> (pubs, msgs, sigs, the corrupted lanes)."""

    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor as R

    def first_window(source):  # commits 1..k, as bsync_gates's arithmetic gives
        wb = min(R.PREFETCH_WINDOW, R.PREFETCH_MAX_SIGS // source["n_vals"])
        return bsync_window_triples(source, range(1, min(wb, len(source["blocks"]))))

    w10k, w150 = first_window(big), first_window(small)
    out = {}
    for src, n in ((w10k, len(w10k[0])), (w10k, big["n_vals"]),
                   (w10k, big["n_vals"] * 2 // 3 + 1), (w150, len(w150[0])),
                   (w150, small["n_vals"] * 2 // 3 + 1)):
        out[str(n)] = corrupt_four(*(x[:n] for x in src))
    return out


def corrupt_four(pubs, msgs, sigs):
    """Copies of a batch with four lanes corrupted: a flipped bit in R, in
    the message, in S and in A, at the first, a third, a half and the last
    lane. Returns (pubs, msgs, sigs, the corrupted lanes)."""

    def flip(b: bytes, at: int) -> bytes:
        return b[:at] + bytes([b[at] ^ 0x01]) + b[at + 1:]

    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    n = len(pubs)
    bad = (0, n // 3, n // 2, n - 1)
    sigs[bad[0]] = flip(sigs[bad[0]], 0)
    msgs[bad[1]] = flip(msgs[bad[1]], len(msgs[bad[1]]) - 1)
    sigs[bad[2]] = flip(sigs[bad[2]], 33)
    pubs[bad[3]] = flip(pubs[bad[3]], 0)
    return pubs, msgs, sigs, set(bad)


def bsync_compare_kernels(batches, dev) -> dict:
    """Each verify kernel against its plain version on the same device
    operands at each blocksync batch (``bsync_batches``, padded by
    ``pack_batch`` to its bucket): challenge_digits, decompress_words (the
    points through point_freeze, and ok) and verify_lanes (the verdicts and
    the accumulator). Requires max_abs_err 0 for each, and the kernel's
    verdicts false at exactly the corrupted lanes. Returns label -> {bucket,
    lanes, corrupted, max_abs_err by kernel} and the device operands."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import sha512_kernel as s5

    out, operands = {}, {}
    for label, (pubs, msgs, sigs, bad) in batches.items():
        n = len(pubs)
        packed, host_ok = ek.pack_batch(pubs, msgs, sigs)
        a_w, r_w, s_w, msg_w, msg_nb = ek.operands_to_device(packed, dev)
        s_dig, k_dig = s5.challenge_digits(msg_w, msg_nb, s_w)
        err_sha = max_abs_err(torch.stack([s_dig, k_dig]),
                              torch.stack(s5.challenge_digits_plain(msg_w, msg_nb, s_w)))
        pt, ok = ed.decompress_words(a_w, r_w)
        pt_p, ok_p = ed.decompress_words_plain(a_w, r_w)
        err_dec = max(max_abs_err(torch.stack(ed.point_freeze(pt)),
                                  torch.stack(ed.point_freeze(pt_p))), max_abs_err(ok, ok_p))
        got, acc = ladder.verify_lanes(s_dig, k_dig, pt, ok, with_acc=True)
        want, acc_p = ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)
        err_lad = max(max_abs_err(got, want), max_abs_err(torch.stack(ed.point_freeze(acc)),
                                                          torch.stack(ed.point_freeze(acc_p))))
        errs = {"sha512": err_sha, "decompress": err_dec, "ladder": err_lad}
        check(all(e == 0 for e in errs.values()),
              f"blocksync batch of {n}: a kernel != plain (max abs err {errs})")
        verdicts = (got.cpu().numpy() & host_ok)[:n]
        rejected = set(np.nonzero(~verdicts)[0].tolist())
        check(rejected == bad, f"blocksync batch of {n}: rejected lanes {sorted(rejected)[:8]}, "
              f"corrupted {sorted(bad)}")
        out[label] = {"lanes": n, "bucket": int(a_w.shape[1]), "corrupted": sorted(bad),
                      "max_abs_err": errs}
        operands[label] = (msg_w, msg_nb, s_w, a_w, r_w, s_dig, k_dig, pt, ok)
    return out, operands


def bsync_window_kernels(batches, dev) -> dict:
    """The verify kernels at the blocksync path's batches: each held against
    its plain version (``bsync_compare_kernels``), then timed by CUDA events
    (20 back-to-back launches each, the batches in turns, median of 3)."""
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import sha512_kernel as s5

    out, operands = bsync_compare_kernels(batches, dev)
    fns = {}
    for label, (msg_w, msg_nb, s_w, a_w, r_w, s_dig, k_dig, pt, ok) in operands.items():
        fns[label] = {
            "sha512": lambda m=msg_w, b=msg_nb, sw=s_w: s5.challenge_digits(m, b, sw),
            "decompress": lambda a=a_w, r=r_w: ed.decompress_words(a, r),
            "ladder": lambda sd=s_dig, kd=k_dig, p=pt, o=ok: ladder.verify_lanes(sd, kd, p, o),
        }
        out[label]["ms"] = {k: [] for k in fns[label]}
    for _ in range(3):
        for label, fn in fns.items():
            for k, f in fn.items():
                out[label]["ms"][k].append(time_cuda(f, 20))
    for rec in out.values():
        rec["ms"] = {k: statistics.median(v) for k, v in rec["ms"].items()}
    return out


def bsync_sources(fixtures, torch_backend) -> dict:
    """The blocksync phase's two source chains (``bsync_source``), the
    10,240-validator one of BSYNC_HEIGHTS and the BSYNC_SMALL-validator one
    of BSYNC_SMALL_HEIGHTS, their validators signing in a pool of
    SIGN_PROCESSES processes; the light phase goes on with them."""
    import multiprocessing

    from cometbft_tpu_torch.sidecar import backend as be

    _, seeds, pubs, *_ = fixtures
    t0 = time.perf_counter()
    be.set_backend(torch_backend)  # the source verifies each LastCommit it applies
    try:
        with multiprocessing.get_context("spawn").Pool(SIGN_PROCESSES) as pool:
            big = bsync_source(seeds, pubs, BSYNC_HEIGHTS, BSYNC_TXS, pool)
            small = bsync_source(seeds[:BSYNC_SMALL], pubs[:BSYNC_SMALL], BSYNC_SMALL_HEIGHTS,
                                 BSYNC_TXS, pool)
    finally:
        be.set_backend(None)
    fixtures_s = time.perf_counter() - t0
    print(f"blocksync fixtures: {len(pubs)} validators x {BSYNC_HEIGHTS} heights and "
          f"{BSYNC_SMALL} x {BSYNC_SMALL_HEIGHTS}, {BSYNC_TXS} transactions of {BSYNC_TX_BYTES} B a "
          f"block, blocks of {len(big['blocks'][-1])} / {len(small['blocks'][-1])} bytes in "
          f"{big['parts'][-1]} / {small['parts'][-1]} parts, built in {fixtures_s:.1f} s",
          flush=True)
    return {"10k": big, "150": small, "fixtures_s": fixtures_s}


def drive_blocksync_path(sources, torch_backend, dev) -> dict:
    """The blocksync phase (module docstring, step 16) over the sources of
    ``bsync_sources``: returns its launches, gates, stage splits, timings
    and the window's kernel times."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    fallbacks = ed25519.scalar_fallbacks
    big, small, fixtures_s = sources["10k"], sources["150"], sources["fixtures_s"]

    # The counted runs: launch counts zeroed, pipeline off, the part sets'
    # proofs on the card (CMTPU_DEVICE_PROOFS=1: the sha256 levels entry).
    ed25519._verified.clear()
    _build.reset_launches()
    gates = {}
    with environ(CMTPU_DEVICE_PROOFS="1"):
        for name, source in (("10k", big), ("150", small)):
            ed25519._verified.clear()
            stages = BsyncStages()
            gates[name] = bsync_gates(source, torch_backend, stages)
            gates[name]["stages"] = bsync_stage_table(stages)
    device_parts = sum(1 for p in big["parts"][:-1] if p >= 32) + sum(
        1 for p in small["parts"][:-1] if p >= 32)
    # One sha512 / decompress / ladder set a backend call, two sha256 launches
    # a part set of 32 parts or more.
    launches = expect_launches(sum(len(g["calls"]) for g in gates.values()), device_parts, 0)

    # The bad peer: p1 serves the 150-validator chain with one flipped
    # signature bit in the LastCommit of the block at BSYNC_BAD_HEIGHT; p2 the
    # honest chain.
    ed25519._verified.clear()
    bad = bsync_run(small, torch_backend, pipeline=True,
                    corrupt={BSYNC_BAD_HEIGHT: bsync_flipped(small, BSYNC_BAD_HEIGHT)})
    bsync_same_chain(small, bad, BSYNC_SMALL_HEIGHTS - 1)
    check(bad["stops"] == ["p1"], f"stopped peers {bad['stops']}, expected p1 once")
    check((bad["prefetch_errors"], bad["sync_errors"]) == (0, 1),
          f"bad peer: prefetch_errors {bad['prefetch_errors']}, sync_errors {bad['sync_errors']}")
    check("wrong signature (#0)" in bad["last_sync_error"], f"bad peer: {bad['last_sync_error']}")

    # Timed: the default (pipeline on, the native proofs pass), in turns
    # under TorchBackend() and the process default, BSYNC_REPS rounds; and
    # the pipeline off under TorchBackend() in each round (the counted runs
    # above are pipeline off too, but staged and with the card's proofs:
    # kept apart as torch_pipeline_off_staged).
    with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                 CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
        auto = be._make_backend()
    runs = {name: {"torch": [], "auto": [], "torch_pipeline_off": []} for name in ("10k", "150")}
    for name in runs:
        runs[name]["torch_pipeline_off_staged"] = [gates[name]["run"]["ms_per_block"]]
    overlap = {name: [] for name in runs}

    def timed(name, source, backend, pipeline):
        ed25519._verified.clear()
        r = bsync_run(source, backend, pipeline=pipeline)
        bsync_same_chain(source, r, len(source["blocks"]) - 1)
        check((r["prefetch_errors"], r["sync_errors"], r["stops"]) == (0, 0, []),
              f"{name}: errors {r['last_prefetch_error']} {r['last_sync_error']} {r['stops']}")
        return r

    try:
        for rep in range(BSYNC_REPS):
            tiers = [("torch", torch_backend), ("auto", auto)]
            for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
                for name, source in (("10k", big), ("150", small)):
                    r = timed(name, source, backend, True)
                    runs[name][tier].append(r["ms_per_block"])
                    if tier == "torch":
                        overlap[name].append(r["pipeline_overlap_ms"])
            for name, source in (("10k", big), ("150", small)):
                runs[name]["torch_pipeline_off"].append(
                    timed(name, source, torch_backend, False)["ms_per_block"])
    finally:
        auto.close()
    check(ed25519.scalar_fallbacks == fallbacks, "a verification took the ChainExhausted fallback")

    # The verify kernels at the batches the path gave them (both windows,
    # one commit, both light checks), each held against its plain version
    # with corrupted lanes, then timed in turns.
    window_kernels = bsync_window_kernels(bsync_batches(big, small), dev)
    return {
        "fixtures_s": fixtures_s, "launches": launches,
        "blocks_bytes": {"10k": len(big["blocks"][-1]), "150": len(small["blocks"][-1])},
        "parts": {"10k": big["parts"], "150": small["parts"]},
        "gates": {name: {k: v for k, v in g.items() if k not in ("run", "stages")}
                  for name, g in gates.items()},
        "stages": {name: g["stages"] for name, g in gates.items()},
        "bad_peer": {k: v for k, v in bad.items() if k not in ("node", "state")},
        "ms_per_block_runs": runs,
        "ms_per_block": {name: {tier: statistics.median(v) for tier, v in r.items() if v}
                         for name, r in runs.items()},
        "pipeline_overlap_ms": overlap,
        "window_kernels": window_kernels,
    }


# -- the light path ---------------------------------------------------------------

LIGHT_CHAIN_ID = "chip-smoke-light"
LIGHT_T0 = 1_700_000_000
LIGHT_POWER = 10
# The 10,240-validator chain: height 1's set is the commit phase's keys; each
# next height drops the first LIGHT_ROTATE of the set's keys (20%) and takes
# as many fresh ones. A client trusting height 1 verifies height 9 with trust
# level 1/3: over 1/3 of a set survives two heights, not four, so the walk is
# 1 -> 9 and 1 -> 5 refused, 1 -> 3, 3 -> 5, 5 -> 9 refused, 5 -> 7, 7 -> 9
# (light_walk), and only heights 1, 3, 5, 7 and 9 need signed commits.
LIGHT_HEIGHTS = 9
LIGHT_ROTATE = 2_048
LIGHT_SIGNED = (1, 3, 5, 7, 9)
# The 150-validator chain (a typical set, as blocksync's): 15 keys (10%)
# rotate a height over 100 heights, every height signed.
LIGHT_SMALL = COMMIT_SMALL
LIGHT_SMALL_HEIGHTS = 100
LIGHT_SMALL_ROTATE = 15
LIGHT_SEQ_TO = 20  # a sequential client verifies 1 -> 20
LIGHT_BACK = (50, 40)  # a client trusting height 50 verifies height 40 backwards
LIGHT_SWARM = 64  # clients at once through one gateway: the default CMTPU_LIGHTGW_SESSIONS
LIGHT_REPS = 3
LIGHT_NOW_S = LIGHT_T0 + 3_600
LIGHT_DUP_HEIGHT = 10  # the duplicate votes' height on the 150-validator blocksync chain
LIGHT_SIGN_CHUNK = 512


class LightWire:
    """A provider of light blocks from their wire bytes, as a node's RPC
    hands them over: each fetch decodes a fresh LightBlock (timed as the
    stage ``fetch_decode`` when ``stages`` is given), and the fetched heights
    are kept. A height it does not hold raises ErrLightBlockNotFound. Its
    ``header_hash`` and ``base_height`` are a node's block store's, for a
    gateway over it."""

    def __init__(self, chain_id: str, encoded: dict, stages=None):
        self._chain_id = chain_id
        self.encoded = encoded
        self.stages = stages
        self.fetched: list[int] = []
        self.evidences: list = []

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int):
        from cometbft_tpu_torch.light.provider import ErrLightBlockNotFound
        from cometbft_tpu_torch.types import LightBlock

        h = height or max(self.encoded)
        self.fetched.append(h)
        raw = self.encoded.get(h)
        if raw is None:
            raise ErrLightBlockNotFound(f"no light block at height {h}")
        if self.stages is None:
            return LightBlock.decode(raw)
        with self.stages.stage("fetch_decode"):
            return LightBlock.decode(raw)

    def report_evidence(self, ev) -> None:
        self.evidences.append(ev)

    def base_height(self) -> int:
        return min(self.encoded)

    def header_hash(self, height: int) -> bytes | None:
        """The header's hash from its bytes alone, as a node's block store
        gives it (``BlockStoreProvider.header_hash``): the MMR's catch-up
        decodes no commit and no validator set."""
        from cometbft_tpu_torch.types import Header
        from cometbft_tpu_torch.wire import proto as wire

        raw = self.encoded.get(height)
        if raw is None:
            return None
        signed_header = wire.get_bytes(wire.decode_fields(raw), 1)
        return Header.decode(wire.get_bytes(wire.decode_fields(signed_header), 1)).hash()


class LightRecorder:
    """A backend that records each call it is asked to verify: the caller's
    engine class (``light``: a descent's or the gateway's prewarm), its
    lanes and wall ms (ended by a synchronize); with ``keep``, its triples
    too (the kernel comparisons run on them). Everything else goes to the
    backend it wraps."""

    def __init__(self, inner, keep: bool = False):
        self.inner = inner
        self.keep = keep
        self.calls: list = []
        self.triples: list = []

    def batch_verify(self, pubs, msgs, sigs):
        from cometbft_tpu_torch.sidecar import engine

        klass = engine.CLASS_NAMES[engine.current_class()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.batch_verify(pubs, msgs, sigs)
        torch.cuda.synchronize()
        self.calls.append({"class": klass, "lanes": len(pubs),
                           "ms": (time.perf_counter() - t0) * 1e3})
        if self.keep:
            self.triples.append((list(pubs), list(msgs), list(sigs)))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def lanes(self, klass=None) -> list:
        return [c["lanes"] for c in self.calls if klass is None or c["class"] == klass]


class LightStages:
    """Times a light sync's stages, each ended by a synchronize: the
    provider's fetch and decode (LightWire), ``LightBlock.validate_basic``,
    ``ValidatorSet.hash``, the descent's prewarm (``_speculate_descent``) and
    inside it ``speculative_verify_triples`` and the backend call
    (``BatchVerifier.verify`` of light class; ``bv.add`` is the rest), each
    hop's trusting and light checks on the cache (with ``BatchVerifier.verify``
    outside a prewarm: the cache filter), the store's save and the
    detector. Stages nest as the calls do. Installed on the port's classes
    for one run (``with``)."""

    def __init__(self):
        self.ms = collections.defaultdict(list)
        self._saved = []

    @contextlib.contextmanager
    def stage(self, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def _wrap(self, owner, attr, name):
        orig = getattr(owner, attr)
        stages = self

        def wrapper(*args, **kwargs):
            label = name(*args) if callable(name) else name
            with stages.stage(label):
                return orig(*args, **kwargs)

        self._saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper)

    def __enter__(self):
        from cometbft_tpu_torch.crypto import ed25519
        from cometbft_tpu_torch.light import client, detector
        from cometbft_tpu_torch.light.store import LightStore
        from cometbft_tpu_torch.sidecar import engine
        from cometbft_tpu_torch.types import LightBlock, ValidatorSet, validation

        self._wrap(LightBlock, "validate_basic", "validate_basic")
        self._wrap(ValidatorSet, "hash", "validator_set_hash")
        self._wrap(client.Client, "_speculate_descent", "prewarm")
        self._wrap(validation, "speculative_verify_triples", "prewarm_triples")
        self._wrap(ed25519.BatchVerifier, "verify", lambda bv: (
            "prewarm_backend" if engine.current_class() == engine.CLASS_LIGHT
            else "hop_cache_filter"))
        self._wrap(validation, "verify_commit_light_trusting", "hop_trusting_check")
        self._wrap(validation, "verify_commit_light", "hop_light_check")
        self._wrap(LightStore, "save_light_block", "store_save")
        self._wrap(detector, "detect_divergence", "detector")
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    def table(self) -> dict:
        out = {k: {"ms": sum(v), "calls": len(v)} for k, v in sorted(self.ms.items())}
        pre = out.get("prewarm", {}).get("ms", 0.0)
        out["prewarm_bv_add"] = {"ms": pre - out.get("prewarm_triples", {}).get("ms", 0.0)
                                 - out.get("prewarm_backend", {}).get("ms", 0.0),
                                 "calls": out.get("prewarm", {}).get("calls", 0)}
        return out


def light_keys(seeds, pubs, pool) -> dict:
    """Each light chain's keys by height, (seed, pub) pairs: height 1's are
    the first n of the commit phase's; each next height drops the first
    `rotate` and appends `rotate` fresh keys (seeds from fixed tags, public
    keys derived in the pool)."""
    plans = {"10k": (N_SIGS, LIGHT_ROTATE, LIGHT_HEIGHTS),
             "150": (LIGHT_SMALL, LIGHT_SMALL_ROTATE, LIGHT_SMALL_HEIGHTS)}
    fresh = {name: [hashlib.sha256(b"chip-smoke-light-%s-%d-%d" % (name.encode(), SEED, i)).digest()
                    for i in range(rot * (heights - 1))]
             for name, (_, rot, heights) in plans.items()}
    every = [s for name in plans for s in fresh[name]]
    chunks = [[("pub", s) for s in every[i : i + LIGHT_SIGN_CHUNK]]
              for i in range(0, len(every), LIGHT_SIGN_CHUNK)]
    derived = dict(zip(every, (p for c in pool.map(sign_jobs, chunks, chunksize=1) for p in c)))
    out = {}
    for name, (n, rot, heights) in plans.items():
        keys = [list(zip(seeds[:n], pubs[:n]))]
        for h in range(1, heights):
            new = fresh[name][(h - 1) * rot : h * rot]
            keys.append(keys[-1][rot:] + [(s, derived[s]) for s in new])
        out[name] = keys
    return out


def light_headers(key_lists):
    """A light chain's validator sets and headers: height h's set is
    key_lists[h - 1] at equal power; its header names the next height's
    set (the last height its own) and the previous header's BlockID."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.types import BlockID, Consensus, Header, PartSetHeader, Time, Validator
    from cometbft_tpu_torch.types import ValidatorSet

    sets = [ValidatorSet([Validator.new(ed25519.PubKey(p), LIGHT_POWER) for _, p in keys])
            for keys in key_lists]
    headers, last = [], BlockID()
    for h, vset in enumerate(sets, 1):
        nxt = sets[h] if h < len(sets) else vset
        header = Header(version=Consensus(11, 1), chain_id=LIGHT_CHAIN_ID, height=h,
                        time=Time(LIGHT_T0 + 6 * h, 0), last_block_id=last,
                        validators_hash=vset.hash(), next_validators_hash=nxt.hash(),
                        app_hash=hashlib.sha256(b"light-app-%d" % h).digest(),
                        proposer_address=vset.get_proposer().address)
        headers.append(header)
        last = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
    return sets, headers


def light_unsigned(header, vset, bid=None):
    """The commit of header (under ``bid``, by default one naming a single
    part) that every validator of vset signs (canonical precommits, seconds
    equal, nanos differing), signatures empty."""
    from cometbft_tpu_torch.types import (BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig,
                                          PartSetHeader, Time)

    if bid is None:
        bid = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
    return Commit(height=header.height, round=0, block_id=bid, signatures=[
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Time(header.time.seconds + 1, 1_000 + 977 * i),
                  b"") for i, v in enumerate(vset.validators)])


def sign_commits(plan, secret, pool) -> dict:
    """plan: (key, chain id, unsigned commit) entries; every commit's
    validators sign their canonical precommits in the pool. Returns key ->
    the signed Commit."""
    from cometbft_tpu_torch.types import Commit, CommitSig

    jobs, start = [], {}
    for key, chain_id, commit in plan:
        start[key] = len(jobs)
        jobs += [("ed25519", *secret[cs.validator_address], m)
                 for cs, m in zip(commit.signatures, commit.vote_sign_bytes_all(chain_id))]
    chunks = [jobs[i : i + LIGHT_SIGN_CHUNK] for i in range(0, len(jobs), LIGHT_SIGN_CHUNK)]
    sigs = [s for c in pool.map(sign_jobs, chunks, chunksize=1) for s in c]
    out = {}
    for key, _, commit in plan:
        k = start[key]
        out[key] = Commit(height=commit.height, round=commit.round, block_id=commit.block_id,
                          signatures=[CommitSig(cs.block_id_flag, cs.validator_address,
                                                cs.timestamp, sigs[k + i])
                                      for i, cs in enumerate(commit.signatures)])
    return out


def forged_tip(source, height: int):
    """The source's header at height with another app hash, and the commit
    its validators sign for it (unsigned): a light-client attack's
    conflicting block, before signing."""
    import dataclasses

    meta = source["node"]["block_store"].load_block_meta(height)
    vals = source["node"]["state_store"].load_validators(height)
    header = dataclasses.replace(meta.header, app_hash=b"\xee" * 32)
    return header, vals, light_unsigned(header, vals)


def light_fixtures(fixtures, sources, pool) -> dict:
    """The light phase's chains as wire bytes: the 10,240-validator chain's
    signed heights (LIGHT_SIGNED) and the 150-validator chain's 100, their
    validator sets; the conflicting tips of the two blocksync sources (the
    150-validator chain's last height for the attack, the 10,240-validator
    chain's for the evidence check) signed by the same validators."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.types import LightBlock, SignedHeader

    _, seeds, pubs, *_ = fixtures
    t0 = time.perf_counter()
    keys = light_keys(seeds, pubs, pool)
    keys_s = time.perf_counter() - t0
    secret = {ed25519.PubKey(p).address(): (s, p)
              for ks in keys.values() for hk in ks for s, p in hk}
    chains, plan = {}, []
    for name, signed in (("10k", LIGHT_SIGNED), ("150", range(1, LIGHT_SMALL_HEIGHTS + 1))):
        sets, headers = light_headers(keys[name])
        chains[name] = {"sets": sets, "headers": headers, "signed": tuple(signed)}
        plan += [((name, h), LIGHT_CHAIN_ID, light_unsigned(headers[h - 1], sets[h - 1]))
                 for h in signed]
    tips = {}
    for name, source in (("attack", sources["150"]), ("evidence", sources["10k"])):
        tip_h = len(source["blocks"])
        header, vals, unsigned = forged_tip(source, tip_h)
        tips[name] = (header, vals)
        plan.append(((name, tip_h), BSYNC_CHAIN_ID, unsigned))
    t1 = time.perf_counter()
    signed = sign_commits(plan, secret, pool)
    sign_s = time.perf_counter() - t1
    out = {"keys_s": keys_s, "sign_s": sign_s, "signatures": sum(
        len(c.signatures) for c in signed.values()), "secret": secret}
    for name, ch in chains.items():
        ch["encoded"] = {h: LightBlock(SignedHeader(ch["headers"][h - 1], signed[(name, h)]),
                                       ch["sets"][h - 1]).encode() for h in ch["signed"]}
        out[name] = ch
    for name, (header, vals) in tips.items():
        key = next(k for k in signed if k[0] == name)
        out[name] = LightBlock(SignedHeader(header, signed[key]), vals).encode()
    return out


def light_walk(sets, trusted: int, target: int) -> dict:
    """The skipping walk's arithmetic over equal-power sets (the client's
    _verify_skipping and _speculate_descent, by sets and counts): a
    non-adjacent hop is trusted when at least k_t = floor(total / 3) / power
    + 1 of the lower set signed the upper commit; its light check needs the
    first k = floor(2 total / 3) / power + 1 signatures in commit order and
    its trusting check the first k_t signers of the lower set; a refused hop
    fetches the midpoint and prewarms the optimistic chain's union, of which
    only what the cache lacks goes out. Returns the pivots fetched, the
    trace, the descents and the lanes of each backend call, in order, as
    (class, lanes)."""
    addr = [[v.address for v in s.validators] for s in sets]
    members = [set(a) for a in addr]

    def k_light(h):
        return (len(addr[h - 1]) * LIGHT_POWER * 2 // 3) // LIGHT_POWER + 1

    def k_trust(h):
        return (len(addr[h - 1]) * LIGHT_POWER // 3) // LIGHT_POWER + 1

    def signers_of(lower, upper):
        return [i for i, a in enumerate(addr[upper - 1]) if a in members[lower - 1]]

    def trusted_ok(lower, upper):
        return upper == lower + 1 or len(signers_of(lower, upper)) >= k_trust(lower)

    def light_part(upper):
        return {(upper, i) for i in range(k_light(upper))}

    def trust_part(lower, upper):
        return {(upper, i) for i in signers_of(lower, upper)[: k_trust(lower)]}

    def hop(lower, upper):
        if upper == lower + 1:
            return light_part(upper)
        return light_part(upper) | trust_part(lower, upper)

    cache, fetched, trace, calls, descents = set(), [], [], [], 0
    current, stack = trusted, [target]
    while stack:
        cand = stack[-1]
        if trusted_ok(current, cand):
            checks = [light_part(cand)] if cand == current + 1 else [
                trust_part(current, cand), light_part(cand)]
            for part in checks:
                if part - cache:
                    calls.append(("blocksync", len(part - cache)))
                cache |= part
            current = cand
            stack.pop()
            trace.append(cand)
            continue
        pivot = (current + cand) // 2
        check(pivot not in (current, cand), f"the walk cannot bisect {current} -> {cand}")
        fetched.append(pivot)
        stack.append(pivot)
        union, lower = set(), current
        for upper in reversed(stack):
            union |= hop(lower, upper)
            lower = upper
        if union:
            descents += 1
            if union - cache:
                calls.append(("light", len(union - cache)))
            cache |= union
    return {"fetched": fetched, "trace": trace, "descents": descents, "calls": calls}


def light_client(chain, provider, trust_height=1, witnesses=(), **kw):
    """The port's Client over ``provider``, trusting the chain's height
    ``trust_height``, a fresh MemDB store, the trusting period of the commit
    phase."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.types import LightBlock

    anchor = LightBlock.decode(chain["encoded"][trust_height])
    return Client(LIGHT_CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, trust_height, anchor.hash()),
                  provider, list(witnesses), LightStore(MemDB()), **kw)


def light_sync(chain, backend, target, trust_height=1, witness=False, stages=None, **kw):
    """One client's sync of ``chain`` to ``target`` under
    ``set_backend(backend)`` from an empty verified-triple cache, timed
    (the verify call alone, ended by a synchronize). Returns the client, its
    providers, the wall ms and the trace (stored heights and hashes)."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Time

    primary = LightWire(LIGHT_CHAIN_ID, chain["encoded"], stages)
    witnesses = [LightWire(LIGHT_CHAIN_ID, chain["encoded"], stages)] if witness else []
    be.set_backend(backend)
    try:
        client = light_client(chain, primary, trust_height, witnesses, **kw)
        ed25519._verified.clear()
        primary.fetched.clear()
        ctx = stages if stages is not None else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lb = client.verify_light_block_at_height(target, Time(LIGHT_NOW_S, 0))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    check(lb.height == target, f"synced to {lb.height}, not {target}")
    trace = [(h, client.store.light_block(h).hash().hex()) for h in client.store._heights()]
    return {"client": client, "primary": primary, "witnesses": witnesses, "ms": wall,
            "trace": trace}


def light_counts_clean(client, what: str) -> None:
    check(client.speculation["errors"] == 0 and client.detector_errors == 0,
          f"{what}: speculation errors {client.speculation['errors']} "
          f"({client.last_speculation_error!r}), detector errors {client.detector_errors} "
          f"({client.last_detector_error!r})")


def light_gates(lf, torch_backend) -> dict:
    """The counted clients under a LightRecorder around ``TorchBackend()``:
    the 10,240-validator sync with an honest witness, the 150-validator
    skipping, sequential and backwards clients. Each trace equals the host
    path's (the same client under ``CpuBackend()``, the native batch
    verifier) and the walk's arithmetic; each backend call is the
    arithmetic's, by class and lanes, so that every hop check after a
    prewarm sent no lane; no error counted."""
    from cometbft_tpu_torch.sidecar.backend import CpuBackend

    host = CpuBackend()
    out, recorders = {}, {}
    cases = {
        "10k": (lf["10k"], LIGHT_HEIGHTS, 1, True, {}),
        "150": (lf["150"], LIGHT_SMALL_HEIGHTS, 1, False, {}),
        "150_sequential": (lf["150"], LIGHT_SEQ_TO, 1, False, {"skip_verification": "sequential"}),
        "150_backwards": (lf["150"], LIGHT_BACK[1], LIGHT_BACK[0], False, {}),
    }
    for name, (chain, target, trust_h, witness, kw) in cases.items():
        rec = LightRecorder(torch_backend, keep=True)
        run = light_sync(chain, rec, target, trust_h, witness, **kw)
        on_host = light_sync(chain, host, target, trust_h, witness, **kw)
        check(run["trace"] == on_host["trace"], f"{name}: the card's trace differs from the host's")
        c = run["client"]
        light_counts_clean(c, name)
        got = [(k["class"], k["lanes"]) for k in rec.calls]
        if kw.get("skip_verification") == "sequential":
            want = {"fetched": [target] + list(range(trust_h + 1, target)),
                    "trace": list(range(trust_h + 1, target + 1)), "descents": 0,
                    "calls": [("blocksync", LIGHT_SMALL * 2 // 3 + 1)] * (target - trust_h)}
        elif target < trust_h:
            want = {"fetched": [target] + list(range(trust_h - 1, target, -1)),
                    "trace": [target], "descents": 0, "calls": []}
        else:
            want = light_walk(chain["sets"], trust_h, target)
            want["fetched"] = [target] + want["fetched"]
        stored = [h for h, _ in run["trace"]]
        check(stored == sorted({trust_h, *want["trace"]}),
              f"{name}: stored heights {stored}, the arithmetic gives {want['trace']}")
        check(run["primary"].fetched == want["fetched"],
              f"{name}: fetched {run['primary'].fetched}, the arithmetic gives {want['fetched']}")
        check(got == want["calls"], f"{name}: backend calls {got}, the arithmetic gives "
              f"{want['calls']}")
        check(c.speculation["descents"] == want["descents"],
              f"{name}: {c.speculation['descents']} descents, the arithmetic gives "
              f"{want['descents']}")
        first_prewarm = next((i for i, k in enumerate(got) if k[0] == "light"), len(got))
        check(all(k[0] == "light" for k in got[first_prewarm:]),
              f"{name}: a hop check sent lanes after the first prewarm: {got}")
        if witness:
            check(run["witnesses"][0].fetched == [target] and c.witnesses,
                  f"{name}: the witness was asked for {run['witnesses'][0].fetched}")
        recorders[name] = rec
        out[name] = {"trace_heights": stored, "fetched": run["primary"].fetched, "calls": got,
                     "speculation": dict(c.speculation), "ms": run["ms"], "host_ms": on_host["ms"]}
    check(lf["10k"]["signed"] == tuple(sorted({1, *out["10k"]["fetched"]})),
          f"the 10k client fetched {out['10k']['fetched']}, not exactly the signed heights")
    return out, recorders


def light_swarm(lf, torch_backend, proofs: bool) -> dict:
    """LIGHT_SWARM clients on threads cold-sync the 150-validator chain from
    height 1 to the tip at once through one LightGateway, each client over
    its own provider of the chain's wire bytes, under the port's
    CoalescingScheduler around a LightRecorder around ``TorchBackend()``,
    from an empty cache. Every kernel launch of the run is recorded with
    its thread. Returns the wall ms, the traces, the gateway's stats and
    the scheduler's counters."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.light.gateway import LightGateway
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler
    from cometbft_tpu_torch.types import Time

    chain = lf["150"]
    rec = LightRecorder(torch_backend)
    sched = CoalescingScheduler(rec)
    gw = LightGateway(LIGHT_CHAIN_ID, LightWire(LIGHT_CHAIN_ID, chain["encoded"]))
    clients = [light_client(chain, LightWire(LIGHT_CHAIN_ID, chain["encoded"]), 1, [],
                            gateway=gw, gateway_proofs=proofs) for _ in range(LIGHT_SWARM)]
    results = [None] * LIGHT_SWARM
    barrier = threading.Barrier(LIGHT_SWARM + 1)
    threads_seen = collections.Counter()
    orig_check = _build.check_launch

    def check_launch(kernel, rc):
        threads_seen[threading.current_thread().name] += 1
        return orig_check(kernel, rc)

    def sync(i):
        try:
            barrier.wait(timeout=60)
            lb = clients[i].verify_light_block_at_height(LIGHT_SMALL_HEIGHTS, Time(LIGHT_NOW_S, 0))
            results[i] = ("ok", lb.hash().hex())
        except Exception as e:  # noqa: BLE001 - reported by the gate below
            results[i] = ("error", repr(e))

    ed25519._verified.clear()
    be.set_backend(sched)
    _build.check_launch = check_launch
    threads = [threading.Thread(target=sync, args=(i,), name=f"light-{i}")
               for i in range(LIGHT_SWARM)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        _build.check_launch = orig_check
        be.set_backend(None)
        sched.close()
    check(all(r is not None and r[0] == "ok" for r in results),
          f"swarm: {[r for r in results if r is None or r[0] != 'ok'][:3]}")
    traces = {tuple((h, c.store.light_block(h).hash().hex()) for h in c.store._heights())
              for c in clients}
    for c in clients:
        light_counts_clean(c, "swarm")
    check(len(traces) == 1, f"swarm: {len(traces)} different traces")
    st = gw.stats()
    check(st["speculate_errors"] == 0 and gw.header_errors == 0,
          f"swarm: gateway prewarm errors {st['speculate_errors']} ({gw.last_speculate_error!r})")
    check(st["plan_misses"] == 1 and st["plan_hits"] + st["plan_waits"] == LIGHT_SWARM - 1,
          f"swarm: plans {st['plan_misses']} computed, {st['plan_hits']} hits, "
          f"{st['plan_waits']} waits")
    check(set(threads_seen) <= {"cmtpu-torch-dev"},
          f"swarm: kernels launched from {dict(threads_seen)}, not the one device-owner thread")
    stats = [dict(c.gateway_stats) for c in clients]
    want = ({"plan_syncs": 1, "proof_rejects": 1, "fallbacks": 0} if proofs
            else {"plan_syncs": 1, "proof_rejects": 0, "fallbacks": 0})
    check(all({k: s[k] for k in want} == want for s in stats),
          f"swarm: client stats {stats[0]}, expected {want}")
    return {"ms": wall, "trace": sorted(traces)[0], "gateway": st, "lanes": rec.lanes(),
            "lanes_total": sum(rec.lanes()), "scheduler": sched.counters(),
            "engine_classes": sched.engine.class_counters_, "client_stats": stats[0],
            "launch_threads": dict(threads_seen)}


def light_attack(sources, lf, torch_backend, signers) -> dict:
    """An attack, end to end, on the 150-validator blocksync source: a
    client trusting its height 1 through BlockStoreProvider (reporting to
    an EvidencePool over the source's stores) verifies the tip; a witness
    serves the source's chain but a conflicting tip signed by the same
    validators. Exactly one ErrLightClientAttack; the evidence is pending;
    the source's executor proposes the next height with it (its commit
    signed by the validators), saves and applies the block, and the pool
    marks the evidence committed; the stored block carries it."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.detector import ErrLightClientAttack
    from cometbft_tpu_torch.light.provider import BlockStoreProvider
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import BlockID, LightBlock
    from cometbft_tpu_torch.types.evidence import encode_evidence

    source = sources["150"]
    node, state = source["node"], source["state"]
    tip = len(source["blocks"])
    pool = EvidencePool(MemDB(), node["state_store"], node["block_store"])

    class Primary(BlockStoreProvider):
        def report_evidence(self, ev):
            pool.add_evidence(ev)

    primary = Primary(BSYNC_CHAIN_ID, node["block_store"], node["state_store"])
    forged = LightBlock.decode(lf["attack"])

    class Witness:
        def __init__(self):
            self.evidences = []

        def chain_id(self):
            return BSYNC_CHAIN_ID

        def light_block(self, height):
            return forged if height == tip else primary.light_block(height)

        def report_evidence(self, ev):
            self.evidences.append(ev)

    witness = Witness()
    rec = LightRecorder(torch_backend)
    ed25519._verified.clear()
    be.set_backend(rec)
    try:
        client = Client(BSYNC_CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, 1,
                                                     primary.light_block(1).hash()),
                        primary, [witness], LightStore(MemDB()))
        now = state.last_block_time.add_nanos(60 * 10**9)
        err = raises(ErrLightClientAttack, lambda: client.verify_light_block_at_height(tip, now))
        light_counts_clean(client, "attack")
        pending, _ = pool.pending_evidence(-1)
        check(len(pending) == 1
          and pending[0].conflicting_block.signed_header.header.hash() == forged.hash(),
              f"attack: {len(pending)} pending evidence")
        check(len(witness.evidences) == 1, "attack: the witness got no evidence of the primary")
        ev_bytes = encode_evidence(pending[0])
        ex = node["executor"]
        ex.evpool = pool
        last_commit = node["block_store"].load_seen_commit(tip)
        block = ex.create_proposal_block(tip + 1, state, last_commit,
                                         state.validators.get_proposer().address)
        check([encode_evidence(e) for e in block.evidence] == [ev_bytes],
              "attack: the proposal does not carry the evidence")
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        commit = sign_commits([("next", BSYNC_CHAIN_ID, light_unsigned(
            block.header, state.validators, bid))], lf["secret"], signers)["next"]
        node["block_store"].save_block(block, parts, commit)
        new_state, _ = ex.apply_block(state, bid, block)
    finally:
        be.set_backend(None)
    stored = node["block_store"].load_block(tip + 1)
    check([encode_evidence(e) for e in stored.evidence] == [ev_bytes],
          "attack: the stored block does not carry the evidence")
    check(pool._is_committed(pending[0]) and pool.pending_count() == 0,
          f"attack: the evidence is not committed ({pool.stats_snapshot()})")
    source["state"] = new_state
    return {"error": str(err), "evidence_bytes": len(ev_bytes), "block_height": tip + 1,
            "pool": pool.stats_snapshot(), "calls": [(k["class"], k["lanes"]) for k in rec.calls],
            "byzantine": len(pending[0].byzantine_validators)}


def light_evidence_10k(sources, lf, backend) -> dict:
    """The 10,240-validator blocksync source's tip, conflicting, signed by
    its validators, as LightClientAttackEvidence against height 1
    (``make_attack_evidence``: every signer byzantine): ``add_evidence`` of
    a fresh pool over the source's stores, from objects decoded anew and an
    empty cache, under ``set_backend(backend)``. Returns the wall ms, the
    backend's calls and the evidence's bytes."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.detector import make_attack_evidence
    from cometbft_tpu_torch.light.provider import BlockStoreProvider
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import LightBlock
    from cometbft_tpu_torch.types.evidence import decode_evidence, encode_evidence

    node = sources["10k"]["node"]
    common = BlockStoreProvider(BSYNC_CHAIN_ID, node["block_store"],
                                node["state_store"]).light_block(1)
    raw = encode_evidence(make_attack_evidence(LightBlock.decode(lf["evidence"]), common))
    rec = LightRecorder(backend, keep=True)
    ev = decode_evidence(raw)
    pool = EvidencePool(MemDB(), node["state_store"], node["block_store"])
    ed25519._verified.clear()
    be.set_backend(rec)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.add_evidence(ev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    check(pool.pending_count() == 1, "the 10,240-validator attack evidence was not accepted")
    return {"ms": wall, "calls": [(k["class"], k["lanes"]) for k in rec.calls],
            "bytes": len(raw), "byzantine": len(ev.byzantine_validators), "recorder": rec}


def light_duplicate_votes(sources, lf, fixtures, torch_backend, auto) -> dict:
    """Validator 0 of the 150-validator blocksync source precommits two
    blocks at LIGHT_DUP_HEIGHT; a fresh EvidencePool over the source's
    stores verifies the DuplicateVoteEvidence through a fresh sigbatch,
    under ``TorchBackend()`` (no engine: the private window, one backend
    call) and under the process default (its CoalescingScheduler's engine,
    consensus class); a copy with one flipped signature bit is refused with
    the reference's text. Returns the counters of each path."""
    import dataclasses

    from cometbft_tpu_torch.crypto import ed25519, sigbatch
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar import engine
    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, BlockID, PartSetHeader, Vote
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence
    from cometbft_tpu_torch.types.vote import VoteError

    node = sources["150"]["node"]
    h = LIGHT_DUP_HEIGHT
    vals = node["state_store"].load_validators(h)
    t = node["block_store"].load_block_meta(h).header.time
    val = vals.validators[0]
    seed, pub = lf["secret"][val.address]
    votes = []
    for mark in (b"\xaa", b"\xbb"):
        v = Vote(type=PRECOMMIT_TYPE, height=h, round=0,
                 block_id=BlockID(mark * 32, PartSetHeader(1, mark * 32)), timestamp=t,
                 validator_address=val.address, validator_index=0)
        votes.append(v.with_signature(sign_known(pure, fixtures[0], seed, pub,
                                                 v.sign_bytes(BSYNC_CHAIN_ID))))
    ev = DuplicateVoteEvidence.new(votes[0], votes[1], t, vals)
    sig = bytearray(ev.vote_b.signature)
    sig[9] ^= 0x04
    bad = dataclasses.replace(ev, vote_b=dataclasses.replace(ev.vote_b, signature=bytes(sig)))
    out = {}
    for name, backend in (("torch", torch_backend), ("auto", auto)):
        old = sigbatch.set_batcher(None)
        ed25519._verified.clear()
        be.set_backend(backend)
        eng = engine.engine_of(backend)
        admitted = eng.class_counters_[engine.CLASS_CONSENSUS]["admitted"] if eng else 0
        launches = dict(_build.LAUNCHES)
        try:
            EvidencePool(MemDB(), node["state_store"], node["block_store"]).add_evidence(ev)
            err = raises(VoteError, lambda: EvidencePool(
                MemDB(), node["state_store"], node["block_store"]).add_evidence(bad))
            counters = sigbatch.counters()
        finally:
            be.set_backend(None)
            sigbatch.set_batcher(old)
        check(str(err) == "invalid signature", f"duplicate vote, {name}: {err!r}")
        check(counters["fallbacks"] == 0 and counters["dispatches"] == 2,
              f"duplicate vote, {name}: sigbatch {counters}")
        sets = {k: _build.LAUNCHES[k] - launches[k] for k in ("sha512", "decompress", "ladder")}
        rec = {"sigbatch": counters, "launch_sets": sets["ladder"],
               "engine": eng is not None}
        if name == "torch":
            check(eng is None and sets == {"sha512": 2, "decompress": 2, "ladder": 2},
                  f"duplicate vote under TorchBackend(): engine {eng}, launches {sets}")
        else:
            check(eng is not None and eng.class_counters_[engine.CLASS_CONSENSUS]["admitted"]
                  == admitted + 2, "duplicate vote under the default: not through its engine")
            hybrid = be._hybrid_tier(backend.inner)
            rec["hybrid_share_of_the_last"] = hybrid.last_share
        out[name] = rec
    return out


def light_kernel_batches(gates, ev10k) -> dict:
    """The batches the light path handed the verify kernels: the largest
    descent prewarm at 10,240 validators, the largest at 150, and the
    evidence check at 10,240; each with four lanes corrupted
    (``corrupt_four``). Returns label -> (pubs, msgs, sigs, corrupted)."""
    out = {}
    for label, rec in (("10k_prewarm", gates[1]["10k"]), ("150_prewarm", gates[1]["150"]),
                       ("10k_evidence", ev10k["recorder"])):
        pubs, msgs, sigs = max(rec.triples, key=lambda t: len(t[0]))
        out[f"{label}_{len(pubs)}"] = corrupt_four(pubs, msgs, sigs)
    return out


def light_metrics(lf, sources, torch_backend, auto) -> dict:
    """Medians of LIGHT_REPS cold syncs (fresh client, empty cache) under
    ``TorchBackend()`` and the process default in turns: the 10,240-
    validator client to height 9 and the 150-validator client to 100; the
    10,240-validator evidence check; then the 10,240 sync's stage split
    (one staged run under ``TorchBackend()``)."""
    runs = {k: {"torch": [], "auto": []} for k in ("10k", "150", "evidence_10k")}
    for rep in range(LIGHT_REPS):
        tiers = [("torch", torch_backend), ("auto", auto)]
        for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
            runs["10k"][tier].append(light_sync(lf["10k"], backend, LIGHT_HEIGHTS, witness=True)["ms"])
            runs["150"][tier].append(light_sync(lf["150"], backend, LIGHT_SMALL_HEIGHTS)["ms"])
            runs["evidence_10k"][tier].append(light_evidence_10k(sources, lf, backend)["ms"])
    stages = LightStages()
    staged = light_sync(lf["10k"], LightRecorder(torch_backend), LIGHT_HEIGHTS, witness=True,
                        stages=stages)
    return {"runs_ms": runs,
            "medians_ms": {k: {t: statistics.median(v) for t, v in r.items()}
                           for k, r in runs.items()},
            "stages_10k": {"wall_ms": staged["ms"], "stages": stages.table()}}


def drive_light_path(fixtures, sources, torch_backend, dev) -> dict:
    """The light phase (module docstring, step 17): returns its launches,
    gates, metrics and the kernels at the path's own batches."""
    import multiprocessing

    from cometbft_tpu_torch.crypto import ed25519, sigbatch
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    fallbacks = ed25519.scalar_fallbacks
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(SIGN_PROCESSES) as pool:
        lf = light_fixtures(fixtures, sources, pool)
        fixtures_s = time.perf_counter() - t0
        print(f"light fixtures: {N_SIGS} validators x {LIGHT_HEIGHTS} heights rotating "
              f"{LIGHT_ROTATE} a height (heights {LIGHT_SIGNED} signed), {LIGHT_SMALL} x "
              f"{LIGHT_SMALL_HEIGHTS} rotating {LIGHT_SMALL_ROTATE}, two conflicting tips: "
              f"{lf['signatures']} signatures, keys {lf['keys_s']:.1f} s, signing "
              f"{lf['sign_s']:.1f} s, built in {fixtures_s:.1f} s", flush=True)

        # The counted run: launch counts zeroed just before, read just after.
        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                     CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            auto = be._make_backend()
        try:
            _build.reset_launches()
            gates = light_gates(lf, torch_backend)
            swarm = {mode: light_swarm(lf, torch_backend, mode == "mmr")
                     for mode in ("plan", "mmr")}
            attack = light_attack(sources, lf, torch_backend, pool)
            ev10k = light_evidence_10k(sources, lf, torch_backend)
            dup = light_duplicate_votes(sources, lf, fixtures, torch_backend, auto)
            launches = dict(_build.LAUNCHES)
            calls = (sum(len(r.calls) for r in gates[1].values())
                     + sum(len(s["lanes"]) for s in swarm.values()) + len(attack["calls"])
                     + len(ev10k["calls"]) + dup["torch"]["launch_sets"]
                     + dup["auto"]["launch_sets"])
            check(launches == {"ladder": calls, "decompress": calls, "sha512": calls,
                               "sha256": 0, "bn254": 0},
                  f"light path launches {launches}: expected one sha512 / decompress / ladder "
                  f"set a card call ({calls})")
            check(ev10k["calls"] == [("blocksync", N_SIGS // 3 + 1)],
                  f"the evidence check's calls {ev10k['calls']}")
            lone = sum(gates[1]["150"].lanes())
            for mode, s in swarm.items():
                check(s["lanes_total"] <= lone + s["gateway"]["prewarmed_sigs"],
                      f"swarm ({mode}): {s['lanes_total']} lanes, more than one lone client's "
                      f"{lone} plus the gateway's prewarm {s['gateway']['prewarmed_sigs']}")
            check(ed25519.scalar_fallbacks == fallbacks,
                  "a light-path verification took the ChainExhausted fallback")
            metrics = light_metrics(lf, sources, torch_backend, auto)
        finally:
            auto.close()
    check(ed25519.scalar_fallbacks == fallbacks,
          "a light-path verification took the ChainExhausted fallback")
    check(sigbatch.counters()["fallbacks"] == 0, "a sigbatch fallback on the light path")
    kernels = bsync_window_kernels(light_kernel_batches(gates, ev10k), dev)
    ev10k.pop("recorder")
    return {
        "fixtures_s": fixtures_s, "signatures": lf["signatures"], "launches": launches,
        "gates": gates[0], "swarm": swarm, "attack": attack, "evidence_10k": ev10k,
        "duplicate_votes": dup, "metrics": metrics, "kernels": kernels,
        "lanes_by_caller": {
            **{name: r.calls for name, r in gates[1].items()},
            **{f"swarm_{m}": s["lanes"] for m, s in swarm.items()},
            "attack": attack["calls"], "evidence_10k": ev10k["calls"]},
    }


N_SHARDS = 2


def compare_digests(leaves, merkle_oracle, dev, sms, clock_hz):
    """The sha256 kernel's digests entry (counterpart of merkle_kernel.
    merkle_root_pow2) against digest_tree_root_plain on every word at the
    block's 65,536 leaf digests and at 10,000, 3 and 1 of them, and
    merkle_root_pow2 against the host tree; times at 65,536. Returns the
    record and the leaf digests (int32[8, n] on the card)."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import sha256_kernel as sha

    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in leaves])
    digests = mk.leaf_core(torch.from_numpy(blocks.view(np.int32)).to(dev),
                           torch.from_numpy(nblocks).to(dev))
    err = 0
    for m in (len(leaves), N_RAGGED_LEAVES, 3, 1):
        part = digests[:, :m]
        got = mk.digest_tree_root(part)
        err = max(err, max_abs_err(got, mk.digest_tree_root_plain(part)))
        check(mk._root_bytes(got) == merkle_oracle(leaves[:m]),
              f"sha256 digests entry: {m}-digest root != hash_from_byte_slices")
    check(err == 0, f"sha256 digests entry != plain (max abs err {err})")
    check(mk.merkle_root_pow2(digests) == merkle_oracle(leaves),
          "merkle_root_pow2 != hash_from_byte_slices at 65,536 digests")
    n = digests.shape[1]
    t_b = bound_ms(2 * (n - 1) * SHA256_BLOCK_OPS, 32 * n + 32, sms, clock_hz)
    rec = {
        "shape": f"{n} leaf digests, 2 launches ({-(-n // mk.CHUNK)} chunks of {mk.CHUNK})",
        "ms": time_cuda(lambda: mk.digest_tree_root(digests), 50),
        # the profiler has dropped records of this pair of launches: up to
        # three traces, the first that holds every launch
        "kernel_ms": next((t for t in (kernel_ms(lambda: mk.digest_tree_root(digests), launches=2)
                                       for _ in range(3)) if t is not None), None),
        "queued_ms": time_queued(lambda: mk.digest_tree_root(digests), 50),
        "plain_ms": time_cuda(lambda: mk.digest_tree_root_plain(digests), 1, warmup=0),
        "bound_ms": t_b[0], "bound_by": t_b[1], "chain_floor_ms": chain_floor_ms(0, n, clock_hz),
        "max_abs_err": err, "replaces": "cometbft_tpu/ops/merkle_kernel.py:214",
    }
    print(f"sha256 digests entry, {n} digests: {rec['kernel_ms']} ms CUPTI, {rec['queued_ms']} "
          f"queued, {rec['ms']} by events; bound {rec['bound_ms']}, chain floor "
          f"{rec['chain_floor_ms']}", flush=True)
    return rec, digests


@contextlib.contextmanager
def virtual_width(dev, width: int):
    """Route as a host with ``width`` cards would, on ``width`` virtual
    shards of ``dev``: ed25519_kernel's mesh_width and local_devices, which
    merkle_kernel and bn254_kernel read too, replaced inside the block."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    saved = ek.mesh_width, ek.local_devices
    ek.mesh_width = lambda device=None: width
    ek.local_devices = lambda dev_type, w: [dev] * w
    try:
        yield
    finally:
        ek.mesh_width, ek.local_devices = saved


def drive_mesh_path(fixtures, bn_fix, pure, merkle_oracle, dev, digests) -> dict:
    """The lane-split programs on N_SHARDS virtual shards of ``dev``, each
    step's launches checked exactly: TorchBackend routed over the mesh (K1
    for the commit, K2 for the root) and Bn254DeviceBackend (K7, the
    aggregate and the one with a share left out); K1 sharded and
    replicated, K3, K2 and K4 called directly; K5 on a one-rank group
    (``nccl`` on the card) over one shard and over N_SHARDS, and
    MultihostShardBackend. Bitmaps equal TorchBackend's on one device, roots
    the host's. Returns the launches and the mesh and bn254 counters'
    steps."""
    import torch.distributed as dist

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import bn254_kernel as bk
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import multihost, sharded
    from cometbft_tpu_torch.ops import sha256_kernel as sha
    from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    one_ok, one_bits = TorchBackend(device=dev).batch_verify(pubs, bad_msgs, bad_sigs)
    check(not one_ok and [i for i, b in enumerate(one_bits) if not b] == want_bad,
          "mesh phase: the one-device bitmap of the corrupted commit is wrong")
    root = merkle_oracle(leaves)
    good_ops, good_mask = ek.pack_batch(pubs, msgs, sigs, 1)
    bad_ops, bad_mask = ek.pack_batch(pubs, bad_msgs, bad_sigs, 1)
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in leaves])
    mesh = sharded.make_mesh([dev] * N_SHARDS)

    def bits_of(mask, dev_ok):
        return [bool(m and d) for m, d in zip(mask[:n], np.asarray(dev_ok)[:n])]

    def step(name, fn, verifies=0, **want):
        before = dict(_build.LAUNCHES)
        out = fn()
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        full = {k: want.get(k, 0) for k in before}
        for k in ("sha512", "decompress", "ladder"):
            full[k] = verifies
        check(got == full, f"mesh path, {name}: launches {got}, expected {full}")
        return out

    mc0, bc0 = ek.mesh_counters(), bk.counters()
    _build.reset_launches()
    with virtual_width(dev, N_SHARDS):
        backend = TorchBackend(device=dev)
        check(backend.mesh_width() == N_SHARDS, "mesh phase: TorchBackend's routing width")
        ok, bits = step("TorchBackend, commit", lambda: backend.batch_verify(pubs, msgs, sigs),
                        N_SHARDS)
        check(ok and all(bits) and len(bits) == n, "mesh phase: the commit did not verify")
        ok, bits = step("TorchBackend, corrupted commit",
                        lambda: backend.batch_verify(pubs, bad_msgs, bad_sigs), N_SHARDS)
        check(bits == one_bits, "mesh phase: K1 bitmap != TorchBackend's on one device")
        check(step("TorchBackend, root (K2)", lambda: backend.merkle_root(leaves),
                   sha256=3 * N_SHARDS + 2) == root, "mesh phase: K2 root != the host's")
        agg = Bn254DeviceBackend(device=dev)
        check(step("K7 aggregate", lambda: agg.aggregate_verify(bn_fix["pubs"], bn_fix["msgs"],
                                                                bn_fix["agg"]), bn254=2 * N_SHARDS)
              is True, "mesh phase: the aggregate did not verify over the lane mesh")
        check(step("K7 aggregate, a share left out",
                   lambda: agg.aggregate_verify(bn_fix["pubs"], bn_fix["msgs"], bn_fix["poisoned"]),
                   bn254=2 * N_SHARDS) is False,
              "mesh phase: the aggregate with a share left out verified over the lane mesh")
    mc, bc = ek.mesh_counters(), bk.counters()
    counters = {k: mc[k] - mc0[k] for k in ("sharded_dispatches", "padded_lanes",
                                            "merkle_sharded_dispatches")}
    counters["bn254_sharded_dispatches"] = bc["sharded_dispatches"] - bc0["sharded_dispatches"]
    pad = 2 * (ek.bucket_for(n, N_SHARDS) - n)
    check(counters == {"sharded_dispatches": 2, "padded_lanes": pad, "merkle_sharded_dispatches": 1,
                       "bn254_sharded_dispatches": 4}, f"mesh phase: counters stepped {counters}")

    dev_ok = step("K1", lambda: sharded.sharded_verify_fn(mesh)(*bad_ops).cpu().numpy(), N_SHARDS)
    rep_ok = step("K1 replicated",
                  lambda: sharded.sharded_verify_replicated_fn(mesh)(*bad_ops).cpu().numpy(),
                  N_SHARDS)
    check((dev_ok == rep_ok).all() and bits_of(bad_mask, dev_ok) == one_bits,
          "mesh phase: K1 sharded and replicated bitmaps differ or != TorchBackend's")
    check(mk._root_bytes(step("K3", lambda: sharded.sharded_merkle_fn(mesh)(digests),
                              sha256=2 * N_SHARDS + 2)) == root, "mesh phase: K3 root")
    check(mk._root_bytes(step("K2", lambda: sharded.sharded_leaves_to_root_fn(mesh)(blocks, nblocks),
                              sha256=3 * N_SHARDS + 2)) == root, "mesh phase: K2 root")
    commit_step = sharded.sharded_commit_step_fn(mesh)
    for ops, mask, valid, want in ((good_ops, good_mask, True, [True] * n),
                                   (bad_ops, bad_mask, False, one_bits)):
        ok_t, all_valid, r = step("K4", lambda: commit_step(*ops, digests), N_SHARDS,
                                  sha256=2 * N_SHARDS + 2)
        check(bool(all_valid) is valid and mk._root_bytes(r) == root
              and bits_of(mask, ok_t.cpu().numpy()) == want,
              f"mesh phase: K4 step (all_valid {bool(all_valid)}, expected {valid})")

    kind = "nccl" if dev.type == "cuda" else "gloo"
    one_rank = multihost.distributed_init(dist.HashStore(), 1, 0,
                                          local_devices=None if dev.type == "cuda" else 1)
    try:
        check(dist.get_backend() == kind and one_rank.width == 1, "mesh phase: the one-rank group")
        wide = sharded.make_mesh([dev] * N_SHARDS, group=dist.group.WORLD)
        for m in (one_rank, wide):
            k = m.local_width
            ok_np, all_valid, r = step(f"K5 commit step, {k} shards",
                                       lambda: multihost.multihost_commit_step(m, bad_ops, digests),
                                       k, sha256=2 * k + 2)
            check(all_valid is False and sha.digest_words_to_bytes(r)[0] == root
                  and bits_of(bad_mask, ok_np) == one_bits, "mesh phase: K5 commit step")
            _, bits = step(f"K5 verify, {k} shards",
                           lambda: multihost.multihost_verify(m, pubs, bad_msgs, bad_sigs), k)
            check(bits == one_bits, "mesh phase: K5 verify bitmap != TorchBackend's")
        shard = multihost.MultihostShardBackend(wide, [])
        _, bits = step("MultihostShardBackend", lambda: shard.batch_verify(pubs, bad_msgs, bad_sigs),
                       N_SHARDS)
        check(bits == one_bits and shard.mesh_width() == N_SHARDS,
              "mesh phase: MultihostShardBackend")
    finally:
        dist.destroy_process_group()
    launches = dict(_build.LAUNCHES)
    check(all(launches.values()), f"mesh phase: a kernel of the path was not launched: {launches}")
    return {"launches": launches, "counters": counters, "good_ops": good_ops,
            "commit_step": commit_step}


def mesh_metrics(mesh_out, digests) -> dict:
    """mesh_commit_step_10k_64k_ms: one K4 step over N_SHARDS virtual shards,
    the commit's packed host operands in, the bitmap, all-valid bit and root
    back on the host; median of 5, and one traced step (the device's busy
    time and each kernel's and copy's)."""
    step, ops = mesh_out["commit_step"], mesh_out["good_ops"]

    def run():
        ok, all_valid, root = step(*ops, digests)
        return ok.cpu(), bool(all_valid), root.cpu()

    runs = [time_host(run) for _ in range(5)]
    trace = trace_call(run)
    trace["kernels_ms"] = dict(collections.Counter(trace["kernels_ms"]).most_common(8))
    return {"metric": "mesh_commit_step_10k_64k_ms", "value": statistics.median(runs),
            "runs_ms": runs, "shards": N_SHARDS,
            "label": "two virtual shards on one card, not a multi-GPU figure",
            "traced_step": trace}


def time_bn254_lanes() -> int:
    """``--bn254-lanes``: only the bn254 kernel's time by events at each of
    BN254_LANE_COUNTS, for the cometbft_tpu_torch beside this file (a copy
    of it in an older checkout times that checkout's kernel, in the same
    call as this one's). Prints {"bn254_ms_by_lanes": {lanes: ms}}."""
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.ops import bn254_kernel as bk

    lanes = bn254_lanes(bn, max(BN254_LANE_COUNTS))
    out = {}
    for n in BN254_LANE_COUNTS:
        ops = bk.operands_to_device(bk._pack(lanes[:n], n), torch.device("cuda"))
        out[n] = time_cuda(lambda: bk.miller_values(*ops), 5)
    print(json.dumps({"bn254_ms_by_lanes": out}), flush=True)
    return 0


def light_phase(fixtures, sources, backend, dev, card, records) -> dict:
    """Runs the light path (step 17), prints its metrics and gates, merges
    its kernel comparisons into ``records``; returns its launches."""
    start = time.perf_counter()
    out = drive_light_path(fixtures, sources, backend, dev)
    for k in ("sha512", "decompress", "ladder"):  # held at the path's own batches too
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    g, sw, med = out["gates"], out["swarm"], out["metrics"]["medians_ms"]
    print(f"light path ok (the {N_SIGS}-validator client fetched {g['10k']['fetched']}, backend "
          f"calls {g['10k']['calls']}; the {LIGHT_SMALL}-validator skipping, sequential and "
          f"backwards clients as the arithmetic gives; {LIGHT_SWARM} clients through one gateway "
          f"share one plan in each mode; the attack detected, its evidence committed at height "
          f"{out['attack']['block_height']}; duplicate votes accepted and the flipped copy "
          f"refused on both paths); launches {out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    for name, key, n in (("light_sync_10k_ms", "10k", N_SIGS),
                         ("light_sync_150_ms", "150", LIGHT_SMALL),
                         ("evidence_verify_10k_ms", "evidence_10k", N_SIGS)):
        print(json.dumps({"metric": name, "value": med[key]["torch"], "validators": n,
                          "by_backend": med[key], "runs_ms": out["metrics"]["runs_ms"][key],
                          **common}), flush=True)
    print(json.dumps({"metric": "light_gateway_64_ms", "value": sw["plan"]["ms"],
                      "clients": LIGHT_SWARM, "by_mode": {m: s["ms"] for m, s in sw.items()},
                      "swarm": {m: {k: v for k, v in s.items() if k != "trace"}
                                for m, s in sw.items()}, **common}), flush=True)
    print(json.dumps({"light_stages_10k": out["metrics"]["stages_10k"], **common}), flush=True)
    print(json.dumps({"light": {k: v for k, v in out.items() if k not in ("swarm", "metrics")},
                      "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"]


def light_only(card, dev) -> int:
    """``--light``: the fixtures, the blocksync sources and the light phase
    alone (a quick check of that phase on the card; no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    launches = light_phase(fixtures, bsync_sources(fixtures, backend), backend, dev, card,
                           records)
    print(json.dumps({"light_launches": launches, "max_abs_err": records}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--bn254-lanes"]:
        return time_bn254_lanes()
    from cometbft_tpu_torch.ops import _build

    card = card_line()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    clock_hz = max_sm_clock_hz()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}; "
          f"{props.multi_processor_count} SMs, max SM clock {clock_hz / 1e6:.0f} MHz; card: {card}",
          flush=True)

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        entry = re.search(r"entry function '_Z\w*?\d+(\w+_kernel)(I((?:L[ib]\d+E)+)E)?", line)
        if entry:
            args = re.findall(r"L[ib](\d+)E", entry.group(3) or "")
            name = re.search(r"[a-z_]+_kernel$", entry.group(1)).group(0)
            print(f"  {name}" + (f"<{', '.join(args)}>" if args else ""))
        elif line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    if sys.argv[1:] == ["--light"]:
        return light_only(card, dev)
    procs: list = []  # every process the phases start, ended here
    try:
        return run_phases(card, dev, props, clock_hz, so, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(card, dev, props, clock_hz, so, procs: list) -> int:
    """Phases 4-18 (module docstring); the processes it starts go to ``procs``."""
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.crypto import merkle as host
    from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    mixes = sass_mix(so)
    for g, mix in mixes.items():
        print(f"ladder SASS at {g} threads a lane (static instruction counts): {mix}", flush=True)
    from cometbft_tpu_torch.probe import issue_rates

    rates = issue_rates.measure(props.multi_processor_count, clock_hz)
    print(f"issue rates (thread-instructions a clock per SM, measured): {json.dumps(rates)}",
          flush=True)

    # Processes of their own on the card, started now that the kernel library
    # is built (they load it) and the issue rates are measured: the fleet's
    # remote sidecar (warming up while the fixtures are made) and the
    # device probe.
    sidecar_proc = start_sidecar_process()
    procs.append(sidecar_proc)
    probe_proc = subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.probe.device"],
                                  cwd=os.path.dirname(os.path.abspath(__file__)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs.append(probe_proc)

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, N_LEAVES)
    print(f"fixtures: {N_SIGS} signatures, {N_LEAVES} leaves, {N_PARTS} parts of {PART_BYTES} "
          f"bytes in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bn_fix = bn254_fixtures(bn)
    print(f"fixtures: {N_VALIDATORS}-validator BN254 aggregate and {N_VOTES} votes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Both processes done with their first use of the card before anything
    # is timed here.
    remote = sidecar_process_addr(sidecar_proc)
    probe_out, _ = probe_proc.communicate(timeout=300)
    print(f"sidecar process serving on {remote}; device probe exit {probe_proc.returncode}",
          flush=True)

    t0 = time.perf_counter()
    records = compare_kernels(fixtures, hash_from_byte_slices, dev, props.multi_processor_count,
                              clock_hz, rates)
    records["bn254"] = compare_bn254(bn, dev, props.multi_processor_count, clock_hz, rates)
    print(f"kernels equal their plain versions (compare + timing {time.perf_counter() - t0:.1f} s)",
          flush=True)
    for g, mix in mixes.items():
        est = ladder_issue_estimate(mix, rates, g, N_SIGS, props.multi_processor_count, clock_hz)
        print(f"ladder issue estimate at {g} threads a lane (ms, static mix over measured "
              f"rates): {est}; measured {records['ladder']['ms_by_group'][g]}", flush=True)

    backend = TorchBackend()
    _build.reset_launches()
    drive_main_path(fixtures, pure, hash_from_byte_slices, backend)
    launches = dict(_build.LAUNCHES)
    check(launches == {"ladder": 4, "decompress": 4, "sha512": 4, "sha256": 4, "bn254": 0},
          f"expected one sha512, decompress and ladder launch a batch (4 batches) and two "
          f"sha256 launches a root (2 roots): {launches}")
    print(f"Ed25519 / Merkle path ok; launches {launches}", flush=True)
    by_path = {"verify_root": launches}

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    totals = []
    for _ in range(5):
        totals.append(time_host(lambda: (backend.batch_verify(pubs, msgs, sigs),
                                         backend.merkle_root(leaves))))
    splits = [stage_split(fixtures, dev) for _ in range(3)]
    stages = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    trace = trace_call(lambda: (backend.batch_verify(pubs, msgs, sigs),
                                backend.merkle_root(leaves)))
    print(json.dumps({
        "metric": "verify_10k_commit_plus_64k_merkle_ms",
        "value": statistics.median(totals), "runs_ms": totals,
        "stages_ms": stages, "device": torch.cuda.get_device_name(0), "card": card,
    }), flush=True)
    trace["kernels_ms"] = dict(collections.Counter(trace["kernels_ms"]).most_common(12))
    # A busy share only from a trace that saw every kernel of the call: the
    # verify's launch from the device-owner thread, the tree's from this one.
    seen = " ".join(trace["kernels_ms"])
    complete = all(k in seen for k in ("digits_kernel", "decompress_kernel", "ladder_verify_kernel",
                                       "tree_chunks_kernel", "tree_roots_kernel"))
    print(json.dumps({"traced_call": trace, "trace_saw_every_kernel": complete,
                      "device_busy_share_of_untraced_median":
                          trace["device_ms"] / statistics.median(totals) if complete else None}),
          flush=True)

    _build.reset_launches()
    drive_proofs(fixtures, host)
    by_path["proofs"] = dict(_build.LAUNCHES)
    check(by_path["proofs"] == {"ladder": 0, "decompress": 0, "sha512": 0, "sha256": 6, "bn254": 0},
          f"expected two sha256 launches a proof set (3 sets): {by_path['proofs']}")
    print(f"proofs path ok (65,536, 10,000 and {N_PARTS} x {PART_BYTES}-byte leaves equal the "
          f"host's proofs); launches {by_path['proofs']}", flush=True)
    print(json.dumps({**proofs_metrics(fixtures, host, dev), "device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)

    sc = drive_sidecar(fixtures, pure, hash_from_byte_slices)
    by_path["sidecar"] = sc["launches"]
    print(f"sidecar path ok through the socket ({sc['dispatches']} verify dispatches); launches "
          f"{sc['launches']}; client {sc['client']}", flush=True)
    print(json.dumps({
        "metric": "sidecar_verify_10k_commit_plus_64k_merkle_ms",
        "value": statistics.median(sc["totals"]), "runs_ms": sc["totals"],
        "in_process_ms": statistics.median(totals), "warmup_s": sc["warmup_s"],
        "scheduler": sc["scheduler"], "device": torch.cuda.get_device_name(0), "card": card,
    }), flush=True)

    bn_backend = Bn254DeviceBackend()
    _build.reset_launches()
    bn_times = drive_bn254_path(bn_fix, bn_backend)
    bn_launches = dict(_build.LAUNCHES)
    check(bn_launches == {"ladder": 0, "decompress": 0, "sha512": 0, "sha256": 0, "bn254": 5},
          f"expected two bn254 launches an aggregate (2 aggregates) and one for the vote "
          f"batch: {bn_launches}")
    by_path["bn254"] = bn_launches
    cut = ("every validator signs one shared message: distinct per-validator sign bytes would "
           "cost 10,240 runs of the host's pure-Python hash-to-G2; the device work a lane is "
           "the same either way")
    print(f"BN254 path ok; launches {bn_launches}; cut: {cut}", flush=True)
    bn_splits = [bn254_stage_split(bn_fix, bn, dev)]
    print(json.dumps({
        "metric": "aggregate_verify_10k_ms", "value": bn_times["aggregate_accept"],
        "runs_ms": bn_times, "stages_ms": bn_splits, "validators": N_VALIDATORS,
        "lanes": N_VALIDATORS + 1, "cut": cut, "device": torch.cuda.get_device_name(0),
        "card": card,
    }), flush=True)

    hybrid, root, plan, by_path["hybrid"] = drive_hybrid_path(fixtures, pure, backend)
    print(f"hybrid path ok (shares 0, {HYBRID_SPLIT} and {N_SIGS}: bitmaps equal TorchBackend's; "
          f"verify_and_root's root too); launches {by_path['hybrid']}; planner {json.dumps(plan)}",
          flush=True)
    hm = hybrid_metrics(fixtures, hybrid, backend)
    print(json.dumps({"metric": "hybrid_verify_10k_commit_ms", "value": hm["verify_ms"]["hybrid"],
                      **hm, "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    by_path["chain"], chain_rec = drive_chain_path(fixtures, pure, bn_fix, root)
    print(f"chain path ok (hybrid serves, an injected error degrades to cpu with the same bitmaps; "
          f"the BN254 chain serves from bn254-device, then bn254-host); launches {by_path['chain']}; "
          f"{json.dumps(chain_rec)}", flush=True)

    auto = drive_auto_path(fixtures, pure, backend)
    by_path["auto"] = auto.pop("launches")
    print(f"auto path ok (CMTPU_BACKEND=auto: the coalesced chain, its hybrid warmed in "
          f"{auto['setup_s']:.1f} s, served every batch with TorchBackend's bitmaps); launches "
          f"{by_path['auto']}", flush=True)
    print(json.dumps({"metric": "auto_verify_ms", **auto, "device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)
    fan = drive_fanout_path(fixtures, pure, backend, sidecar_proc, remote, root)
    by_path["fanout"] = fan.pop("launches")
    print(f"fanout path ok (fanout -> hybrid -> cpu; two sidecars, one in another process, and "
          f"the local hybrid on one card; a killed shard redistributed once, the root failed "
          f"over); launches {by_path['fanout']}", flush=True)
    print(json.dumps({"metric": "fanout_verify_10k_commit_ms",
                      "value": statistics.median(fan["times_ms"]["fanout_commit"]),
                      "torch_ms": statistics.median(fan["times_ms"]["torch_commit"]),
                      "note": "three shards on ONE card, not a multi-host figure", **fan,
                      "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    pp = drive_proofs_paths(fixtures, host)
    by_path["proofs_paths"] = pp.pop("launches")
    print(f"proofs paths ok (the card and the native host pass equal the pure pass; default "
          f"{pp['default']}); launches {by_path['proofs_paths']}", flush=True)
    print(json.dumps({"metric": "proofs_paths_ms", **pp, "device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)
    tools = drive_tooling(fixtures, backend, probe_proc.returncode, probe_out)
    by_path["tooling"] = tools.pop("launches")
    print(f"tooling ok (pprof endpoints, dryrun_multichip(2), entry(), the device probe); "
          f"launches {by_path['tooling']}; {json.dumps(tools)}", flush=True)

    commit_start = time.perf_counter()
    cf = commit_fixtures(fixtures)
    print(f"commit fixtures: a {N_SIGS}-validator ed25519 set and its commits at heights "
          f"{COMMIT_HEIGHT}, +1 and +5 ({3 * N_SIGS} canonical precommits), a hop of "
          f"{CANT_TRUST_SIGNERS} signers, a {COMMIT_SMALL}-validator commit and a "
          f"{N_BN254_COMMIT}-validator BN254 aggregate commit, signed in {SIGN_PROCESSES} "
          f"processes, built in {time.perf_counter() - commit_start:.1f} s", flush=True)
    cp = drive_commit_path(cf, backend)
    by_path["commit"] = cp.pop("launches")
    print(f"commit path ok (verify_commit, verify_commit_light and both hops of the "
          f"{N_SIGS}-validator set; the corrupted commit, the short commit and the hop that "
          f"cannot be trusted raise as they should; the BN254 aggregate through "
          f"get_bn254_backend()); launches {by_path['commit']}; {json.dumps(cp)}", flush=True)
    from cometbft_tpu_torch.sidecar import backend as be

    with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                 CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
        auto = be._make_backend()
    try:
        cm = commit_metrics(cf, backend, auto, dev)
    finally:
        auto.close()
    print(json.dumps({"metric": "verify_commit_10k_ms",
                      "value": cm["medians_ms"]["verify_commit_10k"]["torch"], **cm,
                      "phase_s": time.perf_counter() - commit_start,
                      "device": torch.cuda.get_device_name(0), "card": card}), flush=True)

    bsync_start = time.perf_counter()
    sources = bsync_sources(fixtures, backend)
    bs_out = drive_blocksync_path(sources, backend, dev)
    by_path["blocksync"] = bs_out.pop("launches")
    for k in ("sha512", "decompress", "ladder"):  # held at the path's own batches too
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in bs_out["window_kernels"].values()])
    print(f"blocksync path ok (a fresh node synced the {N_SIGS}-validator chain's "
          f"{BSYNC_HEIGHTS - 1} heights and the {BSYNC_SMALL}-validator chain's "
          f"{BSYNC_SMALL_HEIGHTS - 1} from two peer doubles, state and blocks equal to the "
          f"source's; window batches {bs_out['gates']['10k']['windows']} and "
          f"{bs_out['gates']['150']['windows']}, later checks "
          f"{bs_out['gates']['10k']['later_lanes']} and {bs_out['gates']['150']['later_lanes']}; "
          f"the bad peer stopped once); launches {by_path['blocksync']}", flush=True)
    for name, n in (("10k", N_SIGS), ("150", BSYNC_SMALL)):
        print(json.dumps({
            "metric": f"blocksync_{name}_ms_per_block",
            "value": bs_out["ms_per_block"][name]["torch"],
            "validators": n, "by_backend": bs_out["ms_per_block"][name],
            "runs_ms": bs_out["ms_per_block_runs"][name],
            "pipeline_overlap_ms": bs_out["pipeline_overlap_ms"][name],
            "gates": bs_out["gates"][name],
            "stages_pipeline_off": bs_out["stages"][name],
            "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    print(json.dumps({"blocksync": {k: v for k, v in bs_out.items()
                                    if k not in ("gates", "stages", "ms_per_block_runs")},
                      "phase_s": time.perf_counter() - bsync_start,
                      "device": torch.cuda.get_device_name(0), "card": card}), flush=True)

    by_path["light"] = light_phase(fixtures, sources, backend, dev, card, records)

    mesh_start = time.perf_counter()
    records["sha256"]["digests"], digests = compare_digests(
        fixtures[5], hash_from_byte_slices, dev, props.multi_processor_count, clock_hz)
    records["sha256"]["max_abs_err"] = max(records["sha256"]["max_abs_err"],
                                           records["sha256"]["digests"]["max_abs_err"])
    mesh_out = drive_mesh_path(fixtures, bn_fix, pure, hash_from_byte_slices, dev, digests)
    by_path["mesh"] = mesh_out["launches"]
    print(f"mesh path ok on {N_SHARDS} virtual shards of one card (K1-K7); launches "
          f"{mesh_out['launches']}; counters {mesh_out['counters']}", flush=True)
    print(json.dumps({**mesh_metrics(mesh_out, digests), "device": torch.cuda.get_device_name(0),
                      "card": card, "phase_s": time.perf_counter() - mesh_start}), flush=True)

    sources = {
        "ladder": ("cometbft_tpu_torch/ops/csrc/ladder.cu", "cometbft_tpu/ops/pallas_ladder.py:218",
                   "pallas_ladder._ladder_kernel + the epilogue of ed25519_kernel._verify_from_words"),
        "decompress": ("cometbft_tpu_torch/ops/csrc/decompress.cu",
                       "cometbft_tpu/ops/edwards.py:141, cometbft_tpu/ops/unpack.py:66",
                       "edwards.decompress + unpack.words_to_limbs255"),
        "sha512": ("cometbft_tpu_torch/ops/csrc/sha512.cu",
                   "cometbft_tpu/ops/sha512_kernel.py:188, cometbft_tpu/ops/unpack.py:188,182",
                   "sha512_kernel.hash_blocks_core + unpack.digest_words_to_digits "
                   "+ unpack.scalar_words_to_digits"),
        "sha256": ("cometbft_tpu_torch/ops/csrc/sha256.cu",
                   "cometbft_tpu/ops/sha256_kernel.py:48, cometbft_tpu/ops/merkle_kernel.py:235, "
                   "cometbft_tpu/ops/merkle_kernel.py:214",
                   "sha256_kernel.compress (merkle_kernel._leaf_core/_inner_core/leaves_to_root_core)"
                   " + merkle_kernel._leaves_to_levels_core (the levels entry)"
                   " + merkle_kernel.merkle_root_pow2 (the digests entry)"),
        "bn254": ("cometbft_tpu_torch/ops/csrc/bn254.cu", "cometbft_tpu/ops/bn254_kernel.py:352",
                  "bn254_kernel._build_program.run over _fp_mul :215, _f2_mul_many :239, "
                  "_f12_sqr :277, _f12_sparse :295, _dbl_and_line :320, _add_and_line :335"),
    }
    kernels = []
    for name in _build.KERNELS:
        src, replaces, fn = sources[name]
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "replaces_function": fn, "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": rec["max_abs_err"], "match": rec["max_abs_err"] == 0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "shape": rec["shape"],
            "kernel_ms": rec["kernel_ms"],
            **{k: v for k, v in rec.items()
               if k in ("threads_per_lane", "ms_by_group", "bound_ms_at_imad_wide_rate", "digests",
                        "chain_floor_ms",
                        "ms_by_lanes", "plain_ms_by_lanes", "bound_ms_by_lanes", "fp_muls_a_lane",
                        "queued_ms")
               or k.startswith("levels")},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
