"""Smoke run of the PyTorch/CUDA port (cometbft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at the repo's headline sizes. The Ed25519 / Merkle
path is the ``VerifyBackend`` contract through ``TorchBackend()``: one
10,240-signature commit (vote-shaped challenges) plus the RFC-6962 root of
a 65,536-leaf block. The proofs path is ``proofs_from_byte_slices_device``
(one inclusion proof a transaction or block part) at that block, at 10,000
leaves and at a 21 MiB block's 336 parts of 64 KiB. The sidecar path is the
port's entry point, ``SidecarServer`` over a local socket. The BN254 path is
the aggregate-commit contract through ``Bn254DeviceBackend()``: one
10,240-validator aggregate commit (README "Aggregate BLS commits") and a
16-vote bitmap batch. In order:

  1. prints the PyTorch version and the card (name, power limit);
  2. builds the CUDA kernels from ``cometbft_tpu_torch/ops/csrc``;
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
     10,000 leaves and at the part set; the bn254 Miller loop at 8,192
     lanes (``MAX_LANES``, the first chunk of the 10,240-validator
     aggregate) with edge lanes (the padding lane, coordinates 0, 1 and
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
     root and every proof equal the host's ``proofs_from_byte_slices``,
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
  9. runs the mesh path (the lane-split programs) on two virtual shards of
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
 10. prints the ``kernels`` line (launches summed over the paths, and by
     path), the card line and, last, the result line.

Any failure raises and exits nonzero. Without CUDA it exits nonzero before
printing any result. It imports nothing of JAX or of ``cometbft_tpu``.
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
# BN254 Miller loop, a lane (csrc/bn254.cu): 64 doubling steps of 157 Fp
# multiplies (f^2 63, the doubling 40, its line 54), 38 addition steps of
# 97 (the addition 43, its line 54) and 26 conversions into and out of
# Montgomery form; 136 32x32->64 products a multiply (CIOS over eight
# words: 64 for a*b, 8 quotient words, 64 for m*p). Bytes: P, Q, pi(Q),
# -pi^2(Q) in and the Fp12 value out, 13 float64 limbs an Fp element.
BN254_FP_MULS = 64 * 157 + 38 * 97 + 26
BN254_FP_MUL_OPS = 136
BN254_LANE_BYTES = (2 + 3 * 4 + 12) * 13 * 8
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


def sign_batch(pure, fb: FixedBase, seeds, msgs):
    """RFC 8032 keys and signatures (the pure module's sign, with [r]B and
    [a]B from the fixed-base table)."""
    pubs, sigs = [], []
    for seed, msg in zip(seeds, msgs):
        a, prefix = pure.secret_expand(seed)
        pub = pure.point_compress(fb.mult(a))
        r = pure.sha512_mod_l(prefix, msg)
        rs = pure.point_compress(fb.mult(r))
        k = pure.sha512_mod_l(rs, pub, msg)
        s = (r + k * a) % pure.L
        pubs.append(pub)
        sigs.append(rs + s.to_bytes(32, "little"))
    return pubs, sigs


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
        plain_ms=time_cuda(lambda: mk.tree_root_plain(flat, offsets), 1, warmup=0),
        bound_ms=t_b[0], bound_by=t_b[1],
        shape=f"{nl} leaves, 2 launches ({-(-nl // mk.CHUNK)} chunks of {mk.CHUNK})",
    )
    rec = records["sha256"]
    rec.update(compare_levels(leaves, parts, dev, sms, clock_hz))
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["levels_max_abs_err"])
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


def compare_levels(leaves, parts, dev, sms, clock_hz) -> dict:
    """The sha256 kernel's levels entry (the counterpart of
    merkle_kernel._leaves_to_levels_core) against tree_levels_raw_plain,
    every word, at the 65,536-leaf block, the 10,000-leaf ragged count and
    the part set; times at 65,536 leaves and at the part set. The plain
    version runs on the card, but for the part set on the CPU, on copies of
    the same inputs: its 1,025 compressions a part run one after another,
    each ~2,600 tiny tensor operations, which cost ~66 ms a compression on
    the card (launch-bound; 68 s for the part set) against a few ms on the
    CPU."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    out, err = {}, 0
    for name, items in (("64k", leaves), ("10k", leaves[:N_RAGGED_LEAVES]), ("partset", parts)):
        flat, offsets = mk.pack_leaves(items, dev)
        got = mk.tree_levels_raw(flat, offsets)
        plain_dev = "cpu" if name == "partset" else dev
        t0 = time.perf_counter()
        want = mk.tree_levels_raw_plain(flat.to(plain_dev), offsets.to(plain_dev))
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(got.cpu(), want.cpu()))
        check(got.shape == want.shape == (mk.level_rows(len(items))[-1][0] + 1, 8),
              f"sha256 levels entry: {name} levels have shape {tuple(got.shape)}")
        if name == "10k":
            continue
        t_b = levels_bound(mk, flat, offsets, sms, clock_hz)
        key = "levels" if name == "64k" else "levels_partset"
        out.update({
            f"{key}_ms": time_cuda(lambda: mk.tree_levels_raw(flat, offsets), 50 if name == "64k" else 5),
            f"{key}_kernel_ms": kernel_ms(lambda: mk.tree_levels_raw(flat, offsets),
                                          20 if name == "64k" else 5, launches=2),
            f"{key}_plain_ms": plain, f"{key}_plain_device": str(plain_dev),
            f"{key}_bound_ms": t_b[0], f"{key}_bound_by": t_b[1],
            f"{key}_shape": f"{len(items)} leaves of {len(items[0])} bytes, 2 launches, "
                            f"{got.shape[0]} nodes out",
        })
    check(err == 0, f"sha256 levels entry != plain (max abs err {err})")
    out["levels_max_abs_err"] = err
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
    leaf hash and aunts equal to the host's proofs_from_byte_slices; every
    97th proof and the last verify against the root; two sha256 launches a
    proof set."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    for name, items in proof_sets(fixtures).items():
        before = _build.LAUNCHES["sha256"]
        root, proofs = mk.proofs_from_byte_slices_device(items)
        check(_build.LAUNCHES["sha256"] - before == 2, f"{name} proofs: not two sha256 launches")
        root_h, proofs_h = host.proofs_from_byte_slices(items)
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
    oracle = [time_host(lambda: host.proofs_from_byte_slices(leaves)) for _ in range(3)]
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
    """Phase 4 for bn254: the kernel against its plain version at 8,192
    lanes (MAX_LANES), every lane equal mod P; returns its record."""
    from cometbft_tpu_torch.ops import bn254_kernel as bk

    n = bk.MAX_LANES
    ops = bk.operands_to_device(bk._pack(bn254_lanes(bn, n), n), dev)
    got = bk.miller_values(*ops)
    want = bk.miller_values_plain(*ops)
    torch.cuda.synchronize()
    check(bool(((got >= 0) & (got < 2**21) & (got == got.floor())).all()),
          "bn254 kernel: output limbs are not canonical 21-bit limbs")
    k, p = bk.limbs_to_ints(got.cpu().numpy()), bk.limbs_to_ints(want.cpu().numpy())
    err = max(abs(int(a) - int(b)) for a, b in zip(k.ravel(), p.ravel()))
    check(err == 0, f"bn254 kernel != plain mod P on {int((k != p).any(axis=(1, 2)).sum())} lanes")
    cfg = bk.launch_config(n)
    print(f"bn254 launch at {n} lanes: {cfg}", flush=True)
    products = n * BN254_FP_MULS * BN254_FP_MUL_OPS
    t_b = bound_ms(products, n * BN254_LANE_BYTES, sms, clock_hz)
    return dict(
        max_abs_err=err,
        ms=time_cuda(lambda: bk.miller_values(*ops), 5),
        kernel_ms=kernel_ms(lambda: bk.miller_values(*ops), reps=5),
        plain_ms=time_cuda(lambda: bk.miller_values_plain(*ops), 1, warmup=0),
        bound_ms=t_b[0], bound_by=t_b[1],
        bound_ms_at_imad_wide_rate=products / (rates["IMAD.WIDE"]["rate"] * sms * clock_hz) * 1e3,
        shape=f"{n} lanes x 102 steps, 1 thread a lane ({cfg['blocks']} blocks of "
              f"{cfg['lanes_per_block']} lanes; {cfg['registers']} registers, "
              f"{cfg['local_bytes']} local bytes a thread)",
    )


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
        "bound_ms": t_b[0], "bound_by": t_b[1], "max_abs_err": err,
        "replaces": "cometbft_tpu/ops/merkle_kernel.py:214",
    }
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.crypto import merkle as host
    from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

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
        entry = re.search(r"entry function '_Z\w*?\d+(\w+_kernel)(IL[ib](\d+)EE)?", line)
        if entry:
            print(f"  {entry.group(1)}" + (f"<{entry.group(3)}>" if entry.group(3) else ""))
        elif line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    mixes = sass_mix(so)
    for g, mix in mixes.items():
        print(f"ladder SASS at {g} threads a lane (static instruction counts): {mix}", flush=True)
    from cometbft_tpu_torch.probe import issue_rates

    rates = issue_rates.measure(props.multi_processor_count, clock_hz)
    print(f"issue rates (thread-instructions a clock per SM, measured): {json.dumps(rates)}",
          flush=True)

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, N_LEAVES)
    print(f"fixtures: {N_SIGS} signatures, {N_LEAVES} leaves, {N_PARTS} parts of {PART_BYTES} "
          f"bytes in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bn_fix = bn254_fixtures(bn)
    print(f"fixtures: {N_VALIDATORS}-validator BN254 aggregate and {N_VOTES} votes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
               if k in ("threads_per_lane", "ms_by_group", "bound_ms_at_imad_wide_rate", "digests")
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
