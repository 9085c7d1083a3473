// bn254: per-lane optimal-ate Miller values on BN254, on Hopper (sm_90a).
//
// Replaces the device program of cometbft_tpu/ops/bn254_kernel.py:352
// (_build_program.run: a lax.scan over the ate bits of _f12_sqr,
// _dbl_and_line, _f12_sparse and _add_and_line, over _fp_mul's float64
// 13 x 21-bit limbs, then the two Frobenius lines). Each lane computes
// f_{6t+2,Q}(P) with the lines through pi(Q) and -pi^2(Q), by the
// reference's formulas: Jacobian G2 (T starts at (xq, yq, 1)), the tangent
// scaled by Z^6 and the chord by Z^3, sparse lines at w^0, w^1, w^3,
// Fp12 = Fp2[w]/(w^6 - xi), xi = 9 + u. So the value equals the plain
// version's (ops/bn254_kernel.py miller_values_plain) in Fp12 exactly; the
// limbs differ (canonical here, loose there).
//
// Input: P (n, 2, 13) and Q, pi(Q), -pi^2(Q) (n, 2, 2, 13), float64 limbs
// of 21 bits as _pack writes them (whole numbers, values below 2^256).
// Output: (n, 6, 2, 13) float64, canonical residues cut into 21-bit limbs.
//
// Representation: an Fp element is eight 32-bit words in Montgomery form
// (R = 2^256); a multiply is CIOS: 64 32x32->64 products for a*b, 8 for
// the quotient words and 64 for m*p, then one conditional subtraction, so
// every value stays canonical (< p). Add and subtract correct by p with a
// mask, no branch. The steps run them on PTX carry chains (below); the
// conversions into and out of Montgomery form and the lane's set-up keep
// 64-bit C.
//
// What bounds it: operations. A lane runs 64 doubling steps of 145 Fp
// multiplies (f^2: 6 Fp2 squares of 2 and 15 Karatsuba products of 3; the
// doubling 34; the tangent times f 54) and 38 addition steps of 94 (the
// addition 40, the chord times f 54), plus 26 conversions into and out of
// Montgomery form: 12,878 multiplies of 136 products each, against 1,456
// bytes in and 1,248 out.
//
// Design: a lane over a team of kTeam threads of one warp
// (bn254_schedule.cuh, generated by ops/bn254_schedule.py). The lane's
// state (f, T, the point being added, yp, 2 yp, -xp) and its temporaries
// are slots of eight words in dynamic shared memory, kSlots a lane; a
// thread holds only the operands and accumulator of its own multiply in
// registers, so nothing spills. A step is a table of positions: at each,
// every team thread does one multiply, or one add or subtract, or nothing,
// on the slots its entry names; a round of positions ends in __syncwarp
// over the team, and the generator lets no thread read in a round what
// another writes in it. f^2 (63 multiplies' worth, 57 here) and the
// doubling of T (34) are independent, so the doubling step overlaps them:
// 145 multiplies in 19 multiply positions, against 157 in a row for one
// thread a lane. Every team walks the same table, so a warp diverges only
// where a thread has nothing to do; the tables are staged in shared
// memory (a warp reading different __constant__ addresses serialises).
// The ate bit is a constant, uniform over the lanes, so the kernel
// branches on it (the reference computes the addition at every bit and
// selects). One block of up to 64 lanes (512 threads) a SM, a balanced
// grid: at 8,192 lanes 131 blocks of 63 lanes, 16 warps an SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "bn254_schedule.cuh"
#include "grid.cuh"

using namespace cmtpu;
using namespace bn254_schedule;

namespace {

static_assert(kTeam >= 1 && kTeam < 32 && 32 % kTeam == 0, "a team is a power of two inside a warp");
constexpr int kMaxLanes = 64;  // lanes a block: 512 threads at kTeam = 8
constexpr int kMaxThreads = kMaxLanes * kTeam;
constexpr int kLimbs = 13;  // 21-bit limbs of the operands and the output
constexpr int kTableBytes = (kTableWords * 4 + 15) / 16 * 16;
constexpr int kLaneBytes = kSlots * 32;

// p, little-endian 32-bit words; -p^-1 mod 2^32; R^2 mod p (R = 2^256)
__constant__ uint32_t kP[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr uint32_t kPInv = 0xe4866389u;
__constant__ uint32_t kR2[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
                                0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};

struct Fp {
  uint32_t w[8];
};

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0;
  return r;
}

// r = s - p if s >= p else s, for s < 2p given as eight words and a top word
__device__ __forceinline__ Fp fp_reduce_once(const Fp& s, uint32_t top) {
  Fp d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t t = (int64_t)s.w[i] - (int64_t)kP[i] + br;
    d.w[i] = (uint32_t)t;
    br = t >> 32;  // 0 or -1
  }
  // keep s when s < p: a borrow out of the eight words that top does not cover
  const uint32_t keep = br + (int64_t)top < 0 ? 0xffffffffu : 0u;
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = (s.w[i] & keep) | (d.w[i] & ~keep);
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return fp_reduce_once(s, (uint32_t)c);
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t t = (int64_t)a.w[i] - (int64_t)b.w[i] + br;
    d.w[i] = (uint32_t)t;
    br = t >> 32;
  }
  const uint32_t add = (uint32_t)br;  // all ones when a < b: add p back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)d.w[i] + (kP[i] & add);
    d.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return d;
}

// Montgomery product a b R^-1 mod p (CIOS), canonical in and out.
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.w[j] * b.w[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kPInv;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * kP[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  Fp s;
#pragma unroll
  for (int i = 0; i < 8; ++i) s.w[i] = t[i];
  return fp_reduce_once(s, t[8]);
}

// The steps' multiply, add and subtract on PTX carry chains (mad.lo.cc /
// madc.hi.cc, add.cc, sub.cc): a 32x32 product's halves are two full-rate
// IMADs with the carry in a flag, where the 64-bit form above is a
// half-rate IMAD.WIDE and two adds for its carry. Steps on the 64-bit form
// took 5.31-5.34 ms against 4.70-4.74 at 8,192 lanes (an H100 80GB HBM3 at
// 700 W, chip_smoke.py), so it was dropped from them.

// t[0..8] += a[0..7] * b: the products' low halves into t[0..7], then their
// high halves into t[1..8], one carry chain each (t < 2^288 throughout).
__device__ __forceinline__ void mad_row(uint32_t (&t)[9], const uint32_t (&a)[8], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b));
}

// s - p if s >= p else s, for s < 2p
__device__ __forceinline__ Fp fp_reduce_cc(const Fp& s) {
  Fp d;
  uint32_t br;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]), "=r"(d.w[4]), "=r"(d.w[5]),
        "=r"(d.w[6]), "=r"(d.w[7]), "=r"(br)
      : "r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3]), "r"(s.w[4]), "r"(s.w[5]), "r"(s.w[6]),
        "r"(s.w[7]), "r"(kP[0]), "r"(kP[1]), "r"(kP[2]), "r"(kP[3]), "r"(kP[4]), "r"(kP[5]),
        "r"(kP[6]), "r"(kP[7]));
  Fp r;  // br is all ones when s < p: keep s
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = (s.w[i] & br) | (d.w[i] & ~br);
  return r;
}

__device__ __forceinline__ Fp fp_mul_cc(const Fp& a, const Fp& b) {
  uint32_t t[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = kP[j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mad_row(t, a.w, b.w[i]);
    mad_row(t, p, t[0] * kPInv);  // t[0] becomes 0: shift it out
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  Fp s;
#pragma unroll
  for (int i = 0; i < 8; ++i) s.w[i] = t[i];
  return fp_reduce_cc(s);
}

__device__ __forceinline__ Fp fp_addsub_cc(const Fp& a, const Fp& b, bool sub) {
  Fp nb, s;
  asm("sub.cc.u32 %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.u32 %7, %15, %23;"
      : "=r"(nb.w[0]), "=r"(nb.w[1]), "=r"(nb.w[2]), "=r"(nb.w[3]), "=r"(nb.w[4]), "=r"(nb.w[5]),
        "=r"(nb.w[6]), "=r"(nb.w[7])
      : "r"(kP[0]), "r"(kP[1]), "r"(kP[2]), "r"(kP[3]), "r"(kP[4]), "r"(kP[5]), "r"(kP[6]),
        "r"(kP[7]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]),
        "r"(b.w[6]), "r"(b.w[7]));
  const uint32_t m = sub ? 0xffffffffu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) nb.w[i] = (nb.w[i] & m) | (b.w[i] & ~m);
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]), "=r"(s.w[4]), "=r"(s.w[5]),
        "=r"(s.w[6]), "=r"(s.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]),
        "r"(a.w[7]), "r"(nb.w[0]), "r"(nb.w[1]), "r"(nb.w[2]), "r"(nb.w[3]), "r"(nb.w[4]),
        "r"(nb.w[5]), "r"(nb.w[6]), "r"(nb.w[7]));
  return fp_reduce_cc(s);  // a + (p - b) or a + b, below 2p
}

// 13 whole float64 limbs of 21 bits (value below 2^256) -> Montgomery form
__device__ __forceinline__ Fp load_fp(const double* src) {
  Fp x;
  uint64_t acc = 0;
  int nb = 0, w = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    acc |= (uint64_t)(uint32_t)src[i] << nb;
    nb += 21;
    if (nb >= 32) {
      if (w < 8) x.w[w++] = (uint32_t)acc;
      acc >>= 32;
      nb -= 32;
    }
  }
  Fp r2;
#pragma unroll
  for (int i = 0; i < 8; ++i) r2.w[i] = kR2[i];
  return fp_mul(x, r2);
}

// Montgomery form -> canonical residue -> 13 float64 limbs of 21 bits
__device__ __forceinline__ void store_fp(double* dst, const Fp& x) {
  Fp one = fp_zero();
  one.w[0] = 1;
  const Fp v = fp_mul(x, one);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int bit = 21 * i, w = bit >> 5, off = bit & 31;
    uint32_t limb = w < 8 ? v.w[w] >> off : 0u;
    if (off > 11 && w + 1 < 8) limb |= v.w[w + 1] << (32 - off);
    dst[i] = (double)(limb & ((1u << 21) - 1));
  }
}

__device__ __forceinline__ Fp get(const uint4* st, uint32_t s) {
  const uint4 lo = st[2 * s], hi = st[2 * s + 1];
  return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void put(uint4* st, uint32_t s, const Fp& v) {
  st[2 * s] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  st[2 * s + 1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// One step of the team's schedule: thread t runs column t of the table's
// positions on its lane's slots st.
__device__ __forceinline__ void run_step(const uint32_t* tbl, int positions, uint4* st, int t,
                                         unsigned mask) {
#pragma unroll 1
  for (int p = 0; p < positions; ++p) {
    const uint32_t e = tbl[p * kTeam + t];
    const uint32_t op = (e >> 24) & 3u;
    if (op == kMul) {
      const Fp a = get(st, (e >> 8) & 255u), b = get(st, e & 255u);
      put(st, (e >> 16) & 255u, fp_mul_cc(a, b));
    } else if (op != kNop) {
      const Fp a = get(st, (e >> 8) & 255u), b = get(st, e & 255u);
      put(st, (e >> 16) & 255u, fp_addsub_cc(a, b, op == kSub));
    }
    if (e >> 31) __syncwarp(mask);
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    bn254_team_kernel(const double* __restrict__ p1, const double* __restrict__ qa,
                      const double* __restrict__ q1a, const double* __restrict__ q2a,
                      double* __restrict__ out, int n, int lanes_per_block) {
  extern __shared__ __align__(16) uint32_t smem[];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) smem[i] = kTable[i];
  __syncthreads();
  const int team = threadIdx.x / kTeam, t = threadIdx.x % kTeam;
  const int lane = blockIdx.x * lanes_per_block + team;
  if (team >= lanes_per_block || lane >= n) return;
  const unsigned mask = ((1u << kTeam) - 1u) << ((threadIdx.x & 31) & ~(kTeam - 1));
  uint4* st = reinterpret_cast<uint4*>(reinterpret_cast<char*>(smem) + kTableBytes) +
              (size_t)team * kSlots * 2;
  const double* q = qa + (size_t)lane * 4 * kLimbs;

  // the lane's state: -xp, yp, 2 yp; Q and T = (xq, yq, 1); f = 1
#pragma unroll 1
  for (int job = t; job < 8; job += kTeam) {
    if (job == 0) {
      put(st, kSlotNxp, fp_sub(fp_zero(), load_fp(p1 + (size_t)lane * 2 * kLimbs)));
    } else if (job == 1) {
      const Fp yp = load_fp(p1 + (size_t)lane * 2 * kLimbs + kLimbs);
      put(st, kSlotYp, yp);
      put(st, kSlotYp2, fp_add(yp, yp));
    } else if (job < 6) {
      const Fp v = load_fp(q + (job - 2) * kLimbs);  // xq.a, xq.b, yq.a, yq.b
      put(st, kSlotQ + job - 2, v);
      put(st, kSlotX + job - 2, v);  // X and Y follow each other
    } else if (job == 6) {
      Fp one = fp_zero();
      one.w[0] = 1;
      Fp r2;
#pragma unroll
      for (int i = 0; i < 8; ++i) r2.w[i] = kR2[i];
      one = fp_mul(one, r2);  // R mod p
      put(st, kSlotZ, one);
      put(st, kSlotZ + 1, fp_zero());
      put(st, kSlotF, one);
    } else {
#pragma unroll 1
      for (int k = 1; k < 12; ++k) put(st, kSlotF + k, fp_zero());
    }
  }
  __syncwarp(mask);

  const uint32_t* dbl = smem;
  const uint32_t* add = smem + kDblPositions * kTeam;
#pragma unroll 1
  for (int bit = kAteLen - 1; bit >= 0; --bit) {
    run_step(dbl, kDblPositions, st, t, mask);
    if ((kAteBits >> bit) & 1) run_step(add, kAddPositions, st, t, mask);
  }
  // the two Frobenius lines: pi(Q), then -pi^2(Q), in the point's slots
#pragma unroll 1
  for (int f = 0; f < 2; ++f) {
    const double* src = (f ? q2a : q1a) + (size_t)lane * 4 * kLimbs;
    for (int c = t; c < 4; c += kTeam) put(st, kSlotQ + c, load_fp(src + c * kLimbs));
    __syncwarp(mask);
    run_step(add, kAddPositions, st, t, mask);
  }

  double* dst = out + (size_t)lane * 12 * kLimbs;
  for (int s = t; s < 12; s += kTeam) store_fp(dst + s * kLimbs, get(st, kSlotF + s));
}

// The launch for n lanes: a balanced grid of at most kMaxLanes lanes a
// block, and fewer where the card's shared memory holds fewer; smem gets
// the block's dynamic shared memory.
cudaError_t grid_for(int n, Grid* g, int* smem) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int lanes_per_warp = 32 / kTeam;
  int max_lanes = (optin - kTableBytes) / kLaneBytes;
  if (max_lanes > kMaxLanes) max_lanes = kMaxLanes;
  if (max_lanes < lanes_per_warp) return cudaErrorInvalidConfiguration;
  err = balanced_grid(n, lanes_per_warp, max_lanes / lanes_per_warp * 32, g);
  *smem = kTableBytes + g->lanes_per_block * kLaneBytes;
  return err;
}

}  // namespace

// Miller values of n lanes: p1 (n, 2, 13), qa / q1a / q2a (n, 2, 2, 13)
// float64 limbs in, out (n, 6, 2, 13) float64 canonical limbs.
extern "C" int cmtpu_bn254_miller(const double* p1, const double* qa, const double* q1a,
                                  const double* q2a, double* out, int n, void* stream) {
  Grid g;
  int smem;
  cudaError_t err = grid_for(n, &g, &smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bn254_team_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bn254_team_kernel<<<g.blocks, g.threads, smem, (cudaStream_t)stream>>>(p1, qa, q1a, q2a, out,
                                                                         n, g.lanes_per_block);
  return (int)cudaGetLastError();
}

// The launch for n lanes and the kernel's resources: out[8] = blocks,
// threads, lanes a block, registers a thread, local bytes a thread, threads
// a lane, dynamic shared bytes a block, slots a lane.
extern "C" int cmtpu_bn254_config(int n, int* out) {
  Grid g;
  int smem;
  cudaError_t err = grid_for(n, &g, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, bn254_team_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.lanes_per_block;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = kTeam;
  out[6] = smem;
  out[7] = kSlots;
  return 0;
}
