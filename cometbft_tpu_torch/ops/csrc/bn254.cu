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
// mask, no branch. Fp2 products are Karatsuba (3 multiplies); a product
// by P's coordinates (Fp) is 2.
//
// What bounds it: operations. A lane runs 64 doubling steps (f^2: 21 Fp2
// products, the doubling: 12 and 2 by Fp, the line: 18) and 38 addition
// steps (36 set bits and the two Frobenius points: 13 and 2 by Fp, the
// line 18), plus 26 conversions into and out of Montgomery form: 13,760
// Fp multiplies of 136 products each, against 1,456 bytes in and 1,248
// out. The ate bit is a constant, uniform over the lanes, so the kernel
// branches on it (the reference computes the addition at every bit and
// selects); no warp diverges.
//
// Design, simple first: one thread a lane over a balanced grid (grid.cuh:
// one block per SM, ceil(n / SMs) lanes). A lane's state is about 200
// words (f 96, T 48, Q 32, P 16) before temporaries, so f and the
// Frobenius points live in local memory (L1), indexed by loops that are
// not unrolled, and T, P and the line stay in registers as far as the
// register file allows; ptxas's -v line says what spilled. One doubling
// step and one addition step are inlined once each, and the loop walks
// the step sequence, so the code stays small. At 8,192 lanes the card
// holds two warps an SM: latency, not issue, is what this design leaves on
// the table (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "grid.cuh"

using namespace cmtpu;

namespace {

constexpr int kMaxThreads = 128;
constexpr int kLimbs = 13;  // 21-bit limbs of the operands and the output

// p, little-endian 32-bit words; -p^-1 mod 2^32; R^2 mod p (R = 2^256)
__constant__ uint32_t kP[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr uint32_t kPInv = 0xe4866389u;
__constant__ uint32_t kR2[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
                                0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u};

// 6t + 2 below its top bit (bit 64): the 64 ate bits the loop walks, MSB first.
constexpr uint64_t kAteLow = 0x9d797039be763ba8ull;

struct Fp {
  uint32_t w[8];
};
struct Fp2 {
  Fp a, b;  // a + b u, u^2 = -1
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

__device__ __forceinline__ Fp2 f2_add(const Fp2& x, const Fp2& y) {
  return {fp_add(x.a, y.a), fp_add(x.b, y.b)};
}
__device__ __forceinline__ Fp2 f2_sub(const Fp2& x, const Fp2& y) {
  return {fp_sub(x.a, y.a), fp_sub(x.b, y.b)};
}
__device__ __forceinline__ Fp2 f2_dbl(const Fp2& x) { return f2_add(x, x); }
__device__ __forceinline__ Fp2 f2_neg(const Fp2& x) {
  const Fp z = fp_zero();
  return {fp_sub(z, x.a), fp_sub(z, x.b)};
}
__device__ __forceinline__ Fp2 f2_zero() { return {fp_zero(), fp_zero()}; }

// Karatsuba: (a - b, c - a - b) with a = x.a y.a, b = x.b y.b,
// c = (x.a + x.b)(y.a + y.b)
__device__ __forceinline__ Fp2 f2_mul(const Fp2& x, const Fp2& y) {
  const Fp a = fp_mul(x.a, y.a);
  const Fp b = fp_mul(x.b, y.b);
  const Fp c = fp_mul(fp_add(x.a, x.b), fp_add(y.a, y.b));
  return {fp_sub(a, b), fp_sub(fp_sub(c, a), b)};
}

// x times an element of Fp (P's coordinates)
__device__ __forceinline__ Fp2 f2_mul_fp(const Fp2& x, const Fp& s) {
  return {fp_mul(x.a, s), fp_mul(x.b, s)};
}

// x (9 + u) = (9 x.a - x.b) + (x.a + 9 x.b) u
__device__ __forceinline__ Fp2 f2_mul_xi(const Fp2& x) {
  Fp2 x8 = f2_dbl(f2_dbl(f2_dbl(x)));
  const Fp a9 = fp_add(x8.a, x.a);
  const Fp b9 = fp_add(x8.b, x.b);
  return {fp_sub(a9, x.b), fp_add(x.a, b9)};
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

__device__ __forceinline__ Fp2 load_fp2(const double* src) {
  return {load_fp(src), load_fp(src + kLimbs)};
}

// f^2 into g: the 21 products f_i f_j (i <= j, cross terms doubled), by
// output coefficient k = (i + j) mod 6; i + j >= 6 folds through w^6 = xi.
// Entries: i | j << 4 | (last of its k) << 8.
__constant__ uint16_t kSqrPairs[21] = {
    0x000, 0x051, 0x042, 0x133,                 // k = 0
    0x010, 0x052, 0x143,                        // k = 1
    0x020, 0x011, 0x053, 0x144,                 // k = 2
    0x030, 0x021, 0x154,                        // k = 3
    0x040, 0x031, 0x022, 0x155,                 // k = 4
    0x050, 0x041, 0x132,                        // k = 5
};

__device__ __forceinline__ void f12_sqr(const Fp2 (&f)[6], Fp2 (&g)[6]) {
  Fp2 lo = f2_zero(), hi = f2_zero();
  int k = 0;
#pragma unroll 1
  for (int e = 0; e < 21; ++e) {
    const int ent = kSqrPairs[e];
    const int i = ent & 15, j = (ent >> 4) & 15;
    Fp2 prod = f2_mul(f[i], f[j]);
    if (i != j) prod = f2_dbl(prod);
    if (i + j >= 6) {
      hi = f2_add(hi, prod);
    } else {
      lo = f2_add(lo, prod);
    }
    if (ent >> 8) {
      g[k++] = f2_add(lo, f2_mul_xi(hi));
      lo = f2_zero();
      hi = f2_zero();
    }
  }
}

// f times the sparse line c0 + c1 w + c3 w^3, into g
__device__ __forceinline__ void f12_mul_line(const Fp2 (&f)[6], const Fp2 (&c)[3], Fp2 (&g)[6]) {
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    Fp2 lo = f2_mul(f[k], c[0]);
    const Fp2 t1 = f2_mul(f[k >= 1 ? k - 1 : k + 5], c[1]);
    const Fp2 t3 = f2_mul(f[k >= 3 ? k - 3 : k + 3], c[2]);
    Fp2 hi = f2_zero();
    if (k >= 1) {
      lo = f2_add(lo, t1);
    } else {
      hi = t1;
    }
    if (k >= 3) {
      lo = f2_add(lo, t3);
    } else {
      hi = f2_add(hi, t3);
    }
    g[k] = f2_add(lo, f2_mul_xi(hi));
  }
}

// Double T = (X, Y, Z) and the tangent at P scaled by Z^6:
// c0 = 2 Y Z^3 yp, c1 = -3 X^2 Z^2 xp, c3 = 3 X^3 - 2 Y^2
// (bn254_kernel.py:_dbl_and_line, step for step).
__device__ __forceinline__ void dbl_and_line(Fp2& X, Fp2& Y, Fp2& Z, const Fp& xp, const Fp& yp,
                                             Fp2 (&line)[3]) {
  const Fp2 A = f2_mul(X, X);
  const Fp2 Bv = f2_mul(Y, Y);
  const Fp2 Z2 = f2_mul(Z, Z);
  const Fp2 C = f2_mul(Bv, Bv);
  const Fp2 xb = f2_add(X, Bv);
  const Fp2 XB = f2_mul(xb, xb);
  const Fp2 Z3p = f2_mul(Z2, Z);
  const Fp2 YZ = f2_mul(Y, Z);
  const Fp2 D = f2_dbl(f2_sub(f2_sub(XB, A), C));
  const Fp2 E = f2_add(f2_dbl(A), A);
  const Fp2 F2 = f2_mul(E, E);
  const Fp2 EZ2 = f2_mul(E, Z2);
  const Fp2 AX = f2_mul(A, X);
  const Fp2 YZ3 = f2_mul(Y, Z3p);
  const Fp2 X3 = f2_sub(F2, f2_dbl(D));
  line[2] = f2_sub(f2_add(f2_dbl(AX), AX), f2_dbl(Bv));
  const Fp2 EDX = f2_mul(E, f2_sub(D, X3));
  line[0] = f2_dbl(f2_mul_fp(YZ3, yp));
  line[1] = f2_neg(f2_mul_fp(EZ2, xp));
  Y = f2_sub(EDX, f2_dbl(f2_dbl(f2_dbl(C))));
  X = X3;
  Z = f2_dbl(YZ);
}

// Mixed add T + Q (Q affine) and the chord through Q at P, scaled by Z^3:
// c0 = H Z yp, c1 = -r xp, c3 = r xq - yq H Z
// (bn254_kernel.py:_add_and_line, step for step).
__device__ __forceinline__ void add_and_line(Fp2& X, Fp2& Y, Fp2& Z, const Fp2& xq, const Fp2& yq,
                                             const Fp& xp, const Fp& yp, Fp2 (&line)[3]) {
  const Fp2 Z2 = f2_mul(Z, Z);
  const Fp2 Z3p = f2_mul(Z2, Z);
  const Fp2 U2 = f2_mul(xq, Z2);
  const Fp2 S2 = f2_mul(yq, Z3p);
  const Fp2 H = f2_sub(U2, X);
  const Fp2 r = f2_sub(S2, Y);
  const Fp2 H2 = f2_mul(H, H);
  const Fp2 rsq = f2_mul(r, r);
  const Fp2 ZH = f2_mul(Z, H);
  const Fp2 H3 = f2_mul(H2, H);
  const Fp2 V = f2_mul(X, H2);
  line[2] = f2_sub(f2_mul(r, xq), f2_mul(yq, ZH));
  line[0] = f2_mul_fp(ZH, yp);
  line[1] = f2_neg(f2_mul_fp(r, xp));
  const Fp2 X3 = f2_sub(f2_sub(rsq, H3), f2_dbl(V));
  Y = f2_sub(f2_mul(r, f2_sub(V, X3)), f2_mul(Y, H3));
  X = X3;
  Z = ZH;
}

__global__ void __launch_bounds__(kMaxThreads)
    bn254_miller_kernel(const double* __restrict__ p1, const double* __restrict__ qa,
                        const double* __restrict__ q1a, const double* __restrict__ q2a,
                        double* __restrict__ out, int n, int lanes_per_block) {
  const int lane = blockIdx.x * lanes_per_block + threadIdx.x;
  if (threadIdx.x >= lanes_per_block || lane >= n) return;

  const Fp xp = load_fp(p1 + (size_t)lane * 2 * kLimbs);
  const Fp yp = load_fp(p1 + (size_t)lane * 2 * kLimbs + kLimbs);
  // Q, pi(Q), -pi^2(Q), each (x, y)
  Fp2 q[3][2];
  const double* srcs[3] = {qa, q1a, q2a};
#pragma unroll 1
  for (int s = 0; s < 6; ++s) {
    q[s >> 1][s & 1] = load_fp2(srcs[s >> 1] + (size_t)lane * 4 * kLimbs + (s & 1) * 2 * kLimbs);
  }
  Fp one = fp_zero();
  {
    Fp r2;
#pragma unroll
    for (int i = 0; i < 8; ++i) r2.w[i] = kR2[i];
    Fp plain_one = fp_zero();
    plain_one.w[0] = 1;
    one = fp_mul(plain_one, r2);  // R mod p
  }
  Fp2 X = q[0][0], Y = q[0][1], Z = {one, fp_zero()};
  Fp2 f[6], g[6];
#pragma unroll 1
  for (int k = 0; k < 6; ++k) f[k] = f2_zero();
  f[0].a = one;

  // Steps: for each ate bit (MSB first) a doubling, then an addition of Q
  // when the bit is set; then additions of pi(Q) and -pi^2(Q).
  int bit = 63, tail = 0;
  bool add_next = false;
#pragma unroll 1
  for (;;) {
    int which;  // -1: doubling; else the index of the point to add
    if (add_next) {
      which = 0;
      add_next = false;
    } else if (bit >= 0) {
      which = -1;
      add_next = (kAteLow >> bit) & 1;
      --bit;
    } else if (tail < 2) {
      which = ++tail;
    } else {
      break;
    }
    Fp2 line[3];
    if (which < 0) {
      f12_sqr(f, g);
#pragma unroll 1
      for (int k = 0; k < 6; ++k) f[k] = g[k];
      dbl_and_line(X, Y, Z, xp, yp, line);
    } else {
      add_and_line(X, Y, Z, q[which][0], q[which][1], xp, yp, line);
    }
    f12_mul_line(f, line, g);
#pragma unroll 1
    for (int k = 0; k < 6; ++k) f[k] = g[k];
  }

  double* dst = out + (size_t)lane * 12 * kLimbs;
#pragma unroll 1
  for (int k = 0; k < 6; ++k) {
    store_fp(dst + (2 * k) * kLimbs, f[k].a);
    store_fp(dst + (2 * k + 1) * kLimbs, f[k].b);
  }
}

cudaError_t grid_for(int n, Grid* g) { return balanced_grid(n, 32, kMaxThreads, g); }

}  // namespace

// Miller values of n lanes: p1 (n, 2, 13), qa / q1a / q2a (n, 2, 2, 13)
// float64 limbs in, out (n, 6, 2, 13) float64 canonical limbs.
extern "C" int cmtpu_bn254_miller(const double* p1, const double* qa, const double* q1a,
                                  const double* q2a, double* out, int n, void* stream) {
  Grid g;
  const cudaError_t err = grid_for(n, &g);
  if (err != cudaSuccess) return (int)err;
  bn254_miller_kernel<<<g.blocks, g.threads, 0, (cudaStream_t)stream>>>(p1, qa, q1a, q2a, out, n,
                                                                        g.lanes_per_block);
  return (int)cudaGetLastError();
}

// The launch for n lanes and the kernel's resources: out[5] = blocks,
// threads, lanes a block, registers a thread, local bytes a thread.
extern "C" int cmtpu_bn254_config(int n, int* out) {
  Grid g;
  cudaError_t err = grid_for(n, &g);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, bn254_miller_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.lanes_per_block;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}
