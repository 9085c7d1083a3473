// decompress: batched ZIP-215 point decoding from the raw encodings, on
// Hopper (sm_90a).
//
// Replaces cometbft_tpu/ops/edwards.py:decompress (over field25519's
// fe_pow2523) together with the unpack that feeds it,
// cometbft_tpu/ops/unpack.py:words_to_limbs255 (y = bits 0..254, sign =
// bit 255), and the concatenation of A and R into one 2N-lane pass
// (ed25519_kernel._verify_from_words): lanes 0..N-1 read A's words, lanes
// N..2N-1 R's, straight from pack_batch's int32[8, N] operands. The steps
// are the reference's: u = y^2 - 1, v = d y^2 + 1, the candidate root
// x = u v^3 (u v^7)^((p-5)/8), accept v x^2 == u directly or v x^2 == -u
// after the sqrt(-1) flip, reject x == 0 with sign 1, then fix x's parity
// to the sign. ZIP-215 rules carried: y >= p decodes (the arithmetic
// reduces it); all-zero padded lanes decode and are vetoed by the host
// mask, not here; lanes whose decoding failed still write defined output.
// Output: X, Y, Z, T as canonical 15-bit limbs, int32[4, 17, 2N] (the
// layout the ladder kernel reads), and ok as bool[2N].
//
// What bounds it: operations. A lane needs 255 squarings (251 in the
// (p-5)/8 chain) of 55 32x32->64 multiply-adds and 20 multiplies of 100,
// 16,025 products, against 32 bytes in and 273 out. The chain is serial,
// so what it costs is latency unless enough warps are in flight.
//
// Design: one thread a lane (kGroup = 1 over fe25519_group.cuh, whose
// carries run as parallel rounds), squarings by the dedicated g_sqr, and a
// balanced grid (grid.cuh): one block per SM with ceil(2N / SMs) lanes, so
// no SM runs a second wave. On the H100 at 20,480 lanes this ran 0.118 ms
// against 0.184 ms at kGroup = 5 (five times the warps, but shuffles and
// selects in every operation, and spills at the 64 or 72 registers a
// thread that 26 warps an SM leave; PERF.md). Converting the result to 17
// limbs needs the whole value: each thread of a group gathers it and
// writes every kGroup-th limb. Threads past the last lane, or of a partial
// group at the end of a warp, read lane 0 and store nothing, so every
// shuffle has its whole warp.

#include <cuda_runtime.h>

#include "fe25519.cuh"
#include "fe25519_group.cuh"
#include "grid.cuh"

using namespace cmtpu;

namespace {

constexpr int kGroup = 1;
constexpr int kMaxThreads = 256;

template <int G>
__device__ __forceinline__ void g_sqr_n(gfe<G>& h, const gfe<G>& f, int n, const grp<G>& q) {
  g_sqr(h, f, q);
#pragma unroll 1
  for (int i = 1; i < n; ++i) g_sqr(h, h, q);
}

// z^((p-5)/8) = z^(2^252 - 3): the reference's addition chain
// (cometbft_tpu/ops/field25519.py fe_pow2523), step for step.
template <int G>
__device__ __forceinline__ void g_pow2523(gfe<G>& out, const gfe<G>& z, const grp<G>& q) {
  gfe<G> t0, t1, t2, s;
  g_sqr(t0, z, q);                             // z^2
  g_sqr_n(s, t0, 2, q); g_mul(t1, z, s, q);    // z^9
  g_mul(t0, t0, t1, q);                        // z^11
  g_sqr(s, t0, q); g_mul(t0, t1, s, q);        // z^31
  g_sqr_n(s, t0, 5, q); g_mul(t0, s, t0, q);   // 2^10 - 1
  g_sqr_n(s, t0, 10, q); g_mul(t1, s, t0, q);  // 2^20 - 1
  g_sqr_n(s, t1, 20, q); g_mul(t2, s, t1, q);  // 2^40 - 1
  g_sqr_n(s, t2, 10, q); g_mul(t1, s, t0, q);  // 2^50 - 1
  g_sqr_n(s, t1, 50, q); g_mul(t2, s, t1, q);  // 2^100 - 1
  g_sqr_n(s, t2, 100, q); g_mul(t2, s, t2, q); // 2^200 - 1
  g_sqr_n(s, t2, 50, q); g_mul(t1, s, t1, q);  // 2^250 - 1
  g_sqr_n(s, t1, 2, q); g_mul(out, s, z, q);   // 2^252 - 3
}

// The thread's share of an element's canonical 17 limbs at column `lane`.
template <int G>
__device__ __forceinline__ void store_share(int32_t* dst, const gfe<G>& x, int m, int lane,
                                            bool store, const grp<G>& q) {
  fe w;
  g_gather(w, x, q);
  if (store) fe_store17(dst, w, m, lane, q.t, G);
}

template <int G>
__device__ __forceinline__ bool g_parity(const gfe<G>& x, const grp<G>& q) {
  fe w;
  g_gather(w, x, q);
  return fe_parity(w);
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
decompress_kernel(const uint32_t* __restrict__ a_words, const uint32_t* __restrict__ r_words,
                  int32_t* __restrict__ out, uint8_t* __restrict__ ok_out, int n,
                  int lanes_per_block) {
  constexpr int kLanesPerWarp = 32 / G;
  const int lane_in_warp = threadIdx.x % 32;
  const grp<G> q = make_grp<G>(lane_in_warp);
  const int group = lane_in_warp / G;
  const int local = (threadIdx.x / 32) * kLanesPerWarp + group;
  const int m = 2 * n;  // A then R, lane-stacked
  const int lane = blockIdx.x * lanes_per_block + local;
  const bool active = group < kLanesPerWarp && local < lanes_per_block && lane < m;
  const int ld = active ? lane : 0;

  // y = bits 0..254 of the encoding, straight into the ten limbs; the sign
  // is bit 255.
  const uint32_t* src = ld < n ? a_words + ld : r_words + (ld - n);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = src[(size_t)i * n];
  const bool sign = w[7] >> 31;
  fe yw;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int off = fe_off(k), j = off / 32, s = off % 32;
    uint32_t v = w[j] >> s;
    if (s + fe_width(k) > 32) v |= w[j + 1] << (32 - s);
    yw.v[k] = (int32_t)(v & ((1u << fe_width(k)) - 1));
  }

  gfe<G> y, y2, u, v, t, v3, v7, x, vxx, r, one;
  g_slice(y, yw, q);
  g_small(one, 1, q);
  g_sqr(y2, y, q);
  g_sub(u, y2, one, q);
  g_slice(t, fe_d(), q);
  g_mul(t, y2, t, q);
  g_add(v, t, one, q);
  g_sqr(t, v, q);
  g_mul(v3, t, v, q);
  g_sqr(t, v3, q);
  g_mul(v7, t, v, q);
  g_mul(t, u, v7, q);
  g_pow2523(r, t, q);
  g_mul(t, u, v3, q);
  g_mul(x, t, r, q);  // candidate root of u/v
  g_sqr(t, x, q);
  g_mul(vxx, v, t, q);
  g_sub(t, vxx, u, q);
  const bool ok_direct = g_is_zero(t, q);
  g_add(t, vxx, u, q);
  const bool ok_flip = g_is_zero(t, q);  // vxx == -u
  g_slice(r, fe_sqrt_m1(), q);
  g_mul(t, x, r, q);
  g_select(x, ok_flip && !ok_direct, t, x);
  const bool ok = (ok_direct || ok_flip) && !(g_is_zero(x, q) && sign);
  g_neg(t, x, q);
  g_select(x, g_parity(x, q) != sign, t, x);
  g_mul(t, x, y, q);

  const size_t plane = (size_t)17 * m;
  store_share(out, x, m, lane, active, q);
  store_share(out + plane, y, m, lane, active, q);
  store_share(out + 2 * plane, one, m, lane, active, q);
  store_share(out + 3 * plane, t, m, lane, active, q);
  if (active && q.t == 0) ok_out[lane] = ok ? 1 : 0;
}

template <int G>
int launch(const uint32_t* a_words, const uint32_t* r_words, int32_t* out, uint8_t* ok, int n,
           cudaStream_t stream) {
  Grid g;
  const cudaError_t err = balanced_grid(2 * n, 32 / G, kMaxThreads, &g);
  if (err != cudaSuccess) return (int)err;
  decompress_kernel<G><<<g.blocks, g.threads, 0, stream>>>(a_words, r_words, out, ok, n,
                                                           g.lanes_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// ZIP-215 decoding of A (a_words) and R (r_words), each int32[8, n] raw
// little-endian words: out int32[4, 17, 2n] canonical X, Y, Z, T of A then
// R, ok bool[2n].
extern "C" int cmtpu_decompress_words(const uint32_t* a_words, const uint32_t* r_words,
                                      int32_t* out, uint8_t* ok, int n, void* stream) {
  return launch<kGroup>(a_words, r_words, out, ok, n, (cudaStream_t)stream);
}
