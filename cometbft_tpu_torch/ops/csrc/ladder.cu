// ladder: the whole per-lane Ed25519 check after decoding, on Hopper
// (sm_90a): [8]([s]B + [k](-A) - R) == identity, and both decodings.
//
// Replaces the TPU kernel cometbft_tpu/ops/pallas_ladder.py:_ladder_kernel
// (body _ladder_math, launched by _ladder_call through pl.pallas_call) and
// its XLA twin cometbft_tpu/ops/edwards.py:windowed_double_base_mult, plus
// the cofactored epilogue that follows them in
// cometbft_tpu/ops/ed25519_kernel.py:_verify_from_words (point_neg of A,
// add -R, three doublings, the identity test). Same formulas in the same
// order: -A from decompress's output; the per-lane [1..8](-A) table in
// precomp form (Y-X, Y+X, 2dT, Z) by the add_precomp chain; 64 windows MSB
// first, each 4 doublings, one add_precomp from the A table and one
// add_precomp_z1 from the constant [0..8]B table; then point_add of -R,
// three point_doubles and X == 0, Y == Z. So the accumulator agrees with
// the reference as canonical residues mod p, and the verdict bit for bit.
//
// What bounds it: operations. A lane needs 1,874 field multiplications
// (the table's 64, 64 windows x 28, the epilogue's 18) of 100 32x32->64
// multiply-adds and 1,036 squarings (64 windows x 16, the epilogue's 12)
// of 55, against ~1 KB a lane of inputs and outputs; the work is integer
// multiply-adds, not bytes. g_sq is a full g_mul here, so the kernel
// issues 100 products a squaring.
//
// Design: a group of G threads per lane (G = 1, 2 or 5, a template
// parameter), each owning 10/G limbs of every field element
// (fe25519_group.cuh), so 10,240 lanes fill G times as many warps. The
// [1..8](-A) table (1,280 B a lane) lives in dynamic shared memory, laid
// out [entry][coord][limb][thread] so a warp's 32 reads hit 32 banks
// whatever digit each lane selects; the [0..8]B table (1,440 B) is copied
// into shared memory by each block. The grid is one block per SM for each
// wave: lanes are spread evenly over whole waves of the card's SMs.
// Threads of a lane past n, or of the partial group at the end of a warp
// (G = 5), read lane 0 and store nothing, so every shuffle has its whole
// warp.

#include <cuda_runtime.h>

#include <mutex>

#include "fe25519.cuh"
#include "fe25519_group.cuh"

using namespace cmtpu;

namespace {

constexpr int kDigits = 64;
constexpr int kWindowBits = 4;
constexpr int kTableBWords = 9 * 4 * 10;
constexpr int kTableBBytes = kTableBWords * 4;

// Threads a block may hold, per group width: it caps the registers ptxas
// may give a thread (65,536 / this).
template <int G>
constexpr int max_threads() {
  return G == 1 ? 256 : G == 2 ? 384 : 512;
}

template <int G>
struct ge {
  gfe<G> X, Y, Z, T;
};
// Precomp form: c[0] = Y-X, c[1] = Y+X, c[2] = 2dT, c[3] = Z.
template <int G>
struct gp {
  gfe<G> c[4];
};

// dbl-2008-hwcd for a = -1 (edwards.point_double). r may alias p. T is
// computed only when the next step reads it (WithT): a doubling reads X, Y
// and Z alone, so the first three of a window's four doublings and the
// epilogue's three skip one multiply each; X, Y and Z are unchanged.
template <int G, bool WithT>
__device__ __forceinline__ void point_double(ge<G>& r, const ge<G>& p, const grp<G>& q) {
  gfe<G> a, b, zz, c, e, f, g, h, t;
  g_sq(a, p.X, q);
  g_sq(b, p.Y, q);
  g_sq(zz, p.Z, q);
  g_add(c, zz, zz, q);
  g_add(t, p.X, p.Y, q);
  g_sq(e, t, q);
  g_sub(e, e, a, q);
  g_sub(e, e, b, q);
  g_sub(g, b, a, q);
  g_sub(f, g, c, q);
  g_add(t, a, b, q);
  g_neg(h, t, q);
  g_mul(r.X, e, f, q);
  g_mul(r.Y, g, h, q);
  g_mul(r.Z, f, g, q);
  if (WithT) g_mul(r.T, e, h, q);
}

// The tail shared by the additions: from a, b, c and d = 2 Z1 Z2.
template <int G>
__device__ __forceinline__ void add_tail(ge<G>& r, const gfe<G>& a, const gfe<G>& b,
                                         const gfe<G>& c, const gfe<G>& d, const grp<G>& q) {
  gfe<G> e, f, g, h;
  g_sub(e, b, a, q);
  g_sub(f, d, c, q);
  g_add(g, d, c, q);
  g_add(h, b, a, q);
  g_mul(r.X, e, f, q);
  g_mul(r.Y, g, h, q);
  g_mul(r.Z, f, g, q);
  g_mul(r.T, e, h, q);
}

// edwards._add_precomp_core: complete hwcd addition against a precomputed
// point, zz = Z1*Z2 given. r may alias p.
template <int G>
__device__ __forceinline__ void add_precomp_core(ge<G>& r, const ge<G>& p, const gp<G>& pq,
                                                 const gfe<G>& zz, const grp<G>& q) {
  gfe<G> a, b, c, d, t;
  g_sub(t, p.Y, p.X, q);
  g_mul(a, t, pq.c[0], q);
  g_add(t, p.Y, p.X, q);
  g_mul(b, t, pq.c[1], q);
  g_mul(c, p.T, pq.c[2], q);
  g_add(d, zz, zz, q);
  add_tail(r, a, b, c, d, q);
}

template <int G>
__device__ __forceinline__ void add_precomp(ge<G>& r, const ge<G>& p, const gp<G>& pq,
                                            const grp<G>& q) {
  gfe<G> zz;
  g_mul(zz, p.Z, pq.c[3], q);
  add_precomp_core(r, p, pq, zz, q);
}

template <int G>
__device__ __forceinline__ void add_precomp_z1(ge<G>& r, const ge<G>& p, const gp<G>& pq,
                                               const grp<G>& q) {
  const gfe<G> zz = p.Z;
  add_precomp_core(r, p, pq, zz, q);
}

// edwards.point_add (add-2008-hwcd-3): c = (T1 * 2d) * T2. r may alias p.
template <int G>
__device__ __forceinline__ void point_add(ge<G>& r, const ge<G>& p, const ge<G>& p2,
                                          const gfe<G>& two_d, const grp<G>& q) {
  gfe<G> a, b, c, d, t, u;
  g_sub(t, p.Y, p.X, q);
  g_sub(u, p2.Y, p2.X, q);
  g_mul(a, t, u, q);
  g_add(t, p.Y, p.X, q);
  g_add(u, p2.Y, p2.X, q);
  g_mul(b, t, u, q);
  g_mul(t, p.T, two_d, q);
  g_mul(c, t, p2.T, q);
  g_mul(t, p.Z, p2.Z, q);
  g_add(d, t, t, q);
  add_tail(r, a, b, c, d, q);
}

template <int G>
__device__ __forceinline__ void to_precomp(gp<G>& pq, const ge<G>& p, const gfe<G>& two_d,
                                           const grp<G>& q) {
  g_sub(pq.c[0], p.Y, p.X, q);
  g_add(pq.c[1], p.Y, p.X, q);
  g_mul(pq.c[2], p.T, two_d, q);
  pq.c[3] = p.Z;
}

// The A table in shared memory: word (entry, coord, own limb r) of thread
// `tid` at ((entry * 4 + coord) * L + r) * threads + tid.
template <int G>
__device__ __forceinline__ void store_entry(int32_t* ta, int e, const gp<G>& pq) {
  constexpr int L = 10 / G;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < L; ++r)
      ta[((e * 4 + c) * L + r) * blockDim.x + threadIdx.x] = pq.c[c].v[r];
}

// Signed lookup, branch-free (every thread of the warp shuffles alike):
// entry |d|, negated (swap Y-X / Y+X, negate 2dT) when d < 0.
template <int G>
__device__ __forceinline__ void negate_if(gp<G>& pq, int d, const grp<G>& q) {
  gfe<G> n2;
  g_neg(n2, pq.c[2], q);
  const bool neg = d < 0;
  const gfe<G> c0 = pq.c[0];
  g_select(pq.c[0], neg, pq.c[1], c0);
  g_select(pq.c[1], neg, c0, pq.c[1]);
  g_select(pq.c[2], neg, n2, pq.c[2]);
}

// [|d|](-A) from the shared table; d == 0 gives the precomp identity
// (1, 1, 0, 1).
template <int G>
__device__ __forceinline__ void select_a(gp<G>& pq, const int32_t* ta, int d, const grp<G>& q) {
  constexpr int L = 10 / G;
  const int idx = min(abs(d), 8);
  const int e = max(idx - 1, 0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const int32_t id = (c != 2 && q.t == 0 && r == 0) ? 1 : 0;
      const int32_t v = ta[((e * 4 + c) * L + r) * blockDim.x + threadIdx.x];
      pq.c[c].v[r] = idx == 0 ? id : v;
    }
  }
  negate_if(pq, d, q);
}

template <int G>
__device__ __forceinline__ void select_b(gp<G>& pq, const int32_t* tb, int d, const grp<G>& q) {
  constexpr int L = 10 / G;
  const int idx = min(abs(d), 8);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < L; ++r) pq.c[c].v[r] = tb[(idx * 4 + c) * 10 + q.t * L + r];
  }
  negate_if(pq, d, q);
}

template <int G>
__device__ __forceinline__ void load_coord(gfe<G>& x, const int32_t* src, int m, int lane,
                                           const grp<G>& q) {
  fe w;
  fe_load17(w, src, m, lane);
  g_slice(x, w, q);
}

// Point of decompress's stacked output [4, 17, m] at column `lane`.
template <int G>
__device__ __forceinline__ void load_point(ge<G>& p, const int32_t* pt, int m, int lane,
                                           const grp<G>& q) {
  const size_t plane = (size_t)17 * m;
  load_coord(p.X, pt, m, lane, q);
  load_coord(p.Y, pt + plane, m, lane, q);
  load_coord(p.Z, pt + 2 * plane, m, lane, q);
  load_coord(p.T, pt + 3 * plane, m, lane, q);
}

template <int G>
__device__ __forceinline__ void store_coord(int32_t* dst, const gfe<G>& x, int n, int lane,
                                            bool store, const grp<G>& q) {
  fe w;
  g_gather(w, x, q);
  if (store) fe_store17(dst, w, n, lane);
}

template <int G>
__global__ void __launch_bounds__(max_threads<G>())
ladder_verify_kernel(const int32_t* __restrict__ s_dig, const int32_t* __restrict__ k_dig,
                     const int32_t* __restrict__ pt, const uint8_t* __restrict__ ok,
                     const int32_t* __restrict__ table_b, uint8_t* __restrict__ verdict,
                     int32_t* __restrict__ acc_out, int n, int lanes_per_block) {
  constexpr int kLanesPerWarp = 32 / G;
  extern __shared__ int32_t smem[];
  int32_t* tb = smem;
  int32_t* ta = smem + kTableBWords;
  for (int i = threadIdx.x; i < kTableBWords; i += blockDim.x) tb[i] = table_b[i];
  __syncthreads();

  const int lane_in_warp = threadIdx.x % 32;
  const grp<G> q = make_grp<G>(lane_in_warp);
  const int group = lane_in_warp / G;
  const int local = (threadIdx.x / 32) * kLanesPerWarp + group;
  const int lane = blockIdx.x * lanes_per_block + local;
  const bool active = group < kLanesPerWarp && local < lanes_per_block && lane < n;
  const int ld = active ? lane : 0;
  const int m = 2 * n;  // decompress ran on A then R, lane-stacked

  gfe<G> two_d;
  g_slice(two_d, fe_two_d(), q);

  ge<G> a;
  load_point(a, pt, m, ld, q);
  g_neg(a.X, a.X, q);
  g_neg(a.T, a.T, q);

  // [1..8](-A) in precomp form, by the reference's chain of additions.
  gp<G> pp, pq;
  to_precomp(pp, a, two_d, q);
  store_entry(ta, 0, pp);
  ge<G> cur = a;
#pragma unroll 1
  for (int e = 1; e < 8; ++e) {
    add_precomp(cur, cur, pp, q);
    to_precomp(pq, cur, two_d, q);
    store_entry(ta, e, pq);
  }

  ge<G> acc;
  g_small(acc.X, 0, q);
  g_small(acc.Y, 1, q);
  g_small(acc.Z, 1, q);
  g_small(acc.T, 0, q);
#pragma unroll 1
  for (int w = 0; w < kDigits; ++w) {
    const int row = kDigits - 1 - w;
#pragma unroll 1
    for (int j = 0; j < kWindowBits - 1; ++j) point_double<G, false>(acc, acc, q);
    point_double<G, true>(acc, acc, q);
    select_a(pq, ta, k_dig[(size_t)row * n + ld], q);
    add_precomp(acc, acc, pq, q);
    select_b(pq, tb, s_dig[(size_t)row * n + ld], q);
    add_precomp_z1(acc, acc, pq, q);
  }

  const bool store = active && q.t == 0;
  if (acc_out != nullptr) {
    const size_t plane = (size_t)17 * n;
    store_coord(acc_out, acc.X, n, lane, store, q);
    store_coord(acc_out + plane, acc.Y, n, lane, store, q);
    store_coord(acc_out + 2 * plane, acc.Z, n, lane, store, q);
    store_coord(acc_out + 3 * plane, acc.T, n, lane, store, q);
  }

  // Cofactored epilogue: acc + (-R), three doublings, identity test.
  ge<G> r;
  load_point(r, pt, m, ld + n, q);
  g_neg(r.X, r.X, q);
  g_neg(r.T, r.T, q);
  point_add(acc, acc, r, two_d, q);
#pragma unroll 1
  for (int j = 0; j < 3; ++j) point_double<G, false>(acc, acc, q);
  gfe<G> y_minus_z;
  g_sub(y_minus_z, acc.Y, acc.Z, q);
  const bool ident = g_is_zero(acc.X, q) & g_is_zero(y_minus_z, q);
  if (store) verdict[lane] = (ok[lane] != 0 && ok[lane + n] != 0 && ident) ? 1 : 0;
}

struct Config {
  int blocks, threads, smem, lanes_per_block, regs, local_bytes;
};

// What a launch shape depends on besides n, fixed for a device and G:
// read once, with the kernel's shared-memory ceiling raised once to the
// most any n can ask for.
struct Limits {
  int sms, max_warps, regs, local_bytes;
};

constexpr int kMaxDevices = 64;

template <int G>
cudaError_t limits(Limits* out) {
  constexpr int kWarpSmem = 32 * 8 * 4 * (10 / G) * 4;  // A table, bytes a warp
  static std::mutex mu;
  static Limits cache[kMaxDevices];
  static bool ready[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[dev]) {
    int sms, smem_optin;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, ladder_verify_kernel<G>);
    if (err != cudaSuccess) return err;
    Limits& l = cache[dev];
    l.sms = sms;
    l.max_warps = min(attr.maxThreadsPerBlock / 32, (smem_optin - kTableBBytes) / kWarpSmem);
    l.regs = attr.numRegs;
    l.local_bytes = (int)attr.localSizeBytes;
    err = cudaFuncSetAttribute(ladder_verify_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTableBBytes + l.max_warps * kWarpSmem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// Spread n lanes evenly over whole waves of one block per SM.
template <int G>
cudaError_t configure(int n, Config* cfg) {
  constexpr int kLanesPerWarp = 32 / G;
  constexpr int kWarpSmem = 32 * 8 * 4 * (10 / G) * 4;
  Limits l;
  const cudaError_t err = limits<G>(&l);
  if (err != cudaSuccess) return err;
  int waves = 1, lpb, warps;
  for (;;) {
    lpb = (n + l.sms * waves - 1) / (l.sms * waves);
    warps = (lpb + kLanesPerWarp - 1) / kLanesPerWarp;
    if (warps <= l.max_warps) break;
    ++waves;
  }
  cfg->lanes_per_block = lpb;
  cfg->blocks = (n + lpb - 1) / lpb;
  cfg->threads = warps * 32;
  cfg->smem = kTableBBytes + warps * kWarpSmem;
  cfg->regs = l.regs;
  cfg->local_bytes = l.local_bytes;
  return cudaSuccess;
}

template <int G>
int launch(const int32_t* s_dig, const int32_t* k_dig, const int32_t* pt, const uint8_t* ok,
           const int32_t* table_b, uint8_t* verdict, int32_t* acc, int n, cudaStream_t stream) {
  Config cfg;
  const cudaError_t err = configure<G>(n, &cfg);
  if (err != cudaSuccess) return (int)err;
  ladder_verify_kernel<G><<<cfg.blocks, cfg.threads, cfg.smem, stream>>>(
      s_dig, k_dig, pt, ok, table_b, verdict, acc, n, cfg.lanes_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// verdict[i] = ok[i] & ok[i + n] & ([8]([s_i]B + [k_i](-A_i) - R_i) == 0),
// with A and R the lane-stacked decompress output pt [4, 17, 2n] and ok
// [2n]; s_dig/k_dig int32[64, n]; table_b the [0..8]B precomp table in ten
// limbs [9, 4, 10]. acc, when not null, receives [s]B + [k](-A) as
// canonical 15-bit limbs [4, 17, n]. g is the group width (1, 2 or 5).
extern "C" int cmtpu_ladder_verify(const int32_t* s_dig, const int32_t* k_dig,
                                   const int32_t* pt, const uint8_t* ok, const int32_t* table_b,
                                   uint8_t* verdict, int32_t* acc, int n, int g, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (g) {
    case 1: return launch<1>(s_dig, k_dig, pt, ok, table_b, verdict, acc, n, st);
    case 2: return launch<2>(s_dig, k_dig, pt, ok, table_b, verdict, acc, n, st);
    case 5: return launch<5>(s_dig, k_dig, pt, ok, table_b, verdict, acc, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape cmtpu_ladder_verify picks for n lanes at group width g:
// out[6] = blocks, threads, dynamic shared bytes, lanes a block, registers
// a thread, local (spill) bytes a thread.
extern "C" int cmtpu_ladder_config(int n, int g, int* out) {
  Config cfg;
  cudaError_t err;
  switch (g) {
    case 1: err = configure<1>(n, &cfg); break;
    case 2: err = configure<2>(n, &cfg); break;
    case 5: err = configure<5>(n, &cfg); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = cfg.blocks;
  out[1] = cfg.threads;
  out[2] = cfg.smem;
  out[3] = cfg.lanes_per_block;
  out[4] = cfg.regs;
  out[5] = cfg.local_bytes;
  return 0;
}

extern "C" const char* cmtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
