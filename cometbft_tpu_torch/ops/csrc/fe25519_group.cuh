// GF(2^255-19) arithmetic shared by a group of G threads (G = 1, 2 or 5):
// the __device__ field library of the fused ladder kernel.
//
// An element is fe25519.cuh's ten limbs of radix 2^25.5, split so that
// thread t of the group holds limbs t*L .. t*L+L-1 (L = 10/G). The G
// threads of a group sit on neighbouring lanes of one warp, and exchange
// limbs by __shfl_sync. Every operation is executed by all 32 threads of
// the warp with the same trip counts (full-mask shuffles); threads of a
// partial group at the end of a warp compute on garbage and store nothing.
//
// Multiply. Thread t computes its own L output columns k = t*L + kk. It
// gathers g whole, in limb order, and f rotated by its own offset
// (fr[a] = f[(t*L + a) mod 10]), so that the partner limb of fr[a] in
// column kk is g[(kk - a) mod 10], an index the compiler knows. The two
// factors of fe_mul (x2 when both limbs are odd, x19 when i + j wraps past
// 2^255) go onto fr: a gathered limb (a >= L) wraps in every own column iff
// t*L + a < 10, one select at gather time; an own limb (a < L) wraps iff
// a > kk, known at compile time. 100/G multiply-adds a thread.
//
// Carry. Parallel rounds, no chain through the limbs: every limb keeps
// its low bits and adds the carry out of the limb below, which for a
// thread's first limb comes from the previous thread by one shuffle (x19
// from limb 9 into limb 0). One round after an add, sub or neg; two after
// a multiply (64-bit, then 32-bit carries).
//
// Bounds. After every operation each limb is non-negative and exceeds its
// width by less than 2^15. Then 2 * 19 * an odd (25-bit) limb and 19 * an
// even (26-bit) limb stay below 2^31, a column sum of ten products below
// 2^60, its first-round carry below 2^36 (x19: 2^40.3) and the second
// round's carries below 2^14.3 (x19 from limb 9: 2^14.3).

#pragma once

#include <cstdint>

#include "fe25519.cuh"

namespace cmtpu {

template <int G>
struct gfe {
  int32_t v[10 / G];
};

// Where a thread sits in its group: rank t, the warp lane of rank 0, and
// the lane of the previous rank (source of the carry into its first limb).
template <int G>
struct grp {
  int t;
  int base;
  int prev;
};

template <int G>
__device__ __forceinline__ grp<G> make_grp(int lane_in_warp) {
  grp<G> q;
  q.t = lane_in_warp % G;
  q.base = lane_in_warp - q.t;
  q.prev = q.base + (q.t + G - 1) % G;
  return q;
}

constexpr unsigned kFullMask = 0xffffffffu;

// Width of global limb i: 26 bits even, 25 bits odd.
__device__ __forceinline__ int g_width(int i) { return 26 - (i & 1); }

// One parallel carry round over the group's limbs: every limb keeps its
// low w bits and takes the carry of the limb below it (the previous
// thread's last limb for a thread's first, x19 from limb 9 into limb 0).
template <int G, typename T, typename C>
__device__ __forceinline__ void g_carry_round(T t[10 / G], C lo[10 / G], const grp<G>& q) {
  constexpr int L = 10 / G;
  C c[L];
#pragma unroll
  for (int r = 0; r < L; ++r) {
    const int w = g_width(q.t * L + r);
    c[r] = (C)(t[r] >> w);
    lo[r] = (C)(t[r] & ((T(1) << w) - 1));
  }
  C cin = c[L - 1];
  if constexpr (G > 1) cin = __shfl_sync(kFullMask, c[L - 1], q.prev);
  lo[0] += q.t == 0 ? 19 * cin : cin;
#pragma unroll
  for (int r = 1; r < L; ++r) lo[r] += c[r - 1];
}

// After an add, sub or neg (limbs below 2^29): one round.
template <int G>
__device__ __forceinline__ void g_carry_narrow(gfe<G>& h, int32_t t[10 / G], const grp<G>& q) {
  g_carry_round<G, int32_t, int32_t>(t, h.v, q);
}

// After a multiply (column sums below 2^60): a round in 64 bits leaves
// limbs below 2^40, whose carries fit 32 bits for the second round.
template <int G>
__device__ __forceinline__ void g_carry_wide(gfe<G>& h, int64_t t[10 / G], const grp<G>& q) {
  int64_t u[10 / G];
  g_carry_round<G, int64_t, int64_t>(t, u, q);
  g_carry_round<G, int64_t, int32_t>(u, h.v, q);
}

__device__ __forceinline__ int32_t g_four_p(int i) {
  return i == 0 ? 4 * ((1 << 26) - 19) : 4 * ((1 << g_width(i)) - 1);
}

template <int G>
__device__ __forceinline__ void g_add(gfe<G>& h, const gfe<G>& f, const gfe<G>& g,
                                      const grp<G>& q) {
  int32_t t[10 / G];
#pragma unroll
  for (int r = 0; r < 10 / G; ++r) t[r] = f.v[r] + g.v[r];
  g_carry_narrow(h, t, q);
}

template <int G>
__device__ __forceinline__ void g_sub(gfe<G>& h, const gfe<G>& f, const gfe<G>& g,
                                      const grp<G>& q) {
  int32_t t[10 / G];
#pragma unroll
  for (int r = 0; r < 10 / G; ++r) t[r] = f.v[r] + g_four_p(q.t * (10 / G) + r) - g.v[r];
  g_carry_narrow(h, t, q);
}

template <int G>
__device__ __forceinline__ void g_neg(gfe<G>& h, const gfe<G>& f, const grp<G>& q) {
  int32_t t[10 / G];
#pragma unroll
  for (int r = 0; r < 10 / G; ++r) t[r] = g_four_p(q.t * (10 / G) + r) - f.v[r];
  g_carry_narrow(h, t, q);
}

template <int G>
__device__ __forceinline__ void g_mul(gfe<G>& h, const gfe<G>& f, const gfe<G>& g,
                                      const grp<G>& q) {
  constexpr int L = 10 / G;
  const int off = q.t * L;
  // g whole, in limb order.
  int32_t gg[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    if constexpr (G == 1) {
      gg[j] = g.v[j];
    } else {
      gg[j] = __shfl_sync(kFullMask, g.v[j % L], q.base + j / L);
    }
  }
  // f rotated by the thread's offset; plain (a1), doubled where the limb
  // is odd (d1), and for own limbs the x19 forms (a19, d19).
  int32_t a1[10], d1[10], a19[L], d19[L];
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const bool odd = (off + a) & 1;
    if (a < L) {
      const int o = a < L ? a : 0;  // (a constant index in every unrolled copy)
      a1[a] = f.v[o];
      a19[o] = 19 * f.v[o];
      d19[o] = odd ? 2 * a19[o] : a19[o];
    } else {
      const int32_t x = __shfl_sync(kFullMask, f.v[a % L], q.base + (q.t + a / L) % G);
      a1[a] = off + a < 10 ? 19 * x : x;
    }
    d1[a] = odd ? 2 * a1[a] : a1[a];
  }
  // Below G = 1's ten columns, each column sums in two halves, so that a
  // thread has at least four independent multiply-add chains.
  constexpr int kChains = L < 10 ? 2 : 1;
  int64_t t[L];
#pragma unroll
  for (int kk = 0; kk < L; ++kk) {
    int64_t s[kChains] = {};
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const int j = (kk - a + 10) % 10;
      const bool wrap_own = a < L && a > kk;
      int32_t x;
      const int o = a < L ? a : 0;
      if (j & 1) {
        x = wrap_own ? d19[o] : d1[a];
      } else {
        x = wrap_own ? a19[o] : a1[a];
      }
      s[a % kChains] += (int64_t)x * gg[j];
    }
    t[kk] = kChains == 2 ? s[0] + s[kChains - 1] : s[0];
  }
  g_carry_wide(h, t, q);
}

template <int G>
__device__ __forceinline__ void g_sq(gfe<G>& h, const gfe<G>& f, const grp<G>& q) {
  g_mul(h, f, f, q);
}

// The whole element in every thread of the group.
template <int G>
__device__ __forceinline__ void g_gather(fe& out, const gfe<G>& x, const grp<G>& q) {
  constexpr int L = 10 / G;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    if constexpr (G == 1) {
      out.v[j] = x.v[j];
    } else {
      out.v[j] = __shfl_sync(kFullMask, x.v[j % L], q.base + j / L);
    }
  }
}

// The thread's own limbs of a whole element.
template <int G>
__device__ __forceinline__ void g_slice(gfe<G>& x, const fe& whole, const grp<G>& q) {
  constexpr int L = 10 / G;
#pragma unroll
  for (int r = 0; r < L; ++r) {
    int32_t v = whole.v[r];
#pragma unroll
    for (int tt = 1; tt < G; ++tt) v = q.t == tt ? whole.v[tt * L + r] : v;
    x.v[r] = v;
  }
}

template <int G>
__device__ __forceinline__ void g_small(gfe<G>& x, int32_t c, const grp<G>& q) {
#pragma unroll
  for (int r = 0; r < 10 / G; ++r) x.v[r] = (q.t == 0 && r == 0) ? c : 0;
}

template <int G>
__device__ __forceinline__ void g_select(gfe<G>& h, bool take_a, const gfe<G>& a,
                                         const gfe<G>& b) {
#pragma unroll
  for (int r = 0; r < 10 / G; ++r) h.v[r] = take_a ? a.v[r] : b.v[r];
}

template <int G>
__device__ __forceinline__ bool g_is_zero(const gfe<G>& x, const grp<G>& q) {
  fe w;
  g_gather(w, x, q);
  return fe_is_zero(w);
}

}  // namespace cmtpu
