// GF(2^255-19) arithmetic shared by a group of G threads (G = 1, 2 or 5):
// the __device__ field library of the ladder and decompress kernels.
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
// factors of the schoolbook product (x2 when both limbs are odd, x19 when
// i + j wraps past 2^255) go onto fr: a gathered limb (a >= L) wraps in
// every own column iff t*L + a < 10, one select at gather time; an own
// limb (a < L) wraps iff a > kk, known at compile time. 100/G multiply-adds
// a thread. Squaring (g_sqr, G = 1 or 5) takes 55/G: see there.
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

// Dedicated squaring: 55 limb products where g_mul has 100 (10 squares and
// the 45 cross terms once, doubled). Column k = t*L + kk sums f_i f_j over
// i + j = k (mod 10). With f rotated by R = t*L/2 (fh[a] = f[(R + a) mod
// 10]; R = 0 at G = 1, R = t at G = 5, so L must be even) those are the
// pairs a + b = kk + 10 e, e = 0 or 1: indices the compiler knows, each
// unordered pair taken once. The factors depend on R:
//   - x19 when i + j wraps past 2^255. Then i + j = k + 10 (e - wa - wb),
//     wa = [R + a >= 10], so it wraps iff e = 1 and R + max(a, b) < 10.
//   - x2 when i and j are both odd. a and b share a parity only when kk is
//     even, and then both are odd iff R + a is.
// The larger index's operand takes x19 and the odd x2 (below 2^31), the
// other the cross term's x2 (below 2^27.1); a column sums at most six
// products, below 2^60, as g_mul's do, so g_carry_wide applies unchanged.
template <int G>
__device__ __forceinline__ void g_sqr(gfe<G>& h, const gfe<G>& f, const grp<G>& q) {
  constexpr int L = 10 / G;
  static_assert(L % 2 == 0, "g_sqr rotates by t*L/2: G = 1 or 5");
  constexpr int kMaxRot = (G - 1) * (L / 2);
  const int rot = q.t * (L / 2);
  fe whole;
  g_gather(whole, f, q);
  int32_t fh[10];
#pragma unroll
  for (int a = 0; a < 10; ++a) fh[a] = whole.v[a];
  // Rotate left by rot, one conditional shift per bit (none at G = 1).
#pragma unroll
  for (int s = 1; s <= kMaxRot; s <<= 1) {
    const bool take = rot & s;
    int32_t r[10];
#pragma unroll
    for (int a = 0; a < 10; ++a) r[a] = take ? fh[(a + s) % 10] : fh[a];
#pragma unroll
    for (int a = 0; a < 10; ++a) fh[a] = r[a];
  }
  constexpr int kChains = L < 10 ? 2 : 1;
  int64_t t[L];
#pragma unroll
  for (int kk = 0; kk < L; ++kk) {
    int64_t s[kChains] = {};
    int n = 0;
#pragma unroll
    for (int a = 0; a < 10; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        if ((a + b) % 10 != kk) continue;
        const bool wrap = (a + b) >= 10 && rot + a < 10;
        const bool both_odd = kk % 2 == 0 && ((rot + a) & 1);
        int32_t x = wrap ? 19 * fh[a] : fh[a];
        x = both_odd ? 2 * x : x;
        const int32_t y = a == b ? fh[b] : 2 * fh[b];
        s[n++ % kChains] += (int64_t)x * y;
      }
    }
    t[kk] = kChains == 2 ? s[0] + s[kChains - 1] : s[0];
  }
  g_carry_wide(h, t, q);
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
