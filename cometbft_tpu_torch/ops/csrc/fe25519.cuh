// GF(2^255-19) elements as ten limbs of radix 2^25.5, whole in one
// thread: the representation shared by the ladder and decompress kernels,
// whose arithmetic runs on fe25519_group.cuh (limbs spread over a group of
// threads). This header holds what needs the whole element: constants,
// the canonical residue and the predicates on it, and the exchange with
// PyTorch.
//
// Representation: ten signed 32-bit limbs of radix 2^25.5 (ref10's layout:
// limb i sits at bit ceil(25.5 i), even limbs 26 bits wide, odd limbs 25).
// A product of two limbs fits a 32x32->64 multiply-add (IMAD.WIDE), so a
// field multiply is 100 of them, against 289 for the reference's 17x15-bit
// layout.
//
// The kernels exchange field elements with PyTorch in the reference's
// layout (int32[17, N], 15-bit limbs): fe_load17 accepts loose limbs (up to
// 2^16) and fe_store17 writes the canonical residue.

#pragma once

#include <cstdint>

namespace cmtpu {

struct fe {
  int32_t v[10];
};

__host__ __device__ constexpr int fe_off(int i) { return (51 * i + 1) / 2; }
__host__ __device__ constexpr int fe_width(int i) { return (i & 1) ? 25 : 26; }
// Limb holding bit b of the 255-bit value.
__host__ __device__ constexpr int fe_limb_of(int b) {
  return b < 26 ? 0 : b < 51 ? 1 : b < 77 ? 2 : b < 102 ? 3 : b < 128 ? 4
       : b < 153 ? 5 : b < 179 ? 6 : b < 204 ? 7 : b < 230 ? 8 : 9;
}

// Sequential floor carries over ten limbs; the carry out of limb 9 has
// weight 2^255 = 19 and wraps into limb 0, whose carry then moves once more.
template <typename T>
__device__ __forceinline__ void fe_carry_into(fe& h, T t[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int w = fe_width(i);
    const T c = t[i] >> w;
    t[i] -= c << w;
    if (i == 9) {
      t[0] += 19 * c;
    } else {
      t[i + 1] += c;
    }
  }
  const T c = t[0] >> 26;
  t[0] -= c << 26;
  t[1] += c;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = (int32_t)t[i];
}

__device__ __forceinline__ fe fe_d() {
  return fe{{56195235, 13857412, 51736253, 6949390, 114729, 24766616, 60832955,
             30306712, 48412415, 21499315}};
}
__device__ __forceinline__ fe fe_two_d() {
  return fe{{45281625, 27714825, 36363642, 13898781, 229458, 15978800, 54557047,
             27058993, 29715967, 9444199}};
}
__device__ __forceinline__ fe fe_sqrt_m1() {
  return fe{{34513072, 25610706, 9377949, 3500415, 12389472, 33281959, 41962654,
             31548777, 326685, 11406482}};
}

// Canonical residue in [0, p): two carry chains bring every limb within its
// width (value < 2^255), then one conditional subtraction of p.
__device__ __forceinline__ void fe_freeze(fe& h, const fe& f) {
  int32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = f.v[i];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const int w = fe_width(i);
      const int32_t c = t[i] >> w;
      t[i] -= c << w;
      if (i == 9) {
        t[0] += 19 * c;
      } else {
        t[i + 1] += c;
      }
    }
  }
  int32_t d[10];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int w = fe_width(i);
    const int32_t p = i == 0 ? (1 << 26) - 19 : (1 << w) - 1;
    const int32_t s = t[i] - p + borrow;
    borrow = s >> w;  // 0 or -1
    d[i] = s & ((1 << w) - 1);
  }
  const bool ge = borrow == 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = ge ? d[i] : t[i];
}

__device__ __forceinline__ bool fe_is_zero(const fe& f) {
  fe c;
  fe_freeze(c, f);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) acc |= c.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fe_parity(const fe& f) {
  fe c;
  fe_freeze(c, f);
  return c.v[0] & 1;
}

// int32[17, n] loose 15-bit limbs (each < 2^16) at column `lane` -> fe.
__device__ __forceinline__ void fe_load17(fe& h, const int32_t* __restrict__ src,
                                          int n, int lane) {
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const int b = 15 * i;
    const int k = fe_limb_of(b);
    t[k] += (int64_t)src[(size_t)i * n + lane] << (b - fe_off(k));
  }
  fe_carry_into(h, t);
}

// fe -> canonical residue as int32[17, n] 15-bit limbs at column `lane`:
// the limbs i = first, first + step, ... (all 17 by default).
__device__ __forceinline__ void fe_store17(int32_t* __restrict__ dst, const fe& f,
                                           int n, int lane, int first = 0, int step = 1) {
  fe c;
  fe_freeze(c, f);
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const int off = fe_off(k);
    const uint64_t v = (uint32_t)c.v[k];
    w[off / 64] |= v << (off % 64);
    if (off % 64 + fe_width(k) > 64) w[off / 64 + 1] |= v >> (64 - off % 64);
  }
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const int b = 15 * i;
    uint64_t x = w[b / 64] >> (b % 64);
    if (b % 64 > 49 && b / 64 + 1 < 4) x |= w[b / 64 + 1] << (64 - b % 64);
    if (i % step == first) dst[(size_t)i * n + lane] = (int32_t)(x & 0x7FFF);
  }
}

}  // namespace cmtpu
