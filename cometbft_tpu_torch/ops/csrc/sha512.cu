// sha512: the challenge scalars of batched Ed25519 verification on Hopper
// (sm_90a): SHA-512 of R || A || M, k = digest mod L, and the signed
// radix-16 digits of k and s that the ladder reads.
//
// Replaces cometbft_tpu/ops/sha512_kernel.py:hash_blocks_core (its
// compress, 80 rounds over 64-bit words emulated as hi/lo uint32 pairs),
// the head and tail verify_core wraps around it (the transpose + byte swap
// of the host pack buffer into big-endian block words, digest_to_le_words),
// and the scalar half of the unpack stage that follows:
// cometbft_tpu/ops/unpack.py:digest_words_to_digits (digest mod L, then the
// recode) and :scalar_words_to_digits (the recode of s). Input: the pack
// buffer as little-endian uint32 words, row per lane ([N, B*32]), per-lane
// block counts, and s as int32[8, N] words; lanes stop after their own
// count, so a lane with nblocks = 0 (padding) reduces the IV. A second
// entry takes the digests as int32[16, N] words instead (the host-hash
// program) and skips the hash. Output: s and k digits, int32[64, N] each,
// in [-8, 7], row w of weight 16^w.
//
// The reduction works on the 512-bit digest as eight 64-bit words: three
// folds by 2^252 = -c (mod L), c = L - 2^252 < 2^125, each computing
// lo + M - hi*c with M a multiple of L (L << 133, L << 7, L) above hi*c,
// so nothing goes negative (bounds 2^386, 2^260, 2L), then one conditional
// subtraction of L. The recode is the add-8s identity: t = v + 0x88..8
// (below 2^256 for v < 2^253), digit w = nibble w of t minus 8. The value
// mod L is unique, so the digits equal the reference's bit for bit,
// whatever the representation.
//
// What bounds it: operations. A block is 80 rounds and 64 schedule steps of
// 64-bit adds, rotates and logic, about 5,680 32-bit operations; the
// reduction and the two recodes add about 600 a lane, against 128 bytes a
// block and 548 a lane in and out.
//
// Design: one thread per lane, state and the 16-word schedule window in
// registers (the 80-round loop fully unrolled so the window indices are
// static), round constants in __constant__ memory (every lane reads the
// same one at once), the reduction in registers after the last block. The
// grid is balanced (grid.cuh): one block per SM with ceil(N / SMs) lanes,
// so every SM has work.

#include <cuda_runtime.h>
#include <cstdint>

#include "grid.cuh"

using namespace cmtpu;

namespace {

constexpr int kThreads = 256;

__constant__ uint64_t K512[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}
__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__device__ __forceinline__ void compress(uint64_t st[8], uint64_t w[16]) {
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint64_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint64_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(x15, 1) ^ rotr64(x15, 8) ^ (x15 >> 7);
      const uint64_t s1 = rotr64(x2, 19) ^ rotr64(x2, 61) ^ (x2 >> 6);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = h + S1 + ch + K512[t] + wt;
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint64_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return ((uint64_t)bswap32((uint32_t)x) << 32) | bswap32((uint32_t)(x >> 32));
}

// Word i of L (little-endian 64-bit words; zero outside 0..3). Words 0 and
// 1 are c.
__host__ __device__ constexpr uint64_t l_word(int i) {
  return i == 0 ? 0x5812631A5CF5D3EDull : i == 1 ? 0x14DEF9DEA2F79CD6ull
       : i == 3 ? 0x1000000000000000ull : 0;
}

// Word i of L << s.
__host__ __device__ constexpr uint64_t l_shl_word(int s, int i) {
  return (l_word(i - s / 64) << (s % 64)) |
         (s % 64 ? l_word(i - s / 64 - 1) >> (64 - s % 64) : 0);
}

// One fold: r = (a mod 2^252) + (L << kShift) - (a >> 252) * c, with the
// NH words of a >> 252 (enough for a's bound) and NR words of r.
template <int NA, int NH, int NR, int kShift>
__device__ __forceinline__ void fold(uint64_t r[NR], const uint64_t a[NA]) {
  static_assert(NH + 2 <= NR, "hi * c must fit the result");
  uint64_t hi[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i)
    hi[i] = (a[3 + i] >> 60) | (4 + i < NA ? a[min(4 + i, NA - 1)] << 4 : 0);
  uint64_t p[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) p[i] = 0;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint64_t lo = hi[i] * l_word(j);
      uint64_t up = __umul64hi(hi[i], l_word(j));
      lo += p[i + j];
      up += lo < p[i + j];
      lo += carry;
      up += lo < carry;
      p[i + j] = lo;
      carry = up;
    }
    p[i + 2] = carry;
  }
  uint64_t cy = 0, bw = 0;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const uint64_t lo = i < 3 ? a[i] : i == 3 ? a[3] & ((1ull << 60) - 1) : 0;
    const uint64_t m = l_shl_word(kShift, i);
    uint64_t s = lo + m;
    uint64_t c = s < m;
    s += cy;
    c += s < cy;
    cy = c;
    const uint64_t d = s - p[i];
    uint64_t b = s < p[i];
    r[i] = d - bw;
    b += d < bw;
    bw = b;
  }
}

// x (eight words, below 2^512) mod L.
__device__ __forceinline__ void mod_l(uint64_t out[4], const uint64_t x[8]) {
  uint64_t r1[7], r2[5], r3[4];
  fold<8, 5, 7, 133>(r1, x);   // < 2^252 + (L << 133) < 2^386
  fold<7, 3, 5, 7>(r2, r1);    // < 2^252 + (L << 7) < 2^260
  fold<5, 1, 4, 0>(r3, r2);    // < 2^252 + L < 2L
  uint64_t d[4], bw = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t l = l_word(i);
    const uint64_t t = r3[i] - l;
    uint64_t b = r3[i] < l;
    d[i] = t - bw;
    b += t < bw;
    bw = b;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = bw == 0 ? d[i] : r3[i];
}

// Signed radix-16 digits of v (< 2^253) into dst[64, n] at column lane.
__device__ __forceinline__ void recode(int32_t* __restrict__ dst, const uint64_t v[4], int n,
                                       int lane) {
  constexpr uint64_t kEights = 0x8888888888888888ull;
  uint64_t cy = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint64_t t = v[w] + kEights;
    uint64_t c = t < kEights;
    t += cy;
    c += t < cy;
    cy = c;
#pragma unroll
    for (int d = 0; d < 16; ++d)
      dst[(size_t)(16 * w + d) * n + lane] = (int32_t)((t >> (4 * d)) & 15) - 8;
  }
}

// 64-bit word j of a little-endian int32[2k, n] operand at column lane.
__device__ __forceinline__ uint64_t word64(const uint32_t* __restrict__ src, int j, int n,
                                           int lane) {
  return ((uint64_t)src[(size_t)(2 * j + 1) * n + lane] << 32) | src[(size_t)(2 * j) * n + lane];
}

// kHash: k = SHA-512 of the lane's pack-buffer row; else k from k_words.
template <bool kHash>
__global__ void __launch_bounds__(kThreads)
digits_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ nblocks, int wpl,
              const uint32_t* __restrict__ k_words, const uint32_t* __restrict__ s_words,
              int32_t* __restrict__ s_dig, int32_t* __restrict__ k_dig, int n,
              int lanes_per_block) {
  const int lane = blockIdx.x * lanes_per_block + threadIdx.x;
  if (threadIdx.x >= lanes_per_block || lane >= n) return;
  uint64_t k[8];
  if constexpr (kHash) {
    uint64_t st[8] = {
        0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
        0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
        0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
    const int nb = max(0, min((int)nblocks[lane], wpl / 32));
    const uint4* row = reinterpret_cast<const uint4*>(words + (size_t)lane * wpl);
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      uint64_t w[16];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 v = row[b * 8 + q];  // 4 LE words = 2 big-endian 64-bit words
        w[2 * q] = ((uint64_t)bswap32(v.x) << 32) | bswap32(v.y);
        w[2 * q + 1] = ((uint64_t)bswap32(v.z) << 32) | bswap32(v.w);
      }
      compress(st, w);
    }
    // The digest is the state words big-endian; k reads it little-endian.
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = bswap64(st[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = word64(k_words, j, n, lane);
  }
  uint64_t v[4];
  mod_l(v, k);
  recode(k_dig, v, n, lane);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = word64(s_words, j, n, lane);
  recode(s_dig, v, n, lane);
}

template <bool kHash>
int launch(const uint32_t* words, const int32_t* nblocks, int wpl, const uint32_t* k_words,
           const uint32_t* s_words, int32_t* s_dig, int32_t* k_dig, int n, void* stream) {
  Grid g;
  const cudaError_t err = balanced_grid(n, 32, kThreads, &g);
  if (err != cudaSuccess) return (int)err;
  digits_kernel<kHash><<<g.blocks, g.threads, 0, (cudaStream_t)stream>>>(
      words, nblocks, wpl, k_words, s_words, s_dig, k_dig, n, g.lanes_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// s and k digits (int32[64, n] each) from the pack buffer words [n, wpl]
// (wpl a multiple of 32), block counts int32[n] and s words int32[8, n].
extern "C" int cmtpu_challenge_digits(const uint32_t* words, const int32_t* nblocks, int wpl,
                                      const uint32_t* s_words, int32_t* s_dig, int32_t* k_dig,
                                      int n, void* stream) {
  return launch<true>(words, nblocks, wpl, nullptr, s_words, s_dig, k_dig, n, stream);
}

// The same from the digests, int32[16, n] little-endian words, unhashed.
extern "C" int cmtpu_scalar_digits(const uint32_t* k_words, const uint32_t* s_words,
                                   int32_t* s_dig, int32_t* k_dig, int n, void* stream) {
  return launch<false>(nullptr, nullptr, 0, k_words, s_words, s_dig, k_dig, n, stream);
}
