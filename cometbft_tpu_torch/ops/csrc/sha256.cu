// sha256: batched SHA-256 for the RFC-6962 Merkle tree on Hopper (sm_90a).
//
// Replaces cometbft_tpu/ops/sha256_kernel.py:compress as the Merkle kernels
// run it: merkle_kernel._leaf_core (multi-block leaf hashes of 0x00 || leaf
// with per-lane block counts) and merkle_kernel._inner_core (0x01 || L || R,
// two blocks), which leaves_to_root_core chains into a whole tree. One
// __device__ compression under four __global__ entries:
//   - leaf:  pre-padded big-endian word blocks [B, 16, N] (lane-minor, so
//            neighbouring lanes read neighbouring words) and nblocks[N];
//            lanes stop after their own count;
//   - inner: two digest arrays [8, M] read through row and lane strides (so
//            the even and odd columns of one level are passed without a
//            copy), out [8, M];
//   - tree_chunks and tree_roots: a whole root in two launches, from the
//            raw leaves (one flat byte buffer and int64 offsets[n + 1]).
//            Launch 1 runs one block per aligned chunk of C leaves (C a
//            power of two, one thread a leaf): each thread pads and hashes
//            0x00 || leaf itself, for any length, and the block reduces its
//            chunk level by level in shared memory, an odd node promoted.
//            Launch 2 reduces the chunk roots the same way in one block,
//            C at a time, until one node is left.
//
// The levels entry (what Merkle proofs need; replaces
// cometbft_tpu/ops/merkle_kernel.py:235 _leaves_to_levels_core) is the same
// two launches with a non-null `levels` output: every node either launch
// makes, the leaf digests included, is also stored at its global place in
// int32[total, 8] (node-major, big-endian words), where level l of n leaves
// has ceil(n / 2^l) nodes and starts at row sum_{j<l} ceil(n / 2^j).
// Launch 1 writes levels 0..c (C = 2^c), launch 2 the levels above. A
// block's node j of level l is global node (first >> l) + j, first being
// the global index of its node 0 on its starting level (a multiple of C);
// a subtree root that is done before the block's top level (a ragged last
// chunk or group) is promoted unchanged up to it, as the level-by-level
// tree promotes an odd node. The stores are a template flag (kLevels), so
// the root path (null levels) runs the kernels without them: as a run-time
// branch on the pointer they raised the root's chunk launch from 56 to 72
// registers and from 0.0476 to 0.0534 ms (a traced headline call on an
// H100 80GB HBM3 at 700 W, chip_smoke.py).
//
// The digests entry (replaces cometbft_tpu/ops/merkle_kernel.py:214
// merkle_root_pow2 over _tree_root_jit :200, and the subtree and top
// reductions of cometbft_tpu/ops/sharded.py) is the same two launches from
// leaf digests instead of raw leaves: under the second template flag
// (kDigests) a thread of launch 1 loads its leaf's 8 big-endian words from
// int32[8, n] (word-major, so neighbouring threads read neighbouring words)
// instead of hashing a leaf; launch 2 is the root path's, unchanged. Any
// n >= 1, an odd node promoted as the raw-leaf tree does. Bound at 65,536
// digests: 65,535 inner nodes of two compressions, 2 MiB read:
// operations.
//
// Why two launches give the RFC-6962 root: pairing level by level with the
// odd node promoted makes node j of level h the root of leaves
// [j 2^h, min((j+1) 2^h, n)) (the reference's recursive split at the
// largest power of two below the count gives the same tree). So an aligned
// chunk of C = 2^c leaves is node j of level c, the ragged last chunk
// included, and the chunk roots are exactly level c.
//
// What bounds it: operations. A block is 64 rounds plus 48 schedule steps,
// about 2,200 32-bit operations, against 64 bytes read and 32 written.
//
// Design: one thread per lane (or leaf, or node pair), state and the
// 16-word schedule window in registers (rounds fully unrolled), round
// constants in __constant__ memory (uniform across lanes). The tree's
// nodes sit in shared memory word-major ([8][C]), so a level's reads and
// writes are conflict-free.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t K256[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ void iv(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + K256[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void __launch_bounds__(kThreads)
leaf_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ nblocks,
            uint32_t* __restrict__ out, int nb_max, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t st[8];
  iv(st);
  const int nb = max(0, min((int)nblocks[lane], nb_max));
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = blocks[((size_t)b * 16 + t) * n + lane];
    compress(st, w);
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) out[(size_t)t * n + lane] = st[t];
}

// SHA-256(0x01 || L || R) of two big-endian digests (merkle_kernel._inner_core).
__device__ __forceinline__ void inner_hash(uint32_t st[8], const uint32_t L[8], const uint32_t R[8]) {
  // Block 1: 0x01 || L || R[:31] as big-endian words.
  uint32_t w[16];
  w[0] = (0x01u << 24) | (L[0] >> 8);
#pragma unroll
  for (int i = 1; i < 8; ++i) w[i] = (L[i - 1] << 24) | (L[i] >> 8);
  w[8] = (L[7] << 24) | (R[0] >> 8);
#pragma unroll
  for (int i = 9; i < 16; ++i) w[i] = (R[i - 9] << 24) | (R[i - 8] >> 8);
  iv(st);
  compress(st, w);
  // Block 2: last byte of R || 0x80 pad || bit length 65 * 8 = 520.
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
  w[0] = (R[7] << 24) | (0x80u << 16);
  w[15] = 520;
  compress(st, w);
}

__global__ void __launch_bounds__(kThreads)
inner_kernel(const uint32_t* __restrict__ left, long long l_row, long long l_lane,
             const uint32_t* __restrict__ right, long long r_row, long long r_lane,
             uint32_t* __restrict__ out, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  uint32_t L[8], R[8], st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    L[i] = left[i * l_row + lane * l_lane];
    R[i] = right[i * r_row + lane * r_lane];
  }
  inner_hash(st, L, R);
#pragma unroll
  for (int t = 0; t < 8; ++t) out[(size_t)t * m + lane] = st[t];
}

// SHA-256(0x00 || leaf), padded here: byte q of the message is 0x00 at
// q = 0, leaf[q - 1] up to the leaf's end, then 0x80, zeros, and the 64-bit
// bit length in the last 8 bytes of the last block.
__device__ __forceinline__ void leaf_hash(uint32_t st[8], const uint8_t* __restrict__ leaf,
                                          long long len) {
  const long long mlen = len + 1;
  const long long nb = (mlen + 8) / 64 + 1;
  const unsigned long long bits = (unsigned long long)mlen * 8;
  iv(st);
#pragma unroll 1
  for (long long b = 0; b < nb; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long q = b * 64 + 4 * t + k;
        uint32_t byte = 0;
        if (q >= 1 && q <= len) byte = leaf[q - 1];
        if (q == mlen) byte = 0x80u;
        word = (word << 8) | byte;
      }
      w[t] = word;
    }
    if (b == nb - 1) {
      w[14] |= (uint32_t)(bits >> 32);
      w[15] |= (uint32_t)bits;
    }
    compress(st, w);
  }
}

// Where a block's nodes go in the levels output (out null: no levels).
struct Levels {
  uint32_t* out;    // int32[total, 8], or null
  long long base;   // first row of the current level
  long long count;  // nodes on the current level: ceil(n / 2^level)
  long long first;  // global index of the block's node 0 on the current level
};

__device__ __forceinline__ void level_up(Levels& lv) {
  lv.base += lv.count;
  lv.count = (lv.count + 1) / 2;
  lv.first >>= 1;
}

__device__ __forceinline__ void store_node(const Levels& lv, long long j, const uint32_t v[8]) {
  uint4* p = reinterpret_cast<uint4*>(lv.out + (lv.base + lv.first + j) * 8);
  p[0] = make_uint4(v[0], v[1], v[2], v[3]);
  p[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// Reduce m nodes (nodes[word * C + i], C = blockDim.x) to the root in slot
// 0, level by level, an odd node promoted. Every thread of the block calls
// it with the same m. With kLevels, each node made is stored too, and a
// root reached in fewer than `steps` levels is stored again on each level
// above, up to `steps` levels or the tree's top.
template <bool kLevels>
__device__ void reduce_nodes(uint32_t* nodes, int m, Levels lv, int steps) {
  const int C = blockDim.x, i = threadIdx.x;
  while (m > 1) {
    const int pairs = m / 2;
    uint32_t out[8];
    if (i < pairs) {
      uint32_t L[8], R[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        L[w] = nodes[w * C + 2 * i];
        R[w] = nodes[w * C + 2 * i + 1];
      }
      inner_hash(out, L, R);
    } else if (i == pairs && (m & 1)) {
#pragma unroll
      for (int w = 0; w < 8; ++w) out[w] = nodes[w * C + m - 1];
    }
    __syncthreads();
    if (i < (m + 1) / 2) {
#pragma unroll
      for (int w = 0; w < 8; ++w) nodes[w * C + i] = out[w];
    }
    if (kLevels) {
      level_up(lv);
      if (i < (m + 1) / 2) store_node(lv, i, out);
    }
    --steps;
    __syncthreads();
    m = (m + 1) / 2;
  }
  if (kLevels) {
    uint32_t root[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) root[w] = nodes[w * C];
    for (; steps > 0 && lv.count > 1; --steps) {
      level_up(lv);
      if (i == 0) store_node(lv, 0, root);
    }
  }
}

// Launch 1: block b hashes leaves [b C, min((b+1) C, n)) and writes their
// subtree root to roots[b] (8 big-endian words); with kLevels, also levels
// 0..c of its chunk.
// With kDigests, block b loads digests [b C, min((b+1) C, n)) from
// digests[8, n] instead (flat and offsets unused; kLevels is never set with
// it).
template <bool kLevels, bool kDigests>
__global__ void tree_chunks_kernel(const uint8_t* __restrict__ flat,
                                   const long long* __restrict__ offsets, int n,
                                   uint32_t* __restrict__ roots, uint32_t* __restrict__ levels,
                                   const uint32_t* __restrict__ digests) {
  extern __shared__ uint32_t nodes[];
  const int C = blockDim.x, i = threadIdx.x;
  const long long first = (long long)blockIdx.x * C;
  const int m = (int)min((long long)C, n - first);
  const Levels lv{levels, 0, n, first};
  if (kDigests) {
    if (i < m) {
#pragma unroll
      for (int w = 0; w < 8; ++w) nodes[w * C + i] = digests[(size_t)w * n + first + i];
    }
  } else if (i < m) {
    const long long off = offsets[first + i];
    uint32_t st[8];
    leaf_hash(st, flat + off, offsets[first + i + 1] - off);
#pragma unroll
    for (int w = 0; w < 8; ++w) nodes[w * C + i] = st[w];
    if (kLevels) store_node(lv, i, st);
  }
  __syncthreads();
  reduce_nodes<kLevels>(nodes, m, lv, __ffs(C) - 1);
  for (int w = i; w < 8; w += C) roots[(size_t)blockIdx.x * 8 + w] = nodes[w * C];
}

// Launch 2 (one block): reduce nc chunk roots in place, C at a time (group
// g's root goes to slot g, which no later group reads), until one is left;
// with kLevels, also every level above c of the n-leaf tree.
template <bool kLevels>
__global__ void tree_roots_kernel(uint32_t* __restrict__ roots, int nc,
                                  uint32_t* __restrict__ levels, int n) {
  extern __shared__ uint32_t nodes[];
  const int C = blockDim.x, i = threadIdx.x, c = __ffs(C) - 1;
  Levels lv{levels, 0, n, 0};
  if (kLevels) {
    for (int s = 0; s < c && lv.count > 1; ++s) level_up(lv);  // level c: the chunk roots
  }
  while (nc > 1) {
    const int groups = (nc + C - 1) / C;
    for (int g = 0; g < groups; ++g) {
      const int m = min(C, nc - g * C);
      if (i < m) {
#pragma unroll
        for (int w = 0; w < 8; ++w) nodes[w * C + i] = roots[((size_t)g * C + i) * 8 + w];
      }
      __syncthreads();
      Levels gl = lv;
      gl.first = (long long)g * C;
      reduce_nodes<kLevels>(nodes, m, gl, c);
      for (int w = i; w < 8; w += C) roots[(size_t)g * 8 + w] = nodes[w * C];
      __syncthreads();
    }
    if (kLevels) {
      for (int s = 0; s < c && lv.count > 1; ++s) level_up(lv);
    }
    nc = groups;
  }
}

}  // namespace

extern "C" int cmtpu_sha256_leaf(const uint32_t* blocks, const int32_t* nblocks,
                                 uint32_t* out, int nb_max, int n, void* stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  leaf_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(blocks, nblocks, out, nb_max, n);
  return (int)cudaGetLastError();
}

extern "C" int cmtpu_sha256_inner(const uint32_t* left, long long l_row, long long l_lane,
                                  const uint32_t* right, long long r_row, long long r_lane,
                                  uint32_t* out, int m, void* stream) {
  const int grid = (m + kThreads - 1) / kThreads;
  inner_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(left, l_row, l_lane, right,
                                                              r_row, r_lane, out, m);
  return (int)cudaGetLastError();
}

// The two launches of one root of n >= 1 leaves (flat bytes, offsets[n + 1])
// with chunks of C leaves (a power of two, 2..1024); roots is
// uint32[ceil(n / C), 8] scratch, and the root is left in roots[0..7].
// levels: null for the root alone, else int32[total, 8] for every level
// (the header above), written by the two launches together.
extern "C" int cmtpu_sha256_tree_chunks(const uint8_t* flat, const long long* offsets, int n,
                                        int chunk, uint32_t* roots, uint32_t* levels,
                                        void* stream) {
  const int nc = (n + chunk - 1) / chunk;
  const size_t smem = (size_t)chunk * 32;
  if (levels) {
    tree_chunks_kernel<true, false><<<nc, chunk, smem, (cudaStream_t)stream>>>(
        flat, offsets, n, roots, levels, nullptr);
  } else {
    tree_chunks_kernel<false, false><<<nc, chunk, smem, (cudaStream_t)stream>>>(
        flat, offsets, n, roots, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// Launch 1 of a root of n >= 1 leaf digests (int32[8, n], big-endian words)
// in chunks of C; roots as for the tree entry, whose launch 2
// (cmtpu_sha256_tree_roots with null levels) finishes the root.
extern "C" int cmtpu_sha256_digest_tree(const uint32_t* digests, int n, int chunk,
                                        uint32_t* roots, void* stream) {
  const int nc = (n + chunk - 1) / chunk;
  const size_t smem = (size_t)chunk * 32;
  tree_chunks_kernel<false, true><<<nc, chunk, smem, (cudaStream_t)stream>>>(
      nullptr, nullptr, n, roots, nullptr, digests);
  return (int)cudaGetLastError();
}

extern "C" int cmtpu_sha256_tree_roots(uint32_t* roots, int nc, int chunk, uint32_t* levels,
                                       int n, void* stream) {
  const size_t smem = (size_t)chunk * 32;
  if (levels) {
    tree_roots_kernel<true><<<1, chunk, smem, (cudaStream_t)stream>>>(roots, nc, levels, n);
  } else {
    tree_roots_kernel<false><<<1, chunk, smem, (cudaStream_t)stream>>>(roots, nc, nullptr, n);
  }
  return (int)cudaGetLastError();
}
