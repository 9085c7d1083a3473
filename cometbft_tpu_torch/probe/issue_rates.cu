// Throughput probes for the integer instructions the field arithmetic of
// the ladder and decompress kernels runs on (sm_90a). Each thread runs
// kChains independent dependency chains, kRounds rounds a loop iteration,
// one probed instruction a chain and round, written as inline PTX with a
// data dependence the assembler cannot fold away. Operands come from
// global memory, so no probed instruction runs outside the loop, and are
// offset by the thread index, so no chain is warp-uniform (ptxas moves
// uniform chains to the uniform datapath: UIMAD.WIDE); what ptxas made of
// each probe is read back from its SASS by the caller.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChains = 8;
constexpr int kRounds = 4;

enum Kind { kWide = 0, kWideU32 = 1, kImad = 2, kShfl = 3, kLop3 = 4 };

template <int K>
__global__ void __launch_bounds__(256) probe_kernel(const uint32_t* __restrict__ in,
                                                    uint64_t* __restrict__ out, int iters) {
  uint32_t x[kChains];
  uint64_t acc[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    x[k] = in[k] + threadIdx.x;
    acc[k] = in[kChains + k] + threadIdx.x;
  }
  const uint32_t src = (threadIdx.x + 1) & 31;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        // multiply, then add: ptxas fuses the pair into one IMAD.WIDE with
        // a 64-bit addend (a PTX mad.wide it splits into IMAD.WIDE and a
        // separate 64-bit add); the multiplicand is the next chain's low word
        if (K == kWide)
          asm volatile("{ .reg .u32 lo; .reg .s64 p; cvt.u32.u64 lo, %1;"
                       " mul.wide.s32 p, lo, %2; add.s64 %0, %0, p; }"
                       : "+l"(acc[k]) : "l"(acc[(k + 1) % kChains]), "r"(x[k]));
        if (K == kWideU32)
          asm volatile("{ .reg .u32 lo; .reg .u64 p; cvt.u32.u64 lo, %1;"
                       " mul.wide.u32 p, lo, %2; add.u64 %0, %0, p; }"
                       : "+l"(acc[k]) : "l"(acc[(k + 1) % kChains]), "r"(x[k]));
        if (K == kImad)
          asm volatile("mad.lo.u32 %0, %0, %0, %1;" : "+r"(x[k]) : "r"(x[(k + 1) % kChains]));
        if (K == kShfl)
          asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(x[k]) : "r"(src));
        if (K == kLop3)  // majority of three chains: nothing to fold
          asm volatile("lop3.b32 %0, %0, %1, %2, 0xe8;"
                       : "+r"(x[k]) : "r"(x[(k + 1) % kChains]), "r"(x[(k + 2) % kChains]));
      }
    }
  }
  if (in[2 * kChains] != 0) {  // never true for the caller's input: keeps the results live
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kChains; ++k) out[t * kChains + k] = acc[k] + x[k];
  }
}

}  // namespace

// Probed instructions a thread runs in one launch: iters x rounds x chains.
extern "C" long long cmtpu_probe_ops_per_thread(int iters) {
  return (long long)iters * kRounds * kChains;
}

// Launch probe `kind` (0 IMAD.WIDE, 1 IMAD.WIDE.U32, 2 IMAD, 3 SHFL.IDX,
// 4 LOP3) on blocks x 256 threads; in holds 2 * 8 + 1 words, the last 0.
extern "C" int cmtpu_probe(int kind, int blocks, int iters, const void* in, void* out,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* i = (const uint32_t*)in;
  uint64_t* o = (uint64_t*)out;
  switch (kind) {
    case kWide: probe_kernel<kWide><<<blocks, 256, 0, st>>>(i, o, iters); break;
    case kWideU32: probe_kernel<kWideU32><<<blocks, 256, 0, st>>>(i, o, iters); break;
    case kImad: probe_kernel<kImad><<<blocks, 256, 0, st>>>(i, o, iters); break;
    case kShfl: probe_kernel<kShfl><<<blocks, 256, 0, st>>>(i, o, iters); break;
    case kLop3: probe_kernel<kLop3><<<blocks, 256, 0, st>>>(i, o, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
