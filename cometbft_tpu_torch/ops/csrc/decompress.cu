// decompress: batched ZIP-215 point decoding on Hopper (sm_90a).
//
// Replaces cometbft_tpu/ops/edwards.py:decompress (over field25519's
// fe_pow2523), which the verify program runs on the A and R encodings
// stacked into one 2N-lane pass (ed25519_kernel._verify_from_words). The
// steps are the reference's: u = y^2 - 1, v = d y^2 + 1, the candidate root
// x = u v^3 (u v^7)^((p-5)/8), accept v x^2 == u directly or v x^2 == -u
// after the sqrt(-1) flip, reject x == 0 with sign 1, then fix x's parity
// to the sign. ZIP-215 rules carried: y >= p decodes (the arithmetic
// reduces it); all-zero padded lanes decode without fault and are vetoed by
// the host mask, not here.
//
// What bounds it: operations. A lane needs 255 squarings (251 in the
// exponentiation) of 55 32x32->64 multiply-adds and 20 multiplies of 100,
// against 72 bytes in and 276 out; fe_sq is a full fe_mul here, so the
// kernel issues 100 products a squaring.
//
// Design: one thread per lane, the whole chain in registers (a handful of
// field elements live at once). Outputs are canonical 17x15-bit limbs, the
// layout the rest of the verify pipeline (plain PyTorch) reads.

#include <cuda_runtime.h>

#include "fe25519.cuh"

using namespace cmtpu;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
decompress_kernel(const int32_t* __restrict__ y_in, const int32_t* __restrict__ sign_in,
                  int32_t* __restrict__ out, int32_t* __restrict__ ok_out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t plane = (size_t)17 * n;
  const bool sign = sign_in[lane] != 0;

  fe y, y2, u, v, t, v3, v7, x, vxx, w;
  fe_load17(y, y_in, n, lane);
  fe_sq(y2, y);
  fe_sub(u, y2, fe_one());
  fe_mul(t, y2, fe_d());
  fe_add(v, t, fe_one());
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow2523(w, t);
  fe_mul(t, u, v3);
  fe_mul(x, t, w);  // candidate root of u/v
  fe_sq(t, x);
  fe_mul(vxx, v, t);
  fe_sub(t, vxx, u);
  const bool ok_direct = fe_is_zero(t);
  fe_add(t, vxx, u);
  const bool ok_flip = fe_is_zero(t);  // vxx == -u
  fe_mul(t, x, fe_sqrt_m1());
  fe_select(x, ok_flip && !ok_direct, t, x);
  bool ok = ok_direct || ok_flip;
  ok = ok && !(fe_is_zero(x) && sign);
  fe_neg(t, x);
  fe_select(x, fe_parity(x) != sign, t, x);
  fe_mul(t, x, y);

  fe_store17(out, x, n, lane);
  fe_store17(out + plane, y, n, lane);
  fe_store17(out + 2 * plane, fe_one(), n, lane);
  fe_store17(out + 3 * plane, t, n, lane);
  ok_out[lane] = ok ? 1 : 0;
}

}  // namespace

extern "C" int cmtpu_decompress(const int32_t* y, const int32_t* sign, int32_t* out,
                                int32_t* ok, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  decompress_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(y, sign, out, ok, n);
  return (int)cudaGetLastError();
}
