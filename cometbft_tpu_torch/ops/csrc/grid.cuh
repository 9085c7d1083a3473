// Balanced launch shape for the one-pass kernels (sha512, decompress): the
// lanes spread evenly over whole waves of one block per SM, so no SM runs a
// second wave while another idles. A block holds lanes_per_block lanes,
// lanes_per_warp to a warp, in at most max_threads threads (the kernel's
// __launch_bounds__, so the launch always has its registers).

#pragma once

#include <cuda_runtime.h>

namespace cmtpu {

struct Grid {
  int blocks, threads, lanes_per_block;
};

inline cudaError_t balanced_grid(int lanes, int lanes_per_warp, int max_threads, Grid* g) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int max_warps = max_threads / 32;
  int waves = 1, lpb, warps;
  for (;;) {
    lpb = (lanes + sms * waves - 1) / (sms * waves);
    warps = (lpb + lanes_per_warp - 1) / lanes_per_warp;
    if (warps <= max_warps) break;
    ++waves;
  }
  g->lanes_per_block = lpb;
  g->blocks = (lanes + lpb - 1) / lpb;
  g->threads = warps * 32;
  return cudaSuccess;
}

}  // namespace cmtpu
