// The block-wide exclusive prefix sum that the kernels which scan a whole
// block share: a block a row of kernels C, C2 and C1
// (compact_core.cuh::Group<false>) and kernel B1's staging of a tile's
// runs (pixel_eval_v1.cu).  A header of its own, because those two sides
// include headers (compact_core.cuh, regfile.cuh) that both define a
// template named mpr::Group.
#pragma once

#include <cuda_runtime.h>

namespace mpr {

// Exclusive prefix sum of v over the block (two barriers); *total gets the
// block's sum.  warp_sums: 32 ints of shared memory, not reused before the
// caller's next barrier.  blockDim.x % 32 == 0.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive sums of the warps
  }
  __syncthreads();
  *total = warp_sums[nw - 1];
  return (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
}

}  // namespace mpr
