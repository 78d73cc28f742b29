// Device code shared by the compaction kernels (compact.cu,
// compact_order.cu, compact_runs.cu): a block-wide prefix sum, the scatter
// of one tile's kept clauses to a dense tape, and the numbering of opcode
// runs over the compacted branch ids.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace mpr {

// Exclusive prefix sum of one int per thread over the block; *total gets
// the block sum.  blockDim.x must be a multiple of 32.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums,
                                                   int* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(full, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive sums of the warps
  }
  __syncthreads();
  const int before = (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return before;
}

// Number the opcode runs of the compacted branch ids sbid[0, n) (shared
// memory, complete before the call) and write the headers
// `bid | count << 8` to runs_g[0, rcap), zero past the last run.  Position
// k starts a run when its bid differs from position k-1's; the last run
// ends at n.  Threads split [0, span) (span >= n) into contiguous pieces.
// sstart: rcap + 1 ints of shared memory.  Returns the run count, which
// may exceed rcap (only the first rcap headers are written).
__device__ __forceinline__ int emit_runs(const unsigned char* sbid, int n,
                                         int span, int rcap, int* sstart,
                                         int* warp_sums,
                                         int* __restrict__ runs_g) {
  const int per = (span + blockDim.x - 1) / blockDim.x;
  const int k0 = threadIdx.x * per;
  const int k1 = min(k0 + per, n);
  int heads = 0;
  for (int k = k0; k < k1; ++k) heads += (k == 0 || sbid[k] != sbid[k - 1]);
  int n_runs;
  int r = block_exclusive_sum(heads, warp_sums, &n_runs);
  for (int k = k0; k < k1; ++k) {
    if (k == 0 || sbid[k] != sbid[k - 1]) {
      if (r <= rcap) sstart[r] = k;
      ++r;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < rcap; q += blockDim.x) {
    int h = 0;
    if (q < n_runs) {
      const int s = sstart[q];
      const int e = q + 1 < n_runs ? sstart[q + 1] : n;
      h = (int)sbid[s] | ((e - s) << 8);
    }
    runs_g[q] = h;
  }
  return n_runs;
}

// Kernel C's work on one tile: planes of tcap int32 (rewritten words with
// the branch id in the low byte, imm bits, leftward moves) with n kept
// clauses -> the dense tape tw_g/ti_g[0, cap) (zero past n), the run
// headers runs_g[0, cap) and gmeta_g = [n, n_runs, n > cap, 0..].
// smem: (cap + 1) ints then tcap bytes.
__device__ __forceinline__ void compact_row(
    const int* __restrict__ wrw, const int* __restrict__ irw,
    const int* __restrict__ rem, int n, int* __restrict__ tw_g,
    int* __restrict__ ti_g, int* __restrict__ runs_g,
    int* __restrict__ gmeta_g, int tcap, int cap, int* smem,
    int* warp_sums) {
  int* sstart = smem;                                       // cap + 1
  unsigned char* sbid = reinterpret_cast<unsigned char*>(smem + cap + 1);

  // 1. scatter each kept clause to its compacted slot.  All `n` branch ids
  //    are kept (not only the first `cap`): an overflowing tile still
  //    reports its true run count.
  for (int t = threadIdx.x; t < tcap; t += blockDim.x) {
    const int w = wrw[t];
    if (w & 0xFF) {
      const int k = t - rem[t];
      sbid[k] = (unsigned char)(w & 0xFF);
      if (k < cap) {
        tw_g[k] = w;
        ti_g[k] = irw[t];
      }
    }
  }
  for (int k = n + threadIdx.x; k < cap; k += blockDim.x) {
    tw_g[k] = 0;
    ti_g[k] = 0;
  }
  __syncthreads();

  // 2. number the runs and write their headers
  const int n_runs = emit_runs(sbid, n, tcap, cap, sstart, warp_sums, runs_g);
  if (threadIdx.x < 8) {
    const int v[3] = {n, n_runs, n > cap ? 1 : 0};
    gmeta_g[threadIdx.x] = threadIdx.x < 3 ? v[threadIdx.x] : 0;
  }
}

inline size_t compact_row_shmem(int tcap, int cap) {
  return (size_t)(cap + 1) * sizeof(int) + (size_t)tcap;
}

}  // namespace mpr
