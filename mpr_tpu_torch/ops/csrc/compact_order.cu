// Kernel C2: kernel C with order indirection, one tile per block.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_bitshift (Pallas body
// `_compact_bitshift_kernel` on `_compact_core`), the earlier public
// version of kernel C: the planes stay in TILE order and group g compacts
// tile order[g], where the batched kernel wants them gathered into row
// order first.
//
// Bound on the H100: bytes, as for kernel C (three planes of tcap int32 in
// per group, cap-long tapes and headers out).
//
// Design: one block per group g < cmeta[0]; it reads the planes of tile
// order[g] and n = lens[order[g]] and writes output row g with
// compact_core.cuh's compact_row, the same per-tile code as kernel C.
// gmeta[g] = [n, n_runs, n > cap].  Rows g >= cmeta[0] are left as
// allocated.

#include "compact_core.cuh"

namespace {

__global__ void compact_order_kernel(const int* __restrict__ cmeta,
                                     const int* __restrict__ order,
                                     const int* __restrict__ lens,
                                     const int* __restrict__ wrw,
                                     const int* __restrict__ irw,
                                     const int* __restrict__ rem,
                                     int* __restrict__ tw,
                                     int* __restrict__ ti,
                                     int* __restrict__ runs,
                                     int* __restrict__ gmeta, int n_tiles,
                                     int tcap, int cap) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  const int g = blockIdx.x;
  if (g >= cmeta[0]) return;
  const int tile = order[g];
  if (tile < 0 || tile >= n_tiles) return;   // a bad order entry: no access
  const size_t row = (size_t)tile * tcap;
  mpr::compact_row(wrw + row, irw + row, rem + row, lens[tile],
                   tw + (size_t)g * cap, ti + (size_t)g * cap,
                   runs + (size_t)g * cap, gmeta + (size_t)g * 8, tcap, cap,
                   smem, warp_sums);
}

}  // namespace

extern "C" int mpr_compact_order(const void* cmeta, const void* order,
                                 const void* lens, const void* wrw,
                                 const void* irw, const void* rem, void* tw,
                                 void* ti, void* runs, void* gmeta, int gcap,
                                 int n_tiles, int tcap, int cap,
                                 void* stream) {
  const int threads = tcap < 1024 ? tcap : 1024;
  const size_t shmem = mpr::compact_row_shmem(tcap, cap);
  cudaError_t err = cudaFuncSetAttribute(
      compact_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  compact_order_kernel<<<gcap, threads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const int*>(order),
      static_cast<const int*>(lens), static_cast<const int*>(wrw),
      static_cast<const int*>(irw), static_cast<const int*>(rem),
      static_cast<int*>(tw), static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), n_tiles, tcap, cap);
  return (int)cudaGetLastError();
}
