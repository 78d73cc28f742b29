// Kernel C2: kernel C with order indirection.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_bitshift (Pallas body
// `_compact_bitshift_kernel` on `_compact_core`), the earlier public
// version of kernel C: the planes stay in TILE order and group g compacts
// tile order[g], where the batched kernel wants them gathered into row
// order first.
//
// Bound on the H100: bytes, as for kernel C (a plane of tcap words and the
// kept clauses' moves and immediates in per group, cap-long tapes and
// headers out).
//
// Design: kernel C's, with the same launch shapes (a warp a row or a block
// a row, ops/launch.py::compact_launch) and compact_core.cuh's compact_row:
// group g < cmeta[0] reads the planes of tile order[g] and n =
// lens[order[g]] and writes output row g.  gmeta[g] = [n, n_runs, n > cap].
// Rows g >= cmeta[0], and rows whose order entry names no tile, are left
// as allocated.

#include "compact_core.cuh"

namespace {

template <bool WARP>
__global__ void __launch_bounds__(1024)
compact_order_kernel(const int* __restrict__ cmeta,
                     const int* __restrict__ order,
                     const int* __restrict__ lens,
                     const int* __restrict__ wrw, const int* __restrict__ irw,
                     const int* __restrict__ rem, int* __restrict__ tw,
                     int* __restrict__ ti, int* __restrict__ runs,
                     int* __restrict__ gmeta, int gcap, int n_tiles,
                     int tcap, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[32];
  const int slot = WARP ? (int)(threadIdx.x >> 5) : 0;
  const int g = blockIdx.x * (WARP ? (int)(blockDim.x >> 5) : 1) + slot;
  if (g >= min(gcap, cmeta[0])) return;
  const int tile = order[g];
  if (tile < 0 || tile >= n_tiles) return;   // a bad order entry: no access
  const size_t row = (size_t)tile * tcap, out = (size_t)g * cap;
  mpr::compact_row(mpr::Group<WARP>(scratch), wrw + row, irw + row,
                   rem + row, lens[tile], tw + out, ti + out, runs + out,
                   gmeta + (size_t)g * 8, tcap, cap,
                   smem + (size_t)slot * mpr::compact_row_bytes(tcap, cap));
}

}  // namespace

// As mpr_compact, over gcap groups of n_tiles tiles.
extern "C" int mpr_compact_order(const void* cmeta, const void* order,
                                 const void* lens, const void* wrw,
                                 const void* irw, const void* rem, void* tw,
                                 void* ti, void* runs, void* gmeta, int gcap,
                                 int n_tiles, int tcap, int cap, int threads,
                                 int group, int smem, void* stream) {
  if (tcap % 32 || cap < 1 || cap > tcap || threads % 32 ||
      threads > 1024 || (group != 32 && group != threads) ||
      smem != threads / group * mpr::compact_row_bytes(tcap, cap))
    return (int)cudaErrorInvalidValue;
  const bool warp = group == 32;
  auto fn = warp ? compact_order_kernel<true> : compact_order_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = threads / group;
  fn<<<(gcap + rows - 1) / rows, threads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const int*>(order),
      static_cast<const int*>(lens), static_cast<const int*>(wrw),
      static_cast<const int*>(irw), static_cast<const int*>(rem),
      static_cast<int*>(tw), static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), gcap, n_tiles, tcap, cap);
  return (int)cudaGetLastError();
}
