// Kernel C: per-tile tape compaction with opcode-run extraction.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_bitshift_batched (Pallas body
// `_make_compact_batched_kernel` + `_compact_core`).
//
// Bound on the H100: bytes.  Each ambiguous tile reads its plane of `tcap`
// rewritten words once, the imm bits and move distances of its kept
// clauses, and writes `cap`-long tapes and run headers, zero past the tape
// (most of a row's output at the 3D cells); the arithmetic is a few
// integer operations per clause.  The TPU kernel moved every element left
// by its distance in log2(tcap) vector roll passes; on the GPU the
// distance is simply a scatter target: out[t - rem[t]] = in[t] for each
// kept t.
//
// Design: compact_core.cuh's compact_row, at one of two launch shapes
// picked on the host (ops/launch.py::compact_launch):
//   * a warp a row, several rows a block, for short planes (the 3D cells'
//     256-clause gyroid buckets: 107k rows of ~1 KB each, where a block a
//     row held 8 rows an SM and ran ~100 waves of one row's latency): only
//     __syncwarp, a shuffle scan, and 40 rows an SM at once (five blocks
//     of 8 warps at 46 registers a thread);
//   * a block a row for long planes (the 2D cells, `extruded_stress`):
//     more threads to stream a row, four barriers; 256 to 512 threads, so
//     that an SM holds several rows at once.
// Both read the words in 16-byte loads, load the moves and immediates of
// the kept clauses only, stage the row in shared memory, and write tw, ti
// and the run headers, zero-fill included, in 16-byte stores.  Rows g >=
// cmeta[0] (the ambiguous count, which stays on the device) return at
// once.  gmeta[g] = [len, n_runs, len > cap, 0..].

#include "compact_core.cuh"

namespace {

template <bool WARP>
__global__ void __launch_bounds__(1024)
compact_kernel(const int* __restrict__ cmeta, const int* __restrict__ lens,
               const int* __restrict__ wrw, const int* __restrict__ irw,
               const int* __restrict__ rem, int* __restrict__ tw,
               int* __restrict__ ti, int* __restrict__ runs,
               int* __restrict__ gmeta, int G, int tcap, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[32];
  const int slot = WARP ? (int)(threadIdx.x >> 5) : 0;
  const int g = blockIdx.x * (WARP ? (int)(blockDim.x >> 5) : 1) + slot;
  if (g >= min(G, cmeta[0])) return;
  const size_t row = (size_t)g * tcap, out = (size_t)g * cap;
  mpr::compact_row(mpr::Group<WARP>(scratch), wrw + row, irw + row,
                   rem + row, lens[g], tw + out, ti + out, runs + out,
                   gmeta + (size_t)g * 8, tcap, cap,
                   smem + (size_t)slot * mpr::compact_row_bytes(tcap, cap));
}

}  // namespace

// threads a block, group the threads a row (32: a warp a row; threads: a
// block a row), smem the dynamic shared memory the host computed for the
// shape (ops/launch.py::compact_launch, which also checks it).
extern "C" int mpr_compact(const void* cmeta, const void* lens,
                           const void* wrw, const void* irw, const void* rem,
                           void* tw, void* ti, void* runs, void* gmeta,
                           int G, int tcap, int cap, int threads, int group,
                           int smem, void* stream) {
  if (tcap % 32 || cap < 1 || cap > tcap || threads % 32 ||
      threads > 1024 || (group != 32 && group != threads) ||
      smem != threads / group * mpr::compact_row_bytes(tcap, cap))
    return (int)cudaErrorInvalidValue;
  const bool warp = group == 32;
  auto fn = warp ? compact_kernel<true> : compact_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = threads / group;
  fn<<<(G + rows - 1) / rows, threads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const int*>(lens),
      static_cast<const int*>(wrw), static_cast<const int*>(irw),
      static_cast<const int*>(rem), static_cast<int*>(tw),
      static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), G, tcap, cap);
  return (int)cudaGetLastError();
}
