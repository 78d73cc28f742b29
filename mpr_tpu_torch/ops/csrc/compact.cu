// Kernel C: per-tile tape compaction with opcode-run extraction.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_bitshift_batched (Pallas body
// `_make_compact_batched_kernel` + `_compact_core`).
//
// Bound on the H100: bytes.  Each ambiguous tile reads its three planes of
// `tcap` int32 (rewritten words, imm bits, move distances) once and writes
// `cap`-long tapes and run headers; the arithmetic is a few integer
// operations per clause.  The TPU kernel moved every element left by its
// distance in log2(tcap) vector roll passes; on the GPU the distance is
// simply a scatter target: out[t - rem[t]] = in[t] for each kept t.
//
// Design: one block per tile row g < cmeta[0] (the ambiguous count); rows
// past it return at once.  Threads stride over the row so loads coalesce,
// and only kept clauses (branch id != 0) read their imm and distance.  The
// compacted branch ids of all `len` kept clauses go to shared memory; a
// block-wide prefix sum over run heads (`bid != previous bid`) numbers the
// runs, and each run's header is `bid | (next_start - start) << 8`, the
// last run ending at `len`.  gmeta[g] = [len, n_runs, len > cap].  The
// per-tile work is compact_core.cuh's compact_row, shared with the
// order-indirected kernel of compact_order.cu.

#include "compact_core.cuh"

namespace {

__global__ void compact_kernel(const int* __restrict__ cmeta,
                               const int* __restrict__ lens,
                               const int* __restrict__ wrw,
                               const int* __restrict__ irw,
                               const int* __restrict__ rem,
                               int* __restrict__ tw, int* __restrict__ ti,
                               int* __restrict__ runs,
                               int* __restrict__ gmeta, int tcap, int cap) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  const int g = blockIdx.x;
  if (g >= cmeta[0]) return;
  const size_t row = (size_t)g * tcap;
  mpr::compact_row(wrw + row, irw + row, rem + row, lens[g],
                   tw + (size_t)g * cap, ti + (size_t)g * cap,
                   runs + (size_t)g * cap, gmeta + (size_t)g * 8, tcap, cap,
                   smem, warp_sums);
}

}  // namespace

extern "C" int mpr_compact(const void* cmeta, const void* lens,
                           const void* wrw, const void* irw, const void* rem,
                           void* tw, void* ti, void* runs, void* gmeta,
                           int G, int tcap, int cap, void* stream) {
  const int threads = tcap < 1024 ? tcap : 1024;
  const size_t shmem = mpr::compact_row_shmem(tcap, cap);
  cudaError_t err = cudaFuncSetAttribute(
      compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  compact_kernel<<<G, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const int*>(lens),
      static_cast<const int*>(wrw), static_cast<const int*>(irw),
      static_cast<const int*>(rem), static_cast<int*>(tw),
      static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), tcap, cap);
  return (int)cudaGetLastError();
}
