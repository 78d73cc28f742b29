// Kernel B1: per-pixel float evaluation of each group's tile with that
// tile's own tape, one dispatch per clause.
//
// Replaces: mpr_tpu/ops/kernels.py::pixel_eval (Pallas body
// `_pixel_eval_kernel`), the first public version of kernel B: it returns
// the VALUES of the P pixels of tile order[g] (kernel B returns the 0/1
// fill), reads the tapes in TILE order (tape row order[g], length
// lens[order[g]]), and switches on the opcode byte of every clause, over
// the full float branch list (opcodes 0 and 1 give a * 0).
//
// Bound on the H100: operations, and in practice the latency of the
// per-pixel register file, as for kernel B: len float operations per pixel
// against 12 bytes of coordinates in and 4 bytes of value out per pixel.
//
// Design: one block per group g < nmeta[0]; later groups return at once
// and their rows are left as allocated.  The block copies its tile's tape
// (n words and n immediates) into shared memory when n fits the staged
// capacity (min(cap, 16384) clauses, 128 KB at the most, under the
// opted-in carve-out), and reads it from global memory otherwise, so no
// capacity fails.  Every thread then walks the same clauses for its
// pixels, so a warp takes the same switch branch and reads the same shared
// word (a broadcast).  The register file is a per-thread array indexed by
// run-time slot numbers, so it lives in local memory (L1-cached).  Slot 0
// is zero; x, y, z go to slots nmeta[3:6]; the result is slot nmeta[2].

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"

namespace {

using namespace mpr;

constexpr int REG_CAP = 256;  // slot numbers are bytes
constexpr int THREADS = 512;
constexpr int STAGE_MAX = 16384;  // clauses staged in shared memory

__device__ __forceinline__ float clause_by_op(int op, float a, float b,
                                              float imm) {
  switch (op) {
#define MPR_CASE(o) \
  case o: return float_op<o>(a, b, imm);
    MPR_CASE(0) MPR_CASE(1) MPR_CASE(2) MPR_CASE(3) MPR_CASE(4) MPR_CASE(5)
    MPR_CASE(6) MPR_CASE(7) MPR_CASE(8) MPR_CASE(9) MPR_CASE(10) MPR_CASE(11)
    MPR_CASE(12) MPR_CASE(13) MPR_CASE(14) MPR_CASE(15) MPR_CASE(16)
    MPR_CASE(17) MPR_CASE(18) MPR_CASE(19) MPR_CASE(20) MPR_CASE(21)
    MPR_CASE(22) MPR_CASE(23) MPR_CASE(24) MPR_CASE(25) MPR_CASE(26)
    MPR_CASE(27) MPR_CASE(28) MPR_CASE(29) MPR_CASE(30)
#undef MPR_CASE
    default: return float_op<31>(a, b, imm);  // a switch index clamps high
  }
}

__global__ void __launch_bounds__(THREADS)
pixel_eval_v1_kernel(const int* __restrict__ nmeta,  // [n_groups, S, res, sx, sy, sz, ..]
                     const int* __restrict__ order,  // (gcap,)
                     const int* __restrict__ lens,   // (n_tiles,)
                     const uint32_t* __restrict__ tape_words,  // (n_tiles, cap)
                     const float* __restrict__ tape_imms,
                     const float* __restrict__ coords,  // (n_tiles, 3, P)
                     float* __restrict__ vals,          // (gcap, P)
                     int n_tiles, int cap, int P, int staged) {
  extern __shared__ int smem[];
  const int g = blockIdx.x;
  if (g >= nmeta[0]) return;
  const int tile = order[g];
  if (tile < 0 || tile >= n_tiles) return;   // a bad order entry: no access
  const int n = max(0, min(lens[tile], cap));
  const uint32_t* W = tape_words + (size_t)tile * cap;
  const float* I = tape_imms + (size_t)tile * cap;
  if (n <= staged) {
    uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
    float* si = reinterpret_cast<float*>(smem + staged);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      sw[k] = W[k];
      si[k] = I[k];
    }
    W = sw;
    I = si;
  }
  __syncthreads();

  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  const float* c = coords + (size_t)tile * 3 * P;
  float* out = vals + (size_t)g * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float regs[REG_CAP];
    regs[sx] = c[p];
    regs[sy] = c[P + p];
    regs[sz] = c[2 * P + p];
    regs[0] = 0.0f;  // slot 0: the "no operand" sentinel
    for (int t = 0; t < n; ++t) {
      const uint32_t w = W[t];
      regs[w_out(w)] = clause_by_op(w_op(w), regs[w_lhs(w)], regs[w_rhs(w)],
                                    I[t]);
    }
    out[p] = regs[res];
  }
}

}  // namespace

extern "C" int mpr_pixel_eval_v1(const void* nmeta, const void* order,
                                 const void* lens, const void* tape_words,
                                 const void* tape_imms, const void* coords,
                                 void* vals, int gcap, int n_tiles, int cap,
                                 int P, void* stream) {
  const int staged = cap < STAGE_MAX ? cap : STAGE_MAX;
  const size_t shmem = (size_t)2 * staged * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      pixel_eval_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  pixel_eval_v1_kernel<<<gcap, THREADS, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const int*>(lens),
      static_cast<const uint32_t*>(tape_words),
      static_cast<const float*>(tape_imms),
      static_cast<const float*>(coords), static_cast<float*>(vals), n_tiles,
      cap, P, staged);
  return (int)cudaGetLastError();
}
