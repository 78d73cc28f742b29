// The lane reduction of the port's backward kernels: d(loss)/d(imms[t])
// summed over every lane of a launch.
//
// Users: the interpreter's adjoint K2 (scan_adjoint.cu) and the generated
// VJP kernels K1 of the unrolled float evaluators (ops/unrolled_eval.py,
// unrolled.cuh).  No TPU kernel stands behind them: on the TPU the
// gradient is XLA's transpose of mpr_tpu/ops/eval_scan.py::eval_f and of
// the unrolled float chain under jax.value_and_grad.
//
// Every lane adds a share to each immediate a clause reads, so one float
// atomic a lane and clause would serialise.  Instead, two passes:
//   1. a warp sums its 32 lanes' shares with shuffles, and its lane 0 adds
//      the sum into the block's accumulator in shared memory (one shared
//      atomic a warp and clause); a block walks its lanes in a grid-stride
//      loop, so a launch has at most a few blocks an SM, and each block
//      writes its accumulator once, as row b of partials (blocks, T);
//   2. reduce_partials sums the rows in block order, a thread an
//      immediate, into grad[t] (or adds them to it, for a launch in
//      chunks).
// The order of the shared atomics differs from run to run, so a gradient
// is not bit-reproducible: it agrees with its plain version (autograd of
// the plain walk) to a sum-order tolerance.
#pragma once

#include <cuda_runtime.h>

namespace mpr {

// The sum of v over the warp's 32 lanes (all lanes must call it).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One lane's share v of d/d imms[t], into the block's accumulator acc.
__device__ __forceinline__ void acc_imm(float* acc, int t, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(acc + t, v);
}

// Eight lanes' shares of eight immediates (the accumulator entries T0..T7)
// at once, by a reduce-scatter over the warp: three exchange rounds halve
// the values a lane holds (4, 2, 1 shuffles), two more finish the sums, and
// eight lanes each add one sum into the accumulator: 9 shuffles and one
// branch for eight immediates, where acc_imm takes 40 and eight.  Padding
// entries pass 0 and any index.
template <int T0, int T1, int T2, int T3, int T4, int T5, int T6, int T7>
__device__ __forceinline__ void acc_imm8(float* acc, float v0, float v1,
                                         float v2, float v3, float v4,
                                         float v5, float v6, float v7) {
  constexpr unsigned F = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  const float w0 = (h4 ? v4 : v0) + __shfl_xor_sync(F, h4 ? v0 : v4, 16);
  const float w1 = (h4 ? v5 : v1) + __shfl_xor_sync(F, h4 ? v1 : v5, 16);
  const float w2 = (h4 ? v6 : v2) + __shfl_xor_sync(F, h4 ? v2 : v6, 16);
  const float w3 = (h4 ? v7 : v3) + __shfl_xor_sync(F, h4 ? v3 : v7, 16);
  const float u0 = (h3 ? w2 : w0) + __shfl_xor_sync(F, h3 ? w0 : w2, 8);
  const float u1 = (h3 ? w3 : w1) + __shfl_xor_sync(F, h3 ? w1 : w3, 8);
  float s = (h2 ? u1 : u0) + __shfl_xor_sync(F, h2 ? u0 : u1, 4);
  s += __shfl_xor_sync(F, s, 2);
  s += __shfl_xor_sync(F, s, 1);
  if ((lane & 3) == 0) {
    // lane bits 4, 3, 2 name the immediate whose sum the lane holds
    const int j = (h4 ? 4 : 0) + (h3 ? 2 : 0) + (h2 ? 1 : 0);
    const int t = j < 4 ? (j < 2 ? (j ? T1 : T0) : (j == 3 ? T3 : T2))
                        : (j < 6 ? (j == 5 ? T5 : T4) : (j == 7 ? T7 : T6));
    atomicAdd(acc + t, s);
  }
}

// Zero the block's accumulator of T immediates.
__device__ __forceinline__ void acc_zero(float* acc, int T) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) acc[t] = 0.0f;
  __syncthreads();
}

// Write the block's accumulator of T immediates as row blockIdx.x of
// partials, whose rows are `stride` floats apart.
__device__ __forceinline__ void acc_store(const float* acc, float* partials,
                                          int T, int stride) {
  __syncthreads();
  float* row = partials + (size_t)blockIdx.x * stride;
  for (int t = threadIdx.x; t < T; t += blockDim.x) row[t] = acc[t];
}

// Pass 2, a thread an immediate (a template, so that every file that
// includes this header may keep its own copy).
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partials,
                       float* __restrict__ grad, int T, int blocks,
                       int accumulate) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * T + t];
  grad[t] = accumulate ? grad[t] + s : s;
}

// Pass 2 on the stream; returns the launch's CUDA error.
inline int reduce_partials(const float* partials, float* grad, int T,
                           int blocks, int accumulate, cudaStream_t stream) {
  if (T <= 0) return 0;
  reduce_partials_kernel<256><<<(T + 255) / 256, 256, 0, stream>>>(
      partials, grad, T, blocks, accumulate);
  return (int)cudaGetLastError();
}

// cp.async: start copying 16 bytes from global to shared memory (both
// 16-byte aligned), close the thread's group of copies, wait for all of
// its groups (then a barrier makes the data visible to the block).
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Allow a block `smem` bytes of dynamic shared memory (above 48 KB the
// kernel must opt in).
inline int allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace mpr
