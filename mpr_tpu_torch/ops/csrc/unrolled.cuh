// The fixed frame of the generated unrolled evaluators.
//
// ops/unrolled_eval.py writes one kernel per (tape structure, semantics,
// immediates baked or read from a pointer, config flags): the tape as
// straight-line code, one `const` local per float32 operation (SSA form),
// so every live slot sits in a register.  This header gives it the kernel's
// parameters and the C entry point the ctypes wrapper calls; the clause
// helpers come from clause.cuh (nmin/nmax, the NaN-propagating min/max of
// torch.minimum and jnp.minimum, and the Cephes c_asin/c_acos/c_atan that
// config.fast_transcendentals selects).  No TPU kernel is replaced: on the
// TPU this engine is XLA code (mpr_tpu/ops/unrolled_eval.py build_float
// :397, build_interval :411, build_deriv :421).
//
// Layout: a thread takes a lane; inputs and outputs are SoA float32 planes
// of n lanes (float: x y z -> v; interval: xl xh yl yh zl zh -> lo hi;
// deriv: x y z -> v dx dy dz).  Bound: operations (each clause-operation
// once a lane) for long tapes, the lanes' bytes for short ones.
//
// Numerics: built with ops/build.py's flags (--fmad=false, no fast math),
// so each statement rounds as the plain torch version's operation does.
//
// Kernel K1, the VJP of an imm-input float evaluator, is generated per tape
// too, in two halves (libraries built in parallel), from the tape's storage
// plan (ops/vjp_plan.py).  The forward half is a float evaluator (the frame
// above) that stores only what the partials read: the values of the
// non-linear rules' operands (and sqrt's, exp's and hypot's results) at
// compact positions, row pos of vals (out0), and a 2-bit choice code for
// each min/max clause, 16 to a word, row word of ch (out1), every array in
// blocks of 128 lanes (entry (row, lane) at lane / 128 * rows * 128 + row *
// 128 + lane % 128: a block's rows lie side by side); a lane past n
// computes lane n - 1's values into its own entries.  The
// reverse half (MPR_UNROLLED_VJP_*: in0..in2 = x y z, in3 = the upstream
// gradient g), in segments of at most 512 clauses, one kernel each, run
// last first, walks its clauses backwards in a grid-stride loop over
// lanes: a clause whose output has an adjoint reads what its rule needs
// (stored values, its choice code) and hands the rule's shares on, into
// register adjoints, or into the handover array hand (row pos) for an
// adjoint that an earlier segment reads (or that the plan parks to keep at
// most 56 in registers), which the first contributor stores and the others
// add to through L2 (__stcg / __ldcg: a handed-over value the compiler kept
// in a register from its store to its read would undo the parking), and
// nothing is zero-filled.  Each immediate's share goes into the
// block's accumulator in shared memory, eight immediates reduced over the
// warp at a time (mpr::acc_imm8), written as the segment's columns
// of a row of partials (blocks, T); the reduce entry then sums the rows
// into grad (adjoint.cuh).  A segment's launch bounds (MPR_VJP_THREADS,
// MPR_VJP_MIN_BLOCKS) cap it at 128 registers, 16 warps an SM.
// Bound: the bytes of vals, ch and hand (each written once and read about
// once) for long tapes, plus five shuffles an immediate a warp.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "adjoint.cuh"
#include "clause.cuh"

using mpr::nmax;
using mpr::nmin;
using mpr::c_asin;
using mpr::c_acos;
using mpr::c_atan;

// jax.grad's share of a min/max's gradient for its lhs (a) and its other
// operand (b), from the clause's choice code c (bit 0: the lhs equals the
// result, bit 1: the other operand does): 1 to the one equal to the result,
// 0.5 each at a tie, 0 to both where the result is NaN.
__device__ __forceinline__ float mpr_bal_a(uint32_t c) {
  return (c & 1u) ? ((c & 2u) ? 0.5f : 1.0f) : 0.0f;
}
__device__ __forceinline__ float mpr_bal_b(uint32_t c) {
  return (c & 2u) ? ((c & 1u) ? 0.5f : 1.0f) : 0.0f;
}

#ifndef MPR_UNROLLED_THREADS
#define MPR_UNROLLED_THREADS 128
#endif
#ifndef MPR_VJP_THREADS
#define MPR_VJP_THREADS 128
#endif
#ifndef MPR_VJP_MIN_BLOCKS
#define MPR_VJP_MIN_BLOCKS 4
#endif

#define MPR_UNROLLED_PARAMS                                                  \
  const float* __restrict__ in0, const float* __restrict__ in1,              \
      const float* __restrict__ in2, const float* __restrict__ in3,          \
      const float* __restrict__ in4, const float* __restrict__ in5,          \
      const float* __restrict__ imms, float* __restrict__ out0,              \
      float* __restrict__ out1, float* __restrict__ out2,                    \
      float* __restrict__ out3, int n

#define MPR_UNROLLED_KERNEL                                                  \
  __global__ void __launch_bounds__(MPR_UNROLLED_THREADS)                    \
      mpr_unrolled_kernel(MPR_UNROLLED_PARAMS)

// The C entry point: one launch of a thread a lane over n lanes on the
// given stream; returns the launch's CUDA error (0 when it was taken).
#define MPR_UNROLLED_ENTRY                                                   \
  extern "C" int mpr_unrolled(                                               \
      const void* in0, const void* in1, const void* in2, const void* in3,    \
      const void* in4, const void* in5, const void* imms, void* out0,        \
      void* out1, void* out2, void* out3, int n, int blocks, int threads,    \
      void* stream) {                                                        \
    if (threads != MPR_UNROLLED_THREADS || n < 0 ||                          \
        (long long)blocks * threads < n)                                     \
      return (int)cudaErrorInvalidValue;                                     \
    mpr_unrolled_kernel<<<blocks, threads, 0,                                \
                          static_cast<cudaStream_t>(stream)>>>(              \
        static_cast<const float*>(in0), static_cast<const float*>(in1),      \
        static_cast<const float*>(in2), static_cast<const float*>(in3),      \
        static_cast<const float*>(in4), static_cast<const float*>(in5),      \
        static_cast<const float*>(imms), static_cast<float*>(out0),          \
        static_cast<float*>(out1), static_cast<float*>(out2),                \
        static_cast<float*>(out3), n);                                       \
    return (int)cudaGetLastError();                                          \
  }

#define MPR_UNROLLED_VJP_KERNEL                                              \
  __global__ void __launch_bounds__(MPR_VJP_THREADS, MPR_VJP_MIN_BLOCKS)     \
      mpr_unrolled_vjp_kernel(                                               \
          const float* __restrict__ in0, const float* __restrict__ in1,      \
          const float* __restrict__ in2, const float* __restrict__ in3,      \
          const float* __restrict__ imms, const float* __restrict__ vals,    \
          const uint32_t* __restrict__ ch, float* __restrict__ hand,         \
          float* __restrict__ partials, int n, int T)

// K1's reverse half's C entry points: one segment's kernel on `blocks`
// blocks of MPR_VJP_THREADS over n lanes (its columns [T0, T1) of the
// partials, blocks x T floats; the segment's accumulator in shared
// memory), and the sum of the partials' rows into grad (T floats; added to
// it with `accumulate`); each returns the first CUDA error (0 when the
// launch was taken).
#define MPR_UNROLLED_VJP_ENTRY                                               \
  extern "C" int mpr_unrolled_vjp(                                           \
      const void* x, const void* y, const void* z, const void* g,            \
      const void* imms, const void* vals, const void* ch, void* hand,        \
      void* partials, int n, int T, int blocks, int threads, void* stream) { \
    if (threads != MPR_VJP_THREADS || n < 1 || T < T1 || blocks < 1)         \
      return (int)cudaErrorInvalidValue;                                     \
    const int smem = (T1 - T0 > 0 ? T1 - T0 : 1) * (int)sizeof(float);      \
    int err = mpr::allow_smem((const void*)mpr_unrolled_vjp_kernel, smem);   \
    if (err) return err;                                                     \
    mpr_unrolled_vjp_kernel<<<blocks, threads, smem,                         \
                              static_cast<cudaStream_t>(stream)>>>(          \
        static_cast<const float*>(x), static_cast<const float*>(y),          \
        static_cast<const float*>(z), static_cast<const float*>(g),          \
        static_cast<const float*>(imms), static_cast<const float*>(vals),    \
        static_cast<const uint32_t*>(ch), static_cast<float*>(hand),         \
        static_cast<float*>(partials), n, T);                                \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int mpr_unrolled_vjp_reduce(void* partials, void* grad, int T,  \
                                         int blocks, int accumulate,         \
                                         void* stream) {                     \
    return mpr::reduce_partials(static_cast<const float*>(partials),         \
                                static_cast<float*>(grad), T, blocks,        \
                                accumulate,                                  \
                                static_cast<cudaStream_t>(stream));          \
  }
