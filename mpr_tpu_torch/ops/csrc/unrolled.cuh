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
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "clause.cuh"

using mpr::nmax;
using mpr::nmin;
using mpr::c_asin;
using mpr::c_acos;
using mpr::c_atan;

#ifndef MPR_UNROLLED_THREADS
#define MPR_UNROLLED_THREADS 128
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
