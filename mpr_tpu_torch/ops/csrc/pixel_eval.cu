// Kernel B: per-pixel float evaluation of each ambiguous 64x64 tile with
// that tile's shortened tape; decided tiles write their interval decision.
//
// Replaces: mpr_tpu/ops/kernels.py::pixel_eval_runs (Pallas body
// `_make_pixel_run_kernel`), the reference's eval_voxels_f<2> plus
// copy_filled.
//
// Bound on the H100: operations, and in practice the latency of the
// per-pixel register file.  Each pixel runs its tile's tape (len clauses)
// once: len float operations per pixel against 16 KB of coordinates in and
// 16 KB of fill out per tile.  The register file is a per-thread array
// indexed by slot numbers known only at run time, so it lives in local
// memory (L1-cached), one load per operand and one store per clause.
//
// Design: one block per tile row g of `order`; the output goes to
// fill[order[g], :], so the image is a pure reshape of `fill`.  Blocks with
// g >= nmeta[0] or a status other than AMBIG write their decision.  An
// ambiguous block first copies its shortened tape (words, imms, run
// headers: 3 x cap int32) into shared memory; every thread then walks the
// same runs for its pixels, so the whole warp takes the same branch and
// reads the same shared word (a broadcast).  Dispatch is one switch per
// opcode run, hoisted out of the run's inner loop.  A tile whose tape
// overflowed `cap` (gmeta[g, 2]) interprets the full tape from global
// memory instead.  Keeping several pixels' registers per thread, or the
// register file in shared memory, is later work.

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"

namespace {

using namespace mpr;

constexpr int REG_CAP = 256;  // slot numbers are bytes
constexpr int THREADS = 512;

template <int OP>
__device__ __forceinline__ void run_clauses(float* regs,
                                            const uint32_t* words,
                                            const float* imms, int t0,
                                            int cnt) {
  for (int k = 0; k < cnt; ++k) {
    const uint32_t w = words[t0 + k];
    regs[w_out(w)] = float_op<OP>(regs[w_lhs(w)], regs[w_rhs(w)],
                                  imms[t0 + k]);
  }
}

__device__ __forceinline__ void run_dispatch(int op, float* regs,
                                             const uint32_t* words,
                                             const float* imms, int t0,
                                             int cnt) {
  switch (op) {
#define MPR_CASE(o) \
  case o: run_clauses<o>(regs, words, imms, t0, cnt); break;
    MPR_CASE(2) MPR_CASE(3) MPR_CASE(4) MPR_CASE(5) MPR_CASE(6) MPR_CASE(7)
    MPR_CASE(8) MPR_CASE(9) MPR_CASE(10) MPR_CASE(11) MPR_CASE(12)
    MPR_CASE(13) MPR_CASE(14) MPR_CASE(15) MPR_CASE(16) MPR_CASE(17)
    MPR_CASE(18) MPR_CASE(19) MPR_CASE(20) MPR_CASE(21) MPR_CASE(22)
    MPR_CASE(23) MPR_CASE(24) MPR_CASE(25) MPR_CASE(26) MPR_CASE(27)
    MPR_CASE(28) MPR_CASE(29) MPR_CASE(30) MPR_CASE(31)
#undef MPR_CASE
    default: break;  // branch id 0 and unknown ops: no-op runs
  }
}

__global__ void __launch_bounds__(THREADS)
pixel_eval_kernel(const int* __restrict__ nmeta,  // [n_amb, S, res, sx, sy, sz, n_runs_full, 0]
                  const int* __restrict__ order,
                  const int* __restrict__ status,
                  const uint32_t* __restrict__ words,  // full tape
                  const float* __restrict__ imms,
                  const int* __restrict__ runs_full,
                  const int* __restrict__ bid_op,      // (256,) branch id -> op
                  const int* __restrict__ tw,          // (gcap, cap)
                  const float* __restrict__ ti,
                  const int* __restrict__ runs,
                  const int* __restrict__ gmeta,       // (gcap, 8)
                  const float* __restrict__ coords,    // (n_tiles, 3, P)
                  int* __restrict__ fill,              // (n_tiles, P)
                  int cap, int P) {
  extern __shared__ int smem[];
  __shared__ int sop[256];
  const int g = blockIdx.x;
  const int tile = order[g];
  const int st = status[tile];
  int* out = fill + (size_t)tile * P;
  if (g >= nmeta[0] || st != ST_AMBIG) {
    const int v = st == ST_FILLED ? 1 : 0;
    for (int p = threadIdx.x; p < P; p += blockDim.x) out[p] = v;
    return;
  }

  for (int i = threadIdx.x; i < 256; i += blockDim.x) sop[i] = bid_op[i];
  const uint32_t* W;
  const float* I;
  const int* R;
  int n_runs;
  if (gmeta[(size_t)g * 8 + 2] == 0) {
    const int n = min(gmeta[(size_t)g * 8 + 0], cap);
    n_runs = min(gmeta[(size_t)g * 8 + 1], cap);
    uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
    float* si = reinterpret_cast<float*>(smem + cap);
    int* sr = smem + 2 * cap;
    const size_t row = (size_t)g * cap;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      sw[k] = (uint32_t)tw[row + k];
      si[k] = ti[row + k];
    }
    for (int k = threadIdx.x; k < n_runs; k += blockDim.x) sr[k] = runs[row + k];
    W = sw;
    I = si;
    R = sr;
  } else {
    // overflow: the reference keeps the parent tape
    W = words;
    I = imms;
    R = runs_full;
    n_runs = nmeta[6];
  }
  __syncthreads();

  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  const float* c = coords + (size_t)tile * 3 * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float regs[REG_CAP];
    regs[sx] = c[p];
    regs[sy] = c[P + p];
    regs[sz] = c[2 * P + p];
    regs[0] = 0.0f;  // slot 0: the "no operand" sentinel
    int t0 = 0;
    for (int r = 0; r < n_runs; ++r) {
      const int hdr = R[r];
      const int cnt = hdr >> 8;
      run_dispatch(sop[hdr & 0xFF], regs, W, I, t0, cnt);
      t0 += cnt;
    }
    out[p] = regs[res] < 0.0f ? 1 : 0;
  }
}

}  // namespace

extern "C" int mpr_pixel_eval(const void* nmeta, const void* order,
                              const void* status, const void* words,
                              const void* imms, const void* runs_full,
                              const void* bid_op, const void* tw,
                              const void* ti, const void* runs,
                              const void* gmeta, const void* coords,
                              void* fill, int gcap, int cap, int P,
                              void* stream) {
  const size_t shmem = (size_t)3 * cap * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      pixel_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  pixel_eval_kernel<<<gcap, THREADS, shmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const int*>(status), static_cast<const uint32_t*>(words),
      static_cast<const float*>(imms), static_cast<const int*>(runs_full),
      static_cast<const int*>(bid_op), static_cast<const int*>(tw),
      static_cast<const float*>(ti), static_cast<const int*>(runs),
      static_cast<const int*>(gmeta), static_cast<const float*>(coords),
      static_cast<int*>(fill), cap, P);
  return (int)cudaGetLastError();
}
