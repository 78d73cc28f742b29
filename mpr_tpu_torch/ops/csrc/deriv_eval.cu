// Kernel D: value and gradient (v, d/dx, d/dy, d/dz) of the field by
// forward-mode dual numbers, at each pixel of each 64-px screen tile with
// content, one voxel in front of the depth surface.
//
// Replaces: mpr_tpu/ops/kernels3d.py::deriv_eval_3d (Pallas body
// `_make_deriv_kernel` with `_deriv_branch_list`), the reference's
// eval_pixels_d.
//
// Bound on the H100: operations, and in practice the latency of the
// per-pixel register file.  Each pixel runs its tile's z-column tape once
// with four floats a slot: about four times kernel V's arithmetic per
// clause, against 16 KB of depth in and 64 KB of (v, gradient) out per
// tile.  The register file is a per-thread array of REG_CAP dual numbers
// (4 KB of local memory a thread) indexed by slot numbers known only at
// run time; each operand is one 16-byte local load, each result one
// 16-byte store, and only the slots a tape touches ever reach the cache.
//
// Design: one block per row g < nmeta[0] of `order` (tiles with content
// first); tile t = order[g] gives the screen position, its depth comes
// from depth_blocks[t], and the output goes to out[g] (row order: the
// caller scatters rows back to tiles).  The seeds are the transformed
// coordinates with unit derivatives in world space, not pushed through the
// camera matrix, as the JAX kernel has them.  The tile's column tape
// (3 x cap int32) is staged in shared memory and walked run by run, one
// switch per opcode run, exactly as kernel V does; a column whose tape
// overflowed `cap` interprets the full tape from global memory.  Sizing
// the register file by the tape's slot count is later work.

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"

namespace {

using namespace mpr;

constexpr int REG_CAP = 256;  // slot numbers are bytes
constexpr int THREADS = 512;
constexpr int TILE = 64;
constexpr int TILE_PIXELS = TILE * TILE;

template <int OP>
__device__ __forceinline__ void run_clauses(Dv* regs, const uint32_t* words,
                                            const float* imms, int t0,
                                            int cnt) {
  for (int k = 0; k < cnt; ++k) {
    const uint32_t w = words[t0 + k];
    const Dv a = regs[w_lhs(w)];
    const Dv b = regs[w_rhs(w)];
    regs[w_out(w)] = deriv_op<OP>(a, b, imms[t0 + k]);
  }
}

__device__ __forceinline__ void run_dispatch(int op, Dv* regs,
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
deriv_eval_kernel(const int* __restrict__ nmeta,  // [n_act, S, res, sx, sy, sz, n_runs_full, row0]
                  const int* __restrict__ order,   // xy tile per row
                  const float* __restrict__ matf,  // (16,) row-major mat4
                  const uint32_t* __restrict__ words,  // full tape
                  const float* __restrict__ imms,
                  const int* __restrict__ runs_full,
                  const int* __restrict__ bid_op,      // (256,) branch id -> op
                  const int* __restrict__ tw,          // (gcap, cap)
                  const float* __restrict__ ti,
                  const int* __restrict__ runs,
                  const int* __restrict__ gmeta,       // (gcap, 8)
                  const int* __restrict__ depth,       // (n_tiles, 4096)
                  float* __restrict__ out,             // (gcap, 4, 4096)
                  int cap, int n_side) {
  extern __shared__ int smem[];
  __shared__ int sop[256];
  __shared__ float smat[16];
  const int g = blockIdx.x;
  if (g >= nmeta[0]) return;

  for (int i = threadIdx.x; i < 256; i += blockDim.x) sop[i] = bid_op[i];
  if (threadIdx.x < 16) smat[threadIdx.x] = matf[threadIdx.x];
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

  const int t = order[g];  // slab-local xy tile id
  const float bx = (float)((t % n_side) * TILE);
  const float by = (float)((nmeta[7] + t / n_side) * TILE);
  const int isize = n_side * TILE;
  const float size = (float)isize;
  const int* d = depth + (size_t)t * TILE_PIXELS;

  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  float* o = out + (size_t)g * 4 * TILE_PIXELS;
  for (int l = threadIdx.x; l < TILE_PIXELS; l += blockDim.x) {
    const float px = (float)(l % TILE);
    const float py = (float)(l / TILE);
    // depth stores the top filled voxel's index + 1, so voxel d is the
    // first empty one: the sample lies one voxel in front of the surface
    const float zi = (float)min(d[l], isize - 1);
    float x, y, z;
    mat4_apply(smat, world_coord(bx + px, size), world_coord(by + py, size),
               world_coord(zi, size), x, y, z);
    Dv regs[REG_CAP];
    regs[sx] = Dv{x, 1.0f, 0.0f, 0.0f};
    regs[sy] = Dv{y, 0.0f, 1.0f, 0.0f};
    regs[sz] = Dv{z, 0.0f, 0.0f, 1.0f};
    regs[0] = Dv{0.0f, 0.0f, 0.0f, 0.0f};  // slot 0: the "no operand" sentinel
    int t0 = 0;
    for (int r = 0; r < n_runs; ++r) {
      const int hdr = R[r];
      const int cnt = hdr >> 8;
      run_dispatch(sop[hdr & 0xFF], regs, W, I, t0, cnt);
      t0 += cnt;
    }
    const Dv v = regs[res];
    o[l] = v.v;
    o[TILE_PIXELS + l] = v.dx;
    o[2 * TILE_PIXELS + l] = v.dy;
    o[3 * TILE_PIXELS + l] = v.dz;
  }
}

}  // namespace

extern "C" int mpr_deriv_eval(const void* nmeta, const void* order,
                              const void* matf, const void* words,
                              const void* imms, const void* runs_full,
                              const void* bid_op, const void* tw,
                              const void* ti, const void* runs,
                              const void* gmeta, const void* depth, void* out,
                              int gcap, int cap, int n_side, void* stream) {
  const size_t shmem = (size_t)3 * cap * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      deriv_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  deriv_eval_kernel<<<gcap, THREADS, shmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const float*>(matf), static_cast<const uint32_t*>(words),
      static_cast<const float*>(imms), static_cast<const int*>(runs_full),
      static_cast<const int*>(bid_op), static_cast<const int*>(tw),
      static_cast<const float*>(ti), static_cast<const int*>(runs),
      static_cast<const int*>(gmeta), static_cast<const int*>(depth),
      static_cast<float*>(out), cap, n_side);
  return (int)cudaGetLastError();
}
