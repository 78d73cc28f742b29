// Kernel V: the value of the field at the 4096 voxels of each ambiguous
// 16^3 cell, run with that cell's shortened tape.
//
// Replaces: mpr_tpu/ops/kernels3d.py::voxel_eval_3d (Pallas body
// `_make_voxel_kernel`), the reference's eval_voxels_f<3>.
//
// Bound on the H100: operations, and in practice the latency of the
// per-voxel register file.  Each voxel runs its cell's tape (len clauses)
// once: len float operations per voxel against a few KB of tape in and
// 16 KB of values out per cell.  The register file is a per-thread array
// indexed by slot numbers known only at run time, so it lives in local
// memory (L1-cached), one load per operand and one store per clause, as in
// kernel B.
//
// Design: one block per cell slot g < nmeta[0].  The block finds its cell
// itself: child lane order[g] names a parent slot and one of its 64
// children, order0[parent slot] the slab-local 64^3 tile, and the voxel
// coordinates come from those, the slab's first tile row and the camera
// matrix, in the kernel (an array of them would be 48 KB a cell).  The
// cell's shortened tape (words, imms, run headers: 3 x cap int32, cap =
// Tcap/2 here) is first copied into shared memory; every thread then walks
// the same runs for its voxels, so a warp takes one branch and reads one
// shared word (a broadcast).  Dispatch is one switch per opcode run.  A
// cell whose tape overflowed `cap` (gmeta[g, 2]) interprets the full tape
// from global memory.  Blocks with g >= nmeta[0] write nothing.

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"

namespace {

using namespace mpr;

constexpr int REG_CAP = 256;  // slot numbers are bytes
constexpr int THREADS = 512;
constexpr int CELL = 16;
constexpr int CELL_VOXELS = CELL * CELL * CELL;

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
voxel_eval_kernel(const int* __restrict__ nmeta,  // [n_amb1, S, res, sx, sy, sz, n_runs_full, row0]
                  const int* __restrict__ order,   // child lane per row
                  const int* __restrict__ order0,  // parent tile per parent slot
                  const float* __restrict__ matf,  // (16,) row-major mat4
                  const uint32_t* __restrict__ words,  // full tape
                  const float* __restrict__ imms,
                  const int* __restrict__ runs_full,
                  const int* __restrict__ bid_op,      // (256,) branch id -> op
                  const int* __restrict__ tw,          // (gcap, cap)
                  const float* __restrict__ ti,
                  const int* __restrict__ runs,
                  const int* __restrict__ gmeta,       // (gcap, 8)
                  float* __restrict__ vals,            // (gcap, 4096)
                  int cap, int n_side, int n_rows) {
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

  // the cell: slab-local parent p = (tz * n_rows + ty_l) * n + tx, child
  // c = (czi * 4 + cyi) * 4 + cxi
  const int child = order[g];
  const int p = order0[child / 64];
  const int c = child % 64;
  const int tx = p % n_side;
  const int ty = nmeta[7] + (p / n_side) % n_rows;
  const int tz = p / (n_side * n_rows);
  const float bx = (float)(tx * 64 + (c % 4) * CELL);
  const float by = (float)(ty * 64 + ((c / 4) % 4) * CELL);
  const float bz = (float)(tz * 64 + (c / 16) * CELL);
  const float size = (float)(n_side * 64);

  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  float* out = vals + (size_t)g * CELL_VOXELS;
  for (int l = threadIdx.x; l < CELL_VOXELS; l += blockDim.x) {
    const float vx = (float)(l % CELL);
    const float vy = (float)((l / CELL) % CELL);
    const float vz = (float)(l / (CELL * CELL));
    float x, y, z;
    mat4_apply(smat, world_coord(bx + vx, size), world_coord(by + vy, size),
               world_coord(bz + vz, size), x, y, z);
    float regs[REG_CAP];
    regs[sx] = x;
    regs[sy] = y;
    regs[sz] = z;
    regs[0] = 0.0f;  // slot 0: the "no operand" sentinel
    int t0 = 0;
    for (int r = 0; r < n_runs; ++r) {
      const int hdr = R[r];
      const int cnt = hdr >> 8;
      run_dispatch(sop[hdr & 0xFF], regs, W, I, t0, cnt);
      t0 += cnt;
    }
    out[l] = regs[res];
  }
}

}  // namespace

extern "C" int mpr_voxel_eval(const void* nmeta, const void* order,
                              const void* order0, const void* matf,
                              const void* words, const void* imms,
                              const void* runs_full, const void* bid_op,
                              const void* tw, const void* ti,
                              const void* runs, const void* gmeta, void* vals,
                              int gcap, int cap, int n_side, int n_rows,
                              void* stream) {
  // cap = Tcap/2: 96 KB a block for the 16384 bucket, so the opt-in to
  // more than 48 KB of dynamic shared memory stays
  const size_t shmem = (size_t)3 * cap * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      voxel_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  voxel_eval_kernel<<<gcap, THREADS, shmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const int*>(order0), static_cast<const float*>(matf),
      static_cast<const uint32_t*>(words), static_cast<const float*>(imms),
      static_cast<const int*>(runs_full), static_cast<const int*>(bid_op),
      static_cast<const int*>(tw), static_cast<const float*>(ti),
      static_cast<const int*>(runs), static_cast<const int*>(gmeta),
      static_cast<float*>(vals), cap, n_side, n_rows);
  return (int)cudaGetLastError();
}
