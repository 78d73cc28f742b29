// Kernel V: the value of the field at the 4096 voxels of each ambiguous
// 16^3 cell, run with that cell's shortened tape.
//
// Replaces: mpr_tpu/ops/kernels3d.py::voxel_eval_3d (Pallas body
// `_make_voxel_kernel`), the reference's eval_voxels_f<3>.
//
// Bound on the H100: on paper its output (16 KB of values a cell, 1.76 GB
// over the 107,466 cells of the gyroid 1024^3 frame) or its float
// operations; in practice the interpreter's own work: each clause costs a
// decode, two operand loads and a store of a register file indexed by slot
// numbers known only at run time, against one or a few float operations.
// The first design kept that file in local memory sized for 256 slots and
// ran one voxel a thread: a short tape paid every clause's decode once a
// voxel, and a long one (176 slots, 704 B a voxel) lived in L2.
//
// Design: one block per cell slot g < nmeta[0]; the block finds its cell
// itself: child lane order[g] names a parent slot and one of its 64
// children, order0[parent slot] the slab-local 64^3 tile.  The cell's 16
// world coordinates along each axis are made once, into shared memory, and
// each voxel's position comes from them and the camera matrix in the JAX
// kernel's order of operations (world_coord, mat4_apply), which keeps depth
// bit-equal to the dense renderer.  The cell's shortened tape (words,
// immediates, run headers: 3 x cap int32, cap = Tcap/2) is staged in shared
// memory; a cell whose tape overflowed `cap` (gmeta[g, 2]) interprets the
// full tape from global memory.  A warp takes 32 x K voxels at a time from
// the block's work queue, each thread K of them (voxel l = chunk * 32K + k
// * 32 + lane, so each store of the output is coalesced), and walks the
// tape once for all K, with the register file (regfile.cuh) sized by
// s_cap: in shared memory for a short tape (gyroid: 16 slots, 256 threads,
// K = 4, one 16-byte access an operand), in a bucket-sized local array for
// a long one (extruded: 176 slots, 256 threads, K = 2); the host picks
// (voxel_launch).  A tape with more slots than s_cap traps.  Blocks with
// g >= nmeta[0] write nothing.
//
// Two libraries hold the instantiations (ops/build.py): the main one the
// shapes voxel_launch picks (K = 4 shared, K = 2 local), the extra one,
// built with MPR_EXTRA_SHAPES, the others, which only a forced launch shape
// reaches (ops/kernels3d.py::MAIN_K says which is which).

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"
#include "regfile.cuh"

namespace {

using namespace mpr;

constexpr int CELL = 16;
constexpr int CELL_VOXELS = CELL * CELL * CELL;

template <int K, class File>
__device__ __forceinline__ void eval_cell(File& f, const float* smat,
                                          const float* wtab, const int* nmeta,
                                          int* smem, const uint32_t* W,
                                          const float* I, const int* R,
                                          int n_runs, float* out) {
  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int chunk = next_chunk(smem + QUEUE_INT);
    if (chunk >= CELL_VOXELS / (32 * K)) break;
    const int base = chunk * 32 * K + lane;
    float x[K], y[K], z[K], zero[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = base + k * 32;
      mat4_apply(smat, wtab[l % CELL], wtab[CELL + (l / CELL) % CELL],
                 wtab[2 * CELL + l / (CELL * CELL)], x[k], y[k], z[k]);
      zero[k] = 0.0f;
    }
    f.store(sx, x);
    f.store(sy, y);
    f.store(sz, z);
    f.store(0, zero);  // slot 0: the "no operand" sentinel
    run_tape<FloatClause, K>(f, smem, W, I, R, n_runs);
    f.load(res, x);
#pragma unroll
    for (int k = 0; k < K; ++k) out[base + k * 32] = x[k];
  }
}

// N == 0: the register files in shared memory; else in local memory, N
// slots a thread.
template <int K, int N>
__global__ void __launch_bounds__(512, 1)
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
                  int cap, int n_side, int n_rows, int s_cap) {
  extern __shared__ __align__(16) int smem[];
  if (nmeta[1] > s_cap) __trap();  // the file has s_cap slots
  const int g = blockIdx.x;
  if (g >= nmeta[0]) return;

  // the cell: slab-local parent p = (tz * n_rows + ty_l) * n + tx, child
  // c = (czi * 4 + cyi) * 4 + cxi
  const int child = order[g];
  const int p = order0[child / 64];
  const int c = child % 64;
  const int tx = p % n_side;
  const int ty = nmeta[7] + (p / n_side) % n_rows;
  const int tz = p / (n_side * n_rows);
  const float size = (float)(n_side * 64);
  // the 16 world coordinates of the cell along each axis, made once
  float* wtab = reinterpret_cast<float*>(smem + 272);
  if (threadIdx.x < 3 * CELL) {
    const int axis = threadIdx.x / CELL;
    const float b = (float)(axis == 0 ? tx * 64 + (c % 4) * CELL
                            : axis == 1 ? ty * 64 + ((c / 4) % 4) * CELL
                                        : tz * 64 + (c / 16) * CELL);
    wtab[threadIdx.x] = world_coord(b + (float)(threadIdx.x % CELL), size);
  }

  stage_header(smem, bid_op, matf);
  int* st = smem + HEADER_INTS;
  const uint32_t* W;
  const float* I;
  const int* R;
  int n_runs;
  if (gmeta[(size_t)g * 8 + 2] == 0) {
    const size_t row = (size_t)g * cap;
    n_runs = min(gmeta[(size_t)g * 8 + 1], cap);
    stage_tape(st, cap, tw + row, ti + row, runs + row,
               min(gmeta[(size_t)g * 8 + 0], cap), n_runs);
    W = reinterpret_cast<const uint32_t*>(st);
    I = reinterpret_cast<const float*>(st + cap);
    R = st + 2 * cap;
  } else {
    // overflow: the reference keeps the parent tape
    W = words;
    I = imms;
    R = runs_full;
    n_runs = nmeta[6];
  }
  __syncthreads();

  const float* smat = reinterpret_cast<const float*>(smem + 256);
  float* out = vals + (size_t)g * CELL_VOXELS;
  if constexpr (N == 0) {
    SharedFile<float, K> f(reinterpret_cast<float*>(st + tape_ints(cap)),
                           blockDim.x);
    eval_cell<K>(f, smat, wtab, nmeta, smem, W, I, R, n_runs, out);
  } else {
    LocalFile<float, K, N> f;
    eval_cell<K>(f, smat, wtab, nmeta, smem, W, I, R, n_runs, out);
  }
}

using VoxelKernel = decltype(&voxel_eval_kernel<1, 0>);

#ifdef MPR_EXTRA_SHAPES
constexpr bool EXTRA = true;
#else
constexpr bool EXTRA = false;
#endif

// The instantiation for K and N, if this library holds it.
template <int K, int N>
VoxelKernel kernel() {
  constexpr bool in_main = K == (N == 0 ? 4 : 2);
  if constexpr (in_main != EXTRA) return voxel_eval_kernel<K, N>;
  return nullptr;
}

template <int K>
VoxelKernel pick_n(int bucket) {
  switch (bucket) {
    case 0: return kernel<K, 0>();
    case 16: return kernel<K, 16>();
    case 32: return kernel<K, 32>();
    case 64: return kernel<K, 64>();
    case 128: return kernel<K, 128>();
    case 256: return kernel<K, 256>();
    default: return nullptr;
  }
}

VoxelKernel pick(int k, int bucket) {
  switch (k) {
    case 1: return pick_n<1>(bucket);
    case 2: return pick_n<2>(bucket);
    case 4: return pick_n<4>(bucket);
    default: return nullptr;
  }
}

}  // namespace

// bucket 0: the register files in shared memory; 16..256: in local memory,
// that many slots.  smem is the dynamic shared memory the host computed for
// the shape (ops/kernels3d.py::voxel_launch), which also checks the shape;
// a shape this library does not hold returns cudaErrorInvalidValue.
extern "C" int mpr_voxel_eval(const void* nmeta, const void* order,
                              const void* order0, const void* matf,
                              const void* words, const void* imms,
                              const void* runs_full, const void* bid_op,
                              const void* tw, const void* ti,
                              const void* runs, const void* gmeta, void* vals,
                              int gcap, int cap, int n_side, int n_rows,
                              int s_cap, int bucket, int threads, int k,
                              int smem, void* stream) {
  const VoxelKernel fn = pick(k, bucket);
  // whole warps: the work queue hands chunks out with full-warp shuffles
  if (fn == nullptr || threads % 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<gcap, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const int*>(order0), static_cast<const float*>(matf),
      static_cast<const uint32_t*>(words), static_cast<const float*>(imms),
      static_cast<const int*>(runs_full), static_cast<const int*>(bid_op),
      static_cast<const int*>(tw), static_cast<const float*>(ti),
      static_cast<const int*>(runs), static_cast<const int*>(gmeta),
      static_cast<float*>(vals), cap, n_side, n_rows, s_cap);
  return (int)cudaGetLastError();
}
