// Kernel D: value and gradient (v, d/dx, d/dy, d/dz) of the field by
// forward-mode dual numbers, at each pixel of each 64-px screen tile with
// content, one voxel in front of the depth surface.
//
// Replaces: mpr_tpu/ops/kernels3d.py::deriv_eval_3d (Pallas body
// `_make_deriv_kernel` with `_deriv_branch_list`), the reference's
// eval_pixels_d.
//
// Bound on the H100: operations on paper (each pixel runs its tile's
// z-column tape once with four floats a slot, against 16 KB of depth in and
// 64 KB of (v, gradient) out per tile); in practice where the dual-number
// register file lives.  In shared memory a 176-slot file is 2.8 KB a pixel,
// so an SM holds 64 pixels and waits on each clause's latency; in local
// memory every operand goes to L2.  The first design also ran one block a
// tile, so a frame with few tiles (58 at the extruded 512^3 cell) left most
// of the 132 SMs idle, and read an overflowed column's tape (every column
// there) from global memory.
//
// Design: grid (rows, P): block (g, j) runs pixels [j * 4096/P, (j+1) *
// 4096/P) of row g < nmeta[0] of `order` (tiles with content first); the
// host picks P so that the grid fills the card.  Tile t = order[g] gives
// the screen position, its depth comes from depth_blocks[t], and the output
// goes to out[g] (row order: the caller scatters rows back to tiles).  The
// seeds are the transformed coordinates with unit derivatives in world
// space, not pushed through the camera matrix, as the JAX kernel has them.
// The tile's column tape (3 x cap int32) is staged in shared memory; an
// overflowed column runs the full tape, staged in shared memory too where
// the host found room (stage_full), else from global memory.  A warp takes
// 32 x K pixels at a time from the block's work queue, each thread K of
// them, with the register file (regfile.cuh) in shared memory for a short
// tape (gyroid: 16 slots, 256 threads), or split by warps for a long one
// (extruded: 2 warps' files in shared memory, 6 in local memory, so that
// the latency-bound and the L2-bound warps run side by side and share the
// queue by their speed); the host picks (deriv_launch).  A tape with more
// slots than s_cap traps.
//
// Two libraries hold the instantiations (ops/build.py): the main one the
// shapes deriv_launch picks (K = 1, every home), the extra one, built with
// MPR_EXTRA_SHAPES, the others (K = 2, 4), which only a forced launch shape
// reaches (ops/kernels3d.py::MAIN_K says which is which).

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"
#include "regfile.cuh"

namespace {

using namespace mpr;

constexpr int TILE = 64;
constexpr int TILE_PIXELS = TILE * TILE;

template <int K, class File>
__device__ __forceinline__ void eval_pixels(File& f, const float* smat,
                                            float bx, float by, int isize,
                                            const int* d, const int* nmeta,
                                            int* smem, const uint32_t* W,
                                            const float* I, const int* R,
                                            int n_runs, float* o) {
  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  const int lane = threadIdx.x & 31;
  const int per = TILE_PIXELS / gridDim.y;
  const int first = blockIdx.y * per;
  const float size = (float)isize;
  for (;;) {
    const int chunk = next_chunk(smem + QUEUE_INT);
    if (chunk >= per / (32 * K)) break;
    const int base = first + chunk * 32 * K + lane;
    Dv seed[3][K], zero[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = base + k * 32;
      const float px = (float)(l % TILE);
      const float py = (float)(l / TILE);
      // depth stores the top filled voxel's index + 1, so voxel d is the
      // first empty one: the sample lies one voxel in front of the surface
      const float zi = (float)min(d[l], isize - 1);
      float x, y, z;
      mat4_apply(smat, world_coord(bx + px, size), world_coord(by + py, size),
                 world_coord(zi, size), x, y, z);
      seed[0][k] = Dv{x, 1.0f, 0.0f, 0.0f};
      seed[1][k] = Dv{y, 0.0f, 1.0f, 0.0f};
      seed[2][k] = Dv{z, 0.0f, 0.0f, 1.0f};
      zero[k] = Dv{0.0f, 0.0f, 0.0f, 0.0f};
    }
    f.store(sx, seed[0]);
    f.store(sy, seed[1]);
    f.store(sz, seed[2]);
    f.store(0, zero);  // slot 0: the "no operand" sentinel
    run_tape<DerivClause, K>(f, smem, W, I, R, n_runs);
    Dv v[K];
    f.load(res, v);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = base + k * 32;
      o[l] = v[k].v;
      o[TILE_PIXELS + l] = v[k].dx;
      o[2 * TILE_PIXELS + l] = v[k].dy;
      o[3 * TILE_PIXELS + l] = v[k].dz;
    }
  }
}

// N == 0: every warp keeps its register file in shared memory; else the
// first shared_warps warps do and the rest keep theirs in local memory, N
// slots.  The staged-tape region holds T entries an array: cap, or the full
// tape's tcap where stage_full is set.  Four dual numbers a thread, pipelined,
// need more than 128 registers: those instantiations take at most 256
// threads.
template <int K>
constexpr int max_threads() { return K == 4 ? 256 : 512; }

template <int K, int N>
__global__ void __launch_bounds__(max_threads<K>(), 1)
deriv_eval_kernel(const int* __restrict__ nmeta,  // [n_act, S, res, sx, sy, sz, n_runs_full, row0]
                  const int* __restrict__ order,   // xy tile per row
                  const float* __restrict__ matf,  // (16,) row-major mat4
                  const uint32_t* __restrict__ words,  // full tape (tcap,)
                  const float* __restrict__ imms,
                  const int* __restrict__ runs_full,
                  const int* __restrict__ bid_op,      // (256,) branch id -> op
                  const int* __restrict__ tw,          // (gcap, cap)
                  const float* __restrict__ ti,
                  const int* __restrict__ runs,
                  const int* __restrict__ gmeta,       // (gcap, 8)
                  const int* __restrict__ depth,       // (n_tiles, 4096)
                  float* __restrict__ out,             // (gcap, 4, 4096)
                  int cap, int n_side, int s_cap, int tcap, int stage_full,
                  int shared_warps) {
  extern __shared__ __align__(16) int smem[];
  if (nmeta[1] > s_cap) __trap();  // the file has s_cap slots
  const int g = blockIdx.x;
  if (g >= nmeta[0]) return;

  stage_header(smem, bid_op, matf);
  const int T = stage_full ? max(cap, tcap) : cap;
  int* st = smem + HEADER_INTS;
  const uint32_t* W = reinterpret_cast<const uint32_t*>(st);
  const float* I = reinterpret_cast<const float*>(st + T);
  const int* R = st + 2 * T;
  int n_runs;
  if (gmeta[(size_t)g * 8 + 2] == 0) {
    const size_t row = (size_t)g * cap;
    n_runs = min(gmeta[(size_t)g * 8 + 1], cap);
    stage_tape(st, T, tw + row, ti + row, runs + row,
               min(gmeta[(size_t)g * 8 + 0], cap), n_runs);
  } else if (stage_full) {
    // overflow: the reference keeps the parent tape, here staged whole
    n_runs = nmeta[6];
    stage_tape(st, T, reinterpret_cast<const int*>(words), imms, runs_full,
               tcap, n_runs);
  } else {
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
  const int* d = depth + (size_t)t * TILE_PIXELS;
  const float* smat = reinterpret_cast<const float*>(smem + 256);
  float* o = out + (size_t)g * 4 * TILE_PIXELS;
  float* file = reinterpret_cast<float*>(st + tape_ints(T));
  if (N == 0 || (int)(threadIdx.x >> 5) < shared_warps) {
    SharedFile<Dv, K> f(file, N == 0 ? blockDim.x : 32 * shared_warps);
    eval_pixels<K>(f, smat, bx, by, isize, d, nmeta, smem, W, I, R, n_runs,
                   o);
  } else if constexpr (N > 0) {
    LocalFile<Dv, K, N> f;
    eval_pixels<K>(f, smat, bx, by, isize, d, nmeta, smem, W, I, R, n_runs,
                   o);
  }
}

using DerivKernel = decltype(&deriv_eval_kernel<1, 0>);

#ifdef MPR_EXTRA_SHAPES
constexpr bool EXTRA = true;
#else
constexpr bool EXTRA = false;
#endif

// The instantiation for K and N, if this library holds it.
template <int K, int N>
DerivKernel kernel() {
  constexpr bool in_main = K == 1;
  if constexpr (in_main != EXTRA) return deriv_eval_kernel<K, N>;
  return nullptr;
}

template <int K>
DerivKernel pick_n(int bucket) {
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

DerivKernel pick(int k, int bucket) {
  switch (k) {
    case 1: return pick_n<1>(bucket);
    case 2: return pick_n<2>(bucket);
    case 4: return pick_n<4>(bucket);
    default: return nullptr;
  }
}

}  // namespace

// bucket 0: every warp in the shared home; 16..256: the first
// shared_warps warps there, the others in the local home with that many
// slots.  parts is P, the blocks a row; smem the dynamic shared memory the
// host computed for the shape (ops/kernels3d.py::deriv_launch), which also
// checks the shape; a shape this library does not hold, or one whose
// shared files would run past the block, returns cudaErrorInvalidValue.
extern "C" int mpr_deriv_eval(const void* nmeta, const void* order,
                              const void* matf, const void* words,
                              const void* imms, const void* runs_full,
                              const void* bid_op, const void* tw,
                              const void* ti, const void* runs,
                              const void* gmeta, const void* depth, void* out,
                              int gcap, int cap, int n_side, int s_cap,
                              int tcap, int bucket, int threads, int k,
                              int parts, int stage_full, int shared_warps,
                              int smem, void* stream) {
  const DerivKernel fn = pick(k, bucket);
  // whole warps (the work queue's full-warp shuffles), and no more warps
  // in the shared home than the block has
  if (fn == nullptr || threads % 32 || shared_warps < 0 ||
      32 * shared_warps > threads ||
      (bucket == 0 && 32 * shared_warps != threads))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<dim3(gcap, parts), threads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const float*>(matf), static_cast<const uint32_t*>(words),
      static_cast<const float*>(imms), static_cast<const int*>(runs_full),
      static_cast<const int*>(bid_op), static_cast<const int*>(tw),
      static_cast<const float*>(ti), static_cast<const int*>(runs),
      static_cast<const int*>(gmeta), static_cast<const int*>(depth),
      static_cast<float*>(out), cap, n_side, s_cap, tcap, stage_full,
      shared_warps);
  return (int)cudaGetLastError();
}
