// Kernel B: per-pixel float evaluation of each ambiguous 64x64 tile with
// that tile's shortened tape; decided tiles write their interval decision.
//
// Replaces: mpr_tpu/ops/kernels.py::pixel_eval_runs (Pallas body
// `_make_pixel_run_kernel`), the reference's eval_voxels_f<2> plus
// copy_filled.
//
// Bound on the H100: on paper its operations (len float operations a pixel
// against 16 KB of coordinates in and 16 KB of fill out a tile); in
// practice the L1 traffic of the interpreter's register file: each clause
// costs a decode, two operand loads and a store of a file indexed by slot
// numbers known only at run time.  The first design gave every thread a
// 256-slot array in local memory whatever the tape's slot count (512 KB of
// local file a block of 512 threads against 256 KB of L1), ran one pixel
// at a time, and one block a tile, so tiles of unequal length (96 to 805
// clauses at 1024^2) left the last of 1.84 waves half-empty.
//
// Design: the register file, the tape walk and the work queue of
// regfile.cuh (as kernel V): the file sized by the slot bucket s_cap, in
// shared memory for a short tape, in a bucket-sized local array for a
// long one (stress_2d: 173 slots, local, K = 2); K pixels a thread, so each
// clause's word is read and decoded once for K pixels; a thread's K pixels
// are neighbours, so their coordinates come in one 16-byte load (K = 4)
// and their fill goes out in one store.  Grid (rows, P): block (g, j) runs
// pixels [j * 4096/P, (j+1) * 4096/P) of row g of `order`, so a long tile
// is spread over P blocks and the card's block scheduler balances tiles of
// unequal length without a host read; the host picks P so that the grid
// fills the card (ops/launch.py::pixel_launch).  A warp takes 32 x K
// pixels at a time from the block's work queue.  The output goes to
// fill[order[g], :], so the image is a pure reshape of `fill`.  Blocks of
// rows g >= nmeta[0] or with a status other than AMBIG write their
// decision.  An ambiguous block stages its shortened tape (words, imms,
// run headers: 3 x cap int32) in shared memory; a tile whose tape
// overflowed `cap` (gmeta[g, 2]) runs the full tape, staged too where the
// host found room (stage_full), else from global memory.  A tape with
// more slots than s_cap traps.
//
// Two libraries hold the instantiations (ops/build.py): the main one the
// shapes pixel_launch picks (K = 4 shared, K = 2 local), the extra one,
// built with MPR_EXTRA_SHAPES, the others, which only a forced launch
// shape reaches (ops/launch.py::MAIN_K says which is which).

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"
#include "regfile.cuh"

namespace {

using namespace mpr;

constexpr int TILE_PIXELS = 4096;

template <int K, class File>
__device__ __forceinline__ void eval_pixels(File& f, const int* nmeta,
                                            int* smem, const float* c,
                                            const uint32_t* W,
                                            const float* I, const int* R,
                                            int n_runs, int* out) {
  using FG = Group<float, K>;
  using IG = Group<int, K>;
  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  const int lane = threadIdx.x & 31;
  const int per = TILE_PIXELS / gridDim.y;
  const int first = blockIdx.y * per;
  for (;;) {
    const int chunk = next_chunk(smem + QUEUE_INT);
    if (chunk >= per / (32 * K)) break;
    // this thread's K neighbouring pixels
    const int l = first + chunk * 32 * K + lane * K;
    const FG gx = *reinterpret_cast<const FG*>(c + l);
    const FG gy = *reinterpret_cast<const FG*>(c + TILE_PIXELS + l);
    const FG gz = *reinterpret_cast<const FG*>(c + 2 * TILE_PIXELS + l);
    float x[K], y[K], z[K], zero[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = gx.v[k];
      y[k] = gy.v[k];
      z[k] = gz.v[k];
      zero[k] = 0.0f;
    }
    f.store(sx, x);
    f.store(sy, y);
    f.store(sz, z);
    f.store(0, zero);  // slot 0: the "no operand" sentinel
    run_tape<FloatClause, K>(f, smem, W, I, R, n_runs);
    f.load(res, x);
    IG o;
#pragma unroll
    for (int k = 0; k < K; ++k) o.v[k] = x[k] < 0.0f ? 1 : 0;
    *reinterpret_cast<IG*>(out + l) = o;
  }
}

// N == 0: the register files in shared memory; else in local memory, N
// slots a thread.
template <int K, int N>
__global__ void __launch_bounds__(512, 1)
pixel_eval_kernel(const int* __restrict__ nmeta,  // [n_amb, S, res, sx, sy, sz, n_runs_full, 0]
                  const int* __restrict__ order,
                  const int* __restrict__ status,
                  const uint32_t* __restrict__ words,  // full tape (tcap,)
                  const float* __restrict__ imms,
                  const int* __restrict__ runs_full,
                  const int* __restrict__ bid_op,      // (256,) branch id -> op
                  const int* __restrict__ tw,          // (gcap, cap)
                  const float* __restrict__ ti,
                  const int* __restrict__ runs,
                  const int* __restrict__ gmeta,       // (gcap, 8)
                  const float* __restrict__ coords,    // (n_tiles, 3, 4096)
                  int* __restrict__ fill,              // (n_tiles, 4096)
                  int cap, int s_cap, int tcap, int stage_full) {
  extern __shared__ __align__(16) int smem[];
  if (nmeta[1] > s_cap) __trap();  // the file has s_cap slots
  const int g = blockIdx.x;
  const int tile = order[g];
  const int st = status[tile];
  int* out = fill + (size_t)tile * TILE_PIXELS;
  if (g >= nmeta[0] || st != ST_AMBIG) {
    const int per = TILE_PIXELS / gridDim.y;
    const int4 v = make_int4(st == ST_FILLED, st == ST_FILLED,
                             st == ST_FILLED, st == ST_FILLED);
    int4* o = reinterpret_cast<int4*>(out + blockIdx.y * per);
    for (int p = threadIdx.x; p < per / 4; p += blockDim.x) o[p] = v;
    return;
  }

  for (int i = threadIdx.x; i < 256; i += blockDim.x) smem[i] = bid_op[i];
  if (threadIdx.x == 0) smem[QUEUE_INT] = 0;
  const int T = stage_full ? max(cap, tcap) : cap;
  int* st_tape = smem + HEADER_INTS;
  const uint32_t* W = reinterpret_cast<const uint32_t*>(st_tape);
  const float* I = reinterpret_cast<const float*>(st_tape + T);
  const int* R = st_tape + 2 * T;
  int n_runs;
  if (gmeta[(size_t)g * 8 + 2] == 0) {
    const size_t row = (size_t)g * cap;
    n_runs = min(gmeta[(size_t)g * 8 + 1], cap);
    stage_tape(st_tape, T, tw + row, ti + row, runs + row,
               min(gmeta[(size_t)g * 8 + 0], cap), n_runs);
  } else if (stage_full) {
    // overflow: the reference keeps the parent tape, here staged whole
    n_runs = nmeta[6];
    stage_tape(st_tape, T, reinterpret_cast<const int*>(words), imms,
               runs_full, tcap, n_runs);
  } else {
    W = words;
    I = imms;
    R = runs_full;
    n_runs = nmeta[6];
  }
  __syncthreads();

  const float* c = coords + (size_t)tile * 3 * TILE_PIXELS;
  if constexpr (N == 0) {
    SharedFile<float, K> f(reinterpret_cast<float*>(st_tape + tape_ints(T)),
                           blockDim.x);
    eval_pixels<K>(f, nmeta, smem, c, W, I, R, n_runs, out);
  } else {
    LocalFile<float, K, N> f;
    eval_pixels<K>(f, nmeta, smem, c, W, I, R, n_runs, out);
  }
}

using PixelKernel = decltype(&pixel_eval_kernel<1, 0>);

#ifdef MPR_EXTRA_SHAPES
constexpr bool EXTRA = true;
#else
constexpr bool EXTRA = false;
#endif

// The instantiation for K and N, if this library holds it.
template <int K, int N>
PixelKernel kernel() {
  constexpr bool in_main = K == (N == 0 ? 4 : 2);
  if constexpr (in_main != EXTRA) return pixel_eval_kernel<K, N>;
  return nullptr;
}

template <int K>
PixelKernel pick_n(int bucket) {
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

PixelKernel pick(int k, int bucket) {
  switch (k) {
    case 1: return pick_n<1>(bucket);
    case 2: return pick_n<2>(bucket);
    case 4: return pick_n<4>(bucket);
    default: return nullptr;
  }
}

}  // namespace

// bucket 0: the register files in shared memory; 16..256: in local memory,
// that many slots.  parts is P, the blocks a row; smem the dynamic shared
// memory the host computed for the shape (ops/launch.py::pixel_launch,
// which also checks it); a shape this library does not hold returns
// cudaErrorInvalidValue.
extern "C" int mpr_pixel_eval(const void* nmeta, const void* order,
                              const void* status, const void* words,
                              const void* imms, const void* runs_full,
                              const void* bid_op, const void* tw,
                              const void* ti, const void* runs,
                              const void* gmeta, const void* coords,
                              void* fill, int gcap, int cap, int s_cap,
                              int tcap, int bucket, int threads, int k,
                              int parts, int stage_full, int smem,
                              void* stream) {
  const PixelKernel fn = pick(k, bucket);
  // whole warps (the work queue's full-warp shuffles), whole chunks a block
  if (fn == nullptr || threads % 32 || parts < 1 ||
      TILE_PIXELS % (32 * k * parts))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<dim3(gcap, parts), threads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const int*>(status), static_cast<const uint32_t*>(words),
      static_cast<const float*>(imms), static_cast<const int*>(runs_full),
      static_cast<const int*>(bid_op), static_cast<const int*>(tw),
      static_cast<const float*>(ti), static_cast<const int*>(runs),
      static_cast<const int*>(gmeta), static_cast<const float*>(coords),
      static_cast<int*>(fill), cap, s_cap, tcap, stage_full);
  return (int)cudaGetLastError();
}
