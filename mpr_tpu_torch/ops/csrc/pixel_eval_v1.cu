// Kernel B1: per-pixel float evaluation of each group's tile with that
// tile's own tape, returning values.
//
// Replaces: mpr_tpu/ops/kernels.py::pixel_eval (Pallas body
// `_pixel_eval_kernel`), the first public version of kernel B: it returns
// the VALUES of the P pixels of tile order[g] (kernel B returns the 0/1
// fill), reads the tapes in TILE order (tape row order[g], length
// lens[order[g]] clamped to [0, cap]), has no run headers, no status and
// no overflow path, and runs the full float branch list: opcodes 0 and 1
// give a * 0, an opcode past 31 runs the last branch.
//
// Bound on the H100: on paper its operations (len float operations a pixel
// against 12 bytes of coordinates in and 4 bytes of value out); in
// practice, as for kernel B, the L1 traffic of the interpreter's register
// file, indexed by slot numbers known only at run time.  The first design
// gave every thread a 256-slot local array whatever the tape's slot count
// (512 KB a block of 512 threads against 256 KB of L1), ran one pixel a
// thread, one block a tile (tiles of unequal length left the last wave
// half empty) and a 32-way switch on every clause.
//
// Design: kernel B's (pixel_eval.cu), on regfile.cuh's register file, run
// walk and work queue:
//   * the file sized by the slot bucket s_cap, in shared memory for a
//     short tape and in a bucket-sized local array for a long one, K
//     neighbouring pixels a thread, whose coordinates come in one load of
//     4K bytes and whose values go out in one store where P is a multiple
//     of K (the ragged last chunk of a row is masked);
//   * grid (rows, parts): block (g, j) takes pixels [j * per, (j+1) * per)
//     of row g, per a multiple of 32 K, so a long tile spreads over several
//     blocks; a warp takes 32 K pixels at a time from the block's work
//     queue (next_chunk); the host picks home, threads, K and parts
//     (ops/launch.py::pixel_v1_launch);
//   * B1's tape has no run headers, so the block builds them while it
//     stages the tile's tape in shared memory (words and immediates read 16
//     bytes at a time where the rows allow): a run is a stretch of equal
//     opcodes, found with one block scan; the warps then walk the runs as
//     kernel B does (one switch a run, the next run read ahead), on the
//     full branch list (regfile.cuh's run_op<.., ALL = true>);
//   * a tape longer than the staged capacity T (the host's, at most
//     launch.B1_STAGE clauses, so that an SM still holds a full set of
//     blocks) is read from global memory, each run found as the warps walk
//     it; no capacity fails.  Both walks share one switch (one run_op call
//     site), which keeps the source's build time near kernel B's.
// Rows g >= nmeta[0], and rows whose order entry names no tile, are left as
// allocated.  A tape with more slots than s_cap traps.
//
// Two libraries hold the instantiations (ops/build.py): the main one the
// shapes pixel_v1_launch picks (K = 4 shared, K = 2 local), the extra one,
// built with MPR_EXTRA_SHAPES, the others (ops/launch.py::MAIN_K).

#include <cuda_runtime.h>
#include <cstdint>

#include "block_scan.cuh"
#include "clause.cuh"
#include "regfile.cuh"

namespace {

using namespace mpr;

// Stage the n clauses of a tile's tape (W, I) in the staged-tape region
// `st` of T entries and build its run headers `op | count << 8` there
// (they cover [0, n) in order, so the walk needs no run count).  Each
// thread takes a contiguous piece of [0, n), a multiple of 4 clauses long
// (16-byte loads where `vec`), counts the run heads in it (an opcode
// unlike the one before), and the block's scan numbers them.  A head
// stores its start first; each thread then turns its own starts into
// headers, last first, once the start after its last head is read.
// Barriers: the scan's two and two more; the caller's next one makes the
// headers visible.
__device__ __forceinline__ void stage_runs(int* st, int T, const uint32_t* W,
                                          const float* I, int n, bool vec,
                                          int* warp_sums) {
  uint32_t* sw = reinterpret_cast<uint32_t*>(st);
  float* si = reinterpret_cast<float*>(st + T);
  int* sr = st + 2 * T;
  const int per = (((n + (int)blockDim.x - 1) / (int)blockDim.x) + 3) & ~3;
  const int k0 = min((int)threadIdx.x * per, n), k1 = min(k0 + per, n);
  int prev = k0 > 0 ? w_op(__ldg(W + k0 - 1)) : -1;
  int heads = 0;
  for (int k = k0; k < k1; k += 4) {
    uint32_t w[4];
    float im[4];
    if (vec) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(W + k));
      const float4 b = __ldg(reinterpret_cast<const float4*>(I + k));
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      im[0] = b.x; im[1] = b.y; im[2] = b.z; im[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = k + j < k1 ? __ldg(W + k + j) : 0u;
        im[j] = k + j < k1 ? __ldg(I + k + j) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k + j < k1) {
        sw[k + j] = w[j];
        si[k + j] = im[j];
        heads += w_op(w[j]) != prev;
        prev = w_op(w[j]);
      }
    }
  }
  int n_runs;
  const int r0 = block_scan(heads, warp_sums, &n_runs);  // staging visible
  prev = k0 > 0 ? w_op(sw[k0 - 1]) : -1;
  int r = r0;
  for (int k = k0; k < k1; ++k) {
    const int op = w_op(sw[k]);
    if (op != prev) sr[r++] = k;
    prev = op;
  }
  __syncthreads();
  const int end0 = r < n_runs ? sr[r] : n;  // the start after my last head
  __syncthreads();
  int end = end0;
  for (int q = r - 1; q >= r0; --q) {
    const int s = sr[q];
    sr[q] = w_op(sw[s]) | ((end - s) << 8);
    end = s;
  }
}

// Walk a tape run by run, as regfile.cuh's run_tape does (one switch a
// run, the next run's opcode, length and first clause read during this
// one), on the full branch list.  A run comes from the staged headers
// (R[r] = op | count << 8) or, for a tape read from global memory
// (R == nullptr), from the words themselves: a stretch of equal opcodes.
// One switch for both, so that each instantiation compiles it once.
template <int K, class File>
__device__ __forceinline__ void walk(File& f, const uint32_t* W,
                                     const float* I, const int* R, int n) {
  auto run_at = [&](int t, int r, int* op, int* cnt) {
    if (R != nullptr) {
      const int hdr = R[r];
      *op = hdr & 0xFF;
      *cnt = hdr >> 8;
    } else {
      *op = w_op(W[t]);
      int c = 1;
      while (t + c < n && w_op(W[t + c]) == *op) ++c;
      *cnt = c;
    }
  };
  if (n <= 0) return;
  int t0 = 0, op, cnt;
  run_at(0, 0, &op, &cnt);
  Word w0 = {W[0], I[0]};
  for (int r = 0;; ++r) {
    const int t1 = t0 + cnt;
    int op_n = 0, cnt_n = 0;
    Word w0_n = {0u, 0.0f};
    if (t1 < n) {
      run_at(t1, r + 1, &op_n, &cnt_n);
      w0_n = {W[t1], I[t1]};
    }
    run_op<FloatClause, K, true>(f, op, W, I, t0, cnt, w0);
    if (t1 >= n) break;
    t0 = t1;
    op = op_n;
    cnt = cnt_n;
    w0 = w0_n;
  }
}

template <int K, class File>
__device__ __forceinline__ void eval_pixels(File& f, const int* nmeta,
                                            int* smem, const float* c,
                                            int P, bool vec,
                                            const uint32_t* W, const float* I,
                                            const int* R, int n, float* out) {
  using FG = Group<float, K>;
  const int res = nmeta[2], sx = nmeta[3], sy = nmeta[4], sz = nmeta[5];
  const int lane = threadIdx.x & 31;
  const int span = 32 * K;
  const int per = ((P + (int)gridDim.y - 1) / (int)gridDim.y + span - 1)
                  / span * span;
  const int first = blockIdx.y * per;
  const int last = min(first + per, P);
  const int n_chunks = (last - first + span - 1) / span;
  for (;;) {
    const int chunk = next_chunk(smem + QUEUE_INT);
    if (chunk >= n_chunks) break;
    // this thread's K neighbouring pixels
    const int l = first + chunk * span + lane * K;
    const bool whole = vec && l + K <= last;
    float x[K], y[K], z[K], zero[K];
    if (whole) {
      const FG gx = *reinterpret_cast<const FG*>(c + l);
      const FG gy = *reinterpret_cast<const FG*>(c + P + l);
      const FG gz = *reinterpret_cast<const FG*>(c + 2 * P + l);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        x[k] = gx.v[k];
        y[k] = gy.v[k];
        z[k] = gz.v[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool in = l + k < last;
        x[k] = in ? c[l + k] : 0.0f;
        y[k] = in ? c[P + l + k] : 0.0f;
        z[k] = in ? c[2 * P + l + k] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) zero[k] = 0.0f;
    f.store(sx, x);
    f.store(sy, y);
    f.store(sz, z);
    f.store(0, zero);  // slot 0: the "no operand" sentinel
    walk<K>(f, W, I, R, n);
    f.load(res, x);
    if (whole) {
      FG o;
#pragma unroll
      for (int k = 0; k < K; ++k) o.v[k] = x[k];
      *reinterpret_cast<FG*>(out + l) = o;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (l + k < last) out[l + k] = x[k];
    }
  }
}

// N == 0: the register files in shared memory; else in local memory, N
// slots a thread.  T: clauses of a tape staged in shared memory at most.
template <int K, int N>
__global__ void __launch_bounds__(512, 1)
pixel_eval_v1_kernel(const int* __restrict__ nmeta,  // [n_groups, S, res, sx, sy, sz, ..]
                     const int* __restrict__ order,  // (gcap,)
                     const int* __restrict__ lens,   // (n_tiles,)
                     const uint32_t* __restrict__ tape_words,  // (n_tiles, cap)
                     const float* __restrict__ tape_imms,
                     const float* __restrict__ coords,  // (n_tiles, 3, P)
                     float* __restrict__ vals,          // (gcap, P)
                     int n_tiles, int cap, int P, int s_cap, int T, int vec,
                     int vec_tape) {
  extern __shared__ __align__(16) int smem[];
  if (nmeta[1] > s_cap) __trap();  // the file has s_cap slots
  const int g = blockIdx.x;
  if (g >= nmeta[0]) return;
  const int tile = order[g];
  if (tile < 0 || tile >= n_tiles) return;   // a bad order entry: no access
  const int n = max(0, min(lens[tile], cap));

  // the header (regfile.cuh's layout): the scan's warp sums (in kernel
  // V's coordinate table, unused here) and the work queue's counter; a run
  // header holds its opcode, so no branch table
  if (threadIdx.x == 0) smem[QUEUE_INT] = 0;
  const uint32_t* W = tape_words + (size_t)tile * cap;
  const float* I = tape_imms + (size_t)tile * cap;
  int* st = smem + HEADER_INTS;
  const int* R = nullptr;  // no headers: runs found in the words
  if (n <= T) {
    stage_runs(st, T, W, I, n, vec_tape != 0, smem + 272);
    W = reinterpret_cast<const uint32_t*>(st);
    I = reinterpret_cast<const float*>(st + T);
    R = st + 2 * T;
  }
  __syncthreads();

  const float* c = coords + (size_t)tile * 3 * P;
  float* out = vals + (size_t)g * P;
  if constexpr (N == 0) {
    SharedFile<float, K> f(reinterpret_cast<float*>(st + tape_ints(T)),
                           blockDim.x);
    eval_pixels<K>(f, nmeta, smem, c, P, vec != 0, W, I, R, n, out);
  } else {
    LocalFile<float, K, N> f;
    eval_pixels<K>(f, nmeta, smem, c, P, vec != 0, W, I, R, n, out);
  }
}

using PixelKernel = decltype(&pixel_eval_v1_kernel<1, 0>);

#ifdef MPR_EXTRA_SHAPES
constexpr bool EXTRA = true;
#else
constexpr bool EXTRA = false;
#endif

// The instantiation for K and N, if this library holds it.
template <int K, int N>
PixelKernel kernel() {
  constexpr bool in_main = K == (N == 0 ? 4 : 2);
  if constexpr (in_main != EXTRA) return pixel_eval_v1_kernel<K, N>;
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

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

}  // namespace

// bucket 0: the register files in shared memory; 16..256: in local memory,
// that many slots.  parts: blocks a row; staged: T, the clauses of a tape
// staged in shared memory at most (0: every tape is read from global
// memory); smem: the dynamic shared memory the host computed for the shape
// (ops/launch.py::pixel_v1_launch), which must be the header, T staged
// clauses and the shared files.  A shape this library does not hold
// returns cudaErrorInvalidValue.
extern "C" int mpr_pixel_eval_v1(const void* nmeta, const void* order,
                                 const void* lens, const void* tape_words,
                                 const void* tape_imms, const void* coords,
                                 void* vals, int gcap, int n_tiles, int cap,
                                 int P, int s_cap, int bucket, int threads,
                                 int k, int parts, int staged, int smem,
                                 void* stream) {
  const PixelKernel fn = pick(k, bucket);
  const long want = 4L * (HEADER_INTS + tape_ints(staged))
                    + (bucket == 0 ? 4L * s_cap * k * threads : 0L);
  // whole warps (the work queue's full-warp shuffles)
  if (fn == nullptr || threads % 32 || threads > 512 || parts < 1 ||
      parts > 65535 || P < 1 || cap < 1 || staged < 0 || staged > cap ||
      smem != want)
    return (int)cudaErrorInvalidValue;
  const int vec = P % k == 0 && aligned(coords, 4 * k) && aligned(vals, 4 * k);
  const int vec_tape = cap % 4 == 0 && aligned(tape_words, 16) &&
                       aligned(tape_imms, 16);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<dim3(gcap, parts), threads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nmeta), static_cast<const int*>(order),
      static_cast<const int*>(lens),
      static_cast<const uint32_t*>(tape_words),
      static_cast<const float*>(tape_imms),
      static_cast<const float*>(coords), static_cast<float*>(vals), n_tiles,
      cap, P, s_cap, staged, vec, vec_tape);
  return (int)cudaGetLastError();
}
