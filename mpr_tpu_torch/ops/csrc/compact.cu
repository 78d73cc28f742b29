// Kernel C: per-tile tape compaction with opcode-run extraction.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_bitshift_batched (Pallas body
// `_make_compact_batched_kernel` + `_compact_core`).
//
// Bound on the H100: bytes.  Each ambiguous tile reads its three planes of
// `tcap` int32 (rewritten words, imm bits, move distances) once and writes
// `cap`-long tapes and run headers; the arithmetic is a few integer
// operations per clause.  The TPU kernel moved every element left by its
// distance in log2(tcap) vector roll passes; on the GPU the distance is
// simply a scatter target: out[t - rem[t]] = in[t] for each kept t.
//
// Design: one block per tile row g < cmeta[0] (the ambiguous count); rows
// past it return at once.  Threads stride over the row so loads coalesce,
// and only kept clauses (branch id != 0) read their imm and distance.  The
// compacted branch ids of all `len` kept clauses (not only the first `cap`:
// an overflowing tile still reports its true run count) go to shared
// memory; a block-wide prefix sum over run heads (`bid != previous bid`)
// numbers the runs, and each run's header is `bid | (next_start - start)
// << 8`, the last run ending at `len`.  gmeta[g] = [len, n_runs, len > cap].

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Exclusive prefix sum of one int per thread over the block; *total gets
// the block sum.  blockDim.x must be a multiple of 32.
__device__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(full, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive sums of the warps
  }
  __syncthreads();
  const int before = (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return before;
}

__global__ void compact_kernel(const int* __restrict__ cmeta,
                               const int* __restrict__ lens,
                               const int* __restrict__ wrw,
                               const int* __restrict__ irw,
                               const int* __restrict__ rem,
                               int* __restrict__ tw, int* __restrict__ ti,
                               int* __restrict__ runs,
                               int* __restrict__ gmeta, int tcap, int cap) {
  extern __shared__ int smem[];
  int* sstart = smem;                                       // cap + 1
  unsigned char* sbid = reinterpret_cast<unsigned char*>(smem + cap + 1);
  __shared__ int warp_sums[32];

  const int g = blockIdx.x;
  if (g >= cmeta[0]) return;
  const int n = lens[g];
  const size_t row = (size_t)g * tcap;
  int* tw_g = tw + (size_t)g * cap;
  int* ti_g = ti + (size_t)g * cap;

  // 1. scatter each kept clause to its compacted slot
  for (int t = threadIdx.x; t < tcap; t += blockDim.x) {
    const int w = wrw[row + t];
    if (w & 0xFF) {
      const int k = t - rem[row + t];
      sbid[k] = (unsigned char)(w & 0xFF);
      if (k < cap) {
        tw_g[k] = w;
        ti_g[k] = irw[row + t];
      }
    }
  }
  for (int k = n + threadIdx.x; k < cap; k += blockDim.x) {
    tw_g[k] = 0;
    ti_g[k] = 0;
  }
  __syncthreads();

  // 2. number the runs: position k < n starts one when its bid differs
  //    from position k-1's
  const int per = (tcap + blockDim.x - 1) / blockDim.x;
  const int k0 = threadIdx.x * per;
  const int k1 = min(k0 + per, n);
  int heads = 0;
  for (int k = k0; k < k1; ++k) heads += (k == 0 || sbid[k] != sbid[k - 1]);
  int n_runs;
  int r = block_exclusive_sum(heads, warp_sums, &n_runs);
  for (int k = k0; k < k1; ++k) {
    if (k == 0 || sbid[k] != sbid[k - 1]) {
      if (r <= cap) sstart[r] = k;
      ++r;
    }
  }
  __syncthreads();

  // 3. run headers bid | count << 8, zero past the last run
  int* runs_g = runs + (size_t)g * cap;
  for (int q = threadIdx.x; q < cap; q += blockDim.x) {
    int h = 0;
    if (q < n_runs) {
      const int s = sstart[q];
      const int e = q + 1 < n_runs ? sstart[q + 1] : n;
      h = (int)sbid[s] | ((e - s) << 8);
    }
    runs_g[q] = h;
  }
  if (threadIdx.x < 8) {
    const int v[3] = {n, n_runs, n > cap ? 1 : 0};
    gmeta[(size_t)g * 8 + threadIdx.x] = threadIdx.x < 3 ? v[threadIdx.x] : 0;
  }
}

}  // namespace

extern "C" int mpr_compact(const void* cmeta, const void* lens,
                           const void* wrw, const void* irw, const void* rem,
                           void* tw, void* ti, void* runs, void* gmeta,
                           int G, int tcap, int cap, void* stream) {
  const int threads = tcap < 1024 ? tcap : 1024;
  const size_t shmem = (size_t)(cap + 1) * sizeof(int) + (size_t)tcap;
  cudaError_t err = cudaFuncSetAttribute(
      compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  compact_kernel<<<G, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const int*>(lens),
      static_cast<const int*>(wrw), static_cast<const int*>(irw),
      static_cast<const int*>(rem), static_cast<int*>(tw),
      static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), tcap, cap);
  return (int)cudaGetLastError();
}
