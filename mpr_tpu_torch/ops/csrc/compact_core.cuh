// Device code shared by the compaction kernels.
//
// Kernels C and C2 (compact.cu, compact_order.cu) run compact_row: one
// tile row's compaction by a group of threads that is either one warp (a
// warp a row, several rows a block: short planes) or a whole block (a
// block a row: long planes).  Kernel C1 (compact_runs.cu) takes a row with
// the same groups and numbers its runs with the same number_runs.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "block_scan.cuh"

namespace mpr {

// ---------------------------------------------------------------------------
// One row's compaction by a warp or by a block
// ---------------------------------------------------------------------------

// The threads that take one row.  Group<true>: a warp (barrier __syncwarp,
// a shuffle scan, no shared scratch); Group<false>: the block (barrier
// __syncthreads, a scan over the warps' sums in `scratch`, 32 ints).
template <bool WARP>
struct Group;

template <>
struct Group<true> {
  int rank;
  __device__ explicit Group(int*) : rank(threadIdx.x & 31) {}
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
  // Exclusive prefix sum of v over the warp; *total gets the warp's sum.
  __device__ int exclusive_sum(int v, int* total) const {
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (rank >= o) x += y;
    }
    *total = __shfl_sync(0xffffffffu, x, 31);
    return x - v;
  }
};

template <>
struct Group<false> {
  int rank;
  int* scratch;
  __device__ explicit Group(int* s) : rank(threadIdx.x), scratch(s) {}
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  // Exclusive prefix sum of v over the block (two barriers; the scratch is
  // not reused within a row, so no third one guards it).
  __device__ int exclusive_sum(int v, int* total) const {
    return block_scan(v, scratch, total);
  }
};

// Number the runs of the branch ids sbid[0, nn) (shared memory, complete
// before the call): each thread counts the run heads (an id unlike the one
// before) over a contiguous piece of [0, nn), read four ids a load; the
// group's exclusive sum numbers them, and each head stores its start in
// sstart[r] for r <= limit.  Returns the run count.  sbid must be readable
// up to nn rounded up to 4.
template <bool WARP>
__device__ __forceinline__ int number_runs(const Group<WARP>& grp,
                                           const unsigned char* sbid, int nn,
                                           int* sstart, int limit) {
  const int me = grp.rank, P = grp.size();
  const int per = (((nn + P - 1) / P) + 3) & ~3;   // a multiple of 4
  const int k0 = min(me * per, nn), k1 = min(k0 + per, nn);
  const int first = k0 > 0 ? (int)sbid[k0 - 1] : -1;
  int heads = 0, prev = first;
  for (int k = k0; k < k1; k += 4) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(sbid + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = (x >> (8 * j)) & 0xFF;
      if (k + j < k1) {
        heads += b != prev;
        prev = b;
      }
    }
  }
  int n_runs;
  int r = grp.exclusive_sum(heads, &n_runs);
  prev = first;
  for (int k = k0; k < k1; k += 4) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(sbid + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = (x >> (8 * j)) & 0xFF;
      if (k + j < k1 && b != prev) {
        if (r <= limit) sstart[r] = k + j;
        ++r;
      }
      if (k + j < k1) prev = b;
    }
  }
  return n_runs;
}

// Shared bytes of one row in compact_row: the kept words and immediates
// staged (cap rounded up to 4, each), the run starts (cap + 1 ints, in
// cap rounded up to 4, plus 4) and the branch ids of all kept clauses
// (tcap bytes, rounded up to 16).  A multiple of 16, so that the rows of a
// block lie on 16 bytes.  (Host twin: ops/launch.py::c_row_bytes.)
__host__ __device__ inline int compact_row_bytes(int tcap, int cap) {
  const int cap4 = (cap + 3) & ~3;
  return 4 * (3 * cap4 + 4) + ((tcap + 15) & ~15);
}

// 16-byte loads of the plane a thread has in flight before it scatters
// their words (a block a row gives a thread ops/launch.py::C_WORDS words:
// two rounds).
constexpr int ROW_QUADS = 2;

// One row's compaction: planes of tcap int32 (rewritten words with the
// branch id in the low byte, 0 for a dropped clause; imm bits; leftward
// moves) with n kept clauses -> the dense tape tw_g/ti_g[0, cap) (zero past
// n), the run headers runs_g[0, cap) (`bid | count << 8`, zero past the
// last run) and gmeta_g = [n, n_runs, n > cap, 0..].  Kept clause t lands
// on t - rem[t], whatever the distance.  The branch ids of all n kept
// clauses are kept, not only the first cap, so an overflowing row reports
// its true run count.  tcap % 32 == 0; wrw 16-byte aligned; buf:
// compact_row_bytes(tcap, cap) bytes of shared memory on 16 bytes.
//
//   1. the words in 16-byte loads (ROW_QUADS a thread in flight, a warp's
//      loads side by side); only kept clauses load their move and
//      immediate (predicated loads, all issued before the stores); each
//      kept clause's word, immediate and branch id go to shared memory at
//      its place;
//   2. number_runs over [0, n): the group's exclusive sum of each
//      thread's run heads numbers them, and each head stores its start;
//   3. the outputs in 16-byte stores over [0, cap) (4-byte ones when cap
//      is not a multiple of 4): staged words and immediates below n, zero
//      past it; headers from the run starts below n_runs, zero past it.
// Barriers: after 1, after 2 (and the scan's own two in a block).
template <bool WARP>
__device__ __forceinline__ void compact_row(
    const Group<WARP>& grp, const int* __restrict__ wrw,
    const int* __restrict__ irw, const int* __restrict__ rem, int n,
    int* __restrict__ tw_g, int* __restrict__ ti_g, int* __restrict__ runs_g,
    int* __restrict__ gmeta_g, int tcap, int cap, unsigned char* buf) {
  const int cap4 = (cap + 3) & ~3;
  int* stw = reinterpret_cast<int*>(buf);
  int* sti = stw + cap4;
  int* sstart = sti + cap4;                       // cap + 1 <= cap4 + 4
  unsigned char* sbid = reinterpret_cast<unsigned char*>(sstart + cap4 + 4);
  const int me = grp.rank, P = grp.size();

  // ---- 1. scatter --------------------------------------------------------
  const int4* w4 = reinterpret_cast<const int4*>(wrw);
  const int nq = tcap >> 2;
  for (int q0 = me; q0 < nq; q0 += ROW_QUADS * P) {
    int w[4 * ROW_QUADS];
#pragma unroll
    for (int j = 0; j < ROW_QUADS; ++j) {
      const int q = q0 + j * P;
      const int4 v = q < nq ? __ldg(w4 + q) : make_int4(0, 0, 0, 0);
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
    int mv[4 * ROW_QUADS], im[4 * ROW_QUADS];
#pragma unroll
    for (int i = 0; i < 4 * ROW_QUADS; ++i) {
      const int t = 4 * (q0 + (i >> 2) * P) + (i & 3);
      const bool kept = (w[i] & 0xFF) != 0;
      mv[i] = kept ? __ldg(rem + t) : 0;
      im[i] = kept ? __ldg(irw + t) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4 * ROW_QUADS; ++i) {
      const int t = 4 * (q0 + (i >> 2) * P) + (i & 3);
      const int k = t - mv[i];
      if ((w[i] & 0xFF) != 0 && (unsigned)k < (unsigned)tcap) {
        sbid[k] = (unsigned char)(w[i] & 0xFF);
        if (k < cap) {
          stw[k] = w[i];
          sti[k] = im[i];
        }
      }
    }
  }
  grp.sync();

  // ---- 2. run heads and their starts ---------------------------------------
  const int n_runs = number_runs(grp, sbid, min(max(n, 0), tcap), sstart,
                                 cap);
  grp.sync();

  // ---- 3. outputs ----------------------------------------------------------
  const int nr = min(n_runs, cap);
  auto header = [&](int q) -> int {
    if (q >= nr) return 0;
    const int s = sstart[q];
    const int e = q + 1 < n_runs ? sstart[q + 1] : n;
    return (int)sbid[s] | ((e - s) << 8);
  };
  if ((cap & 3) == 0) {
    int4* tw4 = reinterpret_cast<int4*>(tw_g);
    int4* ti4 = reinterpret_cast<int4*>(ti_g);
    int4* runs4 = reinterpret_cast<int4*>(runs_g);
    for (int q = me; q < (cap >> 2); q += P) {
      const int k = 4 * q;
      int4 a = *reinterpret_cast<const int4*>(stw + k);
      int4 b = *reinterpret_cast<const int4*>(sti + k);
      if (k >= n) a.x = b.x = 0;
      if (k + 1 >= n) a.y = b.y = 0;
      if (k + 2 >= n) a.z = b.z = 0;
      if (k + 3 >= n) a.w = b.w = 0;
      tw4[q] = a;
      ti4[q] = b;
      runs4[q] = make_int4(header(k), header(k + 1), header(k + 2),
                           header(k + 3));
    }
  } else {
    for (int k = me; k < cap; k += P) {
      tw_g[k] = k < n ? stw[k] : 0;
      ti_g[k] = k < n ? sti[k] : 0;
      runs_g[k] = header(k);
    }
  }
  if (me < 2)
    reinterpret_cast<int4*>(gmeta_g)[me] =
        me == 0 ? make_int4(n, n_runs, n > cap ? 1 : 0, 0)
                : make_int4(0, 0, 0, 0);
}

}  // namespace mpr
