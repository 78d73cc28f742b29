// Kernel A: interval evaluation of one shared tape over many tiles, with
// the backward mark-and-sweep that emits 4-bit shorten codes per clause.
//
// Replaces: mpr_tpu/ops/kernels.py::interval_shorten (Pallas body
// `_make_interval_shorten_kernel`), itself the reference's eval_tiles_i.
//
// Bound on the H100: the tape's dependency depth.  The bytes the kernel
// must move (the tape, the boxes, the codes) and its operations are tiny;
// what costs is that every clause waits on its operands.  The first design
// walked the tape clause after clause, one thread a tile, its register
// file in global scratch: 2 x 5,373 dependent steps of ~180 ns for
// stress_2d(600).  But a tape is a shallow DAG (that tape: 17 dependency
// levels), so here a group of threads takes one tile and runs each level's
// clauses side by side, with one barrier a level: the time is about
// (2 x levels) x (a shared-memory round trip plus a barrier), plus the
// widest levels' clauses over the group's threads.
//
// Design: the host computes the tape's schedule once (ops/schedule.py::
// tape_levels): the clauses in level order, and for each its word, the
// level-order positions of its forward producers (or a seed: an axis of
// the tile's box, or [0, 0]), the positions its backward marks go to, and
// its index t in the tape; plus the level offsets.  A clause's immediate
// is read from the call's `imms` at its index t, never from the schedule,
// which outlives a change of the immediates (a fit step, a slider).  A
// tile keeps one interval per clause (SSA style: slot reuse makes no
// hazard), a choice byte, an active byte and a code byte per clause, in
// shared memory (11 B a clause: 180 KB at the 16,384-clause bucket).  Within a level the clauses
// go by opcode, so that a warp's threads mostly take one branch.
//   * Forward, level by level: consecutive threads take consecutive
//     clauses of the level, so the plane reads are coalesced; each reads
//     its operands' intervals, evaluates (interval_op), stores its interval
//     and its choice.  A clause with opcode <= JUMP runs no forward step.
//   * The tile's status comes from the result's source.  A tile that is
//     not ambiguous writes zero codes (CODE_DROP is 0) and stops.
//   * Backward, levels in reverse: a clause's active flag was set by its
//     consumers, all on higher levels (stores of 1 that race harmlessly);
//     it computes its code (the slot walk's rules: an in-place copy is
//     elided, COPY_RHS becomes COPY_IMM for rhs slot 0) into the code byte
//     of its index t, and marks its producers.
//   * The codes are packed 8 to a word and stored row by row, coalesced.
// Each thread reads its next clause's plane entries one clause ahead, across
// the barrier between levels too, so that the global reads overlap work.
// Launch shapes (ops/launch.py::interval_launch, a cost model over the
// levels' widths and the tiles): a block a tile (64 to 1024 threads,
// __syncthreads between levels) for long tapes; or a thread a tile, which
// walks the clauses alone (no barrier) with its arrays interleaved with its
// block's other tiles', for a short tape over many tiles (the 22-clause
// gyroid's 148k cells: a warp a tile, tried first, ran 5x slower there).
// The planes may be staged in shared memory once for the block's tiles.  Lanes at or past meta[7] (when non-zero) write nothing.
// A tape whose metadata disagree with the schedule's traps.

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"

namespace {

using namespace mpr;

constexpr int PLANES = 4;  // word, sources, marks, t

struct Seeds {
  Iv x, y, z;
};

// The interval at a forward source: a position (the tile's elements
// `stride` apart), or a seed code (-1 zero, -2 x, -3 y, -4 z).
__device__ __forceinline__ Iv operand(const float2* iv, int stride, int src,
                                      const Seeds& s) {
  if (src >= 0) {
    const float2 v = iv[src * stride];
    return {v.x, v.y};
  }
  if (src == -2) return s.x;
  if (src == -3) return s.y;
  if (src == -4) return s.z;
  return {0.0f, 0.0f};
}

__device__ __forceinline__ int lo16(int v) { return (int)(short)(v & 0xFFFF); }
__device__ __forceinline__ int hi16(int v) { return v >> 16; }

template <bool WIDEN>
__global__ void __launch_bounds__(1024)
interval_shorten_kernel(
    const int* __restrict__ meta,     // [T, S, res, sx, sy, sz, n_runs, n_active]
    const int* __restrict__ planes,   // (4, tp) in level order
    const float* __restrict__ imms,   // (tcap,) the tape's immediates
    const int* __restrict__ offsets,  // (n_levels + 1,)
    const float* __restrict__ boxes,  // (6, lanes): xl xh yl yh zl zh
    int* __restrict__ status,         // (lanes,)
    int* __restrict__ codes,          // (lanes, tcap/8)
    int lanes, int tcap, int T, int tp, int n_levels, int res_src,
    int res_mark, int res, int sx, int sy, int sz, int tiles, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (meta[0] != T || meta[2] != res || meta[3] != sx || meta[4] != sy ||
      meta[5] != sz)
    __trap();  // the schedule is another tape's
  const int n_active = meta[7];
  const int last = n_active > 0 ? min(lanes, n_active) : lanes;
  if (blockIdx.x * tiles >= last) return;  // the whole block is idle

  const int G = blockDim.x / tiles;  // threads a tile
  const int m = threadIdx.x / G;
  const int gt = threadIdx.x % G;
  const int lane = blockIdx.x * tiles + m;
  const bool live = lane < last;
  // a thread a tile: element i of tile m at i * tiles + m (a warp's threads
  // touch neighbouring words), and no barrier inside a tile; a block a tile
  // (m = 0): element i at i
  const bool own = G == 1;

  const int* P = planes;
  unsigned char* base = smem;
  if (stage) {
    int4* dst = reinterpret_cast<int4*>(smem);
    const int4* src = reinterpret_cast<const int4*>(planes);
    for (int k = threadIdx.x; k < PLANES * tp / 4; k += blockDim.x)
      dst[k] = src[k];
    P = reinterpret_cast<const int*>(smem);
    base += (size_t)PLANES * tp * 4;
  }
  const int* Pw = P;
  const int* Ps = P + tp;
  const int* Pm = P + 2 * tp;
  const int* Pt = P + 3 * tp;
  // the block's arrays: intervals, choices, active flags, codes, tp x tiles
  // each
  const size_t n = (size_t)tp * tiles;
  float2* iv_all = reinterpret_cast<float2*>(base);
  uint8_t* cho_all = reinterpret_cast<uint8_t*>(iv_all + n);
  uint8_t* act_all = cho_all + n;
  uint8_t* code_all = act_all + n;
  {
    uint4* z = reinterpret_cast<uint4*>(act_all);  // act and code
    for (int k = threadIdx.x; k < (int)(2 * n / 16); k += blockDim.x)
      z[k] = make_uint4(0, 0, 0, 0);
  }
  const int st_ = own ? tiles : 1;  // stride between a tile's elements
  const size_t t0 = own ? (size_t)m : 0;
  float2* iv = iv_all + t0;
  uint8_t* cho = cho_all + t0;
  uint8_t* act = act_all + t0;
  uint8_t* code = code_all + t0;

  const size_t L = (size_t)lanes;
  const int lc = min(lane, lanes - 1);
  Seeds seeds;
  seeds.x = {boxes[0 * L + lc], boxes[1 * L + lc]};
  seeds.y = {boxes[2 * L + lc], boxes[3 * L + lc]};
  seeds.z = {boxes[4 * L + lc], boxes[5 * L + lc]};
  __syncthreads();

  auto sync = [&]() {
    if (!own) __syncthreads();
  };

  // ---- forward, level by level ----------------------------------------------
  // The thread's clauses, in order: positions gt, gt + G, ... of each level.
  // Each one's plane entries are read one clause ahead (across a level's
  // barrier too), so the global read overlaps the clause before.
  auto seek_up = [&](int& l, int& i) {
    while (l < n_levels && i >= __ldg(offsets + l + 1)) {
      ++l;
      if (l < n_levels) i = __ldg(offsets + l) + gt;
    }
  };
  {
    int pl = 0, pi = gt;
    seek_up(pl, pi);
    uint32_t nw = 0;
    float nimm = 0.0f;
    int nsrc = 0;
    if (pl < n_levels) {
      nw = (uint32_t)Pw[pi];
      nimm = __ldg(imms + Pt[pi]);
      nsrc = Ps[pi];
    }
    for (int l = 0; l < n_levels; ++l) {
      while (pl == l) {
        const int i = pi;
        const uint32_t w = nw;
        const float imm = nimm;
        const int src = nsrc;
        pi += G;
        seek_up(pl, pi);
        if (pl < n_levels) {
          nw = (uint32_t)Pw[pi];
          nimm = __ldg(imms + Pt[pi]);
          nsrc = Ps[pi];
        }
        const int op = w_op(w);
        if (op <= OP_JUMP || op >= NUM_OPS) continue;
        const Iv a = operand(iv, st_, lo16(src), seeds);
        const Iv b = operand(iv, st_, hi16(src), seeds);
        Iv r;
        const int c = interval_op(op, a.lo, a.hi, b.lo, b.hi, imm, r);
        if (WIDEN) r = widen(r);
        iv[i * st_] = make_float2(r.lo, r.hi);
        cho[i * st_] = (uint8_t)c;
      }
      sync();
    }
  }

  // ---- classification -------------------------------------------------------
  const Iv rv = operand(iv, st_, res_src, seeds);
  const int st = rv.lo > 0.0f ? ST_EMPTY : (rv.hi < 0.0f ? ST_FILLED : ST_AMBIG);
  if (live && gt == 0) status[lane] = st;

  const int nwords = tcap / 8;
  int* crow = codes + (size_t)lane * nwords;
  if (st != ST_AMBIG && !own) {  // uniform over the block
    if (live)
      for (int k = gt; k < nwords; k += G) crow[k] = 0;
    return;
  }

  // ---- backward mark-and-sweep, levels in reverse ----------------------------
  // (a thread a tile that is not ambiguous leaves its codes at 0)
  if (gt == 0 && res_mark >= 0 && st == ST_AMBIG) act[res_mark * st_] = 1;
  sync();
  auto seek_down = [&](int& l, int& i) {
    while (l >= 0 && i >= __ldg(offsets + l + 1)) {
      --l;
      if (l >= 0) i = __ldg(offsets + l) + gt;
    }
  };
  {
    int pl = n_levels - 1, pi = pl >= 0 ? __ldg(offsets + pl) + gt : 0;
    seek_down(pl, pi);
    uint32_t nw = 0;
    int nmk = 0, nt = 0;
    if (pl >= 0) {
      nw = (uint32_t)Pw[pi];
      nmk = Pm[pi];
      nt = Pt[pi];
    }
    for (int l = n_levels - 1; l >= 0 && (st == ST_AMBIG || !own); --l) {
      while (pl == l) {
        const int i = pi;
        const uint32_t w = nw;
        const int marks = nmk, t = nt;
        pi += G;
        seek_down(pl, pi);
        if (pl >= 0) {
          nw = (uint32_t)Pw[pi];
          nmk = Pm[pi];
          nt = Pt[pi];
        }
        const int op = w_op(w), out = w_out(w), lhs = w_lhs(w),
                  rhs = w_rhs(w);
        const bool is_act = act[i * st_] != 0;
        const bool has_choice = op >= CHOICE_OP_LO && op <= CHOICE_OP_HI;
        const int choice = has_choice ? cho[i * st_] : 0;
        const bool keep_both = choice == 0, ch_lhs = choice == 1,
                   ch_rhs = choice == 2;
        const bool rhs_is_reg = rhs != 0;
        const bool elide = (ch_lhs && lhs == out) ||
                           (ch_rhs && rhs_is_reg && rhs == out);
        int c = keep_both ? CODE_KEEP
                : ch_lhs ? CODE_COPY_LHS
                : rhs_is_reg ? CODE_COPY_RHS : CODE_COPY_IMM;
        if (elide || !is_act) c = CODE_DROP;
        // mark targets: -1 for none (a seed, or lhs slot 0)
        const int ml = lo16(marks), mr = hi16(marks);
        if (is_act && (keep_both || ch_lhs) && ml >= 0) act[ml * st_] = 1;
        if (is_act && (keep_both || (ch_rhs && rhs_is_reg)) && mr >= 0)
          act[mr * st_] = 1;
        code[t * st_] = (uint8_t)c;
      }
      sync();
    }
  }

  // ---- pack 8 codes a word, zero past the tape ------------------------------
  const int used = (T + 7) / 8;
  if (own) {
    // the block's rows together, consecutive threads on consecutive words
    __syncthreads();
    for (int x = threadIdx.x; x < tiles * nwords; x += blockDim.x) {
      const int mm = x / nwords, k = x % nwords;
      const int row = blockIdx.x * tiles + mm;
      if (row >= last) continue;
      uint32_t v = 0;
      if (k < used)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v |= (uint32_t)code_all[(size_t)(8 * k + j) * tiles + mm]
               << (4 * j);
      codes[(size_t)row * nwords + k] = (int)v;
    }
    return;
  }
  if (!live) return;
  for (int k = gt; k < nwords; k += G) {
    uint32_t v = 0;
    if (k < used) {
      const uint2 q = reinterpret_cast<const uint2*>(code)[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v |= ((q.x >> (8 * j)) & 0xFu) << (4 * j);
        v |= ((q.y >> (8 * j)) & 0xFu) << (4 * (j + 4));
      }
    }
    crow[k] = (int)v;
  }
}

}  // namespace

// threads a block, tiles a block (1: the block walks one tile; threads: a
// thread a tile), stage: the planes copied into shared memory; smem the
// dynamic shared memory the host computed for the shape (ops/launch.py::
// interval_launch, which also checks it).
extern "C" int mpr_interval_shorten(
    const void* meta, const void* planes, const void* imms,
    const void* offsets, const void* boxes, void* status, void* codes,
    int lanes, int tcap, int T, int tp, int n_levels, int res_src,
    int res_mark, int res, int sx, int sy, int sz, int threads, int tiles,
    int stage, int widen, int smem, void* stream) {
  // a block a tile, or a thread a tile
  if ((tiles != 1 && tiles != threads) || tcap % 8 || tp % 16)
    return (int)cudaErrorInvalidValue;
  auto fn = widen ? interval_shorten_kernel<true>
                  : interval_shorten_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (lanes + tiles - 1) / tiles;
  fn<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(planes),
      static_cast<const float*>(imms), static_cast<const int*>(offsets),
      static_cast<const float*>(boxes), static_cast<int*>(status),
      static_cast<int*>(codes), lanes, tcap, T, tp, n_levels, res_src,
      res_mark, res, sx, sy, sz, tiles, stage);
  return (int)cudaGetLastError();
}
