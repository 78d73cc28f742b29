// Kernel A: interval evaluation of one shared tape over many tiles, with
// the backward mark-and-sweep that emits 4-bit shorten codes per clause.
//
// Replaces: mpr_tpu/ops/kernels.py::interval_shorten (Pallas body
// `_make_interval_shorten_kernel`), itself the reference's eval_tiles_i.
//
// Bound on the H100: latency.  One thread owns one tile (lane) and walks
// the whole tape twice (forward interval pass, backward sweep), each step a
// dependent chain of loads and stores to its register file.  At 1024^2 the
// frame has 256 tiles: eight warps on eight SMs, so the card is mostly
// idle and the time is (tape length x per-clause latency).  The bytes it
// must move (tape, boxes, codes) and its operations are both tiny.
//
// Design: the per-tile state (interval registers, active flags, packed
// choices) lives in global scratch laid out [slot][lane], so the 32 lanes
// of a warp touch 32 neighbouring words and every access is one coalesced
// transaction that stays in L1/L2.  Tape words and immediates are read
// through the read-only path; all lanes of a warp read the same word, a
// broadcast.  Dispatch is one switch per clause on the op byte (all lanes
// take the same branch).  Codes come out as codes[lane, t/8], nibble t%8.
// Making it fast (many threads per tile, or many tiles per warp with the
// register file in shared memory) is later work.

#include <cuda_runtime.h>
#include <cstdint>

#include "clause.cuh"

namespace {

using namespace mpr;

template <bool WIDEN>
__global__ void interval_shorten_kernel(
    const int* __restrict__ meta,     // [T, S, res, sx, sy, sz, n_runs, n_active]
    const uint32_t* __restrict__ words,
    const float* __restrict__ imms,
    const float* __restrict__ boxes,  // (6, lanes): xl xh yl yh zl zh
    int* __restrict__ status,         // (lanes,)
    int* __restrict__ codes,          // (lanes, tcap/8)
    float* __restrict__ rlo,          // (s_cap, lanes) scratch
    float* __restrict__ rhi,          // (s_cap, lanes) scratch
    int* __restrict__ act,            // (s_cap, lanes) scratch
    uint32_t* __restrict__ cho,       // (tcap/16, lanes) scratch
    int lanes, int tcap, int s_cap) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  // lanes past the active count do no work; their outputs are garbage the
  // caller masks (kernels.py:348-359)
  const int n_active = meta[7];
  if (n_active > 0 && lane >= n_active) return;

  const int T = meta[0], res = meta[2];
  const int sx = meta[3], sy = meta[4], sz = meta[5];
  const size_t L = (size_t)lanes;
  auto at = [&](int s) { return (size_t)s * L + lane; };

  for (int s = 0; s < s_cap; ++s) {
    rlo[at(s)] = 0.0f;
    rhi[at(s)] = 0.0f;
  }
  // axis seeds; an unused axis has slot 0, re-zeroed right after (slot 0
  // reads as the [0, 0] "no operand" sentinel)
  rlo[at(sx)] = boxes[0 * L + lane];
  rhi[at(sx)] = boxes[1 * L + lane];
  rlo[at(sy)] = boxes[2 * L + lane];
  rhi[at(sy)] = boxes[3 * L + lane];
  rlo[at(sz)] = boxes[4 * L + lane];
  rhi[at(sz)] = boxes[5 * L + lane];
  rlo[at(0)] = 0.0f;
  rhi[at(0)] = 0.0f;

  // ---- forward interval pass, recording 2-bit choices ----------------------
  uint32_t cword = 0;
  int ci = 0;
  for (int t = 0; t < T; ++t) {
    const uint32_t w = __ldg(words + t);
    const int op = w_op(w);
    if (op <= OP_JUMP || op >= NUM_OPS) continue;  // branch id 0: no-op
    const int out = w_out(w), lhs = w_lhs(w), rhs = w_rhs(w);
    Iv r;
    const int c = interval_op(op, rlo[at(lhs)], rhi[at(lhs)], rlo[at(rhs)],
                              rhi[at(rhs)], __ldg(imms + t), r);
    if (WIDEN) r = widen(r);
    rlo[at(out)] = r.lo;
    rhi[at(out)] = r.hi;
    if (op >= CHOICE_OP_LO && op <= CHOICE_OP_HI) {
      cword |= (uint32_t)c << (2 * (ci % 16));
      if (ci % 16 == 15) {
        cho[(size_t)(ci / 16) * L + lane] = cword;
        cword = 0;
      }
      ++ci;
    }
  }
  if (ci % 16 != 0) cho[(size_t)(ci / 16) * L + lane] = cword;

  // ---- classification ------------------------------------------------------
  const float lo = rlo[at(res)], hi = rhi[at(res)];
  const int st = lo > 0.0f ? ST_EMPTY : (hi < 0.0f ? ST_FILLED : ST_AMBIG);
  status[lane] = st;

  // ---- backward mark-and-sweep ---------------------------------------------
  // (non-ambiguous lanes sweep too and emit all-DROP codes, never consumed)
  for (int s = 0; s < s_cap; ++s) act[at(s)] = 0;
  act[at(res)] = st == ST_AMBIG;

  const int nwords = tcap / 8;
  int* crow = codes + (size_t)lane * nwords;
  for (int k = (T + 7) / 8; k < nwords; ++k) crow[k] = 0;

  uint32_t kword = 0;
  for (int t = T - 1; t >= 0; --t) {
    const uint32_t w = __ldg(words + t);
    const int op = w_op(w), out = w_out(w), lhs = w_lhs(w), rhs = w_rhs(w);
    const bool has_choice = op >= CHOICE_OP_LO && op <= CHOICE_OP_HI;
    int choice = 0;
    if (has_choice) {
      --ci;
      choice = (cho[(size_t)(ci / 16) * L + lane] >> (2 * (ci % 16))) & 3;
    }
    const bool is_act = act[at(out)] != 0;
    const bool keep_both = choice == 0, ch_lhs = choice == 1,
               ch_rhs = choice == 2;
    const bool rhs_is_reg = rhs != 0;
    // a copy onto its own slot is elided
    const bool elide = (ch_lhs && lhs == out) ||
                       (ch_rhs && rhs_is_reg && rhs == out);
    int code = keep_both ? CODE_KEEP
               : ch_lhs ? CODE_COPY_LHS
               : rhs_is_reg ? CODE_COPY_RHS : CODE_COPY_IMM;
    if (elide || !is_act) code = CODE_DROP;
    // the out slot is dead above this clause unless an operand re-marks it
    act[at(out)] = 0;
    if (is_act && (keep_both || ch_lhs) && lhs != 0) act[at(lhs)] = 1;
    if (is_act && (keep_both || (ch_rhs && rhs_is_reg))) act[at(rhs)] = 1;

    kword |= (uint32_t)code << (4 * (t % 8));
    if (t % 8 == 0) {
      crow[t / 8] = (int)kword;
      kword = 0;
    }
  }
}

}  // namespace

extern "C" int mpr_interval_shorten(const void* meta, const void* words,
                                    const void* imms, const void* boxes,
                                    void* status, void* codes, void* regs,
                                    void* act, void* cho, int lanes, int tcap,
                                    int s_cap, int widen, void* stream) {
  const int threads = 32;
  const int blocks = (lanes + threads - 1) / threads;
  float* rlo = static_cast<float*>(regs);
  float* rhi = rlo + (size_t)s_cap * lanes;
  auto s = static_cast<cudaStream_t>(stream);
  if (widen) {
    interval_shorten_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(meta), static_cast<const uint32_t*>(words),
        static_cast<const float*>(imms), static_cast<const float*>(boxes),
        static_cast<int*>(status), static_cast<int*>(codes), rlo, rhi,
        static_cast<int*>(act), static_cast<uint32_t*>(cho), lanes, tcap,
        s_cap);
  } else {
    interval_shorten_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(meta), static_cast<const uint32_t*>(words),
        static_cast<const float*>(imms), static_cast<const float*>(boxes),
        static_cast<int*>(status), static_cast<int*>(codes), rlo, rhi,
        static_cast<int*>(act), static_cast<uint32_t*>(cho), lanes, tcap,
        s_cap);
  }
  return (int)cudaGetLastError();
}
