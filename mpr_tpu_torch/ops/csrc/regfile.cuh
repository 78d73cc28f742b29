// The interpreter's register file, sized by the tape's slot bucket s_cap,
// and the walk of a tape's opcode runs over it.
//
// Users: kernels B (pixel_eval.cu), B1 (pixel_eval_v1.cu) and V
// (voxel_eval.cu), a float a slot, and kernel D (deriv_eval.cu), a dual
// number a slot.  Their head comments say why each needs it.
//
// A thread interprets K items (voxels, pixels) at once: each clause word
// and immediate is read from shared memory and decoded once for K items,
// and the K chains are independent, which gives each warp K-fold
// instruction-level parallelism.  The file has two homes, chosen on the
// host (ops/launch.py::pixel_launch, ops/kernels3d.py::voxel_launch,
// deriv_launch):
//   * SharedFile: dynamic shared memory, s_cap x K x threads items, laid
//     out [slot][K/G][thread][G] with G items (at most 16 bytes) moved by
//     one access: a thread's K floats side by side, a dual number 16 bytes.
//     The lanes of a warp read the same slot of the same clause, so an
//     access is 32 consecutive groups: no bank conflict.
//   * LocalFile<N>: a per-thread array in local memory of N slots, N the
//     power-of-two bucket (16..256) of s_cap, for files too large to leave
//     the shared home enough threads.  Only the slots a tape touches reach
//     the cache (L1, then L2).
// Kernel D's block may also split its warps between the homes: its first
// warps keep their files in shared memory and the rest in local memory, so
// that a long tape is latency-bound in the one and bound by L2 in the other
// at the same time; the warps share the block's items through a work queue
// (next_chunk), which both kernels use.
// Slot numbers come from the tape; a kernel traps when the tape's slot
// count (nmeta[1]) exceeds s_cap, so no access leaves the file.
//
// Dynamic shared memory of a block, in int32 words (the host mirrors it in
// ops/launch.py: SMEM_HEADER, _tape_bytes):
//   [0, 256)               branch id -> opcode
//   [256, 272)             the camera matrix
//   [272, 320)             kernel V: the cell's 16 world coordinates a axis
//   [320, 324)             the work queue's counter, and padding
//   [.., + pad4(3*T))      the staged tape: words, immediates, run headers,
//                          T entries each, padded to 16 bytes
//   [.., ...)              the shared home of the register file, if used
#pragma once

#include <cstdint>

#include "clause.cuh"

namespace mpr {

constexpr int HEADER_INTS = 256 + 16 + 48 + 4;
constexpr int QUEUE_INT = 320;

// Ints the staged tape takes: three arrays of T, padded so that the file
// after it starts on 16 bytes.
__host__ __device__ constexpr int tape_ints(int T) { return (3 * T + 3) & ~3; }

// G items that one access moves (at most 16 bytes: one LDS.128 / LDL.128).
template <typename V, int G>
struct alignas(sizeof(V) * G) Group {
  V v[G];
};

template <typename V, int K>
constexpr int group_items() {
  return sizeof(V) * K <= 16 ? K : 1;
}

// The shared home, laid out [slot][K/G][thread][G]: float slots keep a
// thread's K items side by side (one vector access for K <= 4), dual
// numbers one 16-byte item per access ([slot][k][thread]).  A warp reads one
// slot of 32 threads, 32 consecutive groups: no bank conflict.
template <typename V, int K>
struct SharedFile {
  static constexpr int G = group_items<V, K>();
  static constexpr int NG = K / G;
  using Grp = Group<V, G>;
  Grp* col;  // this thread's column: the file's base + threadIdx.x
  int nt;    // threads per block

  __device__ SharedFile(float* base, int threads)
      : col(reinterpret_cast<Grp*>(base) + threadIdx.x), nt(threads) {}

  __device__ __forceinline__ void load(int s, V (&x)[K]) const {
    const Grp* p = col + s * NG * nt;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const Grp g = p[j * nt];
#pragma unroll
      for (int i = 0; i < G; ++i) x[j * G + i] = g.v[i];
    }
  }
  __device__ __forceinline__ void store(int s, const V (&x)[K]) {
    Grp* p = col + s * NG * nt;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      Grp g;
#pragma unroll
      for (int i = 0; i < G; ++i) g.v[i] = x[j * G + i];
      p[j * nt] = g;
    }
  }
};

// The local home: N slots of K items, grouped as in the shared home.
template <typename V, int K, int N>
struct LocalFile {
  static constexpr int G = group_items<V, K>();
  static constexpr int NG = K / G;
  Group<V, G> r[N * NG];

  __device__ __forceinline__ void load(int s, V (&x)[K]) const {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const Group<V, G> g = r[s * NG + j];
#pragma unroll
      for (int i = 0; i < G; ++i) x[j * G + i] = g.v[i];
    }
  }
  __device__ __forceinline__ void store(int s, const V (&x)[K]) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      Group<V, G> g;
#pragma unroll
      for (int i = 0; i < G; ++i) g.v[i] = x[j * G + i];
      r[s * NG + j] = g;
    }
  }
};

// The clause semantics a file holds: a float (kernel V) or a dual number
// (kernel D) a slot.
struct FloatClause {
  using Value = float;
  template <int OP>
  __device__ __forceinline__ static float apply(float a, float b, float imm) {
    return float_op<OP>(a, b, imm);
  }
};

struct DerivClause {
  using Value = Dv;
  template <int OP>
  __device__ __forceinline__ static Dv apply(const Dv& a, const Dv& b,
                                             float imm) {
    return deriv_op<OP>(a, b, imm);
  }
};

// A clause word and its immediate.
struct Word {
  uint32_t w;
  float imm;
};

// One run of cnt clauses of one opcode, over K items.  All K operand pairs
// are loaded before any result is stored (a store of item k could alias a
// load of item k+1 as far as the compiler knows), and the next clause's
// word and immediate are read before this clause's stores for the same
// reason.  w0 is the run's first clause, which the caller read ahead.
template <class C, int OP, int K, class File>
__device__ __forceinline__ void run_clauses(File& f, const uint32_t* words,
                                            const float* imms, int t0,
                                            int cnt, Word w) {
  using V = typename C::Value;
  for (int i = 0; i < cnt; ++i) {
    V x[K], y[K];
    f.load(w_lhs(w.w), x);
    f.load(w_rhs(w.w), y);
    const int o = w_out(w.w);
    const float imm = w.imm;
    if (i + 1 < cnt) w = {words[t0 + i + 1], imms[t0 + i + 1]};
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = C::template apply<OP>(x[k], y[k], imm);
    f.store(o, x);
  }
}

// One run of cnt clauses of opcode op: one switch for the run.  ALL
// false (kernels B, V, D): op is an opcode a branch table gives, and 0, 1
// and unknown ops are no-op runs (branch id 0).  ALL true (kernel B1's full
// branch list): opcodes 0 and 1 are real clauses (a * 0) and an opcode
// past 31 runs the last branch.
template <class C, int K, bool ALL, class File>
__device__ __forceinline__ void run_op(File& f, int op,
                                       const uint32_t* words,
                                       const float* imms, int t0, int cnt,
                                       Word w0) {
  switch (op) {
#define MPR_CASE(o) \
  case o: run_clauses<C, o, K>(f, words, imms, t0, cnt, w0); break;
    MPR_CASE(2) MPR_CASE(3) MPR_CASE(4) MPR_CASE(5) MPR_CASE(6) MPR_CASE(7)
    MPR_CASE(8) MPR_CASE(9) MPR_CASE(10) MPR_CASE(11) MPR_CASE(12)
    MPR_CASE(13) MPR_CASE(14) MPR_CASE(15) MPR_CASE(16) MPR_CASE(17)
    MPR_CASE(18) MPR_CASE(19) MPR_CASE(20) MPR_CASE(21) MPR_CASE(22)
    MPR_CASE(23) MPR_CASE(24) MPR_CASE(25) MPR_CASE(26) MPR_CASE(27)
    MPR_CASE(28) MPR_CASE(29) MPR_CASE(30) MPR_CASE(31)
#undef MPR_CASE
    default:
      if constexpr (ALL) {
        if (op <= OP_JUMP)
          run_clauses<C, OP_INVALID, K>(f, words, imms, t0, cnt, w0);
        else
          run_clauses<C, NUM_OPS - 1, K>(f, words, imms, t0, cnt, w0);
      }
      break;
  }
}

// Walk a tape run by run: one switch per opcode run (sop maps the run
// header's branch id to its opcode; id 0 and unknown ops are no-op runs).
// The next run's header, opcode and first clause are read during this run.
template <class C, int K, class File>
__device__ __forceinline__ void run_tape(File& f, const int* sop,
                                         const uint32_t* words,
                                         const float* imms, const int* runs,
                                         int n_runs) {
  if (n_runs <= 0) return;
  int t0 = 0;
  int hdr = runs[0];
  int op = sop[hdr & 0xFF];
  Word w0 = {words[0], imms[0]};
  for (int r = 0; r < n_runs; ++r) {
    const int cnt = hdr >> 8;
    int hdr_n = 0, op_n = 0;
    Word w0_n = {0u, 0.0f};
    if (r + 1 < n_runs) {
      hdr_n = runs[r + 1];
      op_n = sop[hdr_n & 0xFF];
      w0_n = {words[t0 + cnt], imms[t0 + cnt]};
    }
    run_op<C, K, false>(f, op, words, imms, t0, cnt, w0);
    t0 += cnt;
    hdr = hdr_n;
    op = op_n;
    w0 = w0_n;
  }
}

// A warp-granular work queue over a block's items: each warp takes the
// next chunk of 32 x K items when it is done with its last, so warps of
// either home share the block's items by their speed.  Returns the chunk,
// the same on every lane; *counter (shared, 0 at the start) counts the
// chunks handed out.
__device__ __forceinline__ int next_chunk(int* counter) {
  int c = 0;
  if ((threadIdx.x & 31) == 0) c = atomicAdd(counter, 1);
  return __shfl_sync(0xffffffffu, c, 0);
}

// Stage a block's header (branch table, camera matrix, the work queue's
// counter) into shared memory.
__device__ __forceinline__ void stage_header(int* smem, const int* bid_op,
                                             const float* matf) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) smem[i] = bid_op[i];
  if (threadIdx.x < 16)
    reinterpret_cast<float*>(smem + 256)[threadIdx.x] = matf[threadIdx.x];
  if (threadIdx.x == 0) smem[QUEUE_INT] = 0;
}

// Copy n words and immediates and n_runs run headers into the staged-tape
// region of T entries each.
__device__ __forceinline__ void stage_tape(int* st, int T, const int* w,
                                           const float* imm, const int* runs,
                                           int n, int n_runs) {
  float* si = reinterpret_cast<float*>(st + T);
  int* sr = st + 2 * T;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    st[k] = w[k];
    si[k] = imm[k];
  }
  for (int k = threadIdx.x; k < n_runs; k += blockDim.x) sr[k] = runs[k];
}

}  // namespace mpr
