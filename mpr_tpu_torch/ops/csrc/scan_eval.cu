// Kernel K2f: the interpreter's float walk, and the store of K2's plan.
//
// The port's own kernel: no TPU kernel stands behind it.  On the TPU,
// mpr_tpu/ops/eval_scan.py::eval_f is a lax.scan over the tape (a
// lax.switch a clause over whole lane vectors).  Here the tape is data:
// one build serves every tape.  It carries every dense evaluation on the
// card (render/brute.py, cli brute, the sharded scan fit) and, storing
// (STORE), the forward half of the scan fit's gradient: the clause values
// and choice words that K2 (scan_adjoint.cu) reads, in the blocked layout
// of ops/vjp_plan.py (entry (row, lane) at lane / 128 * rows * 128 + row *
// 128 + lane % 128).
//
// The walk is the tape's re-slotted plan (ops/scan_plan.py), made once per
// tape on the host: the clauses depth first by register pressure, each
// value in a file slot from its clause to its last reader, so that the
// file holds the plan's live peak (21 slots at stress_2d(600), against the
// tape's 173).  Each walk position is a 16-byte entry:
//   w   op | out << 8 | lhs << 16 | rhs << 24, in file slots;
//   imm the clause's immediate;
//   st  its value's stored row (spos, 0xFFFF: none) | its choice index
//       << 16 (0xFFFF: none);
//   fl  A_ACC / B_ACC: the operand is the previous position's value, held
//       in registers (or is not read); KEEP: the value goes to file slot
//       out; W_FIRST / W_LAST: the choice code opens / closes its word,
//       which lives in file slot fl >> 8 between the two and is written
//       out, whole, at W_LAST.
//
// Each thread walks K lanes, consecutive in one 128-lane block of the
// layout, so each stored row is one 4K-byte vector access a thread (a warp
// writes K x 128 bytes in a row), and each entry is read and decoded once
// for the K lanes.  The file lives in shared memory (regfile.cuh's
// SharedFile: K floats a slot a thread, one vector access); the walk's
// entries come through shared memory in tiles of SCAN_TILE, two buffers
// filled with cp.async while the other tile runs.  Resident blocks take
// the lanes in a grid-stride loop; the host picks threads, K and the grid
// (ops/launch.py::scan_launch, scan_blocks).
//
// The first design (scan_eval_first_kernel: a thread a lane over a local
// array of 256 slots in the tape's own order, a switch a clause) stays in
// the extra library, so that the card's runs time it beside this one.
//
// Bound on the H100: by operations for the brute renders' long tapes; the
// storing launch by the store's bytes (K2's plan: 7,100 B a lane at
// stress_2d(600)).  The walk itself is bound by issue and latency: each
// position costs a warp some 40 instructions (the entry's decode, the
// switch, the file's accesses) for one operation a lane, and the scan
// fit's 65,536 lanes leave each scheduler about four warps to hide a
// position's chain (PERF.md, PR 12).
//
// The main library holds the walk at K = 1 and 4 (ops/launch.py
// SCAN_SWEEP), the extra one (MPR_EXTRA_SHAPES, ops/build.py) the first
// design.
//
// Numerics: --fmad=false (ops/build.py), the float branch of clause.cuh;
// a clause's operands and rounding are the tape's, in any order.

#include <cstdint>

#include "adjoint.cuh"
#include "clause.cuh"
#include "regfile.cuh"

namespace {

using namespace mpr;

constexpr int SCAN_TILE = 256;         // ops/launch.py SCAN_TILE
constexpr int SCAN_MAX_THREADS = 256;  // ops/launch.py SCAN_SWEEP
constexpr int MAX_FILE = 256;          // ops/scan_plan.py MAX_FILE
constexpr int LANE_BLOCK = 128;        // ops/vjp_plan.py LANE_BLOCK
constexpr uint32_t NONE16 = 0xFFFFu;
// ops/scan_plan.py's flags
constexpr uint32_t F_A_ACC = 1u, F_B_ACC = 2u, F_KEEP = 4u, F_W_FIRST = 8u,
                   F_W_LAST = 16u;

#define FOR_K(...)                                 \
  _Pragma("unroll") for (int k = 0; k < K; ++k) { \
    __VA_ARGS__;                                   \
  }

#define MPR_FLOAT_OPS(X)                                                  \
  X(OP_SQUARE) X(OP_SQRT) X(OP_NEG) X(OP_SIN) X(OP_COS) X(OP_ASIN)        \
  X(OP_ACOS) X(OP_ATAN) X(OP_EXP) X(OP_ABS) X(OP_LOG) X(OP_ADD_IMM)       \
  X(OP_ADD) X(OP_MUL_IMM) X(OP_MUL) X(OP_MIN_IMM) X(OP_MIN) X(OP_MAX_IMM) \
  X(OP_MAX) X(OP_SUB_IMM) X(OP_SUB_IMM_RHS) X(OP_SUB) X(OP_DIV_IMM)       \
  X(OP_DIV_IMM_RHS) X(OP_DIV) X(OP_COPY_IMM) X(OP_COPY_LHS)               \
  X(OP_COPY_RHS) X(OP_HYPOT) X(OP_ADDSQ)

#ifndef MPR_EXTRA_SHAPES
constexpr bool EXTRA = false;
#else
constexpr bool EXTRA = true;
#endif

// One position of the walk (ops/scan_plan.py::ScanPlan.entries).
struct alignas(16) ScanEntry {
  uint32_t w;
  float imm;
  uint32_t st;
  uint32_t fl;
};

// One clause for K lanes: a switch on the opcode, the K lanes inside.
template <int K>
__device__ __forceinline__ void float_k(int op, const float (&a)[K],
                                        const float (&b)[K], float imm,
                                        float (&r)[K]) {
  switch (op) {
#define MPR_CASE(OP)                                 \
  case OP:                                           \
    FOR_K(r[k] = float_op<OP>(a[k], b[k], imm))      \
    break;
    MPR_FLOAT_OPS(MPR_CASE)
#undef MPR_CASE
    default: FOR_K(r[k] = a[k] * 0.0f) break;  // INVALID, JUMP
  }
}

// K items to p[0..K) of a thread whose lanes are all live (one vector
// access), else to the live ones alone.
template <int K, class T>
__device__ __forceinline__ void store_k(T* p, const T (&v)[K], bool full,
                                        const bool (&live)[K]) {
  if (full) {
    Group<T, K> g;
    FOR_K(g.v[k] = v[k])
    *reinterpret_cast<Group<T, K>*>(p) = g;
  } else {
    FOR_K(if (live[k]) p[k] = v[k])
  }
}

// Start copying tile j of the walk (SCAN_TILE entries, fewer at its end).
__device__ __forceinline__ void stage(ScanEntry* dst,
                                      const ScanEntry* entries, int j,
                                      int P) {
  const int t0 = j * SCAN_TILE;
  const int cnt = min(SCAN_TILE, P - t0);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x)
    cp16(dst + i, entries + t0 + i);
  cp_commit();
}

// Where a thread's K lanes store: their first lane's row 0 of the values
// and of the choice words, and which lanes exist.
template <int K>
struct Out {
  float* vals;
  uint32_t* ch;
  bool full;
  bool live[K];
};

// One position of the walk for a thread's K lanes.
template <int K, bool STORE, class File>
__device__ __forceinline__ void step(File& f, const ScanEntry& e,
                                     float (&acc)[K], const Out<K>& o) {
  const uint32_t w = e.w, fl = e.fl;
  const int op = w_op(w);
  float a[K], b[K], r[K];
  if (fl & F_A_ACC) {
    FOR_K(a[k] = acc[k])
  } else {
    f.load(w_lhs(w), a);
  }
  if (fl & F_B_ACC) {
    FOR_K(b[k] = acc[k])
  } else {
    f.load(w_rhs(w), b);
  }
  float_k<K>(op, a, b, e.imm, r);
  if (fl & F_KEEP) f.store(w_out(w), r);
  if constexpr (STORE) {
    const uint32_t sp = e.st & NONE16, ci = e.st >> 16;
    if (sp != NONE16)
      store_k<K>(o.vals + (size_t)sp * LANE_BLOCK, r, o.full, o.live);
    if (ci != NONE16) {
      const bool by_imm = op == OP_MIN_IMM || op == OP_MAX_IMM;
      const int sh = 2 * (ci & 15u);
      const int ws = fl >> 8;
      uint32_t c[K];
      FOR_K(const float q = by_imm ? e.imm : b[k];
            c[k] = ((uint32_t)(a[k] == r[k]) | ((uint32_t)(q == r[k]) << 1))
                   << sh)
      if (!(fl & F_W_FIRST)) {
        float old[K];
        f.load(ws, old);
        FOR_K(c[k] |= __float_as_uint(old[k]))
      }
      if (fl & F_W_LAST) {
        store_k<K>(o.ch + (size_t)(ci >> 4) * LANE_BLOCK, c, o.full, o.live);
      } else {
        float cf[K];
        FOR_K(cf[k] = __uint_as_float(c[k]))
        f.store(ws, cf);
      }
    }
  }
  FOR_K(acc[k] = r[k])
}

// The walk over n lanes: a block's lane groups in a grid-stride loop (every
// thread of a block runs the same iterations: barriers), each group's
// inputs into their file slots (in[0..3]: x, y, z, zero; -1: not read),
// the P entries tile by tile, then the result slot to v.
template <int K, bool STORE>
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
scan_walk_kernel(const ScanEntry* __restrict__ entries,
                 const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, float* __restrict__ v,
                 float* __restrict__ vals, uint32_t* __restrict__ ch, int n,
                 int nv, int nw, int P, int4 in, int result) {
  extern __shared__ __align__(16) unsigned char smem[];
  ScanEntry* tiles = reinterpret_cast<ScanEntry*>(smem);
  // two tiles and a spare entry (read ahead past a tile's end), the file
  SharedFile<float, K> f(
      reinterpret_cast<float*>(tiles + 2 * SCAN_TILE + 1), blockDim.x);
  const int nt = (P + SCAN_TILE - 1) / SCAN_TILE;
  const int per = blockDim.x * K;
  for (int base = blockIdx.x * per; base < n; base += gridDim.x * per) {
    const int lane0 = base + threadIdx.x * K;
    Out<K> o;
    float in_k[4][K];
    o.full = lane0 + K <= n;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = lane0 + k;
      o.live[k] = l < n;
      const int i = l < n ? l : n - 1;
      in_k[0][k] = x[i];
      in_k[1][k] = y[i];
      in_k[2][k] = z[i];
      in_k[3][k] = 0.0f;
    }
    if constexpr (STORE) {
      const size_t blk = lane0 / LANE_BLOCK, off = lane0 % LANE_BLOCK;
      o.vals = vals + blk * nv * LANE_BLOCK + off;
      o.ch = ch + blk * nw * LANE_BLOCK + off;
    }
    if (in.x >= 0) f.store(in.x, in_k[0]);
    if (in.y >= 0) f.store(in.y, in_k[1]);
    if (in.z >= 0) f.store(in.z, in_k[2]);
    if (in.w >= 0) f.store(in.w, in_k[3]);
    float acc[K];
    FOR_K(acc[k] = 0.0f)
    __syncthreads();  // the last lane group is done with the tiles
    if (nt > 0) stage(tiles, entries, 0, P);
    if (nt > 1) stage(tiles + SCAN_TILE, entries, 1, P);
    for (int j = 0; j < nt; ++j) {
      // tile j has landed; tile j - 1's buffer is free for tile j + 1
      cp_wait_all();
      __syncthreads();
      if (j > 0 && j + 1 < nt)
        stage(tiles + ((j + 1) & 1) * SCAN_TILE, entries, j + 1, P);
      const ScanEntry* tile = tiles + (j & 1) * SCAN_TILE;
      const int cnt = min(SCAN_TILE, P - j * SCAN_TILE);
      // two positions an iteration, each entry read one position ahead
      // (the read past the tile's last entry is not used)
      ScanEntry e0 = tile[0];
      int i = 0;
#pragma unroll 1
      for (; i + 1 < cnt; i += 2) {
        const ScanEntry e1 = tile[i + 1];
        step<K, STORE>(f, e0, acc, o);
        e0 = tile[i + 2];
        step<K, STORE>(f, e1, acc, o);
      }
      if (i < cnt) step<K, STORE>(f, e0, acc, o);
    }
    float r[K];
    f.load(result, r);
    store_k<K>(v + lane0, r, o.full, o.live);
  }
}

using WalkKernel = decltype(&scan_walk_kernel<1, false>);

// The instantiation for K and STORE (launch.py SCAN_SWEEP's K), in the
// main library.
template <bool STORE>
WalkKernel pick(int k) {
  if constexpr (EXTRA) {
    return nullptr;
  } else {
    switch (k) {
      case 1: return scan_walk_kernel<1, STORE>;
      case 4: return scan_walk_kernel<4, STORE>;
      default: return nullptr;
    }
  }
}

#ifdef MPR_EXTRA_SHAPES

// ---- the first design ------------------------------------------------------

__device__ __forceinline__ float float_dyn(int op, float a, float b,
                                           float imm) {
  switch (op) {
#define MPR_CASE(OP) \
  case OP: return float_op<OP>(a, b, imm);
    MPR_FLOAT_OPS(MPR_CASE)
#undef MPR_CASE
    default: return a * 0.0f;  // INVALID, JUMP
  }
}

constexpr int FIRST_THREADS = 128;

// A thread a lane walks the tape in its own order over a local array of
// 256 slots; STORE: also the plan's values (spos[t] >= 0: row spos[t])
// and choice words (a word written once its 16th code is in).
template <bool STORE>
__global__ void __launch_bounds__(FIRST_THREADS)
scan_eval_first_kernel(const uint32_t* __restrict__ words,
                       const float* __restrict__ imms,
                       const int* __restrict__ spos,
                       const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ z, float* __restrict__ v,
                       float* __restrict__ vals, uint32_t* __restrict__ ch,
                       int n, int nv, int nw, int L, int nslots, int result,
                       int sx, int sy, int sz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t blk = i / LANE_BLOCK, off = i % LANE_BLOCK;
  const size_t vb = blk * nv * LANE_BLOCK + off;
  const size_t cb = blk * nw * LANE_BLOCK + off;
  float regs[MAX_FILE];
  for (int s = 0; s < nslots; ++s) regs[s] = 0.0f;
  if (sx) regs[sx] = x[i];
  if (sy) regs[sy] = y[i];
  if (sz) regs[sz] = z[i];
  uint32_t cw = 0u;
  int ci = 0;
#pragma unroll 1
  for (int t = 0; t < L; ++t) {
    const uint32_t w = __ldg(words + t);
    const int op = w_op(w);
    const float a = regs[w_lhs(w)], b = regs[w_rhs(w)];
    const float imm = __ldg(imms + t);
    const float r = float_dyn(op, a, b, imm);
    regs[w_out(w)] = r;
    if (STORE) {
      const int sp = __ldg(spos + t);
      if (sp >= 0) vals[vb + (size_t)sp * LANE_BLOCK] = r;
      if (op >= CHOICE_OP_LO && op <= CHOICE_OP_HI) {
        const float q = (op == OP_MIN_IMM || op == OP_MAX_IMM) ? imm : b;
        cw |= ((uint32_t)(a == r) | ((uint32_t)(q == r) << 1))
              << (2 * (ci & 15));
        if ((ci & 15) == 15) {
          ch[cb + (size_t)(ci >> 4) * LANE_BLOCK] = cw;
          cw = 0u;
        }
        ++ci;
      }
    }
  }
  if (STORE && (ci & 15)) ch[cb + (size_t)(ci >> 4) * LANE_BLOCK] = cw;
  v[i] = regs[result];
}

#endif  // MPR_EXTRA_SHAPES

}  // namespace

// K2f: v on n lanes (and, with vals non-null, the plan's values and choice
// words: nv and nw rows in the blocked layout) by the re-slotted walk of P
// entries over a file of `slots` slots, the inputs in slots ix, iy, iz and
// a zero in slot i0 (-1: not read), the result read from slot `result`; at
// launch shape (threads, k, smem) on `blocks` blocks, which the host
// computed (ops/launch.py::scan_launch, scan_blocks).  A shape this library
// does not hold returns cudaErrorInvalidValue.
extern "C" int mpr_scan_eval(const void* entries, const void* x,
                             const void* y, const void* z, void* v,
                             void* vals, void* ch, int n, int nv, int nw,
                             int P, int slots, int ix, int iy, int iz,
                             int i0, int result, int blocks, int threads,
                             int k, int smem, void* stream) {
  const WalkKernel fn = vals ? pick<true>(k) : pick<false>(k);
  const auto bad_slot = [slots](int s) { return s < -1 || s >= slots; };
  if (fn == nullptr || n < 0 || P < 0 || nv < 1 || nw < 1 || slots < 1 ||
      slots > MAX_FILE || result < 0 || result >= slots || bad_slot(ix) ||
      bad_slot(iy) || bad_slot(iz) || bad_slot(i0) || threads % 32 ||
      threads < 32 || threads > SCAN_MAX_THREADS || blocks < 1 ||
      (vals && !ch) ||
      smem < (int)((2 * SCAN_TILE + 1) * sizeof(ScanEntry)) +
                 4 * slots * k * threads)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int err = allow_smem((const void*)fn, smem);
  if (err) return err;
  fn<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ScanEntry*>(entries), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<float*>(v), static_cast<float*>(vals),
      static_cast<uint32_t*>(ch), n, nv, nw, P, make_int4(ix, iy, iz, i0),
      result);
  return (int)cudaGetLastError();
}

#ifdef MPR_EXTRA_SHAPES
// K2f's first design: v (and, with vals non-null, the plan's values at
// spos and its choice words) on n lanes, the tape's L clauses in its own
// order over its own nslots slots.
extern "C" int mpr_scan_eval_first(const void* words, const void* imms,
                                   const void* spos, const void* x,
                                   const void* y, const void* z, void* v,
                                   void* vals, void* ch, int n, int nv,
                                   int nw, int L, int nslots, int result,
                                   int sx, int sy, int sz, void* stream) {
  if (n < 0 || L < 0 || nv < 1 || nw < 1 || nslots < 1 ||
      nslots > MAX_FILE || result < 0 || result >= MAX_FILE ||
      (vals && (!spos || !ch)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const auto fn =
      vals ? scan_eval_first_kernel<true> : scan_eval_first_kernel<false>;
  fn<<<(n + FIRST_THREADS - 1) / FIRST_THREADS, FIRST_THREADS, 0,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(imms),
      static_cast<const int*>(spos), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<float*>(v), static_cast<float*>(vals),
      static_cast<uint32_t*>(ch), n, nv, nw, L, nslots, result, sx, sy, sz);
  return (int)cudaGetLastError();
}
#endif
