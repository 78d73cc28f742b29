// Kernel K2: the adjoint of the interpreter's float walk.
//
// The port's own kernel: no TPU kernel stands behind it.  On the TPU,
// mpr_tpu/ops/eval_scan.py::eval_f is a lax.scan over the tape (a
// lax.switch a clause over whole lane vectors), and the fit's gradient
// (mpr_tpu/parallel/sharded.py::make_fit_step) is XLA's transpose of that
// scan under jax.value_and_grad.  Here the tape is data, as in kernels B, V
// and D: one build serves every tape.
//
//   K2f (scan_eval.cu) walks the tape forward and stores what the tape's
//     storage plan lists (ops/vjp_plan.py): the clause values the partials
//     read, at compact positions (row spos of vals), and a 2-bit choice
//     code for each min/max clause, 16 to a word (row cidx / 16 of ch; bit
//     0: the lhs equals the result, bit 1: the other operand does), both in
//     blocks of 128 lanes (vjp_plan.LANE_BLOCK: entry (row, lane) at
//     lane / 128 * rows * 128 + row * 128 + lane % 128).  Linear clauses
//     store nothing.
//   K2 (scan_adjoint_kernel): each thread takes K lanes and walks the tape
//     backwards over an adjoint file indexed by slot, K floats a slot, on
//     chip: in shared memory (SharedFile) or in a local array of the slot
//     bucket (LocalFile<N>, L1), regfile.cuh's two homes; the host picks
//     the home, the threads and K (ops/launch.py::adjoint_launch).  Passing
//     clause t, which wrote slot `out`, it takes the file's `out`, zeroes
//     it, and adds the clause's partials into its lhs / rhs slots; one
//     decode, one switch and one warp reduction serve all K lanes (a thread
//     sums its K lanes' immediate share before the shuffles, adjoint.cuh).
//     The tape comes as 16-byte entries (word, immediate, the 16-bit codes
//     of the stored values the rule reads, the choice index), staged
//     through shared memory in tiles of ADJ_TILE with cp.async, two buffers;
//     each clause's entry and value loads are issued AHEAD clauses before
//     the clause runs, from a ring of registers.  A tape with more slots
//     than the file (s_cap) traps.
//
// The rules are jax.grad's of mpr_tpu/ops/eval_scan.py's branch table
// (:33-72), written as torch's autograd spells them where the two round
// differently (ops/vjp_plan.py::partials states them once; K1's generator
// runs that statement, this kernel spells it by hand), so K2 and autograd
// of the plain walk agree on the card to a sum-order tolerance: min/max
// give 1 to the side equal to the result, 0.5 each at a tie, 0 to both
// where the result is NaN; abs gives +1 for x >= 0 (so at +-0) and -1
// otherwise; sqrt g / (2 sqrt a) (inf at 0); DIV_IMM_RHS imm: g / b, b:
// -g imm / b^2; the INVALID/JUMP branch is a * 0 (g * 0 to lhs).
// asin/acos/atan take their analytic derivatives, as jax.grad of
// jnp.arcsin/arccos/arctan does.  Every partial of a clause whose output
// reaches the result is computed even where its adjoint is 0, as XLA
// does; a clause that does not reach it reads no stored value (its
// partials see zeros).
//
// Bound on the H100: K2 by the latency of its clause chain (an adjoint
// read, the rule, an adjoint read-modify-write a clause) against the lanes
// an SM holds, and by the plan's bytes.
//
// Two libraries hold K2's instantiations (ops/build.py): the main one the
// shapes adjoint_launch picks (K = 2 in either home), the extra one, built
// with MPR_EXTRA_SHAPES, K = 4 (ops/launch.py::MAIN_K, ADJ_KS; at K = 1
// ptxas spilled a few bytes, and it ran no faster than K = 2).
//
// Numerics: --fmad=false (ops/build.py), the float branch of clause.cuh.

#include <cstdint>

#include "adjoint.cuh"
#include "clause.cuh"
#include "regfile.cuh"

namespace {

using namespace mpr;

constexpr int ADJ_TILE = 256;         // ops/launch.py ADJ_TILE
constexpr int ADJ_MAX_THREADS = 256;  // ops/launch.py ADJ_THREADS
constexpr int LANE_BLOCK = 128;       // ops/vjp_plan.py LANE_BLOCK
// the 16-bit operand codes beside a stored value's position
// (ops/vjp_plan.py CODE_*)
constexpr uint32_t CODE_X = 0xFFFCu, CODE_Y = 0xFFFDu, CODE_Z = 0xFFFEu,
                   CODE_NONE = 0xFFFFu;

#define FOR_K(...)                                 \
  _Pragma("unroll") for (int k = 0; k < K; ++k) { \
    __VA_ARGS__;                                   \
  }

// One clause of K2's tape (ops/vjp_plan.py::VjpPlan.entry_codes): the
// word, the immediate, the codes of the lhs and rhs values its rule reads
// (ab: lhs | rhs << 16) and of its result (rc & 0xFFFF), its choice index
// (rc >> 16); CODE_NONE where there is none.
struct alignas(16) Entry {
  uint32_t w;
  float imm;
  uint32_t ab;
  uint32_t rc;
};

// Start copying tile j of the tape (ADJ_TILE entries, fewer at its end)
// into dst.
__device__ __forceinline__ void stage_tile(Entry* dst, const Entry* entries,
                                           int j, int L) {
  const int t0 = j * ADJ_TILE;
  const int cnt = min(ADJ_TILE, L - t0);
  for (int k = threadIdx.x; k < cnt; k += blockDim.x)
    cp16(dst + k, entries + t0 + k);
  cp_commit();
}

// K consecutive items from p (one 8- or 16-byte access for K = 2, 4).
template <int K, class T>
__device__ __forceinline__ void load_k(const T* p, T (&v)[K]) {
  struct alignas(sizeof(T) * K) G {
    T x[K];
  };
  const G g = *reinterpret_cast<const G*>(p);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = g.x[k];
}

// What a clause's rule reads for K lanes, loaded ahead of the clause.
template <int K>
struct Fetch {
  float a[K], b[K], r[K];
  uint32_t c[K];
};

// The lanes' inputs, and their first lane's row 0 of the stored values
// and choice words (the blocked layout: row r is 128 entries further).
template <int K>
struct Lanes {
  const float* vals;
  const uint32_t* ch;
  float x[K], y[K], z[K];
};

template <int K>
__device__ __forceinline__ void value_k(uint32_t code, const Lanes<K>& ln,
                                        float (&v)[K]) {
  if (code < CODE_X) {
    load_k<K>(ln.vals + (size_t)code * LANE_BLOCK, v);
    return;
  }
  FOR_K(v[k] = code == CODE_X ? ln.x[k]
               : code == CODE_Y ? ln.y[k]
               : code == CODE_Z ? ln.z[k]
                                : 0.0f)
}

template <int K>
__device__ __forceinline__ void fetch(const Entry& e, const Lanes<K>& ln,
                                      Fetch<K>& f) {
  value_k<K>(e.ab & 0xFFFFu, ln, f.a);
  value_k<K>(e.ab >> 16, ln, f.b);
  value_k<K>(e.rc & 0xFFFFu, ln, f.r);
  const uint32_t ci = e.rc >> 16;
  if (ci != CODE_NONE) {
    load_k<K>(ln.ch + (size_t)(ci >> 4) * LANE_BLOCK, f.c);
  } else {
    FOR_K(f.c[k] = 0u)
  }
}

__device__ __forceinline__ float bal_a(uint32_t c) {
  return (c & 1u) ? ((c & 2u) ? 0.5f : 1.0f) : 0.0f;
}

__device__ __forceinline__ float bal_b(uint32_t c) {
  return (c & 2u) ? ((c & 1u) ? 0.5f : 1.0f) : 0.0f;
}

// The opcodes whose rule gives the lhs, the rhs, the immediate a share
// (ops/vjp_plan.py USES_A, USES_B, USES_I), as bit masks.
constexpr uint32_t USES_A = ~((1u << OP_SUB_IMM_RHS) | (1u << OP_DIV_IMM_RHS) |
                              (1u << OP_COPY_IMM) | (1u << OP_COPY_RHS));
constexpr uint32_t USES_B =
    (1u << OP_ADD) | (1u << OP_MUL) | (1u << OP_MIN) | (1u << OP_MAX) |
    (1u << OP_SUB_IMM_RHS) | (1u << OP_SUB) | (1u << OP_DIV_IMM_RHS) |
    (1u << OP_DIV) | (1u << OP_COPY_RHS) | (1u << OP_HYPOT) | (1u << OP_ADDSQ);
constexpr uint32_t USES_I =
    (1u << OP_ADD_IMM) | (1u << OP_MUL_IMM) | (1u << OP_MIN_IMM) |
    (1u << OP_MAX_IMM) | (1u << OP_SUB_IMM) | (1u << OP_SUB_IMM_RHS) |
    (1u << OP_DIV_IMM) | (1u << OP_DIV_IMM_RHS) | (1u << OP_COPY_IMM);

// An immediate's share summed over the block's lanes (adjoint.cuh), one
// clause late: the shuffles of clause t's sum run while the next clause's
// adjoint reads are in flight.
struct Pending {
  float sum;
  int t;
};

__device__ __forceinline__ void flush(Pending& p, float* acc) {
  if (p.t >= 0) acc_imm(acc, p.t, p.sum);
  p.t = -1;
}

// Clause t's reverse step for a thread's K lanes: the output's adjoint and
// the operands' read at once (an operand slot equal to the output slot
// reads the zero it is about to hold), the rule, then the output zeroed
// and the operands' sums written back.
template <int K, class File>
__device__ __forceinline__ void clause_k(File& f, const Entry& e,
                                         const Fetch<K>& v, float* acc,
                                         int t, const bool (&live)[K],
                                         Pending& pend) {
  const uint32_t w = e.w;
  const int op = w_op(w), out = w_out(w), lhs = w_lhs(w), rhs = w_rhs(w);
  const bool ua = (USES_A >> op) & 1u, ub = (USES_B >> op) & 1u,
             ui = (USES_I >> op) & 1u;
  float g[K], sa[K], sb[K], da[K], db[K], di[K];
  f.load(out, g);
  if (ua) f.load(lhs, sa);
  if (ub) f.load(rhs, sb);
  flush(pend, acc);
  FOR_K(da[k] = 0.0f; db[k] = 0.0f; di[k] = 0.0f;
        if (lhs == out) sa[k] = 0.0f; if (rhs == out) sb[k] = 0.0f)
  const float imm = e.imm;
  const int sh = 2 * ((e.rc >> 16) & 15u);
  switch (op) {
    case OP_SQUARE: FOR_K(const float p = g[k] * v.a[k]; da[k] = p + p) break;
    case OP_SQRT: FOR_K(da[k] = g[k] / (2.0f * v.r[k])) break;
    case OP_NEG: FOR_K(da[k] = -g[k]) break;
    case OP_SIN: FOR_K(da[k] = g[k] * cosf(v.a[k])) break;
    case OP_COS: FOR_K(da[k] = g[k] * -sinf(v.a[k])) break;
    case OP_ASIN:
      FOR_K(da[k] = g[k] / sqrtf(1.0f - v.a[k] * v.a[k])) break;
    case OP_ACOS:
      FOR_K(da[k] = -g[k] / sqrtf(1.0f - v.a[k] * v.a[k])) break;
    case OP_ATAN: FOR_K(da[k] = g[k] / (1.0f + v.a[k] * v.a[k])) break;
    case OP_EXP: FOR_K(da[k] = g[k] * v.r[k]) break;
    case OP_ABS: FOR_K(da[k] = v.a[k] >= 0.0f ? g[k] : -g[k]) break;
    case OP_LOG: FOR_K(da[k] = g[k] / v.a[k]) break;
    case OP_ADD_IMM:
      FOR_K(da[k] = g[k]; di[k] = g[k])
      break;
    case OP_ADD:
      FOR_K(da[k] = g[k]; db[k] = g[k])
      break;
    case OP_MUL_IMM:
      FOR_K(da[k] = g[k] * imm; di[k] = g[k] * v.a[k])
      break;
    case OP_MUL:
      FOR_K(da[k] = g[k] * v.b[k]; db[k] = g[k] * v.a[k])
      break;
    case OP_MIN_IMM:
    case OP_MAX_IMM:
      FOR_K(const uint32_t c = v.c[k] >> sh; da[k] = g[k] * bal_a(c);
            di[k] = g[k] * bal_b(c))
      break;
    case OP_MIN:
    case OP_MAX:
      FOR_K(const uint32_t c = v.c[k] >> sh; da[k] = g[k] * bal_a(c);
            db[k] = g[k] * bal_b(c))
      break;
    case OP_SUB_IMM:
      FOR_K(da[k] = g[k]; di[k] = -g[k])
      break;
    case OP_SUB_IMM_RHS:
      FOR_K(db[k] = -g[k]; di[k] = g[k])
      break;
    case OP_SUB:
      FOR_K(da[k] = g[k]; db[k] = -g[k])
      break;
    case OP_DIV_IMM:
      FOR_K(da[k] = g[k] / imm; di[k] = -g[k] * v.a[k] / (imm * imm))
      break;
    case OP_DIV_IMM_RHS:
      FOR_K(db[k] = -g[k] * imm / (v.b[k] * v.b[k]); di[k] = g[k] / v.b[k])
      break;
    case OP_DIV:
      FOR_K(da[k] = g[k] / v.b[k];
            db[k] = -g[k] * v.a[k] / (v.b[k] * v.b[k]))
      break;
    case OP_COPY_IMM:
      FOR_K(di[k] = g[k])
      break;
    case OP_COPY_LHS: FOR_K(da[k] = g[k]) break;
    case OP_COPY_RHS:
      FOR_K(db[k] = g[k])
      break;
    case OP_HYPOT:
      FOR_K(const float h = g[k] / (2.0f * v.r[k]);
            const float ha = h * v.a[k]; const float hb = h * v.b[k];
            da[k] = ha + ha; db[k] = hb + hb)
      break;
    case OP_ADDSQ:
      FOR_K(const float p = g[k] * v.a[k]; da[k] = p + p; db[k] = g[k])
      break;
    default: FOR_K(da[k] = g[k] * 0.0f) break;  // INVALID, JUMP: a * 0
  }
  {
    float zero[K];
    FOR_K(zero[k] = 0.0f)
    f.store(out, zero);
  }
  if (ua) {
    FOR_K(sa[k] += da[k])
    f.store(lhs, sa);
  }
  if (ub) {
    if (ua && rhs == lhs) FOR_K(sb[k] = sa[k])
    FOR_K(sb[k] += db[k])
    f.store(rhs, sb);
  }
  if (ui) {
    pend.sum = 0.0f;
    FOR_K(pend.sum += live[k] ? di[k] : 0.0f)
    pend.t = t;
  }
}

// The reverse walk of the whole tape for one thread's K lanes: the file
// seeded with g at the result slot, the tape's tiles staged from the last
// down (tile j in buffer j & 1; the next one is copied while a tile runs),
// each clause's entry and values fetched AHEAD clauses before it runs.
// Every thread of the block runs the same steps (barriers, shuffles).
template <int K, class File>
__device__ __forceinline__ void walk(File& f, Entry* tiles,
                                     const Entry* entries, const Lanes<K>& ln,
                                     const float (&gk)[K],
                                     const bool (&live)[K], float* acc, int L,
                                     int s_cap, int result) {
  constexpr int AHEAD = K == 4 ? 2 : 4;
  {
    float zero[K];
    FOR_K(zero[k] = 0.0f)
    for (int s = 0; s < s_cap; ++s) f.store(s, zero);
    f.store(result, gk);
  }
  const int nt = (L + ADJ_TILE - 1) / ADJ_TILE;
  __syncthreads();  // the last lane group is done with the tiles
  stage_tile(tiles + ((nt - 1) & 1) * ADJ_TILE, entries, nt - 1, L);
  if (nt > 1)
    stage_tile(tiles + ((nt - 2) & 1) * ADJ_TILE, entries, nt - 2, L);
  cp_wait_all();
  __syncthreads();
  int tf = L - 1;  // the next clause to fetch
  auto next = [&](Entry& e, Fetch<K>& fe) {
    if (tf < 0) return;
    if (tf % ADJ_TILE == ADJ_TILE - 1 && tf < (nt - 1) * ADJ_TILE) {
      // tf opens tile j: it has landed; tile j + 1's buffer is free
      const int j = tf / ADJ_TILE;
      cp_wait_all();
      __syncthreads();
      if (j > 0)
        stage_tile(tiles + ((j - 1) & 1) * ADJ_TILE, entries, j - 1, L);
    }
    e = tiles[((tf / ADJ_TILE) & 1) * ADJ_TILE + tf % ADJ_TILE];
    fetch<K>(e, ln, fe);
    --tf;
  };
  Entry E[AHEAD];
  Fetch<K> F[AHEAD];
  Pending pend = {0.0f, -1};
#pragma unroll
  for (int d = 0; d < AHEAD; ++d) next(E[d], F[d]);
  for (int t = L - 1; t >= 0;) {
#pragma unroll
    for (int d = 0; d < AHEAD; ++d) {
      if (t >= 0) {
        clause_k<K>(f, E[d], F[d], acc, t, live, pend);
        next(E[d], F[d]);
        --t;
      }
    }
  }
  flush(pend, acc);
}

__host__ __device__ constexpr int acc_bytes(int L) {
  return 16 * ((4 * (L > 0 ? L : 1) + 15) / 16);
}

// N = 0: the files in shared memory (s_cap slots); else a local array of N
// slots.  Shared memory: the immediates' accumulator (L floats, padded to
// 16 bytes), two tiles of the tape, the shared home.
template <int K, int N>
__global__ void __launch_bounds__(ADJ_MAX_THREADS)
scan_adjoint_kernel(const Entry* __restrict__ entries,
                    const float* __restrict__ vals,
                    const uint32_t* __restrict__ ch,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ z, const float* __restrict__ g,
                    float* __restrict__ partials, int n, int ld, int nv,
                    int nw, int L, int nslots, int s_cap, int result) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (nslots > s_cap || result >= s_cap) __trap();  // the file's size
  float* acc = reinterpret_cast<float*>(smem);
  Entry* tiles = reinterpret_cast<Entry*>(smem + acc_bytes(L));
  float* home = reinterpret_cast<float*>(tiles + 2 * ADJ_TILE);
  acc_zero(acc, L);
  const int per = blockDim.x * K;
  // the block's lane groups in a grid-stride loop; every thread of a block
  // runs the same iterations
  for (int base = blockIdx.x * per; base < ld; base += gridDim.x * per) {
    const int lane0 = base + threadIdx.x * K;
    const size_t blk = lane0 / LANE_BLOCK, off = lane0 % LANE_BLOCK;
    Lanes<K> ln;
    ln.vals = vals + blk * nv * LANE_BLOCK + off;
    ln.ch = ch + blk * nw * LANE_BLOCK + off;
    float gk[K];
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = lane0 + k;
      live[k] = l < n;
      const int i = l < n ? l : n - 1;
      ln.x[k] = x[i];
      ln.y[k] = y[i];
      ln.z[k] = z[i];
      gk[k] = g[i];
    }
    if constexpr (N == 0) {
      SharedFile<float, K> f(home, blockDim.x);
      walk<K>(f, tiles, entries, ln, gk, live, acc, L, s_cap, result);
    } else {
      LocalFile<float, K, N> f;
      walk<K>(f, tiles, entries, ln, gk, live, acc, L, s_cap, result);
    }
  }
  acc_store(acc, partials, L, L);
}

using AdjKernel = decltype(&scan_adjoint_kernel<2, 0>);

#ifdef MPR_EXTRA_SHAPES
constexpr bool EXTRA = true;
#else
constexpr bool EXTRA = false;
#endif

// The instantiation for K and N, if this library holds it (K = 2 in main).
template <int K, int N>
AdjKernel adj_kernel() {
  constexpr bool in_main = K == 2;
  if constexpr (in_main != EXTRA) return scan_adjoint_kernel<K, N>;
  return nullptr;
}

template <int K>
AdjKernel pick_n(int bucket) {
  switch (bucket) {
    case 0: return adj_kernel<K, 0>();
    case 16: return adj_kernel<K, 16>();
    case 32: return adj_kernel<K, 32>();
    case 64: return adj_kernel<K, 64>();
    case 128: return adj_kernel<K, 128>();
    case 256: return adj_kernel<K, 256>();
    default: return nullptr;
  }
}

AdjKernel pick(int k, int bucket) {
  switch (k) {
    case 2: return pick_n<2>(bucket);
    case 4: return pick_n<4>(bucket);
    default: return nullptr;
  }
}

}  // namespace

// K2: grad (+)= d(sum_i g_i v_i)/d(imms) on n lanes, from K2f's stores
// (nv and nw rows in the blocked layout, over ld lanes, a multiple of
// threads x k); the adjoint in `blocks`
// blocks at launch shape (bucket 0: shared home; threads; k; smem, which
// the host computed, ops/launch.py::adjoint_launch), then the reduction
// over them (partials holds blocks x L floats).  A shape this library does
// not hold returns cudaErrorInvalidValue.
extern "C" int mpr_scan_adjoint(const void* entries, const void* vals,
                                const void* ch, const void* x, const void* y,
                                const void* z, const void* g, void* partials,
                                void* grad, int n, int ld, int nv, int nw,
                                int L, int nslots, int s_cap, int result,
                                int accumulate,
                                int blocks, int bucket, int threads, int k,
                                int smem, void* stream) {
  const AdjKernel fn = pick(k, bucket);
  if (fn == nullptr || threads % 32 || threads < 32 ||
      threads > ADJ_MAX_THREADS || n < 1 || L < 1 || ld < n ||
      ld % (threads * k) || nv < 1 || nw < 1 || nslots < 1 || result < 0 ||
      s_cap < 1 ||
      (bucket && s_cap > bucket) || blocks < 1 ||
      smem < acc_bytes(L) + 2 * ADJ_TILE * (int)sizeof(Entry))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  fn<<<blocks, threads, smem, st>>>(
      static_cast<const Entry*>(entries), static_cast<const float*>(vals),
      static_cast<const uint32_t*>(ch), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<const float*>(g), static_cast<float*>(partials), n, ld, nv,
      nw, L, nslots, s_cap, result);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(static_cast<const float*>(partials),
                         static_cast<float*>(grad), L, blocks, accumulate,
                         st);
}
