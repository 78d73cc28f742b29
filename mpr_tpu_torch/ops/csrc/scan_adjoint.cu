// Kernels K2f and K2: the interpreter's float walk and its adjoint.
//
// The port's own kernels: no TPU kernel stands behind them.  On the TPU,
// mpr_tpu/ops/eval_scan.py::eval_f is a lax.scan over the tape (a
// lax.switch a clause over whole lane vectors), and the fit's gradient
// (mpr_tpu/parallel/sharded.py::make_fit_step) is XLA's transpose of that
// scan under jax.value_and_grad.  Here the tape is data, as in kernels B, V
// and D: one build serves every tape.
//
//   K2f (scan_eval_kernel): a thread a lane walks the whole tape over a
//     register file of slots in local memory and writes the result slot;
//     with `vals`, also every clause's output, vals[t * n + lane] (the
//     forward values the adjoint reads).
//   K2 (scan_adjoint_kernel): a thread a lane walks the tape backwards
//     over an adjoint register file indexed by slot: passing clause t,
//     which wrote slot `out`, it takes adj[out], zeroes it, and adds the
//     clause's partials into its lhs / rhs slots; an immediate's share is
//     summed over the lanes (adjoint.cuh).  A clause's operand values come
//     from `vals` through the host's operand table src (ops/tape_data.py::
//     TapeData.sources: the clause whose output it reads, or an input).
//
// The rules are jax.grad's of mpr_tpu/ops/eval_scan.py's branch table
// (:33-72), written as torch's autograd spells them where the two round
// differently, so K2 and autograd of the plain walk agree on the card to a
// sum-order tolerance: min/max give 1 to the side equal to the result,
// 0.5 each at a tie, 0 to both where the result is NaN; abs gives +1 for
// x >= 0 (so at +-0) and -1 otherwise; sqrt g / (2 sqrt a) (inf at 0);
// DIV_IMM_RHS imm: g / b, b: -g imm / b^2; the INVALID/JUMP branch is
// a * 0 (g * 0 to lhs).  asin/acos/atan take their analytic derivatives,
// as jax.grad of jnp.arcsin/arccos/arctan does (the plain walk
// differentiates the Cephes polynomials, within a few ulp of them).
// Every partial is computed even where the adjoint is 0, as XLA does: a
// 0 * inf partial is NaN in both.
//
// Bound on the H100: K2f by operations for long tapes (about one clause a
// lane and cycle at best, plus the register file's local-memory traffic);
// K2 by the bytes of vals (T x n floats read back) and its register file.
// Simple first designs: the tape is read through the read-only cache, not
// staged; the register files live in local memory (L1).
//
// Numerics: --fmad=false (ops/build.py), the float branch of clause.cuh.

#include <cstdint>

#include "adjoint.cuh"
#include "clause.cuh"

namespace {

using namespace mpr;

constexpr int SCAN_THREADS = 128;
constexpr int MAX_SLOTS = 256;

__device__ __forceinline__ float float_dyn(int op, float a, float b,
                                           float imm) {
  switch (op) {
#define MPR_CASE(OP) \
  case OP: return float_op<OP>(a, b, imm);
    MPR_CASE(OP_SQUARE) MPR_CASE(OP_SQRT) MPR_CASE(OP_NEG) MPR_CASE(OP_SIN)
    MPR_CASE(OP_COS) MPR_CASE(OP_ASIN) MPR_CASE(OP_ACOS) MPR_CASE(OP_ATAN)
    MPR_CASE(OP_EXP) MPR_CASE(OP_ABS) MPR_CASE(OP_LOG) MPR_CASE(OP_ADD_IMM)
    MPR_CASE(OP_ADD) MPR_CASE(OP_MUL_IMM) MPR_CASE(OP_MUL)
    MPR_CASE(OP_MIN_IMM) MPR_CASE(OP_MIN) MPR_CASE(OP_MAX_IMM)
    MPR_CASE(OP_MAX) MPR_CASE(OP_SUB_IMM) MPR_CASE(OP_SUB_IMM_RHS)
    MPR_CASE(OP_SUB) MPR_CASE(OP_DIV_IMM) MPR_CASE(OP_DIV_IMM_RHS)
    MPR_CASE(OP_DIV) MPR_CASE(OP_COPY_IMM) MPR_CASE(OP_COPY_LHS)
    MPR_CASE(OP_COPY_RHS) MPR_CASE(OP_HYPOT) MPR_CASE(OP_ADDSQ)
#undef MPR_CASE
    default: return a * 0.0f;  // INVALID, JUMP
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_eval_kernel(const uint32_t* __restrict__ words,
                 const float* __restrict__ imms, const float* __restrict__ x,
                 const float* __restrict__ y, const float* __restrict__ z,
                 float* __restrict__ v, float* __restrict__ vals, int n,
                 int L, int nslots, int result, int sx, int sy, int sz) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float regs[MAX_SLOTS];
  for (int s = 0; s < nslots; ++s) regs[s] = 0.0f;
  if (sx) regs[sx] = x[i];
  if (sy) regs[sy] = y[i];
  if (sz) regs[sz] = z[i];
#pragma unroll 1
  for (int t = 0; t < L; ++t) {
    const uint32_t w = __ldg(words + t);
    const float r = float_dyn(w_op(w), regs[w_lhs(w)], regs[w_rhs(w)],
                              __ldg(imms + t));
    regs[w_out(w)] = r;
    if (vals) vals[(size_t)t * n + i] = r;
  }
  v[i] = regs[result];
}

__device__ __forceinline__ float operand(int src, const float* vals, int n,
                                         int i, float x, float y, float z) {
  if (src >= 0) return vals[(size_t)src * n + i];
  return src == -1 ? x : (src == -2 ? y : (src == -3 ? z : 0.0f));
}

// JAX's share of a min/max's gradient for operand p (q the other one).
__device__ __forceinline__ float balanced(float p, float q, float r) {
  return p == r ? (q == r ? 0.5f : 1.0f) : 0.0f;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_adjoint_kernel(const uint32_t* __restrict__ words,
                    const float* __restrict__ imms,
                    const int* __restrict__ src, const float* __restrict__ x,
                    const float* __restrict__ y, const float* __restrict__ z,
                    const float* __restrict__ vals,
                    const float* __restrict__ g, float* __restrict__ partials,
                    int n, int L, int nslots, int result) {
  extern __shared__ float acc[];
  acc_zero(acc, L);
  float adj[MAX_SLOTS];
  const int stride = gridDim.x * blockDim.x;
  // the block's lanes in a grid-stride loop; every thread of a block runs
  // the same iterations (the shuffles of acc_imm need the whole warp)
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int lane = base + threadIdx.x;
    const bool live = lane < n;
    const int i = live ? lane : n - 1;
    const float xi = x[i], yi = y[i], zi = z[i];
    for (int s = 0; s < nslots; ++s) adj[s] = 0.0f;
    adj[result] = g[i];
#pragma unroll 1
    for (int t = L - 1; t >= 0; --t) {
      const uint32_t w = __ldg(words + t);
      const int op = w_op(w), out = w_out(w), lhs = w_lhs(w), rhs = w_rhs(w);
      const float ga = adj[out];
      adj[out] = 0.0f;
      const float imm = __ldg(imms + t);
      const float a = operand(__ldg(src + t), vals, n, i, xi, yi, zi);
      const float b = operand(__ldg(src + L + t), vals, n, i, xi, yi, zi);
      const float r = vals[(size_t)t * n + i];
      float da = 0.0f, db = 0.0f, di = 0.0f;
      bool use_a = true, use_b = false, use_i = false;
      switch (op) {
        case OP_SQUARE: da = ga * a + ga * a; break;
        case OP_SQRT: da = ga / (2.0f * r); break;
        case OP_NEG: da = -ga; break;
        case OP_SIN: da = ga * cosf(a); break;
        case OP_COS: da = ga * -sinf(a); break;
        case OP_ASIN: da = ga / sqrtf(1.0f - a * a); break;
        case OP_ACOS: da = -ga / sqrtf(1.0f - a * a); break;
        case OP_ATAN: da = ga / (1.0f + a * a); break;
        case OP_EXP: da = ga * r; break;
        case OP_ABS: da = a >= 0.0f ? ga : -ga; break;
        case OP_LOG: da = ga / a; break;
        case OP_ADD_IMM: da = ga; di = ga; use_i = true; break;
        case OP_ADD: da = ga; db = ga; use_b = true; break;
        case OP_MUL_IMM: da = ga * imm; di = ga * a; use_i = true; break;
        case OP_MUL: da = ga * b; db = ga * a; use_b = true; break;
        case OP_MIN_IMM:
        case OP_MAX_IMM:
          da = ga * balanced(a, imm, r);
          di = ga * balanced(imm, a, r);
          use_i = true;
          break;
        case OP_MIN:
        case OP_MAX:
          da = ga * balanced(a, b, r);
          db = ga * balanced(b, a, r);
          use_b = true;
          break;
        case OP_SUB_IMM: da = ga; di = -ga; use_i = true; break;
        case OP_SUB_IMM_RHS:
          di = ga; db = -ga; use_a = false; use_b = use_i = true; break;
        case OP_SUB: da = ga; db = -ga; use_b = true; break;
        case OP_DIV_IMM:
          da = ga / imm; di = -ga * a / (imm * imm); use_i = true; break;
        case OP_DIV_IMM_RHS:
          di = ga / b; db = -ga * imm / (b * b);
          use_a = false; use_b = use_i = true;
          break;
        case OP_DIV: da = ga / b; db = -ga * a / (b * b); use_b = true; break;
        case OP_COPY_IMM: di = ga; use_a = false; use_i = true; break;
        case OP_COPY_LHS: da = ga; break;
        case OP_COPY_RHS: db = ga; use_a = false; use_b = true; break;
        case OP_HYPOT: {
          const float h = ga / (2.0f * r);
          da = h * a + h * a;
          db = h * b + h * b;
          use_b = true;
          break;
        }
        case OP_ADDSQ: da = ga * a + ga * a; db = ga; use_b = true; break;
        default: da = ga * 0.0f; break;  // INVALID, JUMP: a * 0
      }
      if (use_a) adj[lhs] += da;
      if (use_b) adj[rhs] += db;
      if (use_i) acc_imm(acc, t, live ? di : 0.0f);
    }
  }
  acc_store(acc, partials, L, L);
}

}  // namespace

// K2f: v (and, with vals non-null, every clause's output) on n lanes.
extern "C" int mpr_scan_adjoint_eval(const void* words, const void* imms,
                                     const void* x, const void* y,
                                     const void* z, void* v, void* vals,
                                     int n, int L, int nslots, int result,
                                     int sx, int sy, int sz, void* stream) {
  if (n < 0 || L < 0 || nslots < 1 || nslots > MAX_SLOTS || result < 0 ||
      result >= MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  scan_eval_kernel<<<(n + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(imms),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(z), static_cast<float*>(v),
      static_cast<float*>(vals), n, L, nslots, result, sx, sy, sz);
  return (int)cudaGetLastError();
}

// K2: grad (+)= d(sum_i g_i v_i)/d(imms) on n lanes, from K2f's vals; the
// adjoint in `blocks` blocks, then the reduction over them (partials holds
// blocks x L floats).
extern "C" int mpr_scan_adjoint(const void* words, const void* imms,
                                const void* src, const void* x, const void* y,
                                const void* z, const void* vals,
                                const void* g, void* partials, void* grad,
                                int n, int L, int nslots, int result,
                                int accumulate, int blocks, void* stream) {
  if (n < 1 || L < 0 || nslots < 1 || nslots > MAX_SLOTS || result < 0 ||
      result >= MAX_SLOTS || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  const int smem = L * (int)sizeof(float);
  int err = allow_smem((const void*)scan_adjoint_kernel, smem);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  scan_adjoint_kernel<<<blocks, SCAN_THREADS, smem, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(imms),
      static_cast<const int*>(src), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<const float*>(vals), static_cast<const float*>(g),
      static_cast<float*>(partials), n, L, nslots, result);
  err = (int)cudaGetLastError();
  if (err) return err;
  return reduce_partials(static_cast<const float*>(partials),
                         static_cast<float*>(grad), L, blocks, accumulate,
                         st);
}
