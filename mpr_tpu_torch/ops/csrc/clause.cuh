// Clause semantics shared by the kernels: the interval branch, the float
// branch and the derivative (dual-number) branch of all 32 opcodes.
//
// This is the CUDA statement of mpr_tpu/ops/kernels.py:83-317 (interval,
// `_interval_branch_list`), :575-609 (float, `_float_branch_list`) and
// mpr_tpu/ops/kernels3d.py:231-363 (derivative, `_deriv_branch_list`), kept
// operation for operation so the kernels round exactly as the JAX package
// and the plain PyTorch versions in ops/kernels.py and ops/kernels3d.py do.
// The rules that make that hold:
//   * build with --fmad=false and without --use_fast_math (no contraction,
//     IEEE division and square root, no flush to zero);
//   * min/max propagate NaN like jnp.minimum / torch.minimum (fminf and
//     fmaxf do not), see nmin/nmax;
//   * asin, acos and atan use the Cephes forms of ops/transcendental.py,
//     with the constants rounded from double to float as JAX rounds them;
//   * interval sin/cos are always [-1, 1] (the reference quirk), and the
//     interval log keeps the reference quirk too;
//   * clause words are decoded as uint32: a word whose rhs byte is >= 128
//     is negative as an int32.
#pragma once

#include <cstdint>
#include <math.h>

namespace mpr {

// Opcode numbering of tape/opcodes.py (the reference's gpu_opcode.hpp).
enum Op : int {
  OP_INVALID = 0, OP_JUMP = 1,
  OP_SQUARE = 2, OP_SQRT = 3, OP_NEG = 4, OP_SIN = 5, OP_COS = 6,
  OP_ASIN = 7, OP_ACOS = 8, OP_ATAN = 9, OP_EXP = 10, OP_ABS = 11,
  OP_LOG = 12,
  OP_ADD_IMM = 13, OP_ADD = 14, OP_MUL_IMM = 15, OP_MUL = 16,
  OP_MIN_IMM = 17, OP_MIN = 18, OP_MAX_IMM = 19, OP_MAX = 20,
  OP_SUB_IMM = 21, OP_SUB_IMM_RHS = 22, OP_SUB = 23,
  OP_DIV_IMM = 24, OP_DIV_IMM_RHS = 25, OP_DIV = 26,
  OP_COPY_IMM = 27, OP_COPY_LHS = 28, OP_COPY_RHS = 29,
  OP_HYPOT = 30, OP_ADDSQ = 31,
  NUM_OPS = 32,
};
constexpr int CHOICE_OP_LO = OP_MIN_IMM;
constexpr int CHOICE_OP_HI = OP_MAX;

// Tile status and shorten codes (ops/kernels.py constants).
constexpr int ST_EMPTY = 0, ST_FILLED = 1, ST_AMBIG = 2;
constexpr int CODE_DROP = 0, CODE_KEEP = 1, CODE_COPY_LHS = 2,
              CODE_COPY_RHS = 3, CODE_COPY_IMM = 4;

__device__ __forceinline__ int w_op(uint32_t w) { return w & 0xFF; }
__device__ __forceinline__ int w_out(uint32_t w) { return (w >> 8) & 0xFF; }
__device__ __forceinline__ int w_lhs(uint32_t w) { return (w >> 16) & 0xFF; }
__device__ __forceinline__ int w_rhs(uint32_t w) { return (w >> 24) & 0xFF; }

__device__ __forceinline__ float f_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// NaN-propagating min/max, as torch.minimum/maximum compute them on CUDA.
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clip1(float x) {
  return nmin(nmax(x, -1.0f), 1.0f);
}
// XLA's sign: -1, +1, or x itself for +-0 and NaN.
__device__ __forceinline__ float xsign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ---- Cephes asin/acos/atan (ops/transcendental.py) -------------------------
#define MPR_F(c) ((float)(c))

__device__ __forceinline__ float c_atan(float x) {
  const float a = fabsf(x);
  const bool big = a > MPR_F(2.414213562373095);
  const bool mid = a > MPR_F(0.4142135623730951);
  const float safe_a = nmax(a, MPR_F(1e-30));
  const float z = big ? (-1.0f / safe_a) : (mid ? (a - 1.0f) / (a + 1.0f) : a);
  const float y = big ? MPR_F(1.5707963267948966)
                      : (mid ? MPR_F(0.7853981633974483) : 0.0f);
  const float z2 = z * z;
  const float p = ((MPR_F(8.05374449538e-2) * z2 - MPR_F(1.38776856032e-1)) * z2
                   + MPR_F(1.99777106478e-1)) * z2 - MPR_F(3.33329491539e-1);
  const float r = y + z + z * z2 * p;
  return xsign(x) * r;
}

__device__ __forceinline__ float c_asin(float x) {
  const float a = fabsf(x);
  const bool over = a > 0.5f;
  const float z_hi = 0.5f * (1.0f - a);
  const float v = over ? sqrtf(nmax(z_hi, 0.0f)) : a;
  const float z = over ? z_hi : a * a;
  const float p = ((((MPR_F(4.2163199048e-2) * z + MPR_F(2.4181311049e-2)) * z
                     + MPR_F(4.5470025998e-2)) * z + MPR_F(7.4953002686e-2)) * z
                   + MPR_F(1.6666752422e-1)) * z * v + v;
  float r = over ? MPR_F(1.5707963267948966) - 2.0f * p : p;
  r = xsign(x) * r;
  return a > 1.0f ? f_nan() : r;
}

__device__ __forceinline__ float c_acos(float x) {
  return MPR_F(1.5707963267948966) - c_asin(x);
}

// ---- float branch (kernels.py:575-609) --------------------------------------
template <int OP>
__device__ __forceinline__ float float_op(float a, float b, float imm) {
  switch (OP) {
    case OP_SQUARE: return a * a;
    case OP_SQRT: return sqrtf(a);
    case OP_NEG: return -a;
    case OP_SIN: return sinf(a);
    case OP_COS: return cosf(a);
    case OP_ASIN: return c_asin(a);
    case OP_ACOS: return c_acos(a);
    case OP_ATAN: return c_atan(a);
    case OP_EXP: return expf(a);
    case OP_ABS: return fabsf(a);
    case OP_LOG: return logf(a);
    case OP_ADD_IMM: return a + imm;
    case OP_ADD: return a + b;
    case OP_MUL_IMM: return a * imm;
    case OP_MUL: return a * b;
    case OP_MIN_IMM: return nmin(a, imm);
    case OP_MIN: return nmin(a, b);
    case OP_MAX_IMM: return nmax(a, imm);
    case OP_MAX: return nmax(a, b);
    case OP_SUB_IMM: return a - imm;
    case OP_SUB_IMM_RHS: return imm - b;
    case OP_SUB: return a - b;
    case OP_DIV_IMM: return a / imm;
    case OP_DIV_IMM_RHS: return imm / b;
    case OP_DIV: return a / b;
    case OP_COPY_IMM: return imm;
    case OP_COPY_LHS: return a;
    case OP_COPY_RHS: return b;
    case OP_HYPOT: return sqrtf(a * a + b * b);
    case OP_ADDSQ: return a * a + b;
    default: return a * 0.0f;  // INVALID, JUMP
  }
}

// ---- derivative branch (kernels3d.py:231-363) -------------------------------
// A dual number: value and d/dx, d/dy, d/dz (the reference's Deriv float4,
// reference/inc/gpu_deriv.hpp).  Every product and sum below is its own
// rounded operation (--fmad=false): a.v * b.dx + b.v * a.dx must not fuse.
struct __align__(16) Dv {
  float v, dx, dy, dz;
};

// A constant: zero derivatives, spelled dx * 0 as the JAX package spells
// them (so a NaN derivative of the operand stays NaN).
__device__ __forceinline__ Dv dv_const(float v, const Dv& like) {
  const float z = like.dx * 0.0f;
  return {v, z, z, z};
}
// Unary: value v, derivatives scaled by the coefficient c.
__device__ __forceinline__ Dv dv_lift(float v, float c, const Dv& a) {
  return {v, c * a.dx, c * a.dy, c * a.dz};
}

template <int OP>
__device__ __forceinline__ Dv deriv_op(const Dv& a, const Dv& b, float imm) {
  switch (OP) {
    case OP_SQUARE: return dv_lift(a.v * a.v, 2.0f * a.v, a);
    case OP_SQRT: return dv_lift(sqrtf(a.v), 0.5f / sqrtf(a.v), a);
    case OP_NEG: return {-a.v, -a.dx, -a.dy, -a.dz};
    case OP_SIN: return dv_lift(sinf(a.v), cosf(a.v), a);
    case OP_COS: return dv_lift(cosf(a.v), -sinf(a.v), a);
    case OP_ASIN:
      return dv_lift(c_asin(a.v), 1.0f / sqrtf(1.0f - a.v * a.v), a);
    case OP_ACOS:
      return dv_lift(c_acos(a.v), -1.0f / sqrtf(1.0f - a.v * a.v), a);
    case OP_ATAN: return dv_lift(c_atan(a.v), 1.0f / (1.0f + a.v * a.v), a);
    case OP_EXP: return dv_lift(expf(a.v), expf(a.v), a);
    case OP_ABS: return dv_lift(fabsf(a.v), a.v < 0.0f ? -1.0f : 1.0f, a);
    case OP_LOG: return dv_lift(logf(a.v), 1.0f / a.v, a);
    case OP_ADD_IMM: return {a.v + imm, a.dx, a.dy, a.dz};
    case OP_ADD: return {a.v + b.v, a.dx + b.dx, a.dy + b.dy, a.dz + b.dz};
    case OP_MUL_IMM: return {a.v * imm, a.dx * imm, a.dy * imm, a.dz * imm};
    case OP_MUL:
      return {a.v * b.v, a.v * b.dx + b.v * a.dx, a.v * b.dy + b.v * a.dy,
              a.v * b.dz + b.v * a.dz};
    // min/max pick the winning side's whole tuple; a NaN picks the rhs
    case OP_MIN_IMM: return a.v < imm ? a : dv_const(imm, a);
    case OP_MIN: return a.v < b.v ? a : b;
    case OP_MAX_IMM: return a.v > imm ? a : dv_const(imm, a);
    case OP_MAX: return a.v > b.v ? a : b;
    case OP_SUB_IMM: return {a.v - imm, a.dx, a.dy, a.dz};
    case OP_SUB_IMM_RHS: return {imm - b.v, -b.dx, -b.dy, -b.dz};
    case OP_SUB: return {a.v - b.v, a.dx - b.dx, a.dy - b.dy, a.dz - b.dz};
    case OP_DIV_IMM: {
      const float inv = 1.0f / imm;
      return {a.v * inv, a.dx * inv, a.dy * inv, a.dz * inv};
    }
    case OP_DIV_IMM_RHS: {
      const float v = imm / b.v;
      const float c = -v / b.v;
      return {v, c * b.dx, c * b.dy, c * b.dz};
    }
    case OP_DIV: {
      const float inv = 1.0f / b.v;
      const float v = a.v * inv;
      return {v, (a.dx - v * b.dx) * inv, (a.dy - v * b.dy) * inv,
              (a.dz - v * b.dz) * inv};
    }
    case OP_COPY_IMM: return dv_const(imm, a);
    case OP_COPY_LHS: return a;
    case OP_COPY_RHS: return b;
    case OP_HYPOT: {
      const float v = sqrtf(a.v * a.v + b.v * b.v);
      const float inv = 1.0f / v;
      return {v, (a.v * a.dx + b.v * b.dx) * inv,
              (a.v * a.dy + b.v * b.dy) * inv,
              (a.v * a.dz + b.v * b.dz) * inv};
    }
    case OP_ADDSQ: {
      const float c = 2.0f * a.v;
      return {a.v * a.v + b.v, c * a.dx + b.dx, c * a.dy + b.dy,
              c * a.dz + b.dz};
    }
    default: return dv_const(a.v * 0.0f, a);  // INVALID, JUMP
  }
}

// Projective mat4 transform with scalar matrix entries (kernels3d.py:51-60):
// four dot products left to right, then three divisions by w.
__device__ __forceinline__ void mat4_apply(const float* __restrict__ m,
                                           float wx, float wy, float wz,
                                           float& x, float& y, float& z) {
  const float w = m[12] * wx + m[13] * wy + m[14] * wz + m[15];
  x = (m[0] * wx + m[1] * wy + m[2] * wz + m[3]) / w;
  y = (m[4] * wx + m[5] * wy + m[6] * wz + m[7]) / w;
  z = (m[8] * wx + m[9] * wy + m[10] * wz + m[11]) / w;
}

// Voxel index along an axis -> render-space coordinate (kernels3d.py:147).
__device__ __forceinline__ float world_coord(float idx, float size) {
  return (idx + 0.5f) / size * 2.0f - 1.0f;
}

// ---- interval branch (kernels.py:83-317) ------------------------------------
struct Iv {
  float lo, hi;
};

__device__ __forceinline__ Iv iv_sq(float al, float ah) {
  const bool neg = ah < 0.0f, pos = al > 0.0f;
  const float ll = al * al, hh = ah * ah;
  const float lo = neg ? hh : (pos ? ll : 0.0f);
  float hi = fabsf(al) > fabsf(ah) ? ll : hh;
  hi = neg ? ll : (pos ? hh : hi);
  return {lo, hi};
}

__device__ __forceinline__ Iv iv_div(float al, float ah, float bl, float bh) {
  const bool spans = (bl <= 0.0f) && (bh >= 0.0f);
  const float sbl = spans ? -1.0f : bl;
  const float sbh = spans ? 1.0f : bh;
  const bool x_neg = ah < 0.0f;
  const bool x_mix = !x_neg && (al < 0.0f);
  const bool y_neg = bh < 0.0f;
  float lo, hi;
  if (x_neg && y_neg) {
    lo = ah / sbl; hi = al / sbh;
  } else if (x_neg) {
    lo = al / sbl; hi = ah / sbh;
  } else if (x_mix && y_neg) {
    lo = ah / sbh; hi = al / sbh;
  } else if (x_mix) {
    lo = al / sbl; hi = ah / sbl;
  } else {
    lo = y_neg ? ah / sbh : al / sbh;
    hi = y_neg ? al / sbl : ah / sbl;
  }
  if (spans) { lo = -f_inf(); hi = f_inf(); }
  return {lo, hi};
}

// Interval eval of one clause.  Writes the result interval to r and returns
// the choice (1 = LHS only, 2 = RHS only, 0 = both; 0 for non-choice ops).
__device__ __forceinline__ int interval_op(int op, float al, float ah,
                                           float bl, float bh, float imm,
                                           Iv& r) {
  int c = 0;
  switch (op) {
    case OP_SQUARE: r = iv_sq(al, ah); break;
    case OP_SQRT: {
      const bool bad = ah < 0.0f;
      const float lo = al <= 0.0f ? 0.0f : sqrtf(nmax(al, 0.0f));
      const float hi = sqrtf(nmax(ah, 0.0f));
      r = bad ? Iv{f_nan(), f_nan()} : Iv{lo, hi};
      break;
    }
    case OP_NEG: r = {-ah, -al}; break;
    case OP_SIN:
    case OP_COS: r = {-1.0f, 1.0f}; break;
    case OP_ASIN: {
      const bool bad = (ah < -1.0f) || (al > 1.0f);
      r = bad ? Iv{f_nan(), f_nan()} : Iv{c_asin(clip1(al)), c_asin(clip1(ah))};
      break;
    }
    case OP_ACOS: {
      const bool bad = (ah < -1.0f) || (al > 1.0f);
      r = bad ? Iv{f_nan(), f_nan()} : Iv{c_acos(clip1(ah)), c_acos(clip1(al))};
      break;
    }
    case OP_ATAN: r = {c_atan(al), c_atan(ah)}; break;
    case OP_EXP: r = {expf(al), expf(ah)}; break;
    case OP_ABS: {
      const bool neg = ah < 0.0f, pos = al >= 0.0f;
      const float lo = pos ? al : (neg ? -ah : 0.0f);
      const float hi = pos ? ah : (neg ? -al : nmax(-al, ah));
      r = {lo, hi};
      break;
    }
    case OP_LOG: {
      // reference quirk (gpu_interval.hpp:382-391): a strip holding 0 gives
      // [0, log(hi)], inverted when hi < 1
      const bool bad = ah < 0.0f;
      const float lo = al <= 0.0f ? 0.0f : logf(nmax(al, MPR_F(1e-38)));
      const float hi = ah <= 0.0f ? -f_inf() : logf(nmax(ah, MPR_F(1e-38)));
      r = bad ? Iv{f_nan(), f_nan()} : Iv{lo, hi};
      break;
    }
    case OP_ADD_IMM: r = {al + imm, ah + imm}; break;
    case OP_ADD: r = {al + bl, ah + bh}; break;
    case OP_MUL_IMM:
      r = imm < 0.0f ? Iv{ah * imm, al * imm} : Iv{al * imm, ah * imm};
      break;
    case OP_MUL: {
      const float p1 = al * bl, p2 = al * bh, p3 = ah * bl, p4 = ah * bh;
      const bool xn = al < 0.0f, xp = ah > 0.0f;
      const bool yn = bl < 0.0f, yp = bh > 0.0f;
      const bool x_m = xn && xp, x_n = xn && !xp, x_p = !xn && xp;
      const bool y_m = yn && yp, y_n = yn && !yp, y_p = !yn && yp;
      const float zero = al * 0.0f;
      float lo = zero, hi = zero;
      if (x_m && y_m) { lo = nmin(p2, p3); hi = nmax(p1, p4); }
      else if (x_m && y_n) { lo = p3; hi = p1; }
      else if (x_m && y_p) { lo = p2; hi = p4; }
      else if (x_n && y_m) { lo = p2; hi = p1; }
      else if (x_n && y_n) { lo = p4; hi = p1; }
      else if (x_n && y_p) { lo = p2; hi = p3; }
      else if (x_p && y_m) { lo = p3; hi = p4; }
      else if (x_p && y_n) { lo = p3; hi = p2; }
      else if (x_p && y_p) { lo = p1; hi = p4; }
      r = {lo, hi};
      break;
    }
    case OP_MIN_IMM: {
      const bool c1 = ah < imm, c2 = imm < al;
      c = c1 ? 1 : (c2 ? 2 : 0);
      r = c1 ? Iv{al, ah} : (c2 ? Iv{imm, imm} : Iv{nmin(al, imm), nmin(ah, imm)});
      break;
    }
    case OP_MIN: {
      const bool c1 = ah < bl, c2 = bh < al;
      c = c1 ? 1 : (c2 ? 2 : 0);
      r = c1 ? Iv{al, ah} : (c2 ? Iv{bl, bh} : Iv{nmin(al, bl), nmin(ah, bh)});
      break;
    }
    case OP_MAX_IMM: {
      const bool c1 = al > imm, c2 = imm > ah;
      c = c1 ? 1 : (c2 ? 2 : 0);
      r = c1 ? Iv{al, ah} : (c2 ? Iv{imm, imm} : Iv{nmax(al, imm), nmax(ah, imm)});
      break;
    }
    case OP_MAX: {
      const bool c1 = al > bh, c2 = bl > ah;
      c = c1 ? 1 : (c2 ? 2 : 0);
      r = c1 ? Iv{al, ah} : (c2 ? Iv{bl, bh} : Iv{nmax(al, bl), nmax(ah, bh)});
      break;
    }
    case OP_SUB_IMM: r = {al - imm, ah - imm}; break;
    case OP_SUB_IMM_RHS: r = {imm - bh, imm - bl}; break;
    case OP_SUB: r = {al - bh, ah - bl}; break;
    case OP_DIV_IMM: r = iv_div(al, ah, imm, imm); break;
    case OP_DIV_IMM_RHS: r = iv_div(imm, imm, bl, bh); break;
    case OP_DIV: r = iv_div(al, ah, bl, bh); break;
    case OP_COPY_IMM: r = {imm, imm}; break;
    case OP_COPY_LHS: r = {al, ah}; break;
    case OP_COPY_RHS: r = {bl, bh}; break;
    case OP_HYPOT: {
      const Iv sa = iv_sq(al, ah), sb = iv_sq(bl, bh);
      const float tl = sa.lo + sb.lo, th = sa.hi + sb.hi;
      r = {sqrtf(nmax(tl, 0.0f)), sqrtf(th)};
      break;
    }
    case OP_ADDSQ: {
      const Iv sa = iv_sq(al, ah);
      r = {sa.lo + bl, sa.hi + bh};
      break;
    }
    default: r = {al * 0.0f, al * 0.0f}; break;  // INVALID, JUMP
  }
  return c;
}

// >= 1-ulp outward widening (ops/interval_math.py::widen); +-inf and NaN
// pass through.
__device__ __forceinline__ Iv widen(Iv r) {
  const float eps = 1.1920928955078125e-07f;   // 2**-23
  const float tiny = 1.1754943508222875e-38f;  // 2**-126
  const float big = 3.4028234663852886e+38f;   // largest finite float
  const float lo = fabsf(r.lo) <= big ? r.lo - (eps * fabsf(r.lo) + tiny) : r.lo;
  const float hi = fabsf(r.hi) <= big ? r.hi + (eps * fabsf(r.hi) + tiny) : r.hi;
  return {lo, hi};
}

}  // namespace mpr
