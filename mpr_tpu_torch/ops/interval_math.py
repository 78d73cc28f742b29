"""Interval arithmetic, parameterized over the array namespace (numpy/torch).

A copy of ``mpr_tpu.ops.interval_math``: the ``mpr::Interval`` semantics
(reference/inc/gpu_interval.hpp) as used by the port's plain PyTorch
kernels and its tile boxes.  Every function takes the array module ``xp``
(``numpy`` or ``torch``) as its first argument; all are branch-free
(where/select) so they vectorize.  ``select`` below stands in for
``np.select`` (first true condition wins), which torch lacks.

The reference's directed rounding intrinsics are not used; intervals here
are correctly-rounded-to-nearest, which can under-report by ~1 ulp per op.
This cannot flip a fill decision in practice because fill requires a strict
sign (lower>0 / upper<0) with magnitudes far above accumulated ulp noise for
the paper models; documented as a divergence in SURVEY.md section 7.
``config.widen_intervals`` opts into :func:`widen` (>= 1 ulp outward per
op), restoring the reference's soundness guarantee at a small box-tightness
cost.
"""

from __future__ import annotations


# widen(): >= 1-ulp outward padding per op, the conservative substitute
# for CUDA's directed-rounding intrinsics (gpu_interval.hpp:18-43) —
# enabled by ``config.widen_intervals``.  eps*|x| spans [1, 2) ulp for
# normal x; the 2^-126 term covers subnormals/zero.  Pure arithmetic
# (no nextafter) so the identical formula runs on numpy, torch and in
# the CUDA kernels (ops/csrc/clause.cuh).  Non-finite endpoints pass through: +/-inf stay exact bounds,
# NaN stays NaN (the domain-error signal i_sqrt/i_log rely on).
_WIDEN_EPS = 2.0 ** -23
_WIDEN_TINY = 2.0 ** -126


def widen(xp, lo, hi):
    pad_lo = _WIDEN_EPS * xp.abs(lo) + _WIDEN_TINY
    pad_hi = _WIDEN_EPS * xp.abs(hi) + _WIDEN_TINY
    lo2 = xp.where(xp.isfinite(lo), lo - pad_lo, lo)
    hi2 = xp.where(xp.isfinite(hi), hi + pad_hi, hi)
    return lo2, hi2


def select(xp, conds, vals, default):
    """``np.select`` for any ``xp``: the value of the first true condition,
    else ``default``."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = xp.where(c, v, out)
    return out


def i_add(xp, al, ah, bl, bh):
    return al + bl, ah + bh


def i_sub(xp, al, ah, bl, bh):
    return al - bh, ah - bl


def i_neg(xp, al, ah):
    return -ah, -al


def i_mul(xp, al, ah, bl, bh):
    """Sign-case interval multiply (gpu_interval.hpp:85-146).

    Case analysis (not min/max over four products): the reference returns
    exactly {0,0} when an operand is [0,0] even against an infinite
    interval, where 0*inf would poison min/max with NaN.
    """
    p1 = al * bl
    p2 = al * bh
    p3 = ah * bl
    p4 = ah * bh
    xn, xpos = al < 0.0, ah > 0.0
    yn, ypos = bl < 0.0, bh > 0.0
    x_m, x_n, x_p = xn & xpos, xn & ~xpos, ~xn & xpos
    y_m, y_n, y_p = yn & ypos, yn & ~ypos, ~yn & ypos
    zero = xp.zeros_like(al)
    lo = select(xp,
        [x_m & y_m, x_m & y_n, x_m & y_p,
         x_n & y_m, x_n & y_n, x_n & y_p,
         x_p & y_m, x_p & y_n, x_p & y_p],
        [xp.minimum(p2, p3), p3, p2,
         p2, p4, p2,
         p3, p3, p1],
        zero)
    hi = select(xp,
        [x_m & y_m, x_m & y_n, x_m & y_p,
         x_n & y_m, x_n & y_n, x_n & y_p,
         x_p & y_m, x_p & y_n, x_p & y_p],
        [xp.maximum(p1, p4), p1, p4,
         p1, p1, p3,
         p4, p2, p4],
        zero)
    return lo, hi


def i_div(xp, al, ah, bl, bh):
    """Interval divide; divisor spanning 0 -> (-inf, inf)
    (gpu_interval.hpp:162-204)."""
    spans = (bl <= 0.0) & (bh >= 0.0)
    # Guard the divisor away from 0 on the 'spans' lanes so no lane computes
    # x/0; those lanes are overwritten with +/-inf below.
    safe_bl = xp.where(spans, -1.0, bl)
    safe_bh = xp.where(spans, 1.0, bh)
    x_neg = ah < 0.0
    x_mix = ~x_neg & (al < 0.0)
    y_neg = bh < 0.0
    lo = select(xp,
        [x_neg & y_neg, x_neg & ~y_neg,
         x_mix & y_neg, x_mix & ~y_neg],
        [ah / safe_bl, al / safe_bl,
         ah / safe_bh, al / safe_bl],
        xp.where(y_neg, ah / safe_bh, al / safe_bh))
    hi = select(xp,
        [x_neg & y_neg, x_neg & ~y_neg,
         x_mix & y_neg, x_mix & ~y_neg],
        [al / safe_bh, ah / safe_bh,
         al / safe_bh, ah / safe_bl],
        xp.where(y_neg, al / safe_bl, ah / safe_bl))
    lo = xp.where(spans, -xp.inf, lo)
    hi = xp.where(spans, xp.inf, hi)
    return lo, hi


def i_min(xp, al, ah, bl, bh):
    """Returns (lo, hi, choice): 1 = LHS only, 2 = RHS only, 0 = both
    (gpu_interval.hpp:208-228)."""
    c1 = ah < bl
    c2 = bh < al
    choice = xp.where(c1, 1, xp.where(c2, 2, 0))
    lo = xp.where(c1, al, xp.where(c2, bl, xp.minimum(al, bl)))
    hi = xp.where(c1, ah, xp.where(c2, bh, xp.minimum(ah, bh)))
    return lo, hi, choice


def i_max(xp, al, ah, bl, bh):
    """Returns (lo, hi, choice) (gpu_interval.hpp:232-252)."""
    c1 = al > bh
    c2 = bl > ah
    choice = xp.where(c1, 1, xp.where(c2, 2, 0))
    lo = xp.where(c1, al, xp.where(c2, bl, xp.maximum(al, bl)))
    hi = xp.where(c1, ah, xp.where(c2, bh, xp.maximum(ah, bh)))
    return lo, hi, choice


def i_square(xp, al, ah):
    """Sign-aware square (gpu_interval.hpp:256-266)."""
    neg = ah < 0.0
    pos = al > 0.0
    lo = xp.where(neg, ah * ah, xp.where(pos, al * al, 0.0))
    hi = xp.where(xp.abs(al) > xp.abs(ah), al * al, ah * ah)
    hi = xp.where(neg, al * al, xp.where(pos, ah * ah, hi))
    return lo, hi


def i_abs(xp, al, ah):
    neg = ah < 0.0
    pos = al >= 0.0
    lo = xp.where(pos, al, xp.where(neg, -ah, 0.0))
    hi = xp.where(pos, ah, xp.where(neg, -al, xp.maximum(-al, ah)))
    return lo, hi


def i_sqrt(xp, al, ah):
    """NaN below domain; clamped at 0 (gpu_interval.hpp:296-304)."""
    bad = ah < 0.0
    lo = xp.where(al <= 0.0, 0.0, xp.sqrt(xp.maximum(al, 0.0)))
    hi = xp.sqrt(xp.maximum(ah, 0.0))
    nan = xp.full_like(al, xp.nan)
    return xp.where(bad, nan, lo), xp.where(bad, nan, hi)


def i_log(xp, al, ah):
    """Reference quirk preserved: a strip containing 0 yields [0, log(hi)],
    which is INVERTED when hi < 1 (gpu_interval.hpp:382-391)."""
    bad = ah < 0.0
    lo = xp.where(al <= 0.0, 0.0, xp.log(xp.maximum(al, 1e-38)))
    hi = xp.log(xp.maximum(ah, 1e-38))
    hi = xp.where(ah <= 0.0, -xp.inf, hi)
    nan = xp.full_like(al, xp.nan)
    return xp.where(bad, nan, lo), xp.where(bad, nan, hi)


def i_exp(xp, al, ah):
    return xp.exp(al), xp.exp(ah)


def i_sin(xp, al, ah):
    # Reference quirk: always [-1, 1] (gpu_interval.hpp:346-380 early return)
    return xp.full_like(al, -1.0), xp.full_like(ah, 1.0)


def i_cos(xp, al, ah):
    return i_sin(xp, al, ah)


def i_asin(xp, al, ah):
    bad = (ah < -1.0) | (al > 1.0)
    lo = xp.arcsin(xp.clip(al, -1.0, 1.0))
    hi = xp.arcsin(xp.clip(ah, -1.0, 1.0))
    nan = xp.full_like(al, xp.nan)
    return xp.where(bad, nan, lo), xp.where(bad, nan, hi)


def i_acos(xp, al, ah):
    bad = (ah < -1.0) | (al > 1.0)
    lo = xp.arccos(xp.clip(ah, -1.0, 1.0))
    hi = xp.arccos(xp.clip(al, -1.0, 1.0))
    nan = xp.full_like(al, xp.nan)
    return xp.where(bad, nan, lo), xp.where(bad, nan, hi)


def i_atan(xp, al, ah):
    return xp.arctan(al), xp.arctan(ah)


def i_sin_tight(xp, al, ah):
    """Tight interval sine (NOT the reference quirk; ``mpr_tpu``'s oracle
    and unrolled engine use it under its ``config.tight_sincos``).

    Endpoint values, widened to -1/+1 when the interval contains a
    maximum (pi/2 + 2*pi*k) / minimum (-pi/2 + 2*pi*k).  Rounded-to-
    nearest like everything else here (SURVEY.md section 7 divergence)."""
    import math
    hpi, tau = math.pi / 2.0, 2.0 * math.pi
    has_max = xp.floor((ah - hpi) / tau) >= xp.ceil((al - hpi) / tau)
    has_min = xp.floor((ah + hpi) / tau) >= xp.ceil((al + hpi) / tau)
    sa, sb = xp.sin(al), xp.sin(ah)
    lo = xp.where(has_min, -1.0, xp.minimum(sa, sb))
    hi = xp.where(has_max, 1.0, xp.maximum(sa, sb))
    return lo, hi


def i_cos_tight(xp, al, ah):
    """Tight interval cosine: max at 2*pi*k, min at pi + 2*pi*k."""
    import math
    pi, tau = math.pi, 2.0 * math.pi
    has_max = xp.floor(ah / tau) >= xp.ceil(al / tau)
    has_min = xp.floor((ah - pi) / tau) >= xp.ceil((al - pi) / tau)
    ca, cb = xp.cos(al), xp.cos(ah)
    lo = xp.where(has_min, -1.0, xp.minimum(ca, cb))
    hi = xp.where(has_max, 1.0, xp.maximum(ca, cb))
    return lo, hi
