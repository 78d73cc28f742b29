"""Pure-NumPy reference interpreters — the test oracle.

The reference established correctness by cross-rendering against libfive's
CPU evaluator (``benchmark/render_2d.cpp:71-74``); this module plays that
role here (a copy of ``mpr_tpu.oracle``, numpy only, so the port has an
oracle of its own).  It interprets a :class:`~mpr_tpu_torch.tape.tape.Tape`
in three modes, matching the device semantics of the reference headers:

  * float     — ``eval_voxels_f``-style concrete evaluation
                (reference/src/context.cu:866-927)
  * interval  — ``mpr::Interval`` semantics incl. the choice codes
                (reference/inc/gpu_interval.hpp), minus CUDA's directed
                rounding (round-to-nearest endpoints; SURVEY.md section 7
                documents this divergence)
  * deriv     — ``mpr::Deriv`` forward-mode AD 4-tuples
                (reference/inc/gpu_deriv.hpp)

plus a reference implementation of tape shortening that mirrors the backward
mark-and-sweep of ``eval_tiles_i`` (reference/src/context.cu:319-459).

Quirks intentionally preserved (bit-compatibility with the reference):
  * interval sin/cos always return [-1, 1] (dead code after
    reference/inc/gpu_interval.hpp:353);
  * interval log on a strip containing 0 returns [0, log(hi)] — NOT
    conservative, but what the reference ships
    (reference/inc/gpu_interval.hpp:382-391);
  * Deriv min breaks ties toward RHS, max toward LHS
    (reference/inc/gpu_deriv.hpp:106-130).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .tape.tape import Tape
from .tape.opcodes import Op

_INF = np.float32(np.inf)
_NAN = np.float32(np.nan)


# ---------------------------------------------------------------------------
# Interval primitives: shared with the plain PyTorch kernels via ops/interval_math.py
# (single source of truth for the gpu_interval.hpp semantics); bound to
# NumPy here.
# ---------------------------------------------------------------------------

from functools import partial as _partial

from . import config as _config
from .ops import interval_math as _im

i_add = _partial(_im.i_add, np)
i_sub = _partial(_im.i_sub, np)
i_neg = _partial(_im.i_neg, np)
i_mul = _partial(_im.i_mul, np)
i_div = _partial(_im.i_div, np)
i_min = _partial(_im.i_min, np)
i_max = _partial(_im.i_max, np)
i_square = _partial(_im.i_square, np)
i_abs = _partial(_im.i_abs, np)
i_sqrt = _partial(_im.i_sqrt, np)
i_log = _partial(_im.i_log, np)
i_exp = _partial(_im.i_exp, np)
i_sin = _partial(_im.i_sin, np)
i_cos = _partial(_im.i_cos, np)
i_asin = _partial(_im.i_asin, np)
i_acos = _partial(_im.i_acos, np)
i_atan = _partial(_im.i_atan, np)


# ---------------------------------------------------------------------------
# Tape interpreters
# ---------------------------------------------------------------------------

def eval_f(tape: Tape, x, y, z=None) -> np.ndarray:
    """Concrete float evaluation, vectorized over the input arrays."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    z = np.zeros_like(x) if z is None else np.asarray(z, dtype=np.float32)
    slots = np.zeros((tape.num_slots,) + x.shape, dtype=np.float32)
    sx, sy, sz = tape.axis_slots
    if sx:
        slots[sx] = x
    if sy:
        slots[sy] = y
    if sz:
        slots[sz] = z

    with np.errstate(all="ignore"):
        for t in range(tape.length):
            op = int(tape.ops[t])
            o, l, r = int(tape.outs[t]), int(tape.lhss[t]), int(tape.rhss[t])
            imm = np.float32(tape.imms[t])
            a = slots[l]
            b = slots[r]
            if op == Op.SQUARE_LHS:
                slots[o] = a * a
            elif op == Op.SQRT_LHS:
                slots[o] = np.sqrt(a)
            elif op == Op.NEG_LHS:
                slots[o] = -a
            elif op == Op.SIN_LHS:
                slots[o] = np.sin(a)
            elif op == Op.COS_LHS:
                slots[o] = np.cos(a)
            elif op == Op.ASIN_LHS:
                slots[o] = np.arcsin(a)
            elif op == Op.ACOS_LHS:
                slots[o] = np.arccos(a)
            elif op == Op.ATAN_LHS:
                slots[o] = np.arctan(a)
            elif op == Op.EXP_LHS:
                slots[o] = np.exp(a)
            elif op == Op.ABS_LHS:
                slots[o] = np.abs(a)
            elif op == Op.LOG_LHS:
                slots[o] = np.log(a)
            elif op == Op.ADD_LHS_IMM:
                slots[o] = a + imm
            elif op == Op.ADD_LHS_RHS:
                slots[o] = a + b
            elif op == Op.MUL_LHS_IMM:
                slots[o] = a * imm
            elif op == Op.MUL_LHS_RHS:
                slots[o] = a * b
            elif op == Op.MIN_LHS_IMM:
                slots[o] = np.minimum(a, imm)
            elif op == Op.MIN_LHS_RHS:
                slots[o] = np.minimum(a, b)
            elif op == Op.MAX_LHS_IMM:
                slots[o] = np.maximum(a, imm)
            elif op == Op.MAX_LHS_RHS:
                slots[o] = np.maximum(a, b)
            elif op == Op.SUB_LHS_IMM:
                slots[o] = a - imm
            elif op == Op.SUB_IMM_RHS:
                slots[o] = imm - b
            elif op == Op.SUB_LHS_RHS:
                slots[o] = a - b
            elif op == Op.DIV_LHS_IMM:
                slots[o] = a / imm
            elif op == Op.DIV_IMM_RHS:
                slots[o] = imm / b
            elif op == Op.DIV_LHS_RHS:
                slots[o] = a / b
            elif op == Op.COPY_IMM:
                slots[o] = np.full_like(a, imm)
            elif op == Op.COPY_LHS:
                slots[o] = a
            elif op == Op.COPY_RHS:
                slots[o] = b
            elif op == Op.HYPOT_LHS_RHS:
                slots[o] = np.sqrt(a * a + b * b)
            elif op == Op.ADDSQ_LHS_RHS:
                slots[o] = a * a + b
            elif op == Op.INVALID:
                break  # NOP padding / terminator
            else:
                raise ValueError(f"bad opcode {op}")
    return slots[tape.result_slot]


def eval_i(tape: Tape, xl, xh, yl, yh, zl=None, zh=None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interval evaluation.

    Returns ``(lo, hi, choices)`` where ``choices`` has shape
    ``(num_choices,) + xl.shape`` with codes 0/1/2 in min/max execution
    order, exactly like the 2-bit stream of
    reference/src/context.cu:254-263.
    """
    xl = np.asarray(xl, dtype=np.float32)
    xh = np.asarray(xh, dtype=np.float32)
    yl = np.asarray(yl, dtype=np.float32)
    yh = np.asarray(yh, dtype=np.float32)
    if zl is None:
        zl = np.zeros_like(xl)
        zh = np.zeros_like(xl)
    zl = np.asarray(zl, dtype=np.float32)
    zh = np.asarray(zh, dtype=np.float32)

    lo = np.zeros((tape.num_slots,) + xl.shape, dtype=np.float32)
    hi = np.zeros_like(lo)
    sx, sy, sz = tape.axis_slots
    if sx:
        lo[sx], hi[sx] = xl, xh
    if sy:
        lo[sy], hi[sy] = yl, yh
    if sz:
        lo[sz], hi[sz] = zl, zh

    choices = np.zeros((tape.num_choices,) + xl.shape, dtype=np.int32)
    ci = 0
    # config.widen_intervals: conservative outward widening per op (the
    # directed-rounding substitute, interval_math.widen)
    widen = _config.get().widen_intervals

    with np.errstate(all="ignore"):
        for t in range(tape.length):
            op = int(tape.ops[t])
            o, l, r = int(tape.outs[t]), int(tape.lhss[t]), int(tape.rhss[t])
            imm = np.float32(tape.imms[t])
            al, ah = lo[l], hi[l]
            bl, bh = lo[r], hi[r]
            iml = np.full_like(al, imm)
            if op == Op.SQUARE_LHS:
                lo[o], hi[o] = i_square(al, ah)
            elif op == Op.SIN_LHS and _config.get().tight_sincos:
                lo[o], hi[o] = _im.i_sin_tight(np, al, ah)
            elif op == Op.COS_LHS and _config.get().tight_sincos:
                lo[o], hi[o] = _im.i_cos_tight(np, al, ah)
            elif op == Op.SQRT_LHS:
                lo[o], hi[o] = i_sqrt(al, ah)
            elif op == Op.NEG_LHS:
                lo[o], hi[o] = i_neg(al, ah)
            elif op == Op.SIN_LHS:
                lo[o], hi[o] = i_sin(al, ah)
            elif op == Op.COS_LHS:
                lo[o], hi[o] = i_cos(al, ah)
            elif op == Op.ASIN_LHS:
                lo[o], hi[o] = i_asin(al, ah)
            elif op == Op.ACOS_LHS:
                lo[o], hi[o] = i_acos(al, ah)
            elif op == Op.ATAN_LHS:
                lo[o], hi[o] = i_atan(al, ah)
            elif op == Op.EXP_LHS:
                lo[o], hi[o] = i_exp(al, ah)
            elif op == Op.ABS_LHS:
                lo[o], hi[o] = i_abs(al, ah)
            elif op == Op.LOG_LHS:
                lo[o], hi[o] = i_log(al, ah)
            elif op == Op.ADD_LHS_IMM:
                lo[o], hi[o] = i_add(al, ah, iml, iml)
            elif op == Op.ADD_LHS_RHS:
                lo[o], hi[o] = i_add(al, ah, bl, bh)
            elif op == Op.MUL_LHS_IMM:
                lo[o], hi[o] = i_mul(al, ah, iml, iml)
            elif op == Op.MUL_LHS_RHS:
                lo[o], hi[o] = i_mul(al, ah, bl, bh)
            elif op == Op.MIN_LHS_IMM:
                lo[o], hi[o], choices[ci] = i_min(al, ah, iml, iml)
                ci += 1
            elif op == Op.MIN_LHS_RHS:
                lo[o], hi[o], choices[ci] = i_min(al, ah, bl, bh)
                ci += 1
            elif op == Op.MAX_LHS_IMM:
                lo[o], hi[o], choices[ci] = i_max(al, ah, iml, iml)
                ci += 1
            elif op == Op.MAX_LHS_RHS:
                lo[o], hi[o], choices[ci] = i_max(al, ah, bl, bh)
                ci += 1
            elif op == Op.SUB_LHS_IMM:
                lo[o], hi[o] = i_sub(al, ah, iml, iml)
            elif op == Op.SUB_IMM_RHS:
                lo[o], hi[o] = i_sub(iml, iml, bl, bh)
            elif op == Op.SUB_LHS_RHS:
                lo[o], hi[o] = i_sub(al, ah, bl, bh)
            elif op == Op.DIV_LHS_IMM:
                lo[o], hi[o] = i_div(al, ah, iml, iml)
            elif op == Op.DIV_IMM_RHS:
                lo[o], hi[o] = i_div(iml, iml, bl, bh)
            elif op == Op.DIV_LHS_RHS:
                lo[o], hi[o] = i_div(al, ah, bl, bh)
            elif op == Op.COPY_IMM:
                lo[o], hi[o] = iml.copy(), iml.copy()
            elif op == Op.COPY_LHS:
                lo[o], hi[o] = al.copy(), ah.copy()
            elif op == Op.COPY_RHS:
                lo[o], hi[o] = bl.copy(), bh.copy()
            elif op == Op.HYPOT_LHS_RHS:
                sal, sah = i_square(al, ah)
                sbl, sbh = i_square(bl, bh)
                tl_, th_ = i_add(sal, sah, sbl, sbh)
                lo[o], hi[o] = i_sqrt(tl_, th_)
            elif op == Op.ADDSQ_LHS_RHS:
                sal, sah = i_square(al, ah)
                lo[o], hi[o] = i_add(sal, sah, bl, bh)
            elif op == Op.INVALID:
                break
            else:
                raise ValueError(f"bad opcode {op}")
            if widen:
                lo[o], hi[o] = _im.widen(np, lo[o], hi[o])
    return lo[tape.result_slot], hi[tape.result_slot], choices


def eval_d(tape: Tape, x, y, z=None) -> Tuple[np.ndarray, ...]:
    """Forward-mode AD: returns (value, dx, dy, dz)
    (gpu_deriv.hpp semantics; min ties -> RHS, max ties -> LHS)."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    z = np.zeros_like(x) if z is None else np.asarray(z, dtype=np.float32)
    S = tape.num_slots
    v = np.zeros((S,) + x.shape, dtype=np.float32)
    dx = np.zeros_like(v)
    dy = np.zeros_like(v)
    dz = np.zeros_like(v)
    sx, sy, sz_ = tape.axis_slots
    if sx:
        v[sx] = x
        dx[sx] = 1.0
    if sy:
        v[sy] = y
        dy[sy] = 1.0
    if sz_:
        v[sz_] = z
        dz[sz_] = 1.0

    def pick(cond, a, b):
        return np.where(cond, a, b)

    with np.errstate(all="ignore"):
        for t in range(tape.length):
            op = int(tape.ops[t])
            o, l, r = int(tape.outs[t]), int(tape.lhss[t]), int(tape.rhss[t])
            imm = np.float32(tape.imms[t])
            # Copy: clauses may write in-place (out == lhs/rhs thanks to the
            # compiler's slot reuse), and the multi-statement updates below
            # must all see the ORIGINAL operand values.
            av, ax, ay, az = (v[l].copy(), dx[l].copy(),
                              dy[l].copy(), dz[l].copy())
            bv, bx, by, bz = (v[r].copy(), dx[r].copy(),
                              dy[r].copy(), dz[r].copy())
            if op == Op.INVALID:
                break
            if op == Op.SQUARE_LHS:
                v[o] = av * av
                g = 2.0 * av
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.SQRT_LHS:
                s = np.sqrt(av)
                v[o] = s
                g = 0.5 / s
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.NEG_LHS:
                v[o], dx[o], dy[o], dz[o] = -av, -ax, -ay, -az
            elif op == Op.SIN_LHS:
                v[o] = np.sin(av)
                g = np.cos(av)
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.COS_LHS:
                v[o] = np.cos(av)
                g = -np.sin(av)
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.ASIN_LHS:
                v[o] = np.arcsin(av)
                g = 1.0 / np.sqrt(1.0 - av * av)
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.ACOS_LHS:
                v[o] = np.arccos(av)
                g = -1.0 / np.sqrt(1.0 - av * av)
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.ATAN_LHS:
                v[o] = np.arctan(av)
                g = 1.0 / (1.0 + av * av)
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.EXP_LHS:
                e = np.exp(av)
                v[o] = e
                dx[o], dy[o], dz[o] = e * ax, e * ay, e * az
            elif op == Op.ABS_LHS:
                v[o] = np.abs(av)
                s = np.where(av < 0.0, -1.0, 1.0).astype(np.float32)
                dx[o], dy[o], dz[o] = s * ax, s * ay, s * az
            elif op == Op.LOG_LHS:
                v[o] = np.log(av)
                g = 1.0 / av
                dx[o], dy[o], dz[o] = g * ax, g * ay, g * az
            elif op == Op.ADD_LHS_IMM:
                v[o], dx[o], dy[o], dz[o] = av + imm, ax, ay, az
            elif op == Op.ADD_LHS_RHS:
                v[o] = av + bv
                dx[o], dy[o], dz[o] = ax + bx, ay + by, az + bz
            elif op == Op.MUL_LHS_IMM:
                v[o], dx[o], dy[o], dz[o] = av * imm, ax * imm, ay * imm, az * imm
            elif op == Op.MUL_LHS_RHS:
                v[o] = av * bv
                dx[o] = ax * bv + bx * av
                dy[o] = ay * bv + by * av
                dz[o] = az * bv + bz * av
            elif op in (Op.MIN_LHS_IMM, Op.MIN_LHS_RHS,
                        Op.MAX_LHS_IMM, Op.MAX_LHS_RHS):
                if op == Op.MIN_LHS_IMM:
                    cond = av < imm
                    ov, ox, oy, oz = imm, 0.0, 0.0, 0.0
                elif op == Op.MIN_LHS_RHS:
                    cond = av < bv
                    ov, ox, oy, oz = bv, bx, by, bz
                elif op == Op.MAX_LHS_IMM:
                    cond = av >= imm
                    ov, ox, oy, oz = imm, 0.0, 0.0, 0.0
                else:
                    cond = av >= bv
                    ov, ox, oy, oz = bv, bx, by, bz
                v[o] = pick(cond, av, ov)
                dx[o] = pick(cond, ax, ox)
                dy[o] = pick(cond, ay, oy)
                dz[o] = pick(cond, az, oz)
            elif op == Op.SUB_LHS_IMM:
                v[o], dx[o], dy[o], dz[o] = av - imm, ax, ay, az
            elif op == Op.SUB_IMM_RHS:
                v[o], dx[o], dy[o], dz[o] = imm - bv, -bx, -by, -bz
            elif op == Op.SUB_LHS_RHS:
                v[o] = av - bv
                dx[o], dy[o], dz[o] = ax - bx, ay - by, az - bz
            elif op == Op.DIV_LHS_IMM:
                v[o] = av / imm
                dx[o], dy[o], dz[o] = ax / imm, ay / imm, az / imm
            elif op == Op.DIV_IMM_RHS:
                d = bv * bv
                v[o] = imm / bv
                dx[o], dy[o], dz[o] = (-imm * bx / d, -imm * by / d,
                                       -imm * bz / d)
            elif op == Op.DIV_LHS_RHS:
                d = bv * bv
                v[o] = av / bv
                dx[o] = (ax * bv - av * bx) / d
                dy[o] = (ay * bv - av * by) / d
                dz[o] = (az * bv - av * bz) / d
            elif op == Op.COPY_IMM:
                v[o] = imm
                dx[o], dy[o], dz[o] = 0.0, 0.0, 0.0
            elif op == Op.COPY_LHS:
                v[o], dx[o], dy[o], dz[o] = av, ax, ay, az
            elif op == Op.COPY_RHS:
                v[o], dx[o], dy[o], dz[o] = bv, bx, by, bz
            elif op == Op.HYPOT_LHS_RHS:
                v[o] = np.sqrt(av * av + bv * bv)
                inv = 1.0 / v[o]
                dx[o] = (av * ax + bv * bx) * inv
                dy[o] = (av * ay + bv * by) * inv
                dz[o] = (av * az + bv * bz) * inv
            elif op == Op.ADDSQ_LHS_RHS:
                v[o] = av * av + bv
                dx[o], dy[o], dz[o] = (2 * av * ax + bx, 2 * av * ay + by,
                                       2 * av * az + bz)
            else:
                raise ValueError(f"bad opcode {op}")
    rs = tape.result_slot
    return v[rs], dx[rs], dy[rs], dz[rs]


# ---------------------------------------------------------------------------
# Reference tape shortening (single tile)
# ---------------------------------------------------------------------------

def shorten(tape: Tape, choices: np.ndarray) -> Tape:
    """Backward mark-and-sweep tape push for ONE tile.

    ``choices`` is the (num_choices,) int vector from :func:`eval_i` for the
    tile.  Mirrors reference/src/context.cu:319-459: min/max clauses
    with a one-sided choice are rewritten to COPY_LHS / COPY_RHS / COPY_IMM,
    or elided entirely when the copy would be in-place; dead clauses are
    dropped.  Slots are NOT renumbered (same as the reference).
    """
    from .tape.tape import Tape as TapeCls

    kept: list = []   # (op, out, lhs, rhs, imm) in reverse order
    active = np.zeros(tape.num_slots, dtype=bool)
    active[tape.result_slot] = True
    ci = tape.num_choices

    for t in range(tape.length - 1, -1, -1):
        op = int(tape.ops[t])
        has_choice = Op.MIN_LHS_IMM <= op <= Op.MAX_LHS_RHS
        if has_choice:
            ci -= 1
        o, l, r = int(tape.outs[t]), int(tape.lhss[t]), int(tape.rhss[t])
        imm = float(tape.imms[t])
        if not active[o]:
            continue
        choice = int(choices[ci]) if has_choice else 0
        active[o] = False
        new_op = op
        if choice == 0:
            if l:
                active[l] = True
            if r:
                active[r] = True
        elif choice == 1:
            active[l] = True
            if l == o:
                continue  # elide in-place copy
            new_op = int(Op.COPY_LHS)
        elif choice == 2:
            if r:
                active[r] = True
                if r == o:
                    continue
                new_op = int(Op.COPY_RHS)
            else:
                new_op = int(Op.COPY_IMM)
        kept.append((new_op, o, l, r, imm))

    kept.reverse()
    n_ch = sum(1 for k in kept
               if Op.MIN_LHS_IMM <= k[0] <= Op.MAX_LHS_RHS)
    return TapeCls(
        ops=np.asarray([k[0] for k in kept], dtype=np.int32),
        outs=np.asarray([k[1] for k in kept], dtype=np.int32),
        lhss=np.asarray([k[2] for k in kept], dtype=np.int32),
        rhss=np.asarray([k[3] for k in kept], dtype=np.int32),
        imms=np.asarray([k[4] for k in kept], dtype=np.float32),
        axis_slots=tape.axis_slots,
        result_slot=tape.result_slot,
        num_slots=tape.num_slots,
        num_choices=n_ch,
        tree=None,
    )
