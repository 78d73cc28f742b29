"""Per-tape unrolled evaluators: the tape generated as straight-line code.

Counterpart of ``mpr_tpu.ops.unrolled_eval``, with its three builders and
their contracts:

  * :func:`build_float`    -> ``f(x, y, z=None, imms=None) -> v``;
  * :func:`build_interval` -> ``fi(xl, xh, yl, yh, zl, zh, imms=None)
    -> (lo, hi)``;
  * :func:`build_deriv`    -> ``fd(x, y, z=None, imms=None) -> (v, dx, dy,
    dz)``.

The JAX package traces the tape clause by clause into XLA, which fuses it.
Here each builder returns an :class:`UnrolledEval` that holds two
implementations of one clause walk:

  * the kernel: a generator writes one CUDA C++ kernel per (tape
    structure, semantics, immediates baked or read from a pointer, config
    flags): a thread takes a lane, every clause is a statement on fresh
    local variables (SSA form), so the compiler keeps every live slot in a
    register, and the result slot is stored.  It is built with nvcc for
    ``sm_90a`` with the port's flags (``ops/build.py``) at first use, into
    ``build/mpr_tpu_torch/unrolled/<key>/``, and loaded with ctypes;
    a second renderer of the same tape, in any process, builds nothing.
    With ``take_imms`` the key leaves the immediates out and the kernel
    reads them from a pointer, so a slider drag or a fit step builds
    nothing.  It bounds on operations (one per clause-operation and lane)
    for long tapes, and on the lanes' bytes for short ones.
  * the plain version: the same walk emitting torch ops, one call an
    operation.  CPU inputs take it, and a run on the card holds the kernel
    against it.  With ``take_imms`` it is differentiable in ``imms``.

One statement of each semantics drives both: the semantic classes below
call the operations of a backend, :class:`_TorchOps` (eager tensors) or
:class:`_CEmitter` (C statements), so the kernel and the plain version run
the same float32 operations in the same order.

The float evaluator with ``take_imms`` is differentiable in ``imms`` on
the card too: it is a ``torch.autograd.Function`` whose forward is the
float kernel and whose backward is kernel K1, generated per tape too
(:func:`generate_vjp_fwd`, :func:`generate_vjp`) from the tape's storage
plan (``ops/vjp_plan.py``): a forward half stores only the values the
partials read and a choice code a min/max clause, and reverse segments of
``VJP_SEGMENT`` clauses walk the tape backwards from the upstream gradient
with ``jax.grad``'s rules (``vjp_plan.partials``), keeping adjoints in
registers, handing the few that cross a segment (or are parked to bound
the registers) over in memory, and summing each immediate's share over
the lanes (``csrc/adjoint.cuh``).  Its plain version is autograd through
the plain walk.  The baked kernels, the interval and the deriv kernels are
forward-only: CUDA inputs with ``imms.requires_grad`` raise there.

Numerics follow ``mpr_tpu``'s unrolled semantics, which differ from the
interpreter's (``clause.cuh``):

  * interval ``mul``/``div`` take the min and max of the four endpoint
    products; a divisor that spans 0 gives ``[-inf, inf]``;
  * a baked immediate picks a branch when the kernel is generated
    (``mul_imm`` by its sign, ``div_imm`` by sign or zero); the
    imm-input forms take min/max of the two products instead;
  * a baked division by an immediate is a product with its reciprocal,
    rounded once in float32, because XLA rewrites ``a / c`` that way;
    the imm-input form divides;
  * the tight sin/cos bounds scale by ``1/tau`` for the same reason;
  * deriv ``min``/``max`` select with ``a < b`` / ``a > b``;
  * interval sin/cos are ``[-1, 1]`` unless ``config.tight_sincos``, and
    ``config.widen_intervals`` widens every clause's interval;
  * ``config.fast_transcendentals`` takes the Cephes asin/acos/atan
    (``transcendental.py``, ``clause.cuh``'s ``c_asin``...) instead of the
    math library's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import config as _config
from ..tape.opcodes import Op
from ..tape.tape import Tape
from . import build
from . import launch as ln
from . import transcendental as tc
from . import unrolled_plan as up
from . import vjp_plan as vp

# inputs and outputs of each semantics' kernel, SoA float32 planes of n lanes
N_IN = {"float": 3, "interval": 6, "deriv": 3}
N_OUT = {"float": 1, "interval": 2, "deriv": 4}
UNROLLED_ROOT = build.BUILD_ROOT / "unrolled"
# ptxas optimisation level of the generated kernels (part of the key)
PTXAS_O = 3
_WIDEN_EPS = 2.0 ** -23
_WIDEN_TINY = 2.0 ** -126
_HPI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))
_TAU = np.float32(2 * np.pi)


def recip(v: float) -> float:
    """``1/v`` rounded once in float32 (XLA's rewrite of ``a / v``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(1.0) / np.float32(v))


_INV_TAU = recip(_TAU)


# ---------------------------------------------------------------------------
# Backends: the operations a semantics is written in
# ---------------------------------------------------------------------------

def _f32(v) -> float:
    return float(np.float32(v))


class _Folding:
    """Constant chains folded as XLA's algebraic simplifier folds them in
    the JAX package's evaluators: ``(a + c1) + c2`` is ``a + (c1 + c2)``,
    ``(c1 - a) + c2`` is ``(c1 + c2) - a`` (a subtraction of a constant
    being the addition of its negation), and ``(a * c1) * c2`` is ``a *
    (c1 * c2)``, with the constants combined once in float32; nothing else
    reassociates (``c1 - (a + c2)`` and ``-(a * c1) * c2`` stay as they
    are).  A constant is a Python float: the baked immediates and the
    semantics' own literals, never an immediate read as an input.  A value
    made by adding or multiplying a constant carries a tag (how it was
    made), which the next such operation on it reads."""

    def add(self, a, b):
        if isinstance(a, float) and not isinstance(b, float):
            a, b = b, a
        if not isinstance(b, float) or isinstance(a, float):
            return self._add(a, b)
        t = self._tag(a)
        if t is not None and t[0] == "add":
            _, base, c, neg = t
            c = _f32(np.float32(c) + np.float32(b))
            v = self._sub(c, base) if neg else self._add(base, c)
            return self._set(v, ("add", base, c, neg))
        return self._set(self._add(a, b), ("add", a, b, False))

    def sub(self, a, b):
        if isinstance(b, float) and not isinstance(a, float):
            return self.add(a, -b)
        if isinstance(a, float) and not isinstance(b, float):
            return self._set(self._sub(a, b), ("add", b, a, True))
        return self._sub(a, b)

    def mul(self, a, b):
        if isinstance(a, float) and not isinstance(b, float):
            a, b = b, a
        if not isinstance(b, float) or isinstance(a, float):
            return self._mul(a, b)
        t = self._tag(a)
        if t is not None and t[0] == "mul":
            _, base, c = t
            c = _f32(np.float32(c) * np.float32(b))
            return self._set(self._mul(base, c), ("mul", base, c))
        return self._set(self._mul(a, b), ("mul", a, b))


class _TorchOps(_Folding):
    """Eager torch: each operation one torch call.  Values are tensors;
    an operand may also be a Python float (an f32 constant), never both
    operands of one operation.  Divisions are IEEE divisions on every
    device (CUDA turns ``tensor / python_float`` into a product with the
    reciprocal, so a constant divisor is spelled as a tensor)."""

    def __init__(self, fast: bool):
        self.fast = fast

    @staticmethod
    def _t(v, like):
        if isinstance(v, float):
            return torch.full_like(like, v)
        return v if v.shape == like.shape else v.expand_as(like)

    @staticmethod
    def _tag(v):
        return getattr(v, "_mpr_fold", None)

    @staticmethod
    def _set(v, tag):
        v._mpr_fold = tag
        return v

    def _add(self, a, b):
        return a + b

    def _sub(self, a, b):
        return a - b

    def _mul(self, a, b):
        return a * b

    def div(self, a, b):
        if isinstance(a, float):
            return torch.div(torch.full_like(b, a), b)
        return torch.div(a, self._t(b, a))

    def neg(self, a):
        return -a

    def minimum(self, a, b):
        return tc.minimum(a, self._t(b, a))

    def maximum(self, a, b):
        return tc.maximum(a, self._t(b, a))

    def where(self, c, a, b):
        if not isinstance(a, float) and not isinstance(b, float):
            return torch.where(c, a, b)
        like = b if isinstance(a, float) else a
        if isinstance(like, float):
            like = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
        return torch.where(c, self._t(a, like), self._t(b, like))

    def lt(self, a, b):
        return a < b

    def le(self, a, b):
        return a <= b

    def gt(self, a, b):
        return a > b

    def ge(self, a, b):
        return a >= b

    def and_(self, p, q):
        return p & q

    def or_(self, p, q):
        return p | q

    def abs(self, a):
        return tc.abs(a)

    def sqrt(self, a):
        return tc.sqrt(a)

    def sin(self, a):
        return torch.sin(a)

    def cos(self, a):
        return torch.cos(a)

    def exp(self, a):
        return torch.exp(a)

    def log(self, a):
        return torch.log(a)

    def floor(self, a):
        return torch.floor(a)

    def ceil(self, a):
        return torch.ceil(a)

    def isfinite(self, a):
        return torch.isfinite(a)

    def asin(self, a):
        return tc.asin(a) if self.fast else torch.asin(a)

    def acos(self, a):
        return tc.acos(a) if self.fast else torch.acos(a)

    def atan(self, a):
        return tc.atan(a) if self.fast else torch.atan(a)

    def zeros(self, like):
        return torch.zeros_like(like)

    def ones(self, like):
        return torch.ones_like(like)

    def full(self, v, like):
        return self._t(v, like)


# the recorded operation of each C operator
_BIN_OP = {"+": "add", "-": "sub", "*": "mul", "/": "div", "<": "lt",
           "<=": "le", ">": "gt", ">=": "ge", "&&": "and", "||": "or"}


def lit(v) -> str:
    """A float32 value as a bit-exact C literal: a hex float, or
    ``__int_as_float`` of its bits for infinities and NaNs."""
    f = np.float32(v)
    if np.isfinite(f):
        return f"({float(f).hex()}f)"
    return f"__int_as_float(0x{int(f.view(np.uint32)):08x})"


class _CEmitter(_Folding):
    """C statements: each operation one ``const`` local of the kernel, in
    SSA form, written in walk order (``lines``, the serial form) and
    recorded as a :class:`unrolled_plan.Stmt` (``stmts``, made by clause
    ``clause``), from which the scheduled forms are written.  Values are
    variable names or Python floats (constants)."""

    def __init__(self, fast: bool):
        self.fast = fast
        self.lines = []
        self.stmts = []
        self.clause = -1
        self.n = 0
        self.tags = {}

    def _tag(self, v):
        return self.tags.get(v)

    def _set(self, v, tag):
        self.tags[v] = tag
        return v

    def _new(self, expr: str, ty: str = "float", op: str = None,
             args=()) -> str:
        name = f"v{self.n}"
        self.n += 1
        self.lines.append(f"const {ty} {name} = {expr};")
        if op is not None:
            self.stmts.append(up.Stmt(name, ty, op, tuple(args),
                                      self.clause))
        return name

    def load(self, op: str, k: int) -> str:
        """An input lane (``in``), an immediate (``imm``)."""
        return self._new(f"in{k}[i]" if op == "in"
                         else f"__ldg(imms + {k})", "float", op, (k,))

    @staticmethod
    def _e(v) -> str:
        return lit(v) if isinstance(v, float) else v

    def _bin(self, a, op, b, ty="float"):
        return self._new(f"{self._e(a)} {op} {self._e(b)}", ty, _BIN_OP[op],
                         (a, b))

    def _call(self, fn, *args, ty="float"):
        return self._new(f"{fn}({', '.join(self._e(a) for a in args)})", ty,
                         fn, args)

    def _add(self, a, b):
        return self._bin(a, "+", b)

    def _sub(self, a, b):
        return self._bin(a, "-", b)

    def _mul(self, a, b):
        return self._bin(a, "*", b)

    def div(self, a, b):
        return self._bin(a, "/", b)

    def neg(self, a):
        return self._new(f"-{self._e(a)}", "float", "neg", (a,))

    def minimum(self, a, b):
        return self._call("nmin", a, b)

    def maximum(self, a, b):
        return self._call("nmax", a, b)

    def where(self, c, a, b):
        return self._new(f"{c} ? {self._e(a)} : {self._e(b)}", "float",
                         "sel", (c, a, b))

    def lt(self, a, b):
        return self._bin(a, "<", b, "bool")

    def le(self, a, b):
        return self._bin(a, "<=", b, "bool")

    def gt(self, a, b):
        return self._bin(a, ">", b, "bool")

    def ge(self, a, b):
        return self._bin(a, ">=", b, "bool")

    def and_(self, p, q):
        return self._bin(p, "&&", q, "bool")

    def or_(self, p, q):
        return self._bin(p, "||", q, "bool")

    def abs(self, a):
        return self._call("fabsf", a)

    def sqrt(self, a):
        return self._call("sqrtf", a)

    def sin(self, a):
        return self._call("sinf", a)

    def cos(self, a):
        return self._call("cosf", a)

    def exp(self, a):
        return self._call("expf", a)

    def log(self, a):
        return self._call("logf", a)

    def floor(self, a):
        return self._call("floorf", a)

    def ceil(self, a):
        return self._call("ceilf", a)

    def isfinite(self, a):
        return self._call("isfinite", a, ty="bool")

    def asin(self, a):
        return self._call("c_asin" if self.fast else "asinf", a)

    def acos(self, a):
        return self._call("c_acos" if self.fast else "acosf", a)

    def atan(self, a):
        return self._call("c_atan" if self.fast else "atanf", a)

    def zeros(self, like):
        return 0.0

    def ones(self, like):
        return 1.0

    def full(self, v, like):
        return v


class _CRules:
    """The backend of :func:`vjp_plan.partials` on a :class:`_CEmitter`:
    each operation a fresh ``const`` local, written as it stands (no
    folding of constants); a choice code's shares read ``mpr_bal_a`` /
    ``mpr_bal_b`` (csrc/unrolled.cuh)."""

    def __init__(self, K: _CEmitter):
        self.K = K

    def _b(self, a, op, b):
        return self.K._bin(a, op, b)

    def mul(self, a, b):
        return self._b(a, "*", b)

    def div(self, a, b):
        return self._b(a, "/", b)

    def add(self, a, b):
        return self._b(a, "+", b)

    def sub(self, a, b):
        return self._b(a, "-", b)

    def neg(self, a):
        return self.K._new(f"-{self.K._e(a)}")

    def sqrt(self, a):
        return self.K._call("sqrtf", a)

    def sin(self, a):
        return self.K._call("sinf", a)

    def cos(self, a):
        return self.K._call("cosf", a)

    def sel_ge0(self, a, p, q):
        e = self.K._e
        return self.K._new(f"{e(a)} >= 0.0f ? {e(p)} : {e(q)}")

    def bal(self, code, side):
        return self.K._call("mpr_bal_b" if side else "mpr_bal_a", code)


# ---------------------------------------------------------------------------
# The three semantics, over a backend K (mpr_tpu/ops/unrolled_eval.py:98-387)
# ---------------------------------------------------------------------------

def _baked(i) -> bool:
    return isinstance(i, float)


class _FloatSem:
    """Concrete float32 values (``_FloatSem`` of the JAX package)."""

    def __init__(self, K):
        self.K = K
        T = {}
        T[Op.SQUARE_LHS] = lambda a, b, i: K.mul(a, a)
        T[Op.SQRT_LHS] = lambda a, b, i: K.sqrt(a)
        T[Op.NEG_LHS] = lambda a, b, i: K.neg(a)
        T[Op.SIN_LHS] = lambda a, b, i: K.sin(a)
        T[Op.COS_LHS] = lambda a, b, i: K.cos(a)
        T[Op.ASIN_LHS] = lambda a, b, i: K.asin(a)
        T[Op.ACOS_LHS] = lambda a, b, i: K.acos(a)
        T[Op.ATAN_LHS] = lambda a, b, i: K.atan(a)
        T[Op.EXP_LHS] = lambda a, b, i: K.exp(a)
        T[Op.ABS_LHS] = lambda a, b, i: K.abs(a)
        T[Op.LOG_LHS] = lambda a, b, i: K.log(a)
        T[Op.ADD_LHS_IMM] = lambda a, b, i: K.add(a, i)
        T[Op.ADD_LHS_RHS] = lambda a, b, i: K.add(a, b)
        T[Op.MUL_LHS_IMM] = lambda a, b, i: K.mul(a, i)
        T[Op.MUL_LHS_RHS] = lambda a, b, i: K.mul(a, b)
        T[Op.MIN_LHS_IMM] = lambda a, b, i: K.minimum(a, i)
        T[Op.MIN_LHS_RHS] = lambda a, b, i: K.minimum(a, b)
        T[Op.MAX_LHS_IMM] = lambda a, b, i: K.maximum(a, i)
        T[Op.MAX_LHS_RHS] = lambda a, b, i: K.maximum(a, b)
        T[Op.SUB_LHS_IMM] = lambda a, b, i: K.sub(a, i)
        T[Op.SUB_IMM_RHS] = lambda a, b, i: K.sub(i, b)
        T[Op.SUB_LHS_RHS] = lambda a, b, i: K.sub(a, b)
        T[Op.DIV_LHS_IMM] = lambda a, b, i: (
            K.mul(a, recip(i)) if _baked(i) else K.div(a, i))
        T[Op.DIV_IMM_RHS] = lambda a, b, i: K.div(K.full(i, b), b)
        T[Op.DIV_LHS_RHS] = lambda a, b, i: K.div(a, b)
        T[Op.COPY_IMM] = lambda a, b, i: K.add(K.zeros(a), i)
        T[Op.COPY_LHS] = lambda a, b, i: a
        T[Op.COPY_RHS] = lambda a, b, i: b
        T[Op.HYPOT_LHS_RHS] = lambda a, b, i: K.sqrt(
            K.add(K.mul(a, a), K.mul(b, b)))
        T[Op.ADDSQ_LHS_RHS] = lambda a, b, i: K.add(K.mul(a, a), b)
        self.table = {int(k): v for k, v in T.items()}

    def zero_like(self, x):
        return self.K.zeros(x)

    def seed(self, v, axis):
        return v


class _IntervalSem:
    """Interval bounds (``_IntervalSem`` of the JAX package, with
    ``interval_math``'s square, sqrt, abs, log, asin, acos and the tight
    sin/cos written out over K)."""

    def __init__(self, K, tight_sincos: bool, widen: bool):
        self.K = K

        def minmax4(a, b, red):
            p1, p2 = K.mul(a[0], b[0]), K.mul(a[0], b[1])
            p3, p4 = K.mul(a[1], b[0]), K.mul(a[1], b[1])
            return red(red(p1, p2), red(p3, p4))

        def mul(a, b, i=None):
            return (minmax4(a, b, K.minimum), minmax4(a, b, K.maximum))

        def mul_imm(a, b, i):
            if _baked(i):
                if i >= 0:
                    return (K.mul(a[0], i), K.mul(a[1], i))
                return (K.mul(a[1], i), K.mul(a[0], i))
            p, q = K.mul(a[0], i), K.mul(a[1], i)
            return (K.minimum(p, q), K.maximum(p, q))

        def div(a, b, i=None):
            spans = K.and_(K.le(b[0], 0.0), K.ge(b[1], 0.0))
            sb = (K.where(spans, -1.0, b[0]), K.where(spans, 1.0, b[1]))
            inv = (K.div(1.0, sb[1]), K.div(1.0, sb[0]))
            lo, hi = mul(a, inv)
            return (K.where(spans, -np.inf, lo), K.where(spans, np.inf, hi))

        def div_imm(a, b, i):
            if _baked(i):
                r = recip(i)
                if i > 0:
                    return (K.mul(a[0], r), K.mul(a[1], r))
                if i < 0:
                    return (K.mul(a[1], r), K.mul(a[0], r))
                return (K.full(-np.inf, a[0]), K.full(np.inf, a[1]))
            p, q = K.div(a[0], i), K.div(a[1], i)
            return (K.minimum(p, q), K.maximum(p, q))

        def div_imm_rhs(a, b, i):
            c = K.full(i, b[0])
            return div((c, c), b)

        def square(a, b=None, i=None):
            al, ah = a
            neg = K.lt(ah, 0.0)
            pos = K.gt(al, 0.0)
            ll, hh = K.mul(al, al), K.mul(ah, ah)
            lo = K.where(neg, hh, K.where(pos, ll, 0.0))
            hi = K.where(K.gt(K.abs(al), K.abs(ah)), ll, hh)
            hi = K.where(neg, ll, K.where(pos, hh, hi))
            return lo, hi

        def sqrt_(a, b=None, i=None):
            al, ah = a
            bad = K.lt(ah, 0.0)
            lo = K.where(K.le(al, 0.0), 0.0, K.sqrt(K.maximum(al, 0.0)))
            hi = K.sqrt(K.maximum(ah, 0.0))
            return (K.where(bad, np.nan, lo), K.where(bad, np.nan, hi))

        def abs_(a, b, i):
            al, ah = a
            neg = K.lt(ah, 0.0)
            pos = K.ge(al, 0.0)
            lo = K.where(pos, al, K.where(neg, K.neg(ah), 0.0))
            hi = K.where(pos, ah, K.where(neg, K.neg(al),
                                          K.maximum(K.neg(al), ah)))
            return lo, hi

        def log_(a, b, i):
            al, ah = a
            bad = K.lt(ah, 0.0)
            tiny = float(np.float32(1e-38))
            lo = K.where(K.le(al, 0.0), 0.0, K.log(K.maximum(al, tiny)))
            hi = K.log(K.maximum(ah, tiny))
            hi = K.where(K.le(ah, 0.0), -np.inf, hi)
            return (K.where(bad, np.nan, lo), K.where(bad, np.nan, hi))

        def periodic(al, ah, f, c_max, c_min):
            """Endpoint values of f, widened to +-1 where [al, ah] holds a
            maximum (at c_max + 2 pi k) or a minimum (c_min + 2 pi k)."""
            def holds(c):
                top = ah if c == 0.0 else K.sub(ah, c)
                bot = al if c == 0.0 else K.sub(al, c)
                return K.ge(K.floor(K.mul(top, _INV_TAU)),
                            K.ceil(K.mul(bot, _INV_TAU)))
            has_max, has_min = holds(c_max), holds(c_min)
            fa, fb = f(al), f(ah)
            return (K.where(has_min, -1.0, K.minimum(fa, fb)),
                    K.where(has_max, 1.0, K.maximum(fa, fb)))

        def sin_(a, b, i):
            if tight_sincos:
                return periodic(a[0], a[1], K.sin, _HPI, -_HPI)
            return (K.full(-1.0, a[0]), K.full(1.0, a[1]))

        def cos_(a, b, i):
            if tight_sincos:
                return periodic(a[0], a[1], K.cos, 0.0, _PI)
            return (K.full(-1.0, a[0]), K.full(1.0, a[1]))

        def clip1(v):
            return K.minimum(K.maximum(v, -1.0), 1.0)

        def asin_(a, b, i):
            al, ah = a
            bad = K.or_(K.lt(ah, -1.0), K.gt(al, 1.0))
            lo, hi = K.asin(clip1(al)), K.asin(clip1(ah))
            return (K.where(bad, np.nan, lo), K.where(bad, np.nan, hi))

        def acos_(a, b, i):
            al, ah = a
            bad = K.or_(K.lt(ah, -1.0), K.gt(al, 1.0))
            lo, hi = K.acos(clip1(ah)), K.acos(clip1(al))
            return (K.where(bad, np.nan, lo), K.where(bad, np.nan, hi))

        def hypot_(a, b, i):
            sa, sb_ = square(a), square(b)
            return sqrt_((K.add(sa[0], sb_[0]), K.add(sa[1], sb_[1])))

        def addsq_(a, b, i):
            sa = square(a)
            return (K.add(sa[0], b[0]), K.add(sa[1], b[1]))

        T = {}
        T[Op.SQUARE_LHS] = square
        T[Op.SQRT_LHS] = sqrt_
        T[Op.NEG_LHS] = lambda a, b, i: (K.neg(a[1]), K.neg(a[0]))
        T[Op.SIN_LHS] = sin_
        T[Op.COS_LHS] = cos_
        T[Op.ASIN_LHS] = asin_
        T[Op.ACOS_LHS] = acos_
        T[Op.ATAN_LHS] = lambda a, b, i: (K.atan(a[0]), K.atan(a[1]))
        T[Op.EXP_LHS] = lambda a, b, i: (K.exp(a[0]), K.exp(a[1]))
        T[Op.ABS_LHS] = abs_
        T[Op.LOG_LHS] = log_
        T[Op.ADD_LHS_IMM] = lambda a, b, i: (K.add(a[0], i), K.add(a[1], i))
        T[Op.ADD_LHS_RHS] = lambda a, b, i: (K.add(a[0], b[0]),
                                             K.add(a[1], b[1]))
        T[Op.MUL_LHS_IMM] = mul_imm
        T[Op.MUL_LHS_RHS] = mul
        T[Op.MIN_LHS_IMM] = lambda a, b, i: (K.minimum(a[0], i),
                                             K.minimum(a[1], i))
        T[Op.MIN_LHS_RHS] = lambda a, b, i: (K.minimum(a[0], b[0]),
                                             K.minimum(a[1], b[1]))
        T[Op.MAX_LHS_IMM] = lambda a, b, i: (K.maximum(a[0], i),
                                             K.maximum(a[1], i))
        T[Op.MAX_LHS_RHS] = lambda a, b, i: (K.maximum(a[0], b[0]),
                                             K.maximum(a[1], b[1]))
        T[Op.SUB_LHS_IMM] = lambda a, b, i: (K.sub(a[0], i), K.sub(a[1], i))
        T[Op.SUB_IMM_RHS] = lambda a, b, i: (K.sub(i, b[1]), K.sub(i, b[0]))
        T[Op.SUB_LHS_RHS] = lambda a, b, i: (K.sub(a[0], b[1]),
                                             K.sub(a[1], b[0]))
        T[Op.DIV_LHS_IMM] = div_imm
        T[Op.DIV_IMM_RHS] = div_imm_rhs
        T[Op.DIV_LHS_RHS] = div
        T[Op.COPY_IMM] = lambda a, b, i: (K.add(K.zeros(a[0]), i),
                                          K.add(K.zeros(a[1]), i))
        T[Op.COPY_LHS] = lambda a, b, i: a
        T[Op.COPY_RHS] = lambda a, b, i: b
        T[Op.HYPOT_LHS_RHS] = hypot_
        T[Op.ADDSQ_LHS_RHS] = addsq_
        self.table = {int(k): v for k, v in T.items()}
        if widen:
            def post(v):
                lo, hi = v
                pad_lo = K.add(K.mul(_WIDEN_EPS, K.abs(lo)), _WIDEN_TINY)
                pad_hi = K.add(K.mul(_WIDEN_EPS, K.abs(hi)), _WIDEN_TINY)
                return (K.where(K.isfinite(lo), K.sub(lo, pad_lo), lo),
                        K.where(K.isfinite(hi), K.add(hi, pad_hi), hi))
            self.post = post

    def zero_like(self, x):
        z = self.K.zeros(x[0])
        return (z, z)

    def seed(self, v, axis):
        return v


class _DerivSem:
    """Forward-mode dual numbers (v, dx, dy, dz) (``_DerivSem`` of the JAX
    package); min/max pick the winning operand with ``<`` / ``>``."""

    def __init__(self, K):
        self.K = K

        def sel(c, a, b):
            return tuple(K.where(c, x, y) for x, y in zip(a, b))

        def d0(v, like):
            z = K.mul(like[1], 0.0)
            return (K.add(K.zeros(like[0]), v), z, z, z)

        def lift(vf, df):
            def f(a, b, i):
                c = df(a[0])
                return (vf(a[0]), K.mul(c, a[1]), K.mul(c, a[2]),
                        K.mul(c, a[3]))
            return f

        def twice(a, d):
            return K.mul(K.mul(2.0, a[0]), d)

        T = {}
        T[Op.SQUARE_LHS] = lambda a, b, i: (
            K.mul(a[0], a[0]), twice(a, a[1]), twice(a, a[2]),
            twice(a, a[3]))
        T[Op.SQRT_LHS] = lift(K.sqrt, lambda v: K.div(0.5, K.sqrt(v)))
        T[Op.NEG_LHS] = lambda a, b, i: tuple(K.neg(x) for x in a)
        T[Op.SIN_LHS] = lift(K.sin, K.cos)
        T[Op.COS_LHS] = lift(K.cos, lambda v: K.neg(K.sin(v)))

        def inv_root(num):
            return lambda v: K.div(num, K.sqrt(K.sub(1.0, K.mul(v, v))))
        T[Op.ASIN_LHS] = lift(K.asin, inv_root(1.0))
        T[Op.ACOS_LHS] = lift(K.acos, inv_root(-1.0))
        T[Op.ATAN_LHS] = lift(K.atan, lambda v: K.div(
            1.0, K.add(1.0, K.mul(v, v))))
        T[Op.EXP_LHS] = lift(K.exp, K.exp)

        def abs_(a, b, i):
            s = K.where(K.lt(a[0], 0.0), -1.0, 1.0)
            return (K.abs(a[0]), K.mul(s, a[1]), K.mul(s, a[2]),
                    K.mul(s, a[3]))
        T[Op.ABS_LHS] = abs_
        T[Op.LOG_LHS] = lift(K.log, lambda v: K.div(1.0, v))
        T[Op.ADD_LHS_IMM] = lambda a, b, i: (K.add(a[0], i), a[1], a[2],
                                             a[3])
        T[Op.ADD_LHS_RHS] = lambda a, b, i: tuple(
            K.add(x, y) for x, y in zip(a, b))
        T[Op.MUL_LHS_IMM] = lambda a, b, i: tuple(K.mul(x, i) for x in a)

        def mul(a, b, i):
            return (K.mul(a[0], b[0]),
                    *(K.add(K.mul(a[0], b[k]), K.mul(b[0], a[k]))
                      for k in (1, 2, 3)))
        T[Op.MUL_LHS_RHS] = mul
        T[Op.MIN_LHS_IMM] = lambda a, b, i: sel(K.lt(a[0], i), a, d0(i, a))
        T[Op.MIN_LHS_RHS] = lambda a, b, i: sel(K.lt(a[0], b[0]), a, b)
        T[Op.MAX_LHS_IMM] = lambda a, b, i: sel(K.gt(a[0], i), a, d0(i, a))
        T[Op.MAX_LHS_RHS] = lambda a, b, i: sel(K.gt(a[0], b[0]), a, b)
        T[Op.SUB_LHS_IMM] = lambda a, b, i: (K.sub(a[0], i), a[1], a[2],
                                             a[3])
        T[Op.SUB_IMM_RHS] = lambda a, b, i: (
            K.sub(i, b[0]), K.neg(b[1]), K.neg(b[2]), K.neg(b[3]))
        T[Op.SUB_LHS_RHS] = lambda a, b, i: tuple(
            K.sub(x, y) for x, y in zip(a, b))

        def div_imm(a, b, i):
            if _baked(i):
                r = recip(i)
                return tuple(K.mul(x, r) for x in a)
            return tuple(K.div(x, i) for x in a)
        T[Op.DIV_LHS_IMM] = div_imm

        def div_imm_rhs(a, b, i):
            v = K.div(K.full(i, b[0]), b[0])
            c = K.div(K.neg(v), b[0])
            return (v, K.mul(c, b[1]), K.mul(c, b[2]), K.mul(c, b[3]))
        T[Op.DIV_IMM_RHS] = div_imm_rhs

        def div(a, b, i):
            inv = K.div(1.0, b[0])
            v = K.mul(a[0], inv)
            return (v, *(K.mul(K.sub(a[k], K.mul(v, b[k])), inv)
                         for k in (1, 2, 3)))
        T[Op.DIV_LHS_RHS] = div
        T[Op.COPY_IMM] = lambda a, b, i: d0(i, a)
        T[Op.COPY_LHS] = lambda a, b, i: a
        T[Op.COPY_RHS] = lambda a, b, i: b

        def hypot_(a, b, i):
            v = K.sqrt(K.add(K.mul(a[0], a[0]), K.mul(b[0], b[0])))
            inv = K.div(1.0, v)
            return (v, *(K.mul(K.add(K.mul(a[0], a[k]), K.mul(b[0], b[k])),
                               inv) for k in (1, 2, 3)))
        T[Op.HYPOT_LHS_RHS] = hypot_
        T[Op.ADDSQ_LHS_RHS] = lambda a, b, i: (
            K.add(K.mul(a[0], a[0]), b[0]),
            *(K.add(twice(a, a[k]), b[k]) for k in (1, 2, 3)))
        self.table = {int(k): v for k, v in T.items()}

    def zero_like(self, x):
        z = self.K.zeros(x)
        return (z, z, z, z)

    def seed(self, v, axis):
        z, o = self.K.zeros(v), self.K.ones(v)
        d = [z, z, z]
        d[axis] = o
        return (v, d[0], d[1], d[2])


def _sem(kind: str, K, flags):
    if kind in ("float", "vjp", "vjpf"):
        return _FloatSem(K)
    if kind == "interval":
        return _IntervalSem(K, flags["tight_sincos"],
                            flags["widen_intervals"])
    return _DerivSem(K)


def _walk(tape: Tape, sem, x, y, z, imms, comment=None):
    """The clause walk (``_walk`` of the JAX package): ``sem.table`` maps
    opcodes to callables on the backend's values; slots are a dict, so a
    slot's reuse is a rebinding.  A slot read before it is written reads
    zero.  ``comment(t, op, o, l, r)`` is called before each clause (the
    generator writes it into the source)."""
    ops, outs = tape.ops.tolist(), tape.outs.tolist()
    lhss, rhss = tape.lhss.tolist(), tape.rhss.tolist()
    zero = sem.zero_like(x)
    slots = {0: zero}
    sx, sy, sz = tape.axis_slots
    if sx:
        slots[sx] = sem.seed(x, 0)
    if sy:
        slots[sy] = sem.seed(y, 1)
    if sz:
        slots[sz] = sem.seed(z, 2)
    post = getattr(sem, "post", None)
    for t in range(tape.length):
        op, o, l, r = ops[t], outs[t], lhss[t], rhss[t]
        if op not in sem.table:
            raise ValueError(f"clause {t}: opcode {op} has no unrolled form")
        if comment is not None:
            comment(t, op, o, l, r)
        v = sem.table[op](slots.get(l, zero), slots.get(r, zero), imms[t])
        slots[o] = post(v) if post is not None else v
    return slots.get(tape.result_slot, zero)


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def _flags() -> dict:
    cfg = _config.get()
    return {"tight_sincos": bool(cfg.tight_sincos),
            "fast_transcendentals": bool(cfg.fast_transcendentals),
            "widen_intervals": bool(cfg.widen_intervals)}


def _nvcc_flags():
    return build.FLAGS + ("-Xptxas", f"-O{PTXAS_O}")


def _generator_hash() -> str:
    h = hashlib.sha256(" ".join(_nvcc_flags()).encode())
    for p in (Path(__file__), Path(up.__file__), Path(vp.__file__),
              Path(ln.__file__), build.CSRC / "unrolled.cuh",
              build.CSRC / "clause.cuh", build.CSRC / "adjoint.cuh"):
        h.update(p.read_bytes())
    return h.hexdigest()


_GEN_HASH = None


def structure_key(tape: Tape, take_imms: bool, flags: dict) -> str:
    """What a kernel of ``tape`` is keyed by: the clauses (ops, outs,
    lhss, rhss), the immediates unless ``take_imms``, ``axis_slots``,
    ``result_slot``, the config flags and a hash of the generator's own
    source, the schedule and launch modules it reads, its headers and the
    nvcc flags (``render/unrolled.py``'s ``tape_key`` analog)."""
    global _GEN_HASH
    if _GEN_HASH is None:
        _GEN_HASH = _generator_hash()
    h = hashlib.sha1(_GEN_HASH.encode())
    planes = (tape.ops, tape.outs, tape.lhss, tape.rhss)
    if not take_imms:
        planes += (tape.imms,)
    for a in planes:
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(bytes(tape.axis_slots) + bytes([tape.result_slot]))
    h.update(bytes([flags["tight_sincos"], flags["fast_transcendentals"],
                    flags["widen_intervals"], bool(take_imms)]))
    return h.hexdigest()


def record(tape: Tape, kind: str, take_imms: bool, flags: dict):
    """One walk of ``tape`` over a :class:`_CEmitter`: returns the emitter
    (its serial ``lines``, a comment before each clause, and its ``stmts``)
    and the outputs (names or constants)."""
    K = _CEmitter(flags["fast_transcendentals"])
    sem = _sem(kind, K, flags)
    if kind == "interval":
        ins = [K.load("in", k) for k in range(6)]
        x, y, z = (ins[0], ins[1]), (ins[2], ins[3]), (ins[4], ins[5])
    else:
        x, y, z = (K.load("in", k) for k in range(3))
    if take_imms:
        class _Imms:
            def __getitem__(self, t):
                return K.load("imm", t)
        imms = _Imms()
    else:
        imms = [float(v) for v in tape.imms]
    names = _op_names()

    def comment(t, op, o, l, r):
        K.lines.append(f"// {t}: s{o} = {names.get(op, op)} s{l} s{r}")
        K.clause = t
    res = _walk(tape, sem, x, y, z, imms, comment)
    return K, res if isinstance(res, tuple) else (res,)


def _op_names():
    return {int(o): o.name for o in Op}


def program(tape: Tape, kind: str, take_imms: bool,
            flags: dict) -> up.Program:
    """The statements of ``tape``'s ``kind`` walk and its outputs."""
    K, outs = record(tape, kind, take_imms, flags)
    return up.Program(K.stmts, outs)


# The lanes and split forms' min/max: PTX min.NaN / max.NaN (one
# instruction, sm_80 on; a NaN operand gives the canonical NaN) in place
# of clause.cuh's nmin / nmax (two NaN tests, fminf, two selects).  Both
# equal torch.minimum / maximum on the card, NaNs by NaN-ness (chip_smoke.py
# phase 13 and tests/test_torch_gpu.py hold them to it on +-0, +-inf and
# NaN).  The serial form keeps nmin / nmax.  These forms also write a
# clause's sinf and cosf of one operand (a dual number's sin or cos) as
# one sincosf (_sincos_pairs).
_C_MINMAX = {"nmin": "mpr_min_nan", "nmax": "mpr_max_nan"}
_C_BIN = {v: k for k, v in _BIN_OP.items()}


def _c_expr(s: up.Stmt, ref, idx: str) -> str:
    """C expression of ``s``, its operands written by ``ref``, an input
    read at lane index ``idx``."""
    if s.op == "in":
        return f"in{s.args[0]}[{idx}]"
    if s.op == "imm":
        return f"__ldg(imms + {s.args[0]})"
    if s.op == "part":
        return f"mpr_part[{s.args[0]}][lane]"
    a = [ref(v) for v in s.args]
    if s.op in _C_BIN:
        return f"{a[0]} {_C_BIN[s.op]} {a[1]}"
    if s.op == "neg":
        return f"-{a[0]}"
    if s.op == "sel":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    return f"{_C_MINMAX.get(s.op, s.op)}({', '.join(a)})"


def _sincos_pairs(order) -> dict:
    """The ``sinf`` and ``cosf`` statements of one clause on one operand
    (a dual number's sin and cos clauses take both), each pair to be
    written as one ``sincosf`` call, which shares the argument's range
    reduction and rounds both as ``sinf`` and ``cosf`` do (the card holds
    the lanes and split forms to the plain version bit for bit): the
    pair's first statement in ``order`` -> (the sine's name, the
    cosine's), its second -> None."""
    out, alone = {}, {}
    for s in order:
        if s.op not in ("sinf", "cosf"):
            continue
        other = "cosf" if s.op == "sinf" else "sinf"
        mate = alone.pop((s.clause, s.args[0], other), None)
        if mate is None:
            alone[(s.clause, s.args[0], s.op)] = s
            continue
        sin, cos = (mate, s) if s.op == "cosf" else (s, mate)
        out[mate.name], out[s.name] = (sin.name, cos.name), None
    return out


def _statement(s: up.Stmt, pairs: dict, ref, idx: str, suffix: str = "") \
        -> str:
    """The C line of ``s`` (operands by ``ref``, inputs at ``idx``, the
    name with ``suffix``): a declaration, both values of a sine-cosine
    pair at its first statement, nothing at its second."""
    if s.name not in pairs:
        return f"const {s.ty} {s.name}{suffix} = {_c_expr(s, ref, idx)};"
    if pairs[s.name] is None:
        return ""
    sin, cos = (n + suffix for n in pairs[s.name])
    return f"float {sin}, {cos}; sincosf({ref(s.args[0])}, &{sin}, &{cos});"


def _listing(tape: Tape) -> str:
    """The tape as comments, a clause a line."""
    names = _op_names()
    ops, outs = tape.ops.tolist(), tape.outs.tolist()
    lhss, rhss = tape.lhss.tolist(), tape.rhss.tolist()
    return "\n".join(f"// {t}: s{outs[t]} = {names.get(ops[t], ops[t])} "
                     f"s{lhss[t]} s{rhss[t]}" for t in range(tape.length))


def _lanes_body(order, outs, k: int) -> str:
    """The statements of ``order`` for ``k`` lanes a thread (``vN_j`` is
    lane j's; a lane-invariant statement is written once), then the
    stores (lane 0 always lies below n, the others are guarded)."""
    inv = up.lane_invariant(order)
    pairs = _sincos_pairs(order)

    def name(v, j):
        if isinstance(v, float):
            return lit(v)
        return v if v in inv else f"{v}_{j}"
    lines = []
    for s in order:
        if s.name in inv:
            lines.append(_statement(s, pairs, lambda v: name(v, 0), ""))
            continue
        for j in range(k):
            lines.append(_statement(s, pairs, lambda v, j=j: name(v, j),
                                    f"i{j}", f"_{j}"))
    lines = [x for x in lines if x]
    for j in range(k):
        st = " ".join(f"out{q}[l{j}] = {name(o, j)};"
                      for q, o in enumerate(outs))
        lines.append(st if j == 0 else f"if (l{j} < n) {{ {st} }}")
    return "\n        ".join(lines)


def _lanes_source(tape, prog: up.Program, k: int, take_imms: bool,
                  head: str) -> str:
    order = up.schedule(prog.stmts, prog.outs)
    T = ln.UNROLLED_THREADS
    idx = ["const int l0 = b, i0 = b;"] + [
        f"const int l{j} = b + {j * T}, i{j} = l{j} < n ? l{j} : n - 1;"
        for j in range(1, k)]
    # the immediates' pointer made opaque each step: their loads stay in
    # the loop (hoisted, every immediate would hold a register)
    im = ("unsigned long long mpr_im = (unsigned long long)imms;\n        "
          "asm volatile(\"\" : \"+l\"(mpr_im));\n        "
          "const float* const imms = (const float*)mpr_im;\n        "
          ) if take_imms else ""
    # The grid covers the lanes (csrc/unrolled.cuh), so a thread takes one
    # step of the loop; written as a loop, ptxas -O3 allocates the step
    # without the spills (4-76 B) it made of three of the chip cells'
    # lanes builds written as one guarded step (chip_smoke.py phase 13).
    return (f"{head}\n#define MPR_UNROLLED_THREADS {T}\n"
            f"#define MPR_BLOCK_THREADS {T}\n#define MPR_BLOCK_LANES "
            f"{T * k}\n#include \"unrolled.cuh\"\n\n"
            f"{_listing(tape)}\n\nMPR_GRID_KERNEL {{\n"
            f"  for (int b = blockIdx.x * {T * k} + threadIdx.x; b < n; "
            f"b += gridDim.x * {T * k}) {{\n"
            f"    {{\n        {' '.join(idx)}\n        {im}"
            f"{_lanes_body(order, prog.outs, k)}\n    }}\n  }}\n}}\n\n"
            f"MPR_GRID_ENTRY\n")


def _split_source(tape, sp: up.Split, head: str) -> str:
    def ref(v):
        return lit(v) if isinstance(v, float) else v

    def stmts(order):
        pairs = _sincos_pairs(order)
        return "\n        ".join(x for x in (_statement(s, pairs, ref, "i")
                                             for s in order) if x)
    cases = []
    for w, p in enumerate(sp.parts[:sp.warps]):
        for n, _ in p.outs:
            if p.order and next(s for s in p.order if s.name == n).ty \
                    != "float":
                raise AssertionError(f"part result {n} is not a float")
        st = " ".join(f"mpr_part[{k}][lane] = {n};" for n, k in p.outs)
        cases.append(f"  case {w}: {{\n        {stmts(p.order)}\n"
                     f"        {st}\n        break;\n  }}")
    stores = " ".join(f"out{q}[l] = {ref(o)};" for q, o in enumerate(sp.outs))
    return (f"{head}\n#define MPR_BLOCK_THREADS {32 * sp.warps}\n"
            f"#define MPR_BLOCK_LANES 32\n"
            f"#include \"unrolled.cuh\"\n\n{_listing(tape)}\n\n"
            f"MPR_GRID_KERNEL {{\n"
            f"  __shared__ float mpr_part[{max(sp.n_slots, 1)}][32];\n"
            f"  const int lane = threadIdx.x & 31;\n"
            f"  const int l = blockIdx.x * 32 + lane;\n"
            f"  const int i = l < n ? l : n - 1;\n"
            f"  switch (threadIdx.x >> 5) {{\n" + "\n".join(cases)
            + f"\n  }}\n  __syncthreads();\n  if (threadIdx.x >= 32) "
            f"return;\n  {{\n        {stmts(sp.top)}\n"
            f"        if (l < n) {{ {stores} }}\n  }}\n}}\n\n"
            f"MPR_GRID_ENTRY\n")


def generate(tape: Tape, kind: str, take_imms: bool, flags: dict,
             shape: ln.UnrolledLaunch = None) -> str:
    """The CUDA source of one evaluator in one form (``shape``; default
    serial) and its C entry point ``mpr_unrolled`` (csrc/unrolled.cuh):

      * serial: ``mpr_unrolled_kernel``, a thread a lane, the statements
        in tape order (the float, interval and deriv kernels' first
        design);
      * lanes: the statements in :func:`unrolled_plan.schedule`'s order,
        written for ``k`` lanes a thread, a block of
        ``launch.UNROLLED_THREADS`` every ``UNROLLED_THREADS * k`` lanes;
      * split: :func:`unrolled_plan.split`'s parts, a warp each, and the
        top on warp 0, 32 lanes a block."""
    shape = shape or ln.UnrolledLaunch("serial")
    mode = "imms from a pointer" if take_imms else "imms baked"
    if shape.form != "serial":
        prog = program(tape, kind, take_imms, flags)
        head = (f"// {kind} evaluator of a {tape.length}-clause tape, "
                f"{shape.tag} ({mode}; flags {flags}), written by "
                f"mpr_tpu_torch/ops/unrolled_eval.py")
        if kind == "deriv":
            # dual numbers keep about four times the float values live:
            # without a minimum of blocks ptxas -O3 spilled stress_2d(600)'s
            # tape far below the registers the block allows, to meet an
            # occupancy of its own choosing; one block an SM at least
            # leaves it the registers it needs
            head += "\n#define MPR_MIN_BLOCKS 1"
        if shape.form == "lanes":
            return _lanes_source(tape, prog, shape.k, take_imms, head)
        return _split_source(tape, up.split(prog, shape.parts), head)
    K, outs = record(tape, kind, take_imms, flags)
    body = "\n    ".join(K.lines)
    stores = "\n    ".join(f"out{k}[i] = {K._e(v)};"
                           for k, v in enumerate(outs))
    head = (f"// {kind} evaluator of a {tape.length}-clause tape "
            f"({mode}; flags {flags}), written by "
            f"mpr_tpu_torch/ops/unrolled_eval.py")
    return (f"{head}\n#define MPR_UNROLLED_THREADS {ln.UNROLLED_THREADS}\n"
            f"#include \"unrolled.cuh\"\n\nMPR_UNROLLED_KERNEL {{\n"
            f"    const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            f"    if (i >= n) return;\n    {body}\n    {stores}\n}}\n\n"
            f"MPR_UNROLLED_ENTRY\n")


def _blocked_bases(plan: vp.VjpPlan) -> str:
    """C statements giving ``lane``'s row 0 in each of K1's arrays
    (``ops/vjp_plan.py``'s layout, in blocks of ``LANE_BLOCK`` lanes: vals
    ``vb``, choice words ``cb``, hand ``hb``)."""
    B = vp.LANE_BLOCK
    return " ".join(f"const size_t {nm} = (size_t)(lane / {B}) * "
                    f"{max(rows, 1) * B} + lane % {B};"
                    for nm, rows in (("vb", plan.n_vals),
                                     ("cb", plan.n_words),
                                     ("hb", plan.n_handover)))


def generate_vjp_fwd(tape: Tape, flags: dict, plan: vp.VjpPlan) -> str:
    """The CUDA source of K1's forward half (the float evaluator's
    statements in the ``mpr_unrolled`` frame) storing what ``plan`` lists
    (``ops/vjp_plan.py``'s layout): each value the partials read in row
    ``vpos`` of ``vals`` (out0), and each min/max clause's choice code, 16
    to a word, in row ``cidx / 16`` of ``ch`` (out1).  A lane past n
    computes lane n - 1's values into its own entries (the layout pads to
    whole blocks), so that the reverse half needs no guard.  It takes up
    to 255 registers, half the warps of the reverse half: the codes'
    comparisons raise its pressure past 128 registers, and at 168 or 128
    it spilled (``chip_smoke.py`` fails on a spill)."""
    K = _CEmitter(flags["fast_transcendentals"])
    sem = _FloatSem(K)
    x, y, z = (K._new(f"in{k}[i]") for k in range(3))
    e = K._e
    zero = sem.zero_like(x)
    slots = {0: zero}
    for s_, v in zip(tape.axis_slots, (x, y, z)):
        if s_:
            slots[s_] = v
    ops, outs = tape.ops.tolist(), tape.outs.tolist()
    lhss, rhss = tape.lhss.tolist(), tape.rhss.tolist()
    B = vp.LANE_BLOCK
    K.lines.append("uint32_t cw = 0u;")
    for t in range(tape.length):
        op, o = ops[t], outs[t]
        if op not in sem.table:
            raise ValueError(f"clause {t}: opcode {op} has no unrolled form")
        a, b = slots.get(lhss[t], zero), slots.get(rhss[t], zero)
        imm = K._new(f"__ldg(imms + {t})")
        v = slots[o] = sem.table[op](a, b, imm)
        if plan.vpos[t] >= 0:
            K.lines.append(f"vals[vb + {B * plan.vpos[t]}] = {e(v)};")
        c = int(plan.cidx[t])
        if c >= 0:
            q = imm if op in (Op.MIN_LHS_IMM, Op.MAX_LHS_IMM) else b
            K.lines.append(f"cw |= ((uint32_t)({e(a)} == {e(v)}) | "
                           f"((uint32_t)({e(q)} == {e(v)}) << 1)) << "
                           f"{2 * (c % 16)};")
            if c % 16 == 15 or c == plan.n_choices - 1:
                K.lines.append(f"ch[cb + {B * (c // 16)}] = cw; cw = 0u;")
    body = "\n    ".join(K.lines)
    head = (f"// K1 forward half: the float evaluator of a {tape.length}-"
            f"clause tape storing {plan.n_vals} values and {plan.n_words} "
            f"choice words a lane (flags {flags}), written by "
            f"mpr_tpu_torch/ops/unrolled_eval.py")
    return (f"{head}\n#define MPR_UNROLLED_THREADS {ln.UNROLLED_THREADS}\n"
            f"#include \"unrolled.cuh\"\n\nMPR_UNROLLED_KERNEL {{\n"
            f"    const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
            f"    const int i = lane < n ? lane : n - 1;\n"
            f"    float* const vals = out0;\n"
            f"    uint32_t* const ch = reinterpret_cast<uint32_t*>(out1);\n"
            f"    {_blocked_bases(plan)}\n"
            f"    {body}\n}}\n\nMPR_UNROLLED_ENTRY\n")


def generate_vjp(tape: Tape, flags: dict, plan: vp.VjpPlan, seg,
                 shape: dict = None) -> str:
    """The CUDA source of one segment ``seg = (t0, t1)`` of K1's reverse
    half, the VJP of the imm-input float evaluator:
    ``mpr_unrolled_vjp_kernel`` (a thread a lane in a grid-stride loop
    walks the segment's clauses backwards; for each clause whose output has
    an adjoint it reads what its rule needs, the stored values and choice
    code of the forward half, and hands the rule's shares
    (:func:`vjp_plan.partials`) on: into a register adjoint, into the
    handover array ``hand``, or, for the immediate, into the block's
    accumulator, eight immediates at a time (``mpr::acc_imm8``)) and its
    entry points (csrc/unrolled.cuh).

    ``plan`` says where each adjoint lives: a register within the segment,
    or row ``hpos`` of ``hand`` (an adjoint read by an earlier segment, or
    parked to keep at most ``VJP_LIVE`` in registers), which its first
    contributor stores and the others add to.  The clause writing the
    result starts from the upstream gradient ``g`` (in3).  A lane past n
    reads lane n - 1's inputs and its own entries (the forward half filled
    them), so it needs no guard; its immediate shares count 0.  Segments
    keep each kernel a few thousand statements (nvcc's time grows faster
    than the code).  ``shape`` (``_VjpEval.shape``) gives the launch
    bounds."""
    t0, t1 = seg
    shape = shape or _vjp_shape()
    B = vp.LANE_BLOCK
    K = _CEmitter(flags["fast_transcendentals"])
    R = _CRules(K)
    e = K._e
    ins, reg, pending, words = {}, {}, [], {}

    def value(s_):
        if s_ >= 0:
            return K._new(f"vals[vb + {B * plan.vpos[s_]}]")
        if s_ == -4:
            return 0.0
        if s_ not in ins:
            ins[s_] = K._new(f"in{-1 - s_}[i]")
        return ins[s_]

    def reduce(flush=False):
        # the pending immediates' shares, eight at a time (padded with 0)
        while pending and (len(pending) >= 8 or flush):
            batch, pending[:] = pending[:8], pending[8:]
            batch += [(batch[0][0], "0.0f")] * (8 - len(batch))
            K.lines.append(
                f"mpr::acc_imm8<{', '.join(str(k) for k, _ in batch)}>("
                "acc, " + ", ".join(v for _, v in batch) + ");")
    names = {int(o): o.name for o in Op}
    ops, outs = tape.ops.tolist(), tape.outs.tolist()
    lhss, rhss = tape.lhss.tolist(), tape.rhss.tolist()
    src = plan.src
    reduced = 0
    for t in range(t1 - 1, t0 - 1, -1):
        if not plan.has[t]:
            continue
        op = ops[t]
        if op < Op.SQUARE_LHS:
            raise ValueError(f"clause {t}: opcode {op} has no unrolled form")
        K.lines.append(f"// {t}: s{outs[t]} = {names.get(op, op)} "
                       f"s{lhss[t]} s{rhss[t]}")
        if t == plan.result:
            g = K._new("in3[i]")
        elif plan.hpos[t] >= 0:
            g = K._new(f"__ldcg(hand + hb + {B * plan.hpos[t]})")
        else:
            g = reg.pop(t)
        a = value(int(src[0, t])) if vp.NEEDS_A[op] else None
        b = value(int(src[1, t])) if vp.NEEDS_B[op] else None
        r = (K._new(f"vals[vb + {B * plan.vpos[t]}]")
             if vp.NEEDS_R[op] else None)
        imm = K._new(f"__ldg(imms + {t})") if vp.READS_IMM[op] else None
        code = None
        if vp.CHOICE[op]:
            c = int(plan.cidx[t])
            if c // 16 not in words:
                words[c // 16] = K._new(f"ch[cb + {B * (c // 16)}]",
                                        "uint32_t")
            code = K._new(f"({words[c // 16]} >> {2 * (c % 16)}) & 3u",
                          "uint32_t")
        da, db, di = vp.partials(op, R, g, a, b, r, imm, code)
        if di is not None:
            pending.append((t - t0, K._new(f"live ? {e(di)} : 0.0f")))
            reduced += 1
            reduce()
        got = {}
        for d, s_ in ((da, int(src[0, t])), (db, int(src[1, t]))):
            if d is None or s_ < 0:
                continue
            got[s_] = d if s_ not in got else K._new(f"{got[s_]} + {e(d)}")
        for s_, d in got.items():
            h = int(plan.hpos[s_])
            if h < 0:
                reg[s_] = d if s_ not in reg else K._new(f"{reg[s_]} + {e(d)}")
            else:
                # through L2, out of the compiler's sight: a value kept in
                # a register from its store to its read would undo the
                # plan's parking
                p = f"hand + hb + {B * h}"
                if plan.first[s_] != t:
                    d = K._new(f"__ldcg({p}) + {e(d)}")
                K.lines.append(f"__stcg({p}, {e(d)});")
    reduce(flush=True)
    if reg:
        raise AssertionError(f"segment {seg}: adjoints of {sorted(reg)} left "
                             "in registers")
    body = "\n        ".join(K.lines)
    head = (f"// K1 reverse half, clauses [{t0}, {t1}) of {tape.length}: VJP "
            f"(d/d imms) of the float evaluator ({reduced} immediates "
            f"reduced; flags {flags}), written by "
            f"mpr_tpu_torch/ops/unrolled_eval.py")
    return (f"{head}\n#define MPR_UNROLLED_THREADS {ln.UNROLLED_THREADS}\n"
            f"#define MPR_VJP_THREADS {shape['threads']}\n"
            f"#define MPR_VJP_MIN_BLOCKS {shape['min_blocks']}\n"
            f"#include \"unrolled.cuh\"\n\nconstexpr int T0 = {t0}, "
            f"T1 = {t1};\n\nMPR_UNROLLED_VJP_KERNEL {{\n"
            f"    extern __shared__ float acc[];\n"
            f"    mpr::acc_zero(acc, T1 - T0);\n"
            f"    const int stride = gridDim.x * blockDim.x;\n"
            f"    for (int base = blockIdx.x * blockDim.x; base < n; "
            f"base += stride) {{\n"
            f"        const int lane = base + threadIdx.x;\n"
            f"        const bool live = lane < n;\n"
            f"        const int i = live ? lane : n - 1;\n"
            f"        {_blocked_bases(plan)}\n"
            f"        {body}\n    }}\n"
            f"    mpr::acc_store(acc, partials + T0, T1 - T0, T);\n}}\n\n"
            f"MPR_UNROLLED_VJP_ENTRY\n")


# ---------------------------------------------------------------------------
# Build: nvcc at first use, one process an evaluator, all started together
# ---------------------------------------------------------------------------

# key -> {"kind", "clauses", "seconds", "log", "compiled"} for every
# evaluator this process built or loaded
BUILDS = {}
_lock = threading.Lock()
_libs = {}
_SIGNATURE = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
              + [ctypes.c_void_p])
# kinds with other entry points: K1's reverse half (a segment: x, y, z, g,
# imms, vals, ch, hand, partials; n, T, blocks, threads; stream) and its
# sum of the blocks' rows (partials, grad; T, blocks, accumulate; stream)
_ENTRIES = {"vjp": [("mpr_unrolled_vjp", [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
                    ("mpr_unrolled_vjp_reduce", [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])]}
# K1's reverse half: clauses a segment at most (a kernel each), adjoints
# kept in registers at once at most (ops/vjp_plan.py parks the rest in the
# handover array), threads a block and blocks an SM that its launch bounds
# ask for (__launch_bounds__(128, 4): at most 128 registers a thread, 16
# warps an SM).  Chosen by ptxas's report (chip_smoke.py phase 14 prints
# it and fails on a spill): at 56 adjoints no segment of the chip cells'
# tapes spills at 128 registers.
VJP_SEGMENT = 512
VJP_LIVE = 56
VJP_THREADS = 128
VJP_MIN_BLOCKS = 4
# waves of resident blocks a K1 launch takes at most (its grid-stride loop
# takes the rest): its blocks, and so the rows of its partial sums
VJP_WAVES = 2


def _vjp_shape() -> dict:
    """K1's generation and launch parameters as the module sets them."""
    return dict(segment=VJP_SEGMENT, live=VJP_LIVE, threads=VJP_THREADS,
                min_blocks=VJP_MIN_BLOCKS)


# the bytes of K1's memory (stored values, choice words, the handover
# array: VjpPlan.k1_lane_bytes a lane) one launch uses: a VJP over more
# lanes runs in chunks within this
VJP_BYTES = 16 << 30


def vjp_chunk(plan: vp.VjpPlan, n: int) -> int:
    """Lanes of one K1 launch over ``n`` lanes (a whole number of the
    layout's lane blocks unless it is all of them)."""
    c = VJP_BYTES // max(plan.k1_lane_bytes, 4)
    return max(vp.LANE_BLOCK, min(n, c - c % vp.LANE_BLOCK))


def _form_tag(e) -> str:
    """The form of a library: a :class:`_Kernel`'s, else serial."""
    return e.form.tag if isinstance(e, _Kernel) else "serial"


# fields of mpr_unrolled_info (csrc/unrolled.cuh), in order
INFO_FIELDS = ("blocks_per_sm", "sms", "threads", "block_lanes",
               "registers", "local_bytes", "shared_bytes")


def kernel_info(kern) -> dict:
    """A built lanes or split library's launch facts on the current
    device (:data:`INFO_FIELDS`): the resident blocks an SM the occupancy
    query gives at its registers, the SMs, its block, the lanes a block
    takes, and its registers, local and static shared bytes."""
    build_all([kern])
    out = (ctypes.c_int * len(INFO_FIELDS))()
    err = _libs[kern.key].mpr_unrolled_info(ctypes.addressof(out))
    if err:
        raise RuntimeError(f"mpr_unrolled_info failed: CUDA error {err}")
    return dict(zip(INFO_FIELDS, list(out)))


def _lib_path(key: str) -> Path:
    return UNROLLED_ROOT / key / "libunrolled.so"


def build_all(evals) -> None:
    """Make sure every evaluator in ``evals`` has its libraries (each
    form :meth:`UnrolledEval.kernels` lists; a :class:`_Kernel` stands for
    its own form): the missing ones are generated and compiled by nvcc
    processes all started at once, then every library is loaded.  Each
    build's seconds run from its start to its own end.  A failed build
    raises with nvcc's output; nothing falls back."""
    with _lock:
        todo = [k for e in evals for k in e.kernels() if k.key not in _libs]
        starts, procs = {}, []
        seen = set()
        for e in todo:
            out = _lib_path(e.key)
            if out.exists() or e.key in seen:
                continue
            seen.add(e.key)
            out.parent.mkdir(parents=True, exist_ok=True)
            src = out.parent / "kernel.cu"
            src.write_text(e.source())
            tmp = out.parent / f"tmp{os.getpid()}.so"
            log = open(out.parent / f"tmp{os.getpid()}.log", "w+")
            starts[e.key] = time.perf_counter()
            procs.append((e, out, tmp, log, subprocess.Popen(
                [build._nvcc(), *_nvcc_flags(), "-I", str(build.CSRC),
                 "-shared", "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT)))
        failed, ends = [], {}
        try:
            while len(ends) < len(procs):
                for e, *_, p in procs:
                    if e.key not in ends and p.poll() is not None:
                        ends[e.key] = time.perf_counter()
                time.sleep(0.02)
            for e, out, tmp, log, p in procs:
                rc = p.wait()
                log.seek(0)
                text = log.read()
                secs = ends[e.key] - starts[e.key]
                if rc:
                    failed.append(f"{e.kind} evaluator {e.key}:\n{text}")
                    continue
                (out.parent / "build.log").write_text(text)
                (out.parent / "seconds").write_text(f"{secs:.3f}\n")
                os.replace(tmp, out)
                BUILDS[e.key] = {"kind": e.kind, "clauses": e.tape.length,
                                 "form": _form_tag(e), "seconds": secs,
                                 "log": text, "compiled": True}
        finally:
            for e, out, tmp, log, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
                Path(log.name).unlink(missing_ok=True)
                tmp.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed on a generated kernel: "
                               + "\n".join(failed))
        for e in todo:
            if e.key in _libs:
                continue
            out = _lib_path(e.key)
            if e.key not in BUILDS:
                log = out.parent / "build.log"
                secs = out.parent / "seconds"
                BUILDS[e.key] = {
                    "kind": e.kind, "clauses": e.tape.length,
                    "form": _form_tag(e),
                    "seconds": float(secs.read_text()) if secs.exists()
                    else 0.0,
                    "log": log.read_text() if log.exists() else "",
                    "compiled": False}
            handle = ctypes.CDLL(str(out))
            entries = _ENTRIES.get(e.kind, [("mpr_unrolled", _SIGNATURE)])
            if _form_tag(e) != "serial":
                entries = entries + [("mpr_unrolled_info",
                                      [ctypes.c_void_p])]
            for entry, sig in entries:
                fn = getattr(handle, entry)
                fn.argtypes = sig
                fn.restype = ctypes.c_int
            _libs[e.key] = handle


# ---------------------------------------------------------------------------
# The evaluators and their wrappers
# ---------------------------------------------------------------------------

def _as_lanes(vals, dev=None):
    ts = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in vals]
    return torch.broadcast_tensors(*ts)


class UnrolledEval:
    """One semantics of one tape: call it like the JAX package's builder
    result.  CPU inputs run :meth:`plain`; CUDA inputs launch the
    generated kernel (built at first use) through the semantics' wrapper
    (:func:`unrolled_float`, :func:`unrolled_interval`,
    :func:`unrolled_deriv`), or raise."""

    def __init__(self, tape: Tape, kind: str, take_imms: bool):
        self.tape = tape
        self.kind = kind
        self.take_imms = bool(take_imms)
        # config flags latch when the evaluator is built, as in the JAX
        # package (the renderer's key includes them)
        self.flags = _flags()
        self.key = f"{kind}-{structure_key(tape, self.take_imms, self.flags)}"

    def source(self, form: ln.UnrolledLaunch = None) -> str:
        """The CUDA source of ``form`` (default: the lanes form the
        picker takes for a float, interval or deriv evaluator)."""
        if self.kind == "vjp":
            return generate_vjp(self.tape, self.flags, self.plan, self.seg,
                                self.shape)
        if self.kind == "vjpf":
            return generate_vjp_fwd(self.tape, self.flags, self.plan)
        return generate(self.tape, self.kind, self.take_imms, self.flags,
                        form or ln.unrolled_defaults(self.kind,
                                                     self.short)[-1])

    def kernel(self, form: ln.UnrolledLaunch):
        """The library of ``form``: the evaluator itself for a serial-only
        kind, else a :class:`_Kernel` (made once a form)."""
        ln.check_unrolled_launch(form, self.kind)
        if self.kind not in ln.UNROLLED_KS:
            return self
        got = self.__dict__.setdefault("_kernels", {})
        if form.tag not in got:
            got[form.tag] = _Kernel(self, form)
        return got[form.tag]

    def kernels(self) -> list:
        """The libraries of the forms the launch picker may choose (what
        :func:`build_all` builds for the evaluator)."""
        return [self.kernel(f)
                for f in ln.unrolled_defaults(self.kind, self.short)]

    @property
    def short(self) -> bool:
        """A float, interval or deriv tape bound by its lanes' bytes: at
        most ``launch.OPS_PER_BYTE`` float operations a byte a lane moves
        (its ``N_IN`` inputs and ``N_OUT`` outputs)."""
        if self.kind not in ln.UNROLLED_KS:
            return False
        if getattr(self, "_short", None) is None:
            self._short = up.float_ops(self.program()) <= (
                ln.OPS_PER_BYTE * 4 * (N_IN[self.kind] + N_OUT[self.kind]))
        return self._short

    def launch(self, n: int) -> ln.UnrolledLaunch:
        """The form the picker takes for a launch over ``n`` lanes."""
        return ln.unrolled_launch(n, self.kind, self.short)

    def program(self) -> up.Program:
        """The statements of the walk (``ops/unrolled_plan.py``)."""
        if getattr(self, "_program", None) is None:
            self._program = program(self.tape, self.kind, self.take_imms,
                                    self.flags)
        return self._program

    def _imms_list(self, imms):
        if self.take_imms and imms is not None:
            return [imms[t] for t in range(self.tape.length)]
        if self.take_imms:
            t = torch.as_tensor(self.tape.imms, dtype=torch.float32)
            return [t[k] for k in range(self.tape.length)]
        return [float(v) for v in self.tape.imms]

    def plain(self, *args, imms=None):
        """The torch walk on the inputs' device (differentiable in
        ``imms`` under ``take_imms``)."""
        lanes = _as_lanes(args, args[0].device
                          if torch.is_tensor(args[0]) else None)
        if imms is not None and self.take_imms:
            imms = torch.as_tensor(imms, dtype=torch.float32,
                                   device=lanes[0].device)
        iv = self._imms_list(imms)
        if iv and torch.is_tensor(iv[0]):
            iv = [v.to(lanes[0].device) for v in iv]
        K = _TorchOps(self.flags["fast_transcendentals"])
        sem = _sem(self.kind, K, self.flags)
        if self.kind == "interval":
            x, y, z = (lanes[0], lanes[1]), (lanes[2], lanes[3]), (
                lanes[4], lanes[5])
        else:
            x, y, z = lanes
        return _walk(self.tape, sem, x, y, z, iv)

    def __call__(self, *args, imms=None):
        raise NotImplementedError


class _Kernel:
    """One form (``form``, an ``UnrolledLaunch``) of a float, interval or
    deriv evaluator ``ev``: a library of its own, keyed by the evaluator's key
    and the form."""

    def __init__(self, ev: UnrolledEval, form: ln.UnrolledLaunch):
        self.ev, self.form = ev, form
        self.kind, self.tape = ev.kind, ev.tape
        self.key = f"{ev.key}-{form.tag}"

    def source(self) -> str:
        return generate(self.tape, self.kind, self.ev.take_imms,
                        self.ev.flags, self.form)

    def kernels(self) -> list:
        return [self]


class _FloatEval(UnrolledEval):
    def __call__(self, x, y, z=None, imms=None, launch=None):
        if z is None:
            z = torch.zeros_like(torch.as_tensor(x, dtype=torch.float32))
        return _module.unrolled_float(self, x, y, z, imms=imms,
                                      launch=launch)

    @property
    def vjp(self) -> "_VjpEval":
        """Kernel K1's evaluators (imm-input evaluators only), made at the
        first use."""
        if not self.take_imms:
            raise RuntimeError("a baked float evaluator has no imms to "
                               "differentiate: build_float(tape, "
                               "take_imms=True)")
        if getattr(self, "_vjp", None) is None:
            self._vjp = _VjpEval(self)
        return self._vjp


class _VjpEval:
    """Kernel K1 of one float evaluator: its storage plan ``plan``
    (``ops/vjp_plan.py``), its forward half ``fwd`` (kind ``vjpf``) and
    the segments of its reverse half ``segments`` (kind ``vjp``, one
    generated kernel each, built in parallel)."""

    def __init__(self, f: "_FloatEval"):
        self.tape, self.flags, self.take_imms = f.tape, f.flags, True
        # the module's parameters, latched as the config flags are
        self.shape = sh = _vjp_shape()
        self.plan = vp.plan_of_tape(self.tape, sh["segment"], sh["live"])
        base = f.key[len("float-"):]

        def half(kind, key, seg=None):
            ev = UnrolledEval(self.tape, kind, True)
            ev.flags, ev.key, ev.seg, ev.plan = self.flags, key, seg, self.plan
            ev.shape = sh
            return ev
        tag = "".join(f"{k[0]}{v}" for k, v in sh.items())
        self.fwd = half("vjpf", f"vjpf-{base}")
        self.segments = [half("vjp", f"vjp{tag}-{k}-{base}", seg)
                         for k, seg in enumerate(self.plan.segments)]
        self.evals = [self.fwd] + self.segments

    def plain(self, *args, imms=None):
        """The float evaluator's plain walk (what K1 differentiates)."""
        return UnrolledEval.plain(self.fwd, *args, imms=imms)


class _IntervalEval(UnrolledEval):
    def __call__(self, xl, xh, yl, yh, zl, zh, imms=None, launch=None):
        return _module.unrolled_interval(self, xl, xh, yl, yh, zl, zh,
                                         imms=imms, launch=launch)


class _DerivEval(UnrolledEval):
    def __call__(self, x, y, z=None, imms=None, launch=None):
        if z is None:
            z = torch.zeros_like(torch.as_tensor(x, dtype=torch.float32))
        return _module.unrolled_deriv(self, x, y, z, imms=imms,
                                      launch=launch)


def _on_cuda(args) -> bool:
    devs = {a.device for a in args if torch.is_tensor(a)}
    if any(d.type == "cuda" for d in devs):
        if len(devs) != 1:
            raise ValueError(f"evaluator inputs on several devices: {devs}")
        return True
    return False


def _run(ev: UnrolledEval, args, imms, launch=None):
    """Launch ``ev``'s kernel on CUDA inputs: broadcast, flatten, check,
    pick the form (``launch`` forces one), build at first use, launch on
    the current stream.  Returns the outputs in the inputs' broadcast
    shape."""
    dev = next(a.device for a in args if torch.is_tensor(a))
    lanes = [t.reshape(-1).contiguous() for t in _as_lanes(args, dev)]
    shape = torch.broadcast_shapes(*(torch.as_tensor(a).shape
                                     for a in args))
    n = lanes[0].shape[0]
    if ev.take_imms:
        if imms is None:
            imms = torch.as_tensor(ev.tape.imms, device=dev)
        if not torch.is_tensor(imms):
            imms = torch.as_tensor(np.asarray(imms, np.float32), device=dev)
        if imms.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"the unrolled {ev.kind} kernel is forward-only: only the "
                "imm-input float evaluator differentiates in imms on the "
                "card (kernel K1); the plain version (UnrolledEval.plain) "
                "differentiates everywhere")
        if imms.device != dev or imms.dtype != torch.float32:
            raise ValueError(f"imms: {imms.dtype} on {imms.device}, want "
                             f"float32 on {dev}")
        if imms.shape[0] < ev.tape.length:
            raise ValueError(f"imms: {imms.shape[0]} values for a "
                             f"{ev.tape.length}-clause tape")
        imms = imms.contiguous()
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(N_OUT[ev.kind])]
    if n:
        form = (ev.launch(n) if launch is None
                else ln.check_unrolled_launch(launch, ev.kind))
        build_all([ev.kernel(form)])
        _launch(ev, lanes, imms, outs, form)
    outs = [t.reshape(shape) for t in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def _launch(ev: UnrolledEval, lanes, imms, outs, form=None):
    """The launch alone: ``ev``'s built kernel of ``form`` (default: the
    picker's) on flat contiguous f32 ``lanes`` of one CUDA device (and
    ``imms`` under ``take_imms``) into the allocated flat ``outs``, on the
    current stream; raises on a CUDA error.  The serial form is launched
    a thread a lane; the lanes and split forms size their own grid."""
    n = lanes[0].shape[0]
    form = form or ev.launch(n)
    blocks = threads = 0
    if form.form == "serial":
        blocks, threads = -(-n // ln.UNROLLED_THREADS), ln.UNROLLED_THREADS
    ptrs = [t.data_ptr() for t in lanes] + [None] * (6 - len(lanes))
    optrs = [t.data_ptr() for t in outs] + [None] * (4 - len(outs))
    with torch.cuda.device(lanes[0].device):
        err = _libs[ev.kernel(form).key].mpr_unrolled(
            *ptrs, imms.data_ptr() if ev.take_imms else None, *optrs,
            n, blocks, threads, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"unrolled {ev.kind} kernel failed: CUDA "
                           f"error {err}")


def unrolled_float(ev, x, y, z, imms=None, launch=None):
    """The float evaluator's kernel on CUDA inputs (counted in
    ``unrolled_float.launches``), its plain version on CPU inputs.  On
    CUDA, imm-input evaluators with ``imms`` that require grad go through
    :class:`_FloatFn` (backward: kernel K1).  ``launch`` (an
    ``UnrolledLaunch``) forces a form (tests and chip_smoke.py)."""
    if not _on_cuda((x, y, z, imms)):
        return ev.plain(x, y, z, imms=imms)
    if any(torch.is_tensor(a) and a.requires_grad for a in (x, y, z)):
        raise RuntimeError("the unrolled kernels differentiate in imms "
                           "only: coordinate gradients take the plain "
                           "version (UnrolledEval.plain)")
    if (ev.take_imms and torch.is_tensor(imms) and imms.requires_grad
            and torch.is_grad_enabled()):
        return _FloatFn.apply(imms, x, y, z, ev, launch)
    out = _run(ev, (x, y, z), imms, launch)
    if out.numel():
        _unrolled_float.launches += 1
    return out


class _FloatFn(torch.autograd.Function):
    """The imm-input float evaluator on the card, differentiable in
    ``imms``: forward the float kernel, backward kernel K1."""

    @staticmethod
    def forward(ctx, imms, x, y, z, ev, launch):
        ctx.ev = ev
        ctx.save_for_backward(imms, *(torch.as_tensor(a) for a in (x, y, z)))
        out = _run(ev, (x, y, z), imms.detach(), launch)
        if out.numel():
            _unrolled_float.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        imms, x, y, z = ctx.saved_tensors
        grad = _module.unrolled_float_vjp(ctx.ev.vjp, x, y, z, g, imms)
        full = torch.zeros_like(imms)
        full[:grad.shape[0]] = grad
        return full, None, None, None, None, None


def unrolled_float_vjp(ev, x, y, z, g, imms):
    """Kernel K1 on CUDA inputs (counted in ``unrolled_float_vjp.launches``,
    one a chunk of lanes: the forward half storing the plan's values and
    choice words, the reverse half's segments last first, the sum over
    blocks): d(sum(g * f(x, y, z)))/d(imms[t]) for t < the tape's length,
    ``ev`` a float evaluator's ``.vjp``; on CPU inputs its plain version,
    autograd through the plain walk."""
    T = ev.tape.length
    if not _on_cuda((x, y, z, g, imms)):
        im = torch.as_tensor(imms, dtype=torch.float32).detach()
        im = im[:T].clone().requires_grad_(True)
        with torch.enable_grad():
            v = ev.plain(x, y, z, imms=im)
            out, = torch.autograd.grad(v, im, torch.as_tensor(g).expand_as(v),
                                       allow_unused=True)
        return torch.zeros(T, dtype=torch.float32) if out is None else out
    dev = next(a.device for a in (x, y, z, g) if torch.is_tensor(a))
    lanes = [t.reshape(-1).detach().contiguous()
             for t in _as_lanes((x, y, z, g), dev)]
    imms = torch.as_tensor(imms, dtype=torch.float32, device=dev).detach()
    if imms.shape[0] < T:
        raise ValueError(f"imms: {imms.shape[0]} values for a {T}-clause "
                         "tape")
    imms = imms.contiguous()
    n = lanes[0].shape[0]
    grad = torch.zeros(T, dtype=torch.float32, device=dev)
    if n == 0 or T == 0:
        return grad
    build_all(ev.evals)
    plan, sh = ev.plan, ev.shape
    chunk = vjp_chunk(plan, n)
    vals, ch, hand = vp.workspace("K1", dev, [
        (vp.blocked_size(plan.n_vals, chunk), torch.float32),
        (vp.blocked_size(plan.n_words, chunk), torch.int32),
        (vp.blocked_size(plan.n_handover, chunk), torch.float32)])
    for c0 in range(0, n, chunk):
        m = min(n, c0 + chunk) - c0
        part = [t[c0:c0 + m] for t in lanes]
        _launch(ev.fwd, part[:3], imms, [vals, ch])
        blocks = min(VJP_WAVES * ln.SM_COUNT * sh["min_blocks"],
                     -(-m // sh["threads"]))
        partials = torch.empty(blocks, T, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        with torch.cuda.device(dev):
            for seg in reversed(ev.segments):
                err = _libs[seg.key].mpr_unrolled_vjp(
                    *(t.data_ptr() for t in part), imms.data_ptr(),
                    vals.data_ptr(), ch.data_ptr(), hand.data_ptr(),
                    partials.data_ptr(), m, T, blocks, sh["threads"], stream)
                if err:
                    break
            else:
                err = _libs[ev.segments[0].key].mpr_unrolled_vjp_reduce(
                    partials.data_ptr(), grad.data_ptr(), T, blocks,
                    int(c0 > 0), stream)
        if err:
            raise RuntimeError(f"unrolled VJP kernel failed: CUDA error "
                               f"{err}")
        _unrolled_float_vjp.launches += 1
    return grad


def unrolled_interval(ev, xl, xh, yl, yh, zl, zh, imms=None, launch=None):
    """The interval evaluator's kernel on CUDA inputs (counted in
    ``unrolled_interval.launches``), its plain version on CPU inputs;
    ``launch`` forces a form, as for :func:`unrolled_float`."""
    args = (xl, xh, yl, yh, zl, zh)
    if not _on_cuda(args + (imms,)):
        return ev.plain(*args, imms=imms)
    out = _run(ev, args, imms, launch)
    if out[0].numel():
        _unrolled_interval.launches += 1
    return out


def unrolled_deriv(ev, x, y, z, imms=None, launch=None):
    """The deriv evaluator's kernel on CUDA inputs (counted in
    ``unrolled_deriv.launches``), its plain version on CPU inputs;
    ``launch`` forces a form, as for :func:`unrolled_float`."""
    if not _on_cuda((x, y, z, imms)):
        return ev.plain(x, y, z, imms=imms)
    out = _run(ev, (x, y, z), imms, launch)
    if out[0].numel():
        _unrolled_deriv.launches += 1
    return out


unrolled_float.launches = 0
unrolled_interval.launches = 0
unrolled_deriv.launches = 0
unrolled_float_vjp.launches = 0
# the counters' homes, kept if a module attribute is rebound (a recorder)
_unrolled_float = unrolled_float
_unrolled_float_vjp = unrolled_float_vjp
_unrolled_interval = unrolled_interval
_unrolled_deriv = unrolled_deriv
_module = sys.modules[__name__]


def build_float(tape: Tape, take_imms: bool = False) -> Callable:
    """``f(x, y, z=None, imms=None) -> v``.  With ``take_imms`` the
    immediates are an input (default: the tape's own), differentiable in
    them: on the CPU through the plain walk, on the card through kernel
    K1 (:class:`_FloatFn`)."""
    return _FloatEval(tape, "float", take_imms)


def build_interval(tape: Tape, take_imms: bool = False) -> Callable:
    """``fi(xl, xh, yl, yh, zl, zh, imms=None) -> (lo, hi)``."""
    return _IntervalEval(tape, "interval", take_imms)


def build_deriv(tape: Tape, take_imms: bool = False) -> Callable:
    """``fd(x, y, z=None, imms=None) -> (v, dv/dx, dv/dy, dv/dz)`` with unit
    seeds on the axis inputs."""
    return _DerivEval(tape, "deriv", take_imms)
