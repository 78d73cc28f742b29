"""Expression frontend: hash-consed closed-form implicit-surface trees.

Replacement for ``libfive::Tree`` as used by the reference
(``reference/src/tape.cpp:21-228`` consumes the tree API; the libfive
submodule itself is external).  We support the op set the reference tape
compiler accepts (``reference/inc/gpu_opcode.hpp:18-56``) plus the
libfive ops it rejects (TAN, RECIP, ATAN2, POW, NTH_ROOT, MOD, NANFILL,
COMPARE) so that ``.frep`` archives deserialize losslessly.  Where the
reference errors on ALL of those (``reference/src/tape.cpp:182-196``),
:func:`lower_extended` rewrites the expressible ones (tan/recip/atan2/pow/
nth-root/compare) into supported clauses at compile time; only MOD/NANFILL/
VAR_FREE still reject.

Design notes:
  * Nodes are immutable and hash-consed (a global intern table), mirroring
    libfive's ``Cache`` dedup so common subexpressions share ids.  Ids are
    dense ints -> arrays index naturally.
  * No torch / no CUDA anywhere; this layer is pure Python + NumPy scalars
    (a copy of ``mpr_tpu.frontend.tree``, kept so the port imports nothing
    of the JAX package).
"""

from __future__ import annotations

import math
import struct
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Op names.  These follow libfive's naming (see SURVEY.md section 2.1); the
# GPU-facing opcode enum lives in mpr_tpu_torch/tape/opcodes.py.
# ---------------------------------------------------------------------------

CONSTANT = "const"
VAR_X = "var-x"
VAR_Y = "var-y"
VAR_Z = "var-z"
VAR_FREE = "var-free"
# A named free parameter with a default value — the analog of libfive's
# CONST_VAR (a constant marked as a draggable variable; the reference GUI
# extracts these from script results, reference/gui/interpreter.cpp:
# 125-148).  Compiles to a COPY_IMM clause whose immediate is the value,
# so parameter edits are pure data (no recompile) in every engine that
# treats ``Tape.imms`` as input.
PARAM = "param"

UNARY_OPS = (
    "square", "sqrt", "neg", "sin", "cos", "asin", "acos", "atan",
    "exp", "abs", "log",
    # accepted by the frontend, rejected by the tape compiler (parity with
    # reference/src/tape.cpp:182-196):
    "tan", "recip",
)

BINARY_OPS = (
    "add", "mul", "min", "max", "sub", "div",
    # fused compound ops, produced by tape/fuse.py (not user-facing):
    "hypot", "addsq",
    # frontend-only (tape compiler rejects, like the reference):
    "atan2", "pow", "nth-root", "mod", "nanfill", "compare",
)

LEAF_OPS = (CONSTANT, VAR_X, VAR_Y, VAR_Z, VAR_FREE, PARAM)

_ALL_OPS = set(LEAF_OPS) | set(UNARY_OPS) | set(BINARY_OPS)

_COMMUTATIVE = {"add", "mul", "min", "max"}

# Ops rewritten into supported clauses by lower_extended (defined at the
# bottom of this module); tracked as a constructor flag so compile_tree's
# lowering check is O(1), not a DFS per compile.
_LOWERABLE = {"tan", "recip", "atan2", "pow", "nth-root", "compare"}


class Tree:
    """An immutable, hash-consed expression node.

    Equality is identity (like ``libfive::Tree::Id``); the intern table
    guarantees structurally equal nodes are the same object.
    """

    __slots__ = ("op", "lhs", "rhs", "value", "name", "_id", "_ext",
                 "_param", "__weakref__")

    _intern: Dict[tuple, "Tree"] = {}
    _lock = threading.Lock()
    _next_id = [0]

    def __new__(cls, op: str, lhs: Optional["Tree"] = None,
                rhs: Optional["Tree"] = None, value: float = 0.0,
                name: Optional[str] = None):
        if op not in _ALL_OPS:
            raise ValueError(f"unknown op {op!r}")
        if op == CONSTANT:
            # Canonicalize constants through float32 like the reference's
            # float-valued immediates (reference/inc/clause.hpp:22).
            value = struct.unpack("<f", struct.pack("<f", float(value)))[0]
            key = (op, value)
        elif op == PARAM:
            if not name:
                raise ValueError("param nodes need a name")
            value = struct.unpack("<f", struct.pack("<f", float(value)))[0]
            key = (op, name, value)
        elif op in UNARY_OPS:
            key = (op, id(lhs))
        elif op in BINARY_OPS:
            key = (op, id(lhs), id(rhs))
        else:
            key = (op,)
        with cls._lock:
            node = cls._intern.get(key)
            if node is not None:
                return node
            node = object.__new__(cls)
            node.op = op
            node.lhs = lhs
            node.rhs = rhs
            node.value = value if op in (CONSTANT, PARAM) else None
            node.name = name if op == PARAM else None
            node._id = cls._next_id[0]
            node._ext = (op in _LOWERABLE
                         or (lhs is not None and lhs._ext)
                         or (rhs is not None and rhs._ext))
            node._param = (op == PARAM
                           or (lhs is not None and lhs._param)
                           or (rhs is not None and rhs._param))
            cls._next_id[0] += 1
            cls._intern[key] = node
            return node

    # -- structural helpers --------------------------------------------------

    @property
    def id(self) -> int:
        return self._id

    def children(self) -> Tuple["Tree", ...]:
        if self.op in BINARY_OPS:
            return (self.lhs, self.rhs)
        if self.op in UNARY_OPS:
            return (self.lhs,)
        return ()

    def ordered_dfs(self) -> List["Tree"]:
        """Topological order with children before parents, each node once.

        Mirrors ``libfive::Tree::orderedDfs`` as consumed by the reference
        tape compiler (reference/src/tape.cpp:25): a deterministic
        post-order DFS over the DAG.
        """
        seen = set()
        out: List[Tree] = []
        stack: List[Tuple[Tree, bool]] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if node._id in seen:
                continue
            if expanded:
                seen.add(node._id)
                out.append(node)
            else:
                stack.append((node, True))
                for c in reversed(node.children()):
                    if c._id not in seen:
                        stack.append((c, False))
        return out

    def remap(self, x: "Tree", y: "Tree", z: "Tree") -> "Tree":
        """Substitute the axis variables (libfive ``Tree::remap`` analog)."""
        memo: Dict[int, Tree] = {}

        order = self.ordered_dfs()
        for node in order:
            if node.op == VAR_X:
                memo[node._id] = x
            elif node.op == VAR_Y:
                memo[node._id] = y
            elif node.op == VAR_Z:
                memo[node._id] = z
            elif node.op in UNARY_OPS:
                memo[node._id] = Tree(node.op, memo[node.lhs._id])
            elif node.op in BINARY_OPS:
                memo[node._id] = Tree(node.op, memo[node.lhs._id],
                                      memo[node.rhs._id])
            else:
                memo[node._id] = node
        return memo[self._id]

    def __len__(self) -> int:
        return len(self.ordered_dfs())

    def __repr__(self) -> str:
        if self.op == CONSTANT:
            return f"Tree({self.value})"
        if self.op == PARAM:
            return f"Tree<param {self.name}={self.value}>"
        return f"Tree<{self.op}#{self._id}>"

    # -- operator overloads ---------------------------------------------------

    @staticmethod
    def wrap(v) -> "Tree":
        if isinstance(v, Tree):
            return v
        return Tree(CONSTANT, value=float(v))

    def __add__(self, o): return _binary("add", self, Tree.wrap(o))
    def __radd__(self, o): return _binary("add", Tree.wrap(o), self)
    def __mul__(self, o): return _binary("mul", self, Tree.wrap(o))
    def __rmul__(self, o): return _binary("mul", Tree.wrap(o), self)
    def __sub__(self, o): return _binary("sub", self, Tree.wrap(o))
    def __rsub__(self, o): return _binary("sub", Tree.wrap(o), self)
    def __truediv__(self, o): return _binary("div", self, Tree.wrap(o))
    def __rtruediv__(self, o): return _binary("div", Tree.wrap(o), self)
    def __neg__(self): return neg(self)          # folds constants
    def __abs__(self): return abs_(self)
    def __pow__(self, o): return _binary("pow", self, Tree.wrap(o))


def _binary(op: str, a: Tree, b: Tree) -> Tree:
    """Build a binary node with constant and identity folding.

    Mirrors libfive's ``Cache::checkCommutative``/``checkIdentity``: the
    reference's trees arrive pre-folded through the Cache, so folding here
    keeps our tapes structurally comparable.
    """
    if a.op == CONSTANT and b.op == CONSTANT:
        f = _FOLD.get(op)
        if f is not None:
            # total fold (numpy semantics: x/0 -> ±inf/nan) — a clause
            # with two constant operands has no register form, so the
            # fold must never fail (see _unary_fn)
            with np.errstate(all="ignore"):
                return Tree(CONSTANT, value=float(f(a.value, b.value)))
    # identity folding (libfive Cache::checkIdentity)
    if op == "add":
        if a.op == CONSTANT and a.value == 0.0:
            return b
        if b.op == CONSTANT and b.value == 0.0:
            return a
    elif op == "sub":
        if b.op == CONSTANT and b.value == 0.0:
            return a
        if a.op == CONSTANT and a.value == 0.0:
            return Tree("neg", b)
    elif op == "mul":
        if a.op == CONSTANT:
            if a.value == 0.0:
                return a
            if a.value == 1.0:
                return b
        if b.op == CONSTANT:
            if b.value == 0.0:
                return b
            if b.value == 1.0:
                return a
    elif op == "div":
        if b.op == CONSTANT and b.value == 1.0:
            return a
    return Tree(op, a, b)


_FOLD = {
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "sub": lambda a, b: a - b,
    "div": np.divide,
    # np.minimum/maximum, not Python min/max: NaN constants can reach a
    # binary fold now that unary folds are total (sqrt(-1) -> nan), and
    # Python's min(2.0, nan) == 2.0 while every evaluator (oracle and
    # kernels) propagates the NaN.
    "min": np.minimum,
    "max": np.maximum,
    "pow": np.power,
}


# ---------------------------------------------------------------------------
# Public constructors
# ---------------------------------------------------------------------------

def x() -> Tree: return Tree(VAR_X)
def y() -> Tree: return Tree(VAR_Y)
def z() -> Tree: return Tree(VAR_Z)
def const(v: float) -> Tree: return Tree(CONSTANT, value=v)


def var(name: str, value: float) -> Tree:
    """A named free parameter with a default value (libfive's CONST_VAR
    analog — the free variables the reference interpreter extracts from
    scripts, reference/gui/interpreter.cpp:125-148).  Participates
    in expressions like a constant but is never folded, so it survives to
    a tape clause: ``Tape.params[name]`` gives its imm indices and
    parameter edits are pure imm-vector data (no recompile in the
    interpreter engine, and the differentiable target for fitting)."""
    return Tree(PARAM, value=value, name=str(name))


def params_of(t: Tree) -> Dict[str, float]:
    """All named parameters reachable from ``t`` (name -> default value).
    A name bound at two different values (e.g. mid-edit) keeps the value
    of the LAST occurrence in DFS order."""
    out: Dict[str, float] = {}
    for n in t.ordered_dfs():
        if n.op == PARAM:
            out[n.name] = float(n.value)
    return out


def with_params(t: Tree, values: Dict[str, float]) -> Tree:
    """Rebuild ``t`` with the named parameters' default values replaced —
    bakes viewer slider edits back into the tree (e.g. before a .frep
    save).  Names absent from ``values`` are untouched."""
    memo: Dict[int, Tree] = {}
    for n in t.ordered_dfs():
        if n.op == PARAM and n.name in values:
            nn = Tree(PARAM, value=values[n.name], name=n.name)
            if nn is not n:
                memo[n._id] = nn
        elif n.children():
            kids = [memo.get(c._id, c) for c in n.children()]
            if any(k is not c for k, c in zip(kids, n.children())):
                memo[n._id] = (Tree(n.op, kids[0]) if len(kids) == 1
                               else Tree(n.op, kids[0], kids[1]))
    return memo.get(t._id, t)


def _unary_fn(op):
    def f(t: Tree) -> Tree:
        t = Tree.wrap(t)
        if t.op == CONSTANT:
            g = _UFOLD.get(op)
            if g is not None:
                # numpy semantics make the fold TOTAL (sqrt(-1) -> nan,
                # log(0) -> -inf, ...): exactly what the evaluators
                # would compute, and a constant operand must never
                # survive folding — the tape compiler has no register
                # form for it (clauses reference constants only through
                # the immediate field)
                with np.errstate(all="ignore"):
                    return Tree(CONSTANT, value=float(g(t.value)))
        return Tree(op, t)
    f.__name__ = op
    return f


_UFOLD = {
    "square": lambda v: v * v,
    "sqrt": np.sqrt,
    "neg": lambda v: -v,
    "sin": np.sin,
    "cos": np.cos,
    "asin": np.arcsin,
    "acos": np.arccos,
    "atan": np.arctan,
    "exp": np.exp,
    "abs": abs,
    "log": np.log,
    "tan": np.tan,
    "recip": lambda v: np.divide(1.0, v),
}

square = _unary_fn("square")
sqrt = _unary_fn("sqrt")
sin = _unary_fn("sin")
cos = _unary_fn("cos")
asin = _unary_fn("asin")
acos = _unary_fn("acos")
atan = _unary_fn("atan")
exp = _unary_fn("exp")
log = _unary_fn("log")
tan = _unary_fn("tan")
neg = _unary_fn("neg")
abs_ = _unary_fn("abs")


def minimum(a, b) -> Tree:
    return _binary("min", Tree.wrap(a), Tree.wrap(b))


def maximum(a, b) -> Tree:
    return _binary("max", Tree.wrap(a), Tree.wrap(b))


# ---------------------------------------------------------------------------
# Extended-op lowering
# ---------------------------------------------------------------------------

# _LOWERABLE (defined with the op tables above): libfive ops the reference
# tape compiler REJECTS ("Unimplemented opcode",
# reference/src/tape.cpp:182-196) but that are expressible in the
# supported clause algebra.  Lowering them (tape/tape.py::compile_tree calls
# lower_extended) means .frep archives using them load and render here,
# run on every engine (tapes only ever contain supported opcodes), and stay
# differentiable — where the reference errors out.

_UNARY_CTOR = {}  # filled below; op name -> folding constructor


def _int_pow(a: Tree, n: int) -> Tree:
    """a**n for integer n by repeated squaring (exact for negative bases,
    matching np.power; n == 0 -> 1.0 like np.power)."""
    if n == 0:
        return Tree(CONSTANT, value=1.0)
    if n < 0:
        return Tree(CONSTANT, value=1.0) / _int_pow(a, -n)
    r = None
    base = a
    while True:
        if n & 1:
            r = base if r is None else r * base
        n >>= 1
        if not n:
            return r
        base = base * base


def _lower_node(op: str, a: Tree, b: Optional[Tree]) -> Tree:
    if op == "tan":
        return sin(a) / cos(a)
    if op == "recip":
        return Tree(CONSTANT, value=1.0) / a
    if op == "pow":
        if b.op == CONSTANT and math.isfinite(b.value) \
                and float(b.value) == int(b.value) and abs(b.value) <= 64:
            return _int_pow(a, int(b.value))
        # general: exp(b*log a) — NaN for a<0 like np.power's float branch
        return exp(b * log(a))
    if op == "nth-root":
        if b.op == CONSTANT and b.value == 2.0:
            return sqrt(a)
        if b.op == CONSTANT and b.value == 4.0:
            return sqrt(sqrt(a))
        return exp(log(a) / b)            # NaN for a<0, like sqrt
    if op == "atan2":
        # half-angle form: atan2(y,x) = 2*atan(y / (hypot(x,y) + x)).
        # Exact everywhere except the closed negative-x half-line
        # (x<=0, y==0), where it yields NaN instead of ±pi — implicit
        # surfaces treat NaN as outside, so the branch cut renders as a
        # hairline seam (documented divergence; the reference simply
        # cannot compile atan2 at all).
        y_, x_ = a, b
        h = sqrt(square(x_) + square(y_))
        return Tree(CONSTANT, value=2.0) * atan(y_ / (h + x_))
    if op == "compare":
        # sign(a-b) in {-1, 0, +1}: clamp of a huge multiple — exact
        # outside a ~1e-38-wide band around equality, 0 exactly at a==b
        big = Tree(CONSTANT, value=1e38)
        return minimum(maximum((a - b) * big, Tree.wrap(-1.0)),
                       Tree.wrap(1.0))
    raise AssertionError(op)


def lower_extended(t: Tree) -> Tree:
    """Rewrite every lowerable extended op into supported clauses.

    Returns ``t`` itself when nothing needs rewriting (the common case:
    a cheap DFS scan, no reconstruction).  MOD/NANFILL (no floor /
    NaN-select in the clause algebra) and VAR_FREE still raise in the
    tape compiler, as in the reference."""
    if not t._ext:                       # O(1): flag set at construction
        return t
    order = t.ordered_dfs()
    memo: Dict[int, Tree] = {}

    def get(n: Tree) -> Tree:
        return memo.get(n._id, n)

    for n in order:
        if n.op in _LOWERABLE:
            b = get(n.rhs) if n.op in BINARY_OPS else None
            memo[n._id] = _lower_node(n.op, get(n.lhs), b)
        elif n.op in UNARY_OPS:
            a = get(n.lhs)
            if a is not n.lhs:
                memo[n._id] = _UNARY_CTOR[n.op](a)
        elif n.op in BINARY_OPS:
            a, b = get(n.lhs), get(n.rhs)
            if a is not n.lhs or b is not n.rhs:
                memo[n._id] = _binary(n.op, a, b)
    return get(t)


_UNARY_CTOR.update({
    "square": square, "sqrt": sqrt, "neg": neg, "sin": sin, "cos": cos,
    "asin": asin, "acos": acos, "atan": atan, "exp": exp, "abs": abs_,
    "log": log, "tan": tan, "recip": lambda a: Tree(CONSTANT, value=1.0) / a,
})


def atan2(y_, x_) -> Tree:
    """Two-argument arctangent (lowered at compile time — see
    lower_extended; NaN on the closed negative-x half-line)."""
    return _binary("atan2", Tree.wrap(y_), Tree.wrap(x_))


def pow_(a, b) -> Tree:
    return _binary("pow", Tree.wrap(a), Tree.wrap(b))


def nth_root(a, n) -> Tree:
    return _binary("nth-root", Tree.wrap(a), Tree.wrap(n))


def compare(a, b) -> Tree:
    """sign(a-b) in {-1, 0, +1} (lowered to a clamped huge multiple)."""
    return _binary("compare", Tree.wrap(a), Tree.wrap(b))


def recip(a) -> Tree:
    return _unary_fn("recip")(Tree.wrap(a))
