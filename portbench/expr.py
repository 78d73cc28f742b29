"""The benchmark's own expression of a scene: a hash-consed DAG.

A scene builder (``scenes/<name>.py``) writes its shape as an ``Expr``.
Two readers take it from there and share nothing else:

* ``program.py`` rebuilds it node by node as the port's frontend ``Tree``
  and compiles it (the system under test);
* ``reference/`` evaluates it densely in plain PyTorch (the yardstick).

So the expression carries the same construction rules as the port's
frontend, and nothing of the port's code: constants are float32 values;
an operator on two constants folds (in float64, then rounded to float32,
as numpy computes it); ``x + 0``, ``x - 0``, ``0 - x``, ``x * 0``,
``x * 1`` and ``x / 1`` fold away; a unary operator on a constant folds;
structurally equal nodes are one node; ``remap`` substitutes the axes
without folding.  The port's ``Tree`` follows the same rules, so a scene
built here turns into the very ``Tree`` its own shape library builds.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

UNARY = ("square", "sqrt", "neg", "sin", "cos", "abs")
BINARY = ("add", "sub", "mul", "div", "min", "max")


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


class Expr:
    """An immutable expression node; equal structure is the same object."""

    __slots__ = ("op", "args", "value", "__weakref__")
    _intern = {}
    _lock = threading.Lock()

    def __new__(cls, op: str, *args: "Expr", value: float = 0.0):
        if op == "const":
            value = f32(value)
            key = (op, value)
        elif op in UNARY + BINARY:
            if len(args) != (1 if op in UNARY else 2):
                raise ValueError(f"{op} takes {1 if op in UNARY else 2} "
                                 "operands")
            key = (op,) + tuple(id(a) for a in args)
        elif op in ("x", "y", "z"):
            key = (op,)
        else:
            raise ValueError(f"unknown op {op!r}")
        with cls._lock:
            node = cls._intern.get(key)
            if node is None:
                node = object.__new__(cls)
                node.op = op
                node.args = args
                node.value = value if op == "const" else None
                cls._intern[key] = node
            return node

    # -- traversal ---------------------------------------------------------

    def nodes(self):
        """Every node once, operands before the nodes that read them (a
        post-order walk, operands left to right)."""
        seen, out, stack = set(), [], [(self, False)]
        while stack:
            node, done = stack.pop()
            if id(node) in seen:
                continue
            if done:
                seen.add(id(node))
                out.append(node)
            else:
                stack.append((node, True))
                for a in reversed(node.args):
                    if id(a) not in seen:
                        stack.append((a, False))
        return out

    def remap(self, x: "Expr", y: "Expr", z: "Expr") -> "Expr":
        """The axes substituted, nothing folded."""
        memo = {}
        for n in self.nodes():
            if n.op == "x":
                memo[id(n)] = x
            elif n.op == "y":
                memo[id(n)] = y
            elif n.op == "z":
                memo[id(n)] = z
            elif n.args:
                memo[id(n)] = Expr(n.op, *(memo[id(a)] for a in n.args))
            else:
                memo[id(n)] = n
        return memo[id(self)]

    def map_constants(self, fn) -> "Expr":
        """The expression with each constant ``c`` replaced by
        ``fn(index, c)``, constants numbered in :meth:`nodes` order; the
        nodes above are rebuilt without folding, so the structure stays."""
        memo, k = {}, 0
        for n in self.nodes():
            if n.op == "const":
                memo[id(n)] = Expr("const", value=fn(k, n.value))
                k += 1
            elif n.args:
                memo[id(n)] = Expr(n.op, *(memo[id(a)] for a in n.args))
            else:
                memo[id(n)] = n
        return memo[id(self)]

    # -- operators -----------------------------------------------------------

    @staticmethod
    def wrap(v) -> "Expr":
        return v if isinstance(v, Expr) else Expr("const", value=v)

    def __add__(self, o): return binary("add", self, o)
    def __radd__(self, o): return binary("add", o, self)
    def __sub__(self, o): return binary("sub", self, o)
    def __rsub__(self, o): return binary("sub", o, self)
    def __mul__(self, o): return binary("mul", self, o)
    def __rmul__(self, o): return binary("mul", o, self)
    def __truediv__(self, o): return binary("div", self, o)
    def __rtruediv__(self, o): return binary("div", o, self)
    def __neg__(self): return unary("neg", self)
    def __abs__(self): return unary("abs", self)

    def __repr__(self):
        return (f"Expr({self.value})" if self.op == "const"
                else f"Expr<{self.op}>")


_FOLD2 = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
          "mul": lambda a, b: a * b, "div": np.divide, "min": np.minimum,
          "max": np.maximum}
_FOLD1 = {"square": lambda v: v * v, "sqrt": np.sqrt, "neg": lambda v: -v,
          "sin": np.sin, "cos": np.cos, "abs": abs}


def binary(op: str, a, b) -> Expr:
    a, b = Expr.wrap(a), Expr.wrap(b)
    if a.op == "const" and b.op == "const":
        with np.errstate(all="ignore"):
            return Expr("const", value=float(_FOLD2[op](a.value, b.value)))
    ca = a.value if a.op == "const" else None
    cb = b.value if b.op == "const" else None
    if op == "add":
        if ca == 0.0:
            return b
        if cb == 0.0:
            return a
    elif op == "sub":
        if cb == 0.0:
            return a
        if ca == 0.0:
            return Expr("neg", b)
    elif op == "mul":
        if ca == 0.0 or ca == 1.0:
            return a if ca == 0.0 else b
        if cb == 0.0 or cb == 1.0:
            return b if cb == 0.0 else a
    elif op == "div" and cb == 1.0:
        return a
    return Expr(op, a, b)


def unary(op: str, a) -> Expr:
    a = Expr.wrap(a)
    if a.op == "const":
        with np.errstate(all="ignore"):
            return Expr("const", value=float(_FOLD1[op](a.value)))
    return Expr(op, a)


def x() -> Expr: return Expr("x")
def y() -> Expr: return Expr("y")
def z() -> Expr: return Expr("z")
def square(a) -> Expr: return unary("square", a)
def sqrt(a) -> Expr: return unary("sqrt", a)
def sin(a) -> Expr: return unary("sin", a)
def cos(a) -> Expr: return unary("cos", a)
def minimum(a, b) -> Expr: return binary("min", a, b)
def maximum(a, b) -> Expr: return binary("max", a, b)


def union(*shapes):
    out = shapes[0]
    for s in shapes[1:]:
        out = minimum(out, s)
    return out


def intersection(*shapes):
    out = shapes[0]
    for s in shapes[1:]:
        out = maximum(out, s)
    return out


def perturbed(e: Expr, seed, share: float) -> Expr:
    """``e`` with every constant scaled by ``1 + share * N(0, 1)``, one
    draw a constant from ``seed`` (an int or a sequence of ints, as numpy's
    ``default_rng`` takes it), in :meth:`Expr.nodes` order."""
    draws = np.random.default_rng(seed).standard_normal(
        sum(n.op == "const" for n in e.nodes()))
    return e.map_constants(lambda k, c: c * (1.0 + share * float(draws[k])))

