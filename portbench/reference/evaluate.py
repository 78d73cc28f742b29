"""Evaluate an ``Expr`` on tensors of coordinates, elementwise.

Each operator is the plain PyTorch one.  ``min`` and ``max`` pick an
operand with ``torch.where``, so a gradient reaches one side only, as in
the port's forward-mode normals.  With ``flip`` set, every ``min``,
``max`` and ``abs`` whose two candidates lie within ``flip`` of each other
takes the other side: at such a seam the surface has no single normal,
and either side's gradient is a correct one (``render.normals`` uses
both).
"""

from __future__ import annotations

import torch

from ..expr import Expr


def leaf_params(e: Expr):
    """The fit's parameters: one for each node with a constant operand, as
    a compiled tape has one immediate a clause.  Returns (list of
    (node id, operand index), float values)."""
    where, vals = [], []
    for n in e.nodes():
        for k, a in enumerate(n.args):
            if a.op == "const":
                where.append((id(n), k))
                vals.append(a.value)
    return where, vals


def _uses(nodes):
    count = {}
    for n in nodes:
        for a in n.args:
            count[id(a)] = count.get(id(a), 0) + 1
    return count


def evaluate(e: Expr, x, y, z=None, dtype=torch.float32, params=None,
             flip: float = None):
    """``e`` at the points ``(x, y, z)`` (broadcastable tensors, cast to
    ``dtype``).  ``params``: (where, tensors) from :func:`leaf_params`
    with a 0-d tensor each, to read each constant operand from (a fit
    differentiates them); constants are Python floats otherwise, which
    PyTorch applies in the tensor's own type."""
    nodes = e.nodes()
    left = _uses(nodes)
    dev = x.device
    axes = {"x": x.to(dtype), "y": y.to(dtype),
            "z": (torch.zeros((), device=dev) if z is None else z).to(dtype)}
    operand = {}
    if params is not None:
        for (nid, k), t in zip(*params):
            operand[(nid, k)] = t.to(dtype)
    val = {}

    def arg(n, k):
        a = n.args[k]
        if a.op == "const":
            p = operand.get((id(n), k))
            return a.value if p is None else p
        return val[id(a)]

    for n in nodes:
        op = n.op
        if op in axes:
            out = axes[op]
        elif op == "const":
            continue
        elif len(n.args) == 1:
            a = arg(n, 0)
            if op == "square":
                out = a * a
            elif op == "sqrt":
                out = torch.sqrt(a)
            elif op == "neg":
                out = -a
            elif op == "sin":
                out = torch.sin(a)
            elif op == "cos":
                out = torch.cos(a)
            elif op == "abs":
                pos = a >= 0
                if flip is not None:
                    pos = pos ^ (2 * a.abs() <= flip)
                out = torch.where(pos, a, -a)
            else:
                raise ValueError(op)
        else:
            a, b = arg(n, 0), arg(n, 1)
            if op == "add":
                out = a + b
            elif op == "sub":
                out = a - b
            elif op == "mul":
                out = a * b
            elif op == "div":
                out = a / b
            elif op in ("min", "max"):
                take_a = a <= b if op == "min" else a >= b
                if flip is not None:
                    take_a = take_a ^ ((a - b).abs() <= flip)
                out = torch.where(take_a, a, b)
            else:
                raise ValueError(op)
        val[id(n)] = out
        for a in n.args:
            if a.op != "const":
                left[id(a)] -= 1
                if not left[id(a)]:
                    val.pop(id(a), None)
    return val[id(e)]
