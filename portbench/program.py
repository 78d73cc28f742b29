"""The system under test, as the harness reaches it: the port's frontend
``Tree`` of a scene, its compiled tape, and the device it runs on.

Only this module and the drivers import ``mpr_tpu_torch``; the reference
(``reference/``) never does.
"""

from __future__ import annotations

import time

from .expr import BINARY, UNARY, Expr


def to_tree(e: Expr):
    """``e`` rebuilt node by node with the port's frontend constructors
    (which fold as ``Expr`` does), so it is the ``Tree`` the port's own
    shape library would build for the same scene."""
    from mpr_tpu_torch.frontend import tree as T
    memo = {}
    for n in e.nodes():
        if n.op == "const":
            t = T.const(n.value)
        elif n.op in ("x", "y", "z"):
            t = getattr(T, n.op)()
        elif n.op in UNARY:
            t = T.Tree(n.op, memo[id(n.args[0])])
        elif n.op in BINARY:
            t = T.Tree(n.op, memo[id(n.args[0])], memo[id(n.args[1])])
        else:
            raise ValueError(f"no tree op for {n.op!r}")
        memo[id(n)] = t
    return memo[id(e)]


def compile_scene(e: Expr):
    """(tape, host seconds of ``compile_tree``): the tape compiler as a
    user's first frame runs it (the native compiler, built or loaded at its
    first use in the process)."""
    import mpr_tpu_torch
    tree = to_tree(e)
    t0 = time.perf_counter()
    tape = mpr_tpu_torch.compile_tree(tree)
    return tape, time.perf_counter() - t0
