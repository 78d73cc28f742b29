"""Compile-time peephole fusion: collapse hot clause patterns.

The interpreter's cost grows with its step count, so every fused clause
saves a dispatch and a register round trip (no reference counterpart).

Patterns (matched on the hash-consed DAG with use counts, so slot
allocation downstream stays untouched):

  sqrt(square(x) + square(y))  -> hypot(x, y)      [4 clauses -> 1]
       (the distance-field workhorse; prospero has ~250 of these)
  square(x) + b                -> addsq(x, b)      [2 -> 1]
  neg(a - b)                   -> b - a            [2 -> 1, free:
       reuses SUB's existing IMM/reg forms]

Intermediates are fused only when used exactly once; fusion with a
constant operand is skipped (the unfused imm-forms are cheaper).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from ..frontend.tree import CONSTANT, Tree


_CACHE: Dict[int, Tree] = {}


def fuse_tree(tree: Tree) -> Tree:
    """Peephole-rewrite, memoized — trees are interned and immutable, so
    the result is cached by node id (compile_tree may recompile the same
    shape for several image sizes)."""
    hit = _CACHE.get(tree.id)
    if hit is not None:
        return hit
    fused = _fuse(tree)
    if len(_CACHE) > 64:
        _CACHE.clear()
    _CACHE[tree.id] = fused
    return fused


def _fuse(tree: Tree) -> Tree:
    order = tree.ordered_dfs()
    uses: Counter = Counter()
    for n in order:
        for c in n.children():
            uses[c.id] += 1

    memo: Dict[int, Tree] = {}
    for n in order:
        if n.op == "sqrt":
            A = n.lhs
            if (A.op == "add" and uses[A.id] == 1
                    and A.lhs.op == "square" and A.rhs.op == "square"
                    and uses[A.lhs.id] == 1 and uses[A.rhs.id] == 1):
                memo[n.id] = Tree("hypot", memo[A.lhs.lhs.id],
                                  memo[A.rhs.lhs.id])
                continue
        if n.op == "add":
            if (n.lhs.op == "square" and uses[n.lhs.id] == 1
                    and n.rhs.op != CONSTANT):
                memo[n.id] = Tree("addsq", memo[n.lhs.lhs.id],
                                  memo[n.rhs.id])
                continue
            if (n.rhs.op == "square" and uses[n.rhs.id] == 1
                    and n.lhs.op != CONSTANT):
                memo[n.id] = Tree("addsq", memo[n.rhs.lhs.id],
                                  memo[n.lhs.id])
                continue
        if n.op == "neg" and n.lhs.op == "sub" and uses[n.lhs.id] == 1:
            S = n.lhs
            memo[n.id] = Tree("sub", memo[S.rhs.id], memo[S.lhs.id])
            continue
        if n.children():
            kids = [memo[c.id] for c in n.children()]
            memo[n.id] = (Tree(n.op, kids[0]) if len(kids) == 1
                          else Tree(n.op, kids[0], kids[1]))
        else:
            memo[n.id] = n
    return memo[tree.id]
