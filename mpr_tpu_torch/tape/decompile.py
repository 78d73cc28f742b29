"""Tape -> Tree reconstruction (tape decompiler).

The inverse of ``tape/tape.py::compile_tree``: replays the clause program
symbolically, binding each output slot to the ``frontend.tree`` expression
it computes.  This closes the artifact loop the reference leaves open —
its tapes are a one-way GPU upload (reference/src/tape.cpp:223-227),
so a *fitted* tape (``cli fit`` writes ``.npz`` checkpoints with updated
immediates) could otherwise never travel back to the ``.frep`` archive
format that the reference's benchmarks and our viewer consume.

Round-trip guarantee: ``tape_to_tree(compile_tree(t))`` evaluates
identically to ``t`` (the oracle is the arbiter; the reconstructed DAG may
be smaller because hash-consing and total constant folding re-run).  One
caveat: if fitting drove an immediate to exactly 0.0 or 1.0, the
frontend's identity folds (x*1 -> x, x*0 -> 0, ...) absorb that clause —
same values everywhere finite, but the constant is no longer a free
parameter of the reconstructed tree.
"""

from __future__ import annotations

from ..frontend import tree as T
from .opcodes import Op
from .tape import Tape

# Unary opcode -> frontend constructor.
_UNARY = {
    int(Op.SQUARE_LHS): T.square,
    int(Op.SQRT_LHS): T.sqrt,
    int(Op.NEG_LHS): T.neg,
    int(Op.SIN_LHS): T.sin,
    int(Op.COS_LHS): T.cos,
    int(Op.ASIN_LHS): T.asin,
    int(Op.ACOS_LHS): T.acos,
    int(Op.ATAN_LHS): T.atan,
    int(Op.EXP_LHS): T.exp,
    int(Op.ABS_LHS): T.abs_,
    int(Op.LOG_LHS): T.log,
}

# Binary opcode -> (constructor, operand pattern).  Patterns: "ab" =
# (slot, slot), "ai" = (slot, imm), "ia" = (imm, slot) — the three clause
# forms of reference/inc/gpu_opcode.hpp:18-56.
_BINARY = {
    int(Op.ADD_LHS_IMM): (lambda a, b: a + b, "ai"),
    int(Op.ADD_LHS_RHS): (lambda a, b: a + b, "ab"),
    int(Op.MUL_LHS_IMM): (lambda a, b: a * b, "ai"),
    int(Op.MUL_LHS_RHS): (lambda a, b: a * b, "ab"),
    int(Op.MIN_LHS_IMM): (T.minimum, "ai"),
    int(Op.MIN_LHS_RHS): (T.minimum, "ab"),
    int(Op.MAX_LHS_IMM): (T.maximum, "ai"),
    int(Op.MAX_LHS_RHS): (T.maximum, "ab"),
    int(Op.SUB_LHS_IMM): (lambda a, b: a - b, "ai"),
    int(Op.SUB_IMM_RHS): (lambda a, b: a - b, "ia"),
    int(Op.SUB_LHS_RHS): (lambda a, b: a - b, "ab"),
    int(Op.DIV_LHS_IMM): (lambda a, b: a / b, "ai"),
    int(Op.DIV_IMM_RHS): (lambda a, b: a / b, "ia"),
    int(Op.DIV_LHS_RHS): (lambda a, b: a / b, "ab"),
}


def tape_to_tree(tape: Tape) -> T.Tree:
    """Reconstruct the expression a compiled tape computes.

    Handles every opcode the compiler and the shortening pass emit,
    including the fused ops the reference lacks (HYPOT/ADDSQ expand back to their
    sqrt/square/add form so the result serializes to reference-compatible
    ``.frep``).  Constants come from ``tape.imms`` — pass a fitted tape
    and the optimized constants land in the tree.
    """
    slots = {}
    sx, sy, sz = tape.axis_slots
    if sx:
        slots[sx] = T.x()
    if sy:
        slots[sy] = T.y()
    if sz:
        slots[sz] = T.z()
    # named parameters survive the round trip: their COPY_IMM clauses
    # decompile back to var() nodes (at the tape's CURRENT imm values —
    # a fitted tape decompiles with the fitted var values)
    param_at = {i: name for name, idxs in getattr(tape, "params", {}).items()
                for i in idxs}

    def slot(s, i):
        v = slots.get(int(s))
        if v is None:
            raise ValueError(f"clause {i} reads slot {int(s)} before any "
                             f"write (corrupt tape?)")
        return v

    for i in range(tape.length):
        op = int(tape.ops[i])
        imm = float(tape.imms[i])
        if op == int(Op.INVALID):      # NOP padding
            continue
        if op in _UNARY:
            val = _UNARY[op](slot(tape.lhss[i], i))
        elif op in _BINARY:
            fn, pat = _BINARY[op]
            if pat == "ai":
                val = fn(slot(tape.lhss[i], i), T.const(imm))
            elif pat == "ia":
                val = fn(T.const(imm), slot(tape.rhss[i], i))
            else:
                val = fn(slot(tape.lhss[i], i), slot(tape.rhss[i], i))
        elif op == int(Op.COPY_IMM):
            name = param_at.get(i)
            val = T.var(name, imm) if name else T.const(imm)
        elif op == int(Op.COPY_LHS):
            val = slot(tape.lhss[i], i)
        elif op == int(Op.COPY_RHS):
            val = slot(tape.rhss[i], i)
        elif op == int(Op.HYPOT_LHS_RHS):
            a, b = slot(tape.lhss[i], i), slot(tape.rhss[i], i)
            val = T.sqrt(T.square(a) + T.square(b))
        elif op == int(Op.ADDSQ_LHS_RHS):
            val = T.square(slot(tape.lhss[i], i)) + slot(tape.rhss[i], i)
        else:
            raise ValueError(f"clause {i}: cannot decompile opcode {op}")
        slots[int(tape.outs[i])] = val

    out = slots.get(tape.result_slot)
    if out is None:
        raise ValueError(f"result slot {tape.result_slot} never written")
    return out
