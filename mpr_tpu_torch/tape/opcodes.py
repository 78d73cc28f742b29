"""GPU-tape opcode set.

Numbering mirrors the reference enum exactly
(``reference/inc/gpu_opcode.hpp:18-56``) so tape dumps are directly
comparable.  ``JUMP`` exists only for parity in dumps: this runtime uses
flat fixed-capacity per-tile tapes instead of the reference's chunked
linked-list subtape arena (``reference/src/context.cu:341,400-412``), so
no jump clauses are ever emitted here.  Opcode 0 (``INVALID``) doubles as the
NOP/terminator padding value in our fixed-shape tapes, matching the
reference's use of a zero opcode as the tape terminator
(``reference/src/tape.cpp:216-221``).
"""

from __future__ import annotations

import enum


class Op(enum.IntEnum):
    INVALID = 0          # terminator / NOP padding
    JUMP = 1             # never emitted (kept for enum parity)

    SQUARE_LHS = 2
    SQRT_LHS = 3
    NEG_LHS = 4
    SIN_LHS = 5
    COS_LHS = 6
    ASIN_LHS = 7
    ACOS_LHS = 8
    ATAN_LHS = 9
    EXP_LHS = 10
    ABS_LHS = 11
    LOG_LHS = 12

    # Commutative
    ADD_LHS_IMM = 13
    ADD_LHS_RHS = 14
    MUL_LHS_IMM = 15
    MUL_LHS_RHS = 16
    MIN_LHS_IMM = 17
    MIN_LHS_RHS = 18
    MAX_LHS_IMM = 19
    MAX_LHS_RHS = 20

    # Non-commutative
    SUB_LHS_IMM = 21
    SUB_IMM_RHS = 22
    SUB_LHS_RHS = 23
    DIV_LHS_IMM = 24
    DIV_IMM_RHS = 25
    DIV_LHS_RHS = 26

    # Copy-only opcodes (emitted by tape shortening)
    COPY_IMM = 27
    COPY_LHS = 28
    COPY_RHS = 29

    # Fused compound ops (no reference counterpart; emitted by the
    # compile-time peephole pass in tape/fuse.py — the distance-field
    # hot patterns sqrt(a²+b²) and a²+b collapse 4/2 clauses into 1,
    # cutting interpreter steps)
    HYPOT_LHS_RHS = 30
    ADDSQ_LHS_RHS = 31


NUM_OPS = 32

# Choice-recording ops: min/max in both forms.  The shortening pass relies on
# this contiguous range exactly like reference/src/context.cu:365-366.
CHOICE_OPS = (Op.MIN_LHS_IMM, Op.MIN_LHS_RHS, Op.MAX_LHS_IMM, Op.MAX_LHS_RHS)
CHOICE_OP_LO = int(Op.MIN_LHS_IMM)
CHOICE_OP_HI = int(Op.MAX_LHS_RHS)

# Ops whose RHS byte names a live slot (everything else leaves rhs == 0,
# which the shortening pass interprets as "no RHS operand",
# reference/src/context.cu:421-423,437-447).
RHS_OPS = (Op.ADD_LHS_RHS, Op.MUL_LHS_RHS, Op.MIN_LHS_RHS, Op.MAX_LHS_RHS,
           Op.SUB_IMM_RHS, Op.SUB_LHS_RHS, Op.DIV_IMM_RHS, Op.DIV_LHS_RHS,
           Op.COPY_RHS, Op.HYPOT_LHS_RHS, Op.ADDSQ_LHS_RHS)

# Ops whose LHS byte names a live slot.
LHS_OPS = (Op.SQUARE_LHS, Op.SQRT_LHS, Op.NEG_LHS, Op.SIN_LHS, Op.COS_LHS,
           Op.ASIN_LHS, Op.ACOS_LHS, Op.ATAN_LHS, Op.EXP_LHS, Op.ABS_LHS,
           Op.LOG_LHS,
           Op.ADD_LHS_IMM, Op.ADD_LHS_RHS, Op.MUL_LHS_IMM, Op.MUL_LHS_RHS,
           Op.MIN_LHS_IMM, Op.MIN_LHS_RHS, Op.MAX_LHS_IMM, Op.MAX_LHS_RHS,
           Op.SUB_LHS_IMM, Op.SUB_LHS_RHS, Op.DIV_LHS_IMM, Op.DIV_LHS_RHS,
           Op.COPY_LHS, Op.HYPOT_LHS_RHS, Op.ADDSQ_LHS_RHS)

# Ops that carry a float immediate.
IMM_OPS = (Op.ADD_LHS_IMM, Op.MUL_LHS_IMM, Op.MIN_LHS_IMM, Op.MAX_LHS_IMM,
           Op.SUB_LHS_IMM, Op.SUB_IMM_RHS, Op.DIV_LHS_IMM, Op.DIV_IMM_RHS,
           Op.COPY_IMM)


_OP_STR = {
    Op.INVALID: "INVALID",
    Op.JUMP: "JUMP",
    Op.SQUARE_LHS: "SQUARE_LHS",
    Op.SQRT_LHS: "SQRT_LHS",
    Op.NEG_LHS: "NEG_LHS",
    Op.SIN_LHS: "SIN_LHS",
    Op.COS_LHS: "COS_LHS",
    Op.ASIN_LHS: "ASIN_LHS",
    Op.ACOS_LHS: "ACOS_LHS",
    Op.ATAN_LHS: "ATAN_LHS",
    Op.EXP_LHS: "EXP_LHS",
    Op.ABS_LHS: "ABS_LHS",
    Op.LOG_LHS: "LOG_LHS",
    Op.ADD_LHS_IMM: "ADD_LHS_IMM",
    Op.ADD_LHS_RHS: "ADD_LHS_RHS",
    Op.MUL_LHS_IMM: "MUL_LHS_IMM",
    Op.MUL_LHS_RHS: "MUL_LHS_RHS",
    Op.MIN_LHS_IMM: "MIN_LHS_IMM",
    Op.MIN_LHS_RHS: "MIN_LHS_RHS",
    Op.MAX_LHS_IMM: "MAX_LHS_IMM",
    Op.MAX_LHS_RHS: "MAX_LHS_RHS",
    Op.SUB_LHS_IMM: "SUB_LHS_IMM",
    Op.SUB_IMM_RHS: "SUB_IMM_RHS",
    Op.SUB_LHS_RHS: "SUB_LHS_RHS",
    Op.DIV_LHS_IMM: "DIV_LHS_IMM",
    Op.DIV_IMM_RHS: "DIV_IMM_RHS",
    Op.DIV_LHS_RHS: "DIV_LHS_RHS",
    Op.COPY_IMM: "COPY_IMM",
    Op.COPY_LHS: "COPY_LHS",
    Op.COPY_RHS: "COPY_RHS",
    Op.HYPOT_LHS_RHS: "HYPOT_LHS_RHS",
    Op.ADDSQ_LHS_RHS: "ADDSQ_LHS_RHS",
}


def op_str(op: int) -> str:
    """Analog of ``gpu_op_str`` (reference/src/gpu_opcode.cu:17-58)."""
    try:
        return _OP_STR[Op(op)]
    except ValueError:
        return f"?{op}"
