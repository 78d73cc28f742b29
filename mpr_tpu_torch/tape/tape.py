"""Tape compiler: frontend ``Tree`` -> flat register program.

Reimplements the reference compiler's semantics
(``reference/src/tape.cpp:21-228``): topological order, liveness via a
last-used map, linear-scan slot allocation with LIFO free-list reuse, constant
folding into immediates (commutative ops canonicalize the constant to the IMM
operand; SUB/DIV get IMM_RHS / LHS_IMM forms), and a result-slot terminator.

A copy of ``mpr_tpu.tape.tape``.  ``compile_tree`` hands a tree without
named parameters to the native C++ compiler (``mpr_tpu_torch/native/``,
bit-identical output) and keeps these Python passes for param trees and
for a machine where the library cannot be built.

Divergences from the reference (deliberate, documented):
  * The tape is a struct-of-arrays (ops/outs/lhss/rhss/imms as NumPy arrays)
    instead of packed uint64 words — typed arrays upload directly, and
    keeping ``imms`` separate makes the constants a parameter vector.
    ``pack_words()`` produces the reference's packed layout for parity dumps.
  * Slot count is hard-capped at ``SLOT_CAP``: the reference allows 255
    slots (reference/src/tape.cpp:79) but its kernels only allocate 128
    registers (reference/src/context.cu:210) — a latent overflow we fix
    by failing loudly (SURVEY.md section 7 quirk list).
  * Slot 0 is reserved as the "no operand" sentinel, exactly like the
    reference (num_slots starts at 1, reference/src/tape.cpp:70).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frontend.tree import (Tree, CONSTANT, PARAM, VAR_X, VAR_Y, VAR_Z,
                             UNARY_OPS)
from .opcodes import Op

SLOT_CAP = 224

# Frontend op name -> GPU opcode family.
_UNARY_GPU = {
    "square": Op.SQUARE_LHS, "sqrt": Op.SQRT_LHS, "neg": Op.NEG_LHS,
    "sin": Op.SIN_LHS, "cos": Op.COS_LHS, "asin": Op.ASIN_LHS,
    "acos": Op.ACOS_LHS, "atan": Op.ATAN_LHS, "exp": Op.EXP_LHS,
    "abs": Op.ABS_LHS, "log": Op.LOG_LHS,
}
_COMMUTATIVE_GPU = {
    "add": (Op.ADD_LHS_IMM, Op.ADD_LHS_RHS),
    "mul": (Op.MUL_LHS_IMM, Op.MUL_LHS_RHS),
    "min": (Op.MIN_LHS_IMM, Op.MIN_LHS_RHS),
    "max": (Op.MAX_LHS_IMM, Op.MAX_LHS_RHS),
}
_NONCOMMUTATIVE_GPU = {
    "sub": (Op.SUB_LHS_IMM, Op.SUB_IMM_RHS, Op.SUB_LHS_RHS),
    "div": (Op.DIV_LHS_IMM, Op.DIV_IMM_RHS, Op.DIV_LHS_RHS),
}
# Fused compound ops (tape/fuse.py): register-register only — the fuser
# never fuses across constant operands (imm forms would be cheaper).
_FUSED_GPU = {
    "hypot": Op.HYPOT_LHS_RHS,
    "addsq": Op.ADDSQ_LHS_RHS,
}

# Ops neither compilable nor lowerable (the clause algebra has no floor /
# NaN-select / free-variable form).  The reference rejects these AND the
# lowerable set (tan/recip/atan2/pow/nth-root/compare — see
# frontend/tree.py::lower_extended) with "Unimplemented opcode"
# (reference/src/tape.cpp:182-196); we only reject these three.
UNSUPPORTED = ("mod", "nanfill", "var-free")


class TapeError(ValueError):
    pass


@dataclass
class Tape:
    """A compiled clause program.

    ``ops/outs/lhss/rhss`` are int32 arrays of shape (length,); ``imms`` is a
    float32 array of the same shape and is the tape's differentiable
    parameter vector.  Real clauses occupy [0, length); callers may pad with
    zero-opcode NOPs to a fixed capacity bucket.
    """
    ops: np.ndarray
    outs: np.ndarray
    lhss: np.ndarray
    rhss: np.ndarray
    imms: np.ndarray
    axis_slots: Tuple[int, int, int]     # slot of x/y/z (0 = axis unused)
    result_slot: int
    num_slots: int                        # slots actually used (incl. slot 0)
    num_choices: int                      # count of min/max clauses
    tree: Optional[Tree] = field(default=None, repr=False)
    # named parameters (frontend var(): libfive CONST_VAR analog) ->
    # clause indices of their COPY_IMM imms.  Usually one index per name;
    # a name bound at two values mid-edit yields two clauses, and
    # imms_with sets them all.
    params: Dict[str, List[int]] = field(default_factory=dict, repr=False)

    @property
    def length(self) -> int:
        return int(self.ops.shape[0])

    @classmethod
    def from_arrays(cls, ops, outs, lhss, rhss, imms, *, axis_slots,
                    result_slot: int, num_slots: int,
                    num_choices: int) -> "Tape":
        """A tape from its clause arrays and static fields — how a tape
        compiled by another package (e.g. an ``mpr_tpu.Tape``, through
        ``np.asarray`` of its fields) is carried into this one."""
        return cls(ops=np.asarray(ops, np.int32),
                   outs=np.asarray(outs, np.int32),
                   lhss=np.asarray(lhss, np.int32),
                   rhss=np.asarray(rhss, np.int32),
                   imms=np.asarray(imms, np.float32),
                   axis_slots=tuple(int(a) for a in axis_slots),
                   result_slot=int(result_slot), num_slots=int(num_slots),
                   num_choices=int(num_choices))

    def imms_with(self, values: Dict[str, float]) -> np.ndarray:
        """A copy of ``imms`` with the named parameters overridden —
        parameter edits are pure data, so one compiled executable serves
        every value (the no-recompile contract of frontend var())."""
        imms = self.imms.copy()
        for name, v in values.items():
            for i in self.params.get(name, ()):
                imms[i] = np.float32(v)
        return imms

    # -- parity helpers -----------------------------------------------------

    def pack_words(self) -> np.ndarray:
        """Pack to the reference's uint64 clause layout
        (reference/inc/clause.hpp:18-23): byte0=op, byte1=out,
        byte2=lhs, byte3=rhs, bytes4-7=float immediate.  Includes the axis
        header word and the terminator word, so ``len == self.length + 2``.
        """
        n = self.length
        w = np.zeros(n + 2, dtype=np.uint64)
        b = w.view(np.uint8).reshape(n + 2, 8)
        sx, sy, sz = self.axis_slots
        b[0, 1], b[0, 2], b[0, 3] = sx, sy, sz
        b[1:n + 1, 0] = self.ops.astype(np.uint8)
        b[1:n + 1, 1] = self.outs.astype(np.uint8)
        b[1:n + 1, 2] = self.lhss.astype(np.uint8)
        b[1:n + 1, 3] = self.rhss.astype(np.uint8)
        b[1:n + 1, 4:8] = self.imms.astype("<f4").view(np.uint8).reshape(n, 4)
        b[n + 1, 1] = self.result_slot
        return w

    def pretty(self, limit: int = 40) -> str:
        from .opcodes import op_str
        lines = [f"# axes x->s{self.axis_slots[0]} y->s{self.axis_slots[1]} "
                 f"z->s{self.axis_slots[2]}; result s{self.result_slot}; "
                 f"{self.length} clauses, {self.num_slots} slots"]
        for i in range(min(self.length, limit)):
            o = op_str(int(self.ops[i]))
            lines.append(f"{i:5d}  s{int(self.outs[i]):<3d} = {o:<12s} "
                         f"lhs=s{int(self.lhss[i])} rhs=s{int(self.rhss[i])} "
                         f"imm={float(self.imms[i]):g}")
        if self.length > limit:
            lines.append(f"... ({self.length - limit} more)")
        return "\n".join(lines)


def _eff_operands(c: Tree):
    return tuple(h for h in (c.lhs, c.rhs) if h is not None)


def _gpu_op_of(c: Tree) -> int:
    """The GPU opcode this node will compile to (imm-folding aware)."""
    if c.op == PARAM:
        return int(Op.COPY_IMM)
    if c.op in _UNARY_GPU:
        return int(_UNARY_GPU[c.op])
    if c.op in _FUSED_GPU:
        return int(_FUSED_GPU[c.op])
    if c.op in _COMMUTATIVE_GPU:
        imm_form, reg_form = _COMMUTATIVE_GPU[c.op]
        if c.lhs.op == CONSTANT or c.rhs.op == CONSTANT:
            return int(imm_form)
        return int(reg_form)
    if c.op in _NONCOMMUTATIVE_GPU:
        lhs_imm, imm_rhs, reg_form = _NONCOMMUTATIVE_GPU[c.op]
        if c.lhs.op == CONSTANT:
            return int(imm_rhs)
        if c.rhs.op == CONSTANT:
            return int(lhs_imm)
        return int(reg_form)
    raise TapeError(f"no GPU op for {c.op!r}")


def _schedule_opruns(nodes, window: int = 256):
    """Reorder clauses into same-opcode runs (dependency-safe, windowed).

    Scheduling pass with no reference counterpart: the interpreters can
    dispatch once per RUN instead of per clause, and neighbouring clauses
    of one opcode take the same branch.  Greedy list scheduling within a
    sliding window of the original DFS order: keep emitting ready clauses of
    the current opcode; when none remain, switch to the opcode with the most
    ready clauses.  The window bounds register-pressure growth (unbounded
    greedy scheduling blows past the slot cap on prospero).  Any subsequence
    of the result is still topologically valid, so runtime tape shortening
    preserves run contiguity for free.
    """
    from collections import deque

    index = {c.id: i for i, c in enumerate(nodes)}
    n = len(nodes)
    ndeps = [0] * n
    consumers = [[] for _ in nodes]
    for i, c in enumerate(nodes):
        for h in _eff_operands(c):
            if h.id in index:
                ndeps[i] += 1
                consumers[index[h.id]].append(i)
    ready = {}
    inqueue = [False] * n
    scheduled = [False] * n

    def push(i):
        if not inqueue[i]:
            ready.setdefault(_gpu_op_of(nodes[i]), deque()).append(i)
            inqueue[i] = True

    frontier = 0
    for i in range(min(window, n)):
        if ndeps[i] == 0:
            push(i)
    out = []
    cur = None
    while len(out) < n:
        q = ready.get(cur)
        if not q:
            cur = max((k for k, v in ready.items() if v),
                      key=lambda k: len(ready[k]))
            q = ready[cur]
        i = q.popleft()
        out.append(nodes[i])
        scheduled[i] = True
        for j in consumers[i]:
            ndeps[j] -= 1
            if ndeps[j] == 0 and j < frontier + window:
                push(j)
        old_f = frontier
        while frontier < n and scheduled[frontier]:
            frontier += 1
        for j in range(old_f + window, min(frontier + window, n)):
            if ndeps[j] == 0 and not scheduled[j]:
                push(j)
    return out


def compile_tree(tree: Tree, schedule: str = "opruns",
                 backend: str = "auto", fuse: bool = True) -> Tape:
    """Compile a ``Tree`` to a ``Tape`` (reference semantics, see module doc).

    ``schedule='opruns'`` (default) reorders clauses into same-opcode runs
    for the interpreters (see :func:`_schedule_opruns`);
    ``schedule='dfs'`` keeps the reference's orderedDfs emission order.

    ``backend='auto'`` uses the native C++ compiler
    (mpr_tpu_torch/native/) for a tree without named parameters when its
    shared library builds and loads — bit-identical output — falling back
    to this module's pure-Python passes; ``'python'`` forces the
    fallback, ``'native'`` requires the library (and raises on a param
    tree).

    ``fuse=True`` runs the compile-time peephole pass (tape/fuse.py):
    hypot/addsq compound ops cut interpreter steps 10-15% on the
    benchmark models with identical float semantics.
    """
    from ..frontend.tree import lower_extended
    # Rewrite the libfive ops the reference REJECTS (tan/recip/atan2/pow/
    # nth-root/compare) into supported clauses — archives using them load
    # and render here instead of erroring (frontend/tree.py docstring).
    tree = lower_extended(tree)
    if fuse:
        from .fuse import fuse_tree
        tree = fuse_tree(tree)
    if tree.op == CONSTANT:
        # A constant-only expression (e.g. after folding) has no axis
        # reads for the slot binder to seed; emit the one-clause program
        # COPY_IMM directly (the opcode tape shortening already uses,
        # reference/inc/gpu_opcode.hpp COPY_IMM).  Shared by both
        # compiler backends.
        return Tape(ops=np.asarray([int(Op.COPY_IMM)], np.int32),
                    outs=np.asarray([1], np.int32),
                    lhss=np.asarray([0], np.int32),
                    rhss=np.asarray([0], np.int32),
                    imms=np.asarray([tree.value], np.float32),
                    axis_slots=(0, 0, 0), result_slot=1, num_slots=2,
                    num_choices=0, tree=tree)
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown tape compiler backend {backend!r}")
    if backend == "native" and tree._param:
        raise RuntimeError("native tape compiler does not support param "
                           "nodes (param tapes use the Python path)")
    if backend in ("auto", "native") and not tree._param:
        # param trees always take the Python path: the native compiler
        # has no PARAM clause form, and param-carrying tapes are small
        # interactive scenes, not the long compiles the C++ path is for
        from ..native import compile_native
        t = compile_native(tree, schedule)
        if t is not None:
            return t
        if backend == "native":
            raise RuntimeError("native tape compiler unavailable")

    ordered = tree.ordered_dfs()

    # ---- liveness: last consumer of every non-constant node ---------------
    # (reference/src/tape.cpp:29-66)
    last_used: Dict[int, int] = {}
    axes_used: List[Optional[Tree]] = [None, None, None]
    ordered_fast: List[Tree] = []
    for c in ordered:
        op = c.op
        if op == CONSTANT:
            continue
        if op == VAR_X:
            axes_used[0] = c
            continue
        if op == VAR_Y:
            axes_used[1] = c
            continue
        if op == VAR_Z:
            axes_used[2] = c
            continue
        if op in UNSUPPORTED:
            raise TapeError(f"unimplemented opcode {op!r} in tape compiler "
                            "(parity with reference/src/tape.cpp:182-196)")
        ordered_fast.append(c)

    if schedule == "opruns":
        # Windowed scheduling can raise register pressure; back off the
        # window until the tape fits the slot cap.
        base = ordered_fast
        for window in (512, 384, 256, 128, 64, 32, 0):
            try:
                reordered = (_schedule_opruns(base, window) if window
                             else base)
                return _emit(tree, ordered, reordered, last_used, axes_used)
            except TapeError:
                if window == 0:
                    raise
        raise AssertionError("unreachable")
    elif schedule == "dfs":
        return _emit(tree, ordered, ordered_fast, last_used, axes_used)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")


def _emit(tree, ordered, ordered_fast, last_used, axes_used) -> Tape:
    """Slot allocation + clause emission for a fixed clause order."""
    last_used = dict(last_used)
    # liveness follows the FINAL emission order
    for c in ordered_fast:
        for h in _eff_operands(c):
            last_used[h.id] = c.id

    # ---- slot allocation ---------------------------------------------------
    free_slots: List[int] = []
    bound_slots: Dict[int, int] = {}
    num_slots = 1  # slot 0 reserved as the "unused" sentinel

    def get_slot(node_id: int) -> int:
        nonlocal num_slots
        if free_slots:
            out = free_slots.pop()
        else:
            if num_slots >= SLOT_CAP:
                raise TapeError(
                    f"tape needs more than {SLOT_CAP} slots")
            out = num_slots
            num_slots += 1
        bound_slots[node_id] = out
        return out

    # Axis variables get the first slots; recorded in the tape header
    # (reference/src/tape.cpp:91-99).
    axis_slots = [0, 0, 0]
    for i in range(3):
        if axes_used[i] is not None:
            axis_slots[i] = get_slot(axes_used[i].id)

    def get_reg(node: Tree) -> int:
        s = bound_slots.get(node.id)
        if s is None:
            raise TapeError(f"no bound slot for {node!r}")
        return s

    ops: List[int] = []
    outs: List[int] = []
    lhss: List[int] = []
    rhss: List[int] = []
    imms: List[float] = []
    num_choices = 0
    params: Dict[str, List[int]] = {}

    for c in ordered_fast:
        op = c.op
        o_op, o_lhs, o_rhs, o_imm = 0, 0, 0, 0.0
        if op == PARAM:
            # named parameter -> COPY_IMM; its imm index is the handle
            # parameter edits and fitting masks use (Tape.params)
            o_op, o_imm = Op.COPY_IMM, c.value
            params.setdefault(c.name, []).append(len(ops))
        elif op in _UNARY_GPU:
            o_op = _UNARY_GPU[op]
            o_lhs = get_reg(c.lhs)
        elif op in _FUSED_GPU:
            o_op = _FUSED_GPU[op]
            o_lhs, o_rhs = get_reg(c.lhs), get_reg(c.rhs)
        elif op in _COMMUTATIVE_GPU:
            imm_form, reg_form = _COMMUTATIVE_GPU[op]
            if c.lhs.op == CONSTANT:
                o_op, o_lhs, o_imm = imm_form, get_reg(c.rhs), c.lhs.value
            elif c.rhs.op == CONSTANT:
                o_op, o_lhs, o_imm = imm_form, get_reg(c.lhs), c.rhs.value
            else:
                o_op, o_lhs, o_rhs = reg_form, get_reg(c.lhs), get_reg(c.rhs)
            if op in ("min", "max"):
                num_choices += 1
        elif op in _NONCOMMUTATIVE_GPU:
            lhs_imm, imm_rhs, reg_form = _NONCOMMUTATIVE_GPU[op]
            if c.lhs.op == CONSTANT:
                o_op, o_rhs, o_imm = imm_rhs, get_reg(c.rhs), c.lhs.value
            elif c.rhs.op == CONSTANT:
                o_op, o_lhs, o_imm = lhs_imm, get_reg(c.lhs), c.rhs.value
            else:
                o_op, o_lhs, o_rhs = reg_form, get_reg(c.lhs), get_reg(c.rhs)
        else:  # pragma: no cover - guarded above
            raise TapeError(f"unhandled op {op!r}")

        # Free operand slots at their last use BEFORE allocating the output,
        # enabling in-place reuse (reference/src/tape.cpp:199-210).
        # RHS is freed first so the LIFO pop hands the output the LHS
        # operand's slot: tape shortening rewrites one-sided min/max to
        # COPY_LHS far more often than COPY_RHS (accumulator chains keep
        # their running value), and an in-place COPY_LHS is elided
        # entirely by both shorten passes (oracle.shorten,
        # ops/kernels.py backward `elide`).
        freed = set()
        for h in (c.rhs, c.lhs):
            if (h is not None and h.op != CONSTANT
                    and last_used.get(h.id) == c.id and h.id not in freed):
                s = bound_slots.pop(h.id, None)
                if s is not None:
                    free_slots.append(s)
                    freed.add(h.id)

        o_out = get_slot(c.id)
        ops.append(int(o_op))
        outs.append(o_out)
        lhss.append(o_lhs)
        rhss.append(o_rhs)
        imms.append(float(o_imm))

    # ---- result slot --------------------------------------------------------
    root = ordered[-1]
    if root.op == CONSTANT:
        # The reference would fail here (get_reg on an unbound constant);
        # we emit a COPY_IMM so constant shapes still render.
        s = get_slot(root.id)
        ops.append(int(Op.COPY_IMM))
        outs.append(s)
        lhss.append(0)
        rhss.append(0)
        imms.append(float(root.value))
        result_slot = s
    else:
        result_slot = get_reg(root)

    return Tape(
        ops=np.asarray(ops, dtype=np.int32),
        outs=np.asarray(outs, dtype=np.int32),
        lhss=np.asarray(lhss, dtype=np.int32),
        rhss=np.asarray(rhss, dtype=np.int32),
        imms=np.asarray(imms, dtype=np.float32),
        axis_slots=(axis_slots[0], axis_slots[1], axis_slots[2]),
        result_slot=result_slot,
        num_slots=num_slots,
        num_choices=num_choices,
        tree=tree,
        params=params,
    )
