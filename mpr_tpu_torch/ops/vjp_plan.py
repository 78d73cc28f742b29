"""The storage plan of the backward kernels K1 and K2, made on the host.

Both kernels compute d(sum_lanes g * f)/d(imms) of a tape's float walk
with ``jax.grad``'s rules: K1 (``ops/unrolled_eval.py``, generated per
tape) for the unrolled evaluator, K2 (``csrc/scan_adjoint.cu``) for the
interpreter.  Each runs a forward half that stores what the reverse half
reads.  This module decides what that is, once per tape, from the clauses
alone (no immediate, no lane):

  * **values**: the clause values the partials read.  A linear clause
    (add, sub, neg, copy) reads none; the other rules read their operands
    (``NEEDS_A``, ``NEEDS_B``), and sqrt, exp and hypot their result
    (``NEEDS_R``).  Each stored value has a compact position
    (``vpos``), its row in ``vals``.
  * **choices**: a 2-bit code for each min/max clause (``cidx``: its
    index among them), 16 to a 32-bit word a lane, in row ``cidx // 16``
    of ``words``, bits ``2 * (cidx % 16)``: bit 0 set where the lhs equals
    the result, bit 1 where the other operand does.  That is
    ``jax.grad``'s four cases: left (1, 0), right (0, 1), a tie (0.5
    each) and a NaN result (0 to both).
  * **handover** (K1 only): K1's reverse half runs in segments of
    ``segment`` clauses, one kernel each, last first, keeping adjoints in
    registers.  The adjoint of a value whose readers lie in a later
    segment, or that would stay live while more than ``live`` others are
    (the longest-lived are parked first), goes through memory instead, in
    row ``hpos[s]`` of ``hand``, stored by its first contributor in
    reverse order (``first[s]``), added to by the others, read by the
    clause that made the value.  Nothing is zero-filled.

Every such array (``rows`` rows, one float a lane) is laid out in blocks
of ``LANE_BLOCK`` lanes: entry (row, lane) at ``lane // LANE_BLOCK *
rows * LANE_BLOCK + row * LANE_BLOCK + lane % LANE_BLOCK``
(:func:`blocked_size`), so that a block's stores and loads of successive
rows fall on neighbouring addresses.

:func:`partials` states the rules once, over a backend of operations, so
that K1's generator (C statements) and the replays below (torch tensors)
run the same formulas; ``csrc/scan_adjoint.cu`` spells them by hand.
:func:`replay_k1` and :func:`replay_k2` run both kernels' algorithms in
plain PyTorch from the stored values, choice words and handed-over
adjoints alone (the CPU tests hold them to autograd and ``jax.grad``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..tape.opcodes import Op
from .tape_data import operand_sources

NUM_OPS = 32
_CHOICE = (Op.MIN_LHS_IMM, Op.MIN_LHS_RHS, Op.MAX_LHS_IMM, Op.MAX_LHS_RHS)
_IMM_CHOICE = (Op.MIN_LHS_IMM, Op.MAX_LHS_IMM)


def _table(ops) -> np.ndarray:
    t = np.zeros(NUM_OPS, bool)
    t[[int(o) for o in ops]] = True
    return t


# the rules that read the lhs value, the rhs value, the result
NEEDS_A = _table((Op.SQUARE_LHS, Op.SIN_LHS, Op.COS_LHS, Op.ASIN_LHS,
                  Op.ACOS_LHS, Op.ATAN_LHS, Op.ABS_LHS, Op.LOG_LHS,
                  Op.MUL_LHS_IMM, Op.MUL_LHS_RHS, Op.DIV_LHS_IMM,
                  Op.DIV_LHS_RHS, Op.HYPOT_LHS_RHS, Op.ADDSQ_LHS_RHS))
NEEDS_B = _table((Op.MUL_LHS_RHS, Op.DIV_IMM_RHS, Op.DIV_LHS_RHS,
                  Op.HYPOT_LHS_RHS))
NEEDS_R = _table((Op.SQRT_LHS, Op.EXP_LHS, Op.HYPOT_LHS_RHS))
CHOICE = _table(_CHOICE)
# the clauses whose rule gives the lhs / the rhs / the immediate a share
# (INVALID and JUMP, the interpreter's a * 0, give the lhs g * 0)
USES_A = _table(set(range(NUM_OPS)) - {Op.SUB_IMM_RHS, Op.DIV_IMM_RHS,
                                        Op.COPY_IMM, Op.COPY_RHS})
USES_B = _table((Op.ADD_LHS_RHS, Op.MUL_LHS_RHS, Op.MIN_LHS_RHS,
                 Op.MAX_LHS_RHS, Op.SUB_IMM_RHS, Op.SUB_LHS_RHS,
                 Op.DIV_IMM_RHS, Op.DIV_LHS_RHS, Op.COPY_RHS,
                 Op.HYPOT_LHS_RHS, Op.ADDSQ_LHS_RHS))
USES_I = _table((Op.ADD_LHS_IMM, Op.MUL_LHS_IMM, Op.MIN_LHS_IMM,
                 Op.MAX_LHS_IMM, Op.SUB_LHS_IMM, Op.SUB_IMM_RHS,
                 Op.DIV_LHS_IMM, Op.DIV_IMM_RHS, Op.COPY_IMM))
# the rules that read the immediate's value
READS_IMM = _table((Op.MUL_LHS_IMM, Op.DIV_LHS_IMM, Op.DIV_IMM_RHS))

# lanes of a block of the stored arrays' layout (module doc; K1's and K2's
# kernels assume it)
LANE_BLOCK = 128


def blocked_size(rows: int, lanes: int) -> int:
    """Entries of an array of ``rows`` rows over ``lanes`` lanes in the
    blocked layout (at least one row)."""
    return max(rows, 1) * -(-lanes // LANE_BLOCK) * LANE_BLOCK


# device -> {name: a byte buffer} (workspace)
_WORK = {}


def workspace(name: str, device, parts):
    """Tensors for a kernel's stored arrays, carved from one byte buffer
    kept per ``name`` and device and grown as a call needs (each part's
    start 256-byte aligned): ``parts`` is ``[(entries, dtype), ...]``.  A
    backward pass allocating gigabytes anew at every call spent much of
    its time in the allocator; this keeps the largest buffer a process has
    needed (it is reused, not freed)."""
    sizes = [(int(n), dt, torch.empty((), dtype=dt).element_size())
             for n, dt in parts]
    offs, total = [], 0
    for n, _, es in sizes:
        offs.append(total)
        total += -(-n * es // 256) * 256
    key = (name, str(device))
    buf = _WORK.get(key)
    if buf is None or buf.numel() < total:
        _WORK.pop(key, None)
        buf = _WORK[key] = torch.empty(total, dtype=torch.uint8,
                                       device=device)
    return [buf[o:o + n * es].view(dt) for o, (n, dt, es) in zip(offs,
                                                                  sizes)]


# K2's 16-bit operand codes (csrc/scan_adjoint.cu): a stored value's
# position, or one of these
CODE_X, CODE_Y, CODE_Z, CODE_ZERO = 0xFFFC, 0xFFFD, 0xFFFE, 0xFFFF
CODE_NONE = CODE_ZERO


def partials(op: int, K, g, a, b, r, imm, code):
    """``(da, db, di)``: the shares of clause ``op``'s lhs, rhs and
    immediate in the adjoint ``g`` of its output, ``None`` where the rule
    gives none; ``a``, ``b``, ``r`` the lhs, rhs and result values (only
    those of ``NEEDS_*`` are read), ``code`` the choice code.  ``K`` is the
    backend: ``mul``, ``div``, ``add``, ``sub``, ``neg``, ``sqrt``,
    ``sin``, ``cos``, ``sel_ge0(a, p, q)`` (``a >= 0 ? p : q``) and
    ``bal(code, side)`` (the min/max share of side 0, the lhs, or 1).
    These are ``jax.grad``'s rules as torch's autograd spells them (the
    module doc of ``csrc/scan_adjoint.cu``)."""
    op = int(op)
    if op == Op.SQUARE_LHS:
        p = K.mul(g, a)
        return K.add(p, p), None, None
    if op == Op.SQRT_LHS:
        return K.div(g, K.mul(2.0, r)), None, None
    if op == Op.NEG_LHS:
        return K.neg(g), None, None
    if op == Op.SIN_LHS:
        return K.mul(g, K.cos(a)), None, None
    if op == Op.COS_LHS:
        return K.mul(g, K.neg(K.sin(a))), None, None
    if op == Op.ASIN_LHS:
        return K.div(g, K.sqrt(K.sub(1.0, K.mul(a, a)))), None, None
    if op == Op.ACOS_LHS:
        return K.div(K.neg(g), K.sqrt(K.sub(1.0, K.mul(a, a)))), None, None
    if op == Op.ATAN_LHS:
        return K.div(g, K.add(1.0, K.mul(a, a))), None, None
    if op == Op.EXP_LHS:
        return K.mul(g, r), None, None
    if op == Op.ABS_LHS:
        return K.sel_ge0(a, g, K.neg(g)), None, None
    if op == Op.LOG_LHS:
        return K.div(g, a), None, None
    if op == Op.ADD_LHS_IMM:
        return g, None, g
    if op == Op.ADD_LHS_RHS:
        return g, g, None
    if op == Op.MUL_LHS_IMM:
        return K.mul(g, imm), None, K.mul(g, a)
    if op == Op.MUL_LHS_RHS:
        return K.mul(g, b), K.mul(g, a), None
    if op in (Op.MIN_LHS_IMM, Op.MAX_LHS_IMM):
        return K.mul(g, K.bal(code, 0)), None, K.mul(g, K.bal(code, 1))
    if op in (Op.MIN_LHS_RHS, Op.MAX_LHS_RHS):
        return K.mul(g, K.bal(code, 0)), K.mul(g, K.bal(code, 1)), None
    if op == Op.SUB_LHS_IMM:
        return g, None, K.neg(g)
    if op == Op.SUB_IMM_RHS:
        return None, K.neg(g), g
    if op == Op.SUB_LHS_RHS:
        return g, K.neg(g), None
    if op == Op.DIV_LHS_IMM:
        return (K.div(g, imm), None,
                K.div(K.mul(K.neg(g), a), K.mul(imm, imm)))
    if op == Op.DIV_IMM_RHS:
        return (None, K.div(K.mul(K.neg(g), imm), K.mul(b, b)),
                K.div(g, b))
    if op == Op.DIV_LHS_RHS:
        return (K.div(g, b), K.div(K.mul(K.neg(g), a), K.mul(b, b)), None)
    if op == Op.COPY_IMM:
        return None, None, g
    if op == Op.COPY_LHS:
        return g, None, None
    if op == Op.COPY_RHS:
        return None, g, None
    if op == Op.HYPOT_LHS_RHS:
        h = K.div(g, K.mul(2.0, r))
        ha, hb = K.mul(h, a), K.mul(h, b)
        return K.add(ha, ha), K.add(hb, hb), None
    if op == Op.ADDSQ_LHS_RHS:
        p = K.mul(g, a)
        return K.add(p, p), g, None
    return K.mul(g, 0.0), None, None          # INVALID, JUMP: a * 0


class _Count:
    """A backend of :func:`partials` that counts float operations (a
    select, a share and a constant count none)."""

    def __init__(self):
        self.n = 0

    def _op(self, *_):
        self.n += 1
        return "v"

    mul = div = add = sub = neg = sqrt = sin = cos = _op

    def sel_ge0(self, a, p, q):
        return "v"

    def bal(self, code, side):
        return 1.0


def vjp_ops(op: int) -> int:
    """Float operations of clause ``op``'s reverse step a lane: its rule's
    operations, and one addition for each share it hands on (into an
    operand's adjoint or the lane sum of an immediate's)."""
    K = _Count()
    shares = partials(op, K, "g", "a", "b", "r", "i", "c")
    return K.n + sum(s is not None for s in shares)


@dataclass(frozen=True)
class VjpPlan:
    """A tape's storage plan (module doc).  Arrays are numpy, one entry a
    clause unless said otherwise; -1 marks "none"."""
    length: int
    ops: np.ndarray          # opcodes
    src: np.ndarray          # (2, L) operand sources (tape_data.operand_sources)
    result: int              # the clause whose value is the result (or < 0)
    has: np.ndarray          # the clause's output has an adjoint
    vpos: np.ndarray         # stored position of the clause's value
    cidx: np.ndarray         # index among the min/max clauses
    n_vals: int
    n_choices: int
    segments: tuple          # K1's reverse segments (t0, t1), forward order
    hpos: np.ndarray         # handover position of the value's adjoint
    first: np.ndarray        # the clause that stores a handed-over adjoint
    n_handover: int
    contributions: int       # handover writes (stores and additions), all

    @property
    def n_words(self) -> int:
        """32-bit words a lane of choice codes (2 bits a clause)."""
        return -(-self.n_choices // 16)

    @property
    def k2_lane_bytes(self) -> int:
        """Bytes a lane of what K2f stores for K2: values and choice
        words."""
        return 4 * (self.n_vals + self.n_words)

    @property
    def k1_lane_bytes(self) -> int:
        """Bytes a lane of K1's memory: values, choice words and the
        handover array."""
        return 4 * (self.n_vals + self.n_words + self.n_handover)

    def k1_floor_bytes(self, lanes: int) -> int:
        """Bytes K1's design must move over ``lanes`` lanes beyond its
        inputs and outputs: values and choice words written once and read
        once, each handover entry stored, added to and read once each."""
        return lanes * 4 * (2 * (self.n_vals + self.n_words)
                            + 2 * self.contributions)

    def k2_floor_bytes(self, lanes: int) -> int:
        """The same for K2 (no handover: its adjoints stay on chip)."""
        return lanes * 4 * 2 * (self.n_vals + self.n_words)

    def code(self, s: int) -> int:
        """K2's 16-bit code of a stored value or an input (``src``)."""
        if s >= 0:
            p = int(self.vpos[s])
            if p < 0:
                raise AssertionError(f"value of clause {s} is not stored")
            return p
        return {-1: CODE_X, -2: CODE_Y, -3: CODE_Z}.get(int(s), CODE_ZERO)

    def entry_codes(self):
        """K2's per-clause fields beside the word and the immediate, two
        int32 planes: ``ab`` = lhs code | rhs code << 16 and ``rc`` =
        result code | choice index << 16 (``CODE_NONE`` where the rule
        reads nothing there, for a clause without an adjoint too)."""
        L = self.length
        ab = np.full(L, CODE_NONE | CODE_NONE << 16, np.int64)
        rc = np.full(L, CODE_NONE | CODE_NONE << 16, np.int64)
        for t in range(L):
            op = int(self.ops[t])
            ci = int(self.cidx[t]) if self.cidx[t] >= 0 else CODE_NONE
            ca = cb = cr = CODE_NONE
            if self.has[t]:
                if NEEDS_A[op]:
                    ca = self.code(int(self.src[0, t]))
                if NEEDS_B[op]:
                    cb = self.code(int(self.src[1, t]))
                if NEEDS_R[op]:
                    cr = int(self.vpos[t])
            ab[t] = ca | cb << 16
            rc[t] = cr | ci << 16
        return ab.astype(np.uint32).view(np.int32), \
            rc.astype(np.uint32).view(np.int32)


def vjp_plan(ops, outs, lhss, rhss, axis_slots, result_slot,
             segment: int = 512, live: int = 56) -> VjpPlan:
    """The plan of a tape given by its clause fields (module doc):
    ``segment`` clauses a K1 reverse kernel, at most ``live`` adjoints
    kept in registers at once."""
    ops = np.asarray(ops, np.int64)
    L = int(ops.shape[0])
    src = operand_sources(outs, lhss, rhss, axis_slots)
    last = {s: -1 - k for k, s in enumerate(axis_slots) if s}
    for t, o in enumerate(np.asarray(outs).tolist()):
        last[o] = t
    result = int(last.get(int(result_slot), -4))
    # which clause outputs the result depends on, and who reads them
    has = np.zeros(L, bool)
    if result >= 0:
        has[result] = True
    readers = {}
    for t in range(L - 1, -1, -1):
        if not has[t]:
            continue
        op = int(ops[t])
        for k, uses in ((0, USES_A), (1, USES_B)):
            s = int(src[k, t])
            if uses[op] and s >= 0:
                has[s] = True
                rs = readers.setdefault(s, [])
                if not rs or rs[-1] != t:
                    rs.append(t)          # descending: rs[0] is the last
    # stored values and choice codes
    need = np.zeros(L, bool)
    for t in np.flatnonzero(has):
        op = int(ops[t])
        for k, tab in ((0, NEEDS_A), (1, NEEDS_B)):
            s = int(src[k, t])
            if tab[op] and s >= 0:
                need[s] = True
        if NEEDS_R[op]:
            need[t] = True
    vpos = np.full(L, -1, np.int32)
    vpos[need] = np.arange(int(need.sum()), dtype=np.int32)
    is_choice = CHOICE[ops] if L else np.zeros(0, bool)
    cidx = np.full(L, -1, np.int32)
    cidx[is_choice] = np.arange(int(is_choice.sum()), dtype=np.int32)
    # K1's segments and the adjoints handed over in memory
    segs = tuple((t0, min(L, t0 + segment))
                 for t0 in range(0, L, segment)) or ((0, 0),)
    seg_of = lambda t: t // segment              # noqa: E731
    end = {s: rs[0] for s, rs in readers.items()}
    hand = {s for s, e in end.items() if seg_of(s) != seg_of(e)}
    starts = {}
    for s, e in end.items():
        if s not in hand:
            starts.setdefault(e, []).append(s)
    act = set()
    for t in range(L - 1, -1, -1):
        act.discard(t)
        act.update(starts.get(t, ()))
        while len(act) > live:
            s = min(act)                   # the one live longest from here
            act.discard(s)
            hand.add(s)
    hpos = np.full(L, -1, np.int32)
    first = np.full(L, -1, np.int32)
    for k, s in enumerate(sorted(hand)):
        hpos[s] = k
        first[s] = end[s]
    contributions = sum(len(readers[s]) for s in hand)
    if int(need.sum()) >= CODE_X:
        raise ValueError(f"{int(need.sum())} stored values: over K2's "
                         "16-bit codes")
    return VjpPlan(L, ops, src, result, has, vpos, cidx, int(need.sum()),
                   int(is_choice.sum()), segs, hpos, first, len(hand),
                   contributions)


def plan_of_tape(tape, segment: int = 512, live: int = 56) -> VjpPlan:
    """:func:`vjp_plan` of a ``Tape``."""
    return vjp_plan(tape.ops, tape.outs, tape.lhss, tape.rhss,
                    tape.axis_slots, tape.result_slot, segment, live)


def register_live(plan: VjpPlan) -> int:
    """The most adjoints K1 keeps in registers at once (the values read
    within their own segment and not handed over)."""
    act, most = set(), 0
    ends, starts = {}, {}
    for t in range(plan.length - 1, -1, -1):
        if not plan.has[t]:
            continue
        for k, uses in ((0, USES_A), (1, USES_B)):
            s = int(plan.src[k, t])
            if uses[int(plan.ops[t])] and s >= 0 and plan.hpos[s] < 0:
                if s not in ends:
                    ends[s] = t
                    starts.setdefault(t, []).append(s)
    for t in range(plan.length - 1, -1, -1):
        act.discard(t)
        act.update(starts.get(t, ()))
        most = max(most, len(act))
    return most


# ---------------------------------------------------------------------------
# The kernels' algorithms in plain PyTorch (for the CPU tests)
# ---------------------------------------------------------------------------

class _Torch:
    """:func:`partials` on float32 tensors (and Python constants)."""

    @staticmethod
    def _t(v, like):
        return v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float32)

    def mul(self, a, b):
        return self._t(a, b) * self._t(b, a)

    def div(self, a, b):
        return torch.div(self._t(a, b), self._t(b, a))

    def add(self, a, b):
        return self._t(a, b) + self._t(b, a)

    def sub(self, a, b):
        return self._t(a, b) - self._t(b, a)

    def neg(self, a):
        return -a

    def sqrt(self, a):
        return torch.sqrt(a)

    def sin(self, a):
        return torch.sin(a)

    def cos(self, a):
        return torch.cos(a)

    def sel_ge0(self, a, p, q):
        return torch.where(a >= 0.0, p, q)

    def bal(self, code, side):
        me, other = (code & 1, code & 2) if side == 0 else (code & 2,
                                                            code & 1)
        return torch.where(me != 0, torch.where(other != 0, 0.5, 1.0),
                           0.0).to(torch.float32)


def forward_store(plan: VjpPlan, imms, values, x, y, z):
    """What a forward half stores, from every clause's value ``values``
    ((L, lanes) float32, the walk's outputs) and the inputs: ``(vals
    (n_vals, lanes), words (n_words, lanes) int64 holding 32 bits)``."""
    ins = {-1: x, -2: y, -3: z}

    def val(s):
        return values[s] if s >= 0 else ins.get(s, torch.zeros_like(x))
    vals = values[torch.from_numpy(np.flatnonzero(plan.vpos >= 0))]
    words = torch.zeros(max(plan.n_words, 1), x.shape[0], dtype=torch.int64)
    for t in np.flatnonzero(plan.cidx >= 0):
        op, c = int(plan.ops[t]), int(plan.cidx[t])
        r, a = values[t], val(int(plan.src[0, t]))
        q = (torch.full_like(r, float(imms[t])) if op in _IMM_CHOICE
             else val(int(plan.src[1, t])))
        code = (a == r).to(torch.int64) | ((q == r).to(torch.int64) << 1)
        words[c // 16] |= code << (2 * (c % 16))
    return vals, words


def _code(words, c):
    """Clause ``c``'s 2-bit choice code of each lane."""
    return (words[c // 16] >> (2 * (c % 16))) & 3


def _reader(plan, vals, words, x, y, z, imms):
    """``step(t, g, K)``: clause t's shares from what is stored."""
    ins = {-1: x, -2: y, -3: z}

    def value(s):
        if s >= 0:
            return vals[int(plan.vpos[s])]
        return ins.get(s, torch.zeros_like(x))

    def step(t, g, K):
        op = int(plan.ops[t])
        a = value(int(plan.src[0, t])) if NEEDS_A[op] else None
        b = value(int(plan.src[1, t])) if NEEDS_B[op] else None
        r = vals[int(plan.vpos[t])] if NEEDS_R[op] else None
        code = _code(words, int(plan.cidx[t])) if CHOICE[op] else None
        imm = torch.tensor(float(imms[t]), dtype=torch.float32)
        return partials(op, K, g, a, b, r, imm, code)
    return step


def replay_k1(plan: VjpPlan, imms, vals, words, x, y, z, g):
    """K1's reverse half in plain PyTorch: segments last first; within a
    segment adjoints in a dict (registers), across segments and where
    parked in ``hand`` (stored by the first contributor, added to by the
    rest, read by the value's clause); each immediate's share summed over
    the lanes.  Reads only ``vals``, the choice words ``words``, ``x, y,
    z, g`` and ``imms`` (:func:`forward_store`).  Returns the gradient
    (L,)."""
    L = plan.length
    grad = torch.zeros(L, dtype=torch.float32)
    hand = torch.empty(max(plan.n_handover, 1), x.shape[0])
    step = _reader(plan, vals, words, x, y, z, imms)
    K = _Torch()
    for t0, t1 in reversed(plan.segments):
        reg = {}
        for t in range(t1 - 1, t0 - 1, -1):
            if not plan.has[t]:
                continue
            if t == plan.result:
                gt = g
            elif plan.hpos[t] >= 0:
                gt = hand[int(plan.hpos[t])].clone()
            else:
                gt = reg.pop(t)
            da, db, di = step(t, gt, K)
            if di is not None:
                grad[t] = di.sum()
            got = {}
            for d, s in ((da, int(plan.src[0, t])), (db, int(plan.src[1, t]))):
                if d is None or s < 0:
                    continue
                got[s] = d if s not in got else got[s] + d
            for s, d in got.items():
                h = int(plan.hpos[s])
                if h < 0:
                    reg[s] = d if s not in reg else reg[s] + d
                elif plan.first[s] == t:
                    hand[h] = d
                else:
                    hand[h] += d
        if reg:
            raise AssertionError(f"adjoints left in registers: {sorted(reg)}")
    return grad


def replay_k2(plan: VjpPlan, words_tape, imms, vals, words, x, y, z, g,
              num_slots: int, result_slot: int):
    """K2 in plain PyTorch: the tape walked backwards over an adjoint file
    indexed by slot (``words_tape``: the packed clause words), each
    clause's operands read through K2's 16-bit codes
    (:meth:`VjpPlan.entry_codes`).  Returns the gradient (L,)."""
    L = plan.length
    ab, rc = plan.entry_codes()
    ins = {CODE_X: x, CODE_Y: y, CODE_Z: z}

    def value(code):
        code = int(code) & 0xFFFF
        if code < CODE_X:
            return vals[code]
        return ins.get(code, torch.zeros_like(x))
    adj = [torch.zeros_like(x) for _ in range(max(num_slots, 1))]
    adj[result_slot] = g.clone()
    grad = torch.zeros(L, dtype=torch.float32)
    K = _Torch()
    w = np.asarray(words_tape[:L]).astype(np.int64) & 0xFFFFFFFF
    for t in range(L - 1, -1, -1):
        op, out = int(w[t] & 0xFF), int((w[t] >> 8) & 0xFF)
        lhs, rhs = int((w[t] >> 16) & 0xFF), int(w[t] >> 24)
        gt = adj[out]
        adj[out] = torch.zeros_like(x)
        a, b = value(int(ab[t])), value(int(ab[t]) >> 16)
        r = value(int(rc[t]))
        ci = (int(rc[t]) >> 16) & 0xFFFF
        code = _code(words, ci) if ci != CODE_NONE else None
        imm = torch.tensor(float(imms[t]), dtype=torch.float32)
        da, db, di = partials(op, K, gt, a, b, r, imm, code)
        if da is not None:
            adj[lhs] = adj[lhs] + da
        if db is not None:
            adj[rhs] = adj[rhs] + db
        if di is not None:
            grad[t] = di.sum()
    return grad
