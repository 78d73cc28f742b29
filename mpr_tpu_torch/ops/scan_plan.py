"""The re-slotted tape of kernel K2f, made on the host.

Kernel K2f (``csrc/scan_adjoint.cu``) walks a tape's float clauses for
every lane; with ``STORE`` it also writes what the tape's storage plan
(``ops/vjp_plan.py``) lists for K2.  The tape's own slots were allocated in
the compiler's order, so a walk in that order keeps up to ``num_slots``
values live (173 at ``stress_2d(600)``).  This module rewrites the walk
once per tape, from the clauses alone (no immediate, no lane):

  * **order**: depth first over the clauses from the result and the
    min/max clauses (whose choice codes K2 reads), each clause right after
    the clauses it reads, the one of the larger Sethi–Ullman need first:
    ``unrolled_plan.schedule``'s rule, a statement a clause.  A clause
    that none of these reach is left out.  Reordering changes no clause's
    operands or rounding, so every value is the tape-order walk's.
  * **slots**: a file slot a value, from its clause to its last reader,
    the lowest free slot first (a linear scan: the file holds the live
    peak, not the tape's slots).  An operand that the previous clause of
    the walk made is read from a register (``A_ACC`` / ``B_ACC``), and a
    value read only that way takes no slot.  The inputs (and a zero, for
    a slot the tape reads before any clause writes it) take slots from
    the start.
  * **choice words**: a min/max clause's 2-bit code goes to word
    ``cidx // 16`` at bits ``2 * (cidx % 16)``, as in the tape-order walk,
    but the walk now meets a word's 16 clauses out of order.  Each word
    takes a file slot from its first clause (``W_FIRST``) to its last
    (``W_LAST``), which writes it out, once.  Stored values go out at
    their clause to their plan position (``spos``).

Each walk position is one 16-byte entry of four int32 planes (``w``,
``imm``, ``st``, ``fl``; :meth:`ScanPlan.entries` adds the immediates,
which change from call to call)::

    w  = op | out << 8 | lhs << 16 | rhs << 24   (file slots)
    st = spos | cidx << 16                        (0xFFFF: none)
    fl = A_ACC | B_ACC | KEEP | W_FIRST | W_LAST | word slot << 8

:func:`replay` runs the entries in plain PyTorch over the small file, as
the kernel does, filling the store in the plan's blocked layout; the CPU
tests hold it bit for bit to the tape-order walk and its store
(:func:`store_plain`).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from . import unrolled_plan as up
from . import vjp_plan as vp

A_ACC, B_ACC, KEEP, W_FIRST, W_LAST = 1, 2, 4, 8, 16
NONE16 = 0xFFFF
# slots of K2f's file at most (slot numbers are bytes)
MAX_FILE = 256
_INPUTS = ("x", "y", "z", "zero")       # sources -1, -2, -3, -4


@dataclass(frozen=True)
class ScanPlan:
    """A tape's re-slotted walk (module doc).  ``order`` gives each walk
    position's clause; ``w``, ``st``, ``fl`` are its entry planes (int32
    numpy); ``slots`` the file's slots (the live peak, at least 1);
    ``inputs`` the file slots of x, y, z and the zero (-1: not read);
    ``result`` the slot the result is read from at the end; ``form``
    ``"depth"`` or ``"tape"`` (tape order, where depth first would need
    more than ``MAX_FILE`` slots)."""
    order: np.ndarray
    w: np.ndarray
    st: np.ndarray
    fl: np.ndarray
    slots: int
    inputs: tuple
    result: int
    form: str

    @property
    def length(self) -> int:
        return int(self.order.shape[0])

    def planes(self, device):
        """``(order, entries)`` on ``device``: each position's clause
        (int64) and the walk's (length, 4) int32 entries with zero
        immediates (``TapeData.scan_plan`` keeps them)."""
        ent = np.stack([self.w, np.zeros_like(self.w), self.st, self.fl], 1)
        return (torch.from_numpy(self.order).to(device),
                torch.from_numpy(np.ascontiguousarray(ent)).to(device))

    def entries(self, imms: torch.Tensor, planes=None) -> torch.Tensor:
        """The walk's (length, 4) int32 entries on ``imms``' device, with
        the immediates of ``imms`` (a tape's plane) at their clauses;
        ``planes``: :meth:`planes` on that device, if kept."""
        order, ent = planes or self.planes(imms.device)
        ent = ent.clone()
        ent[:, 1] = imms.detach()[order].view(torch.int32)
        return ent


def _reads(plan: vp.VjpPlan, t: int):
    """The operand sources clause ``t`` reads: (side, source) for the lhs
    (side 0) and the rhs (side 1) where its float rule reads them."""
    op = int(plan.ops[t])
    return [(k, int(plan.src[k, t])) for k, uses in ((0, vp.USES_A),
                                                     (1, vp.USES_B))
            if uses[op]]


def _roots(plan: vp.VjpPlan):
    return ([plan.result] if plan.result >= 0 else []) + [
        int(t) for t in np.flatnonzero(plan.cidx >= 0)]


def walk_order(plan: vp.VjpPlan, form: str = "depth") -> np.ndarray:
    """The clauses the walk computes, in its order: the result's and the
    min/max clauses' cone, depth first (``unrolled_plan.schedule`` over a
    statement a clause) or in tape order."""
    roots = _roots(plan)
    cone = np.zeros(plan.length, bool)
    stack = list(roots)
    while stack:
        t = stack.pop()
        if not cone[t]:
            cone[t] = True
            stack.extend(s for _, s in _reads(plan, t) if s >= 0)
    if form == "tape":
        return np.flatnonzero(cone).astype(np.int64)
    name = lambda s: f"c{s}" if s >= 0 else _INPUTS[-1 - s]  # noqa: E731
    stmts = [up.Stmt(n, "float", "in", (0,), -1) for n in _INPUTS]
    stmts += [up.Stmt(f"c{t}", "float", "clause",
                      tuple(name(s) for _, s in _reads(plan, t)), int(t))
              for t in np.flatnonzero(cone)]
    order = up.schedule(stmts, tuple(f"c{t}" for t in roots))
    return np.array([s.clause for s in order if s.clause >= 0], np.int64)


def _allocate(plan: vp.VjpPlan, order: np.ndarray, form: str) -> ScanPlan:
    P = len(order)
    pos = {int(t): p for p, t in enumerate(order)}
    # each operand read: through the register (made by the previous
    # position) or from the file; the file reads' last positions
    acc = np.zeros((2, P), bool)
    last = {}
    for p, t in enumerate(order):
        for k, s in _reads(plan, int(t)):
            if s >= 0 and pos[s] == p - 1:
                acc[k, p] = True
            else:
                last[s] = p
    last[plan.result] = P                     # read at the end
    # each choice word's first and last walk positions
    wpos = {}
    for t in np.flatnonzero(plan.cidx >= 0):
        wd, p = int(plan.cidx[t]) >> 4, pos[int(t)]
        lo, hi = wpos.get(wd, (p, p))
        wpos[wd] = (min(lo, p), max(hi, p))
    free, top = [], [0]

    def take():
        if free:
            return heapq.heappop(free)
        top[0] += 1
        return top[0] - 1
    slot = {s: take() for s in (-1, -2, -3, -4) if s in last}
    ends = {}
    for s, e in last.items():
        ends.setdefault(e, []).append(s)
    w = np.zeros(P, np.int64)
    st = np.zeros(P, np.int64)
    fl = np.zeros(P, np.int64)
    wslot = {}
    for p, t in enumerate(order):
        t = int(t)
        for s in ends.get(p, ()):             # read here for the last time
            if s in slot:
                heapq.heappush(free, slot[s])
        op = int(plan.ops[t])
        f = A_ACC | B_ACC
        lhs = rhs = 0
        for k, s in _reads(plan, t):
            if not acc[k, p]:
                f &= ~(A_ACC, B_ACC)[k]
                if k == 0:
                    lhs = slot[s]
                else:
                    rhs = slot[s]
        out = 0
        if t in last:
            out = slot[t] = take()
            f |= KEEP
        closed = None
        c = int(plan.cidx[t])
        if c >= 0:
            lo, hi = wpos[c >> 4]
            f |= (W_FIRST if p == lo else 0) | (W_LAST if p == hi else 0)
            if p == lo and p != hi:
                wslot[c >> 4] = take()
            ws = wslot.get(c >> 4, 0)
            f |= ws << 8
            if p == hi and p != lo:
                closed = ws
        if closed is not None:                # after the clause's writes
            heapq.heappush(free, closed)
        w[p] = op | out << 8 | lhs << 16 | rhs << 24
        sp = int(plan.vpos[t])
        st[p] = (sp if sp >= 0 else NONE16) | (c if c >= 0 else NONE16) << 16
        fl[p] = f
    slots = max(top[0], 1)
    as32 = lambda a: a.astype(np.uint32).view(np.int32)  # noqa: E731
    return ScanPlan(order, as32(w), as32(st), as32(fl), slots,
                    tuple(slot.get(s, -1) for s in (-1, -2, -3, -4)),
                    slot[plan.result], form)


def scan_plan(plan: vp.VjpPlan) -> ScanPlan:
    """The re-slotted walk of the tape of ``plan`` (its storage plan): depth
    first, or in tape order where depth first would need more than
    ``MAX_FILE`` slots (tape order never needs more than the tape's slots
    and one open word)."""
    sp = _allocate(plan, walk_order(plan, "depth"), "depth")
    if sp.slots <= MAX_FILE:
        return sp
    sp = _allocate(plan, walk_order(plan, "tape"), "tape")
    if sp.slots > MAX_FILE:
        raise ValueError(f"K2f's file needs {sp.slots} slots, over "
                         f"{MAX_FILE}")
    return sp


# ---------------------------------------------------------------------------
# The walk in plain PyTorch (for the CPU tests and the card's checks)
# ---------------------------------------------------------------------------

def _blocked(rows: torch.Tensor, lanes: int, dtype) -> torch.Tensor:
    """``rows`` (R, lanes) in the plan's blocked layout, flat
    (``vjp_plan.blocked_size(R, lanes)`` entries, zero in the padding)."""
    R = max(rows.shape[0], 1)
    nb = -(-lanes // vp.LANE_BLOCK)
    out = torch.zeros(R, nb * vp.LANE_BLOCK, dtype=dtype)
    out[:rows.shape[0], :lanes] = rows.to(dtype)
    return out.reshape(R, nb, vp.LANE_BLOCK).transpose(0, 1).reshape(-1)


def replay(sp: ScanPlan, plan: vp.VjpPlan, imms, x, y, z):
    """Kernel K2f's walk in plain PyTorch from the entries alone: the file
    of ``sp.slots`` slots, the previous value in a register, each stored
    value written at its clause and each choice word at its last clause.
    Returns ``(v, vals, words)``: the result a lane, and the store in the
    blocked layout (float32, and int32 holding the 32 bits)."""
    from .kernels import float_clause
    n = x.shape[0]
    ent = sp.entries(torch.as_tensor(imms, dtype=torch.float32))
    e = ent.numpy().astype(np.int64) & 0xFFFFFFFF
    imm = ent[:, 1].view(torch.float32)
    zero = torch.zeros_like(x)
    file = [zero] * sp.slots
    for s, val in zip(sp.inputs, (x, y, z, zero)):
        if s >= 0:
            file[s] = val
    vals = torch.zeros(max(plan.n_vals, 1), n)
    words = torch.zeros(max(plan.n_words, 1), n, dtype=torch.int64)
    accv = zero
    for p in range(sp.length):
        w, st, f = int(e[p, 0]), int(e[p, 2]), int(e[p, 3])
        op = w & 0xFF
        a = accv if f & A_ACC else file[(w >> 16) & 0xFF]
        b = accv if f & B_ACC else file[(w >> 24) & 0xFF]
        r = a * 0.0 if op <= 1 else float_clause(op, a, b, imm[p])
        accv = r
        if f & KEEP:
            file[(w >> 8) & 0xFF] = r
        if st & 0xFFFF != NONE16:
            vals[st & 0xFFFF] = r
        c = st >> 16
        if c != NONE16:
            q = torch.full_like(r, float(imm[p])) if op in (17, 19) else b
            code = (a == r).to(torch.int64) | ((q == r).to(torch.int64) << 1)
            code = code << (2 * (c & 15))
            ws = (f >> 8) & 0xFF
            word = code if f & W_FIRST else file[ws] | code
            if f & W_LAST:
                words[c >> 4] = word
            else:
                file[ws] = word
    v = file[sp.result]
    return (v, _blocked(vals, n, torch.float32),
            _words32(_blocked(words, n, torch.int64)))


def _words32(w: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32 bits -> int32 with the same bits."""
    w = w & 0xFFFFFFFF
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def store_plain(td, x, y, z):
    """The tape-order walk and its store: ``(v, vals, words)`` as
    :func:`replay` gives them, from every clause's value of the plain walk
    (``vjp_plan.forward_store``).  The plain version of K2f storing, on
    the tape's device."""
    from .kernels import _decode, float_clause
    plan = td.vjp_plan()[0]
    x, y, z = (t.detach().reshape(-1).float() for t in (x, y, z))
    n = x.shape[0]
    zero = torch.zeros_like(x)
    regs = [zero] * max(td.num_slots, 1)
    for s, val in zip(td.axis_slots, (x, y, z)):
        if s:
            regs[s] = val
    L = td.length
    ops, outs, lhss, rhss = _decode(td.packed[:L])
    imms = td.imms.detach()[:L]
    values = []
    for t in range(L):
        a, b = regs[lhss[t]], regs[rhss[t]]
        r = a * 0.0 if ops[t] <= 1 else float_clause(ops[t], a, b, imms[t])
        regs[outs[t]] = r
        values.append(r)
    values = torch.stack(values) if values else zero[None, :0]
    vals, words = vp.forward_store(plan, imms.cpu(), values.cpu(), x.cpu(),
                                   y.cpu(), z.cpu())
    dev = x.device
    return (regs[td.result_slot], _blocked(vals, n, torch.float32).to(dev),
            _words32(_blocked(words, n, torch.int64)).to(dev))
