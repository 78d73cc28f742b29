"""Plain tape interpreters on tensors: one Python step per clause.

Counterpart of ``mpr_tpu.ops.eval_scan``.  The tape is data: the loop reads
the clause fields once on the host and applies :func:`kernels.float_clause`
or :func:`kernels.interval_clause` to whole lane tensors, so the same code
serves every tape on any device.  These are the portable statement of the
tape's semantics (the brute renderers use them; the CUDA kernels are the
fast path), and :func:`eval_f` is built from differentiable torch ops:
autograd gives d(result)/d(x, y, z) and d(result)/d(``td.imms``).
"""

from __future__ import annotations

import torch

from ..tape.opcodes import CHOICE_OP_HI, CHOICE_OP_LO, Op
from . import kernels
from .tape_data import TapeData


def _lanes(td, vals):
    """Broadcast the coordinate inputs to one shape, flattened, as f32
    tensors on the tape's device."""
    ts = [torch.as_tensor(v, dtype=torch.float32, device=td.device)
          for v in vals]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return [t.expand(shape).reshape(-1) for t in ts], shape


def eval_f(td: TapeData, x, y, z=None):
    """Evaluate the tape at concrete points.  Inputs broadcast; the result
    has the broadcast shape.  Differentiable w.r.t. x/y/z and ``td.imms``."""
    if z is None:
        z = 0.0
    (xf, yf, zf), shape = _lanes(td, (x, y, z))
    zero = torch.zeros_like(xf)
    regs = [zero] * max(td.num_slots, 1)
    for s, v in zip(td.axis_slots, (xf, yf, zf)):
        if s:
            regs[s] = v
    T = td.length
    ops, outs, lhss, rhss = kernels._decode(td.packed[:T])
    for t in range(T):
        op = ops[t]
        if op <= Op.JUMP:
            continue
        regs[outs[t]] = kernels.float_clause(op, regs[lhss[t]], regs[rhss[t]],
                                             td.imms[t])
    return regs[td.result_slot].reshape(shape)


def eval_i(td: TapeData, xl, xh, yl, yh, zl=None, zh=None):
    """Interval evaluation over lanes of boxes.

    Returns ``(lo, hi, choices)``; ``choices`` is ``(max(num_choices, 1),
    n) int8`` in min/max execution order (1 = LHS only, 2 = RHS only,
    0 = both)."""
    if zl is None:
        zl = zh = 0.0
    (xl, xh, yl, yh, zl, zh), _ = _lanes(td, (xl, xh, yl, yh, zl, zh))
    n = xl.shape[0]
    zero = torch.zeros_like(xl)
    regs = [(zero, zero)] * max(td.num_slots, 1)
    for s, v in zip(td.axis_slots, ((xl, xh), (yl, yh), (zl, zh))):
        if s:
            regs[s] = v
    T = td.length
    ops, outs, lhss, rhss = kernels._decode(td.packed[:T])
    imms = td.imms[:T].cpu().numpy().tolist()
    choices = torch.zeros(max(td.num_choices, 1), n, dtype=torch.int8,
                          device=td.device)
    ci = 0
    for t in range(T):
        op = ops[t]
        if op <= Op.JUMP:
            continue
        al, ah = regs[lhss[t]]
        bl, bh = regs[rhss[t]]
        lo, hi, c = kernels.interval_clause(op, al, ah, bl, bh, imms[t])
        regs[outs[t]] = (lo, hi)
        if CHOICE_OP_LO <= op <= CHOICE_OP_HI:
            choices[ci] = c.to(torch.int8)
            ci += 1
    lo, hi = regs[td.result_slot]
    return lo, hi, choices
