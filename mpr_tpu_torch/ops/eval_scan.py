"""Tape interpreters on tensors: the tape is data.

Counterpart of ``mpr_tpu.ops.eval_scan``.  The plain walks read the clause
fields once on the host and apply :func:`kernels.float_clause` or
:func:`kernels.interval_clause` to whole lane tensors, one Python step a
clause, so the same code serves every tape on any device: the portable
statement of the tape's semantics, differentiable with autograd in the
coordinates and in ``td.imms`` (with ``jax.grad``'s rules,
``transcendental.abs`` / ``minimum`` / ``maximum``).

:func:`eval_f` is also the float path of the ``--engine scan`` fit on the
card: on CUDA it runs kernel K2f (``csrc/scan_adjoint.cu``: a thread a
lane walks the tape over a register file) and, under autograd in
``td.imms``, its backward is kernel K2 (the adjoint walk, with K2f
keeping every clause's value, in chunks of lanes of at most
``VALS_BYTES``).  Their plain versions are :func:`eval_f_plain` and
autograd through it.
"""

from __future__ import annotations

import torch

from ..tape.opcodes import CHOICE_OP_HI, CHOICE_OP_LO, Op
from . import build, kernels
from .tape_data import TapeData

# the bytes of forward values (clauses x lanes floats) one K2 launch reads:
# the backward pass runs K2f and K2 in chunks of lanes within this
VALS_BYTES = 1 << 30
# blocks of a K2 launch at most (its grid-stride loop takes the rest), and
# so the rows of its partial sums
ADJ_BLOCKS = 1024


def _lanes(td, vals):
    """Broadcast the coordinate inputs to one shape, flattened, as f32
    tensors on the tape's device."""
    ts = [torch.as_tensor(v, dtype=torch.float32, device=td.device)
          for v in vals]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return [t.expand(shape).reshape(-1) for t in ts], shape


def _walk_f(td: TapeData, xf, yf, zf):
    """The plain float walk over flat lanes.  INVALID / JUMP clauses write
    ``a * 0`` to their slot, as ``mpr_tpu``'s branch table does."""
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
            regs[outs[t]] = regs[lhss[t]] * 0.0
            continue
        regs[outs[t]] = kernels.float_clause(op, regs[lhss[t]], regs[rhss[t]],
                                             td.imms[t])
    return regs[td.result_slot]


def eval_f_plain(td: TapeData, x, y, z=None):
    """The plain walk on the tape's device: the tape at concrete points,
    inputs broadcast, the result in the broadcast shape.  Differentiable
    in x/y/z and ``td.imms``."""
    if z is None:
        z = 0.0
    (xf, yf, zf), shape = _lanes(td, (x, y, z))
    return _walk_f(td, xf, yf, zf).reshape(shape)


def eval_f(td: TapeData, x, y, z=None):
    """Evaluate the tape at concrete points.  Inputs broadcast; the result
    has the broadcast shape.  On the CPU the plain walk (differentiable in
    x/y/z and ``td.imms``); on the card kernel K2f, differentiable in
    ``td.imms`` through kernel K2 (coordinate gradients there take
    :func:`eval_f_plain`)."""
    if z is None:
        z = 0.0
    (xf, yf, zf), shape = _lanes(td, (x, y, z))
    if td.device.type != "cuda":
        return _walk_f(td, xf, yf, zf).reshape(shape)
    if any(t.requires_grad for t in (xf, yf, zf)):
        raise RuntimeError("eval_f's kernels differentiate in td.imms only: "
                           "coordinate gradients take eval_f_plain")
    if td.imms.requires_grad and torch.is_grad_enabled():
        return _ScanFn.apply(td.imms, xf, yf, zf, td).reshape(shape)
    return scan_eval(td, xf, yf, zf).reshape(shape)


class _ScanFn(torch.autograd.Function):
    """:func:`eval_f` on the card under autograd: forward K2f, backward
    K2 (:func:`scan_adjoint`)."""

    @staticmethod
    def forward(ctx, imms, x, y, z, td):
        ctx.td = td.replace_imms(imms.detach())
        ctx.save_for_backward(x, y, z)
        return scan_eval(ctx.td, x, y, z)

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        return scan_adjoint(ctx.td, x, y, z, g), None, None, None, None


def _flat(t):
    return t.detach().reshape(-1).contiguous()


def scan_eval(td: TapeData, x, y, z, vals=None):
    """Kernel K2f on CUDA tapes (counted in ``scan_eval.launches``): the
    tape on flat f32 lanes x, y, z; with ``vals`` (a (length, n) f32
    tensor) also every clause's output.  On the CPU its plain version,
    :func:`eval_f_plain` (which fills no ``vals``)."""
    if td.device.type != "cuda":
        return _walk_f(td, x, y, z)
    x, y, z = _flat(x), _flat(y), _flat(z)
    n = x.shape[0]
    v = torch.empty(n, dtype=torch.float32, device=td.device)
    if n == 0:
        return v
    imms = td.imms.detach().contiguous()
    with torch.cuda.device(td.device):
        err = build.lib().mpr_scan_adjoint_eval(
            td.packed.data_ptr(), imms.data_ptr(), x.data_ptr(),
            y.data_ptr(), z.data_ptr(), v.data_ptr(),
            None if vals is None else vals.data_ptr(), n, td.length,
            max(td.num_slots, 1), td.result_slot, *td.axis_slots,
            kernels._stream())
    if err:
        raise RuntimeError(f"kernel K2f failed: CUDA error {err}")
    _scan_eval.launches += 1
    return v


def scan_adjoint(td: TapeData, x, y, z, g):
    """Kernel K2 on CUDA tapes (counted in ``scan_adjoint.launches``):
    d(sum(g * eval_f(td, x, y, z)))/d(td.imms), the capacity's length
    (zero past the tape), over flat f32 lanes, in chunks of lanes whose
    forward values (K2f, ``vals``) fit ``VALS_BYTES``.  On the CPU its
    plain version, autograd through :func:`eval_f_plain`."""
    if td.device.type != "cuda":
        imms = td.imms.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = _walk_f(td.replace_imms(imms), x.detach(), y.detach(),
                        z.detach())
            out, = torch.autograd.grad(v, imms, g.reshape(v.shape),
                                       allow_unused=True)
        return torch.zeros_like(imms) if out is None else out
    x, y, z, g = _flat(x), _flat(y), _flat(z), _flat(g)
    n, L = x.shape[0], td.length
    grad = torch.zeros(td.capacity, dtype=torch.float32, device=td.device)
    if n == 0 or L == 0:
        return grad
    src = td.sources()
    imms = td.imms.detach().contiguous()
    chunk = max(1, min(n, VALS_BYTES // (4 * L)))
    lib = build.lib()
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        m = c1 - c0
        vals = torch.empty(L, m, dtype=torch.float32, device=td.device)
        scan_eval(td, x[c0:c1], y[c0:c1], z[c0:c1], vals=vals)
        blocks = min(ADJ_BLOCKS, -(-m // 128))
        partials = torch.empty(blocks, L, dtype=torch.float32,
                               device=td.device)
        with torch.cuda.device(td.device):
            err = lib.mpr_scan_adjoint(
                td.packed.data_ptr(), imms.data_ptr(), src.data_ptr(),
                x[c0:].data_ptr(), y[c0:].data_ptr(), z[c0:].data_ptr(),
                vals.data_ptr(), g[c0:].data_ptr(), partials.data_ptr(),
                grad.data_ptr(), m, L, max(td.num_slots, 1), td.result_slot,
                int(c0 > 0), blocks, kernels._stream())
        if err:
            raise RuntimeError(f"kernel K2 failed: CUDA error {err}")
        _scan_adjoint.launches += 1
    return grad


scan_eval.launches = 0
scan_adjoint.launches = 0
# the counters' homes, kept if a module attribute is rebound (a recorder)
_scan_eval = scan_eval
_scan_adjoint = scan_adjoint


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
