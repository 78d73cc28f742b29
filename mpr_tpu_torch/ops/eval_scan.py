"""Tape interpreters on tensors: the tape is data.

Counterpart of ``mpr_tpu.ops.eval_scan``.  The plain walks read the clause
fields once on the host and apply :func:`kernels.float_clause` or
:func:`kernels.interval_clause` to whole lane tensors, one Python step a
clause, so the same code serves every tape on any device: the portable
statement of the tape's semantics, differentiable with autograd in the
coordinates and in ``td.imms`` (with ``jax.grad``'s rules,
``transcendental.abs`` / ``minimum`` / ``maximum``).

:func:`eval_f` is also the float path of the ``--engine scan`` fit and of
every dense evaluation on the card: on CUDA it runs kernel K2f
(``csrc/scan_eval.cu``: the tape's re-slotted walk, ``ops/scan_plan.py``,
``TapeData.scan_plan``, over a file of the walk's live peak in shared
memory, K lanes a thread) and, under autograd in ``td.imms``, its backward
is kernel K2 (the adjoint walk over an on-chip adjoint file, K lanes a
thread, after K2f has stored what the tape's storage plan lists:
``ops/vjp_plan.py``, ``TapeData.vjp_plan``), in chunks of lanes of at most
``ADJ_BYTES`` of stored values.  Where all the lanes fit one chunk, the
forward pass stores the plan and keeps it for the backward pass: one K2f
launch a step.  Their plain versions are :func:`eval_f_plain`,
``scan_plan.store_plain`` and autograd through them.
"""

from __future__ import annotations

import torch

from ..tape.opcodes import CHOICE_OP_HI, CHOICE_OP_LO, Op
from ..utils.trace import span
from . import build, kernels
from . import launch as ln
from . import scan_plan as spm
from . import vjp_plan as vp
from .tape_data import TapeData

# the bytes of what K2f stores for K2 (the plan's values and choice words,
# VjpPlan.k2_lane_bytes a lane) one launch pair uses: the backward pass
# runs K2f and K2 in chunks of lanes within this
ADJ_BYTES = 8 << 30


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
    K2 (:func:`scan_adjoint`).  Where the lanes fit one chunk of K2, the
    forward launch of K2f stores the plan and the backward pass reads it
    (it holds ``VjpPlan.k2_lane_bytes`` a lane in between); otherwise the
    backward pass runs K2f again, storing, a chunk at a time."""

    @staticmethod
    def forward(ctx, imms, x, y, z, td):
        with span("mpr.fit.K2f"):
            ctx.td = td.replace_imms(imms.detach())
            ctx.save_for_backward(x, y, z)
            n = x.shape[0]
            ctx.store = None
            if 0 < n <= adj_chunk(ctx.td.vjp_plan()[0], n):
                ctx.store = k2_store(ctx.td, n)
            return scan_eval(ctx.td, x, y, z, store=ctx.store)

    @staticmethod
    def backward(ctx, g):
        # autograd runs this on its own thread for a card's tensors: the
        # span opens here, on the thread that launches K2
        with span("mpr.fit.K2"):
            x, y, z = ctx.saved_tensors
            grad = scan_adjoint(ctx.td, x, y, z, g, store=ctx.store)
            ctx.store = None
            return grad, None, None, None, None


def _flat(t):
    return t.detach().reshape(-1).contiguous()


def scan_eval(td: TapeData, x, y, z, store=None, launch=None):
    """Kernel K2f on CUDA tapes (counted in ``scan_eval.launches``): the
    tape on flat f32 lanes x, y, z by its re-slotted walk
    (``TapeData.scan_plan``) at ``launch`` (default
    ``launch.scan_launch(slots, n)``; a caller's shape is checked); with
    ``store = (vals, words)`` also what the tape's storage plan lists
    (``TapeData.vjp_plan``): the values K2's partials read and the choice
    words, f32 and int32 tensors in the plan's blocked layout
    (``vjp_plan.blocked_size(n_vals, n)`` and ``blocked_size(n_words, n)``
    entries at least; entries of lanes past ``n`` are not written).  On the
    CPU its plain version: the tape-order walk (:func:`eval_f_plain`) and,
    with ``store``, its store (``scan_plan.store_plain``; ``launch`` is not
    read)."""
    if td.device.type != "cuda":
        if store is None:
            return _walk_f(td, x, y, z)
        v, vals, words = spm.store_plain(td, x, y, z)
        store[0][:vals.numel()] = vals
        store[1][:words.numel()] = words
        return v
    x, y, z = _flat(x), _flat(y), _flat(z)
    n = x.shape[0]
    v = torch.empty(n, dtype=torch.float32, device=td.device)
    if n == 0:
        return v
    sp, planes = td.scan_plan()
    launch = (ln.scan_launch(sp.slots, n) if launch is None
              else ln.check_scan_launch(launch, sp.slots))
    vals, words, nv, nw = _store_args(td, store, n)
    entries = sp.entries(td.imms, planes)
    with torch.cuda.device(td.device):
        err = build.lib().mpr_scan_eval(
            entries.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
            v.data_ptr(), vals, words, n, nv, nw, sp.length, sp.slots,
            *sp.inputs, sp.result, ln.scan_blocks(launch, sp.slots, n),
            launch.threads, launch.k, launch.smem(sp.slots),
            kernels._stream())
    if err:
        raise RuntimeError(f"kernel K2f failed: CUDA error {err}")
    _scan_eval.launches += 1
    return v


def _store_args(td, store, n):
    """The store's pointers (None without one) and rows, checked against
    the plan's layout over ``n`` lanes."""
    if store is None:
        return None, None, 1, 1
    plan = td.vjp_plan()[0]
    nv, nw = max(plan.n_vals, 1), max(plan.n_words, 1)
    vals, words = store
    if (vals.numel() < vp.blocked_size(nv, n)
            or words.numel() < vp.blocked_size(nw, n)):
        raise ValueError("K2f's store is smaller than the plan's layout")
    return vals.data_ptr(), words.data_ptr(), nv, nw


def scan_eval_first(td: TapeData, x, y, z, store=None):
    """K2f's first design on CUDA tapes (the extra library; not counted):
    a thread a lane over a local array of the tape's slots, in the tape's
    order.  The card's runs time it beside :func:`scan_eval` on the same
    launches and hold the two to the same bits; no path calls it.  On the
    CPU the same plain version as :func:`scan_eval`."""
    if td.device.type != "cuda":
        return scan_eval(td, x, y, z, store=store)
    x, y, z = _flat(x), _flat(y), _flat(z)
    n = x.shape[0]
    v = torch.empty(n, dtype=torch.float32, device=td.device)
    if n == 0:
        return v
    vals, words, nv, nw = _store_args(td, store, n)
    spos = td.vjp_plan()[1] if store is not None else None
    with torch.cuda.device(td.device):
        err = build.lib("extra").mpr_scan_eval_first(
            td.packed.data_ptr(), td.imms.detach().contiguous().data_ptr(),
            None if spos is None else spos.data_ptr(), x.data_ptr(),
            y.data_ptr(), z.data_ptr(), v.data_ptr(), vals, words, n, nv,
            nw, td.length, max(td.num_slots, 1), td.result_slot,
            *td.axis_slots, kernels._stream())
    if err:
        raise RuntimeError(f"K2f's first design failed: CUDA error {err}")
    return v


def adjoint_s_cap(td: TapeData) -> int:
    """The slots of K2's adjoint file for ``td``: its slot count rounded
    up to 8 (as the 3D kernels size their register files)."""
    return max(8, -(-td.num_slots // 8) * 8)


def adj_chunk(plan, n: int) -> int:
    """Lanes of one K2f/K2 launch pair over ``n`` lanes."""
    return max(1, min(n, ADJ_BYTES // max(plan.k2_lane_bytes, 4)))


def _k2_lanes(launch, m: int) -> int:
    """Lanes K2 walks for ``m`` lanes at ``launch``: whole lane groups."""
    return -(-m // launch.lanes) * launch.lanes


def k2_store(td: TapeData, n: int):
    """New tensors for K2f's store of ``n`` lanes as K2 reads it at its
    default shape (``(vals, words)`` over K2's whole lane groups)."""
    plan = td.vjp_plan()[0]
    ld = _k2_lanes(ln.adjoint_launch(adjoint_s_cap(td), td.length), n)
    return (torch.empty(vp.blocked_size(plan.n_vals, ld),
                        dtype=torch.float32, device=td.device),
            torch.empty(vp.blocked_size(plan.n_words, ld), dtype=torch.int32,
                        device=td.device))


def scan_adjoint(td: TapeData, x, y, z, g, launch=None, s_cap=None,
                 store=None):
    """Kernel K2 on CUDA tapes (counted in ``scan_adjoint.launches``, one
    a chunk of lanes): d(sum(g * eval_f(td, x, y, z)))/d(td.imms), the
    capacity's length (zero past the tape), over flat f32 lanes.  Each
    chunk runs K2f storing the tape's plan (:func:`scan_eval` with
    ``store``), then K2 at ``launch`` (default
    ``launch.adjoint_launch(s_cap, length)``; a caller's shape is
    checked) with an adjoint file of ``s_cap`` slots (default
    :func:`adjoint_s_cap`; a tape with more slots traps), then the sum of
    its blocks' rows.  ``store``: K2f's store of all the lanes, made
    already (:func:`k2_store`, one chunk), which K2 reads instead.  On the
    CPU its plain version, autograd through :func:`eval_f_plain`
    (``launch``, ``s_cap`` and ``store`` are not read)."""
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
    s_cap = adjoint_s_cap(td) if s_cap is None else int(s_cap)
    launch = (ln.adjoint_launch(s_cap, L) if launch is None
              else ln.check_adjoint_launch(launch, s_cap, L))
    plan, _, ab, rc = td.vjp_plan()
    imms = td.imms.detach().contiguous()
    entries = torch.stack([td.packed[:L], imms[:L].view(torch.int32), ab, rc],
                          1).contiguous()
    lib = build.lib(ln.library("scan_adjoint", launch))
    chunk = adj_chunk(plan, n)
    nv, nw = max(plan.n_vals, 1), max(plan.n_words, 1)
    if store is not None:
        if chunk < n:
            raise ValueError("a store made ahead serves K2 in one chunk")
        _store_args(td, store, _k2_lanes(launch, n))      # large enough
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        m = c1 - c0
        ld = _k2_lanes(launch, m)
        if store is None:
            vals, words = vp.workspace("K2", td.device, [
                (vp.blocked_size(nv, ld), torch.float32),
                (vp.blocked_size(nw, ld), torch.int32)])
            scan_eval(td, x[c0:c1], y[c0:c1], z[c0:c1], store=(vals, words))
        else:
            vals, words = store
        blocks = min(ln.ADJ_BLOCKS, ld // launch.lanes)
        partials = torch.empty(blocks, L, dtype=torch.float32,
                               device=td.device)
        with torch.cuda.device(td.device):
            err = lib.mpr_scan_adjoint(
                entries.data_ptr(), vals.data_ptr(), words.data_ptr(),
                x[c0:].data_ptr(), y[c0:].data_ptr(), z[c0:].data_ptr(),
                g[c0:].data_ptr(), partials.data_ptr(), grad.data_ptr(), m,
                ld, nv, nw, L, max(td.num_slots, 1), s_cap, td.result_slot,
                int(c0 > 0), blocks, launch.bucket, launch.threads,
                launch.k, launch.smem, kernels._stream())
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
