"""The interpreter kernels: CUDA wrappers and their plain PyTorch versions.

Three kernels carry the 2D interpreter render, each written by hand in
CUDA for Hopper (sources in ``csrc/``, built by ``build.py``):

  * kernel A, :func:`interval_shorten` — interval evaluation of one shared
    tape over many tiles, tile classification, and the backward
    mark-and-sweep that emits a 4-bit shorten code per clause;
  * kernel C, :func:`compact_bitshift_batched` — compacts each ambiguous
    tile's kept clauses into a dense tape and extracts its opcode runs;
  * kernel B, :func:`pixel_eval_runs` — evaluates every pixel of each
    ambiguous tile with its shortened tape, and writes the interval
    decision of every other tile.

Three more are the earlier public versions of kernels B and C, which no
render path calls any more; they are public functions here as they are in
``mpr_tpu.ops.kernels``:

  * kernel B1, :func:`pixel_eval` — the values of each group's pixels on
    its tile's own tape, whose opcode runs it finds itself (kernel B's
    register file and run walk; launch shape ``launch.pixel_v1_launch``);
  * kernel C1, :func:`compact_runs` — compaction straight from kernel A's
    codes (no prepass), opcodes kept in the words, run headers (kernel C's
    row groups; launch shape ``launch.compact_runs_launch``);
  * kernel C2, :func:`compact_bitshift` — kernel C with order indirection.

Each wrapper launches its kernel for CUDA tensors (and raises if it
cannot), and runs the plain PyTorch version beside it, with the same
signature and outputs, only when its inputs lie on the CPU.  The plain
versions are what the CPU tests hold against the JAX package, and what a
run on the card holds the kernels against.  Each wrapper counts the
launches of its kernel in ``<wrapper>.launches``.

Tape word layout: int32 = op | out<<8 | lhs<<16 | rhs<<24; imm rides in a
parallel f32 plane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tape.opcodes import CHOICE_OP_HI, CHOICE_OP_LO, NUM_OPS, Op
from . import build
from . import interval_math as im
from . import launch as ln
from . import schedule as sch
from . import transcendental as tc

# Tile status.
ST_EMPTY = 0
ST_FILLED = 1
ST_AMBIG = 2

# Shorten codes (4-bit, packed 8 per int32 word, nibble t % 8 of word t // 8).
CODE_DROP = 0
CODE_KEEP = 1
CODE_COPY_LHS = 2
CODE_COPY_RHS = 3
CODE_COPY_IMM = 4

SLOT_CAP = 192
# Slot numbers are bytes: a register file holds at most this many slots.
REG_CAP = 256


def build_remap(ops_present):
    """Branch table spec: returns (branch_ops tuple, remap np array (32,)).

    Branch id 0 is a no-op; branch id ``i + 1`` runs ``branch_ops[i]``.
    COPY_IMM is always present (shortening can emit it); ``ops_present``
    order is preserved."""
    extra = [int(Op.COPY_IMM)]
    seen = set()
    branch_ops = []
    for o in tuple(ops_present) + tuple(extra):
        o = int(o)
        if o in (0, 1) or o in seen:
            continue
        seen.add(o)
        branch_ops.append(o)
    remap = np.zeros(NUM_OPS, dtype=np.int32)
    for i, o in enumerate(branch_ops):
        remap[o] = i + 1
    return tuple(branch_ops), remap


def bid_table(branch_ops) -> np.ndarray:
    """Inverse of the remap: int32[256] branch id -> opcode (0 = no-op)."""
    table = np.zeros(256, dtype=np.int32)
    table[1:len(branch_ops) + 1] = branch_ops
    return table


# ---------------------------------------------------------------------------
# Wrapper plumbing
# ---------------------------------------------------------------------------

def _on_cuda(*tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; anything else is an error."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream():
    """The current stream as the C functions take it."""
    return torch.cuda.current_stream().cuda_stream


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


_BID_TABLES = {}


def _bid_table_on(branch_ops, dev) -> torch.Tensor:
    """:func:`bid_table` of ``branch_ops`` on ``dev``, copied there once
    per (branch set, device) and kept."""
    key = (tuple(branch_ops), str(dev))
    table = _BID_TABLES.get(key)
    if table is None:
        table = _BID_TABLES[key] = torch.as_tensor(bid_table(branch_ops),
                                                   device=dev)
    return table


# ---------------------------------------------------------------------------
# Interval clause semantics (kernels.py:83-317 of the JAX package)
# ---------------------------------------------------------------------------

def _sq(al, ah):
    neg = ah < 0.0
    pos = al > 0.0
    ll, hh = al * al, ah * ah
    lo = torch.where(neg, hh, torch.where(pos, ll, 0.0))
    hi = torch.where(torch.abs(al) > torch.abs(ah), ll, hh)
    hi = torch.where(neg, ll, torch.where(pos, hh, hi))
    return lo, hi


def _nan_where(bad, lo, hi):
    nan = float("nan")
    return torch.where(bad, nan, lo), torch.where(bad, nan, hi)


def _iv_div(al, ah, bl, bh):
    spans = (bl <= 0.0) & (bh >= 0.0)
    sbl = torch.where(spans, -1.0, bl)
    sbh = torch.where(spans, 1.0, bh)
    x_neg = ah < 0.0
    x_mix = ~x_neg & (al < 0.0)
    y_neg = bh < 0.0
    cases = [x_neg & y_neg, x_neg & ~y_neg, x_mix & y_neg, x_mix & ~y_neg]
    lo = im.select(torch, cases, [ah / sbl, al / sbl, ah / sbh, al / sbl],
                   torch.where(y_neg, ah / sbh, al / sbh))
    hi = im.select(torch, cases, [al / sbh, ah / sbh, al / sbh, ah / sbl],
                   torch.where(y_neg, al / sbl, ah / sbl))
    return torch.where(spans, -float("inf"), lo), torch.where(
        spans, float("inf"), hi)


def interval_clause(op: int, al, ah, bl, bh, imm: float):
    """Interval eval of one clause for all lanes: ``(lo, hi, choice)``,
    ``choice`` None for ops that record none.  ``imm`` is the clause's f32
    immediate as a Python float."""
    c = None
    if op == Op.SQUARE_LHS:
        lo, hi = _sq(al, ah)
    elif op == Op.SQRT_LHS:
        lo = torch.where(al <= 0.0, 0.0, tc.sqrt(torch.clamp_min(al, 0.0)))
        hi = tc.sqrt(torch.clamp_min(ah, 0.0))
        lo, hi = _nan_where(ah < 0.0, lo, hi)
    elif op == Op.NEG_LHS:
        lo, hi = -ah, -al
    elif op in (Op.SIN_LHS, Op.COS_LHS):
        # reference quirk: interval sin/cos are always [-1, 1]
        lo, hi = torch.full_like(al, -1.0), torch.full_like(ah, 1.0)
    elif op == Op.ASIN_LHS:
        bad = (ah < -1.0) | (al > 1.0)
        lo, hi = _nan_where(bad, tc.asin(torch.clamp(al, -1.0, 1.0)),
                            tc.asin(torch.clamp(ah, -1.0, 1.0)))
    elif op == Op.ACOS_LHS:
        bad = (ah < -1.0) | (al > 1.0)
        lo, hi = _nan_where(bad, tc.acos(torch.clamp(ah, -1.0, 1.0)),
                            tc.acos(torch.clamp(al, -1.0, 1.0)))
    elif op == Op.ATAN_LHS:
        lo, hi = tc.atan(al), tc.atan(ah)
    elif op == Op.EXP_LHS:
        lo, hi = torch.exp(al), torch.exp(ah)
    elif op == Op.ABS_LHS:
        neg = ah < 0.0
        pos = al >= 0.0
        lo = torch.where(pos, al, torch.where(neg, -ah, 0.0))
        hi = torch.where(pos, ah, torch.where(neg, -al,
                                              torch.maximum(-al, ah)))
    elif op == Op.LOG_LHS:
        # reference quirk (gpu_interval.hpp:382-391)
        lo = torch.where(al <= 0.0, 0.0, torch.log(torch.clamp_min(al, 1e-38)))
        hi = torch.where(ah <= 0.0, -float("inf"),
                         torch.log(torch.clamp_min(ah, 1e-38)))
        lo, hi = _nan_where(ah < 0.0, lo, hi)
    elif op == Op.ADD_LHS_IMM:
        lo, hi = al + imm, ah + imm
    elif op == Op.ADD_LHS_RHS:
        lo, hi = al + bl, ah + bh
    elif op == Op.MUL_LHS_IMM:
        lo, hi = (ah * imm, al * imm) if imm < 0.0 else (al * imm, ah * imm)
    elif op == Op.MUL_LHS_RHS:
        p1, p2, p3, p4 = al * bl, al * bh, ah * bl, ah * bh
        xn, xp = al < 0.0, ah > 0.0
        yn, yp = bl < 0.0, bh > 0.0
        x_m, x_n, x_p = xn & xp, xn & ~xp, ~xn & xp
        y_m, y_n, y_p = yn & yp, yn & ~yp, ~yn & yp
        cases = [x_m & y_m, x_m & y_n, x_m & y_p, x_n & y_m, x_n & y_n,
                 x_n & y_p, x_p & y_m, x_p & y_n, x_p & y_p]
        zero = al * 0.0
        lo = im.select(torch, cases, [torch.minimum(p2, p3), p3, p2, p2, p4,
                                      p2, p3, p3, p1], zero)
        hi = im.select(torch, cases, [torch.maximum(p1, p4), p1, p4, p1, p1,
                                      p3, p4, p2, p4], zero)
    elif op in (Op.MIN_LHS_IMM, Op.MAX_LHS_IMM):
        i = torch.full_like(al, imm)
        if op == Op.MIN_LHS_IMM:
            c1, c2, f = ah < i, i < al, torch.minimum
        else:
            c1, c2, f = al > i, i > ah, torch.maximum
        lo = torch.where(c1, al, torch.where(c2, i, f(al, i)))
        hi = torch.where(c1, ah, torch.where(c2, i, f(ah, i)))
        c = torch.where(c1, 1, torch.where(c2, 2, 0))
    elif op == Op.MIN_LHS_RHS:
        c1, c2 = ah < bl, bh < al
        lo = torch.where(c1, al, torch.where(c2, bl, torch.minimum(al, bl)))
        hi = torch.where(c1, ah, torch.where(c2, bh, torch.minimum(ah, bh)))
        c = torch.where(c1, 1, torch.where(c2, 2, 0))
    elif op == Op.MAX_LHS_RHS:
        c1, c2 = al > bh, bl > ah
        lo = torch.where(c1, al, torch.where(c2, bl, torch.maximum(al, bl)))
        hi = torch.where(c1, ah, torch.where(c2, bh, torch.maximum(ah, bh)))
        c = torch.where(c1, 1, torch.where(c2, 2, 0))
    elif op == Op.SUB_LHS_IMM:
        lo, hi = al - imm, ah - imm
    elif op == Op.SUB_IMM_RHS:
        i = torch.full_like(bl, imm)
        lo, hi = i - bh, i - bl
    elif op == Op.SUB_LHS_RHS:
        lo, hi = al - bh, ah - bl
    elif op == Op.DIV_LHS_IMM:
        i = torch.full_like(al, imm)
        lo, hi = _iv_div(al, ah, i, i)
    elif op == Op.DIV_IMM_RHS:
        i = torch.full_like(bl, imm)
        lo, hi = _iv_div(i, i, bl, bh)
    elif op == Op.DIV_LHS_RHS:
        lo, hi = _iv_div(al, ah, bl, bh)
    elif op == Op.COPY_IMM:
        lo = torch.full_like(al, imm)
        hi = lo
    elif op == Op.COPY_LHS:
        lo, hi = al, ah
    elif op == Op.COPY_RHS:
        lo, hi = bl, bh
    elif op == Op.HYPOT_LHS_RHS:
        sal, sah = _sq(al, ah)
        sbl, sbh = _sq(bl, bh)
        lo = tc.sqrt(torch.clamp_min(sal + sbl, 0.0))
        hi = tc.sqrt(sah + sbh)
    elif op == Op.ADDSQ_LHS_RHS:
        sal, sah = _sq(al, ah)
        lo, hi = sal + bl, sah + bh
    else:
        raise ValueError(f"no interval branch for op {op}")
    return lo, hi, c


# ---------------------------------------------------------------------------
# Kernel A: interval eval + tape shortening codes
# ---------------------------------------------------------------------------

def _decode(words: torch.Tensor):
    w = words.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return ((w & 0xFF).tolist(), ((w >> 8) & 0xFF).tolist(),
            ((w >> 16) & 0xFF).tolist(), ((w >> 24) & 0xFF).tolist())


def _pack_codes(nib, tcap: int):
    """(T, lanes) 4-bit codes -> (lanes, tcap // 8) int32, nibble t % 8 of
    word t // 8, zero past T."""
    T, la = nib.shape
    full = torch.zeros(tcap, la, dtype=torch.int32, device=nib.device)
    full[:T] = nib
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=nib.device)
    packed = (full.reshape(tcap // 8, 8, la) << shifts[None, :, None]).sum(
        dim=1, dtype=torch.int32)
    return packed.T


def _sweep_code(op, out, lhs, rhs, is_act, choice):
    """One clause of the backward sweep: (code, mark lhs, mark rhs) for all
    lanes, ``choice`` the clause's recorded choices (None for a clause
    that records none).  The lhs mark applies only where lhs != 0, which
    the caller checks."""
    if CHOICE_OP_LO <= op <= CHOICE_OP_HI:
        keep_both, ch_lhs, ch_rhs = choice == 0, choice == 1, choice == 2
        code = torch.where(keep_both, CODE_KEEP, torch.where(
            ch_lhs, CODE_COPY_LHS,
            CODE_COPY_RHS if rhs != 0 else CODE_COPY_IMM))
        elide = ch_lhs & (lhs == out) | ch_rhs & (rhs != 0 and rhs == out)
        code = torch.where(elide | ~is_act, CODE_DROP, code)
        return (code, is_act & (keep_both | ch_lhs),
                is_act & (keep_both | ch_rhs & (rhs != 0)))
    return torch.where(is_act, CODE_KEEP, CODE_DROP), is_act, is_act


def interval_shorten_plain(meta, words, imms, boxes, *, s_cap=SLOT_CAP,
                           widen=False, levels=None, launch=None):
    """Plain PyTorch kernel A: one clause at a time across all lanes.

    Same signature and outputs as :func:`interval_shorten` (``levels`` and
    ``launch`` are the kernel's and ignored here); lanes at or past
    ``meta[7]`` (when nonzero) do no work and come back zero."""
    lanes = boxes.shape[1]
    tcap = words.shape[0]
    dev = boxes.device
    T, _, res, sx, sy, sz, _, n_active = (int(v) for v in meta.tolist())
    la = lanes if n_active <= 0 else min(lanes, n_active)
    status = torch.zeros(lanes, dtype=torch.int32, device=dev)
    codes = torch.zeros(lanes, tcap // 8, dtype=torch.int32, device=dev)
    if la == 0:
        return status, codes
    ops, outs, lhss, rhss = _decode(words[:T])
    imm_f = imms[:T].cpu().numpy().tolist()
    b = boxes[:, :la]
    zero = torch.zeros(la, dtype=torch.float32, device=dev)
    regs = [(zero, zero)] * s_cap
    regs[sx] = (b[0], b[1])
    regs[sy] = (b[2], b[3])
    regs[sz] = (b[4], b[5])
    regs[0] = (zero, zero)

    choices = []
    for t in range(T):
        op = ops[t]
        if op <= Op.JUMP:
            continue
        al, ah = regs[lhss[t]]
        bl, bh = regs[rhss[t]]
        lo, hi, c = interval_clause(op, al, ah, bl, bh, imm_f[t])
        if widen:
            lo, hi = im.widen(torch, lo, hi)
        regs[outs[t]] = (lo, hi)
        if CHOICE_OP_LO <= op <= CHOICE_OP_HI:
            choices.append(c)

    rlo, rhi = regs[res]
    st = torch.where(rlo > 0.0, ST_EMPTY,
                     torch.where(rhi < 0.0, ST_FILLED, ST_AMBIG))
    status[:la] = st.to(torch.int32)

    # backward mark-and-sweep (non-ambiguous lanes emit all-DROP codes)
    false = torch.zeros(la, dtype=torch.bool, device=dev)
    act = [false] * s_cap
    act[res] = st == ST_AMBIG
    nib = torch.zeros(T, la, dtype=torch.int32, device=dev)
    ci = len(choices)
    for t in range(T - 1, -1, -1):
        op, out, lhs, rhs = ops[t], outs[t], lhss[t], rhss[t]
        choice = None
        if CHOICE_OP_LO <= op <= CHOICE_OP_HI:
            ci -= 1
            choice = choices[ci]
        nib[t], mark_lhs, mark_rhs = _sweep_code(op, out, lhs, rhs, act[out],
                                                 choice)
        act[out] = false
        if lhs != 0:
            act[lhs] = act[lhs] | mark_lhs
        act[rhs] = act[rhs] | mark_rhs
    codes[:la] = _pack_codes(nib, tcap)
    return status, codes


def _interval_shorten_levels(meta, words, imms, boxes, levels, *,
                             widen=False):
    """Kernel A's algorithm in plain PyTorch, for the tests: the clauses in
    the level order of ``levels`` (:func:`schedule.tape_levels`), one
    interval kept per clause, operands read from their producers'
    positions or the seeds, immediates from ``imms`` at each clause's tape
    index, choices kept per clause; backward in reverse level order, each
    active clause marking its producers' positions.
    Same outputs as :func:`interval_shorten_plain`; no render path calls
    it."""
    lanes = boxes.shape[1]
    tcap = words.shape[0]
    dev = boxes.device
    T, _, res, sx, sy, sz, _, n_active = (int(v) for v in meta.tolist())
    if levels.key != (T, res, sx, sy, sz):
        raise ValueError(f"schedule of {levels.key}, tape {T, res, sx, sy, sz}")
    la = lanes if n_active <= 0 else min(lanes, n_active)
    status = torch.zeros(lanes, dtype=torch.int32, device=dev)
    codes = torch.zeros(lanes, tcap // 8, dtype=torch.int32, device=dev)
    if la == 0:
        return status, codes
    h = levels.host
    planes = levels.planes.cpu().numpy()
    ops, outs, lhss, rhss = _decode(torch.from_numpy(planes[0, :T]))
    # each clause's immediate from the call's imms at its tape index (the
    # schedule may be older than the immediates)
    imm_f = imms[:T].cpu().numpy()[h["order"]].tolist()
    offs = levels.offsets.cpu().tolist()
    b = boxes[:, :la]
    zero = torch.zeros(la, dtype=torch.float32, device=dev)
    seeds = {sch.SEED_ZERO: (zero, zero), sch.SEED_X: (b[0], b[1]),
             sch.SEED_Y: (b[2], b[3]), sch.SEED_Z: (b[4], b[5])}
    iv, cho = [None] * T, [None] * T

    def operand(src):
        return iv[src] if src >= 0 else seeds[src]

    for lvl in range(levels.n_levels):
        for i in range(offs[lvl], offs[lvl + 1]):
            op = ops[i]
            if op <= Op.JUMP or op >= NUM_OPS:
                continue
            al, ah = operand(int(h["lhs_src"][i]))
            bl, bh = operand(int(h["rhs_src"][i]))
            lo, hi, cho[i] = interval_clause(op, al, ah, bl, bh, imm_f[i])
            iv[i] = im.widen(torch, lo, hi) if widen else (lo, hi)

    rlo, rhi = operand(levels.res_src)
    st = torch.where(rlo > 0.0, ST_EMPTY,
                     torch.where(rhi < 0.0, ST_FILLED, ST_AMBIG))
    status[:la] = st.to(torch.int32)

    false = torch.zeros(la, dtype=torch.bool, device=dev)
    act = [false] * T
    if levels.res_mark >= 0:
        act[levels.res_mark] = st == ST_AMBIG
    nib = torch.zeros(T, la, dtype=torch.int32, device=dev)
    for lvl in range(levels.n_levels - 1, -1, -1):
        for i in range(offs[lvl], offs[lvl + 1]):
            code, mark_lhs, mark_rhs = _sweep_code(
                ops[i], outs[i], lhss[i], rhss[i], act[i], cho[i])
            nib[int(h["order"][i])] = code
            for tgt, mark in ((int(h["mark_l"][i]), mark_lhs),
                              (int(h["mark_r"][i]), mark_rhs)):
                if tgt >= 0:
                    act[tgt] = act[tgt] | mark
    codes[:la] = _pack_codes(nib, tcap)
    return status, codes


def interval_shorten(meta, words, imms, boxes, *, s_cap=SLOT_CAP,
                     widen=False, levels=None, launch=None):
    """Kernel A over ``lanes`` tiles with one shared tape.

    Args:
      meta: (8,) int32 [T, S, result_slot, sx, sy, sz, n_runs, n_active]
        (n_active = 0: all lanes; else lanes >= n_active do no work and
        their outputs are garbage)
      words: (Tcap,) int32; imms: (Tcap,) f32 tape planes
      boxes: (6, lanes) f32 — xl xh yl yh zl zh per tile
      s_cap: slot bucket (> every slot number of the tape)
      widen: widen every interval result outward (config.widen_intervals)
      levels: the tape's dependency schedule (:func:`schedule.tape_levels`
        on the boxes' device), or a function that returns it (called only
        when the kernel runs: ``TapeData.levels``); without one the
        wrapper reads ``meta`` back and builds it from ``words``.  It holds
        no immediates: the kernel reads each clause's from ``imms``
      launch: a forced launch shape (one :func:`launch.interval_launch`
        can give; default: the one it picks for the schedule and lanes)

    Returns:
      status: (lanes,) int32; codes: (lanes, Tcap//8) int32, nibble t%8 of
      word t//8 the shorten code of clause t (zero past the tape)
    """
    if not _on_cuda(meta, words, imms, boxes):
        return interval_shorten_plain(meta, words, imms, boxes, s_cap=s_cap,
                                      widen=widen)
    tcap = words.shape[0]
    lanes = boxes.shape[1]
    _check(meta, "meta", torch.int32, (8,))
    _check(words, "words", torch.int32, (tcap,))
    _check(imms, "imms", torch.float32, (tcap,))
    _check(boxes, "boxes", torch.float32, (6, lanes))
    if tcap % 16 or not 8 <= s_cap <= REG_CAP:
        raise ValueError(f"bad tcap {tcap} or s_cap {s_cap}")
    dev = boxes.device
    if callable(levels):
        levels = levels()
    if levels is None:
        m = [int(v) for v in meta.tolist()]
        levels = sch.tape_levels(words, m[0], m[2], m[3:6], device=dev)
    if levels.planes.device != dev or levels.length > tcap:
        raise ValueError(f"schedule of {levels.length} clauses on "
                         f"{levels.planes.device} for a tape of capacity "
                         f"{tcap} on {dev}")
    if launch is None:
        launch = ln.interval_launch(levels.widths, lanes)
    else:
        ln.check_interval_launch(launch, levels.length)
    status = torch.empty(lanes, dtype=torch.int32, device=dev)
    codes = torch.empty(lanes, tcap // 8, dtype=torch.int32, device=dev)
    if lanes:
        with torch.cuda.device(dev):
            _launch(build.lib().mpr_interval_shorten, meta.data_ptr(),
                    levels.planes.data_ptr(), imms.data_ptr(),
                    levels.offsets.data_ptr(),
                    boxes.data_ptr(), status.data_ptr(), codes.data_ptr(),
                    lanes, tcap, levels.length, levels.padded,
                    levels.n_levels, levels.res_src, levels.res_mark,
                    *levels.key[1:], launch.threads, launch.tiles,
                    int(launch.stage), int(bool(widen)), launch.smem,
                    _stream())
        _interval_shorten.launches += 1
    return status, codes


interval_shorten.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_interval_shorten = interval_shorten


# ---------------------------------------------------------------------------
# The run-preserving rewrites of a shortened clause
# ---------------------------------------------------------------------------

_NEG_INF_BITS = int(np.float32(-np.inf).view(np.int32))
_POS_INF_BITS = int(np.float32(np.inf).view(np.int32))


def rewrite_clauses(nib, words, imms):
    """Apply shorten codes to clauses, keeping opcode runs whole.

    ``nib``: (L, T) int32 shorten codes; ``words`` (T,) int32 and ``imms``
    (T,) f32 the shared tape.  choice=LHS on a two-operand min/max
    duplicates the operand (min(a, a) == a), choice=LHS on
    MIN/MAX_LHS_IMM sets the imm to +inf/-inf, choice=RHS moves rhs to lhs,
    and COPY_IMM, the one run breaker, changes the opcode.

    Returns ``(new_op, body, imm_bits)``, each (L, T) int32: the opcode, the
    word without its opcode byte (``out << 8 | lhs << 16 | rhs << 24``) and
    the immediate's bits."""
    word = words[None, :]
    op = word & 0xFF
    lhs = (word >> 16) & 0xFF
    rhs = (word >> 24) & 0xFF
    is_min_imm = op == int(Op.MIN_LHS_IMM)
    is_max_imm = op == int(Op.MAX_LHS_IMM)
    imm_form = is_min_imm | is_max_imm
    dup_rhs = (nib == CODE_COPY_LHS) & ~imm_form
    take_rhs = nib == CODE_COPY_RHS
    inf_imm = (nib == CODE_COPY_LHS) & imm_form
    new_lhs = torch.where(take_rhs, rhs, lhs)
    new_rhs = torch.where(dup_rhs, lhs, rhs)
    new_op = torch.where(nib == CODE_COPY_IMM, int(Op.COPY_IMM), op)
    body = (word & 0xFF00) | (new_lhs << 16) | (new_rhs << 24)
    imm_bits = torch.where(
        inf_imm, torch.where(is_min_imm, _POS_INF_BITS, _NEG_INF_BITS),
        imms.view(torch.int32)[None, :])
    return new_op, body.to(torch.int32), imm_bits.to(torch.int32)


def unpack_codes(codes, n_clauses: int):
    """(L, TW) packed code words -> (L, n_clauses) int32 nibbles."""
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=codes.device)
    nib = (codes[:, :, None] >> shifts) & 15
    return nib.reshape(codes.shape[0], -1)[:, :n_clauses]


def _run_headers(cb, n, rcap: int):
    """Opcode-run headers of compacted branch ids.

    ``cb``: (G, T) int64 branch ids, meaningful over ``[0, n[g])``; a run
    starts where the id differs from the one before.  Returns ``(runs (G,
    rcap) int32 headers bid | count << 8, zero past the last run; n_runs
    (G,) int64)``."""
    G, T = cb.shape
    dev = cb.device
    k = torch.arange(T, device=dev)
    valid = k[None, :] < n[:, None]
    prev = torch.roll(cb, 1, dims=1)
    head = valid & ((k[None, :] == 0) | (cb != prev))
    n_runs = head.sum(dim=1)
    ridx = torch.where(head, head.long().cumsum(dim=1) - 1, T)
    width = max(T, rcap) + 1
    starts = torch.zeros(G, width, dtype=torch.long, device=dev)
    starts.scatter_(1, ridx.clamp(max=width - 1),
                    k[None, :].expand(G, T).contiguous())
    q = torch.arange(rcap, device=dev)
    s = starts[:, :rcap]
    nxt = torch.where(q[None, :] + 1 < n_runs[:, None],
                      starts[:, 1:rcap + 1], n[:, None])
    hbid = torch.gather(cb, 1, s.clamp(max=T - 1))
    runs = torch.where(q[None, :] < n_runs[:, None],
                       hbid | ((nxt - s) << 8), 0).to(torch.int32)
    return runs, n_runs


# ---------------------------------------------------------------------------
# Kernel C: tape compaction + run extraction
# ---------------------------------------------------------------------------

def compact_bitshift_batched_plain(cmeta, lens, wrw, irw, rem, cap: int,
                                   launch=None):
    """Plain PyTorch kernel C, vectorized over tile rows.  Same signature
    and outputs as :func:`compact_bitshift_batched` (``launch`` is the
    kernel's and ignored here; rows at or past ``cmeta[0]`` are computed
    too)."""
    G, R, W = wrw.shape
    tcap = R * W
    dev = wrw.device
    w = wrw.reshape(G, tcap)
    bid = w & 0xFF
    keep = bid != 0
    t = torch.arange(tcap, device=dev)
    # kept clause t lands on t - rem[t]; dropped ones on a spill column
    dest = torch.where(keep, t - rem.reshape(G, tcap).long(), tcap)
    n = lens.long()
    k = torch.arange(tcap, device=dev)
    valid = k[None, :] < n[:, None]

    def scatter(src):
        out = torch.zeros(G, tcap + 1, dtype=src.dtype, device=dev)
        out.scatter_(1, dest, src)
        return torch.where(valid, out[:, :tcap], 0)

    cw, ci, cb = scatter(w), scatter(irw.reshape(G, tcap)), scatter(bid)
    runs, n_runs = _run_headers(cb.long(), n, cap)
    gmeta = torch.zeros(G, 8, dtype=torch.int32, device=dev)
    gmeta[:, 0] = lens
    gmeta[:, 1] = n_runs.to(torch.int32)
    gmeta[:, 2] = (n > cap).to(torch.int32)
    return (cw[:, :cap].contiguous(), ci[:, :cap].contiguous(), runs, gmeta)


def _check_planes(wrw, irw, rem, cap: int):
    """The prepass planes of kernels C and C2: int32, contiguous, 16-byte
    aligned (the kernels read the words 16 bytes at a time), a plane of at
    most 16384 clauses in whole warps, and 1 <= cap <= the plane."""
    n, R, W = wrw.shape
    tcap = R * W
    for name, p in (("wrw", wrw), ("irw", irw), ("rem", rem)):
        _check(p, name, torch.int32, (n, R, W))
        if p.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    if not 1 <= cap <= tcap or tcap > 16384 or tcap % 32:
        raise ValueError(f"bad cap {cap} for a {tcap}-clause plane")
    return tcap


def compact_bitshift_batched(cmeta, lens, wrw, irw, rem, cap: int,
                             launch=None):
    """Kernel C over pre-ordered tile rows.

    cmeta: (8,) int32, cmeta[0] = rows to compact (the ambiguous count);
    lens: (G,) int32 kept clauses per row; wrw/irw/rem: (G, R, W) int32
    planes from the prepass (pipeline2d._shorten_prepass): rewritten words
    with the branch id in the op byte (0 for a dropped clause), imm bits,
    and each kept clause's leftward move.  ``cap`` (<= R*W) is the
    per-tile capacity.  ``launch``: a forced launch shape (one
    :func:`launch.compact_launch` can give; default: the one it picks).

    Returns (tw (G, cap) i32, ti_bits (G, cap) i32, runs (G, cap) i32
    headers bid | count<<8, gmeta (G, 8) i32 [len, n_runs, len > cap, 0..]);
    rows >= cmeta[0] are garbage, tw/ti/runs are zero past len/n_runs.
    """
    if not _on_cuda(cmeta, lens, wrw, irw, rem):
        return compact_bitshift_batched_plain(cmeta, lens, wrw, irw, rem, cap)
    G = wrw.shape[0]
    _check(cmeta, "cmeta", torch.int32, (8,))
    _check(lens, "lens", torch.int32, (G,))
    tcap = _check_planes(wrw, irw, rem, cap)
    if launch is None:
        launch = ln.compact_launch(tcap, cap, G)
    else:
        ln.check_compact_launch(launch, tcap, cap)
    dev = wrw.device
    tw = torch.empty(G, cap, dtype=torch.int32, device=dev)
    ti = torch.empty(G, cap, dtype=torch.int32, device=dev)
    runs = torch.empty(G, cap, dtype=torch.int32, device=dev)
    gmeta = torch.empty(G, 8, dtype=torch.int32, device=dev)
    if G:
        with torch.cuda.device(dev):
            _launch(build.lib().mpr_compact, cmeta.data_ptr(), lens.data_ptr(),
                    wrw.data_ptr(), irw.data_ptr(), rem.data_ptr(),
                    tw.data_ptr(), ti.data_ptr(), runs.data_ptr(),
                    gmeta.data_ptr(), G, tcap, cap, launch.threads,
                    launch.group, launch.smem, _stream())
        _compact_bitshift_batched.launches += 1
    return tw, ti, runs, gmeta


compact_bitshift_batched.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_compact_bitshift_batched = compact_bitshift_batched


# ---------------------------------------------------------------------------
# Kernel B: per-pixel evaluation with the shortened tapes
# ---------------------------------------------------------------------------

def float_clause(op: int, a, b, imm):
    """Float eval of one clause (kernels.py:575-609 of the JAX package);
    ``imm`` broadcasts against ``a``/``b``."""
    if op == Op.SQUARE_LHS:
        return a * a
    if op == Op.SQRT_LHS:
        return tc.sqrt(a)
    if op == Op.NEG_LHS:
        return -a
    if op == Op.SIN_LHS:
        return torch.sin(a)
    if op == Op.COS_LHS:
        return torch.cos(a)
    if op == Op.ASIN_LHS:
        return tc.asin_analytic(a)
    if op == Op.ACOS_LHS:
        return tc.acos_analytic(a)
    if op == Op.ATAN_LHS:
        return tc.atan_analytic(a)
    if op == Op.EXP_LHS:
        return torch.exp(a)
    if op == Op.ABS_LHS:
        return tc.abs(a)
    if op == Op.LOG_LHS:
        return torch.log(a)
    if op == Op.ADD_LHS_IMM:
        return a + imm
    if op == Op.ADD_LHS_RHS:
        return a + b
    if op == Op.MUL_LHS_IMM:
        return a * imm
    if op == Op.MUL_LHS_RHS:
        return a * b
    if op == Op.MIN_LHS_IMM:
        return tc.minimum(a, imm.expand_as(a))
    if op == Op.MIN_LHS_RHS:
        return tc.minimum(a, b)
    if op == Op.MAX_LHS_IMM:
        return tc.maximum(a, imm.expand_as(a))
    if op == Op.MAX_LHS_RHS:
        return tc.maximum(a, b)
    if op == Op.SUB_LHS_IMM:
        return a - imm
    if op == Op.SUB_IMM_RHS:
        return imm - b
    if op == Op.SUB_LHS_RHS:
        return a - b
    if op == Op.DIV_LHS_IMM:
        return a / imm
    if op == Op.DIV_IMM_RHS:
        return imm / b
    if op == Op.DIV_LHS_RHS:
        return a / b
    if op == Op.COPY_IMM:
        return imm.expand_as(a).clone()
    if op == Op.COPY_LHS:
        return a
    if op == Op.COPY_RHS:
        return b
    if op == Op.HYPOT_LHS_RHS:
        return tc.sqrt(a * a + b * b)
    if op == Op.ADDSQ_LHS_RHS:
        return a * a + b
    raise ValueError(f"no float branch for op {op}")


def _tile_programs(sel, nmeta, words, imms, runs_full, table, tw, ti, runs,
                   gmeta):
    """Per-tile clause lists (host numpy) for the ambiguous rows ``sel``:
    each row's shortened tape expanded through its run headers, or the
    full tape when the row overflowed."""
    nm = nmeta.tolist()
    ow, oi, orun = (words.cpu().numpy(), imms.cpu().numpy(),
                    runs_full.cpu().numpy())
    sel_t = torch.as_tensor(sel, device=tw.device)
    tw_h, ti_h = tw[sel_t].cpu().numpy(), ti[sel_t].cpu().numpy()
    runs_h, gm_h = runs[sel_t].cpu().numpy(), gmeta[sel_t].cpu().numpy()
    progs = []
    for i in range(len(sel)):
        if gm_h[i, 2]:
            hdr, w, imm = orun[:nm[6]], ow, oi
        else:
            hdr, w, imm = runs_h[i, :gm_h[i, 1]], tw_h[i], ti_h[i]
        cnt = (hdr >> 8).astype(np.int64)
        ops = np.repeat(table[hdr & 0xFF], cnt)
        n = int(cnt.sum())
        progs.append((ops, w[:n].astype(np.int64) & 0xFFFFFFFF, imm[:n]))
    return progs


def _run_programs(progs, regs, clause, min_op=int(Op.JUMP)):
    """Interpret one clause list per row, in place: clause ``t`` of every
    row steps together, operands gathered by each row's own slot numbers.

    ``progs``: per-row ``(ops, words, imms)`` from :func:`_tile_programs`;
    ``regs``: (rows, s_cap, ...) register file; ``clause(op, a, b, imm)``
    evaluates one opcode on operands shaped ``regs[:, 0]``, with ``imm``
    shaped (rows, 1, ...).  Clauses with an opcode at or under ``min_op``
    do nothing (-1: every clause of a row runs)."""
    ga = len(progs)
    dev = regs.device
    lmax = max(p[0].shape[0] for p in progs)
    if lmax == 0:
        return
    op_m = np.full((ga, lmax), -1, np.int64)
    w_m = np.zeros((ga, lmax), np.int64)
    i_m = np.zeros((ga, lmax), np.float32)
    for r, (ops, w, imm) in enumerate(progs):
        op_m[r, :ops.shape[0]] = ops
        w_m[r, :ops.shape[0]] = w
        i_m[r, :ops.shape[0]] = imm
    out_m = torch.as_tensor((w_m >> 8) & 0xFF, device=dev)
    lhs_m = torch.as_tensor((w_m >> 16) & 0xFF, device=dev)
    rhs_m = torch.as_tensor((w_m >> 24) & 0xFF, device=dev)
    imm_m = torch.as_tensor(i_m, device=dev)
    per_row = (ga,) + (1,) * (regs.dim() - 2)
    rows = torch.arange(ga, device=dev)
    for t in range(lmax):
        ops_t = op_m[:, t]
        live = ops_t > min_op
        if not live.any():
            continue
        a = regs[rows, lhs_m[:, t]]
        b = regs[rows, rhs_m[:, t]]
        imm = imm_m[:, t].reshape(per_row)
        r = None
        for op in np.unique(ops_t[live]):
            v = clause(int(op), a, b, imm)
            if r is None:
                r = v
            else:
                m = torch.as_tensor(ops_t == op, device=dev)
                r = torch.where(m.reshape(per_row), v, r)
        if live.all():
            regs[rows, out_m[:, t]] = r
        else:
            li = torch.as_tensor(np.flatnonzero(live), device=dev)
            regs[li, out_m[li, t]] = r[li]


def pixel_eval_runs_plain(nmeta, order, status, words, imms, runs_full,
                          branch_ops, tw, ti, runs, gmeta, coords, s_cap,
                          launch=None):
    """Plain PyTorch kernel B: clause ``t`` of every ambiguous tile steps
    together, operands gathered by each tile's own slot numbers.  Same
    signature and outputs as :func:`pixel_eval_runs` (``launch`` is the
    kernel's and ignored here)."""
    n_tiles, _, P = coords.shape
    dev = coords.device
    nm = [int(v) for v in nmeta.tolist()]
    n_amb, res, sx, sy, sz = nm[0], nm[2], nm[3], nm[4], nm[5]
    order_h = order.cpu().numpy().astype(np.int64)
    st_h = status.cpu().numpy()[order_h]
    g = np.arange(order_h.shape[0])
    amb = (g < n_amb) & (st_h == ST_AMBIG)
    fill = torch.empty(n_tiles, P, dtype=torch.int32, device=dev)
    dec = torch.as_tensor(order_h[~amb], device=dev)
    fill[dec] = torch.as_tensor((st_h[~amb] == ST_FILLED).astype(np.int32),
                                device=dev)[:, None].expand(-1, P)
    sel = np.flatnonzero(amb)
    if sel.size == 0:
        return fill
    progs = _tile_programs(sel, nmeta, words, imms, runs_full,
                           bid_table(branch_ops), tw, ti, runs, gmeta)
    tiles = torch.as_tensor(order_h[sel], device=dev)
    c = coords[tiles]
    regs = torch.zeros(len(progs), s_cap, P, dtype=torch.float32, device=dev)
    regs[:, sx] = c[:, 0]
    regs[:, sy] = c[:, 1]
    regs[:, sz] = c[:, 2]
    regs[:, 0] = 0.0
    _run_programs(progs, regs, float_clause)
    fill[tiles] = (regs[:, res] < 0.0).to(torch.int32)
    return fill


def pixel_eval_runs(nmeta, order, status, words, imms, runs_full,
                    branch_ops, tw, ti, runs, gmeta, coords, s_cap: int,
                    launch: ln.Launch = None):
    """Kernel B.

    nmeta: (8,) int32 [n_amb, S, res, sx, sy, sz, n_runs_full, 0]
    order: (gcap,) int32 tile per row (ambiguous tiles first);
    status: (n_tiles,) int32 interval-stage statuses, TILE order;
    words/imms/runs_full: the full tape, runs' op byte a branch id;
    branch_ops: tuple of opcodes, branch id i+1 -> branch_ops[i]
    (build_remap); tw/ti/runs/gmeta: kernel C outputs, ROW order;
    coords: (n_tiles, 3, P) f32 pixel x/y/z, TILE order; s_cap: the slot
    bucket, the register file's size (a tape with more slots traps);
    launch: a forced launch shape (one :func:`launch.pixel_launch` can
    give; default: the one it picks for ``gcap`` rows).

    Returns fill: (n_tiles, P) int32 0/1 in TILE order — ambiguous tiles
    carry per-pixel signs, the others their interval decision.
    """
    if not _on_cuda(nmeta, order, status, words, imms, runs_full, tw, ti,
                    runs, gmeta, coords):
        return pixel_eval_runs_plain(nmeta, order, status, words, imms,
                                     runs_full, branch_ops, tw, ti, runs,
                                     gmeta, coords, s_cap)
    n_tiles, _, P = coords.shape
    gcap = order.shape[0]
    tcap = words.shape[0]
    cap = tw.shape[1]
    _check(nmeta, "nmeta", torch.int32, (8,))
    _check(order, "order", torch.int32, (gcap,))
    _check(status, "status", torch.int32, (n_tiles,))
    _check(words, "words", torch.int32, (tcap,))
    _check(imms, "imms", torch.float32, (tcap,))
    _check(runs_full, "runs_full", torch.int32, (tcap,))
    _check(tw, "tw", torch.int32, (tw.shape[0], cap))
    _check(ti, "ti", torch.float32, (tw.shape[0], cap))
    _check(runs, "runs", torch.int32, (tw.shape[0], cap))
    _check(gmeta, "gmeta", torch.int32, (tw.shape[0], 8))
    _check(coords, "coords", torch.float32, (n_tiles, 3, P))
    if tw.shape[0] < gcap or gcap > n_tiles or cap > 16384 or P != 4096:
        raise ValueError(f"bad shapes: {tw.shape[0]} tape rows, {gcap} "
                         f"order rows, {n_tiles} tiles, cap {cap}, {P} "
                         "pixels a tile")
    if not s_cap <= REG_CAP or len(branch_ops) > 255:
        raise ValueError(f"s_cap {s_cap} or {len(branch_ops)} branches "
                         "out of range")
    if launch is None:
        launch = ln.pixel_launch(s_cap, cap, gcap, tcap)
    else:
        ln.check_pixel_launch(launch, s_cap, cap, tcap)
    dev = coords.device
    table = _bid_table_on(branch_ops, dev)
    fill = torch.empty(n_tiles, P, dtype=torch.int32, device=dev)
    if gcap:
        fn = build.lib(ln.library("pixel_eval_runs", launch)).mpr_pixel_eval
        with torch.cuda.device(dev):
            _launch(fn, nmeta.data_ptr(), order.data_ptr(),
                    status.data_ptr(), words.data_ptr(), imms.data_ptr(),
                    runs_full.data_ptr(), table.data_ptr(), tw.data_ptr(),
                    ti.data_ptr(), runs.data_ptr(), gmeta.data_ptr(),
                    coords.data_ptr(), fill.data_ptr(), gcap, cap, s_cap,
                    tcap, launch.bucket, launch.threads, launch.k,
                    launch.blocks_per_row, int(launch.stage_full),
                    launch.smem, _stream())
        _pixel_eval_runs.launches += 1
    return fill


pixel_eval_runs.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_pixel_eval_runs = pixel_eval_runs


# ---------------------------------------------------------------------------
# Kernel B1: per-pixel values, one dispatch per clause
# ---------------------------------------------------------------------------

def _float_clause_all(op: int, a, b, imm):
    """:func:`float_clause` over the full branch list of kernel B1: the
    opcodes INVALID and JUMP give ``a * 0`` and an opcode past the list
    runs the last branch (a switch index clamps)."""
    if op <= Op.JUMP:
        return a * 0.0
    return float_clause(min(op, NUM_OPS - 1), a, b, imm)


def pixel_eval_plain(nmeta, order, lens, tape_words, tape_imms, coords,
                     s_cap=SLOT_CAP):
    """Plain PyTorch kernel B1: clause ``t`` of every group steps together.
    Same signature and outputs as :func:`pixel_eval`; rows at or past
    ``nmeta[0]`` come back zero."""
    n_tiles, cap = tape_words.shape
    gcap = order.shape[0]
    P = coords.shape[2]
    dev = coords.device
    nm = [int(v) for v in nmeta.tolist()]
    n_groups, res, sx, sy, sz = min(nm[0], gcap), nm[2], nm[3], nm[4], nm[5]
    vals = torch.zeros(gcap, P, dtype=torch.float32, device=dev)
    if n_groups <= 0:
        return vals
    tiles = order[:n_groups].long()
    n_h = lens[tiles].clamp(0, cap).cpu().numpy()
    w_h = tape_words[tiles].cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    i_h = tape_imms[tiles].cpu().numpy()
    progs = [(w_h[r, :n] & 0xFF, w_h[r, :n], i_h[r, :n])
             for r, n in enumerate(n_h)]
    c = coords[tiles]
    regs = torch.zeros(n_groups, s_cap, P, dtype=torch.float32, device=dev)
    regs[:, sx] = c[:, 0]
    regs[:, sy] = c[:, 1]
    regs[:, sz] = c[:, 2]
    regs[:, 0] = 0.0
    _run_programs(progs, regs, _float_clause_all, min_op=-1)
    vals[:n_groups] = regs[:, res]
    return vals


def pixel_eval(nmeta, order, lens, tape_words, tape_imms, coords,
               s_cap: int = SLOT_CAP, launch=None):
    """Kernel B1: evaluate each group's pixels with its tile's own tape.

    Args:
      nmeta: (8,) int32 [n_groups, S, result_slot, sx, sy, sz, 0, 0]
      order: (gcap,) int32 tile index of each group
      lens: (n_tiles,) int32 tape length per TILE
      tape_words: (n_tiles, cap) int32, the opcode in the low byte;
      tape_imms: (n_tiles, cap) f32 (kernel C1's outputs when gcap ==
      n_tiles and order is the identity, else rows gathered by the caller)
      coords: (n_tiles, 3, P) f32 pixel x/y/z per tile, any P >= 1
      s_cap: the register file's slots (the tape's slot count at most)
      launch: a forced launch shape (:func:`launch.pixel_v1_launch`;
        default: the one it picks); ignored on the CPU

    Returns vals: (gcap, P) f32 pixel values of tile ``order[g]`` in row
    ``g``; rows ``g >= n_groups`` are unspecified.
    """
    if not _on_cuda(nmeta, order, lens, tape_words, tape_imms, coords):
        return pixel_eval_plain(nmeta, order, lens, tape_words, tape_imms,
                                coords, s_cap)
    n_tiles, cap = tape_words.shape
    gcap = order.shape[0]
    P = coords.shape[2]
    _check(nmeta, "nmeta", torch.int32, (8,))
    _check(order, "order", torch.int32, (gcap,))
    _check(lens, "lens", torch.int32, (n_tiles,))
    _check(tape_words, "tape_words", torch.int32, (n_tiles, cap))
    _check(tape_imms, "tape_imms", torch.float32, (n_tiles, cap))
    _check(coords, "coords", torch.float32, (n_tiles, 3, P))
    if not 8 <= s_cap <= REG_CAP or cap < 1 or P < 1:
        raise ValueError(f"bad s_cap {s_cap}, cap {cap} or {P} pixels")
    if launch is None:
        launch = ln.pixel_v1_launch(s_cap, cap, gcap, P)
    else:
        ln.check_pixel_v1_launch(launch, s_cap, cap)
    vals = torch.empty(gcap, P, dtype=torch.float32, device=coords.device)
    if gcap:
        fn = build.lib(ln.library("pixel_eval", launch)).mpr_pixel_eval_v1
        with torch.cuda.device(coords.device):
            _launch(fn, nmeta.data_ptr(), order.data_ptr(), lens.data_ptr(),
                    tape_words.data_ptr(), tape_imms.data_ptr(),
                    coords.data_ptr(), vals.data_ptr(), gcap, n_tiles, cap,
                    P, s_cap, launch.bucket, launch.threads, launch.k,
                    launch.blocks_per_row, launch.staged, launch.smem,
                    _stream())
        _pixel_eval.launches += 1
    return vals


pixel_eval.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_pixel_eval = pixel_eval


# ---------------------------------------------------------------------------
# Kernel C1: compaction straight from the shorten codes
# ---------------------------------------------------------------------------

def compact_runs_plain(cmeta, words, imms, order, remap, codes, gcap: int,
                       cap: int, rcap: int, launch=None):
    """Plain PyTorch kernel C1, vectorized over groups.  Same signature and
    outputs as :func:`compact_runs` (``launch`` is the kernel's and ignored
    here); rows at or past ``cmeta[0]``, tape slots past ``len`` and
    headers past ``n_runs`` come back zero."""
    n_tiles, tw_words = codes.shape
    tcap = words.shape[0]
    dev = codes.device
    cm = [int(v) for v in cmeta.tolist()]
    n_groups = min(cm[0], gcap)
    n_words = max(0, min(cm[1], tw_words, tcap // 8))
    capm = max(0, min(cm[2], cap))
    tw = torch.zeros(gcap, cap, dtype=torch.int32, device=dev)
    ti = torch.zeros(gcap, cap, dtype=torch.float32, device=dev)
    runs = torch.zeros(gcap, rcap, dtype=torch.int32, device=dev)
    gmeta = torch.zeros(gcap, 8, dtype=torch.int32, device=dev)
    T = n_words * 8
    if n_groups <= 0 or T == 0:
        gmeta[:max(n_groups, 0), 2] = int(capm <= 0)
        return tw, ti, runs, gmeta
    G = n_groups
    nib = unpack_codes(codes[order[:G].long(), :n_words], T)
    nz = nib != 0
    # a clause's place: the non-zero nibbles before it; kept while < cap
    place = torch.cumsum(nz.long(), dim=1) - nz.long()
    keep = nz & (place < capm)
    n = keep.sum(dim=1)
    new_op, body, imm_bits = rewrite_clauses(nib, words[:T], imms[:T])
    bid = remap[new_op.long().clamp(max=remap.shape[0] - 1)].long()
    width = max(T, cap)
    dest = torch.where(keep, place, width)    # dropped: a spill column

    def scatter(src):
        out = torch.zeros(G, width + 1, dtype=src.dtype, device=dev)
        out.scatter_(1, dest, src)
        return out[:, :width]

    tw[:G] = scatter(new_op | body)[:, :cap]
    ti[:G] = scatter(imm_bits)[:, :cap].contiguous().view(torch.float32)
    runs[:G], n_runs = _run_headers(scatter(bid), n, rcap)
    gmeta[:G, 0] = n.to(torch.int32)
    gmeta[:G, 1] = n_runs.to(torch.int32)
    gmeta[:G, 2] = (n >= capm).to(torch.int32)
    return tw, ti, runs, gmeta


def compact_runs(cmeta, words, imms, order, remap, codes, gcap: int,
                 cap: int, rcap: int, launch=None):
    """Kernel C1: compact each group's tape from kernel A's codes.

    Args:
      cmeta: (8,) int32 [n_groups, n_words, cap, ..]: groups to compact,
        code words to walk per tile (8 clauses each; the codes are not
        masked by the tape's length), and the capacity (<= ``cap``)
      words: (Tcap,) int32; imms: (Tcap,) f32, the shared tape (Tcap <=
        65536: the kernel keeps a clause's index in 16 bits)
      order: (Gcap >= gcap,) int32 tile index of each group
      remap: (32,) int32 opcode -> branch id (build_remap)
      codes: (n_tiles, Tcap/8) int32 from kernel A
      gcap, cap, rcap: rows, tape slots and run-header slots of the outputs
      launch: a forced launch shape (:func:`launch.compact_runs_launch`;
        default: the one it picks); ignored on the CPU

    Returns (tw (gcap, cap) i32 with the OPCODE in the low byte, ti (gcap,
    cap) f32, runs (gcap, rcap) i32 headers ``branch id | count << 8``,
    gmeta (gcap, 8) i32 [len, n_runs, len >= cap, ..]).  Only ``[0, len)``
    of a tape, ``[0, n_runs)`` of the headers and rows ``g < n_groups`` are
    specified.  A tape of exactly ``cap`` clauses is flagged as overflowed.
    """
    if not _on_cuda(cmeta, words, imms, order, remap, codes):
        return compact_runs_plain(cmeta, words, imms, order, remap, codes,
                                  gcap, cap, rcap)
    n_tiles, tw_words = codes.shape
    tcap = words.shape[0]
    _check(cmeta, "cmeta", torch.int32, (8,))
    _check(words, "words", torch.int32, (tcap,))
    _check(imms, "imms", torch.float32, (tcap,))
    _check(order, "order", torch.int32, (order.shape[0],))
    _check(remap, "remap", torch.int32, (NUM_OPS,))
    _check(codes, "codes", torch.int32, (n_tiles, tw_words))
    if (order.shape[0] < gcap or not 1 <= tcap <= 65536
            or not 1 <= cap <= 16384 or not 1 <= rcap <= 16384):
        raise ValueError(f"bad shapes: {order.shape[0]} order rows for gcap "
                         f"{gcap}, a {tcap}-clause tape, cap {cap}, rcap "
                         f"{rcap}")
    if launch is None:
        launch = ln.compact_runs_launch(tcap, cap, gcap)
    else:
        ln.check_compact_runs_launch(launch, tcap, cap)
    dev = codes.device
    tw = torch.empty(gcap, cap, dtype=torch.int32, device=dev)
    ti = torch.empty(gcap, cap, dtype=torch.int32, device=dev)
    runs = torch.empty(gcap, rcap, dtype=torch.int32, device=dev)
    gmeta = torch.empty(gcap, 8, dtype=torch.int32, device=dev)
    if gcap:
        with torch.cuda.device(dev):
            _launch(build.lib().mpr_compact_runs, cmeta.data_ptr(),
                    words.data_ptr(), imms.data_ptr(), order.data_ptr(),
                    remap.data_ptr(), codes.data_ptr(), tw.data_ptr(),
                    ti.data_ptr(), runs.data_ptr(), gmeta.data_ptr(), gcap,
                    n_tiles, tw_words, tcap, cap, rcap, launch.threads,
                    launch.group, launch.smem, _stream())
        _compact_runs.launches += 1
    return tw, ti.view(torch.float32), runs, gmeta


compact_runs.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_compact_runs = compact_runs


# ---------------------------------------------------------------------------
# Kernel C2: kernel C with order indirection
# ---------------------------------------------------------------------------

def compact_bitshift_plain(cmeta, order, lens, wrw, irw, rem, gcap: int,
                           cap: int, rcap: int, launch=None):
    """Plain PyTorch kernel C2: gathers the planes of tiles ``order[:gcap]``
    into row order and runs the plain kernel C on them.  Same signature and
    outputs as :func:`compact_bitshift` (``launch`` ignored)."""
    sel = order[:gcap].long().clamp(0, wrw.shape[0] - 1)
    return compact_bitshift_batched_plain(cmeta, lens[sel], wrw[sel],
                                          irw[sel], rem[sel], cap)


def compact_bitshift(cmeta, order, lens, wrw, irw, rem, gcap: int, cap: int,
                     rcap: int, launch=None):
    """Kernel C2: kernel C over planes in TILE order.

    cmeta: (8,) int32, cmeta[0] = groups to compact; order: (Gcap >= gcap,)
    int32 tile index of each group; lens: (n_tiles,) int32 kept clauses per
    TILE; wrw/irw/rem: (n_tiles, R, W) int32 planes from the prepass
    (pipeline2d._shorten_prepass).  ``cap`` (<= R*W) is the per-tile
    capacity; ``rcap`` is accepted for the JAX signature's sake (the
    headers have ``cap`` slots).  ``launch``: a forced launch shape, as for
    :func:`compact_bitshift_batched` (default: the one
    :func:`launch.compact_launch` picks for ``gcap`` rows).

    Returns (tw, ti_bits, runs (gcap, cap) i32, gmeta (gcap, 8) i32 [len,
    n_runs, len > cap, 0..]) with group ``g`` = tile ``order[g]`` in row
    ``g``; rows ``g >= cmeta[0]`` are unspecified.
    """
    if not _on_cuda(cmeta, order, lens, wrw, irw, rem):
        return compact_bitshift_plain(cmeta, order, lens, wrw, irw, rem,
                                      gcap, cap, rcap)
    n_tiles = wrw.shape[0]
    _check(cmeta, "cmeta", torch.int32, (8,))
    _check(order, "order", torch.int32, (order.shape[0],))
    _check(lens, "lens", torch.int32, (n_tiles,))
    tcap = _check_planes(wrw, irw, rem, cap)
    if order.shape[0] < gcap:
        raise ValueError(f"{order.shape[0]} order rows for gcap {gcap}")
    if launch is None:
        launch = ln.compact_launch(tcap, cap, gcap)
    else:
        ln.check_compact_launch(launch, tcap, cap)
    dev = wrw.device
    tw = torch.empty(gcap, cap, dtype=torch.int32, device=dev)
    ti = torch.empty(gcap, cap, dtype=torch.int32, device=dev)
    runs = torch.empty(gcap, cap, dtype=torch.int32, device=dev)
    gmeta = torch.empty(gcap, 8, dtype=torch.int32, device=dev)
    if gcap:
        with torch.cuda.device(dev):
            _launch(build.lib().mpr_compact_order, cmeta.data_ptr(),
                    order.data_ptr(), lens.data_ptr(), wrw.data_ptr(),
                    irw.data_ptr(), rem.data_ptr(), tw.data_ptr(),
                    ti.data_ptr(), runs.data_ptr(), gmeta.data_ptr(), gcap,
                    n_tiles, tcap, cap, launch.threads, launch.group,
                    launch.smem, _stream())
        _compact_bitshift.launches += 1
    return tw, ti, runs, gmeta


compact_bitshift.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_compact_bitshift = compact_bitshift
