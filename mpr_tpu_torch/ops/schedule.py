"""The dependency schedule of a tape, which kernel A walks level by level.

Kernel A (``csrc/interval_shorten.cu``) evaluates a tape's intervals for
one tile and then sweeps it backward to mark the clauses the tile needs.
The tape is a program over a few hundred reused register slots, but its
clauses form a shallow DAG: ``stress_2d(600)``'s 5,373 clauses sit on 17
dependency levels.  :func:`tape_levels` computes, once per tape on the
host, each clause's level and the clauses in level order, and rewrites
every slot operand as the position (in that order) of the clause that
produced it.  The kernel then keeps one interval per clause (SSA style)
and runs a level's clauses side by side, forward in level order and
backward in reverse, with no hazard from slot reuse.

The schedule reproduces the slot walk of
``kernels.interval_shorten_plain`` exactly:

  * forward, an operand is the interval of the last clause before it that
    wrote the slot and runs forward (opcode above JUMP and below
    NUM_OPS), else the slot's seed: the tile box's x, y or z interval for
    an axis slot (z over y over x where they share one), ``[0, 0]`` for
    slot 0 and for a slot never written;
  * backward, a clause that is active marks its operands: the mark goes to
    the last clause before it that wrote the slot, whatever its opcode (a
    clause with an opcode at or under JUMP runs no forward step but still
    kills and marks backward), and none goes to a seed; the lhs operand is
    not marked when it is slot 0, the rhs operand is (the slot walk's
    ``act[rhs]`` under KEEP);
  * the result is the forward value of the result slot after the tape, and
    the tile's mark of it goes to the slot's last writer.

A clause's level is one more than the largest level among its forward
producers and its mark targets (0 with none), so both passes find every
operand and every mark at a lower level.  Within a level the clauses go by
opcode, so that a warp's threads mostly take one branch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.trace import count, read_array, upload
from .launch import A_PLANES, padded_length

# Seed codes of a forward operand (a non-negative code is a position).
SEED_ZERO = -1
SEED_X = -2
SEED_Y = -3
SEED_Z = -4
NO_MARK = -1
# Fixed-point rounds of the vectorised level computation before it falls
# back to one pass in clause order (a tape deeper than this is a chain).
_ROUNDS = 64


@dataclass
class TapeLevels:
    """A tape's dependency schedule.

    ``planes`` (4, Tp) int32 on the device, in level order: the clause
    word, the forward sources (lhs in the low 16 bits, rhs in the high 16,
    each a position or a seed code), the mark targets (the same packing, a
    position or ``NO_MARK``) and the clause's index ``t`` in the tape.
    The schedule holds no immediate: kernel A reads each clause's from the
    tape's imms at ``t``, so a schedule stays valid when they change.
    ``offsets`` (n_levels + 1,) int32 on the device, level ``l`` holding
    positions ``[offsets[l], offsets[l+1])``.  ``widths`` the clauses of
    each level (host); ``res_src`` is the result's forward source,
    ``res_mark`` its mark target.  ``key`` = (length, result slot, sx, sy,
    sz): the kernel traps when the tape's metadata disagree.  ``host`` keeps the numpy arrays
    (``order``, ``level``, ``lhs_src``, ``rhs_src``, ``mark_l``,
    ``mark_r``, by position)."""
    length: int
    n_levels: int
    widest: int
    widths: tuple
    planes: torch.Tensor
    offsets: torch.Tensor
    res_src: int
    res_mark: int
    key: tuple
    seconds: float
    host: dict

    @property
    def padded(self) -> int:
        return int(self.planes.shape[1])


def _seed(slot, sx, sy, sz):
    """Seed codes of an array of slots (the order the slot walk writes
    them: x, y, z, then slot 0 cleared)."""
    out = np.full(slot.shape, SEED_ZERO, np.int64)
    out[slot == sx] = SEED_X
    out[slot == sy] = SEED_Y
    out[slot == sz] = SEED_Z
    out[slot == 0] = SEED_ZERO
    return out


def _last_writer(writers, outs, slot, t, T):
    """For reads of ``slot`` at clause ``t`` (arrays), the last clause
    index < t among ``writers`` (sorted indices) that wrote the slot, or
    -1."""
    if writers.size == 0:
        return np.full(np.shape(slot), -1, np.int64)
    key_w = outs[writers].astype(np.int64) * (T + 1) + writers
    key_w.sort()
    key_r = slot.astype(np.int64) * (T + 1) + t
    i = np.searchsorted(key_w, key_r, side="left") - 1
    ok = i >= 0
    w = key_w[np.maximum(i, 0)]
    ok &= (w // (T + 1)) == slot
    return np.where(ok, w % (T + 1), -1)


def _levels(deps, T):
    """Longest-path level of each clause over ``deps`` ((n, T) clause
    indices, -1 for none), every dependency earlier in the tape."""
    level = np.zeros(T, np.int64)
    has = deps >= 0
    safe = np.where(has, deps, 0)
    for _ in range(_ROUNDS):
        new = np.where(has, level[safe] + 1, 0).max(axis=0)
        if np.array_equal(new, level):
            return level
        level = new
    lv = level.tolist()
    cols = deps.T.tolist()
    for t in range(T):
        lv[t] = max([lv[d] + 1 for d in cols[t] if d >= 0], default=0)
    return np.asarray(lv, np.int64)


def _host(a):
    return read_array(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _pack(lo, hi):
    """Two int16 fields (low, high) in one int32."""
    v = (lo.astype(np.int64) & 0xFFFF) | ((hi.astype(np.int64) & 0xFFFF) << 16)
    return v.astype(np.uint32).view(np.int32)


def tape_levels(words, length: int, result_slot: int, axis_slots,
                device=None) -> TapeLevels:
    """The dependency schedule of the tape ``words[:length]`` (numpy or a
    tensor) with result slot ``result_slot`` and axis slots ``axis_slots``
    (sx, sy, sz), on ``device``."""
    t0 = time.perf_counter()
    T = int(length)
    if T > 1 << 15:
        raise ValueError(f"tape of {T} clauses: positions take 16 bits")
    w = _host(words)[:T].astype(np.int64) & 0xFFFFFFFF
    sx, sy, sz = (int(a) for a in axis_slots)
    res = int(result_slot)
    ops, outs = w & 0xFF, (w >> 8) & 0xFF
    lhss, rhss = (w >> 16) & 0xFF, (w >> 24) & 0xFF
    t = np.arange(T, dtype=np.int64)
    steps = (ops > 1) & (ops < 32)      # a forward step: above JUMP
    fwd, every = np.flatnonzero(steps), np.arange(T)

    lw = _last_writer(fwd, outs, lhss, t, T)
    rw = _last_writer(fwd, outs, rhss, t, T)
    lhs_src = np.where(lw >= 0, lw, _seed(lhss, sx, sy, sz))
    rhs_src = np.where(rw >= 0, rw, _seed(rhss, sx, sy, sz))
    mark_l = np.where(lhss != 0, _last_writer(every, outs, lhss, t, T), -1)
    mark_r = _last_writer(every, outs, rhss, t, T)
    end = np.array([T])
    res_w = _last_writer(fwd, outs, np.array([res]), end, T)[0]
    res_src = int(res_w if res_w >= 0 else _seed(np.array([res]), sx, sy,
                                                 sz)[0])
    res_mark = int(_last_writer(every, outs, np.array([res]), end, T)[0])

    deps = np.stack([np.where(steps, lhs_src, -1),
                     np.where(steps, rhs_src, -1), mark_l, mark_r])
    level = _levels(deps, T)
    # within a level, clauses of one opcode side by side (then in tape
    # order): the threads of a warp take neighbouring clauses, and take
    # one branch of the interval switch where they share an opcode
    order = np.lexsort((t, ops, level))
    pos = np.empty(T, np.int64)
    pos[order] = np.arange(T)
    counts = np.bincount(level, minlength=1) if T else np.zeros(1, np.int64)
    n_levels = int(level.max()) + 1 if T else 0
    offsets = np.zeros(n_levels + 1, np.int32)
    offsets[1:] = np.cumsum(counts[:n_levels])

    def at(x):  # clause indices -> positions, codes kept
        return np.where(x >= 0, pos[np.maximum(x, 0)], x)[order]

    tp = padded_length(T)
    planes = np.zeros((A_PLANES, tp), np.int32)
    planes[0, :T] = w[order].astype(np.uint32).view(np.int32)
    host = dict(order=order, level=level[order], lhs_src=at(lhs_src),
                rhs_src=at(rhs_src), mark_l=at(mark_l), mark_r=at(mark_r))
    planes[1, :T] = _pack(host["lhs_src"], host["rhs_src"])
    planes[2, :T] = _pack(host["mark_l"], host["mark_r"])
    planes[3, :T] = order
    dev = torch.device(device) if device is not None else torch.device("cpu")
    out = TapeLevels(
        length=T, n_levels=n_levels,
        widest=int(counts.max()) if T else 0,
        widths=tuple(int(c) for c in counts[:n_levels]),
        planes=upload(planes, dev), offsets=upload(offsets, dev),
        res_src=int(pos[res_src]) if res_src >= 0 else res_src,
        res_mark=int(pos[res_mark]) if res_mark >= 0 else NO_MARK,
        key=(T, res, sx, sy, sz), seconds=time.perf_counter() - t0,
        host=host)
    count("builds.schedule")
    return out
