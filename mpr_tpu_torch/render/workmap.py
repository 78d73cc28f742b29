"""Work per pixel of the unrolled engine.

Counterpart of ``mpr_tpu.render.workmap``.  The unrolled engine never
shortens a tape, so every evaluation costs ``tape.length`` clauses and a
pixel's work follows from the ladder's stage statuses alone: which stage
decided it, and how many deeper evaluations its cells paid.  This module
runs the interval stages again (the interval evaluator of
``ops/unrolled_eval.py``; no pixel or voxel stage) and composes the count
image, normalised by the tape's length like the reference's heatmaps
(reference/src/context.cu:2140-2144):

  2D:  1/4096                        every pixel (64px stage, amortized)
     + 1/64    if its 64px tile was ambiguous      (8px children stage)
     + 1       if its 8px tile was ambiguous       (pixel stage)

  3D:  n/4096 summed over the z column's 64^3 cells, then per surviving
     (ambiguous and unoccluded) cell: 64 interval evaluations over its xy
     block at each refinement, and 64 float evaluations a surviving 4^3
     cell (4096 a 16^3 cell under skip4); + 1 a pixel of a screen tile
     with content, for the normals pass.

The port sizes every stage by its exact count, so the work executed is
the work attributed: ``totals`` reports no padding lanes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.tape_data import resolve_device
from ..tape.tape import Tape
from . import camera
from .unrolled import (ST_AMBIG, _st8_image, _stages2d, _stages3d, _up,
                       get_renderer)


def workmap2d(tape: Tape, mat=None, z: float = 0.0, size: int = 256,
              device=None) -> Tuple[np.ndarray, dict]:
    """(per-pixel normalised clause count, totals) of the unrolled 2D
    ladder."""
    dev = resolve_device(device)
    r = get_renderer(tape, imm_inputs=bool(tape.params))
    mat = camera.identity2() if mat is None else np.asarray(mat, np.float32)
    mat_t = torch.as_tensor(mat, device=dev)
    z_t = torch.tensor(z, dtype=torch.float32, device=dev)
    r._ready(dev, [r.fi])
    n64 = size // 64
    st64, ids64, st8c, _, gx8, gy8 = _stages2d(r.fi, mat_t, z_t, size,
                                                r._imms_arg(None, dev))
    st8img = _st8_image(st64, st8c, gx8, gy8, size)
    amb64 = (st64 == ST_AMBIG).to(torch.float32).reshape(n64, n64)
    amb8 = (st8img == ST_AMBIG).to(torch.float32)
    w8 = 1.0 / 4096.0 + _up(amb64, 8) / 64.0 + amb8
    heat = _up(w8, 8)
    a64 = int(ids64.shape[0])
    a8 = int((st8c == ST_AMBIG).sum())
    L = tape.length
    evals = (size * size // 4096 + a64 * 64 + a8 * 64) * L
    totals = {
        "clauses": L,
        "stage_lanes": {"64px": size * size // 4096, "8px": a64 * 64,
                        "pixel": a8 * 64},
        "attributable_evals": evals,
        "executed_evals": evals,
        "padding_evals": 0,
    }
    return heat.cpu().numpy(), totals


def _workmap3d_heat(fi, mat, size: int, skip4: bool, imms):
    """The interval stages of the 3D ladder (unrolled._stages3d), with
    each stage's work scattered into an xy image of its granularity.
    Returns (heat, (n0, n1, n2))."""
    n = size // 64
    dev = mat.device
    f32 = torch.float32
    s = _stages3d(fi, mat, size, skip4, imms)
    # every 64^3 cell costs one interval evaluation over 64^2 px; stage
    # B's share: 64 children x L intervals over the parent's 64^2 px
    heat64 = torch.full((n * n,), n / 4096.0, dtype=f32, device=dev)
    heat64 = heat64.index_add(0, s.cell64,
                              torch.where(s.surv0, 64.0 / 4096.0, 0.0))
    # skip4: the surviving 16^3 cells evaluate their 4096 voxels, 16 a px;
    # else stage B''s share: 64 children x L intervals over 16^2 px
    heat16 = torch.zeros(16 * n * n, dtype=f32, device=dev).index_add(
        0, s.cell16, torch.where(s.surv1, 16.0 if skip4 else 64.0 / 256.0,
                                 0.0))
    heat4 = torch.zeros(256 * n * n, dtype=f32, device=dev)
    if not skip4:
        # voxel stage: 64 float evaluations over the 4^2 px block = 4 a px
        heat4 = heat4.index_add(0, s.cell4, torch.where(s.surv2, 4.0, 0.0))
    heat = (_up(heat64.reshape(n, n), 64)
            + _up(heat16.reshape(4 * n, 4 * n), 16)
            + _up(heat4.reshape(16 * n, 16 * n), 4))
    return heat, s.counts


def workmap3d(tape: Tape, mat=None, size: int = 256, device=None
              ) -> Tuple[np.ndarray, dict]:
    """(per-pixel normalised clause count, totals) of the unrolled 3D
    ladder; the normals pass adds 1 a pixel of every screen tile with
    content (one dual-number evaluation a pixel)."""
    dev = resolve_device(device)
    r = get_renderer(tape, imm_inputs=bool(tape.params))
    depth, _ = r.render3d(mat, size, with_normals=False, device=dev)
    skip4 = r._skip4_key(("3d", size))
    mat = camera.identity3() if mat is None else np.asarray(mat, np.float32)
    heat, (a0, a1, a2) = _workmap3d_heat(
        r.fi, torch.as_tensor(mat, device=dev), size, skip4,
        r._imms_arg(None, dev))
    heat = heat.cpu().numpy()
    content = depth.reshape(size // 64, 64, size // 64, 64).max(
        axis=(1, 3)) > 0
    heat = heat + np.repeat(np.repeat(content.astype(np.float32), 64, 0),
                            64, 1)
    L = tape.length
    lanes = (size // 64) ** 3 + a0 * 64 + (
        a1 * 4096 if skip4 else (a1 * 64 + a2 * 64))
    totals = {
        "clauses": L, "skip4": bool(skip4),
        "counts": {"64^3": a0, "16^3": a1, "4^3": a2},
        "attributable_evals": lanes * L,
        "executed_evals": lanes * L,
        "padding_evals": 0,
    }
    return heat, totals
