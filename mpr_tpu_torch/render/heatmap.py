"""Work-per-pixel heatmaps.

Counterpart of ``mpr_tpu.render.heatmap``.  The reference duplicates its
kernels with an interpreted-clause counter spread over each tile's pixels
(``eval_tiles_i_heatmap`` / ``eval_voxels_f_heatmap``,
reference/src/context.cu:1513-2340).  Here the same quantity falls out of
the pipeline's own bookkeeping: the run-dispatch interpreters execute
exactly the shortened-tape lengths the prepass reports, so the heatmap is
kernel A's status plus the kept-clause counts, upsampled to pixels.  No
instrumented kernels, no second render.

Normalization matches the reference: clause counts divided by the source
tape length.  The 3D heatmap sizes its child stage from the count of
ambiguous tiles read back from the device (``mpr_tpu`` truncates it at a
static capacity).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as _config
from ..ops import kernels
from ..ops.kernels import ST_AMBIG
from ..ops.tape_data import TapeData, resolve_device
from ..tape.tape import Tape
from . import camera
from .pipeline2d import TILE, _shorten_prepass, _tile_boxes_2d
from .pipeline3d import (PREPASS_WORDS, _amb_first, _child_boxes_3d,
                         _child_cells, _tile_boxes_3d)


def _stage(td: TapeData, boxes):
    """Kernel A over ``boxes`` and the kept-clause count of every lane:
    (status (lanes,), lens (lanes,) int32)."""
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    _, remap = kernels.build_remap(td.ops_present)
    remap_t = torch.as_tensor(remap, device=td.device)
    status, codes = kernels.interval_shorten(
        td.meta(), td.packed, td.imms, boxes.contiguous(), s_cap=s_cap,
        widen=_config.get().widen_intervals, levels=td.levels)
    chunk = max(1, PREPASS_WORDS // td.capacity)
    lens = torch.cat([
        _shorten_prepass(codes[g0:g0 + chunk], td.packed, td.imms, td.length,
                         remap_t)[3]
        for g0 in range(0, codes.shape[0], chunk)])
    return status, lens


def _upsample(a, k: int):
    return a.repeat_interleave(k, 0).repeat_interleave(k, 1)


def render2d_heatmap(tape: Tape, mat=None, z: float = 0.0, size: int = 256,
                     device=None) -> np.ndarray:
    """Per-pixel normalized clause-evaluation count, like
    Context::render2D_heatmap (reference/src/context.cu:2009-2147)."""
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity2() if mat is None else np.asarray(mat, np.float32)
    n_side = size // TILE
    status, lens = _stage(td, _tile_boxes_2d(
        n_side, torch.as_tensor(mat, device=dev),
        torch.tensor(z, dtype=torch.float32, device=dev)))
    cap = td.capacity // 8
    T = torch.tensor(float(td.length), device=dev)
    # per-pixel work: the interval stage amortized over the 64x64 tile
    # + the pixel stage's shortened tape (the full tape on overflow)
    pix = torch.where(lens > cap, T, lens.to(torch.float32))
    per_tile = T / (TILE * TILE) + torch.where(status == ST_AMBIG, pix, 0.0)
    heat = _upsample(per_tile.reshape(n_side, n_side), TILE)
    return (heat / T).cpu().numpy()


def render3d_heatmap(tape: Tape, mat=None, size: int = 256,
                     device=None) -> np.ndarray:
    """3D analog (Context::render3D_heatmap,
    reference/src/context.cu:2150-2340); normals work excluded."""
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity3() if mat is None else np.asarray(mat, np.float32)
    m = torch.as_tensor(mat, device=dev)
    n = size // TILE
    length = float(td.length)
    T = torch.tensor(length, device=dev)
    cap = td.capacity // 2    # matches pipeline3d's per-cell cap

    # stage A work: T per 64^3 tile, amortized over its 64^2 pixels,
    # summed over the n z-tiles of each screen column
    heat_xy = torch.full((n * n,), n * length / (TILE * TILE),
                         dtype=torch.float32, device=dev)
    status0, _ = _stage(td, _tile_boxes_3d(n, m))
    amb0 = status0 == ST_AMBIG
    order0, n_amb0 = _amb_first(amb0)
    parents = order0[:n_amb0]

    # stage B work: T per 16^3 child over its 16^2 pixels; every ambiguous
    # parent adds its 64 children's share to its xy block (each child
    # covers 1/16 of the parent's 64x64 block)
    t_all = torch.arange(n ** 3, device=dev)
    txy = ((t_all // n) % n) * n + (t_all % n)
    w_b = torch.where(amb0, 64.0 * length / (16 * 16), 0.0)
    heat_xy = heat_xy.index_put((txy,), w_b / (4.0 * 4.0), accumulate=True)
    heat = _upsample(heat_xy.reshape(n, n), TILE)
    if n_amb0:
        status1, lens1 = _stage(td, _child_boxes_3d(n, m, parents))
        # voxel work: 16 voxels per pixel of an ambiguous child's 16x16 block
        pix1 = torch.where(lens1 > cap, T, lens1.to(torch.float32)) * 16.0
        pix1 = torch.where(status1 == ST_AMBIG, pix1, 0.0)
        gx16, gy16, _ = _child_cells(n, parents)
        heat16 = torch.zeros(4 * n * 4 * n, dtype=torch.float32, device=dev)
        heat16 = heat16.index_put(((gy16 * (4 * n) + gx16).long(),), pix1,
                                  accumulate=True)
        heat = heat + _upsample(heat16.reshape(4 * n, 4 * n), 16)
    return (heat / T).cpu().numpy()
