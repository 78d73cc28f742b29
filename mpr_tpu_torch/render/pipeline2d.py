"""Staged 2D render pipeline (Alg 3 of the paper) on PyTorch and CUDA.

The same stages as ``mpr_tpu.render.pipeline2d``, one frame on one device:

  1. kernel A (ops/kernels.py::interval_shorten): interval-evaluate all
     (N/64)^2 64-px tiles against the full tape, classify
     empty/filled/ambiguous, and emit per-clause shorten codes;
  2. a stable sort moves ambiguous tiles to the front (the reference's
     ``assign_next_nodes`` stream compaction, reference/src/context.cu:
     512-551) — the ambiguous count stays on the device;
  3. the prepass (plain PyTorch) turns each ambiguous tile's codes into
     rewritten words, imm bits and move distances, and kernel C
     (compact_bitshift_batched) compacts them into per-tile tapes with
     opcode-run headers;
  4. kernel B (pixel_eval_runs) evaluates every pixel of each ambiguous
     tile with its shortened tape, and writes the decision of every
     decided tile, indexed by tile, so the image is a reshape.

No stage reads a count back to the host, and the kernels take the tape's
metadata at run time, so any tape renders with the one kernel build.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as _config
from ..ops import interval_math as im
from ..ops import kernels
from ..ops.kernels import ST_AMBIG
from ..ops.tape_data import TapeData, resolve_device
from ..tape.tape import Tape
from . import camera

TILE = 64


def _iv_mul_scalar(m, lo, hi):
    """interval * scalar."""
    a, b = m * lo, m * hi
    return torch.minimum(a, b), torch.maximum(a, b)


def _tile_boxes_2d(n_side: int, mat, z, row0=0, n_rows: int = None,
                   col0=0, n_cols: int = None):
    """Interval-transform tile AABBs for the tile block
    [row0, row0+n_rows) x [col0, col0+n_cols), like calculate_intervals_2d
    (reference/src/context.cu:122-159).  ``mat``: (3, 3) f32 tensor, ``z``
    a 0-d f32 tensor, both on the output device.  Returns (6, n_tiles)."""
    if n_rows is None:
        n_rows = n_side
    if n_cols is None:
        n_cols = n_side
    dev = mat.device
    f32 = torch.float32
    cidx = col0 + torch.arange(n_cols, dtype=f32, device=dev)
    lo = (cidx / n_side - 0.5) * 2.0
    hi = ((cidx + 1.0) / n_side - 0.5) * 2.0
    ridx = row0 + torch.arange(n_rows, dtype=f32, device=dev)
    rlo = (ridx / n_side - 0.5) * 2.0
    rhi = ((ridx + 1.0) / n_side - 0.5) * 2.0
    # tile t = (ty, tx): x box from tx, y box from ty
    xl = lo.repeat(n_rows)
    xh = hi.repeat(n_rows)
    yl = rlo.repeat_interleave(n_cols)
    yh = rhi.repeat_interleave(n_cols)

    def affine(r):
        al, ah = _iv_mul_scalar(mat[r, 0], xl, xh)
        bl, bh = _iv_mul_scalar(mat[r, 1], yl, yh)
        return al + bl + mat[r, 2], ah + bh + mat[r, 2]

    txl, txh = affine(0)
    tyl, tyh = affine(1)
    twl, twh = affine(2)
    # projective divide (interval): exact interval division, so a w range
    # spanning 0 gives an unbounded box
    txl, txh = im.i_div(torch, txl, txh, twl, twh)
    tyl, tyh = im.i_div(torch, tyl, tyh, twl, twh)
    zf = z.expand_as(xl)
    return torch.stack([txl, txh, tyl, tyh, zf, zf]).contiguous()


def _pixel_coords_2d(n_side: int, mat, z, row0=0, n_rows: int = None,
                     col0=0, n_cols: int = None):
    """Per-tile pixel-center coordinates after transform, shaped
    (n_tiles, 3, 4096) with lane k of tile (ty,tx) at pixel
    (ty*64 + k//64, tx*64 + k%64) — matches calculate_pixels
    (reference/src/context.cu:764-813)."""
    if n_rows is None:
        n_rows = n_side
    if n_cols is None:
        n_cols = n_side
    dev = mat.device
    f32 = torch.float32
    size = n_side * TILE
    k = torch.arange(TILE * TILE, device=dev)
    dy = (k // TILE).to(f32)
    dx = (k % TILE).to(f32)
    tc = (col0 + torch.arange(n_cols, dtype=f32, device=dev)) * TILE
    tr = (row0 + torch.arange(n_rows, dtype=f32, device=dev)) * TILE
    gx = tc[:, None] + dx[None, :]         # (n_cols, 4096)
    gy = tr[:, None] + dy[None, :]         # (n_rows, 4096)
    fx = ((gx + 0.5) / size - 0.5) * 2.0
    fy = ((gy + 0.5) / size - 0.5) * 2.0
    fx = fx[None].expand(n_rows, n_cols, TILE * TILE).reshape(-1, TILE * TILE)
    fy = fy[:, None].expand(n_rows, n_cols, TILE * TILE).reshape(
        -1, TILE * TILE)
    w = mat[2, 0] * fx + mat[2, 1] * fy + mat[2, 2]
    x = (mat[0, 0] * fx + mat[0, 1] * fy + mat[0, 2]) / w
    y = (mat[1, 0] * fx + mat[1, 1] * fy + mat[1, 2]) / w
    zz = z.expand_as(x)
    return torch.stack([x, y, zz], dim=1).contiguous()   # (n_tiles, 3, 4096)


def _shorten_prepass(codes, words, imms, length, remap, rows: int = 8):
    """Plain PyTorch prepass for the compaction kernel.

    Unpacks kernel A's 4-bit shorten codes, applies the run-preserving
    rewrites (choice=LHS on MIN/MAX_LHS_RHS duplicates the operand,
    choice=LHS on *_LHS_IMM sets the imm to +-inf, choice=RHS on
    MIN/MAX_LHS_RHS moves rhs to lhs, COPY_IMM stays the one run
    breaker), replaces the opcode byte with the kernel branch id, and
    computes each kept clause's leftward move (= dropped clauses before
    it).  ``length`` (int or 0-d tensor) masks codes past the tape.

    Returns (wrw, irw, rem) as (L, rows, Tcap/rows) int32 planes + lens
    (L,) int32.
    """
    L = codes.shape[0]
    tcap = words.shape[0]
    dev = codes.device
    nib = kernels.unpack_codes(codes, tcap)
    t_idx = torch.arange(tcap, dtype=torch.int32, device=dev)
    nib = torch.where(t_idx[None, :] < length, nib, 0)
    keep = nib > 0
    new_op, body, imm_bits = kernels.rewrite_clauses(nib, words, imms)
    wrw = torch.where(keep, remap[new_op.long()] | body, 0)
    irw = torch.where(keep, imm_bits, 0)
    incl = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32)
    rem = torch.where(keep, t_idx[None, :] - (incl - 1), 0)
    lens = incl[:, -1].contiguous()
    wr = tcap // rows
    return (wrw.to(torch.int32).reshape(L, rows, wr),
            irw.to(torch.int32).reshape(L, rows, wr),
            rem.to(torch.int32).reshape(L, rows, wr), lens)


def render_tile_block(td: TapeData, mat, z, size: int, row0=0,
                      n_rows: int = None, col0=0, n_cols: int = None):
    """Render the tile block [row0, row0+n_rows) x [col0, col0+n_cols) of a
    size² image on the tape's device (a block per device is how the
    sharded renderer splits a frame).

    ``mat``: (3, 3) f32 tensor and ``z`` 0-d f32 tensor on that device.
    Returns (block image (n_rows*64, n_cols*64) bool tensor, status
    (n_rows*n_cols,) int32).
    """
    n_side = size // TILE
    if n_rows is None:
        n_rows = n_side
    if n_cols is None:
        n_cols = n_side
    dev = td.device
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    meta = td.meta()
    branch_ops, remap = kernels.build_remap(td.ops_present)
    remap_t = torch.as_tensor(remap, device=dev)
    # full-tape run headers with the op byte remapped to branch ids
    runs_full = remap_t[(td.runs & 0xFF).long()] | (td.runs & ~0xFF)
    widen = _config.get().widen_intervals
    boxes = _tile_boxes_2d(n_side, mat, z, row0, n_rows, col0, n_cols)
    status, codes = kernels.interval_shorten(meta, td.packed, td.imms, boxes,
                                             s_cap=s_cap, widen=widen,
                                             levels=td.levels)

    amb = status == ST_AMBIG
    order = torch.argsort((~amb).to(torch.int32), stable=True).to(torch.int32)
    n_amb = amb.sum(dtype=torch.int32)

    # Per-tile cap: small images shorten less per tile (each tile covers
    # more of the shape), so they get Tcap/4; large images Tcap/8.
    cap = td.capacity // (8 if n_side >= 16 else 4)
    wrw, irw, rem, lens = _shorten_prepass(codes[order.long()], td.packed,
                                           td.imms, meta[0], remap_t)
    cmeta = torch.zeros(8, dtype=torch.int32, device=dev)
    cmeta[0] = n_amb
    cmeta[1] = cap
    cmeta[2] = cap
    tw, ti_bits, runs, gmeta = kernels.compact_bitshift_batched(
        cmeta, lens, wrw, irw, rem, cap=cap)
    ti = ti_bits.view(torch.float32)

    nmeta = meta.clone()
    nmeta[0] = n_amb
    coords = _pixel_coords_2d(n_side, mat, z, row0, n_rows, col0, n_cols)
    fill = kernels.pixel_eval_runs(nmeta, order, status, td.packed, td.imms,
                                   runs_full, branch_ops, tw, ti, runs,
                                   gmeta, coords, s_cap=s_cap)
    img = (fill > 0).reshape(n_rows, n_cols, TILE, TILE)
    img = img.permute(0, 2, 1, 3)
    return img.reshape(n_rows * TILE, n_cols * TILE), status


def render2d(tape: Tape, mat=None, z: float = 0.0, size: int = 256,
             device=None) -> np.ndarray:
    """Render a boolean fill image (row=y up, col=x), like render2D
    (reference/inc/context.hpp:38-44).  Runs on ``cuda`` unless ``device``
    names another device; with no card and no device it raises."""
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity2() if mat is None else np.asarray(mat, np.float32)
    img, _ = render_tile_block(td, torch.as_tensor(mat, device=dev),
                               torch.tensor(z, dtype=torch.float32,
                                            device=dev), size)
    return img.cpu().numpy()
