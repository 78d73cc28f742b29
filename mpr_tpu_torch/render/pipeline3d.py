"""Staged 3D render pipeline: depth heightmap + normals, on PyTorch and CUDA.

The same stages as ``mpr_tpu.render.pipeline3d`` (its re-design of the
reference's ``Context::render3D``, reference/src/context.cu:1282-1458),
one frame (or one slab of screen-tile rows) on one device:

  1. stage A — kernel A (ops/kernels.py::interval_shorten) classifies all
     (n/64)^3 64^3 tiles against the full tape;
  2. occlusion — a heightmap from filled tiles culls ambiguous tiles whose
     top lies at or below the filled height over their whole screen block
     (the ``mask_filled_tiles`` analog, :471-495);
  3. stage B — kernel A again over the 64 16^3 children of each surviving
     ambiguous parent, full tape, emitting shorten codes; children of
     filled and empty parents are never evaluated;
  4. per-cell tapes — the prepass and kernel C (compact_bitshift_batched)
     turn the children's codes into dense run-structured tapes;
  5. stage C — kernel V (ops/kernels3d.py::voxel_eval_3d) evaluates each
     ambiguous child's 16^3 voxels with its own tape;
  6. depth compose — painter's-algorithm maximum composition (the
     reference's atomicMax heightmap, :932-948) as a scatter-max;
  7. normals — per-xy-column tapes (kernel A over the full z extent, so one
     tape is valid at every depth of the column, then kernel C) and kernel
     D (ops/kernels3d.py::deriv_eval_3d).

Counts.  ``mpr_tpu`` sizes stages B and C by static capacities and
re-renders with doubled ones until nothing overflows, so its result is the
uncapped one.  Here the three counts that size the later stages (ambiguous
tiles, ambiguous cells, screen tiles with content) are read back to the
host, three reads a frame, and each stage is sized exactly: there are no
capacities, no retry, and ``render3d_rows`` returns the true counts.

Depth convention: int32 per pixel, 0 = empty, else top filled voxel
index + 1 (matches render/brute.py::render3d_brute and the reference's
z-index image).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as _config
from ..ops import interval_math as im
from ..ops import kernels, kernels3d
from ..ops import transcendental as tc
from ..ops.kernels import ST_AMBIG, ST_FILLED
from ..ops.tape_data import TapeData, resolve_device
from ..tape.tape import Tape
from ..utils.trace import read_int, span, upload
from . import camera
from .pipeline2d import _iv_mul_scalar, _shorten_prepass

TILE = 64
# tape words the prepass unpacks at once (rows x Tcap), bounding its
# temporaries to a few hundred MB whatever the count of cells
PREPASS_WORDS = 1 << 24


def _mat4_interval(mat, xl, xh, yl, yh, zl, zh):
    """Interval-valued projective mat4 transform (the interval analog of
    calculate_intervals_3d, reference/src/context.cu:78-121)."""
    def row(r):
        al, ah = _iv_mul_scalar(mat[r, 0], xl, xh)
        bl, bh = _iv_mul_scalar(mat[r, 1], yl, yh)
        cl, ch = _iv_mul_scalar(mat[r, 2], zl, zh)
        return al + bl + cl + mat[r, 3], ah + bh + ch + mat[r, 3]

    wl, wh = row(3)
    outs = []
    for r in range(3):
        rl, rh = row(r)
        outs.extend(im.i_div(torch, rl, rh, wl, wh))
    return outs  # xl xh yl yh zl zh


def _axis_iv(n: int, idx):
    f = idx.to(torch.float32)
    lo = (tc.div_scalar(f, n) - 0.5) * 2.0
    hi = (tc.div_scalar(f + 1.0, n) - 0.5) * 2.0
    return lo, hi


def _tile_boxes_3d(n: int, mat, row0=0, n_rows: int = None):
    """Boxes for the 64^3 tiles of screen-tile rows [row0, row0+n_rows);
    LOCAL tile id t = (tz*n_rows + ty_local)*n + tx.  Returns (6, tiles)."""
    if n_rows is None:
        n_rows = n
    t = torch.arange(n * n_rows * n, dtype=torch.int32, device=mat.device)
    xl, xh = _axis_iv(n, t % n)
    yl, yh = _axis_iv(n, row0 + (t // n) % n_rows)
    zl, zh = _axis_iv(n, t // (n * n_rows))
    return torch.stack(_mat4_interval(mat, xl, xh, yl, yh, zl, zh))


def _child_cells(n: int, parents, row0=0, n_rows: int = None):
    """16-cell grid coordinates (gx, gy, gz) of the 64 children of each
    LOCAL parent tile id in ``parents``; gy is GLOBAL (row0 applied).
    Child lane = pslot*64 + c with c = (czi*4 + cyi)*4 + cxi."""
    if n_rows is None:
        n_rows = n
    p = parents
    tx = p % n
    ty = row0 + (p // n) % n_rows
    tz = p // (n * n_rows)
    c = torch.arange(64, dtype=torch.int32, device=p.device)
    gx = (tx[:, None] * 4 + (c % 4)[None, :]).reshape(-1)
    gy = (ty[:, None] * 4 + ((c // 4) % 4)[None, :]).reshape(-1)
    gz = (tz[:, None] * 4 + (c // 16)[None, :]).reshape(-1)
    return gx, gy, gz


def _child_boxes_3d(n: int, mat, parents, row0=0, n_rows: int = None):
    """Boxes for the 64 16^3 children of each LOCAL parent tile id in
    ``parents`` (local ids index the slab's (tz, ty_local, tx) grid)."""
    gx, gy, gz = _child_cells(n, parents, row0, n_rows)
    xl, xh = _axis_iv(4 * n, gx)
    yl, yh = _axis_iv(4 * n, gy)
    zl, zh = _axis_iv(4 * n, gz)
    return torch.stack(_mat4_interval(mat, xl, xh, yl, yh, zl, zh))


def _column_boxes(n: int, mat, row0=0, n_rows: int = None):
    """Boxes for the slab's xy screen tiles, z spanning the full [-1, 1]."""
    if n_rows is None:
        n_rows = n
    t = torch.arange(n_rows * n, dtype=torch.int32, device=mat.device)
    xl, xh = _axis_iv(n, t % n)
    yl, yh = _axis_iv(n, row0 + t // n)
    zl = torch.full_like(xl, -1.0)
    zh = torch.full_like(xl, 1.0)
    return torch.stack(_mat4_interval(mat, xl, xh, yl, yh, zl, zh))


def _amb_first(amb):
    """Stable order with the ambiguous lanes first, and their count (one
    read back to the host)."""
    order = torch.argsort((~amb).to(torch.int32), stable=True)
    return order.to(torch.int32), read_int(amb.sum())


def _row_tapes(td, codes_sel, remap_t, cap):
    """Per-row shortened tapes from kernel A's codes: the prepass in
    chunks of rows, then one launch of kernel C over all rows."""
    G = codes_sel.shape[0]
    dev = codes_sel.device
    tcap = td.capacity
    planes = [torch.empty(G, 8, tcap // 8, dtype=torch.int32, device=dev)
              for _ in range(3)]
    lens = torch.empty(G, dtype=torch.int32, device=dev)
    chunk = max(1, PREPASS_WORDS // tcap)
    for g0 in range(0, G, chunk):
        out = _shorten_prepass(codes_sel[g0:g0 + chunk], td.packed, td.imms,
                               td.length, remap_t)
        for dst, src in zip(planes + [lens], out):
            dst[g0:g0 + chunk] = src
    cmeta = upload([G, cap, cap, 0, 0, 0, 0, 0], dev, torch.int32)
    tw, ti_bits, runs, gmeta = kernels.compact_bitshift_batched(
        cmeta, lens, *planes, cap=cap)
    return tw, ti_bits.view(torch.float32), runs, gmeta


def render3d_rows(td: TapeData, mat, size: int, row0: int, n_rows: int,
                  with_normals: bool = True, s_cap: int = None):
    """Render screen-tile rows [row0, row0+n_rows) of a size^2 3D frame on
    the tape's device.

    A sharded renderer calls this per slab (each device owns a horizontal
    slab; every stage is slab-local because tiles have no cross-tile data
    dependence); the single-device path passes the whole grid.

    ``mat``: (4, 4) f32 tensor on that device; ``s_cap`` overrides the
    slot bucket (default: the tape's slot count rounded up to 8).
    Returns (depth (n_rows*64, size) int32 tensor, normals (n_rows*64,
    size, 3) f32 tensor or None, counts) with counts a dict of the three
    numbers read back: ``n_amb0`` ambiguous 64^3 tiles after the occlusion
    cull, ``n_amb1`` ambiguous 16^3 cells after it, ``n_act`` screen tiles
    with content (None without normals)."""
    cfg = _config.get()
    dev = td.device
    n = size // TILE
    if s_cap is None:
        s_cap = max(8, -(-td.num_slots // 8) * 8)
    branch_ops, remap = kernels.build_remap(td.ops_present)
    remap_t = upload(remap, dev)
    runs_full = remap_t[(td.runs & 0xFF).long()] | (td.runs & ~0xFF)
    meta = td.meta()
    matf = mat.reshape(16).contiguous()
    cap = td.capacity // cfg.cap_div
    widen = cfg.widen_intervals
    h_px = n_rows * TILE

    def stage(boxes):
        return kernels.interval_shorten(meta, td.packed, td.imms,
                                        boxes.contiguous(), s_cap=s_cap,
                                        widen=widen, levels=td.levels)

    # ---- stage A: 64^3 tiles, full tape ---------------------------------
    with span("mpr.3d.A"):
        status0, _ = stage(_tile_boxes_3d(n, mat, row0, n_rows))
        st0 = status0.reshape(n, n_rows, n)                # [tz, ty_l, tx]
        tz_idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None,
                                                                None]
        h0 = torch.where(st0 == ST_FILLED, (tz_idx + 1) * TILE,
                         0).amax(dim=0)

        # occlusion cull of ambiguous tiles fully at/below the filled height
        t_all = torch.arange(n * n_rows * n, dtype=torch.int32, device=dev)
        top0 = (t_all // (n * n_rows) + 1) * TILE
        amb0 = (status0 == ST_AMBIG) & (top0 > h0.reshape(-1)[
            ((t_all // n) % n_rows * n + t_all % n).long()])
        order0, n_amb0 = _amb_first(amb0)
        parents = order0[:n_amb0].contiguous()

    with span("mpr.3d.B"):
        # 16-px-granular heightmap: filled parents upsampled
        h16 = h0.repeat_interleave(4, 0).repeat_interleave(4, 1)
        n_amb1 = 0
        if n_amb0:
            # ---- stage B: 16^3 children of ambiguous parents ------------
            status1, codes1 = stage(_child_boxes_3d(n, mat, parents, row0,
                                                    n_rows))
            gx16, gy16, gz16 = _child_cells(n, parents, 0, n_rows)  # y local
            top1 = (gz16 + 1) * 16
            cell = (gy16 * (4 * n) + gx16).long()
            # ... plus filled children (max is order-independent)
            h16 = h16.reshape(-1).scatter_reduce(
                0, cell, torch.where(status1 == ST_FILLED, top1, 0),
                "amax").reshape(4 * n_rows, 4 * n)
            amb1 = (status1 == ST_AMBIG) & (top1 > h16.reshape(-1)[cell])
            order1, n_amb1 = _amb_first(amb1)
            order1 = order1[:n_amb1].contiguous()
        depth = h16.repeat_interleave(16, 0).repeat_interleave(16, 1)

    if n_amb1:
        # ---- per-cell tapes, then stage C: voxel evaluation --------------
        with span("mpr.3d.tapes"):
            sel1 = order1.long()
            tw, ti, runsC, gmetaC = _row_tapes(td, codes1[sel1], remap_t,
                                               cap)
        del codes1
        with span("mpr.3d.V"):
            nmeta = meta.clone()
            nmeta[0] = n_amb1
            nmeta[7] = row0
            vals = kernels3d.voxel_eval_3d(nmeta, order1, parents, matf,
                                           td.packed, td.imms, runs_full,
                                           branch_ops, tw, ti, runsC, gmetaC,
                                           n_side=n, n_rows=n_rows,
                                           s_cap=s_cap)
        del tw, ti, runsC, gmetaC

    with span("mpr.3d.compose"):
        if n_amb1:
            # ---- depth composition (slab-local image) ---------------------
            v = vals.reshape(n_amb1, 16, 16, 16)            # [vz, vy, vx]
            k16 = torch.arange(16, dtype=torch.int32, device=dev)
            cz0 = (gz16[sel1] * 16)[:, None, None, None]
            hit = torch.where(v < 0.0, cz0 + k16[None, :, None, None] + 1,
                              0)
            dep_c = hit.amax(dim=1)                         # (n_amb1, 16, 16)
            py = (gy16[sel1] * 16)[:, None, None] + k16[None, :, None]
            px = (gx16[sel1] * 16)[:, None, None] + k16[None, None, :]
            flat = (py * size + px).reshape(-1).long()
            depth = depth.reshape(-1).scatter_reduce(
                0, flat, dep_c.reshape(-1), "amax").reshape(h_px, size)
            del vals, v, hit
        depth = depth.to(torch.int32).contiguous()
    counts = {"n_amb0": n_amb0, "n_amb1": n_amb1, "n_act": None}
    if not with_normals:
        return depth, None, counts

    # ---- normals: column tapes + kernel D ---------------------------------
    with span("mpr.3d.normals"):
        n_cols = n_rows * n
        _, codesD = stage(_column_boxes(n, mat, row0, n_rows))
        blocks = depth.reshape(n_rows, TILE, n, TILE).permute(0, 2, 1, 3)
        blocks = blocks.reshape(n_cols, TILE * TILE).contiguous()
        orderD, n_act = _amb_first(blocks.amax(dim=1) > 0)
        counts["n_act"] = n_act
        all_blocks = torch.zeros(n_cols, 4, TILE * TILE,
                                 dtype=torch.float32, device=dev)
        if n_act:
            with span("mpr.3d.tapes"):
                rowsD = orderD[:n_act].long()
                twD, tiD, runsD, gmetaD = _row_tapes(td, codesD[rowsD],
                                                     remap_t, cap)
            nmetaD = meta.clone()
            nmetaD[0] = n_act
            nmetaD[7] = row0
            out = kernels3d.deriv_eval_3d(nmetaD, orderD, matf, td.packed,
                                          td.imms, runs_full, branch_ops,
                                          twD, tiD, runsD, gmetaD, blocks,
                                          n_side=n, n_rows=n_rows,
                                          s_cap=s_cap)
            # rows back to tile order
            all_blocks[rowsD] = out
        grad = all_blocks[:, 1:4]                          # (n_cols, 3, 4096)
        norm = tc.sqrt((grad * grad).sum(dim=1, keepdim=True))
        grad = grad / torch.clamp_min(norm, 1e-12)
        img = grad.reshape(n_rows, n, 3, TILE, TILE).permute(0, 3, 1, 4, 2)
        img = img.reshape(h_px, size, 3)
        img = torch.where((depth > 0)[:, :, None], img, 0.0)
        return depth, img, counts


def render3d(tape: Tape, mat=None, size: int = 256, with_normals: bool = True,
             device=None):
    """Render depth (+ normals) like render3D
    (reference/inc/context.hpp:50-54).  Runs on ``cuda`` unless ``device``
    names another device; with no card and no device it raises.

    Returns (depth int32 (size, size), normals f32 (size, size, 3) or
    None) as numpy arrays.  Depth: 0 = empty, else top filled voxel
    index + 1."""
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity3() if mat is None else np.asarray(mat, np.float32)
    depth, normals, _ = render3d_rows(td, torch.as_tensor(mat, device=dev),
                                      size, 0, size // TILE, with_normals)
    return depth.cpu().numpy(), (None if normals is None
                                 else normals.cpu().numpy())
