"""The unrolled engine: the staged render ladders on per-tape kernels.

Counterpart of ``mpr_tpu.render.unrolled``, the second render engine
beside the interpreter pipelines (pipeline2d, pipeline3d).  The same
staged interval culling (the reference's ``Context::render2D/3D``,
reference/src/context.cu:1136-1458), but every evaluation runs the FULL
tape through the evaluators of ``ops/unrolled_eval.py``: on a card the
kernels generated for this tape, on the CPU their plain versions.  The
tape is never shortened, so there are no shorten codes, no compaction and
no per-tile tapes; a ladder is as deep as the reference's stage list:

  * 2D: 64px tiles -> 8px tiles -> pixels (:func:`_stages2d`,
    :func:`_render2d_impl`);
  * 3D: 64^3 -> 16^3 -> 4^3 -> voxels, with occlusion culls between the
    stages (heightmaps of filled cells at each granularity,
    :func:`_render3d_impl`), or 64^3 -> 16^3 -> voxels (``skip4``, which
    the renderer picks from the counts it observed, :meth:`_skip4_decide`),
    then forward-mode normals one voxel in front of the depth
    (:func:`_normals_pass`).  Two options of the JAX package change the
    voxel stage and not the depth: ``two_phase`` (front to back, phase 2
    culled by phase 1's least depth a 4px column, :func:`_two_phase`)
    and ``refine2`` (the 2^3 children of each 4^3 cell classified first,
    :func:`_refine2`); ``debug_stage`` stops a frame after a stage
    (:func:`_render3d_impl`).

Each stage's ambiguous set is compacted with ``torch.nonzero``: its exact
count is read back to the host (one read a stage), and the next stage is
sized by it, so there are no static capacities, no observed-count cap
memory and no retry.  The boxes, classification, occlusion heightmaps,
index arithmetic, upsampling and scatters are plain PyTorch; the
evaluations are the generated kernels (two interval launches, one float
launch a 2D frame; two or three interval launches, one float, one deriv a
3D frame with normals).  On the card the voxel stage's glue, the voxels'
centers and their columns' top into the depth, is two hand-written
kernels around each float launch (csrc/voxel_glue.cu,
:func:`voxel_centers`, :func:`voxel_columns`); on the CPU it is their
plain versions.

The ladders also run on a slab of 64px tile rows ``[r0, r0 + rows)``
(``r0`` / ``rows64`` in 2D, ``r0`` / ``rows`` in 3D): tiles have no
cross-tile dependence, and 3D slabs keep whole z columns, so slabs
compose exactly.  ``parallel/sharded.py`` gives each rank of a process
group one (:meth:`UnrolledRenderer.render2d_sharded`,
:meth:`UnrolledRenderer.render3d_sharded`).  :func:`_soft_render2d_impl`
is the differentiable soft render of the culled fit: the interval stages
without gradient, widened by ``4 / sharpness``, and the soft pixels of
the ambiguous 8px tiles through the float evaluator, which on the card
differentiates in ``imms`` through kernel K1.

Depth: int32, 0 = empty, else the top filled voxel's index + 1.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import build
from ..ops import interval_math as im
from ..ops import transcendental as tc
from ..ops import unrolled_eval as ue
from ..ops.kernels import _check, _launch, _on_cuda, _stream
from ..ops.tape_data import resolve_device
from ..tape.tape import Tape
from ..utils.trace import count, read_ids, span
from . import camera
from .pipeline2d import _iv_mul_scalar
from .pipeline3d import _mat4_interval

ST_EMPTY, ST_FILLED, ST_AMBIG = 0, 1, 2
TILE = 64
# lanes one float launch of the voxel stage takes at most (a 4^3 cell is
# 64 lanes, a 16^3 cell 4096): bounds the stage's temporaries
VOXEL_LANES = 1 << 26


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _classify(lo, hi, delta: float = 0.0):
    """0 empty / 1 filled / 2 ambiguous; NaN bounds classify ambiguous.
    ``delta`` widens the test to |f| > delta (``lo - delta``, ``hi +
    delta``)."""
    if delta:
        lo, hi = lo - delta, hi + delta
    return torch.where(lo > 0.0, ST_EMPTY,
                       torch.where(hi < 0.0, ST_FILLED, ST_AMBIG))


def _axis_box(idx, ngrid: int):
    f = idx.to(torch.float32)
    return ((tc.div_scalar(f, ngrid) - 0.5) * 2.0,
            (tc.div_scalar(f + 1.0, ngrid) - 0.5) * 2.0)


def _center(idx, size: int):
    """Pixel or voxel centers: ``(i + 0.5) / size * 2 - 1`` (the brute
    renderers' order of operations)."""
    return tc.div_scalar(idx.to(torch.float32) + 0.5, size) * 2.0 - 1.0


def _mat3_interval(mat, xl, xh, yl, yh):
    """Interval 3x3 homogeneous transform (calculate_intervals_2d,
    reference/src/context.cu:122-159)."""
    def row(r):
        al, ah = _iv_mul_scalar(mat[r, 0], xl, xh)
        bl, bh = _iv_mul_scalar(mat[r, 1], yl, yh)
        return al + bl + mat[r, 2], ah + bh + mat[r, 2]
    wl, wh = row(2)
    txl, txh = row(0)
    tyl, tyh = row(1)
    txl, txh = im.i_div(torch, txl, txh, wl, wh)
    tyl, tyh = im.i_div(torch, tyl, tyh, wl, wh)
    return txl, txh, tyl, tyh


def _cell_boxes_3d(mat, gx, gy, gz, ngrid: int):
    xl, xh = _axis_box(gx, ngrid)
    yl, yh = _axis_box(gy, ngrid)
    zl, zh = _axis_box(gz, ngrid)
    return _mat4_interval(mat, xl, xh, yl, yh, zl, zh)


def _up(img, k: int):
    """Nearest upsampling of a 2-D image by ``k`` on both axes."""
    return img.repeat_interleave(k, 0).repeat_interleave(k, 1)


def _children_of_cells(gx, gy, gz):
    """Coordinates of the 64 children (lane c = (cz*4 + cy)*4 + cx) of
    cells (gx, gy, gz), in the grid 4x finer."""
    c = torch.arange(64, dtype=torch.int64, device=gx.device)
    return ((gx[:, None] * 4 + (c % 4)[None, :]).reshape(-1),
            (gy[:, None] * 4 + ((c // 4) % 4)[None, :]).reshape(-1),
            (gz[:, None] * 4 + (c // 16)[None, :]).reshape(-1))


# ---------------------------------------------------------------------------
# 2D ladder: 64px -> 8px -> pixel
# ---------------------------------------------------------------------------

def _stages2d(fi, mat, z, size: int, imms, delta: float = 0.0, r0: int = 0,
              rows64: Optional[int] = None):
    """The interval stages of the 2D ladder on the slab of 64px tile rows
    ``[r0, r0 + rows64)`` (default: the whole image): 64px
    classification, the ambiguous tiles' 64 8px children, their
    classification, each widened by ``delta`` (:func:`_classify`; the
    soft render's ``4 / sharpness``).  Returns (st64 (rows64*n64,), ids64,
    st8c (len(ids64)*64,), ids8, gx8, gy8) with ids into st64 and st8c,
    and gx8/gy8 the children's global 8px coordinates."""
    n64, n8 = size // 64, size // 8
    rows64 = n64 if rows64 is None else rows64
    dev = mat.device
    t = r0 * n64 + torch.arange(rows64 * n64, dtype=torch.int64, device=dev)
    xl, xh = _axis_box(t % n64, n64)
    yl, yh = _axis_box(t // n64, n64)
    bxl, bxh, byl, byh = _mat3_interval(mat, xl, xh, yl, yh)
    zc = z.expand_as(bxl)
    lo, hi = fi(bxl, bxh, byl, byh, zc, zc, imms=imms)
    st64 = _classify(lo, hi, delta)
    ids64 = read_ids(st64 == ST_AMBIG)

    c = torch.arange(64, dtype=torch.int64, device=dev)
    gx8 = ((ids64 % n64)[:, None] * 8 + (c % 8)[None, :]).reshape(-1)
    gy8 = ((ids64 // n64 + r0)[:, None] * 8 + (c // 8)[None, :]).reshape(-1)
    xl, xh = _axis_box(gx8, n8)
    yl, yh = _axis_box(gy8, n8)
    bxl, bxh, byl, byh = _mat3_interval(mat, xl, xh, yl, yh)
    zc = z.expand_as(bxl)
    lo, hi = fi(bxl, bxh, byl, byh, zc, zc, imms=imms)
    st8c = _classify(lo, hi, delta)
    ids8 = read_ids(st8c == ST_AMBIG)
    return st64, ids64, st8c, ids8, gx8, gy8


def _st8_image(st64, st8c, gx8, gy8, size: int, r0: int = 0):
    """Statuses at 8px granularity, (rows64*8, n8) for the slab at tile
    row ``r0``: parent statuses upsampled, the ambiguous parents' children
    their own (the copy_filled_2d upsample analog,
    reference/src/context.cu:664-692)."""
    n64 = size // 64
    st8 = _up(st64.reshape(-1, n64), 8)
    st8[gy8 - r0 * 8, gx8] = st8c
    return st8


def _ambiguous_pixels(gx8, gy8, ids8):
    """Global pixel coordinates of the 64 pixels of each ambiguous 8px
    tile."""
    p = torch.arange(64, dtype=torch.int64, device=gx8.device)
    return ((gx8[ids8][:, None] * 8 + (p % 8)[None, :]).reshape(-1),
            (gy8[ids8][:, None] * 8 + (p // 8)[None, :]).reshape(-1))


def _render2d_impl(fi, f, mat, z, size: int, imms=None, r0: int = 0,
                   rows64: Optional[int] = None):
    """The 2D ladder on the slab of 64px tile rows ``[r0, r0 + rows64)``
    (default: the whole image): (rows64*64, size) bool image (row = y)
    and the exact ambiguous counts (64px tiles, 8px tiles)."""
    st64, ids64, st8c, ids8, gx8, gy8 = _stages2d(fi, mat, z, size, imms,
                                                  r0=r0, rows64=rows64)
    gpx, gpy = _ambiguous_pixels(gx8, gy8, ids8)
    px, py = camera.transform2(mat, _center(gpx, size), _center(gpy, size))
    v = f(px, py, z.expand_as(px), imms=imms)
    img = _up(_st8_image(st64, st8c, gx8, gy8, size, r0) == ST_FILLED, 8)
    img[gpy - r0 * 64, gpx] = v < 0.0
    return img, (int(ids64.shape[0]), int(ids8.shape[0]))


def _soft_render2d_impl(fi, f, mat, z, size: int, sharpness: float, imms,
                        r0: int = 0, rows64: Optional[int] = None):
    """The differentiable soft render restricted to ambiguous tiles, on
    the slab of 64px tile rows ``[r0, r0 + rows64)``: the culled fit's
    forward (``mpr_tpu.render.unrolled._soft_render2d_impl``).

    The interval ladder is structure without gradient (``imms`` detached,
    the straight-through convention of the reference's Deriv, which
    treats min/max discontinuously, reference/inc/gpu_deriv.hpp:106-130);
    gradients flow through the soft pixels ``tanh(-sharpness * f) / 2 +
    1/2`` of the ambiguous 8px tiles and their scatter into the composed
    image.  Culling is sound for gradients because the classification is
    widened by ``4 / sharpness``: a culled tile has |f| > delta
    everywhere, so its pixels' tanh sits within tanh(4) ~ 1 - 2.5e-4 of
    saturation and their gradient is O(sech^2(4)) ~ 1.3e-3 of a boundary
    pixel's.  Culled tiles contribute their saturated constant (filled 1,
    empty 0).

    Every lane evaluated is a pixel of an ambiguous tile: the exact count
    read back sizes the launch.  (The JAX package pads to a cap and pins
    the lanes past its count at pixel (0, 0)'s centre, not at the
    origin, or tapes with hypot/sqrt, singular there, NaN-poison the
    gradient through the padding's zero cotangents; here there is no
    padding.)

    Returns ((rows64*64, size) f32 soft image, counts)."""
    delta = 4.0 / float(sharpness)
    with torch.no_grad():
        st64, ids64, st8c, ids8, gx8, gy8 = _stages2d(
            fi, mat, z, size, None if imms is None else imms.detach(),
            delta, r0, rows64)
        st8img = _st8_image(st64, st8c, gx8, gy8, size, r0)
        gpx, gpy = _ambiguous_pixels(gx8, gy8, ids8)
        px, py = camera.transform2(mat, _center(gpx, size),
                                   _center(gpy, size))
    v = f(px, py, z.expand_as(px), imms=imms)
    soft = torch.tanh(-sharpness * v) * 0.5 + 0.5
    base = _up((st8img == ST_FILLED).to(torch.float32), 8)
    img = base.index_put((gpy - r0 * 64, gpx), soft)
    return img, (int(ids64.shape[0]), int(ids8.shape[0]))


# ---------------------------------------------------------------------------
# 3D ladder: 64^3 -> 16^3 -> 4^3 -> voxel -> normals
# ---------------------------------------------------------------------------

class Stages3d(NamedTuple):
    """The interval stages of one 3D frame (:func:`_stages3d`).  Every
    ``cell*`` is the screen cell of its stage's lanes at that stage's
    granularity (row-major), every ``surv*`` its lanes that are ambiguous
    and not occluded, every ``h*`` the heightmap (voxel units) of the
    filled cells' tops down to that stage, and every ``c*`` the surviving
    cells' grid coordinates (gx, gy, gz).  The 4^3 fields are None under
    ``skip4``."""
    cell64: torch.Tensor
    surv0: torch.Tensor
    cell16: torch.Tensor
    surv1: torch.Tensor
    h16: torch.Tensor
    c16: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    cell4: Optional[torch.Tensor]
    surv2: Optional[torch.Tensor]
    h4: Optional[torch.Tensor]
    c4: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    counts: Tuple[int, int, int]       # survivors at 64^3, 16^3, 4^3


def _stages3d(fi, mat, size: int, skip4: bool, imms, r0: int = 0,
              rows: Optional[int] = None, stop: str = "") -> Stages3d:
    """The interval stages of the 3D ladder, 64^3 -> 16^3 (-> 4^3 unless
    ``skip4``), with the occlusion culls between them (the
    mask_filled_tiles analog, reference/src/context.cu:471-495), on the
    slab of screen tile rows ``[r0, r0 + rows)`` (default: the whole
    image; whole z columns, so the culls stay exact).  Screen cells are
    slab-local, cell coordinates global.  ``stop`` "A" or "B" returns
    after that stage with only its counts (every other field None)."""
    n = size // 64
    rows = n if rows is None else rows
    dev = mat.device
    i64 = torch.int64

    # ---- stage A: 64^3 tiles, t = (tz*rows + tyl)*n + tx -------------------
    with span("mpr.u3d.A"):
        t = torch.arange(n * rows * n, dtype=i64, device=dev)
        tx, tyl, tz = t % n, (t // n) % rows, t // (n * rows)
        lo, hi = fi(*_cell_boxes_3d(mat, tx, tyl + r0, tz, n), imms=imms)
        st0 = _classify(lo, hi)
        # heightmap (tyl, tx) of filled tiles' tops: (tz + 1) * 64
        h0 = torch.where((st0 == ST_FILLED).reshape(n, rows, n),
                         (torch.arange(n, dtype=i64, device=dev)
                          + 1)[:, None, None] * 64, 0).amax(dim=0)
        cell64 = tyl * n + tx
        surv0 = (st0 == ST_AMBIG) & ((tz + 1) * 64 > h0.reshape(-1)[cell64])
        ids0 = read_ids(surv0)
    if stop == "A":
        return Stages3d(*[None] * 10, counts=(int(ids0.shape[0]),))

    # ---- stage B: 16^3 children of the surviving tiles ---------------------
    with span("mpr.u3d.B"):
        g16x, g16y, g16z = _children_of_cells(
            ids0 % n, (ids0 // n) % rows + r0, ids0 // (n * rows))
        lo, hi = fi(*_cell_boxes_3d(mat, g16x, g16y, g16z, 4 * n),
                    imms=imms)
        st1 = _classify(lo, hi)
        top1 = (g16z + 1) * 16
        cell16 = (g16y - 4 * r0) * (4 * n) + g16x
        h16 = _up(h0, 4).reshape(-1).scatter_reduce(
            0, cell16, torch.where(st1 == ST_FILLED, top1, 0), "amax")
        surv1 = (st1 == ST_AMBIG) & (top1 > h16[cell16])
        ids1 = read_ids(surv1)
        c16 = (g16x[ids1], g16y[ids1], g16z[ids1])
    counts = (int(ids0.shape[0]), int(ids1.shape[0]))
    if stop == "B":
        return Stages3d(*[None] * 10, counts=counts)
    if skip4:
        return Stages3d(cell64, surv0, cell16, surv1, h16, c16, None, None,
                        None, None, counts + (0,))

    # ---- stage B': 4^3 children of the surviving 16^3 cells ----------------
    with span("mpr.u3d.Bp"):
        g4x, g4y, g4z = _children_of_cells(*c16)
        lo, hi = fi(*_cell_boxes_3d(mat, g4x, g4y, g4z, 16 * n), imms=imms)
        st2 = _classify(lo, hi)
        top2 = (g4z + 1) * 4
        cell4 = (g4y - 16 * r0) * (16 * n) + g4x
        h4 = _up(h16.reshape(4 * rows, 4 * n), 4).reshape(-1)
        h4 = h4.scatter_reduce(
            0, cell4, torch.where(st2 == ST_FILLED, top2, 0), "amax")
        surv2 = (st2 == ST_AMBIG) & (top2 > h4[cell4])
        ids2 = read_ids(surv2)
        return Stages3d(cell64, surv0, cell16, surv1, h16, c16, cell4,
                        surv2, h4, (g4x[ids2], g4y[ids2], g4z[ids2]),
                        counts + (int(ids2.shape[0]),))


# ---------------------------------------------------------------------------
# The voxel stage's glue: plain versions and their kernels
# (csrc/voxel_glue.cu), one on each side of the float launch
# ---------------------------------------------------------------------------

# the cell edges the glue kernels are built for (the ladder's 2, 4 and 16)
GLUE_KS = (2, 4, 16)


def voxel_centers_plain(mat, bx, by, bz, k: int, size: int):
    """World coordinates (wx, wy, wz) of every voxel of the ``k``^3 cells
    (bx, by, bz) (int64, in the grid of ``k``-voxel cells), lane ``c*k^3
    + (vz*k + vy)*k + vx``: the centers gathered from a table of the
    ``size`` values :func:`_center` gives, then :func:`camera.transform3`
    by ``mat``."""
    vv = torch.arange(k ** 3, dtype=torch.int64, device=bx.device)
    cen = _center(torch.arange(size, device=bx.device), size)
    return camera.transform3(mat, *(
        cen[(g[:, None] * k + off[None, :]).reshape(-1)]
        for g, off in ((bx, vv % k), (by, (vv // k) % k),
                       (bz, vv // (k * k)))))


def voxel_columns_plain(val, bx, by, bz, k: int, size: int, depth,
                        r0: int = 0):
    """``depth`` (int64, the slab of 64px tile rows from ``r0``, ``size``
    pixels a row) with the top filled voxel of each (cell, vy, vx) column
    of ``val`` (the values on :func:`voxel_centers_plain`'s lanes; below 0
    is filled, NaN is not), ``cz*k + vz + 1``, max-reduced in: a new
    tensor."""
    dev = val.device
    vz = torch.arange(k, dtype=torch.int64, device=dev)
    top = torch.where(val.reshape(-1, k, k * k) < 0.0,
                      (bz[:, None] * k + vz + 1)[:, :, None], 0).amax(dim=1)
    c = torch.arange(k * k, dtype=torch.int64, device=dev)
    pix = ((by[:, None] * k + c // k - 64 * r0) * size
           + bx[:, None] * k + c % k)
    return depth.scatter_reduce(0, pix.reshape(-1), top.reshape(-1), "amax")


def _check_cells(bx, by, bz, k: int) -> int:
    if k not in GLUE_KS:
        raise ValueError(f"k {k}: the voxel glue kernels take {GLUE_KS}")
    for name, g in (("bx", bx), ("by", by), ("bz", bz)):
        _check(g, name, torch.int64, (bx.shape[0],))
    return int(bx.shape[0])


def voxel_centers(mat, bx, by, bz, k: int, size: int):
    """:func:`voxel_centers_plain` on CUDA tensors as the centers kernel
    (``mat`` (4, 4) f32 read on the device), equal bit for bit; the plain
    version for CPU tensors.  ``voxel_centers.launches`` counts the
    launches."""
    if not _on_cuda(mat, bx, by, bz):
        return voxel_centers_plain(mat, bx, by, bz, k, size)
    cells = _check_cells(bx, by, bz, k)
    _check(mat, "mat", torch.float32, (4, 4))
    out = [torch.empty(cells * k ** 3, dtype=torch.float32, device=bx.device)
           for _ in range(3)]
    if cells:
        with torch.cuda.device(bx.device):
            _launch(build.lib().mpr_voxel_glue, mat.data_ptr(),
                    bx.data_ptr(), by.data_ptr(), bz.data_ptr(),
                    *(w.data_ptr() for w in out), cells, k, size, _stream())
        _voxel_centers.launches += 1
    return tuple(out)


voxel_centers.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_voxel_centers = voxel_centers


def voxel_columns(val, bx, by, bz, k: int, size: int, depth, r0: int = 0):
    """:func:`voxel_columns_plain` on CUDA tensors as the columns kernel,
    which updates ``depth`` in place (a 64-bit atomic max a filled column)
    and returns it, equal bit for bit; the plain version for CPU tensors.
    ``voxel_columns.launches`` counts the launches."""
    if not _on_cuda(val, bx, by, bz, depth):
        return voxel_columns_plain(val, bx, by, bz, k, size, depth, r0)
    cells = _check_cells(bx, by, bz, k)
    _check(val, "val", torch.float32, (cells * k ** 3,))
    _check(depth, "depth", torch.int64, (depth.shape[0],))
    if cells:
        with torch.cuda.device(val.device):
            _launch(build.lib().mpr_voxel_glue_columns, val.data_ptr(),
                    bx.data_ptr(), by.data_ptr(), bz.data_ptr(),
                    depth.data_ptr(), cells, k, int(depth.shape[0]), size,
                    r0, _stream())
        _voxel_columns.launches += 1
    return depth


voxel_columns.launches = 0
_voxel_columns = voxel_columns


def voxel_launches(cells: int, k: int) -> int:
    """Float launches of the voxel stage over ``cells`` cells of ``k``^3
    voxels (:func:`_voxel_stage`); with ``k = 2`` also the interval
    launches of the 2^3 children of ``cells`` 4^3 cells
    (:func:`_refine2`)."""
    step = max(1, VOXEL_LANES // k ** 3)
    return -(-cells // step)


def _voxel_stage(f, mat, cells, k: int, size: int, depth, imms, r0: int = 0,
                 first_only: bool = False):
    """The voxel stage: every voxel of the ``k``^3 cells ``cells`` (gx,
    gy, gz in the grid of ``k``-voxel cells), a chunk of at most
    VOXEL_LANES lanes at a time (the first chunk alone under
    ``first_only``): the centers (:func:`voxel_centers`), a float launch,
    and the top filled voxel of each column max-reduced into ``depth``
    (rows*64*size, int64: the slab at tile row ``r0``;
    :func:`voxel_columns`).  On the card the glue is two kernels, counted
    in ``COUNTS["voxel.kernels"]`` a chunk, and ``depth`` is updated in
    place.  Returns the depth."""
    with span("mpr.u3d.voxel"):
        step = max(1, VOXEL_LANES // k ** 3)
        on_card = depth.device.type == "cuda"
        for c0 in range(0, int(cells[0].shape[0]), step):
            bx, by, bz = (g[c0:c0 + step] for g in cells)
            val = f(*voxel_centers(mat, bx, by, bz, k, size), imms=imms)
            depth = voxel_columns(val, bx, by, bz, k, size, depth, r0)
            if on_card:
                count("voxel.kernels")
            if first_only:
                break
        return depth


def _take(cells, ids):
    return tuple(g[ids] for g in cells)


def _two_phase(f, mat, s: Stages3d, size: int, depth, imms, r0: int,
               rows: int, stop: str):
    """The two-phase voxel stage over the surviving 4^3 cells ``s.c4``,
    front to back, onto ``depth`` (the filled cells' heightmap, a pixel
    each).  Phase 1 evaluates each 4px column's top surviving cell.
    Phase 2 evaluates the others, but for the cells whose top lies at or
    behind the least depth phase 1 left in their column: every pixel of
    such a cell's column already has a depth no voxel of the cell can
    raise.  (The column's maximum would drop geometry where phase 1
    covered the column in part; the minimum is the exact test.)  Returns
    (depth, or None at ``stop`` "Bp" or "V", counts (n0, n1, n2, na[,
    nb]))."""
    n = size // 64
    gx, gy, gz = s.c4
    col = (gy - 16 * r0) * (16 * n) + gx
    top = torch.zeros(256 * rows * n, dtype=torch.int64,
                      device=gx.device).scatter_reduce(0, col, gz + 1,
                                                       "amax")
    is_top = gz + 1 == top[col]
    ida = read_ids(is_top)
    counts = s.counts + (int(ida.shape[0]),)
    if stop == "Bp":
        return None, counts
    depth = _voxel_stage(f, mat, _take(s.c4, ida), 4, size, depth, imms, r0)
    if stop == "V":
        return None, counts
    least = depth.reshape(16 * rows, 4, 16 * n, 4).amin(dim=(1, 3))
    idb = read_ids(~is_top & ((gz + 1) * 4 > least.reshape(-1)[col]))
    depth = _voxel_stage(f, mat, _take(s.c4, idb), 4, size, depth, imms, r0)
    return depth, counts + (int(idb.shape[0]),)


def _refine2(fi, f, mat, s: Stages3d, size: int, depth, imms, r0: int,
             rows: int, stop: str):
    """The 2^3 sub-refinement of the surviving 4^3 cells ``s.c4``: their
    eight 2^3 children interval-classified (on the grid of 32n cells, an
    interval launch for each chunk of at most VOXEL_LANES children), each
    filled child's top, ``(g2z + 1) * 2``, composed over its 2x2 pixels,
    and the 8 voxels of each ambiguous child evaluated (:func:`_voxel_stage`
    with ``k = 2``) onto ``depth``.  No child is culled against the
    heightmap, as in the JAX package.  Returns (depth, or None at
    ``stop`` "Bp", "R" or "V", counts (n0, n1, n2[, m3, 0]))."""
    if stop == "Bp":
        return None, s.counts
    n = size // 64
    with span("mpr.u3d.R"):
        kk = torch.arange(8, dtype=torch.int64, device=depth.device)
        kx, ky, kz = kk % 2, (kk // 2) % 2, kk // 4
        top2 = torch.zeros(1024 * rows * n, dtype=torch.int64,
                           device=depth.device)
        amb = []
        step = max(1, VOXEL_LANES // 8)
        for c0 in range(0, int(s.c4[0].shape[0]), step):
            bx, by, bz = (g[c0:c0 + step] for g in s.c4)
            g2x = (bx[:, None] * 2 + kx[None, :]).reshape(-1)
            g2y = (by[:, None] * 2 + ky[None, :]).reshape(-1)
            g2z = (bz[:, None] * 2 + kz[None, :]).reshape(-1)
            lo, hi = fi(*_cell_boxes_3d(mat, g2x, g2y, g2z, 32 * n),
                        imms=imms)
            st3 = _classify(lo, hi)
            top2 = top2.scatter_reduce(
                0, (g2y - 32 * r0) * (32 * n) + g2x,
                torch.where(st3 == ST_FILLED, (g2z + 1) * 2, 0), "amax")
            amb.append(_take((g2x, g2y, g2z), read_ids(st3 == ST_AMBIG)))
        if amb:
            amb = tuple(torch.cat(g) for g in zip(*amb))
        else:
            amb = tuple(torch.zeros(0, dtype=torch.int64,
                                    device=depth.device) for _ in range(3))
    counts = s.counts + (int(amb[0].shape[0]), 0)
    if stop == "R":
        return None, counts
    depth = _voxel_stage(f, mat, amb, 2, size, depth, imms, r0,
                         first_only=stop == "V")
    if stop == "V":
        return None, counts
    depth = torch.maximum(depth, _up(top2.reshape(32 * rows, 32 * n),
                                     2).reshape(-1))
    return depth, counts


# the stops of _render3d_impl's ``debug_stage``, in ladder order
STOPS = ("A", "B", "Bp", "R", "V")


def _render3d_impl(fi, f, fd, mat, size: int, with_normals: bool,
                   skip4: bool = False, imms=None, r0: int = 0,
                   rows: Optional[int] = None, two_phase: bool = False,
                   refine2: bool = False, debug_stage: str = ""):
    """The 3D ladder on the slab of screen tile rows ``[r0, r0 + rows)``
    (default: the whole image): :func:`_stages3d`, then the voxel stage
    over the heightmap of the filled cells.  The voxel stage takes, in
    this precedence: under ``skip4`` the voxels of the surviving 16^3
    cells (interval-hostile models spend more on the 4^3 stage than it
    saves); with ``two_phase`` the surviving 4^3 cells in two phases
    (:func:`_two_phase`); with ``refine2`` their 2^3 children
    (:func:`_refine2`); else every surviving 4^3 cell's voxels at once.

    Returns (depth (rows*64, size) int32, normals (rows*64, size, 3) f32
    or None, counts (n0, n1, n2, a, b, nN)): surviving 64^3 tiles, 16^3
    cells and 4^3 cells (0 under ``skip4``); (a, b) = (na, nb), the cells
    of phase 1 and phase 2, under ``two_phase`` (phase 2 culled n2 - na -
    nb), (m3, 0), the ambiguous 2^3 children, under ``refine2``, else (0,
    0); and nN the screen tiles with content.

    ``debug_stage`` (one of STOPS) returns (None, None, counts) early, so
    that a script can time a prefix of the ladder: after stage "A" (64^3),
    "B" (16^3), "Bp" (the compaction before the voxels: phase 1's under
    ``two_phase``), "R" (the children's classification, ``refine2``
    only) or "V" (the voxel stage's first float launch; phase 1 under
    ``two_phase``).  Its counts are the counts so far, real counts, with
    0 in the slots of the stages not reached."""
    if debug_stage and (debug_stage not in STOPS
                        or (debug_stage == "Bp" and skip4)
                        or (debug_stage == "R"
                            and (skip4 or two_phase or not refine2))):
        raise ValueError(f"debug_stage {debug_stage!r}: not a stop of this "
                         "ladder")
    n = size // 64
    rows = n if rows is None else rows
    s = _stages3d(fi, mat, size, skip4, imms, r0, rows, debug_stage)
    counts = s.counts
    if debug_stage in ("A", "B"):
        depth = None
    elif skip4:
        depth = _voxel_stage(f, mat, s.c16, 16, size, _up(
            s.h16.reshape(4 * rows, 4 * n), 16).reshape(-1), imms, r0,
            first_only=debug_stage == "V")
    else:
        depth = _up(s.h4.reshape(16 * rows, 16 * n), 4).reshape(-1)
        if two_phase:
            depth, counts = _two_phase(f, mat, s, size, depth, imms, r0,
                                       rows, debug_stage)
        elif refine2:
            depth, counts = _refine2(fi, f, mat, s, size, depth, imms, r0,
                                     rows, debug_stage)
        elif debug_stage != "Bp":
            depth = _voxel_stage(f, mat, s.c4, 4, size, depth, imms, r0,
                                 first_only=debug_stage == "V")
    counts = list(counts) + [0] * (6 - len(counts))
    if debug_stage:
        return None, None, tuple(counts)
    depth = depth.reshape(rows * 64, size).to(torch.int32)
    if not with_normals:
        return depth, None, tuple(counts)
    normals, counts[5] = _normals_pass(fd, mat, depth, size, imms, r0)
    return depth, normals, tuple(counts)


def _normals_pass(fd, mat, depth, size: int, imms, r0: int = 0):
    """Normals: forward-mode derivatives one voxel in front of the surface
    (eval_pixels_d, reference/src/context.cu:978-1132), on every pixel of
    the 64px screen tiles with content, of the depth slab at tile row
    ``r0``.  Returns ((rows*64, size, 3) f32, count of those tiles)."""
    n = size // 64
    rows = depth.shape[0] // TILE
    dev = depth.device
    with span("mpr.u3d.normals"):
        blocks = depth.reshape(rows, TILE, n, TILE).permute(
            0, 2, 1, 3).reshape(rows * n, TILE * TILE)
        idsN = read_ids(blocks.amax(dim=1) > 0)
        pp = torch.arange(TILE * TILE, dtype=torch.int64, device=dev)
        gpx = ((idsN % n)[:, None] * TILE + (pp % TILE)[None, :]).reshape(-1)
        gpy = ((idsN // n)[:, None] * TILE
               + (pp // TILE)[None, :]).reshape(-1)
        d = blocks[idsN].reshape(-1)
        zi = torch.clamp_max(d, size - 1)
        wx, wy, wz = camera.transform3(mat, _center(gpx, size),
                                       _center(gpy + TILE * r0, size),
                                       _center(zi, size))
        _, dx, dy, dz = fd(wx, wy, wz, imms=imms)
        norm = tc.sqrt(dx * dx + dy * dy + dz * dz)
        inv = torch.where(d > 0,
                          torch.div(1.0, torch.clamp_min(norm, 1e-12)), 0.0)
        img = torch.zeros(rows * TILE, size, 3, dtype=torch.float32,
                          device=dev)
        img[gpy, gpx] = torch.stack([dx * inv, dy * inv, dz * inv], dim=-1)
        return img, int(idsN.shape[0])


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------

def tape_key(tape: Tape, imm_inputs: bool = False) -> str:
    """A renderer's key: its evaluators' (``unrolled_eval.structure_key``:
    the clauses, the immediates unless ``imm_inputs``, the config flags
    the evaluators latch when they are built), so two tapes that differ
    only in constants share an imm-input renderer."""
    return ue.structure_key(tape, imm_inputs, ue._flags())


class UnrolledRenderer:
    """The three evaluators of one tape and the frame loops over them.

    ``imm_inputs=True`` builds kernels that read the immediates from a
    pointer: they are keyed by the tape's structure only, so an edit of
    constants (a slider, ``cli --set``, a fit step) builds nothing.  The
    kernels build at the first frame on a card, all of a frame's
    semantics in parallel nvcc processes.  The renderer keeps the last
    counts of each frame kind, which the 3D ``skip4`` decision reads.

    ``two_phase`` (default False, as in the JAX package) runs the 3D
    frames' voxel stage front to back in two phases (:func:`_two_phase`)
    wherever the 4^3 stage runs; the depth is the same either way."""

    def __init__(self, tape: Tape, imm_inputs: bool = False):
        self.tape = tape
        self.imm_inputs = bool(imm_inputs)
        self._key = tape_key(tape, self.imm_inputs)
        self.f = ue.build_float(tape, take_imms=self.imm_inputs)
        self.fi = ue.build_interval(tape, take_imms=self.imm_inputs)
        self.fd = ue.build_deriv(tape, take_imms=self.imm_inputs)
        self._imms_t: Dict[str, torch.Tensor] = {}
        self._obs: Dict = {}
        self._skip4_age: Dict = {}
        self.two_phase = False

    def _ready(self, dev, evals):
        if dev.type == "cuda":
            ue.build_all(evals)

    def _imms_arg(self, imms, dev):
        """A frame's immediates: the override, else the tape's own (a
        tensor on ``dev``, kept); None for baked kernels."""
        if imms is not None:
            if not self.imm_inputs:
                raise ValueError("imms overrides need imm_inputs=True "
                                 "(get_renderer(tape, imm_inputs=True))")
            return torch.as_tensor(imms, dtype=torch.float32, device=dev)
        if not self.imm_inputs:
            return None
        t = self._imms_t.get(str(dev))
        if t is None:
            t = self._imms_t[str(dev)] = torch.as_tensor(
                np.asarray(self.tape.imms, np.float32), device=dev)
        return t

    # -- 2D ------------------------------------------------------------------

    def frame2d(self, mat, z, size: int, imms=None):
        """One 2D frame on tensors: ``mat`` (3, 3) and ``z`` (0-d) f32 on
        the device.  Returns ((size, size) bool image, counts)."""
        dev = mat.device
        self._ready(dev, [self.fi, self.f])
        img, counts = _render2d_impl(self.fi, self.f, mat, z, size,
                                     self._imms_arg(imms, dev))
        self._obs[("2d", size)] = counts
        return img, counts

    def render2d(self, mat=None, z: float = 0.0, size: int = 256,
                 imms=None, device=None) -> np.ndarray:
        dev = resolve_device(device)
        mat = camera.identity2() if mat is None else np.asarray(
            mat, np.float32)
        img, _ = self.frame2d(torch.as_tensor(mat, device=dev),
                              torch.tensor(z, dtype=torch.float32,
                                           device=dev), size, imms)
        return img.cpu().numpy()

    # -- 3D ------------------------------------------------------------------

    def _skip4(self, size: int) -> bool:
        return self._skip4_key(("3d", size))

    def _skip4_key(self, key) -> bool:
        """Skip the 4^3 interval stage when the last counts say it loses:
        4^3 cells over 16^3 cells above ``10 + clauses/60`` (the JAX
        package's rule, fitted to its measured break-evens)."""
        obs = self._obs.get(key)
        if obs is None:
            return False
        thr = 10.0 + self.tape.length / 60.0
        return obs[2] > thr * max(obs[1], 1)

    def _skip4_decide(self, key) -> bool:
        """The frame loop's skip4 decision: :meth:`_skip4_key`, and the
        full ladder every 64th frame while skipping (the 4^3 count
        freezes while that stage does not run)."""
        if not self._skip4_key(key):
            self._skip4_age[key] = 0
            return False
        age = self._skip4_age.get(key, 0)
        if age >= 64:
            self._skip4_age[key] = 0
            return False
        self._skip4_age[key] = age + 1
        return True

    def _record3d(self, key, cnt, skip4: bool, two: bool,
                  with_normals: bool) -> None:
        """Keep a 3D frame's counts; a stage that did not run keeps the
        count it had (the 4^3 cells under ``skip4``, the two phases'
        cells when they did not run, the normals' tiles without
        normals)."""
        prev = self._obs.get(key)
        if prev is None or len(prev) != 6:
            prev = (0, 0, 0, 0, 0, 1)
        a = list(cnt)
        if skip4:
            a[2] = prev[2]
        if not two:
            a[3], a[4] = prev[3], prev[4]
        a[5] = max(a[5] if with_normals else prev[5], 1)
        self._obs[key] = tuple(a)

    def frame3d(self, mat, size: int, with_normals: bool = True,
                imms=None, skip4=None, two_phase=None):
        """One 3D frame on tensors: ``mat`` (4, 4) f32 on the device.
        ``skip4``: None for the renderer's decision; ``two_phase``: None
        for the renderer's ``two_phase`` (it applies where skip4 does
        not).  Returns (depth, normals or None, counts) as tensors and a
        tuple."""
        dev = mat.device
        key = ("3d", size)
        if skip4 is None:
            skip4 = self._skip4_decide(key)
        two = (self.two_phase if two_phase is None else two_phase) \
            and not skip4
        with span("mpr.u3d.ready"):
            self._ready(dev, [self.fi, self.f] + ([self.fd] if with_normals
                                                  else []))
        depth, normals, cnt = _render3d_impl(
            self.fi, self.f, self.fd, mat, size, with_normals, skip4,
            self._imms_arg(imms, dev), two_phase=two)
        self._record3d(key, cnt, skip4, two, with_normals)
        return depth, normals, cnt

    def render3d(self, mat=None, size: int = 256, with_normals: bool = True,
                 imms=None, device=None, skip4=None):
        dev = resolve_device(device)
        mat = camera.identity3() if mat is None else np.asarray(
            mat, np.float32)
        depth, normals, _ = self.frame3d(torch.as_tensor(mat, device=dev),
                                         size, with_normals, imms, skip4)
        return (depth.cpu().numpy(),
                None if normals is None else normals.cpu().numpy())

    # -- sharded over a process group (parallel/sharded.py) ----------------

    def render2d_sharded(self, mat=None, z: float = 0.0, size: int = 256,
                         mesh=None, imms=None, device=None) -> np.ndarray:
        """:meth:`render2d` with each rank of ``mesh`` (default: the
        default process group, or one process) rendering a slab of 64px
        tile rows; every rank returns the whole image, equal to the
        one-device render."""
        from ..parallel.sharded import _all_gather, make_mesh
        mesh = make_mesh() if mesh is None else mesh
        n64 = size // 64
        if n64 % mesh.size:
            raise ValueError(f"size {size}: {mesh.size} ranks must divide "
                             f"{n64} tile rows")
        rows = n64 // mesh.size
        dev = resolve_device(device)
        mat = camera.identity2() if mat is None else np.asarray(
            mat, np.float32)
        self._ready(dev, [self.fi, self.f])
        img, _ = _render2d_impl(
            self.fi, self.f, torch.as_tensor(mat, device=dev),
            torch.tensor(z, dtype=torch.float32, device=dev), size,
            self._imms_arg(imms, dev), mesh.rank * rows, rows)
        return torch.cat(_all_gather(mesh, img.to(torch.uint8)),
                         0).bool().cpu().numpy()

    def render3d_sharded(self, mat=None, size: int = 256, mesh=None,
                         with_normals: bool = True, imms=None, device=None,
                         skip4=None):
        """:meth:`render3d` with each rank of ``mesh`` rendering a slab of
        64px tile rows (whole z columns, so the occlusion culls and the
        two phases' culls stay exact); every rank returns the whole
        (depth, normals or None).  The skip4 decision reads the most any
        rank counted."""
        import torch.distributed as dist

        from ..parallel.sharded import _all_gather, _all_reduce, make_mesh
        mesh = make_mesh() if mesh is None else mesh
        n = size // 64
        if n % mesh.size:
            raise ValueError(f"size {size}: {mesh.size} ranks must divide "
                             f"{n} tile rows")
        rows = n // mesh.size
        dev = resolve_device(device)
        mat = camera.identity3() if mat is None else np.asarray(
            mat, np.float32)
        key = ("3ds", size, mesh.size)
        if skip4 is None:
            skip4 = self._skip4_decide(key)
        two = self.two_phase and not skip4
        with span("mpr.u3d.ready"):
            self._ready(dev, [self.fi, self.f] + ([self.fd] if with_normals
                                                  else []))
        depth, normals, cnt = _render3d_impl(
            self.fi, self.f, self.fd, torch.as_tensor(mat, device=dev),
            size, with_normals, skip4, self._imms_arg(imms, dev),
            mesh.rank * rows, rows, two_phase=two)
        cnt = _all_reduce(mesh, torch.tensor(cnt, device=dev),
                          dist.ReduceOp.MAX).tolist()
        self._record3d(key, cnt, skip4, two, with_normals)
        depth = torch.cat(_all_gather(mesh, depth), 0).cpu().numpy()
        if not with_normals:
            return depth, None
        return depth, torch.cat(_all_gather(mesh, normals), 0).cpu().numpy()

    def steady_frame3d(self, mat, size: int, with_normals: bool = True,
                       device=None):
        """Benchmark helper: render once (so the counts the skip4
        decision reads exist), then return ``frame(mat) -> (depth,
        normals)`` on tensors with that decision and ``two_phase``
        frozen — the closure the 3D tables time."""
        dev = resolve_device(device)
        mat_t = torch.as_tensor(np.asarray(mat, np.float32), device=dev)
        two = self.two_phase
        self.frame3d(mat_t, size, with_normals, two_phase=two)
        skip4 = self._skip4_key(("3d", size))

        def frame(m):
            d, nrm, _ = self.frame3d(m, size, with_normals, skip4=skip4,
                                     two_phase=two)
            return d, nrm
        return frame


_RENDERERS: Dict[str, UnrolledRenderer] = {}


def get_renderer(tape: Tape, imm_inputs: bool = False) -> UnrolledRenderer:
    """The renderer of ``tape``, made once per key (:func:`tape_key`).  An
    imm-input renderer found under its structural key adopts the caller's
    tape, whose immediates become its default."""
    key = tape_key(tape, imm_inputs)
    r = _RENDERERS.get(key)
    if r is None:
        r = _RENDERERS[key] = UnrolledRenderer(tape, imm_inputs)
    elif imm_inputs:
        r.tape = tape
        r._imms_t = {}
    return r


def render2d(tape: Tape, mat=None, z: float = 0.0, size: int = 256,
             device=None) -> np.ndarray:
    """Unrolled-engine 2D render; the contract of pipeline2d.render2d.
    Tapes with named parameters (frontend var()) get imm-input
    renderers."""
    return get_renderer(tape, imm_inputs=bool(tape.params)).render2d(
        mat, z, size, device=device)


def render3d(tape: Tape, mat=None, size: int = 256,
             with_normals: bool = True, device=None):
    """Unrolled-engine 3D render; the contract of pipeline3d.render3d."""
    return get_renderer(tape, imm_inputs=bool(tape.params)).render3d(
        mat, size, with_normals, device=device)
