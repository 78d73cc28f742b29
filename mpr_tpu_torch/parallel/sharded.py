"""Sharded rendering and fitting over a ``torch.distributed`` process group.

Counterpart of ``mpr_tpu.parallel.sharded``.  The JAX package shards over
a ``(dp, sp)`` device mesh with ``shard_map``; here a process group takes
its place: each rank is one process with one device (a card, or the CPU
under ``gloo``), and :class:`Mesh` lays the group's ranks out as the same
``(dp, sp)`` grid (:func:`_factor2`), rank ``r`` at ``(r // sp, r % sp)``.
No group (the default) is a mesh of one: world size 1, no collective.

  * Renders: 2D tiles have no cross-tile dependence, so each rank renders
    its own block of 64px tiles (interpreter) or slab of tile rows
    (unrolled engine) with the full culling pipeline; 3D slabs keep whole
    z columns, so occlusion culling stays exact.  The blocks come back
    with one ``all_gather``, and the image equals the one-device image.
  * Fit steps: each rank computes the loss and d(loss)/d(imms) on its
    block of pixels (or rows of voxels), one ``all_reduce(SUM)`` adds
    both, and both are divided as the JAX package divides its ``psum``
    (by the image's pixels).  The parameters are the tape's immediates:
    replicated, updated by plain gradient descent (``lr``), optionally
    masked (``grad_mask``: 1 for the immediates to fit).  The gradients
    run on the port's backward kernels on a card: K2 for
    :func:`make_fit_step` (the interpreter, ``ops/eval_scan.py``), K1 for
    the other four (the unrolled float evaluator, ``ops/unrolled_eval.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import eval_scan
from ..ops import transcendental as tc
from ..ops.tape_data import TapeData, resolve_device
from ..render import camera
from ..render.pipeline2d import TILE, render_tile_block
from ..tape.tape import Tape
from ..utils.trace import span, upload


def _factor2(n: int) -> Tuple[int, int]:
    """Split n ranks into a (dp, sp) grid, dp >= sp, dp divisible by sp
    when possible (so a dp-sided tile grid shards evenly both ways)."""
    sp = 1
    for c in range(int(math.isqrt(n)), 0, -1):
        if n % c == 0 and (n // c) % c == 0:
            sp = c
            break
    return n // sp, sp


@dataclass(frozen=True)
class Mesh:
    """A process group as a ``(dp, sp)`` grid: ``dp`` shards tile rows,
    ``sp`` tile columns; ``group`` None is the default group (or, before
    any ``init_process_group``, a single process)."""
    group: object
    size: int
    rank: int
    dp: int
    sp: int

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def make_mesh(group=None) -> Mesh:
    """The mesh over every rank of ``group`` (default: the default group;
    one process when no group is initialised)."""
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size(group)
        rank = dist.get_rank(group)
    else:
        size, rank = 1, 0
    dp, sp = _factor2(size)
    return Mesh(group, size, rank, dp, sp)


def _grouped(mesh: Mesh) -> bool:
    """Whether the mesh's collectives run: across ranks, and on a group of
    one too (the collective then runs on one rank)."""
    return mesh.size > 1 or (dist.is_available() and dist.is_initialized())


def _all_reduce(mesh: Mesh, t: torch.Tensor, op=None) -> torch.Tensor:
    if _grouped(mesh):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=mesh.group)
    return t


def _all_gather(mesh: Mesh, t: torch.Tensor):
    """Every rank's ``t`` (all of one shape), in rank order."""
    t = t.contiguous()
    if not _grouped(mesh):
        return [t]
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def _reduce_step(mesh: Mesh, loss, grad, n_px: int):
    """Sum the ranks' loss and gradient (one collective) and divide both
    by the image's ``n_px`` pixels."""
    both = torch.cat([loss.detach().reshape(1), grad.detach()])
    both = _all_reduce(mesh, both) / float(n_px)
    return both[0], both[1:]


def _mask(grad_mask, dev):
    return None if grad_mask is None else upload(
        np.asarray(grad_mask, np.float32), dev)


def _apply(imms, grad, mask, lr: float):
    """One gradient-descent step; the mask (as long as the tape, or as
    the immediates) zero past its end."""
    if mask is not None:
        full = torch.zeros_like(grad)
        full[:mask.shape[0]] = mask[:grad.shape[0]]
        grad = grad * full
    return imms.detach() - lr * grad


# ---------------------------------------------------------------------------
# Sharded renders
# ---------------------------------------------------------------------------

def render2d_sharded(tape: Tape, mat=None, z: float = 0.0, size: int = 256,
                     mesh: Optional[Mesh] = None, device=None) -> np.ndarray:
    """The interpreter's 2D render (``pipeline2d.render2d``) with each rank
    rendering its own block of 64px tiles with the full culling pipeline;
    every rank returns the whole image."""
    mesh = make_mesh() if mesh is None else mesh
    n_side = size // TILE
    if n_side % mesh.dp or n_side % mesh.sp:
        raise ValueError(f"size {size}: mesh ({mesh.dp}, {mesh.sp}) must "
                         f"divide {n_side} tiles a side")
    rows, cols = n_side // mesh.dp, n_side // mesh.sp
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity2() if mat is None else np.asarray(mat, np.float32)
    img, _ = render_tile_block(td, torch.as_tensor(mat, device=dev),
                               torch.tensor(z, dtype=torch.float32,
                                            device=dev), size,
                               mesh.dp_index * rows, rows,
                               mesh.sp_index * cols, cols)
    parts = _all_gather(mesh, img.to(torch.uint8))
    full = torch.cat([torch.cat(parts[r * mesh.sp:(r + 1) * mesh.sp], 1)
                      for r in range(mesh.dp)], 0)
    return full.bool().cpu().numpy()


def render3d_sharded(tape: Tape, mat=None, size: int = 256,
                     mesh: Optional[Mesh] = None, with_normals: bool = True,
                     device=None):
    """The interpreter's 3D render (``pipeline3d.render3d``) with each rank
    rendering a slab of screen tile rows (whole z columns); every rank
    returns the whole (depth, normals or None)."""
    from ..render.pipeline3d import render3d_rows
    mesh = make_mesh() if mesh is None else mesh
    n_side = size // TILE
    if n_side % mesh.size:
        raise ValueError(f"size {size}: {mesh.size} ranks must divide "
                         f"{n_side} tile rows")
    rows = n_side // mesh.size
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity3() if mat is None else np.asarray(mat, np.float32)
    depth, normals, _ = render3d_rows(td, torch.as_tensor(mat, device=dev),
                                      size, mesh.rank * rows, rows,
                                      with_normals)
    depth = torch.cat(_all_gather(mesh, depth), 0).cpu().numpy()
    if not with_normals:
        return depth, None
    return depth, torch.cat(_all_gather(mesh, normals), 0).cpu().numpy()


def render2d_sharded_unrolled(tape: Tape, mat=None, z: float = 0.0,
                              size: int = 256, mesh: Optional[Mesh] = None,
                              device=None) -> np.ndarray:
    """The unrolled engine's 2D render, a slab of 64px tile rows a rank
    (``render.unrolled.UnrolledRenderer.render2d_sharded``)."""
    from ..render import unrolled
    return unrolled.get_renderer(tape).render2d_sharded(
        mat, z, size, mesh, device=device)


def render3d_sharded_unrolled(tape: Tape, mat=None, size: int = 256,
                              mesh: Optional[Mesh] = None,
                              with_normals: bool = True, device=None):
    """The unrolled engine's 3D render, a slab of 64px tile rows a rank
    (``render.unrolled.UnrolledRenderer.render3d_sharded``)."""
    from ..render import unrolled
    return unrolled.get_renderer(tape).render3d_sharded(
        mat, size, mesh, with_normals, device=device)


# ---------------------------------------------------------------------------
# Sharded differentiable fitting (the "training step")
# ---------------------------------------------------------------------------

def _block_coords(size: int, rows: int, cols: int, mat, z, i0: int,
                  j0: int):
    """Pixel-centre coordinates of the (rows, cols) pixel block at pixel
    (i0, j0)."""
    dev = mat.device
    py = (i0 + torch.arange(rows, dtype=torch.float32, device=dev))[:, None]
    px = (j0 + torch.arange(cols, dtype=torch.float32, device=dev))[None, :]
    fy = (tc.div_scalar(py + 0.5, size) - 0.5) * 2.0
    fx = (tc.div_scalar(px + 0.5, size) - 0.5) * 2.0
    x, y = camera.transform2(mat, fx, fy)
    x = x.expand(rows, cols)
    y = y.expand(rows, cols)
    return x, y, z.expand(rows, cols)


def _soft_fill(v, sharpness: float):
    return torch.tanh(-sharpness * v) * 0.5 + 0.5


def _leaf(imms, dev):
    return torch.as_tensor(imms, dtype=torch.float32,
                           device=dev).detach().clone().requires_grad_(True)


def _mat_z(mat, z, ident, dev):
    """The camera (``ident()`` by default) and z as f32 tensors on dev."""
    mat = ident() if mat is None else mat
    return (upload(mat, dev, torch.float32), upload(z, dev, torch.float32))


def make_fit_step(size: int, mesh: Optional[Mesh] = None, lr: float = 1e-2,
                  sharpness: float = 20.0, grad_mask=None):
    """A sharded fit step of the tape's constants against a target fill
    image, through the interpreter (``mpr_tpu``'s ``make_fit_step``).

    The forward is a soft render, ``tanh(-sharpness * f) / 2 + 1/2`` as
    the fill probability, by :func:`eval_scan.eval_f` at every pixel
    centre of this rank's block (kernel K2f on a card, K2 its backward);
    the discrete culling pipeline is inference only, as the reference's
    Deriv treats min/max discontinuously.  Loss: the squared error summed
    over the image, divided by its pixels.

    Returns ``step(td, target, mat=None, z=0.0) -> (loss, new_td)``:
    ``target`` the (size, size) fill image (every rank passes all of it),
    ``td`` a TapeData on the rank's device."""
    mesh = make_mesh() if mesh is None else mesh
    rows, cols = size // mesh.dp, size // mesh.sp
    i0, j0 = mesh.dp_index * rows, mesh.sp_index * cols

    def step(td: TapeData, target, mat=None, z: float = 0.0):
        dev = td.device
        with span("mpr.fit.inputs"):
            mat_t, z_t = _mat_z(mat, z, camera.identity2, dev)
            x, y, zz = _block_coords(size, rows, cols, mat_t, z_t, i0, j0)
            tgt = upload(target, dev, torch.float32)[
                i0:i0 + rows, j0:j0 + cols]
            imms = _leaf(td.imms, dev)
        with torch.enable_grad():
            v = eval_scan.eval_f(td.replace_imms(imms), x, y, zz)
            loss = ((_soft_fill(v, sharpness) - tgt) ** 2).sum()
            grad, = torch.autograd.grad(loss, imms)
        with span("mpr.fit.apply"):
            loss, grad = _reduce_step(mesh, loss, grad, size * size)
            return loss, td.replace_imms(_apply(td.imms, grad,
                                                _mask(grad_mask, dev), lr))

    return step


def make_fit_step_unrolled(tape: Tape, size: int,
                           mesh: Optional[Mesh] = None, lr: float = 1e-2,
                           sharpness: float = 20.0, grad_mask=None,
                           device=None):
    """:func:`make_fit_step` through the unrolled float evaluator with the
    immediates an input (``build_float(take_imms=True)``: the float kernel
    forward, kernel K1 backward on a card).

    Returns ``step(imms, target, mat=None, z=0.0) -> (loss, new_imms)``,
    ``imms`` the flat f32 immediates (``Tape.imms``)."""
    from ..ops import unrolled_eval as ue
    mesh = make_mesh() if mesh is None else mesh
    dev = resolve_device(device)
    f = ue.build_float(tape, take_imms=True)
    rows, cols = size // mesh.dp, size // mesh.sp
    i0, j0 = mesh.dp_index * rows, mesh.sp_index * cols
    mask = _mask(grad_mask, dev)

    def step(imms, target, mat=None, z: float = 0.0):
        if dev.type == "cuda":
            ue.build_all([f] + f.vjp.evals)
        mat_t, z_t = _mat_z(mat, z, camera.identity2, dev)
        x, y, zz = _block_coords(size, rows, cols, mat_t, z_t, i0, j0)
        tgt = torch.as_tensor(target, dtype=torch.float32, device=dev)[
            i0:i0 + rows, j0:j0 + cols]
        im = _leaf(imms, dev)
        with torch.enable_grad():
            v = f(x.reshape(-1), y.reshape(-1), zz.reshape(-1), imms=im)
            loss = ((_soft_fill(v, sharpness) - tgt.reshape(-1)) ** 2).sum()
            grad, = torch.autograd.grad(loss, im)
        loss, grad = _reduce_step(mesh, loss, grad, size * size)
        return loss, _apply(im, grad, mask, lr)

    return step


def _soft_depth(v, sharpness: float):
    """Volume compositing along axis 0 (z, from the top = last index):
    occupancy ``sigmoid(-sharpness * f)``, each voxel's weight its
    occupancy times the probability that every voxel above it is empty
    (the transmittance), returned with the weights."""
    occ = torch.sigmoid(-sharpness * v)
    above_empty = torch.flip(torch.cumprod(torch.flip(1.0 - occ, [0]), 0),
                             [0])
    trans = torch.cat([above_empty[1:], torch.ones_like(occ[:1])], 0)
    return occ * trans


def make_fit_step_3d(tape: Tape, grid: int, mesh: Optional[Mesh] = None,
                     lr: float = 3e-4, sharpness: float = 40.0,
                     grad_mask=None, device=None):
    """A sharded 3D fit step against a target DEPTH image (voxel units, 0
    = empty; ``mpr_tpu``'s ``make_fit_step_3d``).

    The discrete depth is not differentiable, so the forward composites a
    dense ``grid``^3 occupancy field through the unrolled float evaluator
    (K1 backward on a card): ``soft_depth = sum_z w_z (z + 1)`` with
    ``w_z`` the probability that voxel z is the topmost filled one.  Each
    rank owns a slab of y rows.  The loss is in squared voxel units, so
    gradients are about ``grid`` times steeper than the 2D fill fits'
    (hence the small default ``lr``).

    Returns ``step(imms, target, mat=None) -> (loss, new_imms)``."""
    from ..ops import unrolled_eval as ue
    mesh = make_mesh() if mesh is None else mesh
    if grid % mesh.size:
        raise ValueError(f"{mesh.size} ranks must divide grid {grid}")
    dev = resolve_device(device)
    f = ue.build_float(tape, take_imms=True)
    rows = grid // mesh.size
    r = mesh.rank * rows
    mask = _mask(grad_mask, dev)

    def step(imms, target, mat=None):
        if dev.type == "cuda":
            ue.build_all([f] + f.vjp.evals)
        mat_t, _ = _mat_z(mat, 0.0, camera.identity3, dev)
        c = (tc.div_scalar(torch.arange(grid, dtype=torch.float32,
                                        device=dev) + 0.5, grid)
             * 2.0 - 1.0)
        Z, Y, X = torch.meshgrid(c, c[r:r + rows], c, indexing="ij")
        wx, wy, wz = camera.transform3(mat_t, X.reshape(-1), Y.reshape(-1),
                                       Z.reshape(-1))
        tgt = torch.as_tensor(target, dtype=torch.float32,
                              device=dev)[r:r + rows]
        im = _leaf(imms, dev)
        with torch.enable_grad():
            v = f(wx, wy, wz, imms=im).reshape(grid, rows, grid)
            w = _soft_depth(v, sharpness)
            zi = (torch.arange(grid, dtype=torch.float32, device=dev)
                  + 1.0)[:, None, None]
            loss = (((w * zi).sum(0) - tgt) ** 2).sum()
            grad, = torch.autograd.grad(loss, im)
        loss, grad = _reduce_step(mesh, loss, grad, grid * grid)
        return loss, _apply(im, grad, mask, lr)

    return step


class _CulledFitStep:
    """Stateful stepper of :func:`make_fit_step_culled`: the imm-input
    renderer of the tape, and ``last_counts``, the widened ambiguous
    64px / 8px tiles of the last step (the most of any rank)."""

    def __init__(self, tape: Tape, size: int, mesh: Mesh, lr: float,
                 sharpness: float, grad_mask, device):
        from ..render import unrolled
        self._r = unrolled.get_renderer(tape, imm_inputs=True)
        self.size, self.mesh = size, mesh
        self.lr, self.sharpness = float(lr), float(sharpness)
        self.dev = resolve_device(device)
        self.mask = _mask(grad_mask, self.dev)
        n64 = size // TILE
        if n64 % mesh.size:
            raise ValueError(f"size {size}: {mesh.size} ranks must divide "
                             f"{n64} tile rows")
        self.rows64 = n64 // mesh.size
        self.r0 = mesh.rank * self.rows64
        self.last_counts = None

    def __call__(self, imms, target, mat=None, z: float = 0.0):
        from ..ops import unrolled_eval as ue
        from ..render.unrolled import _soft_render2d_impl
        r, dev = self._r, self.dev
        if dev.type == "cuda":
            ue.build_all([r.fi, r.f] + r.f.vjp.evals)
        mat_t, z_t = _mat_z(mat, z, camera.identity2, dev)
        px0, px1 = self.r0 * TILE, (self.r0 + self.rows64) * TILE
        tgt = torch.as_tensor(target, dtype=torch.float32,
                              device=dev)[px0:px1]
        im = _leaf(imms, dev)
        with torch.enable_grad():
            soft, counts = _soft_render2d_impl(
                r.fi, r.f, mat_t, z_t, self.size, self.sharpness, im,
                self.r0, self.rows64)
            loss = ((soft - tgt) ** 2).sum()
            grad, = torch.autograd.grad(loss, im)
        cnt = _all_reduce(self.mesh, torch.tensor(counts, device=dev),
                          dist.ReduceOp.MAX)
        self.last_counts = tuple(int(c) for c in cnt.tolist())
        loss, grad = _reduce_step(self.mesh, loss, grad,
                                  self.size * self.size)
        return loss, _apply(im, grad, self.mask, self.lr)


def make_fit_step_culled(tape: Tape, size: int, mesh: Optional[Mesh] = None,
                         lr: float = 1e-2, sharpness: float = 20.0,
                         grad_mask=None, device=None) -> _CulledFitStep:
    """A fit step through the CULLED unrolled ladder
    (``mpr_tpu``'s ``make_fit_step_culled``).

    Forward structure: the interval ladder (64px -> 8px) without
    gradient, its cull widened to |f| > 4 / sharpness; the soft render
    then evaluates only the pixels of the surviving ambiguous 8px tiles
    and scatters them over the saturated base image
    (``render.unrolled._soft_render2d_impl``), so a step costs
    O(ambiguous tiles); the gradients match the dense step's to the tanh
    saturation tolerance (~1e-3 relative).  Each rank takes a slab of
    64px tile rows; each stage reads its exact count back, so there are
    no capacities to grow.

    Returns ``step(imms, target, mat=None, z=0.0) -> (loss, new_imms)``."""
    mesh = make_mesh() if mesh is None else mesh
    return _CulledFitStep(tape, size, mesh, lr, sharpness, grad_mask, device)


class _WindowFitStep3D:
    """Stateful stepper of :func:`make_fit_step_3d_window`."""

    def __init__(self, tape: Tape, size: int, mesh: Mesh, lr: float,
                 sharpness: float, window: int, grad_mask, device):
        from ..render import unrolled
        self._r = unrolled.get_renderer(tape, imm_inputs=True)
        self.size, self.mesh = size, mesh
        self.lr, self.sharpness = float(lr), float(sharpness)
        self.window = int(window)
        self.dev = resolve_device(device)
        self.mask = _mask(grad_mask, self.dev)
        if size % mesh.size:
            raise ValueError(f"{mesh.size} ranks must divide size {size}")
        self.rows = size // mesh.size
        self.r0 = mesh.rank * self.rows

    def __call__(self, imms, target_depth, mat=None):
        from ..ops import unrolled_eval as ue
        r, dev, size, W = self._r, self.dev, self.size, self.window
        if dev.type == "cuda":
            ue.build_all([r.fi, r.f] + r.f.vjp.evals)
        mat_t, _ = _mat_z(mat, 0.0, camera.identity3, dev)
        im = _leaf(imms, dev)
        # the discrete depth through the culled ladder (inference only;
        # the window's placement is integer data, without gradient)
        with torch.no_grad():
            d_r, _, _ = r.frame3d(mat_t, size, with_normals=False,
                                  imms=im.detach())
        rs = slice(self.r0, self.r0 + self.rows)
        d_r = d_r[rs].to(torch.float32)
        d_t = torch.as_tensor(target_depth, dtype=torch.float32,
                              device=dev)[rs]
        # window top: one voxel above the deeper of the two surfaces
        # (depth = top filled voxel + 1, so the surface voxel is d - 1)
        top = torch.maximum(d_r, d_t)
        zhi = torch.clamp_max(torch.clamp_min(top, float(W)).to(torch.int32),
                              size)
        zi = (zhi[None] - W + torch.arange(W, dtype=torch.int32,
                                           device=dev)[:, None, None])
        active = (top > 0).to(torch.float32)
        px = torch.arange(size, dtype=torch.float32, device=dev)[None, None]
        py = (self.r0 + torch.arange(self.rows, dtype=torch.float32,
                                     device=dev))[None, :, None]
        fx = tc.div_scalar(px + 0.5, size) * 2.0 - 1.0
        fy = tc.div_scalar(py + 0.5, size) * 2.0 - 1.0
        fz = tc.div_scalar(zi.to(torch.float32) + 0.5, size) * 2.0 - 1.0
        wx, wy, wz = camera.transform3(
            mat_t, fx.expand(zi.shape).reshape(-1),
            fy.expand(zi.shape).reshape(-1), fz.reshape(-1))
        with torch.enable_grad():
            v = r.f(wx, wy, wz, imms=im).reshape(zi.shape)
            w = _soft_depth(v, self.sharpness)
            zval = zi.to(torch.float32) + 1.0
            # transmittance downward from the window top (everything above
            # it is empty in the render by construction, and assumed so in
            # the target); mass not hit in the window sits at its bottom,
            # so receding surfaces keep a downhill gradient
            soft = (w * zval).sum(0) + (1.0 - w.sum(0)) * (zval[0] - 1.0)
            loss = (active * (soft - d_t) ** 2).sum()
            grad, = torch.autograd.grad(loss, im)
        loss, grad = _reduce_step(self.mesh, loss, grad, size * size)
        return loss, _apply(im, grad, self.mask, self.lr)


def make_fit_step_3d_window(tape: Tape, size: int,
                            mesh: Optional[Mesh] = None, lr: float = 3e-4,
                            sharpness: float = 40.0, window: int = 8,
                            grad_mask=None,
                            device=None) -> _WindowFitStep3D:
    """3D depth fitting at render resolutions: O(size^2 * window) voxels a
    step, not O(grid^3) (``mpr_tpu``'s ``make_fit_step_3d_window``).

    Forward: the culled unrolled ladder renders the discrete depth
    (inference only).  Backward: a ``window``-voxel z window a pixel,
    topped one voxel above the deeper of the rendered and the target
    surface, is soft-composited (as :func:`make_fit_step_3d`) and the
    squared depth error differentiates through those voxels only (K1 on
    a card).  Columns empty in both images carry no gradient.  Each rank
    owns a slab of pixel rows.

    Returns ``step(imms, target_depth, mat=None) -> (loss, new_imms)``."""
    mesh = make_mesh() if mesh is None else mesh
    return _WindowFitStep3D(tape, size, mesh, lr, sharpness, window,
                            grad_mask, device)
