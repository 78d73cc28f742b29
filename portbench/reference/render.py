"""Dense renders of an expression, and the gaps by which an image, a depth
or normals depart from them.

Conventions (the port's and its upstream's): a pixel or voxel ``i`` of an
``n``-wide grid has the centre ``((i + 0.5) / n - 0.5) * 2``; a 2D view is
a homogeneous 3x3 matrix and a 3D view a 4x4 one, applied with the
projective divide; image row ``i`` is y, column ``j`` is x; a pixel is
filled where the field is below 0; depth is the top filled voxel's z index
plus 1 (0: none); a normal is the gradient in the transformed coordinates,
normalised, one voxel in front of the surface (at z index ``min(depth,
n - 1)``).
"""

from __future__ import annotations

import math

import torch

from .evaluate import evaluate

# rows of a 2D image evaluated at once, and z layers of a 3D volume
ROWS_2D = 1024
SLAB_3D = 32
# a seam: a min, max or abs whose two sides lie within this of each other
SEAM = 1e-4


def centers(n: int, dev) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=dev)
    return ((i + 0.5) / n - 0.5) * 2.0


def transform2(m, fx, fy):
    """A 3x3 view (a sequence of rows of floats) on broadcast tensors."""
    w = m[2][0] * fx + m[2][1] * fy + m[2][2]
    return ((m[0][0] * fx + m[0][1] * fy + m[0][2]) / w,
            (m[1][0] * fx + m[1][1] * fy + m[1][2]) / w)


def transform3(m, fx, fy, fz):
    """A 4x4 view on broadcast tensors."""
    w = m[3][0] * fx + m[3][1] * fy + m[3][2] * fz + m[3][3]
    return tuple((m[r][0] * fx + m[r][1] * fy + m[r][2] * fz + m[r][3]) / w
                 for r in range(3))


def _rows(m):
    return [[float(v) for v in row] for row in m]


# -- 2D -----------------------------------------------------------------------

def field2d(e, mat, size: int, r0: int, r1: int, dev, dtype=torch.float32):
    """The field at the pixel centres of image rows [r0, r1)."""
    c = centers(size, dev)
    x, y = transform2(_rows(mat), c[None, :], c[r0:r1, None])
    return evaluate(e, x, y, None, dtype).float().expand(r1 - r0, size)


def fill_gap(e, mat, size: int, fill_rows, dev):
    """Where ``fill_rows(r0, r1)`` (a bool block, True = filled) departs
    from the float32 field's sign: (the largest |field| at such a pixel,
    0.0 where none does; the count of such pixels)."""
    gap, bad = 0.0, 0
    for r0 in range(0, size, ROWS_2D):
        r1 = min(size, r0 + ROWS_2D)
        f = field2d(e, mat, size, r0, r1, dev)
        off = fill_rows(r0, r1).to(dev) != (f < 0)
        n = int(off.sum())
        if n:
            bad += n
            gap = max(gap, float(f.abs()[off].max()))
    return gap, bad


# -- 3D -----------------------------------------------------------------------

def depth3d(e, mat, size: int, dev, dtype=torch.float32):
    """(size, size) int32 depth of the dense volume, in z slabs."""
    m = _rows(mat)
    c = centers(size, dev)
    depth = torch.zeros(size, size, dtype=torch.int32, device=dev)
    for z0 in range(0, size, SLAB_3D):
        z1 = min(size, z0 + SLAB_3D)
        x, y, z = transform3(m, c[None, None, :], c[None, :, None],
                             c[z0:z1, None, None])
        f = evaluate(e, x, y, z, dtype)
        k = torch.arange(z0 + 1, z1 + 1, dtype=torch.int32,
                         device=dev)[:, None, None]
        depth = torch.maximum(depth, torch.where(f < 0, k, 0).amax(dim=0))
        del x, y, z, f
    return depth


def _points(m, size, ii, jj, kk, dev):
    c = centers(size, dev)
    return transform3(m, c[jj], c[ii], c[kk])


def field_at(e, mat, size: int, ii, jj, kk, dev):
    """The float32 field at voxels (row ii, column jj, z index kk)."""
    return evaluate(e, *_points(_rows(mat), size, ii, jj, kk, dev))


def normals_at(e, mat, size: int, depth, dev, dtype=torch.float32,
               flip: float = None):
    """(rows, cols, unit normals (k, 3) float32) of the pixels with depth."""
    ii, jj = torch.nonzero(depth > 0, as_tuple=True)
    kk = torch.clamp_max(depth[ii, jj], size - 1).long()
    pts = [p.to(dtype).detach().requires_grad_(True)
           for p in _points(_rows(mat), size, ii, jj, kk, dev)]
    with torch.enable_grad():
        f = evaluate(e, *pts, dtype=dtype, flip=flip)
        g = torch.autograd.grad(f.float().sum(), pts)
    g = torch.stack([t.float() for t in g], dim=-1)
    return ii, jj, g / torch.clamp_min(g.norm(dim=-1, keepdim=True), 1e-12)


def depth_gaps(e, mat, size: int, depth, normals, dev):
    """How a depth and its normals depart from the float32 reference.

    Returns (depth_gap: the largest |field| at the top voxel on which the
    two depths disagree, max(d, d_ref) - 1, over the pixels whose depths
    differ, 0.0 where none does; the count of those pixels; normal_gap: the
    largest difference of a component between ``normals`` and the
    reference's normal, over the pixels whose depths agree, where at a
    seam either side's normal counts).  A depth outside [0, size] reads
    infinite."""
    depth = depth.to(dev).int()
    if bool(((depth < 0) | (depth > size)).any()):
        return math.inf, int(((depth < 0) | (depth > size)).sum()), math.inf
    ref = depth3d(e, mat, size, dev)
    ii, jj = torch.nonzero(depth != ref, as_tuple=True)
    n_off = int(ii.numel())
    dgap = 0.0
    if n_off:
        kk = (torch.maximum(depth[ii, jj], ref[ii, jj]) - 1).long()
        dgap = float(field_at(e, mat, size, ii, jj, kk, dev).abs().max())
    same = torch.where(depth == ref, ref, 0)
    ngap = 0.0
    if bool((same > 0).any()):
        ii, jj, n0 = normals_at(e, mat, size, same, dev)
        _, _, n1 = normals_at(e, mat, size, same, dev, flip=SEAM)
        got = normals.to(dev).float()[ii, jj]
        d = torch.minimum((got - n0).abs().amax(-1),
                          (got - n1).abs().amax(-1))
        ngap = float(d.max())
    return dgap, n_off, ngap


def render3d(e, mat, size: int, dev, dtype=torch.float32):
    """The dense depth and its (size, size, 3) normals, computed in
    ``dtype`` (the control's render, in the program's place)."""
    depth = depth3d(e, mat, size, dev, dtype)
    normals = torch.zeros(size, size, 3, dtype=torch.float32, device=dev)
    if bool((depth > 0).any()):
        ii, jj, n = normals_at(e, mat, size, depth, dev, dtype)
        normals[ii, jj] = n
    return depth, normals
