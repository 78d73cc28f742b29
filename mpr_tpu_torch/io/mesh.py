"""Triangle-mesh extraction and STL / OBJ export.

Counterpart of ``mpr_tpu.io.mesh``: sample the shape on a voxel-corner
grid with the port's float evaluator (``ops/unrolled_eval.py::
build_float``: on a card the kernel generated for the tape, on the CPU its
plain version), then run **marching tetrahedra** over the grid: each cube
splits into 6 tetrahedra fanned around its main diagonal, a decomposition
whose face diagonals agree between neighboring cubes, so the mesh is
watertight by construction.  Per-tet triangulation has only three sign
patterns (1/2/3 corners inside); triangle orientation is fixed
numerically (outward = from the inside corners toward the outside
corners).  ``method="dc"`` is dual contouring with Hermite normals from
the forward-mode evaluator (``build_deriv``).

The two evaluations run on ``device`` (``cuda`` unless the caller names
another; no card and no device raises).  ``use_oracle=True`` takes the
NumPy oracle instead (``oracle.eval_f`` / ``eval_d``); left at None it is
taken only on the CPU, for the short tapes and small grids where the JAX
package takes it, never on the card.  The triangle emission is NumPy on
the host, as in the JAX package.

    python -m mpr_tpu_torch.cli fit a.frep --target b.frep --out-frep f.frep
    python -m mpr_tpu_torch.cli mesh f.frep --size 128 --out out.stl
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..tape.tape import Tape

# 6 tetrahedra fanned around the cube's 0-7 main diagonal.  Cube corner
# index = x + 2y + 4z.  Every cube face takes its diagonal through the
# corner pair that is shared with the neighboring cube's decomposition.
_TETS = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
         (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7))

_CORNER = np.array([(x, y, z) for z in (0, 1) for y in (0, 1)
                    for x in (0, 1)], np.float32)      # idx = x + 2y + 4z


def _use_oracle(use_oracle, dev, small: bool) -> bool:
    """The oracle only where the caller asks, or (left at None) on the CPU
    where the JAX package would take it; never silently on the card."""
    if use_oracle is not None:
        return bool(use_oracle)
    return dev.type == "cpu" and small


def _eval_grid(tape: Tape, n: int, lo, hi, chunk_rows: int = 8,
               use_oracle: Optional[bool] = None,
               device=None) -> np.ndarray:
    """Sample the tape's float field on an (n+1)^3 corner grid over the
    box [lo, hi]^3 (per-axis bounds allowed), ``chunk_rows`` z-planes an
    evaluation.  Returns (z, y, x) float32 values."""
    import torch

    from ..ops.tape_data import resolve_device
    dev = resolve_device(device)
    lo = np.broadcast_to(np.asarray(lo, np.float32), (3,))
    hi = np.broadcast_to(np.asarray(hi, np.float32), (3,))
    axes = [np.linspace(lo[i], hi[i], n + 1, dtype=np.float32)
            for i in range(3)]
    vals = np.empty((n + 1, n + 1, n + 1), np.float32)
    Y, X = np.meshgrid(axes[1], axes[0], indexing="ij")
    if not _use_oracle(use_oracle, dev, tape.length <= 256 and n < 64):
        from ..ops import unrolled_eval as ue
        f = ue.build_float(tape)
        if dev.type == "cuda":
            # every form a chunk may take (the last is often under a
            # wave), built at once
            ue.build_all([f])
        xs = torch.as_tensor(X.ravel(), device=dev)
        ys = torch.as_tensor(Y.ravel(), device=dev)
        for z0 in range(0, n + 1, chunk_rows):
            z1 = min(z0 + chunk_rows, n + 1)
            zs = torch.as_tensor(axes[2][z0:z1], device=dev)
            out = f(xs.repeat(z1 - z0), ys.repeat(z1 - z0),
                    zs.repeat_interleave(xs.shape[0]))
            vals[z0:z1] = out.reshape(z1 - z0, n + 1, n + 1).cpu().numpy()
    else:
        from .. import oracle
        for k in range(n + 1):
            vals[k] = oracle.eval_f(
                tape, X.ravel(), Y.ravel(),
                np.full(X.size, axes[2][k], np.float32)).reshape(
                    n + 1, n + 1)
    return vals


def _close_boundary(vals: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Clamp the grid's boundary-face corners to >= +eps so shapes that
    cross the sampling box get capped at its faces — the mesh stays
    closed (watertight) instead of silently open with a wrong volume."""
    v = vals.copy()
    for axis in range(3):
        sl = [slice(None)] * 3
        for face in (0, -1):
            sl[axis] = face
            v[tuple(sl)] = np.maximum(v[tuple(sl)], eps)
    return v


def _edge_point(pa, pb, va, vb):
    """Linear zero crossing on edge a-b; (k,3) positions, (k,) values."""
    t = va / (va - vb)
    return pa + t[:, None] * (pb - pa)


def marching_tets(vals: np.ndarray, lo, hi) -> np.ndarray:
    """(n+1,n+1,n+1) corner values -> (T, 3, 3) float32 triangle soup in
    world coordinates, outward-oriented (normals point toward f > 0)."""
    n = vals.shape[0] - 1
    lo = np.broadcast_to(np.asarray(lo, np.float32), (3,))
    hi = np.broadcast_to(np.asarray(hi, np.float32), (3,))
    scale = (hi - lo) / n

    # cube-corner values as (8, n^3); grid index of cube origin as (n^3, 3)
    ii = np.arange(n)
    Z, Y, X = np.meshgrid(ii, ii, ii, indexing="ij")
    org = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1).astype(np.float32)
    cv = np.empty((8, org.shape[0]), np.float32)
    for c in range(8):
        dx, dy, dz = (int(_CORNER[c, 0]), int(_CORNER[c, 1]),
                      int(_CORNER[c, 2]))
        cv[c] = vals[dz:dz + n, dy:dy + n, dx:dx + n].ravel()
    tris = []

    def emit(pin, pout, vin, vout):
        """Triangles for tets with the given inside (k,m_in) / outside
        (k,m_out) corner positions+values; orientation fixed so normals
        point from inside toward outside."""
        m_in, m_out = pin.shape[1], pout.shape[1]
        if m_in == 1:
            # one inside corner: tri across its 3 edges
            a = _edge_point(pin[:, 0], pout[:, 0], vin[:, 0], vout[:, 0])
            b = _edge_point(pin[:, 0], pout[:, 1], vin[:, 0], vout[:, 1])
            c = _edge_point(pin[:, 0], pout[:, 2], vin[:, 0], vout[:, 2])
            cand = [np.stack([a, b, c], 1)]
        elif m_in == 3:
            # one outside corner: tri across its 3 edges
            a = _edge_point(pin[:, 0], pout[:, 0], vin[:, 0], vout[:, 0])
            b = _edge_point(pin[:, 1], pout[:, 0], vin[:, 1], vout[:, 0])
            c = _edge_point(pin[:, 2], pout[:, 0], vin[:, 2], vout[:, 0])
            cand = [np.stack([a, b, c], 1)]
        else:
            # 2 in / 2 out: quad p(i0,o0) p(i1,o0) p(i1,o1) p(i0,o1)
            q0 = _edge_point(pin[:, 0], pout[:, 0], vin[:, 0], vout[:, 0])
            q1 = _edge_point(pin[:, 1], pout[:, 0], vin[:, 1], vout[:, 0])
            q2 = _edge_point(pin[:, 1], pout[:, 1], vin[:, 1], vout[:, 1])
            q3 = _edge_point(pin[:, 0], pout[:, 1], vin[:, 0], vout[:, 1])
            cand = [np.stack([q0, q1, q2], 1), np.stack([q0, q2, q3], 1)]
        dirn = pout.mean(1) - pin.mean(1)        # inside -> outside
        for t in cand:
            nrm = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
            flip = (nrm * dirn).sum(1) < 0
            t[flip] = t[flip][:, ::-1]
            tris.append(t)

    for tet in _TETS:
        tv = cv[list(tet)]                       # (4, n^3)
        tp = org[None] + _CORNER[list(tet)][:, None]   # (4, n^3, 3)
        inside = tv < 0.0
        nin = inside.sum(0)
        for m in (1, 2, 3):
            sel = np.where(nin == m)[0]
            if sel.size == 0:
                continue
            ins = inside[:, sel]                 # (4, k)
            v = tv[:, sel].T                     # (k, 4)
            p = tp[:, sel].transpose(1, 0, 2)    # (k, 4, 3)
            # order corners: inside first, outside after (stable)
            order = np.argsort(~ins.T, axis=1, kind="stable")   # (k, 4)
            ko = np.arange(sel.size)[:, None]
            v_s = v[ko, order]
            p_s = p[ko, order]
            emit(p_s[:, :m], p_s[:, m:], v_s[:, :m], v_s[:, m:])

    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    out = np.concatenate(tris, 0).astype(np.float32)
    return out * scale[None, None] + lo[None, None]


def _eval_normals(tape: Tape, pts: np.ndarray,
                  use_oracle: Optional[bool] = None,
                  device=None) -> np.ndarray:
    """Unit surface normals (gradient direction) at (k, 3) points from
    the forward-mode evaluator (``unrolled_eval.build_deriv``, the same
    dual numbers the renderer's normal pass uses)."""
    import torch

    from ..ops.tape_data import resolve_device
    dev = resolve_device(device)
    small = tape.length <= 256 and pts.shape[0] <= 65536
    if not _use_oracle(use_oracle, dev, small) and pts.shape[0]:
        from ..ops import unrolled_eval as ue
        fd = ue.build_deriv(tape)
        p = torch.as_tensor(np.ascontiguousarray(pts, np.float32),
                            device=dev)
        _, dx, dy, dz = fd(p[:, 0].contiguous(), p[:, 1].contiguous(),
                           p[:, 2].contiguous())
        g = torch.stack([dx, dy, dz], 1).cpu().numpy()
    else:
        from .. import oracle
        _, gx, gy, gz = oracle.eval_d(tape, pts[:, 0], pts[:, 1],
                                      pts[:, 2])
        g = np.stack([gx, gy, gz], 1)
    ln = np.linalg.norm(g, axis=1, keepdims=True)
    return np.where(ln > 1e-12, g / np.maximum(ln, 1e-12), 0.0).astype(
        np.float32)


def dual_contour(tape: Tape, vals: np.ndarray, lo, hi,
                 use_oracle: Optional[bool] = None,
                 reg: float = 1e-3, device=None) -> np.ndarray:
    """Uniform-grid dual contouring: one QEF-placed vertex per surface
    cell (Hermite normals from the forward-mode evaluator), one quad per
    sign-changing interior edge.  Reproduces sharp features (box edges,
    CSG creases) that marching tetrahedra rounds off; watertight because
    every crossing edge (with the boundary capped by the caller) has
    exactly 4 in-range adjacent cells, each contributing its vertex to
    the edge's quad.  ``reg``: Tikhonov pull of each QEF vertex toward
    its cell's crossing mass point (stabilizes flat faces)."""
    n = vals.shape[0] - 1
    lo = np.broadcast_to(np.asarray(lo, np.float32), (3,))
    hi = np.broadcast_to(np.asarray(hi, np.float32), (3,))
    scale = (hi - lo) / n
    ncell = n * n * n

    def cell_id(ix, iy, iz):
        return (iz * n + iy) * n + ix

    A = np.zeros((ncell, 3, 3), np.float64)
    b = np.zeros((ncell, 3), np.float64)
    msum = np.zeros((ncell, 3), np.float64)
    mcnt = np.zeros((ncell,), np.int32)

    quads = []          # (cells q0..q3 ids) per crossing edge, oriented
    # transverse axes per edge axis, ordered so (a, u, w) is right-handed
    TRANS = {0: (1, 2), 1: (2, 0), 2: (0, 1)}

    for a in range(3):
        # axis a maps to vals dim: x->2, y->1, z->0 (vals is [z, y, x])
        dim = 2 - a
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[dim] = slice(0, n)
        sl1[dim] = slice(1, n + 1)
        v0 = vals[tuple(sl0)]
        v1 = vals[tuple(sl1)]
        cross = (v0 < 0) != (v1 < 0)
        if not cross.any():
            continue
        zz, yy, xx = np.nonzero(cross)          # indices in [z, y, x] dims
        idx = np.stack([xx, yy, zz], 1)         # corner (x, y, z) of low end
        va = v0[zz, yy, xx]
        vb = v1[zz, yy, xx]
        t = va / (va - vb)
        p = idx.astype(np.float32)
        p[:, a] += t
        pw = p * scale[None] + lo[None]
        nrm = _eval_normals(tape, pw, use_oracle=use_oracle,
                             device=device)
        # crossings produced by the caller's boundary capping lie ON a
        # box face; geometrically the cap face IS the surface there, so
        # use the outward face normal instead of the shape's gradient
        # (which points through the face and would drive the QEF vertex
        # outside its cell — measured as non-manifold duplicates on the
        # cap ring otherwise)
        at_lo = (idx[:, a] == 0) & (t < 1e-3)
        at_hi = (idx[:, a] == n - 1) & (t > 1.0 - 1e-3)
        face_n = np.zeros((1, 3), np.float32)
        face_n[0, a] = 1.0
        nrm = np.where(at_hi[:, None], face_n, nrm)
        nrm = np.where(at_lo[:, None], -face_n, nrm)

        u, w = TRANS[a]
        # 4 adjacent cells at transverse offsets, CCW around +a
        offs = ((-1, -1), (0, -1), (0, 0), (-1, 0))
        cids = []
        for du, dw in offs:
            ci = idx.copy()
            ci[:, u] += du
            ci[:, w] += dw
            # the a coordinate of the cell equals the low corner's
            cids.append(cell_id(ci[:, 0], ci[:, 1], ci[:, 2]))
        cids = np.stack(cids, 1)                # (E, 4)
        ok = np.ones(len(idx), bool)
        # in-range check (crossings on boundary faces are prevented by
        # the caller's boundary capping, but guard anyway)
        for j, (du, dw) in enumerate(offs):
            cu = idx[:, u] + du
            cw = idx[:, w] + dw
            ok &= (cu >= 0) & (cu < n) & (cw >= 0) & (cw < n)
        ok &= idx[:, a] < n
        cids, pj, nj = cids[ok], p[ok], nrm[ok]
        inside_low = (va < 0)[ok]
        # QEF accumulation into each adjacent cell
        nnT = nj[:, :, None] * nj[:, None, :]                # (E,3,3)
        nd = (nj * pj).sum(1)[:, None] * nj                  # (E,3)
        for j in range(4):
            np.add.at(A, cids[:, j], nnT)
            np.add.at(b, cids[:, j], nd)
            np.add.at(msum, cids[:, j], pj)
            np.add.at(mcnt, cids[:, j], 1)
        # quad orientation: +a normal when the low end is inside
        q = np.where(inside_low[:, None], cids, cids[:, ::-1])
        quads.append(q)

    if not quads:
        return np.zeros((0, 3, 3), np.float32)
    quads = np.concatenate(quads, 0)

    surf = mcnt > 0
    ids = np.nonzero(surf)[0]
    mass = msum[ids] / mcnt[ids, None]
    Ar = A[ids] + reg * np.eye(3)[None]
    br = b[ids] + reg * mass
    vtx = np.linalg.solve(Ar, br[..., None])[..., 0]
    # clamp each vertex into its cell (QEF can shoot out on flat data)
    cx = ids % n
    cy = (ids // n) % n
    cz = ids // (n * n)
    cmin = np.stack([cx, cy, cz], 1).astype(np.float32)
    vtx = np.clip(vtx, cmin, cmin + 1.0)
    vert_of = np.full(ncell, -1, np.int64)
    vert_of[ids] = np.arange(len(ids))
    vworld = vtx * scale[None] + lo[None]

    qv = vworld[vert_of[quads]]                              # (Q, 4, 3)
    tris = np.concatenate([qv[:, (0, 1, 2)], qv[:, (0, 2, 3)]], 0)
    return tris.astype(np.float32)


def mesh_tape(tape: Tape, n: int = 64, lo=-1.0, hi=1.0,
              use_oracle: Optional[bool] = None,
              close_boundary: bool = True,
              method: str = "mt", device=None) -> np.ndarray:
    """Extract an outward-oriented triangle soup (T, 3, 3) for the
    tape's zero isosurface over the box [lo, hi]^3, evaluated on
    ``device`` (module doc; ``use_oracle`` picks the NumPy oracle).

    ``method``: ``"mt"`` (marching tetrahedra, the robust default) or
    ``"dc"`` (dual contouring: QEF vertices from forward-mode normals
    reproduce sharp edges).  With ``close_boundary`` (default) shapes
    crossing the box are capped at its faces so the mesh stays
    watertight; pass False for the raw (possibly open) isosurface."""
    if method not in ("mt", "dc"):
        raise ValueError(f"unknown mesh method {method!r}")
    vals = _eval_grid(tape, n, lo, hi, use_oracle=use_oracle, device=device)
    if close_boundary:
        vals = _close_boundary(vals)
    if method == "dc":
        return dual_contour(tape, vals, lo, hi, use_oracle=use_oracle,
                            device=device)
    return marching_tets(vals, lo, hi)


def write_stl(path: str, tris: np.ndarray) -> None:
    """Binary STL (normals recomputed from the outward winding)."""
    tris = np.asarray(tris, np.float32)
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(ln > 1e-20, nrm / np.maximum(ln, 1e-20), 0.0).astype(
        np.float32)
    with open(path, "wb") as f:
        f.write(b"mpr_tpu mesh".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(tris)))
        rec = np.zeros((len(tris), 50), np.uint8)
        body = np.concatenate([nrm[:, None], tris], 1).astype("<f4")
        rec[:, :48] = body.reshape(len(tris), 48 // 4).view(np.uint8).reshape(
            len(tris), 48)
        f.write(rec.tobytes())


def write_obj(path: str, tris: np.ndarray, decimals: int = 6) -> None:
    """Wavefront OBJ with welded (indexed) vertices — the text-format
    sibling of write_stl, friendlier to mesh tooling."""
    q = np.round(np.asarray(tris, np.float32), decimals)
    verts, inv = np.unique(q.reshape(-1, 3), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3) + 1              # OBJ is 1-indexed
    with open(path, "w") as f:
        f.write("# mpr_tpu mesh\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a} {b} {c}\n")


def read_stl(path: str) -> np.ndarray:
    """Binary STL -> (T, 3, 3) triangle soup (tests, round trips)."""
    with open(path, "rb") as f:
        f.seek(80)
        count = struct.unpack("<I", f.read(4))[0]
        rec = np.frombuffer(f.read(count * 50), np.uint8).reshape(count, 50)
    body = rec[:, :48].reshape(count, 48).copy().view("<f4").reshape(
        count, 4, 3)
    return body[:, 1:].astype(np.float32)


def mesh_volume(tris: np.ndarray) -> float:
    """Signed volume via the divergence theorem: exact for a closed,
    consistently outward-oriented mesh — the orientation test."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)


def mesh_area(tris: np.ndarray) -> float:
    return float(0.5 * np.linalg.norm(
        np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]),
        axis=1).sum())


def is_watertight(tris: np.ndarray, decimals: int = 5) -> bool:
    """Every undirected edge must be used by exactly two triangles, in
    opposite directions (quantized to merge duplicated soup vertices)."""
    q = np.round(tris, decimals)
    verts, inv = np.unique(q.reshape(-1, 3), axis=0, return_inverse=True)
    tri_idx = inv.reshape(-1, 3)
    # drop degenerate triangles produced when a corner value is ~0
    ok = ((tri_idx[:, 0] != tri_idx[:, 1]) & (tri_idx[:, 1] != tri_idx[:, 2])
          & (tri_idx[:, 0] != tri_idx[:, 2]))
    tri_idx = tri_idx[ok]
    edges = np.concatenate([tri_idx[:, (0, 1)], tri_idx[:, (1, 2)],
                            tri_idx[:, (2, 0)]], 0)
    fwd = edges[:, 0] * len(verts) + edges[:, 1]
    rev = edges[:, 1] * len(verts) + edges[:, 0]
    fs, fc = np.unique(fwd, return_counts=True)
    # matched: each directed edge appears once, and its reverse once
    if (fc != 1).any():
        return False
    rs = np.sort(rev)
    return bool(np.array_equal(np.sort(fs), rs))
