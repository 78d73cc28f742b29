"""PyTorch port: the whole 3D interpreter render on the CPU.

``mpr_tpu_torch.render.render3d(..., device="cpu")`` runs every stage with
the kernels' plain PyTorch versions and is held against
``mpr_tpu.render.pipeline3d.render3d`` (Pallas in interpret mode), against
both brute renderers, and for one case stage by stage against the JAX
pipeline's intermediate arrays.  Each JAX frame is dear on the CPU, so each
is rendered once in a module-scoped fixture, and the further variants
(empty, all filled, no normals, a slab, a longer CSG model) are held
against the brute renderers only.

Tolerances.  Depth must be equal everywhere, except that for tapes whose
float pass runs sin, cos, exp or log (torch's CPU kernels round them an ulp
apart from XLA's and numpy's) a pixel may differ where the oracle's
|f| <= FILL_BAND at some voxel of its column; such pixels are counted per
test.  Normals: atol 1e-4 against the JAX image (where both depths agree),
1e-3 against autograd of the plain interpreter (the JAX test's tolerance).
Intermediate integer arrays must be equal.
"""

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import mpr_tpu
from mpr_tpu import oracle
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.ops.tape_data import TapeData as JTapeData
from mpr_tpu.render import brute as jbrute
from mpr_tpu.render import pipeline3d as jp3

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.ops import eval_scan
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops import kernels3d as tk3
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import (camera, pipeline3d, render3d,
                                  render3d_brute)

from torch_port_cases import (assert_depth, depth_field,
                              one_torch_thread)  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = 128


def _building(S):
    """The solid of examples/building.py, from the shape library."""
    slab = S.box(-0.8, 0.8, -0.6, 0.6, -0.9, -0.7)
    tower = S.box(-0.35, 0.35, -0.3, 0.3, -0.7, 0.55)
    setback = S.box(-0.25, 0.25, -0.22, 0.22, 0.55, 0.8)
    column = S.cylinder_z(0.05, -0.9, -0.7)
    cols = S.union(*[S.move(column, dx, dy, 0.0)
                     for dx in (-0.6, 0.0, 0.6) for dy in (-0.45, 0.45)])
    arch = S.difference(tower, S.move(S.cylinder_z(0.18, -0.75, 0.2), 0.0,
                                      -0.4, 0.0))
    return S.union(slab, arch, setback, cols)


SCENES = {
    "sphere": (lambda S: S.sphere(0.6), None),
    "two_spheres": (lambda S: S.two_spheres(), camera.gui3d_view()),
    "gyroid": (lambda S: S.intersection(S.gyroid(0.4, 0.08), S.sphere(0.85)),
               camera.gui3d_view(0.5, -0.9, 0.3)),
    # 373 clauses, 115 slots: the per-cell tapes shorten
    "extruded_stress": (lambda S: S.extrude_z(S.stress_2d(40), -0.4, 0.4),
                        camera.gui3d_view()),
    "empty": (lambda S: S.sphere(0.5, 9.0, 9.0, 9.0), None),
    "all_filled": (lambda S: S.sphere(9.0), None),
    "building": (_building, camera.gui3d_view(0.6, -1.05, 0.3)),
}
JAX_SCENES = ["sphere", "two_spheres", "gyroid", "extruded_stress"]


def _tapes(name):
    make, mat = SCENES[name]
    return (mpr_tpu.compile_tree(make(jshapes)),
            mpr_tpu_torch.compile_tree(make(shapes)), mat)


class _JaxStages:
    """What the JAX pipeline handed its kernels in one eager frame."""

    def __init__(self):
        self.status = []      # kernel A's status, one entry per launch
        self.voxel = None     # kernel V's positional arguments


def _jax_frame_with_stages(jt, mat):
    """One eager (unjitted) frame of ``mpr_tpu``'s render3d_rows, with the
    outputs of kernel A and the inputs of kernel V recorded."""
    rec = _JaxStages()
    a_fn, v_fn = jp3.kernels.interval_shorten, jp3.kernels3d.voxel_eval_3d

    def rec_a(*a, **k):
        out = a_fn(*a, **k)
        rec.status.append(np.asarray(out[0]))
        return out

    def rec_v(*a, **k):
        rec.voxel = a
        return v_fn(*a, **k)

    jp3.kernels.interval_shorten = rec_a
    jp3.kernels3d.voxel_eval_3d = rec_v
    try:
        depth, normals, counters = jp3.render3d_rows(
            JTapeData.from_tape(jt), jnp.asarray(mat), SIZE, jnp.int32(0),
            SIZE // 64, True)
    finally:
        jp3.kernels.interval_shorten = a_fn
        jp3.kernels3d.voxel_eval_3d = v_fn
    c = np.asarray(counters)
    assert c[0] <= c[2] and c[1] <= c[3]       # no stage overflowed its cap
    return np.asarray(depth), np.asarray(normals), rec


@pytest.fixture(scope="module")
def jax_frames():
    """name -> (depth, normals[, stages]) from ``mpr_tpu``, rendered on
    first use and kept for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            jt, _, mat = _tapes(name)
            if name == "two_spheres":
                cache[name] = _jax_frame_with_stages(jt, mat)
            else:
                cache[name] = jp3.render3d(jt, mat=mat, size=SIZE)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def port_frames():
    cache = {}

    def get(name):
        if name not in cache:
            _, tt, mat = _tapes(name)
            cache[name] = render3d(tt, mat=mat, size=SIZE, device="cpu")
        return cache[name]
    return get


def _check_normals(depth, normals):
    assert normals.shape == (SIZE, SIZE, 3) and normals.dtype == np.float32
    m = depth > 0
    assert np.allclose(np.linalg.norm(normals[m], axis=-1), 1.0, atol=1e-3)
    assert not normals[~m].any()


@pytest.mark.parametrize("name", JAX_SCENES)
def test_render3d_matches_jax(name, jax_frames, port_frames):
    jt, tt, mat = _tapes(name)
    depth, normals = port_frames(name)
    jdepth, jnormals = jax_frames(name)[:2]
    f = depth_field(oracle.eval_f, jt, mat, SIZE)
    assert_depth(depth, jdepth, tt, f)
    _check_normals(depth, normals)
    same = depth == jdepth
    assert np.allclose(normals[same], jnormals[same], atol=1e-4)
    assert (depth > 0).any() and (depth == 0).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render3d_matches_both_brute_renderers(name, port_frames):
    jt, tt, mat = _tapes(name)
    depth, normals = port_frames(name)
    f = depth_field(oracle.eval_f, jt, mat, SIZE)
    assert_depth(depth, render3d_brute(tt, mat=mat, size=SIZE, device="cpu"),
                 tt, f)
    if name != "building":      # the port's own brute renderer only
        assert_depth(depth, jbrute.render3d_brute(jt, mat=mat, size=SIZE), tt,
                     f)
    _check_normals(depth, normals)
    if name == "empty":
        assert not depth.any() and not normals.any()
    elif name == "all_filled":
        assert (depth == SIZE).all()
    else:
        assert (depth > 0).any() and (depth == 0).any()


def test_sphere_center_faces_the_viewer(port_frames):
    depth, normals = port_frames("sphere")
    c = SIZE // 2
    assert depth[c, c] > 0 and depth[0, 0] == 0
    assert normals[c, c, 2] > 0.9


@pytest.mark.parametrize("name", ["two_spheres", "gyroid"])
def test_without_normals_returns_depth_alone(name, port_frames):
    _, tt, mat = _tapes(name)
    before = tk3.deriv_eval_3d.launches
    depth, none = render3d(tt, mat=mat, size=SIZE, with_normals=False,
                           device="cpu")
    assert none is None and tk3.deriv_eval_3d.launches == before
    assert np.array_equal(depth, port_frames(name)[0])


def test_stage_arrays_match_jax(jax_frames):
    """status0, the parent and cell orders and the per-cell gmeta, tapes and
    run headers, against what the JAX pipeline computed for the same
    frame."""
    jt, tt, mat = _tapes("two_spheres")
    _, _, rec = jax_frames("two_spheres")
    seen = {}
    a_fn, v_fn = tk.interval_shorten, tk3.voxel_eval_3d

    def rec_a(*a, **k):
        out = a_fn(*a, **k)
        seen.setdefault("status", []).append(out[0].numpy())
        return out

    def rec_v(*a, **k):
        seen["voxel"] = a
        return v_fn(*a, **k)

    tk.interval_shorten, tk3.voxel_eval_3d = rec_a, rec_v
    try:
        td = TapeData.from_tape(tt, device="cpu")
        _, _, counts = pipeline3d.render3d_rows(
            td, torch.from_numpy(mat), SIZE, 0, SIZE // 64)
    finally:
        tk.interval_shorten, tk3.voxel_eval_3d = a_fn, v_fn
    n0, n1 = counts["n_amb0"], counts["n_amb1"]
    assert n0 > 0 and n1 > 0
    assert len(seen["status"]) == len(rec.status) == 3
    assert np.array_equal(seen["status"][0], rec.status[0])          # status0
    assert np.array_equal(seen["status"][1], rec.status[1][:n0 * 64])
    assert np.array_equal(seen["status"][2], rec.status[2])       # columns
    jv = [np.asarray(v) if not isinstance(v, tuple) else v for v in rec.voxel]
    pv = [v.numpy() if isinstance(v, torch.Tensor) else v
          for v in seen["voxel"]]
    assert int(jv[0][0]) == n1                       # nmeta[0] = n_amb1
    assert np.array_equal(pv[0], jv[0])              # nmeta
    assert np.array_equal(pv[1], jv[1][:n1])         # order1
    assert np.array_equal(pv[2], jv[2][:n0])         # parents
    assert pv[7] == jv[7]                            # branch_ops
    gmeta, jgmeta = pv[11], jv[11][:n1]
    assert np.array_equal(gmeta[:, :3], jgmeta[:, :3])
    for r in range(n1):
        n, nr = gmeta[r, 0], gmeta[r, 1]
        assert np.array_equal(pv[8][r, :n], jv[8][r, :n]), r       # tw
        assert np.array_equal(pv[9][r, :n].view(np.int32),
                              jv[9][r, :n].view(np.int32)), r      # ti
        assert np.array_equal(pv[10][r, :nr], jv[10][r, :nr]), r   # runs


def test_slab_is_a_crop_of_the_frame(port_frames):
    """Rows [row0, row0 + n_rows) of screen tiles (how a sharded frame
    splits) render as the crop of the whole frame."""
    _, tt, mat = _tapes("two_spheres")
    depth, normals = port_frames("two_spheres")
    td = TapeData.from_tape(tt, device="cpu")
    d, n, counts = pipeline3d.render3d_rows(td, torch.from_numpy(mat), SIZE,
                                            1, 1)
    assert np.array_equal(d.numpy(), depth[64:128])
    assert np.array_equal(n.numpy(), normals[64:128])
    assert counts["n_act"] > 0


def test_normals_match_autograd_of_the_plain_interpreter(port_frames):
    """Kernel D's direction equals autograd of eval_scan.eval_f at the same
    sample point, one voxel in front of the surface."""
    _, tt, mat = _tapes("gyroid")
    depth, normals = port_frames("gyroid")
    ys, xs = np.nonzero(depth)
    sel = np.random.default_rng(7).choice(len(ys), 256, replace=False)
    ys, xs = ys[sel], xs[sel]
    zi = np.minimum(depth[ys, xs], SIZE - 1)
    w = [torch.from_numpy(((v + 0.5) / SIZE * 2.0 - 1.0).astype(np.float32))
         for v in (xs, ys, zi)]
    p = torch.stack(camera.transform3(torch.from_numpy(mat), *w))
    p.requires_grad_(True)
    td = TapeData.from_tape(tt, device="cpu")
    eval_scan.eval_f(td, p[0], p[1], p[2]).sum().backward()
    g = p.grad.numpy().T
    g = g / np.linalg.norm(g, axis=1, keepdims=True)
    assert np.allclose(g, normals[ys, xs], atol=1e-3)


def test_no_device_and_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    tt = mpr_tpu_torch.compile_tree(shapes.sphere(0.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render3d(tt, size=64)


def test_3d_path_imports_neither_jax_nor_mpr_tpu():
    code = ("import sys, mpr_tpu_torch\n"
            "from mpr_tpu_torch.frontend import shapes\n"
            "from mpr_tpu_torch.ops import kernels3d, eval_scan\n"
            "from mpr_tpu_torch.render import (camera, render3d, "
            "render3d_brute, render3d_heatmap)\n"
            "t = mpr_tpu_torch.compile_tree(shapes.two_spheres())\n"
            "m = camera.gui3d_view()\n"
            "d, n = render3d(t, mat=m, size=64, device='cpu')\n"
            "assert (d == render3d_brute(t, mat=m, size=64, "
            "device='cpu')).all() and d.any()\n"
            "render3d_heatmap(t, mat=m, size=64, device='cpu')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mpr_tpu' "
            "or m.startswith('mpr_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
