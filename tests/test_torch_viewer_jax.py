"""PyTorch port: the viewer's 3D modes against the JAX viewer, on the CPU.

``mpr_tpu_torch.viewer.render_scene(..., device="cpu")`` against
``mpr_tpu.viewer.render_scene`` on the same script and camera: the four 3D
modes (heightmap, normals, ssao, shaded) of a two-shape scene, whose depths
composite by the per-pixel maximum with the winning shape's normals, on
both engines.  A JAX 3D frame is dear on the CPU (about a minute at 128^2
in interpret mode), so the JAX viewer renders each engine's frame once:
its ``render3d`` is memoised while it makes the four modes.  So two JAX 3D
frames in all, each at 128^2.

Tolerances.  Heightmap and normals images are equal (8-bit, as the
viewer sends them).  SSAO and shading are within one 8-bit step on at
least 99.9% of the pixels and within ``FAR`` everywhere: AO is a sum of
threshold tests and its blur picks a window by comparing deviations, so a
last-place difference between torch's and XLA's rounding can flip a sample
(1/64) or a window (up to 0.11 at XLA's default optimisation level,
ROADMAP hazard 7; the suite runs XLA at level 0, where tests/
test_torch_effects.py finds no such pixel); 0.05 of the range is 13 steps
after the truncation to 8 bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpr_tpu.render.pipeline3d as jp3
import mpr_tpu.render.unrolled as junrolled
from mpr_tpu import viewer as jviewer

import mpr_tpu_torch
from mpr_tpu_torch import viewer
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.render import unrolled

from torch_port_cases import one_torch_thread  # noqa: F401

CPU = "cpu"
SIZE = 128
MODES = ("heightmap", "normals", "ssao", "shaded")
ENGINES = ("interp", "unrolled")
SHARE = 0.999
FAR = 13
CAM = {"yaw": 0.5, "pitch": -0.9, "persp": 0.3, "scale": 1.0, "panx": 0.0,
       "pany": 0.0}
SCENE = "shapes = [sphere(0.5, -0.3), sphere(0.45, 0.35, 0.1, 0.2)]"

def _memo(fn):
    cache = {}

    def wrapped(tape, mat=None, size=256, *a, **k):
        key = (np.asarray(tape.ops).tobytes(), np.asarray(tape.imms).tobytes(),
               np.asarray(mat).tobytes(), size, a, tuple(sorted(k.items())))
        if key not in cache:
            cache[key] = fn(tape, mat=mat, size=size, *a, **k)
        return cache[key]
    wrapped.cache = cache
    return wrapped


@pytest.fixture(scope="module")
def jax_images():
    """The JAX viewer's image of SCENE in every mode on both engines, each
    engine's shapes rendered once."""
    mp = pytest.MonkeyPatch()
    calls = {"interp": _memo(jp3.render3d),
             "unrolled": _memo(junrolled.render3d)}
    mp.setattr(jp3, "render3d", calls["interp"])
    mp.setattr(junrolled, "render3d", calls["unrolled"])
    try:
        out = {(e, m): jviewer.render_scene(SCENE, CAM, m, SIZE, engine=e)[0]
               for e in ENGINES for m in MODES}
    finally:
        mp.undo()
    assert all(len(c.cache) == 2 for c in calls.values())
    return out


@pytest.fixture(scope="module")
def port_images():
    return {(e, m): viewer.render_scene(SCENE, CAM, m, SIZE, engine=e,
                                        device=CPU)[0]
            for e in ENGINES for m in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ENGINES)
def test_render_scene_3d_matches_jax(jax_images, port_images, engine, mode):
    img, want = port_images[engine, mode], jax_images[engine, mode]
    assert img.shape == want.shape and img.dtype == want.dtype == np.uint8
    assert want.any()
    if mode in ("heightmap", "normals"):
        assert np.array_equal(img, want), int((img != want).sum())
        return
    d = np.abs(img.astype(int) - want.astype(int))
    n_out = int((d > 1).sum())
    print(f"{engine} {mode}: {n_out} pixels more than one step apart, "
          f"largest {int(d.max())}")
    assert n_out <= (1.0 - SHARE) * d.size, n_out
    assert d.max() <= FAR, int(d.max())


def test_composite_takes_the_nearer_shape(port_images):
    """Both shapes show, and the heightmap is the per-pixel maximum of the
    shapes' own heightmaps."""
    shapes_, _ = viewer._eval_src(SCENE)
    mat = torch.as_tensor(viewer.view_matrix(CAM, "heightmap"))
    depths = [viewer.frame3d(mpr_tpu_torch.compile_tree(s), mat, SIZE)[0]
              for s in shapes_]
    assert all(bool((d > 0).any()) for d in depths)
    top = torch.maximum(depths[0], depths[1])
    want = viewer.compose("heightmap", top, torch.zeros(SIZE, SIZE, 3),
                          SIZE).numpy()
    assert np.array_equal(port_images["interp", "heightmap"], want)
    assert (depths[0] > depths[1]).any() and (depths[1] > depths[0]).any()


@pytest.mark.parametrize("mode", ["heightmap", "normals"])
def test_engines_agree(port_images, mode):
    assert np.array_equal(port_images["interp", mode],
                          port_images["unrolled", mode])


@pytest.mark.parametrize("engine", ENGINES)
def test_parametric_sliders_3d(engine):
    """examples/parametric.io: three slider moves, each image equal to a
    fresh render of ``with_params`` of the tree at those values; on the
    unrolled engine no move makes a renderer."""
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "parametric.io"
    src = path.read_text()
    viewer.render_scene(src, CAM, "normals", SIZE, engine=engine,
                        path=str(path), device=CPU)
    n = len(unrolled._RENDERERS)
    (tree,), _ = viewer._eval_src(src, str(path))
    for vv in ({"radius": 0.8}, {"bore-r": 0.15, "tilt": 1.0},
               {"radius": 0.5, "tilt": 0.2}):
        img, _, svars = viewer.render_scene(src, CAM, "normals", SIZE,
                                            engine=engine, path=str(path),
                                            var_values=vv, device=CPU)
        assert all(svars[k][0] == v for k, v in vv.items())
        mat = torch.as_tensor(viewer.view_matrix(CAM, "normals"))
        d, nrm = viewer.frame3d(
            mpr_tpu_torch.compile_tree(T.with_params(tree, vv)), mat, SIZE,
            engine)
        want = viewer.compose("normals", d.to(torch.int32), nrm,
                              SIZE).numpy()
        assert np.array_equal(img, want), vv
    assert len(unrolled._RENDERERS) == n
