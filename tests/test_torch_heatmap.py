"""PyTorch port: the work heatmaps on the CPU against ``mpr_tpu.render.heatmap``.

The heatmaps are clause counts from kernel A's status and codes, summed per
pixel and divided by the tape length.  Every partial sum is the tape length
times a dyadic fraction or a small integer, exact in float32, so the order
of the additions is no part of the result.  The last step is not: the port
divides by the length, and XLA turns the division by that constant into a
multiplication by its rounded reciprocal, a second rounding.  So the images
are held to ``rtol 1e-6`` (an ulp is 1.2e-7 of the value), and must be
equal where the length is a power of two.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import mpr_tpu
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.render import heatmap as jheat

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.render import camera, render2d_heatmap, render3d_heatmap

from torch_port_cases import one_torch_thread  # noqa: F401

RTOL = 1e-6
CAMERA2 = camera.scale2(0.7) @ np.array(
    [[0.9, -0.2, 0.05], [0.2, 0.9, -0.1], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("name", ["stress40", "circle", "circle_camera"])
def test_heatmap2d_matches_jax(name):
    make = ((lambda S: S.stress_2d(40)) if name == "stress40"
            else (lambda S: S.circle(0.6, 0.1, -0.2)))
    mat = CAMERA2 if name == "circle_camera" else None
    tt = mpr_tpu_torch.compile_tree(make(shapes))
    got = render2d_heatmap(tt, mat=mat, z=0.1, size=256, device="cpu")
    want = jheat.render2d_heatmap(mpr_tpu.compile_tree(make(jshapes)),
                                  mat=mat, z=0.1, size=256)
    assert got.shape == (256, 256) and got.dtype == np.float32
    assert np.allclose(got, want, rtol=RTOL, atol=0.0)
    # every pixel pays the amortized interval stage
    assert got.min() >= 1.0 / (64 * 64) - 1e-9
    if name == "stress40":
        # at 256^2 every tile is ambiguous and keeps more than the
        # Tcap/8 clauses a tile may: all pay the full tape again
        assert (got > 1.0).all()
    else:
        assert got.max() > 10 * got.min()


@pytest.mark.parametrize("name,mat", [("two_spheres", None),
                                      ("two_spheres", camera.gui3d_view()),
                                      ("sphere", camera.bench3d_view())])
def test_heatmap3d_matches_jax(name, mat):
    make = ((lambda S: S.two_spheres()) if name == "two_spheres"
            else (lambda S: S.sphere(0.6)))
    tt = mpr_tpu_torch.compile_tree(make(shapes))
    got = render3d_heatmap(tt, mat=mat, size=128, device="cpu")
    want = jheat.render3d_heatmap(mpr_tpu.compile_tree(make(jshapes)),
                                  mat=mat, size=128)
    assert got.shape == (128, 128) and got.dtype == np.float32
    assert np.allclose(got, want, rtol=RTOL, atol=0.0)
    assert got.max() > 4 * got.min() > 0


def test_heatmap3d_of_an_empty_frame_is_the_interval_stage():
    """No ambiguous tile: only stage A's amortized cost, and no child
    stage is run."""
    tt = mpr_tpu_torch.compile_tree(shapes.sphere(0.5, 9.0, 9.0, 9.0))
    got = render3d_heatmap(tt, size=128, device="cpu")
    assert np.array_equal(got, np.full((128, 128), 2.0 / (64 * 64),
                                       np.float32))


def test_heatmaps_need_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    tt = mpr_tpu_torch.compile_tree(shapes.sphere(0.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render2d_heatmap(tt, size=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render3d_heatmap(tt, size=128)
