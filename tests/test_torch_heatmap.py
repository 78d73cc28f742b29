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


def _brute_heat3d(tape, size):
    """The 3D heatmap under the identity camera counted independently of
    the port's pipeline: every 64^3 tile and every child of every ambiguous
    tile classified by the NumPy oracle's interval interpreter, a child's
    tape length taken from the oracle's own mark-and-sweep.  Returns (heat
    (size, size) float64, ambiguous tiles, ambiguous children)."""
    from mpr_tpu_torch import oracle
    n = size // 64
    T = float(tape.length)
    cap = 256 // 2                  # the tape's capacity bucket, halved

    def boxes(k, ix, iy, iz):
        lo = lambda i: (-1.0 + 2.0 * i / k).astype(np.float32)
        return (lo(ix), lo(ix + 1), lo(iy), lo(iy + 1), lo(iz), lo(iz + 1))

    t = np.arange(n ** 3)
    tx, ty, tz = t % n, (t // n) % n, t // (n * n)
    lo, hi, _ = oracle.eval_i(tape, *boxes(n, tx, ty, tz))
    amb0 = ~(lo > 0) & ~(hi < 0)
    heat = np.full((size, size), n * T / 4096.0)
    heat16 = np.zeros((4 * n, 4 * n))
    n_children = 0
    for p in np.flatnonzero(amb0):
        heat[ty[p] * 64:(ty[p] + 1) * 64, tx[p] * 64:(tx[p] + 1) * 64] += \
            64.0 * T / 256.0 / 16.0
        c = np.arange(64)
        cx = tx[p] * 4 + c % 4
        cy = ty[p] * 4 + (c // 4) % 4
        cz = tz[p] * 4 + c // 16
        lo, hi, ch = oracle.eval_i(tape, *boxes(4 * n, cx, cy, cz))
        for k in np.flatnonzero(~(lo > 0) & ~(hi < 0)):
            ln = oracle.shorten(tape, ch[:, k]).length
            heat16[cy[k], cx[k]] += 16.0 * (T if ln > cap else ln)
            n_children += 1
    heat += np.repeat(np.repeat(heat16, 16, 0), 16, 1)
    return heat / T, int(amb0.sum()), n_children


def test_heatmap3d_past_the_static_tile_capacity():
    """A frame with more ambiguous 64^3 tiles than ``mpr_tpu`` holds.

    ``mpr_tpu.render.pipeline3d._caps`` allows min(n^3, max(64, p0_scale *
    n^2)) ambiguous tiles, which is every tile up to 512^3 at the default
    ``p0_scale`` of 8; the smallest frame that can exceed it is 512^3 with
    ``p0_scale`` 1 (64 of 512 tiles).  There the JAX heatmap drops the
    children of every ambiguous tile past the 64th (it has no retry); the
    port sizes the child stage from the count and is held to a count made
    independently of its pipeline."""
    from mpr_tpu import config as jconfig
    from mpr_tpu.render import pipeline3d as jp3d
    size = 512
    tt = mpr_tpu_torch.compile_tree(shapes.sphere(0.8))
    got = render3d_heatmap(tt, size=size, device="cpu")
    want, n_amb0, n_children = _brute_heat3d(tt, size)
    # the capacities are read while the frame is traced and are no part of
    # the jit's cache key: trace anew under each config
    jheat._heatmap3d_jit.clear_cache()
    with jconfig.override(p0_scale=1):
        p0_cap, _ = jp3d._caps(size // 64)
        jax_heat = jheat.render3d_heatmap(
            mpr_tpu.compile_tree(jshapes.sphere(0.8)), size=size)
    jheat._heatmap3d_jit.clear_cache()
    print(f"ambiguous tiles {n_amb0} (capacity {p0_cap}), ambiguous "
          f"children {n_children}; heat summed over the image: port "
          f"{got.sum(dtype=np.float64):.1f}, independent count "
          f"{want.sum():.1f}, mpr_tpu {jax_heat.sum(dtype=np.float64):.1f}")
    assert p0_cap == 64 < n_amb0
    assert np.allclose(got, want, rtol=RTOL, atol=0.0)
    # mpr_tpu agrees wherever it counted, and counted less in all
    assert (jax_heat <= got * (1 + RTOL)).all()
    assert jax_heat.sum(dtype=np.float64) < 0.9 * got.sum(dtype=np.float64)
    # at the default capacity (all 512 tiles) the two packages agree
    full = jheat.render3d_heatmap(mpr_tpu.compile_tree(jshapes.sphere(0.8)),
                                  size=size)
    assert np.allclose(got, full, rtol=RTOL, atol=0.0)
