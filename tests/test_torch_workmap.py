"""PyTorch port: the unrolled engine's work maps against ``mpr_tpu``'s.

``mpr_tpu_torch.render.workmap.workmap2d`` / ``workmap3d`` (the interval
evaluator's plain version on the CPU) are held against
``mpr_tpu.render.workmap``'s on the same shapes and cameras.  The heat
images are sums of dyadic fractions (1/4096, 1/64, 1/4, 4, 16, n/4096 and
ones), exact in float32, so they must be equal.  Of the totals, the
clause count, the stage counts and the attributable work must be equal;
the port sizes each stage by its exact count, so the work it executes is
the work attributed (no padding lanes), where ``mpr_tpu`` pads its stages
to static capacities.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.render import workmap as jwork
from mpr_tpu.tape.tape import compile_tree as jcompile

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.render import camera, unrolled, workmap

from torch_port_cases import one_torch_thread  # noqa: F401

W2 = {"circle": (lambda S: S.circle(0.7), None, 256),
      "stress12": (lambda S: S.stress_2d(12), None, 128),
      "ring_scaled": (lambda S: S.ring(0.8, 0.4), camera.scale2(1.2), 128)}


@pytest.mark.parametrize("name", sorted(W2))
def test_workmap2d_matches_jax(name):
    build, mat, size = W2[name]
    heat, totals = workmap.workmap2d(mpr_tpu_torch.compile_tree(
        build(shapes)), mat=mat, size=size, device="cpu")
    jheat, jtotals = jwork.workmap2d(jcompile(build(jshapes)), mat=mat,
                                     size=size)
    assert heat.shape == (size, size) and heat.dtype == np.float32
    assert np.array_equal(heat, np.asarray(jheat))
    for k in ("clauses", "attributable_evals"):
        assert totals[k] == jtotals[k], k
    assert totals["stage_lanes"]["64px"] == jtotals["stage_lanes"]["64px"]
    assert totals["executed_evals"] == totals["attributable_evals"]
    assert totals["padding_evals"] == 0


W3 = {"spheres": (lambda S: S.union(S.sphere(0.6, cx=-0.2),
                                    S.sphere(0.4, cx=0.5, cy=0.3)),
                  camera.bench3d_view()),
      "gyroid": (lambda S: S.intersection(S.gyroid(0.4, 0.08),
                                          S.sphere(0.85)),
                 camera.gui3d_view())}


@pytest.mark.parametrize("name", sorted(W3))
def test_workmap3d_matches_jax(name):
    build, mat = W3[name]
    size = 128
    heat, totals = workmap.workmap3d(mpr_tpu_torch.compile_tree(
        build(shapes)), mat=mat, size=size, device="cpu")
    jheat, jtotals = jwork.workmap3d(jcompile(build(jshapes)), mat=mat,
                                     size=size)
    assert heat.shape == (size, size)
    assert np.array_equal(heat, np.asarray(jheat))
    for k in ("clauses", "skip4", "counts", "attributable_evals"):
        assert totals[k] == jtotals[k], k
    assert totals["executed_evals"] == totals["attributable_evals"]


@pytest.mark.parametrize("skip4", [False, True], ids=["full", "skip4"])
def test_workmap3d_interval_stages_match_jax(skip4):
    """The 3D map's interval stages, with the 4^3 stage and without it
    (skip4: the surviving 16^3 cells cost 16 a pixel and no 4^3 stage
    runs), against mpr_tpu's ``_workmap3d_impl`` at capacities that hold
    every cell."""
    import jax.numpy as jnp
    from mpr_tpu.ops import unrolled_eval as jue
    size, n = 128, 2
    mat = camera.gui3d_view()
    build = W3["spheres"][0]
    r = unrolled.UnrolledRenderer(mpr_tpu_torch.compile_tree(build(shapes)))
    heat, counts = workmap._workmap3d_heat(r.fi, torch.as_tensor(mat), size,
                                           skip4, None)
    jheat, jcounts = jwork._workmap3d_impl(
        jue.build_interval(jcompile(build(jshapes))), jnp.asarray(mat), size,
        n ** 3, n ** 3 * 64, n ** 3 * 4096, skip4)
    assert np.array_equal(heat.numpy(), np.asarray(jheat))
    assert counts == tuple(int(c) for c in np.asarray(jcounts))
    assert (counts[2] == 0) == skip4


def test_workmaps_need_a_device_or_a_card():
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.5))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workmap.workmap2d(tape, size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workmap.workmap3d(tape, size=64)
