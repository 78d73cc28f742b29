"""PyTorch port: the plain tape interpreters and the brute renderers.

``mpr_tpu_torch.ops.eval_scan`` (``eval_f``, ``eval_i``) and
``mpr_tpu_torch.render.brute`` on the CPU against ``mpr_tpu.ops.eval_scan``,
``mpr_tpu.render.brute`` and the NumPy oracle, on the same seeded inputs.

Tolerances.  Tapes without sin, cos, exp or log run the same IEEE float32
operations in all three implementations: their values are held to
``rtol 1e-6, atol 1e-6`` (they are in fact equal) and their images must be
equal.  With those ops torch's CPU kernels round an ulp apart from XLA's
and numpy's: values are held to ``1e-5``, and a pixel may differ only where
the oracle's |f| <= FILL_BAND at the deciding point (counted per test).
Gradients from autograd are held to ``jax.grad`` within atol 1e-5 (rtol
1e-5).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax
import jax.numpy as jnp

import mpr_tpu
from mpr_tpu import oracle
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jtree
from mpr_tpu.ops import eval_scan as jscan
from mpr_tpu.ops.tape_data import TapeData as JTapeData
from mpr_tpu.render import brute as jbrute
from mpr_tpu.tape.tape import Tape as JTape

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as ttree
from mpr_tpu_torch.ops import eval_scan
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import camera, render2d_brute, render3d_brute
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (FILL_BAND, TRANSCENDENTAL_OPS, all_ops_clauses,
                              assert_depth, depth_field,
                              one_torch_thread,  # noqa: F401
                              random_boxes, random_trees)

_JRANDOM = random_trees(jtree, mpr_tpu.compile_tree, 6)
_TRANDOM = random_trees(ttree, mpr_tpu_torch.compile_tree, 6)
NAMES = [f"random{i}" for i in range(6)] + ["all_ops", "stress40"]
CAMERA2 = camera.scale2(0.7) @ np.array(
    [[0.9, -0.2, 0.05], [0.2, 0.9, -0.1], [0, 0, 1]], np.float32)


def _tapes(name):
    """The same model compiled by each package: (mpr_tpu tape, port tape)."""
    if name == "all_ops":
        return JTape(**all_ops_clauses()), Tape.from_arrays(**all_ops_clauses())
    if name == "stress40":
        return (mpr_tpu.compile_tree(jshapes.stress_2d(40)),
                mpr_tpu_torch.compile_tree(shapes.stress_2d(40)))
    i = int(name[len("random"):])
    return (mpr_tpu.compile_tree(_JRANDOM[i]),
            mpr_tpu_torch.compile_tree(_TRANDOM[i]))


def _tol(tape):
    if set(np.unique(tape.ops).tolist()) & TRANSCENDENTAL_OPS:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=1e-6, atol=1e-6)


def _points(seed, n=512):
    return np.random.default_rng(seed).uniform(-1, 1, (3, n)).astype(
        np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_eval_f_matches_jax_and_oracle(name):
    jt, tt = _tapes(name)
    x, y, z = _points(51)
    got = eval_scan.eval_f(TapeData.from_tape(tt, device="cpu"), x, y,
                           z).numpy()
    want = np.asarray(jscan.eval_f(JTapeData.from_tape(jt), x, y, z))
    assert got.shape == want.shape == x.shape
    assert np.allclose(got, want, equal_nan=True, **_tol(tt))
    assert np.allclose(got, oracle.eval_f(jt, x, y, z), equal_nan=True,
                       **_tol(tt))


def test_eval_f_broadcasts_and_defaults_z():
    jt, tt = _tapes("random2")
    td = TapeData.from_tape(tt, device="cpu")
    x = np.linspace(-1, 1, 7, dtype=np.float32)[None, :]
    y = np.linspace(-1, 1, 5, dtype=np.float32)[:, None]
    got = eval_scan.eval_f(td, x, y)
    assert got.shape == (5, 7)
    want = np.asarray(jscan.eval_f(JTapeData.from_tape(jt), x, y))
    assert np.allclose(got.numpy(), want, equal_nan=True, **_tol(tt))


@pytest.mark.parametrize("name", NAMES)
def test_eval_i_matches_jax(name):
    """Bounds within the value tolerance (NaNs in the same lanes), choices
    equal."""
    jt, tt = _tapes(name)
    b = random_boxes(np.random.default_rng(52), 96)
    lo, hi, ch = eval_scan.eval_i(TapeData.from_tape(tt, device="cpu"), *b)
    jlo, jhi, jch = jscan.eval_i(JTapeData.from_tape(jt), *b)
    assert np.allclose(lo.numpy(), np.asarray(jlo), equal_nan=True,
                       **_tol(tt))
    assert np.allclose(hi.numpy(), np.asarray(jhi), equal_nan=True,
                       **_tol(tt))
    assert ch.dtype == torch.int8
    assert np.array_equal(ch.numpy(), np.asarray(jch))


@pytest.mark.parametrize("name", ["random0", "random3", "random5", "stress40",
                                  "gyroid"])
def test_eval_f_autograd_matches_jax_grad(name):
    """d(sum f)/d(x, y, z) and d(sum f)/d(imms) from autograd against
    jax.grad of the JAX interpreter."""
    if name == "gyroid":
        jt = mpr_tpu.compile_tree(jshapes.gyroid(0.4, 0.08))
        tt = mpr_tpu_torch.compile_tree(shapes.gyroid(0.4, 0.08))
    else:
        jt, tt = _tapes(name)
    pts = _points(53, 128)
    jtd = JTapeData.from_tape(jt)

    def f(p, imms):
        return jscan.eval_f(jtd.replace_imms(imms), p[0], p[1], p[2]).sum()

    jgp, jgi = jax.grad(f, argnums=(0, 1))(jnp.asarray(pts), jtd.imms)
    td = TapeData.from_tape(tt, device="cpu")
    p = torch.from_numpy(pts).requires_grad_(True)
    td.imms.requires_grad_(True)
    eval_scan.eval_f(td, p[0], p[1], p[2]).sum().backward()
    assert np.allclose(p.grad.numpy(), np.asarray(jgp), rtol=1e-5, atol=1e-5)
    n = tt.length
    scale = max(1.0, float(np.abs(np.asarray(jgi)).max()))
    assert np.allclose(td.imms.grad.numpy()[:n], np.asarray(jgi)[:n],
                       rtol=1e-5, atol=1e-5 * scale)
    assert np.abs(np.asarray(jgp)).max() > 0


def _assert_fill(img, want, tape, f):
    diff = img != want
    if set(np.unique(tape.ops).tolist()) & TRANSCENDENTAL_OPS:
        band = np.abs(f) <= FILL_BAND
        assert not (diff & ~band).any(), int((diff & ~band).sum())
        assert diff.sum() <= band.sum()
    else:
        assert not diff.any(), f"{int(diff.sum())} pixels differ"


@pytest.mark.parametrize("name,mat", [("random1", None), ("random4", CAMERA2),
                                      ("all_ops", None), ("stress40", CAMERA2)])
def test_render2d_brute_matches_jax_and_oracle(name, mat):
    jt, tt = _tapes(name)
    size, z = 96, 0.25
    img = render2d_brute(tt, mat=mat, z=z, size=size, device="cpu")
    want = jbrute.render2d_brute(jt, mat=mat, z=z, size=size)
    assert img.shape == (size, size) and img.dtype == np.bool_
    p = camera.pixel_centers(size)
    X, Y = np.meshgrid(p, p)
    if mat is not None:
        X, Y = camera.transform2(mat, X, Y)
    f = oracle.eval_f(jt, X, Y, np.full_like(X, z))
    _assert_fill(img, want, tt, f)
    _assert_fill(img, f < 0, tt, f)
    assert img.any() or name != "stress40"


BRUTE3D = {
    "sphere": (lambda S: S.sphere(0.6), None),
    "two_spheres": (lambda S: S.two_spheres(), camera.gui3d_view()),
    "gyroid": (lambda S: S.intersection(S.gyroid(0.4, 0.08), S.sphere(0.85)),
               camera.gui3d_view(0.5, -0.9, 0.3)),
    "menger": (lambda S: S.menger(1), camera.bench3d_view()),
}


@pytest.mark.parametrize("name", sorted(BRUTE3D))
def test_render3d_brute_matches_jax_and_oracle(name):
    make, mat = BRUTE3D[name]
    size = 64
    jt = mpr_tpu.compile_tree(make(jshapes))
    tt = mpr_tpu_torch.compile_tree(make(shapes))
    depth = render3d_brute(tt, mat=mat, size=size, device="cpu")
    f = depth_field(oracle.eval_f, jt, mat, size)
    zidx = np.arange(1, size + 1, dtype=np.int32)
    assert_depth(depth, jbrute.render3d_brute(jt, mat=mat, size=size), tt, f)
    assert_depth(depth, np.where(f < 0, zidx, 0).max(axis=2).astype(np.int32),
                 tt, f)
    assert (depth > 0).any() and (depth == 0).any()


def test_render3d_brute_slabs_do_not_change_the_image(monkeypatch):
    """The volume is evaluated in slabs of rows; the slab size is no part
    of the result."""
    from mpr_tpu_torch.render import brute
    tt = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    mat = camera.gui3d_view()
    whole = render3d_brute(tt, mat=mat, size=64, device="cpu")
    monkeypatch.setattr(brute, "SLAB_VOXELS", 5 * 64 * 64)   # 5 rows a slab
    assert np.array_equal(render3d_brute(tt, mat=mat, size=64, device="cpu"),
                          whole)


def test_brute_renderers_need_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    tt = mpr_tpu_torch.compile_tree(shapes.sphere(0.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render3d_brute(tt, size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render2d_brute(tt, size=64)
