"""PyTorch port: mesh export (mpr_tpu_torch/io/mesh.py) against mpr_tpu's.

The triangle emission is the JAX package's NumPy, copied, so with the
NumPy oracle evaluating the grid on both sides the triangles are equal
exactly.  With the port's own evaluator (the plain version of the
generated float / deriv kernels, on the CPU) against ``use_jax=True``
(the XLA unrolled chain), marching tetrahedra give the same triangles to
1e-5 (measured: equal); dual contouring places each vertex by a
least-squares (QEF) solve on the normals, which turns an ulp of a normal
into up to ~2e-4 of a vertex, the gap mpr_tpu's own oracle and XLA paths
show on the same input, so dc vertices are held to 3e-4 and the
triangle count must be equal.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpr_tpu
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.io import mesh as jmesh

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.io import mesh

from torch_port_cases import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]

SHAPES = {
    "sphere": lambda S: S.sphere(0.6),
    "box": lambda S: S.box(-0.47, 0.51, -0.23, 0.27, -0.49, 0.23),
    "drilled": lambda S: S.difference(S.sphere(0.7),
                                      S.cylinder_z(0.3, -1, 1)),
}
DC_VERTEX_ATOL = 3e-4


def _tapes(name):
    return (mpr_tpu.compile_tree(SHAPES[name](jshapes)),
            mpr_tpu_torch.compile_tree(SHAPES[name](shapes)))


@pytest.fixture(scope="module")
def jax_meshes():
    """mpr_tpu's meshes at n=48, with the oracle and with XLA."""
    out = {}
    for name in SHAPES:
        jt, _ = _tapes(name)
        for method in ("mt", "dc"):
            for use_jax in (False, True):
                out[name, method, use_jax] = jmesh.mesh_tape(
                    jt, n=48, use_jax=use_jax, method=method)
    return out


@pytest.mark.parametrize("method", ["mt", "dc"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_mesh_with_the_oracle_equals_mpr_tpu(jax_meshes, name, method):
    _, pt = _tapes(name)
    got = mesh.mesh_tape(pt, n=48, use_oracle=True, method=method,
                         device="cpu")
    assert np.array_equal(got, jax_meshes[name, method, False])


@pytest.mark.parametrize("method", ["mt", "dc"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_mesh_with_the_port_evaluator_matches_xla(jax_meshes, name, method):
    _, pt = _tapes(name)
    got = mesh.mesh_tape(pt, n=48, use_oracle=False, method=method,
                         device="cpu")
    want = jax_meshes[name, method, True]
    assert got.shape == want.shape
    atol = 1e-5 if method == "mt" else DC_VERTEX_ATOL
    assert np.abs(got - want).max() <= atol


@pytest.mark.parametrize("method", ["mt", "dc"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_mesh_is_watertight_with_positive_volume(name, method):
    _, pt = _tapes(name)
    tris = mesh.mesh_tape(pt, n=48, method=method, device="cpu")
    assert len(tris) > 100
    assert mesh.is_watertight(tris)
    assert mesh.mesh_volume(tris) > 0.0
    assert mesh.mesh_area(tris) > 0.0


def test_sphere_volume_and_area():
    tris = mesh.mesh_tape(mpr_tpu_torch.compile_tree(shapes.sphere(0.6)),
                          n=32, device="cpu")
    want_v, want_a = 4.0 / 3.0 * np.pi * 0.6 ** 3, 4.0 * np.pi * 0.6 ** 2
    assert abs(mesh.mesh_volume(tris) - want_v) / want_v < 0.02
    assert abs(mesh.mesh_area(tris) - want_a) / want_a < 0.02


def test_empty_box_gives_no_triangles():
    tape = mpr_tpu_torch.compile_tree(shapes.sphere(0.1, cx=5.0))
    for method in ("mt", "dc"):
        assert len(mesh.mesh_tape(tape, n=8, method=method,
                                  device="cpu")) == 0


def test_unknown_method_raises():
    tape = mpr_tpu_torch.compile_tree(shapes.sphere(0.5))
    with pytest.raises(ValueError, match="unknown mesh method"):
        mesh.mesh_tape(tape, n=8, method="mc", device="cpu")


def test_stl_and_obj_round_trip(tmp_path):
    tris = mesh.mesh_tape(mpr_tpu_torch.compile_tree(shapes.sphere(0.6)),
                          n=16, device="cpu")
    p = str(tmp_path / "s.stl")
    mesh.write_stl(p, tris)
    assert np.array_equal(mesh.read_stl(p), tris)
    assert np.array_equal(jmesh.read_stl(p), tris)     # mpr_tpu reads it
    q = str(tmp_path / "s.obj")
    mesh.write_obj(q, tris)
    jq = str(tmp_path / "j.obj")
    jmesh.write_obj(jq, tris)
    assert pathlib.Path(q).read_text() == pathlib.Path(jq).read_text()
    lines = pathlib.Path(q).read_text().splitlines()
    verts = np.array([[float(v) for v in ln.split()[1:]]
                      for ln in lines if ln.startswith("v ")])
    faces = np.array([[int(v) - 1 for v in ln.split()[1:]]
                      for ln in lines if ln.startswith("f ")])
    assert len(faces) == len(tris)
    assert np.abs(verts[faces] - tris).max() <= 1e-6


def test_the_oracle_is_never_taken_silently_on_the_card():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not mesh._use_oracle(None, cuda, True)
    assert mesh._use_oracle(None, cpu, True)
    assert not mesh._use_oracle(None, cpu, False)
    assert mesh._use_oracle(True, cuda, False)


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    tape = mpr_tpu_torch.compile_tree(shapes.sphere(0.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.mesh_tape(tape, n=8)


@pytest.mark.parametrize("method,out", [("mt", "m.stl"), ("dc", "m.obj")])
def test_mesh_cli(tmp_path, method, out):
    scene = tmp_path / "scene.io"
    scene.write_text("(set-bounds! [-1 -1 -1] [1 1 1])\n"
                     "(sphere 0.6 [0.1 0 0])\n")
    path = tmp_path / out
    r = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.cli", "mesh",
                        str(scene), "--size", "24", "--method", method,
                        "--out", str(path), "--device", "cpu"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "using script bounds" in r.stderr
    assert r.stdout.startswith("mesh: ") and "volume" in r.stdout
    tris = (mesh.read_stl(str(path)) if out.endswith(".stl") else None)
    if tris is not None:
        assert mesh.is_watertight(tris) and mesh.mesh_volume(tris) > 0
    else:
        assert path.read_text().startswith("# mpr_tpu mesh")
