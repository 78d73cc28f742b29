"""PyTorch port: the whole 2D interpreter render on the CPU.

``mpr_tpu_torch.render.render2d(..., device="cpu")`` runs every stage with
the kernels' plain PyTorch versions and must equal the JAX package's
render and the NumPy oracle.  Images must be equal; for tapes whose float
pass runs sin, cos, exp or log a pixel may differ where the oracle's
|f| <= FILL_BAND (torch and numpy round those functions differently by an
ulp), and each test counts such pixels.  Also here: the port's isolation
from JAX and ``mpr_tpu``, and its refusal to fall back to the CPU.
"""

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import mpr_tpu
from mpr_tpu import oracle
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.render import pipeline2d as jp2d

import mpr_tpu_torch
from mpr_tpu_torch import config
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.render import camera, pipeline2d, render2d
from mpr_tpu_torch.tape.opcodes import Op

from torch_port_cases import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
FILL_BAND = 1e-5
_TRANSCENDENTAL = {int(Op.SIN_LHS), int(Op.COS_LHS), int(Op.EXP_LHS),
                   int(Op.LOG_LHS)}
CAMERA = camera.scale2(0.7) @ np.array(
    [[0.9, -0.2, 0.05], [0.2, 0.9, -0.1], [0, 0, 1]], np.float32)


def _field(tape, size, mat=None, z=0.0):
    """The oracle's f at every pixel center (tests/test_pipeline2d.py)."""
    xs = camera.pixel_centers(size)
    X, Y = np.meshgrid(xs, xs)
    if mat is not None:
        w = mat[2, 0] * X + mat[2, 1] * Y + mat[2, 2]
        Xp = (mat[0, 0] * X + mat[0, 1] * Y + mat[0, 2]) / w
        Yp = (mat[1, 0] * X + mat[1, 1] * Y + mat[1, 2]) / w
        X, Y = Xp, Yp
    return oracle.eval_f(tape, X, Y, np.full_like(X, z))


def _assert_image(img, want, tape, f):
    assert img.shape == want.shape and img.dtype == np.bool_
    diff = img != want
    if set(np.unique(tape.ops).tolist()) & _TRANSCENDENTAL:
        band = np.abs(f) <= FILL_BAND
        assert not (diff & ~band).any(), int((diff & ~band).sum())
        assert diff.sum() <= band.sum()
    else:
        assert not diff.any(), f"{int(diff.sum())} pixels differ"


ORACLE_CASES = {
    "circle": (lambda S: S.circle(0.8), 256),
    "small_circle": (lambda S: S.circle(0.4), 256),
    "all_filled": (lambda S: S.circle(9.0), 128),
    "all_empty": (lambda S: S.circle(0.9, 9.0, 9.0), 128),
    "stress600": (lambda S: S.stress_2d(600), 256),
    # 1024^2 has n_side = 16: the only size taking the cap = Tcap // 8
    # branch of render_tile_block
    "circle_1024": (lambda S: S.circle(0.8), 1024),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_render2d_matches_oracle(name):
    make, size = ORACLE_CASES[name]
    tape = mpr_tpu_torch.compile_tree(make(shapes))
    img = render2d(tape, size=size, device="cpu")
    f = _field(mpr_tpu.compile_tree(make(jshapes)), size)
    _assert_image(img, f < 0, tape, f)
    if name == "all_filled":
        assert img.all()
    if name == "all_empty":
        assert not img.any()


@pytest.mark.parametrize("name", ["stress40", "camera"])
def test_render2d_matches_jax(name):
    """Against mpr_tpu.render2d itself (Pallas in interpret mode)."""
    if name == "stress40":
        make, mat = (lambda S: S.stress_2d(40)), None
    else:
        make, mat = (lambda S: S.circle(0.5, 0.2, 0.1)), CAMERA
    jt = mpr_tpu.compile_tree(make(jshapes))
    want = jp2d.render2d(jt, mat=mat, size=256)
    tape = mpr_tpu_torch.compile_tree(make(shapes))
    img = render2d(tape, mat=mat, size=256, device="cpu")
    _assert_image(img, want, tape, _field(jt, 256, mat=mat))


def test_render2d_widened_matches_oracle():
    """widen_intervals only moves tiles from decided to ambiguous, so the
    image stays exact."""
    make = lambda S: S.union(S.circle(0.52, cx=-0.2),  # noqa: E731
                             S.circle(0.33, cx=0.35, cy=0.25))
    tape = mpr_tpu_torch.compile_tree(make(shapes))
    with config.override(widen_intervals=True):
        img = render2d(tape, size=128, device="cpu")
    f = _field(mpr_tpu.compile_tree(make(jshapes)), 128)
    _assert_image(img, f < 0, tape, f)


def test_tile_boxes_and_pixel_coords_match_jax():
    import jax.numpy as jnp
    mat, z = CAMERA, 0.25
    for n_side in (4, 16):
        want_b = np.asarray(jp2d._tile_boxes_2d(n_side, jnp.asarray(mat),
                                                jnp.float32(z)))
        want_c = np.asarray(jp2d._pixel_coords_2d(n_side, jnp.asarray(mat),
                                                  jnp.float32(z)))
        got_b = pipeline2d._tile_boxes_2d(n_side, torch.from_numpy(mat),
                                          torch.tensor(z))
        got_c = pipeline2d._pixel_coords_2d(n_side, torch.from_numpy(mat),
                                            torch.tensor(z))
        assert np.array_equal(got_b.numpy(), want_b)
        assert np.array_equal(got_c.numpy(), want_c)


def test_tile_block_is_a_crop_of_the_frame():
    """A block of tiles (how a sharded frame splits) renders as the crop
    of the whole frame, with the same tile statuses."""
    from mpr_tpu_torch.ops.tape_data import TapeData
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.3, 0.1, -0.2))
    td = TapeData.from_tape(tape, device="cpu")
    eye, z = torch.from_numpy(CAMERA), torch.tensor(0.0)
    full, st = pipeline2d.render_tile_block(td, eye, z, 512)
    blk, bst = pipeline2d.render_tile_block(td, eye, z, 512, row0=2,
                                            n_rows=3, col0=1, n_cols=5)
    assert torch.equal(blk, full[2 * 64:5 * 64, 64:6 * 64])
    assert torch.equal(bst, st.reshape(8, 8)[2:5, 1:6].reshape(-1))
    assert blk.any() and not blk.all()


def test_edited_tapes_render_with_no_build():
    """Tapes of other lengths and op sets render through the same code:
    the kernels read the tape at run time, so no edit ever builds (here
    on the CPU nothing builds at all)."""
    from mpr_tpu_torch.utils.trace import COUNTS
    before = COUNTS["builds.compile"], COUNTS["builds.load"]
    for t in (shapes.circle(0.7),
              shapes.union(shapes.circle(0.5, cx=-0.3),
                           shapes.rectangle(0.1, 0.6, -0.2, 0.4))):
        tape = mpr_tpu_torch.compile_tree(t)
        f = _field(tape, 128)
        _assert_image(render2d(tape, size=128, device="cpu"), f < 0, tape, f)
    assert (COUNTS["builds.compile"], COUNTS["builds.load"]) == before


def test_no_device_and_no_card_raises():
    """Entry points run on cuda by default and never fall back quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render2d(tape, size=64)


def test_port_imports_neither_jax_nor_mpr_tpu():
    # every module of the port, the command line, the viewer, the native
    # tape compiler and the copied frontends included; importing them
    # starts no thread and touches no card
    code = ("import importlib, pkgutil, sys, threading, mpr_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "mpr_tpu_torch.__path__, 'mpr_tpu_torch.')]\n"
            "assert 'mpr_tpu_torch.cli' in mods and len(mods) > 30, mods\n"
            "assert 'mpr_tpu_torch.viewer' in mods, mods\n"
            "assert 'mpr_tpu_torch.native' in mods, mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "import mpr_tpu_torch.viewer, mpr_tpu_torch.native, torch\n"
            "assert threading.active_count() == 1, threading.enumerate()\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mpr_tpu' "
            "or m.startswith('mpr_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax():
    """No code token of the port, of chip_smoke.py, chip_frames.py or
    chip_phases.py names ``jax`` or ``mpr_tpu`` (comments and docstrings
    may cite the JAX kernels a port replaces)."""
    import io
    import tokenize
    files = sorted((REPO / "mpr_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_frames.py",
        REPO / "chip_phases.py"]
    assert len(files) > 10
    assert REPO / "mpr_tpu_torch" / "viewer.py" in files
    assert REPO / "mpr_tpu_torch" / "native" / "__init__.py" in files
    for p in files:
        toks = tokenize.generate_tokens(io.StringIO(p.read_text()).readline)
        names = {t.string for t in toks if t.type == tokenize.NAME}
        assert not names & {"jax", "jnp", "mpr_tpu"}, p
