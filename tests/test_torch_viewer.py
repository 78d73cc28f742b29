"""PyTorch port: the interactive viewer (mpr_tpu_torch/viewer.py) on the CPU.

The cases of tests/test_viewer.py, run on the port with ``device="cpu"``
(script eval, camera matrix assembly, the HTTP surface: editor POST,
orbit/zoom POST, frame GET), then the port's 2D ``render_scene`` on both
engines held against ``mpr_tpu.viewer.render_scene`` on the same script and
camera, and the device contract (``cuda`` by default, an error without a
card, never a silent CPU fallback).  The JAX frames here are the JAX
viewer's unrolled engine (seconds each on the CPU), and its interpreter
engine (about half a minute a 2D frame in interpret mode) for two scripts.
The 3D modes are in tests/test_torch_viewer_jax.py, so that neither file
holds a test worker for more than about three minutes.

Tolerance (2D).  Images are equal, except that for a tape whose float pass
runs sin, cos, exp or log a pixel may differ where the oracle's
|f| <= FILL_BAND (torch's CPU kernels round those functions an ulp apart
from XLA's; ROADMAP hazard 9); each comparison counts such pixels.
"""

import http.client
import http.server
import json
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpr_tpu
from mpr_tpu import oracle
from mpr_tpu import viewer as jviewer

import mpr_tpu_torch
from mpr_tpu_torch import viewer
from mpr_tpu_torch.io.png import decode_png
from mpr_tpu_torch.render import camera, unrolled
from mpr_tpu_torch.tape.opcodes import Op

from torch_port_cases import one_torch_thread  # noqa: F401

CPU = "cpu"
FILL_BAND = 1e-5
_TRANSCENDENTAL = {int(Op.SIN_LHS), int(Op.COS_LHS), int(Op.EXP_LHS),
                   int(Op.LOG_LHS)}

SCRIPT = """
SIZE = 128
MODE = "heightmap"
VIEW = (0.5, -0.9, 0.3)
shape = sphere(0.6)
"""

IO_SCRIPT = """
;; a Scheme scene (the reference GUI's .io format)
(sequence (circle 0.5)
  (move [0.2 0])
  (difference (circle 0.2)))
"""

CAM0 = {"yaw": 0, "pitch": 0, "persp": 0, "scale": 1.0, "panx": 0,
        "pany": 0}


# ---- the cases of tests/test_viewer.py ------------------------------------

def test_eval_src_and_settings():
    shapes_, st = viewer._eval_src(SCRIPT)
    assert len(shapes_) == 1
    assert st["size"] == 128 and st["mode"] == "heightmap"


def test_view_matrix_modes():
    cam = {"yaw": 0.0, "pitch": 0.0, "persp": 0.25, "scale": 2.0,
           "panx": 0.1, "pany": -0.2}
    m2 = viewer.view_matrix(cam, "2d")
    assert m2.shape == (3, 3) and m2[0, 0] == 2.0 and m2[0, 2] == \
        np.float32(0.1)
    m3 = viewer.view_matrix(cam, "shaded")
    assert m3.shape == (4, 4)
    assert m3[0, 0] == 2.0                      # scale on the rotation
    assert m3[3, 2] == np.float32(0.25 * 2.0)   # perspective row
    for mode in ("2d", "shaded"):
        assert np.array_equal(m2 if mode == "2d" else m3,
                              jviewer.view_matrix(cam, mode))


def test_render_scene_2d_and_3d():
    img, ms, _ = viewer.render_scene("shape = circle(0.5)", CAM0, "2d", 128,
                                     device=CPU)
    assert img.shape == (128, 128) and img.max() == 255
    assert img.dtype == np.uint8 and ms > 0
    img3, _, _ = viewer.render_scene(SCRIPT, {"yaw": 0.5, "pitch": -0.9,
                                              "persp": 0.3, "scale": 1.0,
                                              "panx": 0, "pany": 0},
                                     "heightmap", 128, device=CPU)
    assert img3.shape == (128, 128) and img3.max() > 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Client:
    def __init__(self, port, state=None):
        self.port, self.state = port, state

    def get(self, p):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        c.request("GET", p)
        r = c.getresponse()
        return r.status, r.read()

    def post(self, body):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
        c.request("POST", "/update", json.dumps(body))
        r = c.getresponse()
        return r.status, json.loads(r.read())

    def wait_seq(self, min_seq, timeout=120):
        for _ in range(int(timeout / 0.2)):
            try:
                st = json.loads(self.get("/status")[1])
            except OSError:
                st = None
            if (st is not None and st["seq"] >= min_seq
                    and (self.state is None
                         or not self.state.dirty.is_set())):
                return st
            time.sleep(0.2)
        raise AssertionError("render did not complete")


def test_http_surface(tmp_path):
    """Full interactive loop over HTTP: load page, edit script, orbit,
    zoom, read back frames and status; the frame decodes to the pixels
    of render_scene at the same settings."""
    path = tmp_path / "scene.py"
    path.write_text(SCRIPT)
    state = viewer.ViewerState(device=CPU)
    state.path = str(path)
    state.src = SCRIPT
    _, settings = viewer._eval_src(SCRIPT)
    viewer._apply_script_settings(state, settings)
    worker = threading.Thread(target=viewer._render_worker, args=(state,),
                              daemon=True)
    worker.start()
    state.dirty.set()
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), viewer.make_handler(state))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    cl = _Client(port, state)

    st = cl.wait_seq(1)
    assert st["error"] == "" and st["device"] == "cpu"
    status, page = cl.get("/")
    assert status == 200 and b"textarea" in page
    assert cl.get("/script")[1].decode() == SCRIPT
    status, png = cl.get("/frame.png")
    assert status == 200 and png[:4] == b"\x89PNG"
    want, _, _ = viewer.render_scene(SCRIPT, st["cam"], st["mode"],
                                     st["size"], st["engine"], str(path),
                                     device=CPU)
    assert np.array_equal(decode_png(png), want)

    # orbit + zoom update the camera and trigger a re-render
    yaw0 = st["cam"]["yaw"]
    assert cl.post({"orbit": [30, 0]})[0] == 200
    assert cl.post({"zoom": 1.1})[0] == 200
    st = cl.wait_seq(st["seq"] + 1)
    assert st["cam"]["yaw"] == pytest.approx(yaw0 + 0.3)
    assert st["cam"]["scale"] == pytest.approx(1.1)

    # editor edit: a broken script reports an error without crashing,
    # a fixed one recovers
    assert cl.post({"script": "shape = undefined_fn(1)"})[0] == 200
    st = cl.wait_seq(st["seq"] + 1)
    assert "NameError" in st["error"]
    assert cl.post({"script": "shape = sphere(0.4)", "save": True})[0] == 200
    st = cl.wait_seq(st["seq"] + 1)
    assert st["error"] == ""
    assert "sphere(0.4)" in path.read_text()   # Save wrote the file

    # .frep save: serialize the scene's shapes next to the script
    # (gui/main.cpp:394-403 analog) and round-trip through the loader
    saved = cl.post({"save_frep": True})[1]["saved_frep"]
    assert saved == str(tmp_path / "scene.frep")
    from mpr_tpu_torch import oracle as toracle
    from mpr_tpu_torch.frontend import frep
    (shape,) = frep.load(saved)
    t = mpr_tpu_torch.compile_tree(shape.tree)
    # sphere(0.4): inside at origin, outside at (0.5, 0, 0)
    v = toracle.eval_f(t, np.float32([0.0, 0.5]), np.float32([0.0, 0.0]),
                       np.float32([0.0, 0.0]))
    assert v[0] < 0 < v[1]
    httpd.shutdown()
    state.stop.set()
    state.dirty.set()
    worker.join(timeout=60)
    assert not worker.is_alive()


def test_render_scene_engine_toggle():
    """engine="unrolled" routes through the unrolled engine and produces
    the identical image; ENGINE in the script sets the initial state."""
    img_i, _, _ = viewer.render_scene("shape = circle(0.5)", CAM0, "2d", 128,
                                      engine="interp", device=CPU)
    img_u, _, _ = viewer.render_scene("shape = circle(0.5)", CAM0, "2d", 128,
                                      engine="unrolled", device=CPU)
    assert (img_i == img_u).all()

    state = viewer.ViewerState()
    _, st = viewer._eval_src("ENGINE = 'unrolled'\nshape = circle(0.5)")
    viewer._apply_script_settings(state, st)
    assert state.engine == "unrolled"


def test_open_frep_directly(tmp_path):
    """The viewer opens archives: a generated editing script loads the
    shapes, mode picks 2d/normals by z usage, and the one-shot render
    path accepts the archive."""
    from mpr_tpu_torch.frontend import frep, shapes
    p2 = tmp_path / "disc.frep"
    frep.dump([frep.ArchiveShape(tree=shapes.circle(0.5))], str(p2))
    src = viewer._script_for_frep(str(p2))
    shapes_, st = viewer._eval_src(src)
    assert len(shapes_) == 1 and st["mode"] == "2d"
    img, _, _ = viewer.render_script(str(p2), device=CPU)
    assert img.max() == 255

    p3 = tmp_path / "ball.frep"
    frep.dump([frep.ArchiveShape(tree=shapes.sphere(0.6))], str(p3))
    assert "MODE = 'normals'" in viewer._script_for_frep(str(p3))


def test_eval_src_scheme_dispatch():
    """Scheme sources are detected and evaluated by frontend/scheme.py;
    Python sources still go through exec."""
    shapes_, st = viewer._eval_src(IO_SCRIPT)
    assert len(shapes_) == 1
    assert viewer._is_scheme_src(IO_SCRIPT)
    assert not viewer._is_scheme_src(SCRIPT)


def test_render_scene_scheme_2d():
    img, _, _ = viewer.render_scene(IO_SCRIPT, CAM0, "2d", 128, device=CPU)
    assert img.shape == (128, 128) and img.max() == 255
    # the 0.2-radius hole at the origin is empty
    assert img[64, 70] == 0


def test_scheme_scene_auto_2d_mode():
    shapes_, st = viewer._eval_src("(circle 0.4)")
    assert st["mode"] == "2d"
    shapes_, st = viewer._eval_src("(sphere 0.4)")
    assert st["mode"] is None          # 3D scene keeps the default


def test_save_stl(tmp_path):
    path = str(tmp_path / "scene.io")
    out, err = viewer._save_stl("(sphere 0.5)", path, size=16, device=CPU)
    assert err == "" and out.endswith(".stl")
    from mpr_tpu_torch.io import mesh
    tris = mesh.read_stl(out)
    assert mesh.mesh_volume(tris) > 0.3
    # errors are reported, not raised
    out, err = viewer._save_stl("(circle", path, device=CPU)
    assert out == "" and "save_stl failed" in err


def test_python_scripts_are_sandboxed(monkeypatch):
    """Viewer Python scenes run with restricted builtins (the
    eval-sandboxed Guile analog, reference/gui/interpreter.cpp:22-50):
    no import, no file IO; benign builtins + the DSL work."""
    monkeypatch.delenv("MPR_TPU_TRUST_SCRIPTS", raising=False)
    shapes_, _ = viewer._eval_src(
        "shapes = [circle(0.1 + 0.05 * i) for i in range(3)]\n"
        "n = len(shapes); assert min(1, 2) == 1\n", "s.py")
    assert len(shapes_) == 3
    with pytest.raises(ImportError):
        viewer._eval_src("import os\nshape = circle(0.1)\n", "s.py")
    with pytest.raises(NameError):
        viewer._eval_src("open('/etc/passwd')\n", "s.py")
    # the escape hatch restores full builtins
    monkeypatch.setenv("MPR_TPU_TRUST_SCRIPTS", "1")
    shapes_, _ = viewer._eval_src(
        "import math\nshape = circle(math.sin(0.5))\n", "s.py")
    assert len(shapes_) == 1


# ---- against mpr_tpu.viewer.render_scene (2D) ------------------------------

CAM_MOVED = {"yaw": 0, "pitch": 0, "persp": 0, "scale": 0.8, "panx": 0.15,
             "pany": -0.1}
SCRIPTS_2D = {
    "circle": ("shape = circle(0.5)", CAM0),
    "scheme": (IO_SCRIPT, CAM0),
    "stress_2d(12)": ("shape = stress_2d(12)", CAM_MOVED),
    "two_shapes": ("shapes = [circle(0.35, -0.3), circle(0.3, 0.3, 0.2), "
                   "rectangle(-0.2, 0.6, -0.7, -0.5)]", CAM_MOVED),
    "spiral": (None, CAM0),
}


def _script(name):
    src, cam = SCRIPTS_2D[name]
    if src is None:
        import pathlib
        src = (pathlib.Path(__file__).resolve().parents[1] / "examples"
               / "spiral.py").read_text()
    return src, cam


def _band(src, cam, size):
    """Pixels (in the viewer's flipped rows) where some shape's oracle
    |f| <= FILL_BAND, for shapes whose tape runs a transcendental; None
    when no shape does."""
    shapes_, _ = jviewer._eval_src(src)
    mat = jviewer.view_matrix(cam, "2d")
    xs = camera.pixel_centers(size)
    X, Y = np.meshgrid(xs, xs)
    w = mat[2, 0] * X + mat[2, 1] * Y + mat[2, 2]
    Xp = (mat[0, 0] * X + mat[0, 1] * Y + mat[0, 2]) / w
    Yp = (mat[1, 0] * X + mat[1, 1] * Y + mat[1, 2]) / w
    band = None
    for s in shapes_:
        t = mpr_tpu.compile_tree(s)
        if set(np.unique(t.ops).tolist()) & _TRANSCENDENTAL:
            f = oracle.eval_f(t, Xp, Yp, np.zeros_like(Xp))
            b = (np.abs(f) <= FILL_BAND)[::-1]
            band = b if band is None else band | b
    return band


def _assert_2d(img, want, band, label):
    assert img.shape == want.shape and img.dtype == want.dtype == np.uint8
    diff = img != want
    if band is None:
        assert not diff.any(), f"{label}: {int(diff.sum())} pixels differ"
    else:
        assert not (diff & ~band).any(), (label, int((diff & ~band).sum()))
        print(f"{label}: {int(diff.sum())} pixels differ, all in the "
              f"|f| <= {FILL_BAND} band of {int(band.sum())} pixels")


_JAX_2D = {}


def _jax_2d(name):
    """The JAX viewer's unrolled frame of a script, rendered once."""
    if name not in _JAX_2D:
        src, cam = _script(name)
        _JAX_2D[name] = jviewer.render_scene(src, cam, "2d", 128,
                                             engine="unrolled")
    return _JAX_2D[name]


@pytest.mark.parametrize("engine", ["interp", "unrolled"])
@pytest.mark.parametrize("name", sorted(SCRIPTS_2D))
def test_render_scene_2d_matches_jax(name, engine):
    src, cam = _script(name)
    size = 128
    want, _, jvars = _jax_2d(name)
    img, _, tvars = viewer.render_scene(src, cam, "2d", size,
                                        engine=engine, device=CPU)
    assert tvars == jvars
    assert want.any() and not want.all()
    _assert_2d(img, want, _band(src, cam, size), f"{name} {engine}")


SCRIPTS_2D_INTERP = {
    "two_shapes": ("shapes = [circle(0.35, -0.3), circle(0.3, 0.3, 0.2), "
                   "rectangle(-0.2, 0.6, -0.7, -0.5)]",
                   {"yaw": 0, "pitch": 0, "persp": 0, "scale": 0.8,
                    "panx": 0.15, "pany": -0.1}),
    "stress_2d(40)": ("shape = stress_2d(40)",
                      {"yaw": 0, "pitch": 0, "persp": 0, "scale": 1.0,
                       "panx": 0, "pany": 0}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS_2D_INTERP))
def test_render_scene_2d_interp_matches_jax(name):
    """Against the JAX viewer's interpreter engine (interpret mode, about
    half a minute a frame here).  No tape here runs a transcendental:
    images equal."""
    src, cam = SCRIPTS_2D_INTERP[name]
    want, _, jvars = jviewer.render_scene(src, cam, "2d", 128,
                                          engine="interp")
    img, _, tvars = viewer.render_scene(src, cam, "2d", 128,
                                        engine="interp", device=CPU)
    assert tvars == jvars
    assert want.any() and not want.all()
    assert img.dtype == want.dtype == np.uint8
    assert np.array_equal(img, want), int((img != want).sum())


VAR_SCRIPT = ("shapes = [circle(var('r', 0.4), 0.1), "
              "circle(0.2, var('cx', -0.5), var('cy', 0.3))]")


@pytest.mark.parametrize("engine", ["interp", "unrolled"])
def test_sliders_match_jax_and_build_nothing(engine):
    """Slider overrides are imm data: the images equal the JAX viewer's
    (its unrolled engine, imm-input renderers) at the same values and a
    fresh render of ``with_params`` of the trees; on the unrolled engine
    every move reuses the scene's renderers."""
    from mpr_tpu_torch.frontend import tree as T
    values = [{}, {"r": 0.55}, {"r": 0.3, "cx": -0.2}, {"cy": -0.4}]
    viewer.render_scene(VAR_SCRIPT, CAM0, "2d", 128, engine=engine,
                        device=CPU)
    n_renderers = len(unrolled._RENDERERS)
    for vv in values:
        img, _, svars = viewer.render_scene(VAR_SCRIPT, CAM0, "2d", 128,
                                            engine=engine, var_values=vv,
                                            device=CPU)
        want, _, jvars = jviewer.render_scene(VAR_SCRIPT, CAM0, "2d", 128,
                                              engine="unrolled",
                                              var_values=vv)
        assert svars == jvars
        assert np.array_equal(img, want), vv
        shapes_, _ = viewer._eval_src(VAR_SCRIPT)
        acc = np.zeros((128, 128), bool)
        for s in shapes_:
            t = mpr_tpu_torch.compile_tree(T.with_params(s, vv))
            acc |= mpr_tpu_torch.render.render2d(t, size=128, device=CPU)
        assert np.array_equal(img, np.where(acc[::-1], 255, 0)), vv
    assert len(unrolled._RENDERERS) == n_renderers


# ---- the device contract, the command line ---------------------------------

def test_needs_a_card_or_a_device(monkeypatch, tmp_path):
    """``cuda`` is the default everywhere; without a card each entry point
    raises, and ``serve`` raises before it starts a thread."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    path = tmp_path / "scene.py"
    path.write_text("shape = circle(0.5)\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.render_scene("shape = circle(0.5)", CAM0, "2d", 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.render_script(str(path))
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.serve(str(path), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.main([str(path), "--serve", "0"])
    assert set(threading.enumerate()) <= before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.main([str(path), "--out", str(tmp_path / "x.png"),
                     "--device", "cuda"])
    assert not (tmp_path / "x.png").exists()


def test_main_out_on_the_cpu(tmp_path):
    out = tmp_path / "x.png"
    src = tmp_path / "scene.py"
    src.write_text(SCRIPT)
    viewer.main([str(src), "--device", "cpu", "--out", str(out)])
    want, st, _ = viewer.render_script(str(src), device=CPU)
    assert st == {"mode": "heightmap", "size": 128, "engine": "interp"}
    assert np.array_equal(decode_png(out.read_bytes()), want)


def test_serve_on_the_cpu(tmp_path):
    """``main --serve PORT --device cpu``: the page, a frame and an edit."""
    src = tmp_path / "scene.py"
    src.write_text("SIZE = 128\nMODE = '2d'\nshape = circle(0.5)\n")
    port = _free_port()
    threading.Thread(target=viewer.main,
                     args=([str(src), "--serve", str(port), "--device",
                            "cpu"],), daemon=True).start()
    cl = _Client(port)
    st = cl.wait_seq(1)
    assert st["error"] == "" and st["device"] == "cpu"
    assert b"textarea" in cl.get("/")[1]
    want, _, _ = viewer.render_scene("shape = circle(0.5)", st["cam"], "2d",
                                     128, device=CPU)
    assert np.array_equal(decode_png(cl.get("/frame.png")[1]), want)
    assert cl.post({"script": "shape = circle(0.25)"})[0] == 200
    for _ in range(600):
        st = json.loads(cl.get("/status")[1])
        img = decode_png(cl.get("/frame.png")[1])
        if (img > 0).sum() < (want > 0).sum() // 2:
            break
        time.sleep(0.2)
    want2, _, _ = viewer.render_scene("shape = circle(0.25)", st["cam"],
                                      "2d", 128, device=CPU)
    assert st["error"] == "" and np.array_equal(img, want2)


def test_module_runs_as_a_script(tmp_path):
    import pathlib
    root = str(pathlib.Path(__file__).resolve().parents[1])
    out = tmp_path / "o.png"
    r = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.viewer",
                        "examples/csg_demo.py", "--device", "cpu", "--out",
                        str(out)], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "rendered" in r.stderr and out.read_bytes()[:4] == b"\x89PNG"
