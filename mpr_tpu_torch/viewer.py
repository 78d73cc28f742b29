"""Interactive viewer on the card: the port's counterpart of
``mpr_tpu.viewer`` (the GUI layer, L5a).

The reference embeds a Guile Scheme editor pane plus an orbit camera
(pan/rotate/zoom, reference/gui/main.cpp:184-228) and mode/size panes
(:304-336); shapes re-render on every edit (:263-302).  Here the scripting
language IS Python — the frontend DSL replaces libfive-guile — and the
display is a browser page; frames travel as PNG over HTTP:

    python -m mpr_tpu_torch.viewer examples/hello_world.py --serve 8000
    python -m mpr_tpu_torch.viewer examples/csg_demo.py --serve 8766 --device cpu

In the browser:
  * left pane: the script in a live editor; Ctrl-Enter (or Run) re-renders,
    errors show inline (interpreter.cpp:67-103 analog), Save writes the
    file back (the GUI's Cmd-S, gui/main.cpp:230-247);
  * right pane: drag = orbit (3D) / pan (2D), Shift-drag = pan,
    wheel = zoom — POSTed to the server, which rebuilds the view matrix
    and re-renders (the reference's Eigen::Affine3f assembly,
    gui/main.cpp:117-137);
  * mode (2d/heightmap/normals/ssao/shaded) and size selectors.

Every frame runs on one device, ``cuda`` unless ``--device`` (or
``device=``) names another; ``serve`` and ``main`` resolve it before they
start a thread, so a machine without a card fails at start rather than
serving a page whose every frame is an error, and nothing falls back to the
CPU on its own.  Each frame compiles the script's tapes on the host
(``compile_tree``: the native compiler for a tree without named
parameters), renders each shape on the device, composites and shades
there, and copies the finished 8-bit image to the host once, for the PNG.

Rendering defaults to the interpreter engine (``render/pipeline2d.py``,
``pipeline3d.py``): it reads the tape at run time, so an edit builds
nothing.  The engine selector (or ``ENGINE = "unrolled"`` in the script)
switches to the unrolled engine (``render/unrolled.py``), whose kernels are
generated for each tape and built with nvcc at its first frame (PERF.md
has the cold times); orbit and zoom frames then reuse them.  Slider moves
are data on both engines: the interpreter takes the immediates as a
tensor (``Tape.imms_with``), and the unrolled engine gives a tape with
named parameters kernels that read its immediates from a pointer, keyed by
the tape's structure — so moving a slider builds nothing.

Script protocol (the .io directive analog, gui/examples/architecture.io):
define ``shape`` (a Tree) or ``shapes`` (a list); optional SIZE, MODE,
ENGINE, VIEW ((yaw, pitch, perspective) or a 4x4 matrix) give the
initial settings.  A ``.frep`` archive can be opened directly: a
generated editing script loads it (``_script_for_frep``), and saves
never touch the archive.  Multi-shape scenes composite like the GUI's
append mode (gui/tex.cu:35-147): 2D fills OR together; 3D depths take the
per-pixel max with the winning shape's normals.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.server
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from .io.png import encode_png
from .ops.tape_data import TapeData, resolve_device
from .render import effects, pipeline2d, pipeline3d, unrolled
from .tape.tape import compile_tree
from .utils.trace import span

_PAGE = b"""<!doctype html>
<title>mpr_tpu_torch viewer</title>
<body style="margin:0;background:#14161a;color:#ccc;font:13px monospace;display:flex;height:100vh">
<div style="width:420px;display:flex;flex-direction:column;padding:6px;gap:6px">
  <div>
    <button id=run>Run (Ctrl-Enter)</button>
    <button id=save>Save</button>
    <button id=savef title="serialize the scene's shapes to a .frep archive next to the script">.frep</button>
    <button id=savestl title="mesh the scene (marching tetrahedra) and write an STL next to the script">.stl</button>
    <select id=mode>
      <option>2d</option><option>heightmap</option><option>normals</option>
      <option>ssao</option><option selected>shaded</option>
    </select>
    <select id=size>
      <option>256</option><option selected>512</option>
      <option>1024</option><option>2048</option>
    </select>
    <select id=engine title="interp: no per-shape build (editing); unrolled: CUDA kernels generated and built per shape, faster frames (orbiting)">
      <option selected>interp</option><option>unrolled</option>
    </select>
  </div>
  <div id=vars style="display:none;max-height:30vh;overflow-y:auto"></div>
  <textarea id=src spellcheck=false
    style="flex:1;background:#1b1e24;color:#d8d8d8;border:1px solid #333;font:12px monospace"></textarea>
  <pre id=err style="color:#ff7b72;white-space:pre-wrap;min-height:3em;margin:0"></pre>
</div>
<div style="flex:1;display:flex;flex-direction:column">
  <div id=stat style="padding:4px"></div>
  <div style="position:relative">
    <img id=v draggable=false
      style="image-rendering:pixelated;max-width:100%;max-height:95vh;cursor:grab">
    <canvas id=axes width=70 height=70
      style="position:absolute;left:6px;bottom:10px;pointer-events:none"></canvas>
  </div>
</div>
<script>
let seq = -1, drag = null;
const el = id => document.getElementById(id);
async function post(body) {
  await fetch('/update', {method: 'POST', body: JSON.stringify(body)});
}
function drawAxes(cam, mode) {
  // XYZ gizmo (the reference GUI's axis overlay, gui/main.cpp:420-437):
  // screen dir of shape axis e is Rz(-yaw)*Rx(-pitch)*e (the inverse of
  // view_matrix's rotation); canvas y points down, screen up is +y.
  const cv = el('axes'), g = cv.getContext('2d');
  g.clearRect(0, 0, 70, 70);
  if (mode === '2d') return;
  const cp = Math.cos(cam.pitch), sp = Math.sin(cam.pitch);
  const cy = Math.cos(cam.yaw), sy = Math.sin(cam.yaw);
  const axes = [[[1,0,0],'#e06c75','x'], [[0,1,0],'#98c379','y'],
                [[0,0,1],'#61afef','z']].map(([e, col, lbl]) => {
    const y1 = cp*e[1] + sp*e[2], z1 = -sp*e[1] + cp*e[2];
    return {v: [cy*e[0] + sy*y1, -sy*e[0] + cy*y1, z1], col, lbl};
  }).sort((a, b) => a.v[2] - b.v[2]);      // far first
  for (const {v, col, lbl} of axes) {
    g.strokeStyle = g.fillStyle = col;
    g.lineWidth = 1.5;
    g.beginPath(); g.moveTo(35, 35);
    g.lineTo(35 + 24*v[0], 35 - 24*v[1]); g.stroke();
    g.font = '10px monospace';
    g.fillText(lbl, 33 + 31*v[0], 38 - 31*v[1]);
  }
}
let varsSig = '';
function renderVars(vars) {
  // named-parameter sliders ((var name v lo hi) / Python var()): moves
  // POST imm-level overrides -- neither engine builds anything on a
  // move.  DOM is rebuilt only when the var set/ranges change.
  const box = el('vars'), names = Object.keys(vars || {});
  const sig = names.map(n => n + ':' + vars[n][1] + ':' + vars[n][2]).join();
  if (sig === varsSig) {
    for (const inp of box.querySelectorAll('input[data-var]')) {
      const n = inp.dataset.var;
      if (document.activeElement !== inp && vars[n]) {
        inp.value = vars[n][0];
        inp.parentElement.querySelector('.vv').textContent =
          (+vars[n][0]).toFixed(3);
      }
    }
    return;
  }
  varsSig = sig;
  box.innerHTML = '';
  box.style.display = names.length ? 'block' : 'none';
  for (const n of names) {
    const [v, lo, hi] = vars[n];
    const row = document.createElement('div');
    const lbl = document.createElement('span');
    lbl.style.cssText = 'display:inline-block;width:84px;overflow:hidden';
    lbl.textContent = n;
    const inp = document.createElement('input');
    inp.type = 'range'; inp.min = lo; inp.max = hi;
    inp.step = (hi - lo) / 256; inp.value = v; inp.dataset.var = n;
    inp.style.cssText = 'width:190px;vertical-align:middle';
    const vv = document.createElement('span');
    vv.className = 'vv'; vv.textContent = (+v).toFixed(3);
    inp.oninput = () => {
      vv.textContent = (+inp.value).toFixed(3);
      post({set_var: [n, +inp.value]});
    };
    row.append(lbl, inp, ' ', vv);
    box.appendChild(row);
  }
  const rb = document.createElement('button');
  rb.textContent = 'reset vars';
  rb.onclick = () => { varsSig = ''; post({reset_vars: true}); };
  box.appendChild(rb);
}
async function tick() {
  try {
    const j = await (await fetch('/status')).json();
    el('stat').textContent =
      `${j.script} ${j.mode} ${j.size}px [${j.engine} on ${j.device}] render ${j.ms} ms ` +
      `yaw ${j.cam.yaw.toFixed(2)} pitch ${j.cam.pitch.toFixed(2)} ` +
      `zoom ${(1 / j.cam.scale).toFixed(2)}x  #${j.seq}`;
    el('err').textContent = j.error || '';
    drawAxes(j.cam, j.mode);
    renderVars(j.vars);
    if (j.seq !== seq) { seq = j.seq; el('v').src = '/frame.png?s=' + seq; }
  } catch (e) {}
  setTimeout(tick, 250);
}
fetch('/script').then(r => r.text()).then(t => { el('src').value = t; tick(); });
el('run').onclick = () => post({script: el('src').value});
el('save').onclick = () => post({script: el('src').value, save: true});
el('savef').onclick = () => post({script: el('src').value, save_frep: true});
el('savestl').onclick = () => post({script: el('src').value, save_stl: true});
el('src').onkeydown = e => {
  if (e.ctrlKey && e.key === 'Enter') { e.preventDefault(); el('run').click(); }
};
el('mode').onchange = () => post({mode: el('mode').value});
el('size').onchange = () => post({size: +el('size').value});
el('engine').onchange = () => post({engine: el('engine').value});
const img = el('v');
img.onmousedown = e => { drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey}; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  post(drag.pan ? {pan: [dx, dy]} : {orbit: [dx, dy]});
};
img.onwheel = e => { e.preventDefault(); post({zoom: e.deltaY > 0 ? 1.1 : 1/1.1}); };
</script>
"""


class ViewerState:
    def __init__(self, device=None):
        self.src = ""
        self.path = ""
        self.cam = {"yaw": 0.7, "pitch": -1.0, "persp": 0.3,
                    "scale": 1.0, "panx": 0.0, "pany": 0.0}
        self.mode = "shaded"
        self.size = 512
        self.engine = "interp"
        # the device every frame renders on (None: cuda, an error without
        # a card; serve() resolves it before it starts a thread)
        self.device = device
        self.png = b""
        self.seq = 0
        self.ms = 0.0
        self.error = ""
        # named parameters: slider metadata from the last eval and the
        # user's slider overrides (imm-level, applied at render time)
        self.vars = {}
        self.var_overrides = {}
        self.lock = threading.Lock()
        self.dirty = threading.Event()
        # set, then set ``dirty``, to end the render and watch threads
        self.stop = threading.Event()
        # set when opening a .frep directly: the archive path to watch
        # for external changes (re-render only; src stays the generated
        # editing script)
        self.data_path = ""


def _device(device=None) -> torch.device:
    """The viewer's device: ``cuda`` (None or the name), an error without
    a card; another device only where the caller names it."""
    return resolve_device(None if device in (None, "cuda") else device)


def _is_scheme_src(src: str) -> bool:
    """Sniff Scheme scene scripts (the reference GUI's .io format): the
    first meaningful character of a Scheme scene is '(' (or the whole
    prefix is ';' comments / '#|' blocks); Python scripts never start
    that way."""
    for line in src.splitlines():
        s = line.strip()
        if not s or s.startswith(";"):
            continue
        return s.startswith("(") or s.startswith("#|")
    return False


def _eval_src(src: str, path: str = "<viewer>"):
    """Run script text with the DSL preloaded; collect shapes + settings
    (the interpreter.cpp analog — errors are raised to the caller, which
    reports them in the page instead of crashing).  Scheme sources (the
    reference's .io scripts) are dispatched to frontend/scheme.py; Python
    sources run in the exec sandbox below."""
    from .frontend import shapes as shapelib
    from .frontend import tree as treelib
    if path.endswith(".io") or (not path.endswith(".py")
                                and _is_scheme_src(src)):
        from .frontend import scheme
        from .frontend.tree import VAR_Z
        res = scheme.run_string(src)
        # a scene that never references z is 2D (prospero.io): default
        # the mode accordingly; 3D scenes keep the state's mode
        mode = None
        if res.shapes and all(
                not any(n.op == VAR_Z for n in s.ordered_dfs())
                for s in res.shapes):
            mode = "2d"
        return list(res.shapes), {"size": None, "mode": mode,
                                  "engine": None, "view": None,
                                  "vars": dict(res.vars)}
    # Restricted-builtins exec, the viewer-script analog of the
    # reference's eval-sandboxed Guile (reference/gui/interpreter.cpp:
    # 22-50): scene scripts get the DSL + benign builtins, no
    # import/open/exec.  MPR_TPU_TRUST_SCRIPTS=1 restores full builtins
    # for local power users.
    import builtins as _b
    if os.environ.get("MPR_TPU_TRUST_SCRIPTS") == "1":
        allowed = __builtins__
    else:
        allowed = {k: getattr(_b, k) for k in (
            "abs", "all", "any", "bool", "dict", "divmod", "enumerate",
            "filter", "float", "int", "len", "list", "map", "max", "min",
            "pow", "print", "range", "reversed", "round", "set", "slice",
            "sorted", "str", "sum", "tuple", "zip", "True", "False",
            "None", "ValueError", "TypeError", "Exception",
        ) if hasattr(_b, k)}
    env = {"__builtins__": allowed}
    # archive loading stays available inside the sandbox (the generated
    # .frep editing view uses it; no import machinery needed)
    from .frontend.frep import load as _frep_load
    env["load_frep"] = _frep_load
    env.update({k: getattr(shapelib, k) for k in dir(shapelib)
                if not k.startswith("_")})
    for k in ("x", "y", "z", "const", "var", "minimum", "maximum", "sqrt",
              "square", "sin", "cos", "tan", "asin", "acos", "atan",
              "exp", "log", "neg", "abs_", "atan2", "pow_", "nth_root",
              "compare", "recip", "Tree"):
        if hasattr(treelib, k):
            env[k] = getattr(treelib, k)
    exec(compile(src, path, "exec"), env)
    out = env.get("shapes")
    if out is None:
        out = [env["shape"]] if "shape" in env else []
    # named parameters (var()): slider metadata with a default range
    # around each value (Scheme's (var n v lo hi) can give exact ranges)
    pvars = {}
    for s in out:
        for name, v in treelib.params_of(s).items():
            span = max(abs(v), 1.0)
            pvars[name] = (v, v - span, v + span)
    settings = {"size": env.get("SIZE"), "mode": env.get("MODE"),
                "engine": env.get("ENGINE"), "view": env.get("VIEW", None),
                "vars": pvars}
    return list(out), settings


def _save_frep(src: str, path: str, avoid: str = "",
               var_values: dict = None) -> tuple:
    """Serialize the script's shapes to ``<script-stem>.frep``
    (the GUI's save-shape feature, reference/gui/main.cpp:394-403;
    archives round-trip through frontend/frep.py and load in the
    reference).  Returns ``(written_path, error)`` with exactly one of
    the two non-empty.  Runs the user script, so the caller must NOT
    hold state.lock (an expensive or looping script would otherwise
    freeze every other request and the render worker — render_scene
    runs outside the lock for the same reason)."""
    from .frontend import frep as _frep
    from .frontend import tree as _treelib
    try:
        shapes_, _ = _eval_src(src, path or "<viewer>")
        if not shapes_:
            raise ValueError("script defines no shape/shapes")
        if var_values:
            # bake slider edits into the saved archive (params stay
            # params — const-var + 'V' records — at the new values)
            shapes_ = [_treelib.with_params(s, var_values) for s in shapes_]
        stem = os.path.splitext(path)[0] if path else "scene"
        out_path = stem + ".frep"
        if avoid and os.path.abspath(out_path) == os.path.abspath(avoid):
            # opened-from-.frep mode: never clobber the source archive
            out_path = stem + "_edited.frep"
        _frep.dump([s if isinstance(s, _frep.ArchiveShape)
                    else _frep.ArchiveShape(tree=s, name=f"shape{i}")
                    for i, s in enumerate(shapes_)], out_path)
        return out_path, ""
    except Exception as e:                      # report, never crash
        return "", f"save_frep failed: {e}"


def _save_stl(src: str, path: str, size: int = 96,
              var_values: dict = None, device=None) -> tuple:
    """Mesh the scene (union of its shapes) over [-1,1]^3 and write
    ``<script-stem>.stl`` (io/mesh.py, its grid evaluated on ``device``)
    — the export-for-printing step; same locking contract as _save_frep.
    Returns (written_path, error)."""
    from .frontend import shapes as shapelib
    from .frontend import tree as _treelib
    from .io import mesh as _mesh
    try:
        shapes_, _ = _eval_src(src, path or "<viewer>")
        if not shapes_:
            raise ValueError("script defines no shape/shapes")
        if var_values:
            shapes_ = [_treelib.with_params(s, var_values) for s in shapes_]
        tape = compile_tree(shapelib.union(*shapes_))
        tris = _mesh.mesh_tape(tape, n=size, device=_device(device))
        if not len(tris):
            raise ValueError("no surface inside [-1,1]^3")
        out_path = (os.path.splitext(path)[0] if path else "scene") + ".stl"
        _mesh.write_stl(out_path, tris)
        return out_path, ""
    except Exception as e:                      # report, never crash
        return "", f"save_stl failed: {e}"


def view_matrix(cam: dict, mode: str) -> np.ndarray:
    """Camera dict -> homogeneous matrix, like the GUI's matrix assembly
    from pan/rotate/zoom state (reference/gui/main.cpp:117-137,
    184-228).  The matrix maps screen coords to shape space, so zoom-in
    means scale < 1."""
    from .render import camera as C
    s = float(cam["scale"])
    if mode == "2d":
        m = np.eye(3, dtype=np.float32)
        m[0, 0] = m[1, 1] = s
        m[0, 2] = float(cam["panx"])
        m[1, 2] = float(cam["pany"])
        return m
    m = (C.rot_x4(float(cam["pitch"])) @ C.rot_z4(float(cam["yaw"])))
    m[:3, :] *= s
    m[0, 3] = float(cam["panx"])
    m[1, 3] = float(cam["pany"])
    m[3, 2] = float(cam["persp"]) * s
    return m.astype(np.float32)


def frame2d(tape, mat, size: int, engine: str = "interp") -> torch.Tensor:
    """One shape's 2D fill on the device of ``mat`` ((3, 3) f32 tensor):
    a (size, size) bool tensor, row 0 at y = -1 — what
    ``pipeline2d.render2d`` / ``unrolled.render2d`` return, before their
    copy to the host."""
    z = torch.zeros((), dtype=torch.float32, device=mat.device)
    if engine == "unrolled":
        # a tape with named parameters gets the imm-input renderer: its
        # kernels are keyed by structure, so a slider move builds nothing
        r = unrolled.get_renderer(tape, imm_inputs=bool(tape.params))
        img, _ = r.frame2d(mat, z, size)
        return img
    td = TapeData.from_tape(tape, device=mat.device)
    img, _ = pipeline2d.render_tile_block(td, mat, z, size)
    return img


def frame3d(tape, mat, size: int, engine: str = "interp"):
    """One shape's depth (int32) and normals (f32 x3) on the device of
    ``mat`` ((4, 4) f32 tensor) — what ``pipeline3d.render3d`` /
    ``unrolled.render3d`` return, before their copy to the host."""
    if engine == "unrolled":
        r = unrolled.get_renderer(tape, imm_inputs=bool(tape.params))
        depth, normals, _ = r.frame3d(mat, size, True)
    else:
        with span("mpr.3d.tapedata"):
            td = TapeData.from_tape(tape, device=mat.device)
        depth, normals, _ = pipeline3d.render3d_rows(
            td, mat, size, 0, size // pipeline3d.TILE, True)
    return depth, normals


def compose(mode: str, depth, normals, size: int) -> torch.Tensor:
    """A 3D mode's 8-bit image from the composited depth and normals, on
    their device, rows flipped to the PNG's top-down order.  The
    arithmetic is ``mpr_tpu.viewer.render_scene``'s: the heightmap divides
    in float64, as numpy's ``depth / size`` does."""
    if mode == "heightmap":
        img = (depth.to(torch.float64) / size * 255).to(torch.uint8)
    elif mode == "normals":
        img = (normals * 127 + 128).clamp(0, 255).to(torch.uint8)
    elif mode == "ssao":
        img = (effects.draw_ssao(depth, normals) * 255).to(torch.uint8)
    else:
        img = (effects.draw_shaded(depth, normals) * 255).to(torch.uint8)
    return img.flip(0)


def render_scene(src: str, cam: dict, mode: str, size: int,
                 engine: str = "interp", path: str = "<viewer>",
                 var_values: dict = None, device=None):
    """Render script text under the given camera; returns
    (rgb u8, ms, vars) where vars is {name: (value, lo, hi)} slider
    metadata with ``var_values`` overrides applied.

    ``engine``: "interp" (nothing built per shape — editing) or
    "unrolled" (kernels generated and built per shape at its first frame,
    faster frames — orbiting).
    ``path``: the backing file, if any — a ``.io``/``.py`` suffix decides
    the Scheme-vs-Python dispatch deterministically (content sniffing is
    only the fallback for pathless editor buffers).
    ``var_values``: named-parameter overrides (viewer sliders); applied
    as pure imm-vector data, so neither engine builds anything
    (Tape.imms_with).
    ``device``: ``cuda`` when None (an error without a card).  Every
    shape renders there, compositing and effects run there, and the
    finished image is copied to the host once."""
    dev = _device(device)
    shapes, settings = _eval_src(src, path)
    if not shapes:
        raise ValueError("script defines no `shape` or `shapes`")
    svars = dict(settings.get("vars") or {})
    if var_values:
        for name, v in var_values.items():
            if name in svars:
                _, lo, hi = svars[name]
                svars[name] = (float(v), lo, hi)

    def tape_of(s):
        """Slider overrides are pure imm-vector data on BOTH engines:
        the interpreter reads imms as data by construction, and the
        unrolled engine renders a tape with named parameters through
        imm-input kernels (keyed by tape STRUCTURE,
        render/unrolled.py::tape_key) — so no slider position builds
        anything."""
        t = compile_tree(s)
        if var_values:
            ov = {k: v for k, v in var_values.items() if k in t.params}
            if ov:
                return dataclasses.replace(t, imms=t.imms_with(ov))
        return t

    mat = view_matrix(cam, mode)
    t0 = time.perf_counter()
    mat_t = torch.as_tensor(mat, device=dev)
    if mode == "2d":
        acc = torch.zeros((size, size), dtype=torch.bool, device=dev)
        for s in shapes:
            acc |= frame2d(tape_of(s), mat_t, size, engine)
        img = (acc.flip(0).to(torch.uint8) * 255)
    else:
        depth = torch.zeros((size, size), dtype=torch.int32, device=dev)
        normals = torch.zeros((size, size, 3), dtype=torch.float32,
                              device=dev)
        for s in shapes:
            d, n = frame3d(tape_of(s), mat_t, size, engine)
            win = d > depth
            depth = torch.where(win, d.to(torch.int32), depth)
            normals = torch.where(win[..., None], n, normals)
        img = compose(mode, depth, normals, size)
    img = img.cpu().numpy()
    return img, (time.perf_counter() - t0) * 1e3, svars


def _apply_script_settings(state: ViewerState, settings: dict) -> None:
    if settings.get("size"):
        state.size = int(settings["size"])
    if settings.get("mode"):
        state.mode = str(settings["mode"])
    if settings.get("engine"):
        state.engine = str(settings["engine"])
    v = settings.get("view")
    if v is not None:
        v = np.asarray(v, np.float32)
        if v.shape == (3,):
            state.cam.update(yaw=float(v[0]), pitch=float(v[1]),
                             persp=float(v[2]))


def _render_worker(state: ViewerState, out=None):
    """The render thread: one frame each time ``state.dirty`` is set, on
    ``state.device``; its kernels launch on this thread's current CUDA
    stream.  Returns once ``state.stop`` is set."""
    while True:
        state.dirty.wait()
        if state.stop.is_set():
            return
        state.dirty.clear()
        with state.lock:
            src, cam = state.src, dict(state.cam)
            mode, size, engine = state.mode, state.size, state.engine
            path = state.path or "<viewer>"
            overrides = dict(state.var_overrides)
            device = state.device
        try:
            img, ms, svars = render_scene(src, cam, mode, size, engine,
                                          path, var_values=overrides,
                                          device=device)
            png = encode_png(img)
            err = ""
        except Exception as e:  # script errors show in the page
            png, ms, err, svars = None, 0.0, f"{type(e).__name__}: {e}", None
        with state.lock:
            if png is not None:
                state.png = png
                state.ms = round(ms, 1)
            if svars is not None:
                state.vars = svars
            state.error = err
            state.seq += 1
        if out and png is not None:
            with open(out, "wb") as f:
                f.write(png)


def _watch_worker(state: ViewerState):
    """Re-render when the script file changes on disk (external editors
    keep working alongside the in-page one).  When a .frep archive was
    opened directly, its mtime is watched too — the generated script
    re-loads the archive on every eval, so a dirty flag suffices."""
    last = None
    last_data = None
    while not state.stop.is_set():
        try:
            m = os.stat(state.path).st_mtime
            if m != last:
                if last is not None:
                    with open(state.path) as f:
                        src = f.read()
                    with state.lock:
                        state.src = src
                    state.dirty.set()
                last = m
        except OSError:
            pass
        if state.data_path:
            try:
                m = os.stat(state.data_path).st_mtime
                if m != last_data:
                    if last_data is not None:
                        state.dirty.set()
                    last_data = m
            except OSError:
                pass
        time.sleep(0.4)


def make_handler(state: ViewerState):
    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body, ctype):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # snapshot under the lock, write to the socket AFTER
            # releasing it: a slow client draining wfile must not block
            # the render worker or other handler threads
            if self.path.startswith("/frame.png"):
                with state.lock:
                    body, ctype = state.png, "image/png"
            elif self.path.startswith("/status"):
                with state.lock:
                    body = json.dumps({
                        "seq": state.seq, "ms": state.ms,
                        "mode": state.mode, "size": state.size,
                        "engine": state.engine, "cam": dict(state.cam),
                        "device": str(state.device or "cuda"),
                        "error": state.error,
                        "script": os.path.basename(state.path),
                        "vars": {k: list(v)
                                 for k, v in sorted(state.vars.items())},
                    }).encode()
                ctype = "application/json"
            elif self.path.startswith("/script"):
                with state.lock:
                    body = state.src.encode()
                ctype = "text/plain"
            else:
                body, ctype = _PAGE, "text/html"
            self._send(body, ctype)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                req = {}
            resp = {}
            save_frep_args = None
            save_stl_args = None
            with state.lock:
                if "script" in req:
                    state.src = str(req["script"])
                    if req.get("save"):
                        with open(state.path, "w") as f:
                            f.write(state.src)
                if req.get("save_frep"):
                    # shape serialization, the GUI's save-to-.frep
                    # (reference/gui/main.cpp:394-403); always written
                    # NEXT TO the script (no client paths).  Snapshot
                    # under the lock, execute after releasing it —
                    # _save_frep runs the user script.
                    save_frep_args = (state.src, state.path,
                                      state.data_path,
                                      dict(state.var_overrides))
                if req.get("save_stl"):
                    save_stl_args = (state.src, state.path, 96,
                                     dict(state.var_overrides),
                                     state.device)
                if "set_var" in req:
                    # slider move: a pure imm-vector override — neither
                    # engine builds anything
                    name, value = req["set_var"]
                    state.var_overrides[str(name)] = float(value)
                if req.get("reset_vars"):
                    state.var_overrides.clear()
                if "mode" in req:
                    state.mode = str(req["mode"])
                if "size" in req:
                    state.size = int(req["size"])
                if "engine" in req:
                    state.engine = str(req["engine"])
                if "orbit" in req:
                    dx, dy = req["orbit"]
                    if state.mode == "2d":
                        sc = state.cam["scale"] * 2.0 / state.size
                        state.cam["panx"] -= dx * sc
                        state.cam["pany"] += dy * sc
                    else:
                        state.cam["yaw"] += dx * 0.01
                        state.cam["pitch"] -= dy * 0.01
                if "pan" in req:
                    dx, dy = req["pan"]
                    sc = state.cam["scale"] * 2.0 / state.size
                    state.cam["panx"] -= dx * sc
                    state.cam["pany"] += dy * sc
                if "zoom" in req:
                    state.cam["scale"] = float(np.clip(
                        state.cam["scale"] * float(req["zoom"]),
                        1e-3, 1e3))
            if save_frep_args is not None:
                out_path, err = _save_frep(*save_frep_args)
                resp["saved_frep"] = out_path
                if err:
                    with state.lock:
                        state.error = err
            if save_stl_args is not None:
                out_path, err = _save_stl(*save_stl_args)
                resp["saved_stl"] = out_path
                if err:
                    with state.lock:
                        state.error = err
            state.dirty.set()
            self._send(json.dumps(resp).encode(), "application/json")
    return H


def _script_for_frep(path: str) -> str:
    """Synthesize an editing script for a .frep archive, so the viewer
    opens the reference's bundled models directly (the reference GUI
    only opens Scheme scripts; its .frep models are benchmark-only).
    The script re-loads the archive at each eval, so external edits to
    the .frep re-render live."""
    from .frontend import frep
    ss = frep.load(path)
    uses_z = any(compile_tree(s.tree).axis_slots[2] for s in ss)
    mode = "normals" if uses_z else "2d"
    return (f"# generated editing view of {os.path.basename(path)}\n"
            f"# (save writes this script next to the archive; the\n"
            f"#  archive itself is never overwritten)\n"
            f"shapes = [s.tree for s in "
            f"load_frep({os.path.abspath(path)!r})]\n"
            f"MODE = {mode!r}\n")


def serve(path: str, port: int, out=None, host: str = "127.0.0.1",
          device=None):
    # the device first: without a card this raises before any thread
    # starts or any port is bound
    dev = _device(device)
    state = ViewerState(device=dev)
    if path.endswith(".frep"):
        # open archives directly: edit a generated script, watch the
        # archive; in-page save targets <stem>.py, never the .frep
        state.src = _script_for_frep(path)
        state.data_path = path
        state.path = os.path.splitext(path)[0] + ".py"
    else:
        state.path = path
        with open(path) as f:
            state.src = f.read()
    try:
        _, settings = _eval_src(state.src, path)
        _apply_script_settings(state, settings)
    except Exception as e:
        state.error = f"{type(e).__name__}: {e}"
    threading.Thread(target=_render_worker, args=(state,),
                     kwargs={"out": out}, daemon=True).start()
    threading.Thread(target=_watch_worker, args=(state,),
                     daemon=True).start()
    state.dirty.set()
    # loopback by default: POST /update executes the posted script with
    # full process privileges, so exposing the port is opt-in (--host)
    httpd = http.server.ThreadingHTTPServer((host, port),
                                            make_handler(state))
    print(f"viewer at http://{host}:{port} (editing {path}, on {dev})",
          file=sys.stderr)
    httpd.serve_forever()


def render_script(path: str, device=None):
    """One-shot render of a script or .frep file (CLI --out mode and
    tests), on ``device`` (``cuda`` when None)."""
    dev = _device(device)
    if path.endswith(".frep"):
        src = _script_for_frep(path)
    else:
        with open(path) as f:
            src = f.read()
    state = ViewerState(device=dev)
    state.path = path
    _, settings = _eval_src(src, path)
    _apply_script_settings(state, settings)
    img, ms, _ = render_scene(src, state.cam, state.mode, state.size,
                              state.engine, path, device=dev)
    return img, {"mode": state.mode, "size": state.size,
                 "engine": state.engine}, ms


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mpr_tpu_torch.viewer")
    ap.add_argument("script", help="a Python scene script, or a .frep "
                    "archive (opened via a generated editing script)")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; the editor "
                    "endpoint executes posted scripts — only expose it "
                    "on networks you trust)")
    ap.add_argument("--out", default=None, help="write a PNG and exit "
                    "(or, with --serve, also mirror frames here)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu (the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.serve:
        serve(args.script, args.serve, out=args.out, host=args.host,
              device=args.device)
    else:
        img, st, ms = render_script(args.script, device=args.device)
        out = args.out or "viewer_out.png"
        with open(out, "wb") as f:
            f.write(encode_png(img))
        print(f"rendered {st['mode']} {st['size']}px in {ms:.1f} ms "
              f"-> {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
