"""Command-line render & benchmark suite.

Counterpart of ``mpr_tpu.cli`` (the reference's benchmark executables,
reference/benchmark/CMakeLists.txt:18-32, behind one entry point), with
the same arguments, outputs and printed lines:

    python -m mpr_tpu_torch.cli render2d FILE.frep --size 1024 --out out.png
    python -m mpr_tpu_torch.cli render3d FILE.frep --size 512 --mode shaded
    python -m mpr_tpu_torch.cli table2d FILE.frep        # render_2d_table
    python -m mpr_tpu_torch.cli table3d FILE.frep        # render_3d_table
    python -m mpr_tpu_torch.cli brute FILE.frep          # brute comparison
    python -m mpr_tpu_torch.cli table-effects FILE.frep  # render_effects
    python -m mpr_tpu_torch.cli tape-time FILE.frep      # tape_building_time
    python -m mpr_tpu_torch.cli dump-tape FILE.frep      # print_tape_table
    python -m mpr_tpu_torch.cli fit A.frep --target B.frep  # fit constants
    python -m mpr_tpu_torch.cli mesh FILE.frep --out m.stl  # mesh export

FILE is a ``.frep`` archive, a ``.io`` Scheme scene or ``stress:N``.
Every command runs on ``--device`` (default ``cuda``): without a card it
fails, and ``--device cpu`` is the way to ask for the plain PyTorch
versions of the kernels.  ``--engine`` picks the interpreter pipelines
(``interp``, no per-tape build) or the unrolled engine (``unrolled``:
kernels generated for the tape, built at its first frame); the tables
and ``table-effects`` default to the unrolled engine, as ``mpr_tpu.cli``'s
do.  ``--sharded`` renders over the ranks of a ``torch.distributed``
process group (one process: the whole image), and ``fit`` steps over
them; ``fit`` differentiates through the port's backward kernels on a
card (K2 for ``--engine scan``, K1 otherwise).

Timing protocol: warm-up + timed-runs mean, like benchmark/stats.cpp:19-47
(utils/timing.py: CUDA events around the timed runs).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def _load_tree(path: str):
    """Shape source -> (Tree, ScriptResult-or-None).  Sources: a .frep
    archive, a .io Scheme scene (all shapes unioned; the ScriptResult
    carries its directives), or ``stress:N``."""
    from .frontend import frep
    if path.startswith("stress:"):
        # synthetic long-tape model, e.g. ``stress:1500``, the working
        # analog of the reference's missing prospero_long.frep
        # (reference/benchmark/tape_shortening.cpp:29); see
        # frontend/shapes.py::stress_2d
        from .frontend import shapes as shapelib
        return shapelib.stress_2d(int(path.split(":", 1)[1])), None
    if path.endswith(".io"):
        # a Scheme scene script (the reference GUI's source format,
        # reference/gui/examples/*.io)
        from .frontend import scheme
        from .frontend import shapes as shapelib
        res = scheme.run_file(path)
        if not res.shapes:
            raise SystemExit(f"{path}: script produced no shapes")
        return shapelib.union(*res.shapes), res
    return frep.load(path)[0].tree, None


def _load(path: str):
    from .tape.tape import compile_tree
    return compile_tree(_load_tree(path)[0])


def _device(args):
    """The device the command runs on: ``--device``, ``cuda`` by default.
    A missing card is an error here, never a reason to use the CPU."""
    from .ops.tape_data import resolve_device
    name = getattr(args, "device", "cuda")
    return resolve_device(None if name == "cuda" else name)


def _save(path, img):
    from .io.png import write_png
    write_png(path, img)
    print(f"wrote {path}", file=sys.stderr)


def _depth_to_u8(depth, size):
    return (depth.astype(np.float32) / size * 255.0).astype(np.uint8)


def _normals_to_rgb(normals):
    return ((normals * 127.0) + 128.0).clip(0, 255).astype(np.uint8)


def _apply_sets(tape, sets):
    """--set NAME=VALUE overrides for named vars (frontend var()):
    pure imm-vector data, so the same kernels serve every value
    (Tape.imms_with)."""
    if not sets:
        return tape
    import dataclasses
    vals = {}
    for s in sets:
        name, eq, v = s.partition("=")
        if not eq:
            raise SystemExit(f"--set expects NAME=VALUE, got {s!r}")
        vals[name] = float(v)
    missing = [k for k in vals if k not in tape.params]
    if missing:
        raise SystemExit(f"unknown var(s) {missing}; this shape has "
                         f"{sorted(tape.params) or 'none'}")
    return dataclasses.replace(tape, imms=tape.imms_with(vals))


def cmd_render2d(args):
    from .render import brute, pipeline2d, unrolled
    dev = _device(args)
    tape = _apply_sets(_load(args.file), getattr(args, "sets", None))
    if getattr(args, "sharded", False):
        from .parallel import sharded
        fn = (sharded.render2d_sharded_unrolled
              if args.engine == "unrolled" else sharded.render2d_sharded)
    else:
        fn = (brute.render2d_brute if args.brute else
              unrolled.render2d if args.engine == "unrolled" else
              pipeline2d.render2d)
    img = fn(tape, size=args.size, device=dev)
    _save(args.out, (img * np.uint8(255)))
    if args.check:
        # CPU-oracle cross-check, the render_2d.cpp:71-74 analog (exact:
        # both paths evaluate the same clause semantics)
        from . import oracle
        from .render import camera
        p = camera.pixel_centers(args.size)
        X, Y = np.meshgrid(p, p)
        ref = oracle.eval_f(tape, X, Y) < 0
        mism = (ref != img).mean()
        print(f"oracle cross-check: mismatch {mism:.2e}")
        if mism > 1e-4:
            sys.exit(f"FAIL: {mism:.2%} pixels differ from the oracle")


def _add_ssao_flags(p):
    p.add_argument("--ssao-mode", default=None,
                   choices=["static", "gather"],
                   help="static: gather-free fixed-offset AO; gather: the "
                        "reference's rotated-hemisphere mechanism "
                        "(default: config.ssao_mode)")
    p.add_argument("--ao-scale", type=int, default=None, metavar="K",
                   help="compute raw AO at 1/K resolution (1 = full-res "
                        "reference-parity; default: config auto)")


def _ssao_override(args):
    """config.override(...) context from the --ssao-mode/--ao-scale flags
    (full-res reference-parity AO must be reachable from the command line
    without editing code)."""
    from . import config
    kw = {}
    if getattr(args, "ssao_mode", None) is not None:
        kw["ssao_mode"] = args.ssao_mode
    if getattr(args, "ao_scale", None) is not None:
        kw["ao_scale"] = args.ao_scale
    return config.override(**kw)


def cmd_render3d(args):
    from .render import camera, effects
    if getattr(args, "sharded", False):
        from .parallel import sharded
        render3d = (sharded.render3d_sharded_unrolled
                    if args.engine == "unrolled"
                    else sharded.render3d_sharded)
    elif args.engine == "unrolled":
        from .render.unrolled import render3d
    else:
        from .render.pipeline3d import render3d
    dev = _device(args)
    tape = _apply_sets(_load(args.file), getattr(args, "sets", None))
    mat = camera.bench3d_view() if args.view == "bench" else (
        camera.gui3d_view() if args.view == "gui" else camera.identity3())
    depth, normals = render3d(tape, mat=mat, size=args.size, device=dev)
    base = args.out.rsplit(".", 1)[0]
    if args.mode in ("heightmap", "all"):
        _save(f"{base}_depth.png", _depth_to_u8(depth, args.size))
    if args.mode in ("normals", "all"):
        _save(f"{base}_norm.png", _normals_to_rgb(normals))
    with _ssao_override(args):
        if args.mode in ("ssao", "all"):
            occ = effects.draw_ssao(depth, normals, device=dev).cpu().numpy()
            _save(f"{base}_ssao.png", (occ * 255).astype(np.uint8))
        if args.mode in ("shaded", "all"):
            img = effects.draw_shaded(depth, normals,
                                      device=dev).cpu().numpy()
            _save(f"{base}_shaded.png", (img * 255).astype(np.uint8))


def _profiler(profile_dir):
    """``--profile DIR``: a torch.profiler trace of the table's frames
    (CPU and, on a card, CUDA activity), written as a Chrome trace."""
    if not profile_dir:
        return contextlib.nullcontext()
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    print(f"writing profiler trace to {profile_dir}", file=sys.stderr)

    @contextlib.contextmanager
    def ctx():
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return ctx()


def _table(sizes, frame_of_size, stop_ms=None, profile_dir=None):
    from .utils.timing import time_frames
    with _profiler(profile_dir):
        print(f"{'size':>6} {'mean_ms':>10}")
        for size in sizes:
            frame, fargs = frame_of_size(size)
            ms = time_frames(frame, *fargs, n=args_runs(size), n0=5)
            print(f"{size:>6} {ms:>10.4f}")
            if stop_ms and ms > stop_ms:
                print(f"(stopped: mean > {stop_ms} ms)", file=sys.stderr)
                break


def args_runs(size):
    return 50 if size <= 1024 else 20


def cmd_table2d(args):
    # sizes per reference/benchmark/render_2d_table.cpp:50
    import torch
    from .ops.tape_data import TapeData
    from .render import camera, pipeline2d, unrolled
    dev = _device(args)
    tape = _load(args.file)
    mat = torch.as_tensor(camera.identity2(), device=dev)
    z = torch.tensor(0.0, dtype=torch.float32, device=dev)

    if args.engine == "unrolled":
        r = unrolled.get_renderer(tape)

        def frame_of_size(size):
            def frame(mat):
                return r.frame2d(mat, z, size)[0]
            return frame, (mat,)
    else:
        td = TapeData.from_tape(tape, device=dev)

        def frame_of_size(size):
            def frame(mat):
                return pipeline2d.render_tile_block(td, mat, z, size)[0]
            return frame, (mat,)

    sizes = args.sizes or [256, 512, 1024, 2048, 3072, 4096]
    _table(sizes, frame_of_size, profile_dir=args.profile)


def cmd_table3d(args):
    # sizes + 750 ms stop per benchmark/render_3d_table.cpp:51,71-73.  The
    # 3D stages size themselves from counts read back each frame, so there
    # is no capacity to converge before timing.
    import torch
    from .ops.tape_data import TapeData
    from .render import camera, pipeline3d, unrolled
    dev = _device(args)
    tape = _load(args.file)
    mat = torch.as_tensor(camera.bench3d_view(), device=dev)

    if args.engine == "unrolled":
        r = unrolled.get_renderer(tape)

        def frame_of_size(size):
            base = r.steady_frame3d(camera.bench3d_view(), size, device=dev)
            return (lambda mat: base(mat)[0]), (mat,)
    else:
        td = TapeData.from_tape(tape, device=dev)

        def frame_of_size(size):
            def frame(mat):
                return pipeline3d.render3d_rows(td, mat, size, 0,
                                                size // pipeline3d.TILE,
                                                True)[0]
            return frame, (mat,)

    sizes = args.sizes or [256, 512, 1024, 1536, 2048]
    _table(sizes, frame_of_size, stop_ms=750.0, profile_dir=args.profile)


def cmd_brute(args):
    """Three-way consistency + speed comparison, like benchmark/brute.cu:
    (a) the tape as one generated kernel (``unrolled-CUDA``; its plain
    torch version on the CPU, ``unrolled-torch``), (b) the brute
    interpreter, (c) the full culling pipeline."""
    import torch
    from .ops import eval_scan
    from .ops.tape_data import TapeData
    from .render import brute, camera, pipeline2d
    from .utils.timing import time_frames
    dev = _device(args)
    tape = _load(args.file)
    td = TapeData.from_tape(tape, device=dev)
    size = args.size
    mat = torch.as_tensor(camera.identity2(), device=dev)
    z = torch.tensor(0.0, dtype=torch.float32, device=dev)

    img_c = pipeline2d.render2d(tape, size=size, device=dev)
    img_b = brute.render2d_brute(tape, size=size, device=dev)
    agree = (img_c == img_b).mean()
    print(f"culling vs brute agreement: {agree:.6f}")

    p = brute._centers(size, dev)
    f_unrolled = brute.build_unrolled_f(tape)

    def frame_a(mat):
        x, y = camera.transform2(mat, p[None, :], p[:, None])
        return f_unrolled(x.expand(size, size), y.expand(size, size)) < 0.0

    def frame_b(mat):
        x, y = camera.transform2(mat, p[None, :], p[:, None])
        return eval_scan.eval_f(td, x.expand(size, size),
                                y.expand(size, size)) < 0.0

    def frame_c(mat):
        return pipeline2d.render_tile_block(td, mat, z, size)[0]

    name_a = "unrolled-CUDA" if dev.type == "cuda" else "unrolled-torch"
    for name, f in [(name_a, frame_a), ("brute-interp", frame_b),
                    ("full-pipeline", frame_c)]:
        ms = time_frames(f, mat, n=20, n0=3)
        print(f"{name:>14}: {ms:9.3f} ms @ {size}")


def _tile_stage_2d(tape, size, dev):
    """Kernel A over the 64-px tiles of a size² frame under the identity
    view: ``(td, status, codes, remap)``."""
    import torch
    from .ops import kernels
    from .ops.tape_data import TapeData
    from .render import camera
    from .render.pipeline2d import TILE, _tile_boxes_2d
    td = TapeData.from_tape(tape, device=dev)
    _, remap = kernels.build_remap(td.ops_present)
    boxes = _tile_boxes_2d(size // TILE,
                           torch.as_tensor(camera.identity2(), device=dev),
                           torch.tensor(0.0, dtype=torch.float32, device=dev))
    status, codes = kernels.interval_shorten(
        td.meta(), td.packed, td.imms, boxes,
        s_cap=max(8, -(-td.num_slots // 8) * 8), levels=td.levels)
    return td, status, codes, torch.as_tensor(remap, device=dev)


def cmd_shorten_stats(args):
    """Per-tile shortened-tape length distribution at the 64-px stage:
    the tape_shortening figure data (benchmark/tape_shortening.cpp; that
    executable ships broken, referencing a missing .frep, so this is the
    working equivalent)."""
    from .ops import kernels
    from .render.pipeline2d import TILE, _shorten_prepass
    tape = _load(args.file)
    n_side = args.size // TILE
    td, status, codes, remap = _tile_stage_2d(tape, args.size, _device(args))
    _, _, _, lens = _shorten_prepass(codes, td.packed, td.imms, td.length,
                                     remap)
    status = status.cpu().numpy()
    lens = lens.cpu().numpy()
    amb = lens[status == kernels.ST_AMBIG]
    print(f"tape length {tape.length}; tiles {n_side}x{n_side}: "
          f"empty {(status == 0).sum()} filled {(status == 1).sum()} "
          f"ambiguous {(status == 2).sum()}")
    if len(amb):
        q = np.percentile(amb, [0, 25, 50, 75, 90, 100]).astype(int)
        print(f"shortened lengths (ambiguous tiles): min {q[0]} p25 {q[1]} "
              f"median {q[2]} p75 {q[3]} p90 {q[4]} max {q[5]} "
              f"mean {amb.mean():.1f} ({amb.mean() / tape.length:.1%} "
              "of full)")


def cmd_circle_figure(args):
    """Stage-decision figure for a circle: colors each pixel by which
    stage decided it (benchmark/circle.cpp:42-103)."""
    from .frontend import shapes
    from .render.pipeline2d import TILE, render2d
    from .tape.tape import compile_tree
    dev = _device(args)
    tape = compile_tree(shapes.circle(0.8))
    size = args.size
    n_side = size // TILE
    _, status, _, _ = _tile_stage_2d(tape, size, dev)
    status = status.cpu().numpy().reshape(n_side, n_side)
    img = render2d(tape, size=size, device=dev)
    rgb = np.zeros((size, size, 3), np.uint8)
    st = np.repeat(np.repeat(status, TILE, 0), TILE, 1)
    rgb[st == 0] = (40, 40, 40)        # tile-stage empty
    rgb[st == 1] = (60, 120, 220)      # tile-stage filled
    rgb[(st == 2) & img] = (240, 160, 40)    # pixel-stage filled
    rgb[(st == 2) & ~img] = (120, 80, 20)    # pixel-stage empty
    _save(args.out, rgb)


def _heat_png(path, h):
    h = h / max(h.max(), 1e-9)
    _save(path, (np.sqrt(h) * 255).astype(np.uint8))


def cmd_heatmap2d(args):
    if args.engine == "unrolled":
        from .render.workmap import workmap2d
        heat, totals = workmap2d(_load(args.file), size=args.size,
                                 device=_device(args))
        print(json.dumps(totals))
        _heat_png(args.out, heat)
        return
    from .render.heatmap import render2d_heatmap
    _heat_png(args.out, render2d_heatmap(_load(args.file), size=args.size,
                                         device=_device(args)))


def cmd_heatmap3d(args):
    from .render import camera
    if args.engine == "unrolled":
        from .render.workmap import workmap3d
        heat, totals = workmap3d(_load(args.file),
                                 mat=camera.bench3d_view(), size=args.size,
                                 device=_device(args))
        print(json.dumps(totals))
        _heat_png(args.out, heat)
        return
    from .render.heatmap import render3d_heatmap
    _heat_png(args.out, render3d_heatmap(_load(args.file),
                                         mat=camera.bench3d_view(),
                                         size=args.size,
                                         device=_device(args)))


def cmd_table_effects(args):
    """Frame times for depth+normals / +SSAO / +shaded at each size: the
    render_effects benchmark (reference/benchmark/render_effects.cpp), on
    the unrolled engine."""
    import torch
    from .render import camera, effects, unrolled
    from .utils.timing import time_frames
    dev = _device(args)
    r = unrolled.get_renderer(_load(args.file))
    mat_np = camera.bench3d_view()
    mat = torch.as_tensor(mat_np, device=dev)
    print(f"{'size':>6} {'depth+normals':>14} {'+ssao':>10} "
          f"{'+shaded':>10}   (ms/frame)")
    for size in (int(s) for s in args.sizes.split(",")):
        base = r.steady_frame3d(mat_np, size, device=dev)

        def f_plain(mat):
            return base(mat)[0]

        def f_ssao(mat):
            depth, normals = base(mat)
            return effects.draw_ssao(depth, normals)

        def f_shaded(mat):
            depth, normals = base(mat)
            return effects.draw_shaded(depth, normals)

        with _ssao_override(args):
            cols = [time_frames(f, mat, n=args.frames, n0=3)
                    for f in (f_plain, f_ssao, f_shaded)]
        print(f"{size:>6} {cols[0]:>14.2f} {cols[1]:>10.2f} "
              f"{cols[2]:>10.2f}", flush=True)


def cmd_tape_time(args):
    # mean tape construction time over 100 builds
    # (reference/benchmark/tape_building_time.cpp:44-57)
    from .tape.tape import compile_tree
    tree, _ = _load_tree(args.file)
    compile_tree(tree)
    t0 = time.perf_counter()
    for _ in range(100):
        compile_tree(tree)
    ms = (time.perf_counter() - t0) / 100 * 1e3
    print(f"tape build: {ms:.3f} ms mean over 100")


def cmd_dump_tape(args):
    # clause listing, like benchmark/print_tape_table.cpp:44-51
    tape = _load(args.file)
    print(tape.pretty(limit=args.limit))
    print(f"length={tape.length} slots={tape.num_slots} "
          f"choices={tape.num_choices}")


def cmd_convert(args):
    """Convert any loadable shape source (a ``.npz`` tape checkpoint, a
    ``.frep`` archive, a ``.io`` scene or a ``stress:N`` synthetic model)
    into a ``.frep`` archive via the tape decompiler (tape/decompile.py).
    The reference has no such path: its tapes are a one-way GPU upload
    (reference/src/tape.cpp:223-227)."""
    from .frontend import frep
    from .io import checkpoint
    from .tape.decompile import tape_to_tree
    if args.file.endswith(".npz"):
        tape = checkpoint.load_tape(args.file)
    else:
        tape = _load(args.file)
    frep.dump([frep.ArchiveShape(tree=tape_to_tree(tape), name=args.name)],
              args.out)
    print(f"wrote {args.out}", file=sys.stderr)


def cmd_mesh(args):
    """Mesh extraction and STL / OBJ export (io/mesh.py): the geometry
    export the reference's users go back to libfive for."""
    from .io import mesh
    from .tape.tape import compile_tree
    dev = _device(args)
    tree, script = _load_tree(args.file)
    lo, hi = args.bounds
    if (tuple(args.bounds) == (-1.0, 1.0) and script is not None
            and script.bounds is not None):
        # honor the scene's (set-bounds! lo hi) when the user didn't pass
        # --bounds (per-axis; the box need not be a cube)
        lo = np.asarray(script.bounds[0], np.float32)
        hi = np.asarray(script.bounds[1], np.float32)
        print(f"using script bounds {script.bounds}", file=sys.stderr)
    tape = compile_tree(tree)
    tris = mesh.mesh_tape(tape, n=args.size, lo=lo, hi=hi,
                          method=args.method, device=dev)
    if args.out.endswith(".obj"):
        mesh.write_obj(args.out, tris)
    else:
        mesh.write_stl(args.out, tris)
    print(f"mesh: {len(tris)} triangles, area {mesh.mesh_area(tris):.4f}, "
          f"volume {mesh.mesh_volume(tris):.4f}")
    print(f"wrote {args.out}", file=sys.stderr)


def _oracle_fill(tape, size):
    """NumPy-oracle boolean fill image (the fit target and render-out
    convention, one definition so the two can't drift apart)."""
    from . import oracle
    from .render import camera
    p = camera.pixel_centers(size)
    X, Y = np.meshgrid(p, p)
    return oracle.eval_f(tape, X, Y) < 0


def _oracle_depth(tape, size):
    """NumPy-oracle dense-grid depth (voxel units, the render3d depth
    convention: 0 = empty, else top filled voxel index + 1)."""
    from . import oracle
    from .render import camera
    c = camera.pixel_centers(size)
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    filled = oracle.eval_f(tape, X, Y, Z) < 0
    zi = np.arange(size, dtype=np.float32)[:, None, None] + 1.0
    return np.max(np.where(filled, zi, 0.0), axis=0)


def cmd_fit(args):
    """Differentiable fitting: gradient-descend FILE's tape constants until
    its soft render matches a target, another model's oracle render
    (.frep, .io, stress:N) or a grayscale PNG (the render2d / render3d
    conventions).  --mode 2d fits a fill image; --mode 3d a depth image
    through volume compositing.  Steps run over the ranks of the default
    process group (one process: the whole image); --engine scan
    differentiates the interpreter (kernel K2 on a card), unrolled and
    culled the generated float evaluator (kernel K1)
    (parallel/sharded.py)."""
    import torch

    from .io import checkpoint
    from .ops.tape_data import TapeData
    from .parallel import sharded
    from .render import camera
    dev = _device(args)
    tape = _load(args.file)
    fit3d = args.mode == "3d"
    grad_mask = None
    if args.params_only:
        if not tape.params:
            sys.exit("--params-only: the shape declares no named vars")
        grad_mask = np.zeros(tape.length, np.float32)
        for idxs in tape.params.values():
            grad_mask[list(idxs)] = 1.0
    # 3d's dense grid is cubed (size^3 voxels through the gradient every
    # step): default small; the culled (depth-window) engine is
    # O(size^2 * window) and affords render-resolution fits
    if args.size is not None:
        size = args.size
    elif fit3d:
        size = 128 if args.engine == "culled" else 32
    else:
        size = 256
    lr = args.lr
    if lr is None:
        # voxel-unit losses steepen with resolution
        lr = (2e-5 if args.engine == "culled" else 3e-4) if fit3d else 1e-2
    if args.target.endswith(".png"):
        from .io.png import read_png_gray
        tgt = read_png_gray(args.target).astype(np.float32) / 255.0
        if tgt.shape != (size, size):
            sys.exit(f"target is {tgt.shape}, expected {(size, size)}")
        if fit3d:
            tgt *= size       # undo render3d's _depth_to_u8 scaling
    elif fit3d:
        tgt = _oracle_depth(_load(args.target), size)
    else:
        tgt = _oracle_fill(_load(args.target), size).astype(np.float32)
    mesh = sharded.make_mesh()
    tgt_t = torch.as_tensor(tgt, device=dev)
    every = max(1, args.steps // 10)
    kw = dict(lr=lr, grad_mask=grad_mask, device=dev)
    state = torch.as_tensor(tape.imms, device=dev)
    if fit3d and args.engine == "culled":
        step = sharded.make_fit_step_3d_window(tape, size, mesh, **kw)
    elif fit3d:
        step = sharded.make_fit_step_3d(tape, size, mesh, **kw)
    elif args.engine == "culled":
        step = sharded.make_fit_step_culled(tape, size, mesh, **kw)
    elif args.engine == "unrolled":
        step = sharded.make_fit_step_unrolled(tape, size, mesh, **kw)
    else:
        step = sharded.make_fit_step(size, mesh, lr=lr, grad_mask=grad_mask)
        state = TapeData.from_tape(tape, device=dev)
    for i in range(args.steps):
        loss, state = step(state, tgt_t)
        if i % every == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.6f}")
    fitted = (state.imms if isinstance(state, TapeData) else state)
    checkpoint.save_tape(args.out, tape, imms=fitted.cpu().numpy())
    print(f"wrote {args.out}", file=sys.stderr)
    if args.out_frep:
        # decompile the fitted tape back to an expression and archive it:
        # the artifact loads anywhere .frep does
        from .frontend import frep
        from .tape.decompile import tape_to_tree
        t2 = checkpoint.load_tape(args.out)
        frep.dump([frep.ArchiveShape(tree=tape_to_tree(t2), name="fitted")],
                  args.out_frep)
        print(f"wrote {args.out_frep}", file=sys.stderr)
    if args.render_out:
        t2 = checkpoint.load_tape(args.out)
        if fit3d:
            _save(args.render_out, _depth_to_u8(_oracle_depth(t2, size),
                                                size))
        else:
            _save(args.render_out, _oracle_fill(t2, size) * np.uint8(255))


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu (the "
                        "plain PyTorch versions of the kernels)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mpr_tpu_torch.cli",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render2d")
    p.add_argument("file")
    p.add_argument("--set", dest="sets", action="append", metavar="NAME=V",
                   help="override a named var (frontend var() / Scheme "
                   "(var ...)); repeatable")
    p.add_argument("--engine", default="interp",
                   choices=["interp", "unrolled"],
                   help="interp: the interpreter kernels, no per-tape "
                        "build; unrolled: kernels generated for the tape "
                        "(built at its first frame, then kept)")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--out", default="out_2d.png")
    p.add_argument("--brute", action="store_true")
    p.add_argument("--sharded", action="store_true",
                   help="shard tile rows over the ranks of the default "
                        "process group (either engine; equal to the "
                        "one-device image)")
    p.add_argument("--check", action="store_true",
                   help="cross-check against the NumPy oracle")
    _add_device(p)
    p.set_defaults(fn=cmd_render2d)

    p = sub.add_parser("render3d")
    p.add_argument("file")
    p.add_argument("--set", dest="sets", action="append", metavar="NAME=V",
                   help="override a named var; repeatable")
    p.add_argument("--engine", default="interp",
                   choices=["interp", "unrolled"])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="out_3d.png")
    p.add_argument("--mode", default="all",
                   choices=["heightmap", "normals", "ssao", "shaded", "all"])
    p.add_argument("--view", default="bench",
                   choices=["identity", "bench", "gui"])
    p.add_argument("--sharded", action="store_true",
                   help="shard tile rows over the ranks of the default "
                        "process group")
    _add_ssao_flags(p)
    _add_device(p)
    p.set_defaults(fn=cmd_render3d)

    for name, fn in [("table2d", cmd_table2d), ("table3d", cmd_table3d)]:
        p = sub.add_parser(name)
        p.add_argument("file")
        p.add_argument("--engine", default="unrolled",
                       choices=["interp", "unrolled"],
                       help="benchmark tables default to the unrolled "
                            "engine (the repeated-render regime the "
                            "reference protocol measures)")
        p.add_argument("--sizes", type=lambda s: [int(x) for x in
                                                  s.split(",")],
                       default=None)
        p.add_argument("--profile", default=None, metavar="DIR",
                       help="write a torch.profiler trace")
        _add_device(p)
        p.set_defaults(fn=fn)

    p = sub.add_parser("brute")
    p.add_argument("file")
    p.add_argument("--size", type=int, default=1024)
    _add_device(p)
    p.set_defaults(fn=cmd_brute)

    p = sub.add_parser("shorten-stats")
    p.add_argument("file")
    p.add_argument("--size", type=int, default=1024)
    _add_device(p)
    p.set_defaults(fn=cmd_shorten_stats)

    p = sub.add_parser("circle-figure")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--out", default="out_circle.png")
    _add_device(p)
    p.set_defaults(fn=cmd_circle_figure)

    p = sub.add_parser("heatmap2d")
    p.add_argument("file")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--out", default="out_heat2d.png")
    p.add_argument("--engine", choices=["interp", "unrolled"],
                   default="interp",
                   help="unrolled: the unrolled engine's work map "
                        "(render/workmap.py), work totals on stdout")
    _add_device(p)
    p.set_defaults(fn=cmd_heatmap2d)

    p = sub.add_parser("heatmap3d")
    p.add_argument("file")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="out_heat3d.png")
    p.add_argument("--engine", choices=["interp", "unrolled"],
                   default="interp",
                   help="unrolled: the unrolled engine's work map "
                        "(render/workmap.py), work totals on stdout")
    _add_device(p)
    p.set_defaults(fn=cmd_heatmap3d)

    p = sub.add_parser("table-effects")
    p.add_argument("file")
    p.add_argument("--sizes", default="1024")
    p.add_argument("--frames", type=int, default=20)
    _add_ssao_flags(p)
    _add_device(p)
    p.set_defaults(fn=cmd_table_effects)

    p = sub.add_parser("tape-time")
    p.add_argument("file")
    p.set_defaults(fn=cmd_tape_time)

    p = sub.add_parser("dump-tape")
    p.add_argument("file")
    p.add_argument("--limit", type=int, default=60)
    p.set_defaults(fn=cmd_dump_tape)

    p = sub.add_parser("convert", help="decompile any shape source "
                       "(.npz checkpoint / .frep / .io / stress:N) to a "
                       ".frep archive")
    p.add_argument("file")
    p.add_argument("out")
    p.add_argument("--name", default="converted")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("fit", help="fit tape constants to a target image")
    p.add_argument("file")
    p.add_argument("--target", required=True,
                   help=".frep / .io / stress:N (oracle-rendered) or "
                        "grayscale .png")
    p.add_argument("--mode", default="2d", choices=["2d", "3d"],
                   help="2d: soft fill vs a fill image; 3d: volume-"
                        "compositing soft depth vs a depth image "
                        "(--size is the voxel grid side, CUBED in "
                        "memory: keep it small)")
    p.add_argument("--size", type=int, default=None,
                   help="default 256 (2d) / 32 (3d: size^3 voxels a "
                        "gradient step) / 128 (3d culled)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--params-only", action="store_true",
                   help="update only the named vars (frontend var() / "
                        "Scheme (var ...)) and freeze every other constant")
    p.add_argument("--lr", type=float, default=None,
                   help="default 1e-2 (2d) / 3e-4 (3d) / 2e-5 (3d culled)")
    p.add_argument("--engine", default="scan",
                   choices=["scan", "unrolled", "culled"],
                   help="scan: the interpreter (kernels K2f/K2); unrolled: "
                        "the generated float evaluator on every pixel "
                        "(K1); culled: the unrolled ladder with the "
                        "backward pass on ambiguous tiles only (2d) / a "
                        "depth window (3d)")
    p.add_argument("--out", default="fitted.npz")
    p.add_argument("--out-frep", default="",
                   help="also decompile the fitted tape to a .frep archive")
    p.add_argument("--render-out", default="",
                   help="also render the fitted tape (oracle) to PNG")
    _add_device(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("mesh", help="extract a watertight triangle mesh "
                       "(marching tetrahedra over the unrolled evaluator) "
                       "and write binary STL or OBJ")
    p.add_argument("file")
    p.add_argument("--size", type=int, default=64,
                   help="voxel grid resolution per axis")
    p.add_argument("--bounds", type=float, nargs=2, default=(-1.0, 1.0),
                   metavar=("LO", "HI"))
    p.add_argument("--method", default="mt", choices=("mt", "dc"),
                   help="mt: marching tetrahedra (robust); dc: dual "
                        "contouring (sharp edges from forward-mode "
                        "normals)")
    p.add_argument("--out", default="out.stl",
                   help=".stl (binary) or .obj (welded vertices)")
    _add_device(p)
    p.set_defaults(fn=cmd_mesh)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
