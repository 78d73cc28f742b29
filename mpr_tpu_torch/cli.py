"""Command-line render & benchmark suite on the interpreter engine.

Counterpart of ``mpr_tpu.cli`` (the reference's benchmark executables,
reference/benchmark/CMakeLists.txt:18-32, behind one entry point), with
the same arguments, outputs and printed lines:

    python -m mpr_tpu_torch.cli render2d FILE.frep --size 1024 --out out.png
    python -m mpr_tpu_torch.cli render3d FILE.frep --size 512 --mode shaded
    python -m mpr_tpu_torch.cli table2d FILE.frep        # render_2d_table
    python -m mpr_tpu_torch.cli table3d FILE.frep        # render_3d_table
    python -m mpr_tpu_torch.cli brute FILE.frep          # brute comparison
    python -m mpr_tpu_torch.cli tape-time FILE.frep      # tape_building_time
    python -m mpr_tpu_torch.cli dump-tape FILE.frep      # print_tape_table

FILE is a ``.frep`` archive, a ``.io`` Scheme scene or ``stress:N``.
Every command runs on ``--device`` (default ``cuda``): without a card it
fails, and ``--device cpu`` is the way to ask for the plain PyTorch
versions of the kernels.  The unrolled engine, the sharded renderers,
``table-effects``, ``fit`` and ``mesh`` of ``mpr_tpu.cli`` are not ported
yet and not registered.

Timing protocol: warm-up + timed-runs mean, like benchmark/stats.cpp:19-47
(utils/timing.py: CUDA events around the timed runs).
"""

from __future__ import annotations

import argparse
import contextlib
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
    from .render import brute, pipeline2d
    dev = _device(args)
    tape = _apply_sets(_load(args.file), getattr(args, "sets", None))
    fn = brute.render2d_brute if args.brute else pipeline2d.render2d
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
    from .render import camera, pipeline2d
    dev = _device(args)
    td = TapeData.from_tape(_load(args.file), device=dev)
    mat = torch.as_tensor(camera.identity2(), device=dev)
    z = torch.tensor(0.0, dtype=torch.float32, device=dev)

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
    from .render import camera, pipeline3d
    dev = _device(args)
    td = TapeData.from_tape(_load(args.file), device=dev)
    mat = torch.as_tensor(camera.bench3d_view(), device=dev)

    def frame_of_size(size):
        def frame(mat):
            return pipeline3d.render3d_rows(td, mat, size, 0,
                                            size // pipeline3d.TILE, True)[0]
        return frame, (mat,)

    sizes = args.sizes or [256, 512, 1024, 1536, 2048]
    _table(sizes, frame_of_size, stop_ms=750.0, profile_dir=args.profile)


def cmd_brute(args):
    """Consistency + speed comparison, like benchmark/brute.cu: the brute
    interpreter against the full culling pipeline."""
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

    def frame_b(mat):
        x, y = camera.transform2(mat, p[None, :], p[:, None])
        return eval_scan.eval_f(td, x.expand(size, size),
                                y.expand(size, size)) < 0.0

    def frame_c(mat):
        return pipeline2d.render_tile_block(td, mat, z, size)[0]

    for name, f in [("brute-interp", frame_b), ("full-pipeline", frame_c)]:
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
    from .render.heatmap import render2d_heatmap
    _heat_png(args.out, render2d_heatmap(_load(args.file), size=args.size,
                                         device=_device(args)))


def cmd_heatmap3d(args):
    from .render import camera
    from .render.heatmap import render3d_heatmap
    _heat_png(args.out, render3d_heatmap(_load(args.file),
                                         mat=camera.bench3d_view(),
                                         size=args.size,
                                         device=_device(args)))


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
    p.add_argument("--engine", default="interp", choices=["interp"],
                   help="interp: the interpreter kernels, no per-shape "
                        "build")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--out", default="out_2d.png")
    p.add_argument("--brute", action="store_true")
    p.add_argument("--check", action="store_true",
                   help="cross-check against the NumPy oracle")
    _add_device(p)
    p.set_defaults(fn=cmd_render2d)

    p = sub.add_parser("render3d")
    p.add_argument("file")
    p.add_argument("--set", dest="sets", action="append", metavar="NAME=V",
                   help="override a named var; repeatable")
    p.add_argument("--engine", default="interp", choices=["interp"])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="out_3d.png")
    p.add_argument("--mode", default="all",
                   choices=["heightmap", "normals", "ssao", "shaded", "all"])
    p.add_argument("--view", default="bench",
                   choices=["identity", "bench", "gui"])
    _add_ssao_flags(p)
    _add_device(p)
    p.set_defaults(fn=cmd_render3d)

    for name, fn in [("table2d", cmd_table2d), ("table3d", cmd_table3d)]:
        p = sub.add_parser(name)
        p.add_argument("file")
        p.add_argument("--engine", default="interp", choices=["interp"])
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
    p.add_argument("--engine", choices=["interp"], default="interp")
    _add_device(p)
    p.set_defaults(fn=cmd_heatmap2d)

    p = sub.add_parser("heatmap3d")
    p.add_argument("file")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", default="out_heat3d.png")
    p.add_argument("--engine", choices=["interp"], default="interp")
    _add_device(p)
    p.set_defaults(fn=cmd_heatmap3d)

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

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
