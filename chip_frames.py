#!/usr/bin/env python3
"""Frame times, cold first frames and fit steps of the port on one CUDA card.

    python3 chip_frames.py [--what frames|cold|fits|unrolled|options|
                                   builds|v1] [--root DIR] [--label NAME]

Each mode runs the ``mpr_tpu_torch`` package found in DIR (default: this
script's directory), so that two checkouts can be timed in turns on one
card, and ends with one JSON line of all it measured and the card's name
and power limit.  It checks nothing: ``chip_smoke.py`` is the check.
Exits non-zero without a card.

``frames`` (default): the interpreter engine on the four cells of
``chip_smoke.py`` (``CASES``: ``stress_2d`` at 1024^2 and 2048^2 through
``pipeline2d.render_tile_block``; ``CASES_3D``: ``gyroid_sphere`` at
1024^3 and ``extruded_stress`` at 512^3 through
``pipeline3d.render3d_rows`` with normals).  For each cell the frame time
(CUDA events around a frame, median of 20 frames in 2D and 10 in 3D,
after warm-up) and the device time (torch.profiler, mean of 10 launches)
of every launch of kernels A and C a frame makes.

``cold``: the unrolled engine's first frame on an empty build directory of
its generated kernels, as a user's first frame of a new tape: the 2D cell
(``stress_2d(600)`` at 1024^2) and the extruded cell (512^3, normals).
Host clock from making the renderer to the frame's end, the generated
kernels' count and each one's nvcc seconds by semantics and form, and
the second frame's host time.

``builds``: the kernel libraries of ``ops/build.py`` (``main``, then
``extra``) compiled as it compiles them, every source's nvcc started
together, into a fresh directory: each library's seconds with its link
and each source's nvcc seconds (host clock) and kernel count (ptxas
entries).

``v1``: kernels C1 and B1 as ``chip_smoke.py`` phase 9 calls them: C1 on
the 1024^2 frame's ambiguous tiles at cap = Tcap, B1 on its tapes, and B1
on the full tape of the 2048^2 cell on 8 tiles (the picked shape, and,
where this checkout's ``pixel_v1_launch`` takes an int ``stage``, the
whole tape staged, held against the picked shape bit for bit).  For each
the time with CUDA events around a call (median of 30), the device time
(torch.profiler) and the wrapper's host time a call (200 calls back to
back).

``unrolled``: the unrolled engine's frames on chip_smoke.py phase 13's
cells (``stress_2d(600)`` at 1024^2, the gyroid at 1024^3 and the
extruded model at 512^3, both on the full ladder), built first: each
frame's time (CUDA events, median of 20 in 2D and 10 in 3D, after
warm-up), and the device time (torch.profiler, mean of 10 launches) and
form of every launch of the generated float, interval and deriv kernels
a frame makes, each launched alone on its recorded inputs.

``options``: chip_smoke.py phase 17's frames at its two 3D cells (skip4
off): the single phase, the two-phase voxel stage and the 2^3
sub-refinement, each timed (CUDA events, median of 10 after warm-up) in
turns, single, two-phase, refined, refined, two-phase, single, twice
over.  It needs this checkout's ``mpr_tpu_torch`` (the options' entry
points).

``fits``: chip_smoke.py phase 14's unrolled fit steps (unrolled and
culled 256^2, culled 1024^2, the gyroid's dense grid 32, the extruded
window 512; targets are the unrolled renders of the tapes with seeded
perturbed immediates) and its four meshes at n=128.  Each step's steady
time (CUDA events, median of 10 after 2 steps), each mesh's seconds on
the host clock (the first call, which builds its baked evaluators, and a
second).  The fit steps' kernels are built first, all at once.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("interval_shorten", "compact_bitshift_batched")


def _smoke():
    """chip_smoke.py beside this script (its cells and timing helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorded(tk, frame, names=KERNELS):
    """Every launch of the kernels ``names`` (A and C) one frame makes:
    {name: [(args, kwargs)]}."""
    seen = {name: [] for name in names}
    saved = {name: getattr(tk, name) for name in names}
    for name, fn in saved.items():
        def rec(*a, _fn=fn, _name=name, **k):
            seen[_name].append((a, k))
            return _fn(*a, **k)
        setattr(tk, name, rec)
    try:
        frame()
    finally:
        for name, fn in saved.items():
            setattr(tk, name, fn)
    return seen


def cold_frames(sm, card, label) -> dict:
    """``--what cold``: see the module's docstring."""
    import shutil
    import tempfile
    import time
    from pathlib import Path
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.render import camera, unrolled
    n_blobs, size = sm.CASES[0]
    name, make, view, size3 = sm.CASES_3D[1]
    cells = [(f"stress_2d({n_blobs}) {size}^2",
              lambda S: S.stress_2d(n_blobs),
              lambda r: r.render2d(size=size)),
             (f"{name} {size3}^3", make,
              lambda r: r.render3d(mat=camera.gui3d_view(*view),
                                   size=size3))]
    out = {}
    for cell, tree, frame in cells:
        tape = mpr_tpu_torch.compile_tree(tree(shapes))
        ue.UNROLLED_ROOT.mkdir(parents=True, exist_ok=True)
        fresh = Path(tempfile.mkdtemp(prefix="cold-",
                                      dir=ue.UNROLLED_ROOT.parent))
        saved, ue.UNROLLED_ROOT = ue.UNROLLED_ROOT, fresh
        try:
            built = set(ue.BUILDS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(unrolled.get_renderer(tape))
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            frame(unrolled.get_renderer(tape))
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
        finally:
            ue.UNROLLED_ROOT = saved
            shutil.rmtree(fresh, ignore_errors=True)
        secs = {f"{b['kind']} {b.get('form', 'serial')}": round(
                    b["seconds"], 2) for k, b in ue.BUILDS.items()
                if k not in built and b["compiled"]}
        out[cell] = {"first_frame_s": round(first, 3),
                     "second_frame_s": round(second, 4),
                     "kernels_built": len(secs),
                     "nvcc_s": secs}
        print(f"{label} {cell}: cold first unrolled frame {first:.3f} s "
              f"(host clock; {len(secs)} generated kernels built, nvcc "
              f"s {secs}), second frame {second:.4f} s  [{card}]",
              flush=True)
    return out


def unrolled_frames(sm, card, label) -> dict:
    """``--what unrolled``: see the module's docstring."""
    import torch
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.render import unrolled
    dev = torch.device("cuda")
    kinds = ("unrolled_interval", "unrolled_float", "unrolled_deriv")
    out = {}
    for cell, tape, mat, size in sm.unrolled_cells():
        r = unrolled.get_renderer(tape)
        if mat is None:
            eye, z = torch.eye(3, device=dev), torch.tensor(0.0, device=dev)
            frame, reps = (lambda: r.frame2d(eye, z, size)), 20
        else:
            m = torch.as_tensor(mat, device=dev)
            frame, reps = (lambda: r.frame3d(m, size, skip4=False)), 10
        frame()
        torch.cuda.synchronize()
        ms = sm.cuda_ms(frame, reps, 3)
        seen = {k: [] for k in kinds}
        saved = {k: getattr(ue, k) for k in kinds}
        for k, fn in saved.items():
            def rec(ev, *a, _fn=fn, _k=k, **kw):
                seen[_k].append((ev, a, kw.get("imms")))
                return _fn(ev, *a, **kw)
            setattr(ue, k, rec)
        try:
            frame()
            torch.cuda.synchronize()
        finally:
            for k, fn in saved.items():
                setattr(ue, k, fn)
        kern = {}
        for k, launches in seen.items():
            for ev, a, imms in launches:
                run, keep = sm.bare_launch(ue, ev, a, imms)
                n = keep[0][0].numel()
                kern.setdefault(k, []).append({
                    "lanes": n, "form": ev.launch(n).tag,
                    "device_ms": sm.device_ms(run, 10,
                                              "mpr_unrolled_kernel", 3)})
                del keep
        out[cell] = {"frame_ms": ms, "launches": kern}
        print(f"{label} {cell} @{size}: frame {ms:.3f} ms (events, median "
              f"of {reps}); device ms " + "; ".join(
                  f"{k[9:]} " + ", ".join(
                      f"{x['form']} {x['lanes']} lanes {x['device_ms']}"
                      for x in v) for k, v in kern.items())
              + f"  [{card}]", flush=True)
    return out


def option_frames(sm, card, label) -> dict:
    """``--what options``: see the module's docstring."""
    import torch
    from mpr_tpu_torch.render import unrolled
    dev = torch.device("cuda")
    out = {}
    for cell, tape, mat, size in sm.unrolled_cells()[1:]:
        r = unrolled.get_renderer(tape)
        m = torch.as_tensor(mat, device=dev)
        frames = {o: sm.option_frame(unrolled, r, m, size, o)
                  for o in sm.OPTIONS}
        turns = {o: [] for o in sm.OPTIONS}
        for o in (list(sm.OPTIONS) + list(reversed(sm.OPTIONS))) * 2:
            turns[o].append(round(sm.cuda_ms(frames[o], 10, 2), 4))
        out[cell] = turns
        print(f"{label} {cell} @{size}: frame ms in turns (events, median "
              f"of 10 each) {turns}  [{card}]", flush=True)
    return out


def fit_steps(sm, card, label) -> dict:
    """``--what fits``: see the module's docstring."""
    import dataclasses
    import time
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.io import mesh as mmesh
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.parallel import sharded
    from mpr_tpu_torch.render import brute, unrolled
    stape = mpr_tpu_torch.compile_tree(shapes.stress_2d(sm.CASES[0][0]))
    (_, gmake, *_), (_, emake, *_) = sm.CASES_3D
    gtape = mpr_tpu_torch.compile_tree(gmake(shapes))
    etape = mpr_tpu_torch.compile_tree(emake(shapes))
    dev = torch.device("cuda")
    evals = []
    for tape in (stape, gtape, etape):
        r = unrolled.get_renderer(tape, imm_inputs=True)
        evals += [r.fi, r.f] + r.f.vjp.evals
    t0 = time.perf_counter()
    ue.build_all(evals)
    build_s = time.perf_counter() - t0
    print(f"{label} fit kernels: {len(evals)} evaluators built in "
          f"{build_s:.1f} s  [{card}]", flush=True)
    rng = np.random.default_rng(14)

    def target(tape, render):
        imms = tape.imms * (1.0 + 0.02 * rng.standard_normal(tape.length))
        out = render(unrolled.get_renderer(tape, imm_inputs=True),
                     imms.astype(np.float32))
        out = out[0] if isinstance(out, tuple) else out
        return torch.as_tensor(np.asarray(out), dtype=torch.float32,
                               device=dev)
    s2, s2b, grid, win = sm.FIT_2D, sm.FIT_2D_BIG, sm.FIT_GRID, sm.FIT_WINDOW
    fills = {s: target(stape, lambda r, i, s=s: r.render2d(size=s, imms=i))
             for s in (s2, s2b)}
    # chip_smoke.py's brute render, here on the host (on the card it would
    # build the interpreter's library)
    depth_grid = target(gtape, lambda r, i: brute.render3d_brute(
        dataclasses.replace(r.tape, imms=i), size=grid, device="cpu"))
    depth_win = target(etape, lambda r, i: r.render3d(
        size=win, imms=i, with_normals=False))
    fits = [(f"unrolled {s2}^2", stape, 1e-2, fills[s2],
             lambda lr: sharded.make_fit_step_unrolled(stape, s2, lr=lr)),
            (f"culled {s2}^2", stape, 1e-2, fills[s2],
             lambda lr: sharded.make_fit_step_culled(stape, s2, lr=lr)),
            (f"culled {s2b}^2", stape, 1e-2, fills[s2b],
             lambda lr: sharded.make_fit_step_culled(stape, s2b, lr=lr)),
            (f"3d grid={grid}", gtape, 3e-5, depth_grid,
             lambda lr: sharded.make_fit_step_3d(gtape, grid, lr=lr)),
            (f"3d window {win}", etape, 2e-5, depth_win,
             lambda lr: sharded.make_fit_step_3d_window(etape, win, lr=lr))]
    out = {"build_s": round(build_s, 2), "steps": {}, "mesh": {}}
    for fit, tape, lr, tgt, make in fits:
        step = make(lr)
        imms = torch.as_tensor(tape.imms, device=dev)
        ms = sm.cuda_ms(lambda: step(imms, tgt), 10, 2)
        out["steps"][fit] = round(ms, 4)
        print(f"{label} fit {fit}: steady step {ms:.4f} ms (events, median "
              f"of 10)  [{card}]", flush=True)
    closed = {"mt": ("drilled sphere", shapes.difference(
                  shapes.sphere(0.7), shapes.cylinder_z(0.3, -1, 1))),
              "dc": ("sphere", shapes.sphere(0.6))}
    for method in ("mt", "dc"):
        for name, tape in (("gyroid_sphere", gtape),
                           (closed[method][0], mpr_tpu_torch.compile_tree(
                               closed[method][1]))):
            secs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mmesh.mesh_tape(tape, n=sm.MESH_N, method=method)
                torch.cuda.synchronize()
                secs.append(round(time.perf_counter() - t0, 3))
            out["mesh"][f"{name} {method}"] = secs
            print(f"{label} mesh {name} n={sm.MESH_N} {method}: first "
                  f"{secs[0]:.3f} s, second {secs[1]:.3f} s (host clock)  "
                  f"[{card}]", flush=True)
    return out


def library_builds(sm, card, label) -> dict:
    """``--what builds``: see the module's docstring."""
    import shutil
    import subprocess
    import tempfile
    import time
    from pathlib import Path
    from mpr_tpu_torch.ops import build
    nvcc = build._nvcc()
    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    out = {}
    for name in build.LIBRARIES:
        cus, _ = build._sources(name)
        flags = build.FLAGS + build.LIBRARIES[name][1]
        tmp = Path(tempfile.mkdtemp(prefix="builds-",
                                    dir=build.BUILD_ROOT.parent))
        try:
            logs = {src.stem: open(tmp / (src.stem + ".log"), "w")
                    for src in cus}
            t0 = time.perf_counter()
            procs = {src.stem: subprocess.Popen(
                [nvcc, *flags, "-I", str(build.CSRC), "-c", str(src), "-o",
                 str(tmp / (src.stem + ".o"))], stdout=logs[src.stem],
                stderr=subprocess.STDOUT) for src in cus}
            done = {}
            while len(done) < len(procs):
                for stem, proc in procs.items():
                    if stem not in done and proc.poll() is not None:
                        done[stem] = time.perf_counter() - t0
                time.sleep(0.02)
            for f in logs.values():
                f.close()
            bad = [s for s, p in procs.items() if p.returncode]
            if bad:
                raise RuntimeError(f"nvcc failed on {bad}")
            subprocess.run(
                [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-o", str(tmp / "lib.so"),
                 *[str(tmp / (s.stem + ".o")) for s in cus]], check=True,
                capture_output=True)
            total = time.perf_counter() - t0
            entries = {s: (tmp / (s + ".log")).read_text().count(
                "Compiling entry function") for s in procs}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out[name] = {"seconds": round(total, 2),
                     "nvcc_s": {s: round(v, 2) for s, v in done.items()},
                     "kernels": entries}
        slow = sorted(done, key=done.get, reverse=True)[:4]
        print(f"{label} build {name}: {total:.2f} s with its link (host "
              f"clock, every source's nvcc started together); slowest "
              + ", ".join(f"{s} {done[s]:.2f} s ({entries[s]} kernels)"
                          for s in slow) + f"  [{card}]", flush=True)
    return out


def v1_kernels(sm, card, label) -> dict:
    """``--what v1``: see the module's docstring."""
    import time
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import kernels as tk
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d
    dev = torch.device("cuda")
    recs = []
    for n_blobs, size in sm.CASES:
        td = TapeData.from_tape(mpr_tpu_torch.compile_tree(
            shapes.stress_2d(n_blobs)), device=dev)
        eye, z = torch.eye(3, device=dev), torch.tensor(0.0, device=dev)
        recs.append(_recorded(
            tk, lambda td=td, eye=eye, z=z, size=size:
            pipeline2d.render_tile_block(td, eye, z, size),
            ("interval_shorten", "pixel_eval_runs")))

    def host_us(fn, reps=200):
        # the wrapper's own time on the host: calls back to back, no sync
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return round((t1 - t0) / reps * 1e6, 2)

    def timed(fn):
        return {"ms": sm.cuda_ms(fn, 30, 3), "device_ms":
                sm.device_ms(fn, tries=3), "host_us": host_us(fn)}

    out = {}
    # C1 on the 1024^2 frame's ambiguous tiles at cap = Tcap, then B1 on
    # its tapes in TILE order, as chip_smoke.py phase 9 runs them
    a_a, k_a = recs[0]["interval_shorten"][0]
    a_b, k_b = recs[0]["pixel_eval_runs"][0]
    meta, words, imms = a_a[0], a_a[1], a_a[2]
    status, codes = tk.interval_shorten(*a_a, **k_a)
    n_tiles, tcap = codes.shape[0], words.shape[0]
    amb = status == tk.ST_AMBIG
    n = int(amb.sum())
    order = torch.argsort((~amb).to(torch.int32), stable=True).to(
        torch.int32)
    remap = torch.as_tensor(tk.build_remap(tuple(range(2, 32)))[1],
                            dtype=torch.int32, device=dev)
    cmeta = torch.zeros(8, dtype=torch.int32, device=dev)
    cmeta[:3] = torch.tensor([n, tcap // 8, tcap], dtype=torch.int32)
    c1_args = (cmeta, words, imms, order, remap, codes, n_tiles, tcap, tcap)
    out["compact_runs"] = timed(lambda: tk.compact_runs(*c1_args))
    tw, ti, _, gmeta = tk.compact_runs(*c1_args)
    tiles = order[:n].long()
    w_t, i_t = torch.zeros_like(tw), torch.zeros_like(ti)
    l_t = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    w_t[tiles], i_t[tiles], l_t[tiles] = tw[:n], ti[:n], gmeta[:n, 0]
    nm = a_b[0].clone()
    nm[0] = n
    nm[6] = 0
    b1_args = (nm, order, l_t, w_t, i_t, a_b[11])
    out["pixel_eval"] = timed(
        lambda: tk.pixel_eval(*b1_args, s_cap=k_b["s_cap"]))
    # B1 on the full tape of the 2048^2 cell, longer than B1_STAGE, on 8
    # tiles: the picked shape, and (where this checkout takes an int stage)
    # the whole tape staged
    a_a2, _ = recs[1]["interval_shorten"][0]
    a_b2, k_b2 = recs[1]["pixel_eval_runs"][0]
    length, nt = int(a_a2[0][0]), 8
    nm2 = a_b2[0].clone()
    nm2[0] = nt
    nm2[6] = 0
    long_args = (nm2, torch.arange(nt, dtype=torch.int32, device=dev),
                 torch.full((nt,), length, dtype=torch.int32, device=dev),
                 a_a2[1][None].expand(nt, -1).contiguous(),
                 a_a2[2][None].expand(nt, -1).contiguous(),
                 a_b2[11][:nt].contiguous())
    sc2 = k_b2["s_cap"]
    out["pixel_eval_long"] = {"clauses": length, "picked": timed(
        lambda: tk.pixel_eval(*long_args, s_cap=sc2))}
    try:
        whole = ln.pixel_v1_launch(sc2, long_args[3].shape[1], nt,
                                   long_args[5].shape[2], home="local",
                                   stage=length)
    except (AttributeError, TypeError):
        whole = None                       # a checkout without the option
    if whole is not None:
        want = tk.pixel_eval(*long_args, s_cap=sc2)
        got = tk.pixel_eval(*long_args, s_cap=sc2, launch=whole)
        torch.cuda.synchronize()
        out["pixel_eval_long"]["whole_staged"] = dict(
            timed(lambda: tk.pixel_eval(*long_args, s_cap=sc2,
                                        launch=whole)),
            equal=bool(torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))),
            staged=whole.staged, smem=whole.smem)
    for k, v in out.items():
        print(f"{label} {k}: {json.dumps(v)}  [{card}]", flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--what", default="frames",
                   choices=("frames", "cold", "fits", "unrolled",
                            "options", "builds", "v1"),
                   help="what to time (see the module's docstring)")
    p.add_argument("--root", default=HERE,
                   help="directory that holds the mpr_tpu_torch to time")
    p.add_argument("--label", default="", help="a name for the JSON line")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_frames: no CUDA device", file=sys.stderr)
        return 2
    sm = _smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import kernels as tk
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import camera, pipeline2d, pipeline3d
    if not os.path.abspath(mpr_tpu_torch.__file__).startswith(root):
        print(f"chip_frames: mpr_tpu_torch came from {mpr_tpu_torch.__file__}"
              f", not {root}", file=sys.stderr)
        return 2
    card = sm.card_line()
    if args.what != "frames":
        what = {"cold": cold_frames, "fits": fit_steps,
                "unrolled": unrolled_frames,
                "options": option_frames, "builds": library_builds,
                "v1": v1_kernels}[args.what]
        print(json.dumps({"label": args.label, "root": root, "card": card,
                          args.what: what(sm, card, args.label)}))
        return 0
    dev = torch.device("cuda")
    frames = []
    for n_blobs, size in sm.CASES:
        td = TapeData.from_tape(mpr_tpu_torch.compile_tree(
            shapes.stress_2d(n_blobs)), device=dev)
        eye, z = torch.eye(3, device=dev), torch.tensor(0.0, device=dev)
        frames.append((f"stress_2d({n_blobs}) {size}^2", 20,
                       lambda td=td, eye=eye, z=z, size=size:
                       pipeline2d.render_tile_block(td, eye, z, size)))
    for name, make, view, size in sm.CASES_3D:
        td = TapeData.from_tape(mpr_tpu_torch.compile_tree(make(shapes)),
                                device=dev)
        mat = torch.as_tensor(camera.gui3d_view(*view), device=dev)
        frames.append((f"{name} {size}^3", 10,
                       lambda td=td, mat=mat, size=size:
                       pipeline3d.render3d_rows(td, mat, size, 0, size // 64,
                                                True)))
    out = {}
    for cell, reps, frame in frames:
        frame()
        ms = sm.cuda_ms(frame, reps, 3)
        kern = {}
        for name, launches in _recorded(tk, frame).items():
            fn = getattr(tk, name)
            kern[name] = [sm.device_ms(lambda: fn(*a, **k))
                          for a, k in launches]
        out[cell] = {"frame_ms": ms, "device_ms": kern}
        print(f"{args.label} {cell}: frame {ms:.3f} ms (events, median of "
              f"{reps}); device ms A {kern['interval_shorten']}, C "
              f"{kern['compact_bitshift_batched']}  [{card}]", flush=True)
    print(json.dumps({"label": args.label, "root": root, "card": card,
                      "cells": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
