#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

  1. print the card (``nvidia-smi`` name and power limit) and build the
     CUDA kernels from ``mpr_tpu_torch/ops/csrc`` (nvcc, first use);
  2. the main path: with every launch count set to 0, render the
     ``stress_2d(600)`` model at 1024^2 and ``stress_2d(1500)`` at 2048^2
     through ``mpr_tpu_torch.render.render2d``, recording each kernel's
     inputs; every kernel must have launched;
  3. hold each kernel's outputs against its plain PyTorch version called on
     the same CUDA inputs (integers and the 0/1 fill must be equal), and
     each image against a dense evaluation of the full tape at every pixel;
  4. re-render an edited tape with another op set: no new build;
  5. time each kernel, its plain version and the whole frame with CUDA
     events (warm-up, then the median of repeated runs);
  6. print the card line, one JSON ``kernels`` line, and last
     ``{"ok": true, "device": {...}}``.

Exits non-zero when no CUDA device is present and when run outside the
repository (it needs the ``mpr_tpu_torch`` package beside it).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
KERNEL_ROWS = (
    # wrapper in mpr_tpu_torch.ops.kernels (its plain version is
    # <wrapper>_plain), source, the TPU kernel it replaces
    ("interval_shorten", "mpr_tpu_torch/ops/csrc/interval_shorten.cu",
     "mpr_tpu/ops/kernels.py:511"),
    ("compact_bitshift_batched", "mpr_tpu_torch/ops/csrc/compact.cu",
     "mpr_tpu/ops/kernels.py:1206"),
    ("pixel_eval_runs", "mpr_tpu_torch/ops/csrc/pixel_eval.cu",
     "mpr_tpu/ops/kernels.py:988"),
)
CASES = ((600, 1024), (1500, 2048))   # (stress_2d blobs, image size)

# Float operations per clause, by opcode, for the bound: one per IEEE
# arithmetic operation or math-library call of the clause's formula (the
# Cephes forms counted out), none for compares, selects and copies.
FLOAT_OPS = {2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 14, 8: 15, 9: 15, 10: 1,
             11: 1, 12: 1, 13: 1, 14: 1, 15: 1, 16: 1, 17: 1, 18: 1, 19: 1,
             20: 1, 21: 1, 22: 1, 23: 1, 24: 1, 25: 1, 26: 1, 27: 0, 28: 0,
             29: 0, 30: 4, 31: 2}
INTERVAL_OPS = {2: 2, 3: 2, 4: 2, 5: 0, 6: 0, 7: 28, 8: 30, 9: 30, 10: 2,
                11: 2, 12: 2, 13: 2, 14: 2, 15: 2, 16: 4, 17: 2, 18: 2,
                19: 2, 20: 2, 21: 2, 22: 2, 23: 2, 24: 2, 25: 2, 26: 4,
                27: 0, 28: 0, 29: 0, 30: 8, 31: 4}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, reps, warmup=2):
    """Median device time of ``fn()`` in ms, CUDA events around each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def dense_field(tape, size, dev):
    """The full tape evaluated at every pixel center of a size^2 image
    (row = y), clause by clause with the plain float semantics — the
    reference the rendered image must match."""
    import torch
    from mpr_tpu_torch.ops.kernels import float_clause
    from mpr_tpu_torch.render import camera
    xs = torch.as_tensor(camera.pixel_centers(size), device=dev)
    X = xs[None, :].expand(size, size).reshape(-1)
    Y = xs[:, None].expand(size, size).reshape(-1)
    zero = torch.zeros_like(X)
    regs = [zero] * tape.num_slots
    for s, v in zip(tape.axis_slots, (X, Y, zero)):
        regs[s] = v
    regs[0] = zero
    imms = torch.as_tensor(tape.imms, device=dev)
    for t in range(tape.length):
        regs[int(tape.outs[t])] = float_clause(
            int(tape.ops[t]), regs[int(tape.lhss[t])],
            regs[int(tape.rhss[t])], imms[t])
    return regs[tape.result_slot].reshape(size, size)


def profile_frames(fn, n=5):
    """Device time by kernel name over ``n`` frames (torch.profiler's CUDA
    activity): returns (host ms per frame, [(name, device ms per frame)],
    device busy share of the window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy = sum(by_name.values())
    rows = sorted(((k, v / n / 1e3) for k, v in by_name.items()),
                  key=lambda kv: -kv[1])
    return wall_us / n / 1e3, rows, busy / wall_us


def install_recorder(tk, originals, log):
    """Route each kernel wrapper through a recorder that keeps its inputs
    and outputs in ``log``; the original wrappers still count their
    launches."""
    for wname, fn in originals.items():
        def rec(*a, _fn=fn, _name=wname, **k):
            out = _fn(*a, **k)
            log.setdefault(_name, []).append((a, k, out))
            return out
        setattr(tk, wname, rec)


def interval_ops(tape):
    return sum(INTERVAL_OPS.get(int(o), 0) for o in tape.ops)


def tile_float_ops(gmeta, runs_h, table, full_ops, n_amb):
    """Float operations kernel B does per pixel, summed over ambiguous
    tiles, from the tapes this run's kernel C produced."""
    import numpy as np
    total = 0
    for g in range(n_amb):
        if gmeta[g, 2]:
            total += full_ops
            continue
        hdr = runs_h[g, :gmeta[g, 1]]
        ops = np.repeat(table[hdr & 0xFF], hdr >> 8)
        total += sum(FLOAT_OPS.get(int(o), 0) for o in ops)
    return total


def compare_kernels(tk, rec, tape, size):
    """Hold each kernel's outputs (recorded on the main path) against its
    plain version on the same CUDA inputs.  Returns per-kernel dicts with
    mismatch counts, max |err| and the data the bounds need."""
    import torch
    res = {}
    (a, k, (st, codes)) = rec["interval_shorten"][0]
    pst, pcodes = tk.interval_shorten_plain(*a, **k)
    amb = st == tk.ST_AMBIG
    n_st = int((st != pst).sum())
    n_codes = int((codes[amb] != pcodes[amb]).sum())
    err = max(float((st - pst).abs().max()),
              float((codes[amb].long() - pcodes[amb].long()).abs().max())
              if amb.any() else 0.0)
    lanes, tcap = codes.shape[0], a[1].shape[0]
    res["interval_shorten"] = dict(
        mismatches=n_st + n_codes, max_abs_err=err,
        bytes=32 + 8 * tape.length + 24 * lanes + 4 * lanes
        + lanes * tcap // 2,
        ops=lanes * interval_ops(tape))
    print(f"  A interval_shorten @{size}^2: {lanes} tiles, "
          f"{int(amb.sum())} ambiguous; status mismatches {n_st}, code "
          f"word mismatches on ambiguous tiles {n_codes}")

    (a, k, out) = rec["compact_bitshift_batched"][0]
    n_amb = int(a[0][0])
    pout = tk.compact_bitshift_batched_plain(*a, **k)
    names = ("tw", "ti", "runs")
    mism = {n: int((o[:n_amb] != p[:n_amb]).sum())
            for n, o, p in zip(names, out[:3], pout[:3])}
    mism["gmeta"] = int((out[3][:n_amb, :3] != pout[3][:n_amb, :3]).sum())
    err = max([float((o[:n_amb].long() - p[:n_amb].long()).abs().max())
               for o, p in zip(out[:3], pout[:3])] + [0.0]) if n_amb else 0.0
    gmeta = out[3][:n_amb].cpu().numpy()
    cap = out[0].shape[1]
    kept = int(gmeta[:, 0].sum())
    res["compact_bitshift_batched"] = dict(
        mismatches=sum(mism.values()), max_abs_err=err,
        bytes=4 * n_amb * tcap + 8 * kept + 4 * n_amb
        + n_amb * (12 * cap + 32),
        ops=0)
    print(f"  C compact @{size}^2: {n_amb} tiles, mean kept "
          f"{kept / max(n_amb, 1):.1f} clauses of {tape.length}, "
          f"{int(gmeta[:, 2].sum())} over cap {cap}; mismatches {mism}")

    (a, k, fill) = rec["pixel_eval_runs"][0]
    pfill = tk.pixel_eval_runs_plain(*a, **k)
    diff = fill != pfill
    n_fill = int(diff.sum())
    if n_fill:
        idx = torch.nonzero(diff)[:10].tolist()
        print(f"  B differing (tile, pixel): {idx}")
    table = tk.bid_table(a[6])
    full_ops = sum(FLOAT_OPS.get(int(o), 0) for o in tape.ops)
    P = fill.shape[1]
    flops = P * tile_float_ops(gmeta, out[2][:n_amb].cpu().numpy(), table,
                               full_ops, n_amb)
    res["pixel_eval_runs"] = dict(
        mismatches=n_fill, max_abs_err=float((fill - pfill).abs().max()),
        bytes=n_amb * 3 * P * 4 + fill.numel() * 4 + 12 * kept,
        ops=flops)
    print(f"  B pixel_eval_runs @{size}^2: fill mismatches {n_fill}")
    return res


def main() -> int:
    import numpy as np
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mpr_tpu_torch
        from mpr_tpu_torch.frontend import shapes
        from mpr_tpu_torch.ops import build
        from mpr_tpu_torch.ops import kernels as tk
        from mpr_tpu_torch.ops.tape_data import TapeData, resolve_device
        from mpr_tpu_torch.render import pipeline2d, render2d
    except ImportError as e:
        print(f"chip_smoke: the mpr_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    dev = resolve_device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {kind}")

    # ---- 1. build ------------------------------------------------------------
    build.lib()
    print(f"build: {build.BuildStats.seconds:.1f} s, compiles "
          f"{build.BuildStats.compiles}, loads {build.BuildStats.loads}")
    for line in build.BuildStats.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # ---- 2. the main path ------------------------------------------------------
    tapes = {}
    for n_blobs, size in CASES:
        t0 = time.perf_counter()
        tapes[size] = mpr_tpu_torch.compile_tree(shapes.stress_2d(n_blobs))
        t = tapes[size]
        print(f"stress_2d({n_blobs}): {t.length} clauses, {t.num_slots} "
              f"slots, bucket {TapeData.from_tape(t, device='cpu').capacity}"
              f", compiled in {time.perf_counter() - t0:.2f} s")
    recs = {size: {} for _, size in CASES}
    images = {}
    originals = {name: getattr(tk, name) for name, *_ in KERNEL_ROWS}
    for fn in originals.values():
        fn.launches = 0
    try:
        for _, size in CASES:
            install_recorder(tk, originals, recs[size])
            t0 = time.perf_counter()
            images[size] = render2d(tapes[size], size=size)
            torch.cuda.synchronize()
            print(f"render2d @{size}^2: {time.perf_counter() - t0:.3f} s "
                  "(first frame, host clock)")
    finally:
        for wname, fn in originals.items():
            setattr(tk, wname, fn)
    launches = {name: getattr(tk, name).launches for name, *_ in KERNEL_ROWS}
    print(f"main-path launches: {launches}")
    for name, n in launches.items():
        check(n >= len(CASES), f"kernel {name} launched {n} times on the "
              "main path")

    # ---- 3. kernels vs plain, images vs the dense reference ---------------
    results = {}
    for _, size in CASES:
        img = images[size]
        status = recs[size]["interval_shorten"][0][2][0]
        n_amb = int((status == tk.ST_AMBIG).sum())
        print(f"image @{size}^2: filled fraction {img.mean():.6f}, "
              f"{n_amb} of {status.numel()} tiles ambiguous")
        res = compare_kernels(tk, recs[size], tapes[size], size)
        results[size] = res
        for name, r in res.items():
            check(r["mismatches"] == 0, f"{name} disagrees with its plain "
                  f"version at {size}^2 ({r['mismatches']} mismatches)")
        f = dense_field(tapes[size], size, dev)
        want = (f < 0).cpu().numpy()
        bad = img != want
        band = int((f.abs() <= 1e-5).sum())
        print(f"  image vs dense full-tape evaluation @{size}^2: "
              f"{int(bad.sum())} pixels differ ({band} pixels have "
              "|f| <= 1e-5)")
        check(img.shape == (size, size) and img.dtype == np.bool_,
              "image has the wrong shape or type")
        check(not bad.any(), f"image differs from the dense evaluation at "
              f"{size}^2")
        check(torch.isfinite(f).float().mean() > 0.99, "field not finite")
    torch.cuda.synchronize()

    # ---- 4. an edited tape renders with no new build -------------------------
    edited = mpr_tpu_torch.compile_tree(shapes.union(
        shapes.circle(0.5), shapes.rectangle(-0.9, -0.2, 0.3, 0.8)))
    img = render2d(edited, size=1024)
    f = dense_field(edited, 1024, dev)
    check(np.array_equal(img, (f < 0).cpu().numpy()),
          "edited tape renders wrong")
    check(build.BuildStats.loads == 1 and build.BuildStats.compiles <= 1,
          "the edited tape caused a new build")
    print(f"edited tape ({edited.length} clauses, another op set): exact, "
          f"builds still {build.BuildStats.loads}")

    # ---- 5. timing -------------------------------------------------------------
    for _, size in CASES:
        rec = recs[size]
        td = TapeData.from_tape(tapes[size], device=dev)
        eye = torch.eye(3, device=dev)
        z = torch.tensor(0.0, device=dev)
        frame_ms = cuda_ms(
            lambda: pipeline2d.render_tile_block(td, eye, z, size), 20, 3)
        t0 = time.perf_counter()
        for _ in range(10):
            pipeline2d.render_tile_block(td, eye, z, size)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 100
        line = [f"frame @{size}^2: {frame_ms:.3f} ms (events), "
                f"{wall_ms:.3f} ms (host clock, mean of 10)"]
        for name, *_ in KERNEL_ROWS:
            a, k, _ = rec[name][0]
            fn = getattr(tk, name)
            ms = cuda_ms(lambda: fn(*a, **k), 30, 3)
            r = results[size][name]
            r["ms"] = ms
            if size == CASES[0][1]:
                plain = getattr(tk, name + "_plain")
                r["plain_ms"] = cuda_ms(lambda: plain(*a, **k), 3, 1)
            line.append(f"{name} {ms:.4f} ms")
        print("; ".join(line) + f"  [{card}]")

    # ---- where a frame's device time goes -----------------------------------
    for _, size in CASES:
        td = TapeData.from_tape(tapes[size], device=dev)
        eye = torch.eye(3, device=dev)
        z = torch.tensor(0.0, device=dev)
        wall, rows, busy = profile_frames(
            lambda: pipeline2d.render_tile_block(td, eye, z, size))
        if not rows:
            print(f"profile @{size}^2: no device time in the trace "
                  "(not measured)")
            continue
        print(f"profile @{size}^2: {wall:.3f} ms per frame (host clock "
              f"under the profiler), device busy {100 * busy:.1f}%, "
              f"{sum(v for _, v in rows):.3f} ms of kernels over "
              f"{len(rows)} kernel names  [{card}]")
        for name, ms in rows[:12]:
            print(f"    {ms:9.4f} ms  {name[:100]}")

    # ---- 6. report -------------------------------------------------------------
    size = CASES[0][1]
    rows = []
    for name, source, replaces in KERNEL_ROWS:
        r = results[size][name]
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_F32_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(results[s][name]["max_abs_err"]
                               for _, s in CASES),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "at": f"stress_2d({CASES[0][0]}) {size}^2",
            "ms_2048": results[CASES[1][1]][name]["ms"],
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
