#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

  1. print the card (``nvidia-smi`` name and power limit) and build the
     CUDA kernels from ``mpr_tpu_torch/ops/csrc`` (nvcc, first use): the
     main library (every kernel, B, V and D at the shapes the render path
     picks; its seconds are the render path's first-use build) and then
     the extra one (B, V and D at the other shapes, for phase 8b), with
     ptxas's registers, stack frame and spills for every instantiation of
     A, B, C, C2, V and D (a spill fails the run at its end);
  2. the 2D path: with every launch count set to 0, render the
     ``stress_2d(600)`` model at 1024^2 and ``stress_2d(1500)`` at 2048^2
     through ``mpr_tpu_torch.render.render2d``, recording each kernel's
     inputs; kernels A, C and B must have launched, and each frame must
     have built its tape's dependency schedule for kernel A once (its
     levels, widest level and host build time are printed);
  3. hold each kernel's outputs against its plain PyTorch version called on
     the same CUDA inputs (integers and the 0/1 fill must be equal), and
     each image against ``render2d_brute`` (the full tape at every pixel);
  4. re-render an edited tape with another op set: no new build;
  5. time each kernel, its plain version and the whole frame with CUDA
     events (warm-up, then the median of repeated runs; a frame after the
     first on one tape must build no schedule), each kernel's device time
     with torch.profiler (kernel C's beside its byte bound and its share
     of it), and profile a frame;
  5b. kernel A under a schedule built before the tape's immediates
     changed (as a fit step or a slider would leave it): status and codes
     at three launch shapes must equal the plain version's on the new
     immediates, which must differ from those on the old ones;
  6. the 3D path: with every launch count set to 0 again, render
     ``intersection(gyroid(0.4, 0.08), sphere(0.85))`` at 1024^3 and
     ``extrude_z(stress_2d(300), -0.4, 0.4)`` at 512^3 through
     ``mpr_tpu_torch.render.render3d``; each frame must launch kernel A
     three times (the three sharing one schedule), C twice, V and D
     once;
  7. hold every recorded launch of A, C, V and D against its plain version
     (all equal, NaNs in the same places),
     each depth image against ``render3d_brute`` (0 pixels differ), and the
     normals against unit length and autograd of the plain interpreter;
  8. time the 3D frame with and without normals, V, D and every launch of
     A and C (C's device time beside its byte bound and share), the device
     time of the frame's prepass (``_shorten_prepass``, the plain PyTorch
     that feeds kernel C), and profile a frame;
  8b. the launch shapes: print the shape ``voxel_launch`` and
     ``deriv_launch`` picked at each 3D cell, then call V and D again on
     the recorded inputs of each 3D cell, A and B on those of each 2D
     cell, A on each of the three launches of each 3D cell, and C on each
     of its launches at all four cells, with forced shapes that reach every
     branch (V, D, B: each home of the register file, K = 1/2/4, P = 1 and
     more, the full tape staged and read from global memory; A: a block a
     tile at 32 to 1024 threads, a thread a tile at 64 to 256 tiles a
     block, the planes staged or not; C: a warp a row at 1 to 32 rows a
     block, a block a row at 128 to 1024 threads), hold each output
     bit for bit against the plain output of phase 3 or 7, and time each
     shape (shapes that do not fit are printed as refused);
  9. kernels B1, C1 and C2 (the earlier public versions of B and C, which
     no render path calls) on the recorded data of the 1024^2 frame: with
     every launch count set to 0, C1 on every ambiguous tile at ``cap =
     Tcap``, ``Tcap/8`` and ``Tcap/16`` (some tapes overflow the last), B1
     on C1's tapes, C2 on the prepass planes in tile order; then each against its plain version, B1's signs against
     the frame's fill, C2's outputs against kernel C's; each timed;
 10. the command line: ``python -m mpr_tpu_torch.cli`` as a subprocess from
     a temporary directory (``render2d stress:600 --size 1024 --check``,
     ``render3d`` of a ``.frep`` scene at 512^3 ``--mode all``, ``render2d
     examples/text_demo.io --check``, ``shorten-stats``), and once in
     process with the launch counts set to 0, where A, C, B, V and D must
     have launched;
 11. the effects (``draw_ssao`` in both modes, ``draw_shaded``) on the
     1024^2 depth and normals, on the card against the same tensors on the
     CPU, and timed;
 12. print the kernel times of the previous designs of A, B, C, C2, V and
     D (recorded, labelled as such; not measured here), the card line, one
     JSON ``kernels`` line, and last ``{"ok": true, "device": {...}}``.

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
    # wrapper (its plain version is <wrapper>_plain), its module under
    # mpr_tpu_torch.ops, source, the TPU kernel it replaces
    ("interval_shorten", "kernels",
     "mpr_tpu_torch/ops/csrc/interval_shorten.cu",
     "mpr_tpu/ops/kernels.py:511"),
    ("compact_bitshift_batched", "kernels",
     "mpr_tpu_torch/ops/csrc/compact.cu", "mpr_tpu/ops/kernels.py:1206"),
    ("pixel_eval_runs", "kernels", "mpr_tpu_torch/ops/csrc/pixel_eval.cu",
     "mpr_tpu/ops/kernels.py:988"),
    ("voxel_eval_3d", "kernels3d", "mpr_tpu_torch/ops/csrc/voxel_eval.cu",
     "mpr_tpu/ops/kernels3d.py:186"),
    ("deriv_eval_3d", "kernels3d", "mpr_tpu_torch/ops/csrc/deriv_eval.cu",
     "mpr_tpu/ops/kernels3d.py:456"),
    ("pixel_eval", "kernels", "mpr_tpu_torch/ops/csrc/pixel_eval_v1.cu",
     "mpr_tpu/ops/kernels.py:661"),
    ("compact_runs", "kernels", "mpr_tpu_torch/ops/csrc/compact_runs.cu",
     "mpr_tpu/ops/kernels.py:832"),
    ("compact_bitshift", "kernels",
     "mpr_tpu_torch/ops/csrc/compact_order.cu",
     "mpr_tpu/ops/kernels.py:1260"),
)
# no render path calls these three: the kernel phase drives them
KERNELS_V1 = ("pixel_eval", "compact_runs", "compact_bitshift")
# limits of the card-against-CPU comparison of the effects (the card-only
# tests use the same): share of pixels further apart than 1e-5, and the
# largest difference
EFFECT_SHARE = 0.01
EFFECT_FAR = 0.05
KERNELS_2D = ("interval_shorten", "compact_bitshift_batched",
              "pixel_eval_runs")
# launches a 3D frame with normals must make
LAUNCHES_3D = {"interval_shorten": 3, "compact_bitshift_batched": 2,
               "voxel_eval_3d": 1, "deriv_eval_3d": 1}
CASES = ((600, 1024), (1500, 2048))   # (stress_2d blobs, image size)
# (name, tree from the shape library, gui3d_view(yaw, pitch, perspective),
# size)
CASES_3D = (
    ("gyroid_sphere", lambda S: S.intersection(S.gyroid(0.4, 0.08),
                                               S.sphere(0.85)),
     (0.5, -0.9, 0.3), 1024),
    ("extruded_stress", lambda S: S.extrude_z(S.stress_2d(300), -0.4, 0.4),
     (0.7, -1.0, 0.3), 512),
)
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
# The same count for a dual-number clause (value and three derivatives),
# from the formulas of clause.cuh's deriv_op: e.g. mul is one product for
# the value and two products and a sum for each derivative.
DERIV_OPS = {2: 5, 3: 6, 4: 4, 5: 5, 6: 6, 7: 21, 8: 22, 9: 21, 10: 5,
             11: 4, 12: 5, 13: 1, 14: 4, 15: 4, 16: 10, 17: 1, 18: 1, 19: 1,
             20: 1, 21: 1, 22: 4, 23: 4, 24: 5, 25: 6, 26: 11, 27: 1, 28: 0,
             29: 0, 30: 17, 31: 9}
# per voxel or pixel: three index-to-coordinate conversions and the mat4
COORD_OPS = 42
# Kernel times of the designs before the redesigns (V and D before their
# register-file redesign, at the two 3D cells; A before the level walk and
# B before the register file of regfile.cuh, at the 1024^2 cell; C before
# its warp-a-row and block-a-row redesign, device time summed over a
# frame's launches at each cell; C2 the same, events at the 1024^2 cell):
# recorded by this script on NVIDIA H100 80GB HBM3, 700.00 W, and printed
# on a line of their own as recorded values, apart from this run's
# measurements.
PREVIOUS_DESIGN_MS = {"voxel_eval_3d": {"gyroid_sphere": 15.221,
                                        "extruded_stress": 8.575},
                      "deriv_eval_3d": {"gyroid_sphere": 0.250,
                                        "extruded_stress": 8.057},
                      "interval_shorten": {"stress_2d(600) 1024^2": 1.9068},
                      "pixel_eval_runs": {"stress_2d(600) 1024^2": 1.0148},
                      "compact_bitshift_batched": {
                          "stress_2d(600) 1024^2": 0.0078,
                          "stress_2d(1500) 2048^2": 0.0790,
                          "gyroid_sphere": 0.2902,
                          "extruded_stress": 0.3162},
                      "compact_bitshift": {"stress_2d(600) 1024^2": 0.0438}}
# Kernel A's dependency bound: each level costs a shared-memory round trip
# (about 30 cycles) and a barrier (about 20 cycles), at 1.98 GHz, twice (the
# forward and the backward pass).  An estimate from the card's published
# latencies, not a measurement.
LEVEL_STEP_NS = 25.0


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


def plain_ms(fn):
    """Time of a plain version: one run, and the median of three when a run
    takes under two seconds."""
    first = cuda_ms(fn, 1, 0)
    return first if first > 2000.0 else cuda_ms(fn, 3, 0)


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


def device_ms(fn, n=10):
    """Device time of the one kernel ``fn()`` launches, in ms: the mean
    duration of the kernels torch.profiler traces over ``n`` calls (the
    mean of those traced, which holds where the trace drops a record).
    The events of :func:`cuda_ms` also time the host's work around a short
    kernel's launch; this does not.  None where the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return round(sum(us) / len(us) / 1e3, 6) if us else None


def print_profile(label, fn, card, n):
    wall, rows, busy = profile_frames(fn, n)
    if not rows:
        print(f"profile {label}: no device time in the trace (not measured)")
        return
    print(f"profile {label}: {wall:.3f} ms per frame (host clock under the "
          f"profiler), device busy {100 * busy:.1f}%, "
          f"{sum(v for _, v in rows):.3f} ms of kernels over {len(rows)} "
          f"kernel names  [{card}]")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {name[:100]}")


class Recorder:
    """Routes each kernel wrapper through a function that keeps the inputs
    and outputs of every launch in ``log``; the original wrappers still
    count their launches."""

    def __init__(self, mods):
        self.mods = mods
        self.originals = {name: getattr(mods[mod], name)
                          for name, mod, *_ in KERNEL_ROWS}

    def reset_counts(self):
        for fn in self.originals.values():
            fn.launches = 0

    def counts(self):
        return {name: fn.launches for name, fn in self.originals.items()}

    def install(self, log):
        for name, mod, *_ in KERNEL_ROWS:
            def rec(*a, _fn=self.originals[name], _name=name, **k):
                out = _fn(*a, **k)
                log.setdefault(_name, []).append((a, k, out))
                return out
            setattr(self.mods[mod], name, rec)

    def remove(self):
        for name, mod, *_ in KERNEL_ROWS:
            setattr(self.mods[mod], name, self.originals[name])


def interval_ops(tape):
    return sum(INTERVAL_OPS.get(int(o), 0) for o in tape.ops)


def row_ops(gmeta, runs_h, table, full_ops, per_op):
    """Operations per pixel or voxel summed over the rows of ``gmeta``, from
    the tapes kernel C produced: ``per_op`` counts one opcode, a row that
    overflowed runs the full tape (``full_ops``)."""
    import numpy as np
    lut = np.zeros(256, np.int64)
    for o, n in per_op.items():
        lut[o] = n
    total = 0
    for g in range(gmeta.shape[0]):
        if gmeta[g, 2]:
            total += full_ops
            continue
        hdr = runs_h[g, :gmeta[g, 1]]
        total += int((lut[table[hdr & 0xFF]] * (hdr >> 8)).sum())
    return total


def same(a, b):
    """Mismatch count and max |a - b| with NaNs in the same places equal."""
    import torch
    if a.is_floating_point():
        bad = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
        d = torch.nan_to_num((a - b).abs(), nan=0.0, posinf=0.0)
        err = float(torch.where(bad, d, torch.zeros_like(d)).max()) \
            if a.numel() else 0.0
    else:
        bad = a != b
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return int(bad.sum()), err


def levels_of(kwargs):
    """The dependency schedule a recorded launch of kernel A was given (the
    tape's ``TapeData.levels``, built at the frame's first launch)."""
    lv = kwargs["levels"]
    return lv() if callable(lv) else lv


def print_levels(label, lv):
    print(f"schedule {label}: {lv.length} clauses on {lv.n_levels} "
          f"dependency levels, widest {lv.widest}; built on the host in "
          f"{1e3 * lv.seconds:.2f} ms (once a tape)")


def a_mismatches(tk, out, plain):
    """Status mismatches, and code word mismatches on the lanes the plain
    version finds ambiguous (the others' codes are never read)."""
    (st, codes), (pst, pcodes) = out, plain
    amb = pst == tk.ST_AMBIG
    n_st, e_st = same(st, pst)
    n_codes, e_codes = same(codes[amb], pcodes[amb])
    return n_st, n_codes, max(e_st, e_codes)


def compare_a(tk, entry, tape, label, keep=None):
    """One recorded launch of kernel A against its plain version (whose
    outputs go to the list ``keep`` for the launch-shape phase)."""
    a, k, out = entry
    plain = tk.interval_shorten_plain(*a, **k)
    if keep is not None:
        keep.append(plain)
    n_st, n_codes, err = a_mismatches(tk, out, plain)
    lanes, tcap = out[1].shape[0], a[1].shape[0]
    lv = levels_of(k)
    print(f"  A interval_shorten {label}: {lanes} lanes, "
          f"{int((plain[0] == tk.ST_AMBIG).sum())} ambiguous, "
          f"{lv.n_levels} levels; status mismatches {n_st}, code word "
          f"mismatches on ambiguous lanes {n_codes}")
    return dict(mismatches=n_st + n_codes, max_abs_err=err,
                bytes=32 + 8 * tape.length + 24 * lanes + 4 * lanes
                + lanes * tcap // 2,
                ops=lanes * interval_ops(tape), levels=lv.n_levels,
                dep_bound_ms=2 * lv.n_levels * LEVEL_STEP_NS * 1e-6)


def c_mismatches(out, pout, n_rows):
    """Kernel C's mismatches against the plain output on the rows below
    cmeta[0]: tw, ti and the run headers over the full cap (the zeros past
    the tape included), and gmeta's [len, n_runs, overflow]."""
    mism, err = {}, 0.0
    for n, o, p in zip(("tw", "ti", "runs"), out[:3], pout[:3]):
        mism[n], e = same(o[:n_rows], p[:n_rows])
        err = max(err, e)
    mism["gmeta"], e = same(out[3][:n_rows, :3], pout[3][:n_rows, :3])
    return mism, max(err, e)


def compare_c(tk, entry, tape, label, keep=None):
    """One recorded launch of kernel C against its plain version (whose
    outputs go to the list ``keep`` for the launch-shape phase); also
    returns the rows' gmeta and run headers (host) for the bounds."""
    a, k, out = entry
    n_rows = int(a[0][0])
    tcap = a[2].shape[1] * a[2].shape[2]
    pout = tk.compact_bitshift_batched_plain(*a, **k)
    if keep is not None:
        keep.append(pout)
    mism, err = c_mismatches(out, pout, n_rows)
    gmeta = out[3][:n_rows].cpu().numpy()
    cap = out[0].shape[1]
    kept = int(gmeta[:, 0].sum())
    print(f"  C compact {label}: {n_rows} rows, mean kept "
          f"{kept / max(n_rows, 1):.1f} clauses of {tape.length}, "
          f"{int(gmeta[:, 2].sum())} over cap {cap}; mismatches {mism}")
    res = dict(mismatches=sum(mism.values()), max_abs_err=err,
               bytes=4 * n_rows * tcap + 8 * kept + 4 * n_rows
               + n_rows * (12 * cap + 32), ops=0, rows=n_rows, tcap=tcap,
               cap=cap)
    return res, gmeta, out[2][:n_rows].cpu().numpy(), kept


def print_c_share(label, r, card):
    """Kernel C's device time at one launch beside its byte bound, and the
    share of the bound it reaches (kept in ``r``)."""
    b_ms, _ = bound(r)
    dev = r.get("device_ms")
    r["share_of_bound"] = b_ms / dev if dev else None
    print(f"  C compact {label}: {r['rows']} rows of {r['tcap']} clauses, "
          f"cap {r['cap']}: device {dev} ms, byte bound {b_ms:.5f} ms, "
          + (f"{100 * b_ms / dev:.1f}% of the bound" if dev
             else "share not measured") + f"  [{card}]")


def time_prepass(fn_frame, card, label):
    """Device time of the prepass (``pipeline3d._shorten_prepass``, the
    plain PyTorch that feeds kernel C) over one 3D frame: its calls are
    recorded in a frame, then replayed and profiled (the sum of its
    kernels' device time) and timed with events."""
    import torch
    from mpr_tpu_torch.render import pipeline3d
    calls = []
    orig = pipeline3d._shorten_prepass

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    pipeline3d._shorten_prepass = rec
    try:
        fn_frame()
    finally:
        pipeline3d._shorten_prepass = orig
    torch.cuda.synchronize()

    def replay():
        for a, k in calls:
            orig(*a, **k)
    ev = cuda_ms(replay, 5, 1)
    _, rows, _ = profile_frames(replay, 3)
    dev = sum(ms for _, ms in rows) if rows else None
    print(f"  prepass {label}: {len(calls)} calls a frame, device "
          + (f"{dev:.4f} ms" if dev is not None else "not measured")
          + f" over {len(rows)} kernel names, {ev:.4f} ms (events)  [{card}]")
    return {"calls": len(calls), "device_ms": dev, "ms": ev}


def compare_kernels(tk, rec, tape, size):
    """Hold each 2D kernel's outputs (recorded on the main path) against its
    plain version on the same CUDA inputs.  Returns per-kernel dicts with
    mismatch counts, max |err| and the data the bounds need."""
    import torch
    res = {"plain": {"interval_shorten": []}}
    res["interval_shorten"] = compare_a(tk, rec["interval_shorten"][0], tape,
                                        f"@{size}^2",
                                        res["plain"]["interval_shorten"])
    res["plain"]["compact_bitshift_batched"] = []
    res["compact_bitshift_batched"], gmeta, runs_h, kept = compare_c(
        tk, rec["compact_bitshift_batched"][0], tape, f"@{size}^2",
        res["plain"]["compact_bitshift_batched"])
    n_amb = gmeta.shape[0]

    (a, k, fill) = rec["pixel_eval_runs"][0]
    pfill = res["plain"]["pixel_eval_runs"] = tk.pixel_eval_runs_plain(*a,
                                                                       **k)
    diff = fill != pfill
    n_fill = int(diff.sum())
    if n_fill:
        idx = torch.nonzero(diff)[:10].tolist()
        print(f"  B differing (tile, pixel): {idx}")
    table = tk.bid_table(a[6])
    full_ops = sum(FLOAT_OPS.get(int(o), 0) for o in tape.ops)
    P = fill.shape[1]
    flops = P * row_ops(gmeta, runs_h, table, full_ops, FLOAT_OPS)
    res["pixel_eval_runs"] = dict(
        mismatches=n_fill, max_abs_err=float((fill - pfill).abs().max()),
        bytes=n_amb * 3 * P * 4 + fill.numel() * 4 + 12 * kept,
        ops=flops)
    fits = gmeta[:, 2] == 0
    print(f"  B pixel_eval_runs @{size}^2: fill mismatches {n_fill}; "
          f"{int(fits.sum())} tiles on their own tapes, mean "
          f"{gmeta[fits, 0].mean() if fits.any() else 0:.1f} clauses in "
          f"{gmeta[fits, 1].mean() if fits.any() else 0:.1f} opcode runs")
    return res


def compare_kernels_3d(tk, tk3, rec, tape, name, keep):
    """Hold every launch of A, C, V and D that one 3D frame recorded against
    the plain versions on the same CUDA inputs.  Returns per-kernel dicts
    (for A and C a list, one per launch); the plain outputs of V and D go
    to ``keep`` for the launch-shape phase."""
    res = {"interval_shorten": [], "compact_bitshift_batched": []}
    stages = ("64^3 tiles", "16^3 cells", "z columns")
    keep["interval_shorten"] = []
    for entry, stage in zip(rec["interval_shorten"], stages):
        res["interval_shorten"].append(
            compare_a(tk, entry, tape, f"{name} {stage}",
                      keep["interval_shorten"]))
    c_rows = []
    keep["compact_bitshift_batched"] = []
    for entry, stage in zip(rec["compact_bitshift_batched"],
                            ("cells", "columns")):
        r, gmeta, runs_h, kept = compare_c(tk, entry, tape, f"{name} {stage}",
                                           keep["compact_bitshift_batched"])
        res["compact_bitshift_batched"].append(r)
        c_rows.append((gmeta, runs_h, kept))

    # ---- V: every ambiguous cell --------------------------------------------
    a, k, vals = rec["voxel_eval_3d"][0]
    n_amb1 = int(a[0][0])
    gmeta, runs_h, kept = c_rows[0]
    pvals = tk3.voxel_eval_3d_plain(*a, **k)
    n_v, e_v = same(vals[:n_amb1], pvals[:n_amb1])
    n_sign = int(((vals[:n_amb1] < 0) != (pvals[:n_amb1] < 0)).sum())
    keep["voxel_eval_3d"] = pvals
    table = tk.bid_table(a[7])
    full_f = sum(FLOAT_OPS.get(int(o), 0) for o in tape.ops)
    flops = 4096 * (row_ops(gmeta, runs_h, table, full_f, FLOAT_OPS)
                    + n_amb1 * COORD_OPS)
    res["voxel_eval_3d"] = dict(
        mismatches=n_v + n_sign, max_abs_err=e_v, rows=n_amb1,
        bytes=12 * kept + 4 * int(gmeta[:, 1].sum()) + 36 * n_amb1
        + 4 * a[2].numel() + 64 + n_amb1 * 4096 * 4,
        ops=flops)
    print(f"  V voxel_eval_3d {name}: {n_amb1} cells, "
          f"{int(gmeta[:, 2].sum())} overflowed: value mismatches {n_v}, "
          f"sign mismatches {n_sign}, max |err| {e_v:.3g}")

    # ---- D: every tile with content ----------------------------------------
    a, k, out = rec["deriv_eval_3d"][0]
    n_act = int(a[0][0])
    gmeta, runs_h, kept = c_rows[1]
    pout = tk3.deriv_eval_3d_plain(*a, **k)
    n_d, e_d = same(out[:n_act], pout[:n_act])
    keep["deriv_eval_3d"] = pout
    full_d = sum(DERIV_OPS.get(int(o), 0) for o in tape.ops)
    flops = 4096 * (row_ops(gmeta, runs_h, table, full_d, DERIV_OPS)
                    + n_act * COORD_OPS)
    res["deriv_eval_3d"] = dict(
        mismatches=n_d, max_abs_err=e_d, rows=n_act,
        bytes=12 * kept + 4 * int(gmeta[:, 1].sum()) + 36 * n_act + 64
        + n_act * 4096 * 4 + n_act * 4 * 4096 * 4,
        ops=flops)
    print(f"  D deriv_eval_3d {name}: {n_act} tiles of {a[11].shape[0]}, "
          f"{int(gmeta[:, 2].sum())} overflowed: mismatches {n_d}, max "
          f"|err| {e_d:.3g}")
    return res


def check_normals(eval_scan, camera, td, mat_t, depth, normals, size, seed):
    """Unit length where there is depth, zero elsewhere, and on 256 seeded
    pixels the direction autograd gives for the plain interpreter at the
    same sample point (one voxel in front of the surface)."""
    import numpy as np
    import torch
    m = depth > 0
    ln = np.linalg.norm(normals[m], axis=-1)
    check(normals.shape == (size, size, 3) and normals.dtype == np.float32,
          "normals have the wrong shape or type")
    check(np.isfinite(normals).all(), "normals not finite")
    check(np.allclose(ln, 1.0, atol=1e-3), "normals not of unit length")
    check(not normals[~m].any(), "normals outside the surface not zero")
    ys, xs = np.nonzero(m)
    sel = np.random.default_rng(seed).choice(len(ys), 256, replace=False)
    ys, xs = ys[sel], xs[sel]
    zi = np.minimum(depth[ys, xs], size - 1)
    w = [torch.as_tensor(((v + 0.5) / size * 2.0 - 1.0).astype(np.float32),
                         device=mat_t.device) for v in (xs, ys, zi)]
    p = torch.stack(camera.transform3(mat_t, *w)).requires_grad_(True)
    eval_scan.eval_f(td, p[0], p[1], p[2]).sum().backward()
    g = p.grad.cpu().numpy().T
    g = g / np.linalg.norm(g, axis=1, keepdims=True)
    err = float(np.abs(g - normals[ys, xs]).max())
    check(err <= 1e-3, f"normals differ from autograd by {err}")
    return float(np.abs(ln - 1.0).max()), err


def run_2d(ctx, results, launches):
    """Phases 2 to 5: the 2D path."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import build
    from mpr_tpu_torch.ops import schedule as sch
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d, render2d, render2d_brute
    tk, dev, card, recorder = ctx["tk"], ctx["dev"], ctx["card"], ctx["rec"]

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
    builds = sch.tape_levels.builds
    recorder.reset_counts()
    try:
        for _, size in CASES:
            recorder.install(recs[size])
            t0 = time.perf_counter()
            images[size] = render2d(tapes[size], size=size)
            torch.cuda.synchronize()
            print(f"render2d @{size}^2: {time.perf_counter() - t0:.3f} s "
                  "(first frame, host clock)")
    finally:
        recorder.remove()
    counts = recorder.counts()
    launches["2d"] = counts
    print(f"2D path launches over {len(CASES)} frames: {counts}")
    for name in KERNELS_2D:
        check(counts[name] >= len(CASES), f"kernel {name} launched "
              f"{counts[name]} times on the 2D path")
    # each render2d call makes the tape's TapeData, whose schedule its one
    # launch of kernel A builds
    check(sch.tape_levels.builds - builds == len(CASES),
          f"{sch.tape_levels.builds - builds} schedules built over "
          f"{len(CASES)} 2D frames")
    for n_blobs, size in CASES:
        print_levels(f"stress_2d({n_blobs})",
                     levels_of(recs[size]["interval_shorten"][0][1]))

    # ---- kernels vs plain, images vs the dense reference --------------------
    for _, size in CASES:
        img = images[size]
        status = recs[size]["interval_shorten"][0][2][0]
        n_amb = int((status == tk.ST_AMBIG).sum())
        print(f"image @{size}^2: filled fraction {img.mean():.6f}, "
              f"{n_amb} of {status.numel()} tiles ambiguous")
        res = compare_kernels(tk, recs[size], tapes[size], size)
        results[size] = res
        for name in KERNELS_2D:
            r = res[name]
            check(r["mismatches"] == 0, f"{name} disagrees with its plain "
                  f"version at {size}^2 ({r['mismatches']} mismatches)")
        want = render2d_brute(tapes[size], size=size)
        bad = img != want
        print(f"  image vs render2d_brute @{size}^2: {int(bad.sum())} pixels "
              "differ")
        check(img.shape == (size, size) and img.dtype == np.bool_,
              "image has the wrong shape or type")
        check(not bad.any(), f"image differs from the dense evaluation at "
              f"{size}^2")
        check(0.0 < img.mean() < 1.0, "image is all empty or all filled")
    torch.cuda.synchronize()

    # ---- an edited tape renders with no new build ----------------------------
    edited = mpr_tpu_torch.compile_tree(shapes.union(
        shapes.circle(0.5), shapes.rectangle(-0.9, -0.2, 0.3, 0.8)))
    img = render2d(edited, size=1024)
    check(np.array_equal(img, render2d_brute(edited, size=1024)),
          "edited tape renders wrong")
    check((build.BuildStats.loads, build.BuildStats.compiles)
          == ctx["builds"], "the edited tape caused a new build")
    print(f"edited tape ({edited.length} clauses, another op set): exact, "
          f"libraries loaded still {build.BuildStats.loads}")

    # ---- timing ----------------------------------------------------------------
    for _, size in CASES:
        rec = recs[size]
        td = TapeData.from_tape(tapes[size], device=dev)
        eye = torch.eye(3, device=dev)
        z = torch.tensor(0.0, device=dev)
        pipeline2d.render_tile_block(td, eye, z, size)
        builds = sch.tape_levels.builds
        frame_ms = cuda_ms(
            lambda: pipeline2d.render_tile_block(td, eye, z, size), 20, 3)
        check(sch.tape_levels.builds == builds, "a 2D frame after the "
              "first on one tape built a schedule")
        t0 = time.perf_counter()
        for _ in range(10):
            pipeline2d.render_tile_block(td, eye, z, size)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 100
        line = [f"frame @{size}^2: {frame_ms:.3f} ms (events), "
                f"{wall_ms:.3f} ms (host clock, mean of 10)"]
        for name in KERNELS_2D:
            a, k, _ = rec[name][0]
            fn = getattr(tk, name)
            ms = cuda_ms(lambda: fn(*a, **k), 30, 3)
            r = results[size][name]
            r["ms"] = ms
            r["device_ms"] = device_ms(lambda: fn(*a, **k))
            if size == CASES[0][1]:
                plain = getattr(tk, name + "_plain")
                r["plain_ms"] = cuda_ms(lambda: plain(*a, **k), 3, 1)
            line.append(f"{name} {ms:.4f} ms (device {r['device_ms']})")
        print("; ".join(line) + f"  [{card}]")
        print_c_share(f"@{size}^2", results[size]["compact_bitshift_batched"],
                      card)

    # ---- where a frame's device time goes -----------------------------------
    for _, size in CASES:
        td = TapeData.from_tape(tapes[size], device=dev)
        eye = torch.eye(3, device=dev)
        z = torch.tensor(0.0, device=dev)
        print_profile(
            f"@{size}^2",
            lambda: pipeline2d.render_tile_block(td, eye, z, size), card, 5)
    size = CASES[0][1]
    ctx["recs2d"] = recs
    ctx["frame2d"] = dict(rec=recs[size], tape=tapes[size], size=size,
                          image=images[size])


def run_stale_imms(ctx):
    """Phase 5b: kernel A under a schedule built before the tape's
    immediates changed, on the 1024^2 cell's tape and tiles."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d
    tk, dev, card = ctx["tk"], ctx["dev"], ctx["card"]
    n_blobs, size = CASES[0]
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(
        shapes.stress_2d(n_blobs)), device=dev)
    old = td.levels()                   # built with the tape's own imms
    imms = td.imms.clone()
    noise = np.random.default_rng(56).normal(0.0, 0.05, td.length)
    imms[:td.length] += torch.from_numpy(noise.astype(np.float32)).to(dev)
    boxes = pipeline2d._tile_boxes_2d(size // 64, torch.eye(3, device=dev),
                                      torch.tensor(0.0, device=dev))
    meta, lanes = td.meta(), boxes.shape[1]
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    plain = tk.interval_shorten_plain(meta, td.packed, imms, boxes,
                                      s_cap=s_cap)
    before = tk.interval_shorten_plain(meta, td.packed, td.imms, boxes,
                                       s_cap=s_cap)
    n_old, c_old, _ = a_mismatches(tk, before, plain)
    check(n_old + c_old > 0, "the changed immediates change no status or "
          "code: the phase cannot tell old from new")
    for kw in (None, dict(threads=1024), dict(threads=256, stage=True)):
        launch = None if kw is None else ln.interval_launch(old.widths,
                                                            lanes, **kw)
        out = tk.interval_shorten(meta, td.packed, imms, boxes, s_cap=s_cap,
                                  levels=old, launch=launch)
        torch.cuda.synchronize()
        n_st, n_codes, _ = a_mismatches(tk, out, plain)
        label = "picked" if kw is None else a_label(launch)
        print(f"  A under an old schedule, new imms @{size}^2 [{label}]: "
              f"status mismatches {n_st}, code word mismatches {n_codes} "
              f"(the old imms' plain output differs in {n_old} statuses, "
              f"{c_old} code words)  [{card}]")
        check(n_st + n_codes == 0, "kernel A follows the schedule's "
              f"immediates, not the call's ({label})")


def run_3d(ctx, results, launches):
    """Phases 6 to 8: the 3D path."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops import schedule as sch
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import (camera, pipeline3d, render3d,
                                      render3d_brute)
    tk, tk3, dev, card, recorder = (ctx["tk"], ctx["tk3"], ctx["dev"],
                                    ctx["card"], ctx["rec"])

    tapes, mats = {}, {}
    for name, make, view, size in CASES_3D:
        t0 = time.perf_counter()
        tapes[name] = t = mpr_tpu_torch.compile_tree(make(shapes))
        mats[name] = camera.gui3d_view(*view)
        print(f"{name}: {t.length} clauses, {t.num_slots} slots, bucket "
              f"{TapeData.from_tape(t, device='cpu').capacity}, compiled in "
              f"{time.perf_counter() - t0:.2f} s")

    # ---- the main path: render3d, every launch recorded ----------------------
    recs = {name: {} for name, *_ in CASES_3D}
    frames = {}
    recorder.reset_counts()
    before = recorder.counts()
    try:
        for name, _, _, size in CASES_3D:
            recorder.install(recs[name])
            builds = sch.tape_levels.builds
            t0 = time.perf_counter()
            frames[name] = render3d(tapes[name], mat=mats[name], size=size)
            torch.cuda.synchronize()
            print(f"render3d {name} @{size}^3: "
                  f"{time.perf_counter() - t0:.3f} s (first frame, host "
                  "clock)")
            now = recorder.counts()
            for kname, need in LAUNCHES_3D.items():
                got = now[kname] - before[kname]
                check(got >= need, f"kernel {kname} launched {got} times in "
                      f"the {name} frame, {need} expected")
            before = now
            # the frame's three launches of kernel A share one schedule
            lvs = [levels_of(k) for _, k, _ in recs[name]["interval_shorten"]]
            check(sch.tape_levels.builds - builds == 1
                  and all(lv is lvs[0] for lv in lvs),
                  f"the {name} frame built {sch.tape_levels.builds - builds}"
                  " schedules, or its launches of kernel A do not share one")
            print_levels(name, lvs[0])
    finally:
        recorder.remove()
    launches["3d"] = recorder.counts()
    print(f"3D path launches over {len(CASES_3D)} frames: {launches['3d']}")
    ctx["recs3d"] = recs
    for name, *_ in CASES_3D:
        a, k, _ = recs[name]["voxel_eval_3d"][0]
        v = tk3.voxel_launch(k["s_cap"], a[8].shape[1])
        a, k, _ = recs[name]["deriv_eval_3d"][0]
        d = tk3.deriv_launch(k["s_cap"], a[7].shape[1], a[7].shape[0],
                             a[3].shape[0])
        results[name] = {"shapes": {"voxel_eval_3d": shape_label(v),
                                    "deriv_eval_3d": shape_label(d)}}
        print(f"launch shapes {name}: V {shape_label(v)} (s_cap "
              f"{k['s_cap']}, cap {a[7].shape[1]}); D {shape_label(d)} "
              f"({a[7].shape[0]} rows, full tape {a[3].shape[0]})")
    check(launches["3d"]["pixel_eval_runs"] == 0,
          "the 3D path launched the 2D pixel kernel")

    # with_normals=False returns the same depth and launches no kernel D
    name, _, _, size = CASES_3D[0]
    d_before = tk3.deriv_eval_3d.launches
    d2, none = render3d(tapes[name], mat=mats[name], size=size,
                        with_normals=False)
    check(none is None and np.array_equal(d2, frames[name][0]),
          "with_normals=False changed the depth")
    check(tk3.deriv_eval_3d.launches == d_before,
          "with_normals=False launched kernel D")

    # ---- kernels vs plain, depth vs the dense reference, normals -------------
    for i, (name, _, _, size) in enumerate(CASES_3D):
        depth, normals = frames[name]
        a_v = recs[name]["voxel_eval_3d"][0][0]
        print(f"image {name} @{size}^3: covered fraction "
              f"{(depth > 0).mean():.6f}, {a_v[2].numel()} of "
              f"{(size // 64) ** 3} tiles and {int(a_v[0][0])} of "
              f"{(size // 16) ** 3} cells ambiguous after the culls")
        keep = ctx.setdefault("plain3d", {})[name] = {}
        res = compare_kernels_3d(tk, tk3, recs[name], tapes[name], name,
                                 keep)
        results[name].update(res)
        for kname, r in res.items():
            for j, rr in enumerate(r if isinstance(r, list) else [r]):
                check(rr["mismatches"] == 0, f"{kname} (launch {j}) "
                      f"disagrees with its plain version in {name} "
                      f"({rr['mismatches']} mismatches)")
        t0 = time.perf_counter()
        want = render3d_brute(tapes[name], mat=mats[name], size=size)
        bad = depth != want
        print(f"  depth vs render3d_brute @{size}^3: {int(bad.sum())} pixels "
              f"differ ({time.perf_counter() - t0:.1f} s of dense "
              "evaluation)")
        check(depth.shape == (size, size) and depth.dtype == np.int32,
              "depth has the wrong shape or type")
        check(not bad.any(), f"depth differs from the dense evaluation in "
              f"{name}")
        check(0.0 < (depth > 0).mean() < 1.0, "depth all empty or all set")
        td = TapeData.from_tape(tapes[name], device=dev)
        e_len, e_ad = check_normals(eval_scan, camera, td,
                                    torch.as_tensor(mats[name], device=dev),
                                    depth, normals, size, 95 + i)
        print(f"  normals {name}: | |n| - 1 | <= {e_len:.2e} where depth > 0,"
              f" zero elsewhere; max |n - autograd| on 256 pixels {e_ad:.2e}")
    torch.cuda.synchronize()

    # ---- timing ----------------------------------------------------------------
    for name, _, _, size in CASES_3D:
        rec, res = recs[name], results[name]
        td = TapeData.from_tape(tapes[name], device=dev)
        mat_t = torch.as_tensor(mats[name], device=dev)
        n = size // 64

        def frame(normals=True):
            return pipeline3d.render3d_rows(td, mat_t, size, 0, n, normals)
        frame()
        builds = sch.tape_levels.builds
        f_ms = cuda_ms(frame, 10, 2)
        check(sch.tape_levels.builds == builds, "a 3D frame after the first "
              "on one tape built a schedule")
        f0_ms = cuda_ms(lambda: frame(False), 10, 2)
        t0 = time.perf_counter()
        for _ in range(5):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 200
        print(f"frame {name} @{size}^3: {f_ms:.3f} ms with normals, "
              f"{f0_ms:.3f} ms without (events, median of 10); "
              f"{wall_ms:.3f} ms (host clock, mean of 5)  [{card}]")
        for kname, mod in (("voxel_eval_3d", tk3), ("deriv_eval_3d", tk3)):
            a, k, _ = rec[kname][0]
            fn = getattr(mod, kname)
            plain = getattr(mod, kname + "_plain")
            r = res[kname]
            r["ms"] = cuda_ms(lambda: fn(*a, **k), 30, 3)
            r["device_ms"] = device_ms(lambda: fn(*a, **k))
            r["plain_ms"] = plain_ms(lambda: plain(*a, **k))
            print(f"  {kname} {r['ms']:.4f} ms (device {r['device_ms']}) "
                  f"over {r['rows']} rows; plain {r['plain_ms']:.1f} ms  "
                  f"[{card}]")
        for kname in ("interval_shorten", "compact_bitshift_batched"):
            fn = getattr(tk, kname)
            plain = getattr(tk, kname + "_plain")
            for (a, k, _), r in zip(rec[kname], res[kname]):
                r["ms"] = cuda_ms(lambda: fn(*a, **k), 30, 3)
                r["device_ms"] = device_ms(lambda: fn(*a, **k))
                r["plain_ms"] = plain_ms(lambda: plain(*a, **k))
            print(f"  {kname} per launch: "
                  + ", ".join(f"{r['ms']:.4f}" for r in res[kname])
                  + " ms (device "
                  + ", ".join(f"{r['device_ms']}" for r in res[kname])
                  + "); plain "
                  + ", ".join(f"{r['plain_ms']:.1f}" for r in res[kname])
                  + f" ms  [{card}]")
        for stage, r in zip(("cells", "columns"),
                            res["compact_bitshift_batched"]):
            print_c_share(f"{name} {stage}", r, card)
        res["prepass"] = time_prepass(frame, card, f"{name} @{size}^3")
        print_profile(f"{name} @{size}^3", frame, card, 3)
    name = CASES_3D[0][0]
    ctx["frame3d"] = dict(name=name, size=CASES_3D[0][3], frame=frames[name])


def masked_same(a, b, lens):
    """Mismatches of two (rows, width) tensors over ``[0, lens[row])`` of
    each row, floats compared by their bits."""
    import torch
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    k = torch.arange(a.shape[1], device=a.device)
    m = k[None, :] < lens[:, None]
    return int(((a != b) & m).sum())


def run_v1(ctx, results, launches):
    """Phase 9: kernels B1, C1 and C2 on the recorded 1024^2 frame."""
    import numpy as np
    import torch
    tk, card, recorder = ctx["tk"], ctx["card"], ctx["rec"]
    f = ctx["frame2d"]
    rec, tape, size = f["rec"], f["tape"], f["size"]
    (meta, words, imms, _), _, (status, codes) = rec["interval_shorten"][0]
    (cmeta_c, lens_c, wrw_r, irw_r, rem_r), kc, out_c = \
        rec["compact_bitshift_batched"][0]
    a_b, k_b, fill = rec["pixel_eval_runs"][0]
    nmeta_b, order, coords = a_b[0], a_b[1], a_b[11]
    dev = codes.device
    n_tiles, tcap = codes.shape[0], words.shape[0]
    n = int(cmeta_c[0])
    cap8 = out_c[0].shape[1]
    P = coords.shape[2]
    # the frame's own branch numbering, so that C1's run headers can be
    # held against kernel C's where the tapes are equal
    remap_t = torch.zeros(32, dtype=torch.int32, device=dev)
    table = tk.bid_table(a_b[6])
    for bid, op in enumerate(table.tolist()):
        if op:
            remap_t[op] = bid
    tiles = order[:n].long()

    def cmeta(*vals):
        m = torch.zeros(8, dtype=torch.int32, device=dev)
        m[:len(vals)] = torch.tensor(vals, dtype=torch.int32)
        return m

    # the frame's capacity, and half of it so that some tapes overflow
    caps = (tcap, cap8, cap8 // 2)
    c1_args = {cap: (cmeta(n, tcap // 8, cap), words, imms, order, remap_t,
                     codes, n_tiles, cap, cap) for cap in caps}
    # the prepass planes back in TILE order, as C2 reads them
    planes_t = []
    for p in (wrw_r, irw_r, rem_r):
        t = torch.empty_like(p)
        t[order.long()] = p
        planes_t.append(t)
    lens_t = torch.empty_like(lens_c)
    lens_t[order.long()] = lens_c
    c2_args = (cmeta(n, cap8, cap8), order, lens_t, *planes_t, n_tiles, cap8,
               cap8)

    def b1_args(c1_out):
        tw, ti, _, gmeta = c1_out
        w_t, i_t = torch.zeros_like(tw), torch.zeros_like(ti)
        l_t = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        w_t[tiles], i_t[tiles], l_t[tiles] = tw[:n], ti[:n], gmeta[:n, 0]
        nm = nmeta_b.clone()
        nm[0] = n
        nm[6] = 0
        return (nm, order, l_t, w_t, i_t, coords)

    s_cap = k_b["s_cap"]

    # ---- the drive: every count at 0, the chain once, the counts read ------
    recorder.reset_counts()
    c1 = {cap: tk.compact_runs(*c1_args[cap]) for cap in caps}
    args_b1 = b1_args(c1[tcap])
    vals = tk.pixel_eval(*args_b1, s_cap=s_cap)
    c2 = tk.compact_bitshift(*c2_args)
    torch.cuda.synchronize()
    counts = recorder.counts()
    launches["v1"] = counts
    print(f"kernel phase launches: "
          f"{ {k: counts[k] for k in KERNELS_V1} }")
    for name in KERNELS_V1:
        check(counts[name] >= 1, f"kernel {name} was not launched by the "
              "kernel phase")

    res = results["v1"] = {}
    # ---- C1 against its plain version ---------------------------------------
    mism, kept = 0, {}
    for cap in caps:
        got, want = c1[cap], tk.compact_runs_plain(*c1_args[cap])
        gm = got[3][:n]
        ln, nr = gm[:, 0], torch.clamp(gm[:, 1], max=cap)
        m = dict(gmeta=same(gm[:, :3], want[3][:n, :3])[0],
                 tw=masked_same(got[0][:n], want[0][:n], ln),
                 ti=masked_same(got[1][:n], want[1][:n], ln),
                 runs=masked_same(got[2][:n], want[2][:n], nr))
        kept[cap] = (int(ln.sum()), int(nr.sum()))
        print(f"  C1 compact_runs cap {cap}: {n} groups, mean len "
              f"{kept[cap][0] / max(n, 1):.1f} of {tape.length}, "
              f"{int(gm[:, 2].sum())} flagged; mismatches {m}")
        mism += sum(m.values())
    # and against the frame: at cap = Tcap the lengths are the prepass's
    # (kernel A's codes are zero past the tape) and the run headers kernel
    # C's, on the rows C did not flag
    gm_c = out_c[3][:n]
    fits = gm_c[:, 2] == 0
    gm1 = c1[tcap][3][:n]
    check(bool((gm1[:, 0] == lens_c[:n]).all()),
          "C1's lengths differ from the prepass's")
    check(bool((gm1[fits][:, 1] == gm_c[fits][:, 1]).all())
          and masked_same(c1[tcap][2][:n][fits][:, :cap8],
                          out_c[2][:n][fits], gm_c[fits][:, 1]) == 0,
          "C1's run headers differ from kernel C's")
    for cap in caps[1:]:
        gm = c1[cap][3][:n]
        check(bool(((lens_c[:n] >= cap) == (gm[:, 2] == 1)).all())
              and bool((gm[:, 0] == torch.clamp(lens_c[:n], max=cap)).all()),
              f"C1 at cap {cap}: len is not min(count, cap) or the flag is "
              "not count >= cap")
    check(bool(c1[caps[-1]][3][:n, 2].any()),
          f"no tape overflowed cap {caps[-1]}")
    k_len, k_runs = kept[tcap]
    res["compact_runs"] = dict(
        mismatches=mism, max_abs_err=0.0,
        bytes=8 * tape.length + 4 * n * (tcap // 8) + 4 * n + 128 + 32
        + 8 * k_len + 4 * k_runs + 32 * n, ops=0)

    # ---- B1 against its plain version and the frame's fill -----------------
    pvals = tk.pixel_eval_plain(*args_b1, s_cap=s_cap)
    n_b1, e_b1 = same(vals[:n], pvals[:n])
    ok_rows = gm1[:, 2] == 0
    fill_rows = fill[tiles] > 0
    n_sign = int(((vals[:n] < 0) != fill_rows)[ok_rows].sum())
    print(f"  B1 pixel_eval: {n} groups x {P} pixels, value mismatches "
          f"{n_b1} (max |err| {e_b1:.3g}); signs against the frame's fill "
          f"on {int(ok_rows.sum())} unflagged tiles: {n_sign} differ")
    lut = np.zeros(256, np.int64)
    for o, c in FLOAT_OPS.items():
        lut[o] = c
    tw_h = c1[tcap][0][:n].cpu().numpy()
    ln_h = gm1[:, 0].cpu().numpy()
    per_px = sum(int(lut[tw_h[g, :ln_h[g]] & 0xFF].sum()) for g in range(n))
    res["pixel_eval"] = dict(
        mismatches=n_b1 + n_sign, max_abs_err=e_b1,
        bytes=n * 3 * P * 4 + n * P * 4 + 8 * k_len + 8 * n + 32,
        ops=P * per_px)

    # ---- C2 against its plain version and kernel C --------------------------
    want = tk.compact_bitshift_plain(*c2_args)
    m = {}
    for nm, g, w, c in zip(("tw", "ti", "runs"), c2[:3], want[:3], out_c[:3]):
        m[nm] = same(g[:n], w[:n])[0] + same(g[:n], c[:n])[0]
    m["gmeta"] = (same(c2[3][:n, :3], want[3][:n, :3])[0]
                  + same(c2[3][:n, :3], out_c[3][:n, :3])[0])
    print(f"  C2 compact_bitshift: {n} groups; mismatches against the plain "
          f"version and kernel C {m}")
    kept_c = int(out_c[3][:n, 0].sum())
    res["compact_bitshift"] = dict(
        mismatches=sum(m.values()), max_abs_err=0.0,
        bytes=4 * n * tcap + 8 * kept_c + 8 * n + n * (12 * cap8 + 32),
        ops=0)
    for name, r in res.items():
        check(r["mismatches"] == 0, f"{name} disagrees with its plain "
              f"version or the frame ({r['mismatches']} mismatches)")

    # ---- timing ---------------------------------------------------------------
    timed = (("compact_runs", lambda: tk.compact_runs(*c1_args[tcap]),
              lambda: tk.compact_runs_plain(*c1_args[tcap])),
             ("pixel_eval", lambda: tk.pixel_eval(*args_b1, s_cap=s_cap),
              lambda: tk.pixel_eval_plain(*args_b1, s_cap=s_cap)),
             ("compact_bitshift", lambda: tk.compact_bitshift(*c2_args),
              lambda: tk.compact_bitshift_plain(*c2_args)))
    for name, fn, plain in timed:
        res[name]["ms"] = cuda_ms(fn, 30, 3)
        res[name]["device_ms"] = device_ms(fn)
        res[name]["plain_ms"] = plain_ms(plain)
    res["compact_runs"]["ms_cap8"] = cuda_ms(
        lambda: tk.compact_runs(*c1_args[cap8]), 30, 3)
    c_ms = cuda_ms(lambda: tk.compact_bitshift_batched(
        cmeta_c, lens_c, wrw_r, irw_r, rem_r, **kc), 30, 3)
    b_ms = cuda_ms(lambda: tk.pixel_eval_runs(*a_b, **k_b), 30, 3)
    print(f"kernel phase @{size}^2: C1 {res['compact_runs']['ms']:.4f} ms at "
          f"cap {tcap}, {res['compact_runs']['ms_cap8']:.4f} ms at cap "
          f"{cap8}; B1 {res['pixel_eval']['ms']:.4f} ms (kernel B beside it "
          f"{b_ms:.4f}); C2 {res['compact_bitshift']['ms']:.4f} ms (kernel "
          f"C beside it {c_ms:.4f}); device C1 "
          f"{res['compact_runs']['device_ms']}, B1 "
          f"{res['pixel_eval']['device_ms']}, C2 "
          f"{res['compact_bitshift']['device_ms']} ms; plain "
          + ", ".join(f"{res[k]['plain_ms']:.1f}" for k in
                      ("compact_runs", "pixel_eval", "compact_bitshift"))
          + f" ms  [{card}]")


def run_cli(ctx, launches):
    """Phase 10: the command line, as a subprocess and once in process."""
    import tempfile
    import numpy as np
    from mpr_tpu_torch import cli
    from mpr_tpu_torch.frontend import frep, shapes
    from mpr_tpu_torch.io.png import read_png_gray
    from mpr_tpu_torch.render import camera, render3d
    import mpr_tpu_torch
    recorder = ctx["rec"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        scene = shapes.intersection(shapes.gyroid(0.4, 0.08),
                                    shapes.sphere(0.85))
        frep.dump([frep.ArchiveShape(tree=scene, name="gyroid_sphere")],
                  os.path.join(tmp, "scene.frep"))

        def run(*argv):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.cli",
                                *argv], cwd=tmp, env=env,
                               capture_output=True, text=True, timeout=600)
            print(f"cli {' '.join(argv)}: exit {r.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in r.stdout.strip().splitlines():
                print("    " + line)
            check(r.returncode == 0, f"cli {argv[0]} failed:\n{r.stderr}")
            return r.stdout

        n_blobs, size = CASES[0]
        out = run("render2d", f"stress:{n_blobs}", "--size", str(size),
                  "--check")
        check("oracle cross-check: mismatch 0.00e+00" in out,
              "render2d --check printed no exact cross-check")
        img = read_png_gray(os.path.join(tmp, "out_2d.png")) > 0
        check(np.array_equal(img, ctx["frame2d"]["image"]),
              "the command line's 2D image differs from render2d's")

        run("render3d", "scene.frep", "--size", "512", "--mode", "all",
            "--view", "gui")
        tape = mpr_tpu_torch.compile_tree(scene)
        depth, _ = render3d(tape, mat=camera.gui3d_view(), size=512)
        pngs = {s: read_png_gray(os.path.join(tmp, f"out_3d_{s}.png"))
                for s in ("depth", "ssao", "shaded")}
        check(os.path.getsize(os.path.join(tmp, "out_3d_norm.png")) > 1000,
              "no normals image")
        check(np.array_equal(pngs["depth"], cli._depth_to_u8(depth, 512)),
              "the command line's depth image differs from render3d's")
        m = depth > 0
        check(0.0 < m.mean() < 1.0 and not pngs["shaded"][~m].any()
              and pngs["shaded"][m].min() >= int(0.2 * 255),
              "the shaded image is not 0 off the shape and >= 0.2 on it")
        check(not pngs["ssao"][~m].any() and pngs["ssao"][m].mean() > 64,
              "the SSAO image is off")
        print(f"  render3d PNGs: covered {m.mean():.4f}, shaded in "
              f"[{pngs['shaded'][m].min()}, {pngs['shaded'][m].max()}] / "
              f"255 on the shape, mean SSAO {pngs['ssao'][m].mean():.1f}")

        out = run("render2d", os.path.join(ROOT, "examples", "text_demo.io"),
                  "--size", "512", "--check", "--out", "text.png")
        check("mismatch 0.00e+00" in out, "the .io scene is not exact")
        out = run("shorten-stats", f"stress:{n_blobs}", "--size", str(size))
        check("shortened lengths (ambiguous tiles)" in out,
              "shorten-stats printed no distribution")

        # in process, so that the launch counts can be read
        recorder.reset_counts()
        cli.main(["render2d", f"stress:{n_blobs}", "--size", str(size),
                  "--out", os.path.join(tmp, "p2.png")])
        cli.main(["render3d", os.path.join(tmp, "scene.frep"), "--size",
                  "512", "--mode", "shaded", "--view", "gui", "--out",
                  os.path.join(tmp, "p3.png")])
    counts = recorder.counts()
    launches["cli"] = counts
    print(f"command line launches (render2d + render3d in process): "
          f"{counts}")
    for name, _, *_ in KERNEL_ROWS:
        if name not in KERNELS_V1:
            check(counts[name] >= 1, f"the command line launched kernel "
                  f"{name} {counts[name]} times")


def run_effects(ctx):
    """Phase 11: SSAO and shading on the card against the CPU, and timed."""
    import torch
    from mpr_tpu_torch.render import effects
    card, dev = ctx["card"], ctx["dev"]
    f = ctx["frame3d"]
    depth_h, normals_h = f["frame"]
    depth = torch.as_tensor(depth_h, device=dev)
    normals = torch.as_tensor(normals_h, device=dev)
    rows = []
    for label, fn in (
            ("draw_ssao static", lambda d, n: effects.draw_ssao(
                d, n, mode="static")),
            ("draw_ssao gather", lambda d, n: effects.draw_ssao(
                d, n, mode="gather")),
            ("draw_shaded", effects.draw_shaded)):
        got = fn(depth, normals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fn(depth.cpu(), normals.cpu())
        cpu_s = time.perf_counter() - t0
        d = (got.cpu() - want).abs()
        share = float((d > 1e-5).float().mean())
        far = float(d.max())
        ms = cuda_ms(lambda: fn(depth, normals), 5, 1)
        rows.append({"name": label, "at": f"{f['name']} {f['size']}^2",
                     "ms": ms, "max_abs_diff_vs_cpu": far,
                     "share_over_1e-5": share, "cpu_s": cpu_s})
        print(f"effects {label} @{f['size']}^2: {ms:.3f} ms on the card "
              f"(events, median of 5); against the CPU ({cpu_s:.1f} s "
              f"there): max |diff| {far:.3g}, {100 * share:.4f}% of pixels "
              f"over 1e-5  [{card}]")
        check(got.shape == depth.shape and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()), f"{label}: bad image")
        check(float(got.min()) >= 0.0 and float(got.max()) <= 1.0
              and not bool(got[depth == 0].any()), f"{label}: out of range")
        check(share <= EFFECT_SHARE and far <= EFFECT_FAR,
              f"{label}: the card and the CPU disagree")
    return rows


def bound(r):
    """(bound ms, what bounds it) from a result's bytes and operations."""
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = r["ops"] / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_rows(log):
    """(kernel, K, bucket, registers, stack bytes, spill stores, spill
    loads) for each instantiation of kernels B, V and D in nvcc's -Xptxas
    -v output (bucket 0 is the shared home), of kernel A (K is 1 with
    widening, 0 without; bucket 0) and of kernels C and C2 (K is 1 for a
    warp a row, 0 for a block a row; bucket 0)."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(voxel_eval_kernel|"
                      r"deriv_eval_kernel|pixel_eval_kernel)ILi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = [m.group(1), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Function properties for \S*?(interval_shorten_kernel|"
                      r"compact_kernel|compact_order_kernel)ILb(\d)E", line)
        if m:
            cur = [m.group(1), int(m.group(2)), 0]
            continue
        if "Function properties for" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur += [int(m.group(1)), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and len(cur) == 6:
            rows.append((cur[0], cur[1], cur[2], int(m.group(1)), *cur[3:]))
            cur = None
    return rows


def print_ptxas(tk3, logs):
    """Registers, stack frame and spills of every instantiation of A, B,
    V and D in the libraries' nvcc logs (``{library: log}``; bucket 0:
    the files in shared memory; else local, or for D split by warps).
    Every (kernel, K, bucket) of B, V and D must be built, those of
    ``tk3.MAIN_K`` in the main library, and both of A's (with and without
    widening), C's and C2's (a warp or a block a row) in the main library.
    Returns the instantiations that spill: the run fails on them once every
    phase has run."""
    names = {"pixel_eval_kernel": "pixel_eval_runs",
             "voxel_eval_kernel": "voxel_eval_3d",
             "deriv_eval_kernel": "deriv_eval_3d"}
    spills, built = [], {}
    for lib_name, log in sorted(logs.items()):
        for kern, k, bucket, regs, stack, st, ld in sorted(ptxas_rows(log)):
            built.setdefault((kern, k, bucket), set()).add(lib_name)
            if kern.startswith("interval"):
                shape = "widen" if k else "no widening"
            elif kern.startswith("compact"):
                shape = "a warp a row" if k else "a block a row"
            else:
                shape = f"K={k} " + ("shared" if bucket == 0 else (
                    f"local/split {bucket} slots" if kern.startswith("deriv")
                    else f"local {bucket} slots"))
            print(f"  ptxas [{lib_name}] {kern} {shape}: {regs} "
                  f"registers, {stack} B stack frame, {st} B spill stores, "
                  f"{ld} B spill loads")
            if st + ld:
                spills.append(f"{kern} K={k} bucket {bucket}")
    for kern, name in names.items():
        for k in tk3.KS:
            for bucket in (0,) + tk3.BUCKETS:
                want = ("main" if k == tk3.MAIN_K[name][bucket != 0]
                        else "extra")
                check(want in built.get((kern, k, bucket), ()),
                      f"{kern} K={k} bucket {bucket} is not in the {want} "
                      f"library (ptxas saw {sorted(built)})")
    for widen in (0, 1):
        check("main" in built.get(("interval_shorten_kernel", widen, 0), ()),
              f"kernel A (widen {widen}) is not in the main library")
    for kern in ("compact_kernel", "compact_order_kernel"):
        for warp in (0, 1):
            check("main" in built.get((kern, warp, 0), ()),
                  f"{kern} (warp a row {warp}) is not in the main library")
    return spills


# Forced launch shapes of phase 8b, as keyword arguments of voxel_launch
# and deriv_launch ("most" P: 4096 / (threads x K)); shapes that do not
# fit the cell are printed as refused and not run, and repeats are left
# out.
EDGE_V = ([dict(home="shared", k=kk) for kk in (1, 2, 4)]
          + [dict(home="shared", k=4, threads=128)]
          + [dict(home="local", k=kk, threads=t) for kk, t in
             ((1, 256), (1, 512), (2, 256), (2, 512), (4, 256))])
EDGE_D = ([dict(home=h, k=kk, parts=p) for h in ("shared", "local")
           for kk in (1, 2, 4) for p in (None, 1, "most")]
          + [dict(home="split", k=kk, threads=t, shared_warps=sw, parts=p)
             for kk, t, sw, p in ((1, 256, 1, None), (1, 256, None, None),
                                  (1, 256, None, 1), (1, 256, None, "most"),
                                  (1, 128, None, None), (2, 256, None, None))]
          + [dict(home="local", stage_full=False),
             dict(home="split", stage_full=False)])


def edge_shapes(tk3, kname, a, k):
    """(label, launch) for the forced shapes of phase 8b at one recorded
    launch of V or D; launch is the reason, a string, where the shape does
    not fit."""
    tw = a[8] if kname == "voxel_eval_3d" else a[7]
    gcap, cap = tw.shape
    s_cap = k["s_cap"]
    if kname == "voxel_eval_3d":
        return forced(lambda: tk3.voxel_launch(s_cap, cap),
                      lambda **kw: tk3.voxel_launch(s_cap, cap, **kw),
                      EDGE_V)
    tcap = a[3].shape[0]

    def deriv(**kw):
        if kw.get("parts") == "most":
            base = tk3.deriv_launch(s_cap, cap, gcap, tcap,
                                    **{**kw, "parts": None})
            kw["parts"] = 4096 // (base.threads * base.k)
        return tk3.deriv_launch(s_cap, cap, gcap, tcap, **kw)
    return forced(lambda: tk3.deriv_launch(s_cap, cap, gcap, tcap), deriv,
                  EDGE_D)


def bit_mismatches(a, b):
    """Elements whose float bits differ, NaNs in the same places equal."""
    import torch
    nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(torch.int32) != b.view(torch.int32)) & ~nan).sum())


def shape_label(launch):
    return (f"{launch.home} threads={launch.threads} K={launch.k} "
            f"P={launch.blocks_per_row} smem={launch.smem}"
            + (f" shared_warps={launch.shared_warps}"
               if launch.home == "split" else "")
            + (f" bucket={launch.bucket}" if launch.bucket else "")
            + (" full-tape-staged" if launch.stage_full else ""))


# Forced launch shapes of kernels A and B in phase 8b, as keyword arguments
# of interval_launch and pixel_launch.
EDGE_A = ([dict(threads=t) for t in (32, 64, 128, 256, 512, 1024)]
          + [dict(threads=t, stage=True) for t in (256, 1024)]
          + [dict(threads=t, tiles=t, stage=st) for t in (64, 128, 256)
             for st in (True, False)])
EDGE_B = ([dict(home="local", k=kk) for kk in (1, 2, 4)]
          + [dict(home="local", k=2, parts=p) for p in (1, 2, 4, 8)]
          + [dict(home="local", k=2, threads=128, parts=16)]
          + [dict(home="shared", k=kk) for kk in (1, 2, 4)]
          + [dict(home="local", k=2, stage_full=st) for st in (True,
                                                               False)])


# Forced launch shapes of kernel C in phase 8b, as keyword arguments of
# compact_launch: a warp a row at 1, 4, 8 and 32 rows a block, a block a
# row at 128 to 1024 threads.
EDGE_C = ([dict(warp=True, threads=t) for t in (32, 128, 256, 1024)]
          + [dict(warp=False, threads=t) for t in (128, 256, 512, 1024)])


def c_label(launch):
    return (f"threads={launch.threads} "
            + ("a warp a row" if launch.group == 32 else "a block a row")
            + f" smem={launch.smem}")


def a_label(launch):
    return (f"threads={launch.threads} tiles={launch.tiles} smem="
            f"{launch.smem}" + (" staged" if launch.stage else ""))


def forced(picked, fn, kws):
    """(label, launch or the reason it was refused) for the picked shape
    and each forced one, repeats left out."""
    out = []
    for label, kw in [("picked", None)] + [(str(kw), kw) for kw in kws]:
        try:
            launch = picked() if kw is None else fn(**kw)
        except ValueError as e:
            out.append((label, str(e)))
            continue
        if all(launch != x for _, x in out):
            out.append((label, launch))
    return out


def sweep_one(cell, kname, fn, a, k, shapes, same_as_plain, label_of,
              sweep, card):
    """Run ``fn(*a, **k, launch=...)`` at each of ``shapes``, hold it
    against the plain output (``same_as_plain(out)`` counts mismatches),
    time it, and add a row to ``sweep``."""
    import torch
    for label, launch in shapes:
        if isinstance(launch, str):
            print(f"  edge {cell} {kname} {label:24.60s}: refused, does not "
                  f"fit ({launch})")
            continue
        got = fn(*a, **k, launch=launch)
        torch.cuda.synchronize()
        bad = same_as_plain(got)
        del got
        ms = cuda_ms(lambda: fn(*a, **k, launch=launch), 30, 3)
        dev = device_ms(lambda: fn(*a, **k, launch=launch))
        sweep.append({"kernel": kname, "label": label,
                      "shape": label_of(launch), "ms": ms,
                      "device_ms": dev, "mismatches": bad})
        print(f"  edge {cell} {kname} {label:24.60s} [{label_of(launch)}]: "
              f"{ms:.4f} ms (device {dev}), {bad} mismatches against plain"
              f"  [{card}]")
        check(bad == 0, f"{kname} at {label} ({label_of(launch)}) disagrees "
              f"with its plain version in {cell}")


def sweep_a(ctx, cell, entries, plains, sweep):
    """Kernel A at the forced shapes on each recorded launch."""
    from mpr_tpu_torch.ops import launch as ln
    tk = ctx["tk"]
    for (a, k, _), plain in zip(entries, plains):
        lv, lanes = levels_of(k), a[3].shape[1]

        def bad(out, plain=plain):
            n_st, n_codes, _ = a_mismatches(tk, out, plain)
            return n_st + n_codes
        shapes = forced(lambda: ln.interval_launch(lv.widths, lanes),
                        lambda **kw: ln.interval_launch(lv.widths, lanes,
                                                        **kw), EDGE_A)
        sweep_one(f"{cell} ({lanes} lanes)", "interval_shorten",
                  tk.interval_shorten, a, k, shapes, bad, a_label, sweep,
                  ctx["card"])


def sweep_c(ctx, cell, entries, plains, sweep):
    """Kernel C at the forced shapes on each recorded launch."""
    from mpr_tpu_torch.ops import launch as ln
    tk = ctx["tk"]
    for (a, k, _), plain in zip(entries, plains):
        G, R, W = a[2].shape
        n = int(a[0][0])
        args = (R * W, k["cap"], G)

        def bad(out, plain=plain, n=n):
            return sum(c_mismatches(out, plain, n)[0].values())
        shapes = forced(lambda: ln.compact_launch(*args),
                        lambda **kw: ln.compact_launch(*args, **kw), EDGE_C)
        sweep_one(f"{cell} ({n} rows)", "compact_bitshift_batched",
                  tk.compact_bitshift_batched, a, k, shapes, bad, c_label,
                  sweep, ctx["card"])


def run_edges(ctx, results):
    """Phase 8b: kernels V, D, A and C at forced launch shapes on the
    recorded inputs of both 3D cells, A, B and C on those of both 2D cells,
    each output against the plain output of phase 3 or 7, each shape
    timed."""
    import torch
    from mpr_tpu_torch.ops import launch as ln
    tk, tk3, card = ctx["tk"], ctx["tk3"], ctx["card"]
    for n_blobs, size in CASES:
        rec, res = ctx["recs2d"][size], results[size]
        sweep = res["sweep"] = []
        cell = f"stress_2d({n_blobs}) {size}^2"
        sweep_a(ctx, cell, rec["interval_shorten"],
                res["plain"]["interval_shorten"], sweep)
        a, k, _ = rec["pixel_eval_runs"][0]
        args = (k["s_cap"], a[7].shape[1], a[1].shape[0], a[3].shape[0])
        shapes = forced(lambda: ln.pixel_launch(*args),
                        lambda **kw: ln.pixel_launch(*args, **kw), EDGE_B)
        pfill = res["plain"]["pixel_eval_runs"]
        sweep_one(cell, "pixel_eval_runs", tk.pixel_eval_runs, a, k, shapes,
                  lambda out: int((out != pfill).sum()), shape_label, sweep,
                  card)
        sweep_c(ctx, cell, rec["compact_bitshift_batched"],
                res["plain"]["compact_bitshift_batched"], sweep)
        res["plain"] = None
    for name, *_ in CASES_3D:
        rec, plain = ctx["recs3d"][name], ctx["plain3d"][name]
        sweep = results[name]["sweep"] = []
        for kname in ("voxel_eval_3d", "deriv_eval_3d"):
            a, k, _ = rec[kname][0]
            n = int(a[0][0])
            sweep_one(name, kname, getattr(tk3, kname), a, k,
                      edge_shapes(tk3, kname, a, k),
                      lambda out: bit_mismatches(out[:n], plain[kname][:n]),
                      shape_label, sweep, card)
        sweep_a(ctx, name, rec["interval_shorten"],
                plain["interval_shorten"], sweep)
        sweep_c(ctx, name, rec["compact_bitshift_batched"],
                plain["compact_bitshift_batched"], sweep)
        ctx["plain3d"][name] = None
        torch.cuda.synchronize()


def main() -> int:
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
        from mpr_tpu_torch.ops import build
        from mpr_tpu_torch.ops import kernels as tk
        from mpr_tpu_torch.ops import kernels3d as tk3
        from mpr_tpu_torch.ops.tape_data import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the mpr_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {kind}")

    # ---- 1. build ------------------------------------------------------------
    for lib_name in build.LIBRARIES:
        build.lib(lib_name)
        print(f"build {lib_name}: {build.BuildStats.seconds[lib_name]:.1f} s"
              f" (compiles so far {build.BuildStats.compiles}, loads "
              f"{build.BuildStats.loads})", flush=True)
    source = ""
    for line in build.BuildStats.log["main"].splitlines():
        if line.startswith("=="):
            source = line
            print("  " + line.strip())
        elif ("registers" in line or "spill" in line) and not any(
                n in source for n in ("voxel_eval", "deriv_eval",
                                      "pixel_eval.cu", "interval_shorten",
                                      "compact.cu", "compact_order.cu")):
            print("  " + line.strip())
    spills = print_ptxas(tk3, build.BuildStats.log)

    ctx = {"tk": tk, "tk3": tk3, "dev": resolve_device(), "card": card,
           "rec": Recorder({"kernels": tk, "kernels3d": tk3}),
           "builds": (build.BuildStats.loads, build.BuildStats.compiles)}
    results, launches = {}, {}
    run_2d(ctx, results, launches)
    sys.stdout.flush()
    run_stale_imms(ctx)
    sys.stdout.flush()
    run_3d(ctx, results, launches)
    sys.stdout.flush()
    run_edges(ctx, results)
    sys.stdout.flush()
    run_v1(ctx, results, launches)
    sys.stdout.flush()
    run_cli(ctx, launches)
    sys.stdout.flush()
    effect_rows = run_effects(ctx)

    check(not spills, f"kernel A, B, C, C2, V or D spills registers: "
          f"{spills}")

    # ---- 12. report -------------------------------------------------------------
    size = CASES[0][1]
    name3 = CASES_3D[0][0]
    n3 = len(CASES_3D)
    rows = []
    for name, _, source, replaces in KERNEL_ROWS:
        per_3d = [results[c][name] for c, *_ in CASES_3D if name in results[c]]
        flat_3d = [r for x in per_3d for r in (x if isinstance(x, list)
                                               else [x])]
        if name in KERNELS_V1:
            # no render path calls it: launched by the kernel phase, on the
            # 2D cell's recorded data
            r = results["v1"][name]
            at = f"stress_2d({CASES[0][0]}) {size}^2"
            errs = [r["max_abs_err"]]
            extra = {"launches_per_frame": 0, "device_ms": r["device_ms"],
                     "launched_by": "kernel phase (no render path calls it)"}
            if "ms_cap8" in r:
                extra["ms_cap8"] = r["ms_cap8"]
        elif name in KERNELS_2D:
            # timed at the 2D cell, as before; the 3D launches ride along
            r = results[size][name]
            at = f"stress_2d({CASES[0][0]}) {size}^2"
            errs = [results[s][name]["max_abs_err"] for _, s in CASES]
            r2 = results[CASES[1][1]][name]
            extra = {"ms_2048": r2["ms"], "device_ms": r["device_ms"],
                     "device_ms_2048": r2["device_ms"],
                     "bound_ms_2048": bound(r2)[0]}
            if name == "compact_bitshift_batched":
                extra["share_of_bound"] = {
                    f"stress_2d({nb}) {sz}^2":
                        results[sz][name]["share_of_bound"]
                    for nb, sz in CASES}
                for c, *_ in CASES_3D:
                    extra["share_of_bound"][c] = [
                        x["share_of_bound"] for x in results[c][name]]
                    extra[f"prepass_{c}"] = results[c]["prepass"]
            if name == "interval_shorten":
                extra.update(levels=r["levels"],
                             dep_bound_ms=r["dep_bound_ms"],
                             levels_2048=results[CASES[1][1]][name]["levels"],
                             dep_bound_ms_2048=results[CASES[1][1]][name][
                                 "dep_bound_ms"])
            if flat_3d:
                for c, *_ in CASES_3D:
                    extra[f"ms_{c}"] = [x["ms"] for x in results[c][name]]
                    extra[f"device_ms_{c}"] = [x["device_ms"]
                                               for x in results[c][name]]
                    extra[f"bound_ms_{c}"] = [bound(x)[0]
                                              for x in results[c][name]]
                    if name == "interval_shorten":
                        extra[f"dep_bound_ms_{c}"] = [
                            x["dep_bound_ms"] for x in results[c][name]]
        else:
            r = results[name3][name]
            at = f"{name3} {CASES_3D[0][3]}^3"
            errs = []
            other = CASES_3D[1][0]
            ro = results[other][name]
            extra = {"rows": r["rows"], f"ms_{other}": ro["ms"],
                     "device_ms": r["device_ms"],
                     f"device_ms_{other}": ro["device_ms"],
                     f"plain_ms_{other}": ro["plain_ms"],
                     f"bound_ms_{other}": bound(ro)[0],
                     f"bound_by_{other}": bound(ro)[1],
                     f"rows_{other}": ro["rows"],
                     "launch_shapes": {c: results[c]["shapes"][name]
                                       for c, *_ in CASES_3D}}
        b_ms, b_by = bound(r)
        per_frame = max(launches["2d"][name] // len(CASES),
                        launches["3d"][name] // n3)
        if name in KERNELS_V1:
            per_frame = launches["v1"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": per_frame,
            "launches_2d_path": launches["2d"][name],
            "launches_3d_path": launches["3d"][name],
            "launches_cli": launches["cli"][name],
            "max_abs_err": max(errs + [x["max_abs_err"] for x in flat_3d]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "at": at, **extra,
        })
    print(json.dumps({"effects": effect_rows}))
    sweeps = {f"stress_2d({nb}) {sz}^2": results[sz]["sweep"]
              for nb, sz in CASES}
    sweeps.update({c: results[c]["sweep"] for c, *_ in CASES_3D})
    print(json.dumps({"launch_sweep": sweeps}))
    print(json.dumps({"previous_design_ms": PREVIOUS_DESIGN_MS,
                      "measured_in_this_run": False,
                      "recorded_on": "NVIDIA H100 80GB HBM3, 700.00 W"}))
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
