"""3D frames in a closed loop, as a user's viewer or the upstream table
draws them: each frame the viewer's ``frame3d(tape, mat, size, engine)``
under the configuration's ``view`` (the upstream table's: the identity
with its perspective term), followed by the copy of its depth and normals
to pinned host memory before the next frame starts.

A frame is timed on the host clock from its call until both arrays are on
the host.  ``frame_ms`` is the window over the frames completed in it;
``frame_p95_ms`` the 95th percentile of every frame's time in the window.
Traffic parameters: ``size``, ``engine`` (``interp`` or ``unrolled``),
``warmup_frames`` and ``warmup_seconds`` (warm-up lasts for both),
``check_frames``, ``trace_seconds``.
"""

from __future__ import annotations

import time

import numpy as np

from .. import core, program
from ..counts import watch
from ..reference import render as ref
from . import (checked, memory_peak, per_second, release, sync, view,
               warm_until)


def run(r: core.Run) -> core.Outcome:
    import torch
    from mpr_tpu_torch import viewer

    tr, dev = r.traffic, r.device
    size, engine = int(tr["size"]), tr["engine"]
    e = core.scene(r.config)
    tape, compile_s = program.compile_scene(e)
    pin = dev.type == "cuda"
    mat = view(r.config, 4)
    m = torch.from_numpy(mat).to(dev)
    out = {}

    def frame(dst=None):
        """One frame to the host; returns (its seconds, its buffers)."""
        t = time.perf_counter()
        with r.tracer.range("portbench.frame"):
            depth, normals = viewer.frame3d(tape, m, size, engine)
        if not out:
            out["buf"] = tuple(torch.empty(a.shape, dtype=a.dtype,
                                           pin_memory=pin)
                               for a in (depth, normals))
        dst = out["buf"] if dst is None else dst
        with r.tracer.range("portbench.aux.copy"):
            dst[0].copy_(depth, non_blocking=True)
            dst[1].copy_(normals, non_blocking=True)
            sync(dev)
        return time.perf_counter() - t, dst

    # ---- set-up: build or load the kernels, warm up, judge the rate ----
    times, t_warm = [], time.perf_counter()
    while warm_until(tr, t_warm, len(times)):
        times.append(frame()[0])
    window = r.window_seconds()
    per_frame = float(np.median(times[len(times) // 2:]))
    keep = checked(r.seed, window / per_frame, int(tr["check_frames"]))
    kept = {i: tuple(torch.empty(b.shape, dtype=b.dtype, pin_memory=pin)
                     for b in out["buf"]) for i in keep}
    undo = watch.install(r.watched, r, tape)
    setup_s = r.setup_done()

    # ---- the window: a closed loop ------------------------------------
    lat, stamps = [], []
    with r.tracer:
        t0 = time.perf_counter()
        end, i = t0 + window, 0
        while time.perf_counter() < end:
            s, dst = frame(kept.get(i))
            lat.append(s)
            stamps.append(time.perf_counter())
            i += 1
        sync(dev)
        t_close = time.perf_counter()
    undo()
    frames = i
    kept = {j: b for j, b in kept.items() if j < frames}
    kept.setdefault(frames - 1, dst)
    trace = (r.tracer.reduce(t_close - t0, frames, {}, compile_s)
             if r.trace else None)
    peak = memory_peak(dev)
    release(dev)

    # ---- the comparison -------------------------------------------------
    t_ref = time.perf_counter()
    dgap = ngap = 0.0
    for d, n in kept.values():
        a, _, b = ref.depth_gaps(e, mat, size, d, n, dev)
        dgap, ngap = max(dgap, a), max(ngap, b)
    return core.Outcome(
        attempted=frames, failed=0,
        metrics={"setup_s": setup_s,
                 "frame_ms": 1e3 * (t_close - t0) / frames,
                 "frame_p95_ms": 1e3 * float(np.percentile(lat, 95.0))},
        checks={"depth_gap": dgap, "normal_gap": ngap},
        memory_peak_bytes=peak, trace=trace,
        info={"window_s": t_close - t0, "checked": len(kept),
              "per_second": per_second(stamps, t0, window),
              "reference_s": time.perf_counter() - t_ref})


def control(cell: core.Cell, seed: int, dev) -> dict:
    """The control's readings: the reference in bfloat16 put in the
    program's place, on the cell's frame (every frame of the window is
    the same, so the seed changes nothing)."""
    import torch
    e = core.scene(cell.config)
    size, mat = int(cell.traffic["size"]), view(cell.config, 4)
    d, n = ref.render3d(e, mat, size, dev, torch.bfloat16)
    a, _, b = ref.depth_gaps(e, mat, size, d, n, dev)
    return {"depth_gap": a, "normal_gap": b}
