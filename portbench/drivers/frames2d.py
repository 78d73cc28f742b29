"""2D fill frames dispatched ahead: the interpreter's frame
(``render/pipeline2d.render_tile_block``) on a ``TapeData`` made once in
set-up, under the configuration's ``view`` (the upstream table's identity
view, uploaded once as ``cli table2d`` does), with at most ``in_flight``
frames issued and not yet on the host.

Each frame's image is copied to pinned host memory; a frame counts once
its image is there.  ``mpix_per_s`` is every pixel of the frames issued in
the window over the window, which closes once the last of them is on the
host.  Traffic parameters: ``size`` (pixels a side), ``in_flight``,
``warmup_frames`` and ``warmup_seconds`` (warm-up lasts for both),
``check_frames`` (frames kept for the comparison, spread over the window,
and the last one), ``trace_seconds``.
"""

from __future__ import annotations

import time

from .. import core, program
from ..counts import watch
from ..reference import render as ref
from . import (checked, memory_peak, per_second, release, sync, view,
               warm_until)


def run(r: core.Run) -> core.Outcome:
    import torch
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d

    tr, dev = r.traffic, r.device
    size, n_slots = int(tr["size"]), int(tr["in_flight"])
    e = core.scene(r.config)
    tape, compile_s = program.compile_scene(e)
    td = TapeData.from_tape(tape, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    pin = dev.type == "cuda"
    host = [torch.empty(size, size, dtype=torch.bool, pin_memory=pin)
            for _ in range(n_slots)]
    mat = view(r.config, 3)
    m = torch.from_numpy(mat).to(dev)
    done = [None] * n_slots
    stamps = []

    def frame(i, out=None):
        """Issue frame ``i``: wait until its slot's last frame is on the
        host, render, copy the image out."""
        k = i % n_slots
        if done[k] is not None:
            done[k].synchronize()
            stamps.append(time.perf_counter())
        t = time.perf_counter()
        with r.tracer.range("portbench.frame"):
            img, _ = pipeline2d.render_tile_block(td, m, z, size)
        r.span("issue", time.perf_counter() - t)
        dst = host[k] if out is None else out
        with r.tracer.range("portbench.aux.copy"):
            dst.copy_(img, non_blocking=True)
            done[k] = (torch.cuda.Event() if pin else None)
            if pin:
                done[k].record()
        return dst

    # ---- set-up: warm up this cell's shapes, judge the frame rate ------
    i, t_warm = 0, time.perf_counter()
    while warm_until(tr, t_warm, i):
        if i == 1:
            sync(dev)
            t_rate = time.perf_counter()
        frame(i)
        i += 1
    sync(dev)
    per_frame = (time.perf_counter() - t_rate) / (i - 1)
    window = r.window_seconds()
    keep = checked(r.seed, window / per_frame, int(tr["check_frames"]))
    kept = {i: torch.empty(size, size, dtype=torch.bool, pin_memory=pin)
            for i in keep}
    r.spans.clear()
    stamps.clear()
    undo = watch.install(r.watched, r, tape)
    setup_s = r.setup_done()

    # ---- the window ---------------------------------------------------
    with r.tracer:
        t0 = time.perf_counter()
        end, i = t0 + window, 0
        while time.perf_counter() < end:
            dst = frame(i, kept.get(i))
            i += 1
        sync(dev)
        t_close = time.perf_counter()
    undo()
    frames = i
    kept = {j: img for j, img in kept.items() if j < frames}
    kept.setdefault(frames - 1, dst)
    trace = (r.tracer.reduce(t_close - t0, frames, r.spans, compile_s)
             if r.trace else None)
    peak = memory_peak(dev)
    del td, host
    release(dev)

    # ---- the comparison -------------------------------------------------
    t_ref = time.perf_counter()
    gap = 0.0
    for img in kept.values():
        g_i, _ = ref.fill_gap(e, mat, size, lambda a, b: img[a:b], dev)
        gap = max(gap, g_i)
    return core.Outcome(
        attempted=frames, failed=0,
        metrics={"setup_s": setup_s,
                 "mpix_per_s": frames * size * size / 1e6 / (t_close - t0)},
        checks={"fill_gap": gap}, memory_peak_bytes=peak, trace=trace,
        info={"window_s": t_close - t0, "checked": len(kept),
              "per_second": per_second(stamps, t0, window),
              "reference_s": time.perf_counter() - t_ref})


def control(cell: core.Cell, seed: int, dev) -> dict:
    """The control's reading: the reference in bfloat16 put in the
    program's place, on the cell's frame (every frame of the window is
    the same, so the seed changes nothing)."""
    import torch
    e = core.scene(cell.config)
    size, mat = int(cell.traffic["size"]), view(cell.config, 3)
    gap, _ = ref.fill_gap(e, mat, size, lambda a, b: ref.field2d(
        e, mat, size, a, b, dev, torch.bfloat16) < 0, dev)
    return {"fill_gap": gap}
