"""Fits of a 2D scene's constants to a target fill, as ``cli fit`` runs
them: its scan engine (``parallel/sharded.make_fit_step``: kernel K2f
forward, K2 backward), ``fit_steps`` steps back to back from a start, the
loss read every ``read_every`` steps and at the last, as ``cli fit``
prints it; then the next fit from the next start.

The benchmark makes the starts, ``starts`` of them: the configuration's
scene with every constant scaled by ``1 + perturb * N(0, 1)``, drawn from
the seed for each start; and the target, the reference's fill of the
scene as configured.  It hands both to the program and the reference.
Set-up builds the step and each start's tape, and drives the step from
every start through ``check_steps`` steps (the warm-up).  The window runs
whole fits from the starts in turn, the first from the first start again,
and closes after the step in which its time ran out.  ``fit_step_ms`` is
the window over the steps completed in it.

The comparison holds two fits' first ``check_steps`` steps to the
reference's from the same start and target: set-up's from the first
start, and those of a fit of the window drawn from the seed: each step's
loss, the first gradient as the state shows it, and the change of the
constants over the steps.  A loss read that is not finite fails the run
(``nonfinite_losses``, limit 0).  Further parameters: ``size``, ``lr``,
``trace_seconds``, ``warmup_frames`` (steps) and ``warmup_seconds``
(warm-up lasts for both).
"""

from __future__ import annotations

import math
import time

from .. import core, expr, program
from ..counts import watch
from ..reference import fit as ref
from . import checked, memory_peak, per_second, release, sync, warm_until


def start(e0, seed: int, j: int, share: float):
    """The ``j``-th start of a run: ``e0`` with its constants perturbed by
    a stream of the seed of its own."""
    return expr.perturbed(e0, [int(seed), 3, j], share)


def run(r: core.Run) -> core.Outcome:
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.parallel import sharded

    tr, dev = r.traffic, r.device
    size, lr = int(tr["size"]), float(tr["lr"])
    n_fit, n_check = int(tr["fit_steps"]), int(tr["check_steps"])
    every = int(tr["read_every"])
    e0 = core.scene(r.config)
    target = ref.fill(e0, size, dev)
    exprs, tds, compile_s = [], [], None
    for j in range(int(tr["starts"])):
        exprs.append(start(e0, r.seed, j, float(tr["perturb"])))
        tape, s = program.compile_scene(exprs[-1])
        compile_s = s if compile_s is None else compile_s
        tds.append(TapeData.from_tape(tape, device=dev))
    step = sharded.make_fit_step(size, lr=lr)

    def first_steps(td):
        """``n_check`` steps from ``td``: (the losses as device tensors,
        the states, the first the start)."""
        losses, states = [], [td.imms.detach().clone()]
        for _ in range(n_check):
            loss, td = step(td, target)
            losses.append(loss.detach())
            states.append(td.imms.detach().clone())
        return losses, states

    # ---- set-up: every start's first steps, the first start's kept; then
    # steps from the starts in turn, timed for the window's fit count -----
    t_warm = time.perf_counter()
    setup_fit = first_steps(tds[0])
    for td in tds[1:]:
        first_steps(td)
    sync(dev)
    t_rate, k, steps = time.perf_counter(), 0, 0
    while k == 0 or warm_until(tr, t_warm, steps):
        first_steps(tds[k % len(tds)])
        k, steps = k + 1, steps + n_check
    sync(dev)
    per_fit = n_fit * (time.perf_counter() - t_rate) / steps
    window = r.window_seconds()
    keep = min(checked(r.seed, window / per_fit, 1))
    undo = watch.install(r.watched, r, tape)
    setup_s = r.setup_done()

    # ---- the window: whole fits from the starts in turn ----------------
    bad, n, fits, stamps = 0, 0, 0, []
    kept = kept_last = None
    with r.tracer:
        t0 = time.perf_counter()
        end = t0 + window
        while time.perf_counter() < end:
            j = fits % len(tds)
            td, record = tds[j], ([], [tds[j].imms.detach().clone()])
            for i in range(n_fit):
                with r.tracer.range("portbench.step"):
                    loss, td = step(td, target)
                n += 1
                if i < n_check:
                    record[0].append(loss.detach())
                    record[1].append(td.imms.detach().clone())
                    if i + 1 == n_check:
                        kept_last = (fits, j, record)
                        if fits == keep:
                            kept = kept_last
                if i % every == 0 or i + 1 == n_fit:
                    bad += not math.isfinite(float(loss))
                    stamps.append(time.perf_counter())
                if time.perf_counter() >= end:
                    break
            fits += 1
        sync(dev)
        t_close = time.perf_counter()
    undo()
    kept = kept_last if kept is None else kept
    trace = (r.tracer.reduce(t_close - t0, n, {}, compile_s)
             if r.trace else None)
    peak = memory_peak(dev)
    del td, tds, step
    release(dev)

    # ---- the comparison -------------------------------------------------
    t_ref = time.perf_counter()
    compared = [(None, 0, setup_fit)] + ([kept] if kept is not None else [])
    checks = {}
    for _, j, (losses, states) in compared:
        rl, rs = ref.steps(exprs[j], target, lr, n_check)
        got = ref.gaps([float(v) for v in losses], states, rl, rs, lr)
        for name, v in got.items():
            checks[name] = max(checks.get(name, 0.0), v)
    checks["nonfinite_losses"] = float(bad)
    return core.Outcome(
        attempted=n, failed=bad,
        metrics={"setup_s": setup_s,
                 "fit_step_ms": 1e3 * (t_close - t0) / n},
        checks=checks, memory_peak_bytes=peak, trace=trace,
        info={"window_s": t_close - t0, "fits": fits,
              "compared_fit": None if kept is None else kept[0],
              "setup_losses": [float(v) for v in setup_fit[0]],
              "reads_per_second": per_second(stamps, t0, window),
              "reference_s": time.perf_counter() - t_ref})


def _start(cell: core.Cell, seed: int, dev):
    tr = cell.traffic
    e0 = core.scene(cell.config)
    return (start(e0, seed, 0, float(tr["perturb"])),
            ref.fill(e0, int(tr["size"]), dev), float(tr["lr"]),
            int(tr["check_steps"]))


def control(cell: core.Cell, seed: int, dev) -> dict:
    """The control's readings: the reference's steps computed in bfloat16
    (the parameters and their update kept in float32) in the program's
    place, from the seed's first start."""
    import torch
    e, target, lr, n = _start(cell, seed, dev)
    rl, rs = ref.steps(e, target, lr, n)
    cl, cs = ref.steps(e, target, lr, n, dtype=torch.bfloat16)
    return ref.gaps(cl, cs, rl, rs, lr)


def faults(cell: core.Cell, seed: int, dev) -> dict:
    """The readings of the faults a fit can have, planted in the reference
    put in the program's place: a step that returns its state unchanged;
    half of the batch (the image's first half of rows) left out, the mean
    taken over the rest."""
    e, target, lr, n = _start(cell, seed, dev)
    rl, rs = ref.steps(e, target, lr, n)
    half = ref.steps(e, target, lr, n, rows=target.shape[0] // 2)
    return {"unchanged": ref.gaps([rl[0]] * n, [rs[0]] * (n + 1), rl, rs,
                                  lr),
            "half_batch": ref.gaps(*half, rl, rs, lr)}
