"""Watchers of a traced window: each wraps one of the port's kernel
entry points, as the harness calls into the layer, with a range of its own
(``portbench.<name>``: the kernels it launches count to it) and keeps the
launch's operations and bytes (``Tracer.count``), computed on the device
under ``portbench.aux.count``, so nothing is read back inside the window.

A per-layer metric supplies the watchers it needs: ``WATCH`` in its file,
a tuple of functions ``watcher(run, tape)`` that wrap an entry point and
return the function that restores it.  It may take one of those below, or
define its own in its file.  The run installs each watcher once, for the
traced window only (``install``).
"""

from __future__ import annotations

from . import (CLAUSE_BYTES, COORD_OPS, RUN_BYTES, VJP_OPS, reaching,
               row_counts, tape_ops)


def _patch(module, attr, make):
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    return lambda: setattr(module, attr, orig)


def pixel_eval_runs(run, tape):
    """Kernel B: a pixel a lane over each ambiguous tile's shortened tape.
    Bytes: the pixel coordinates of the ambiguous tiles, the fill of every
    tile, each row's clauses and run headers."""
    from mpr_tpu_torch.ops import kernels
    full = tape_ops(tape.ops)
    tr = run.tracer

    def make(orig):
        def watched(nmeta, order, status, words, imms, runs_full,
                    branch_ops, tw, ti, runs, gmeta, coords, s_cap,
                    **kw):
            with tr.range("portbench.B"):
                out = orig(nmeta, order, status, words, imms, runs_full,
                           branch_ops, tw, ti, runs, gmeta, coords, s_cap,
                           **kw)
            with tr.range("portbench.aux.count"):
                n_tiles, _, P = coords.shape
                ops, clauses, nruns = row_counts(
                    gmeta, runs, branch_ops, full, tape.length,
                    nmeta[0])
                nbytes = (nmeta[0].long() * 12 * P + n_tiles * P * 4
                          + clauses * CLAUSE_BYTES + nruns * RUN_BYTES)
                tr.count("B", ops * P, nbytes)
            return out
        return watched
    return _patch(kernels, "pixel_eval_runs", make)


def voxel_eval_3d(run, tape):
    """Kernel V: a voxel a lane, the 4096 of each ambiguous 16^3 cell over
    the cell's shortened tape, its coordinates from its index.  Bytes: each
    row's clauses and run headers and its 36 bytes of indices, and the
    values written."""
    from mpr_tpu_torch.ops import kernels3d
    full = tape_ops(tape.ops)
    tr = run.tracer

    def make(orig):
        def watched(nmeta, order, parents, matf, words, imms, runs_full,
                    branch_ops, tw, ti, runs, gmeta, *a, **kw):
            with tr.range("portbench.V"):
                out = orig(nmeta, order, parents, matf, words, imms,
                           runs_full, branch_ops, tw, ti, runs, gmeta, *a,
                           **kw)
            with tr.range("portbench.aux.count"):
                rows = tw.shape[0]
                ops, clauses, nruns = row_counts(
                    gmeta, runs, branch_ops, full, tape.length)
                tr.count("V", (ops + rows * COORD_OPS) * 4096,
                         clauses * CLAUSE_BYTES + nruns * RUN_BYTES
                         + rows * (36 + 4096 * 4))
            return out
        return watched
    return _patch(kernels3d, "voxel_eval_3d", make)


def unrolled_float(run, tape):
    """The unrolled engine's generated float kernel: the whole tape a lane.
    Bytes: three coordinates in and a value out a lane."""
    from mpr_tpu_torch.ops import unrolled_eval
    tr = run.tracer

    def make(orig):
        def watched(ev, x, y, z, *a, **kw):
            with tr.range("portbench.unrolled_float"):
                out = orig(ev, x, y, z, *a, **kw)
            lanes = int(x.numel())
            tr.count("unrolled_float", lanes * tape_ops(ev.tape.ops),
                     lanes * 16)
            return out
        return watched
    return _patch(unrolled_eval, "unrolled_float", make)


def scan_adjoint(run, tape):
    """Kernel K2: a lane's reverse walk, d(sum g f)/d(imms), each clause
    that reaches the result by its rule (the forward values come from K2f,
    timed apart).  Bytes: the coordinates and the upstream gradient in a
    lane, the gradient out a clause."""
    from mpr_tpu_torch.ops import eval_scan
    tr = run.tracer
    live = reaching(tape.ops, tape.outs, tape.lhss, tape.rhss,
                    tape.result_slot)
    per_lane = sum(VJP_OPS.get(int(o), 0) for o, h in zip(tape.ops, live)
                   if h)

    def make(orig):
        def watched(td, x, y, z, g, *a, **kw):
            with tr.range("portbench.K2"):
                out = orig(td, x, y, z, g, *a, **kw)
            lanes = int(x.numel())
            tr.count("K2", lanes * per_lane,
                     lanes * 16 + td.capacity * 4)
            return out
        return watched
    return _patch(eval_scan, "scan_adjoint", make)


def install(watchers, run, tape):
    """Install the watchers; returns a function that removes them."""
    undo = [w(run, tape) for w in watchers]
    return lambda: [u() for u in reversed(undo)]
