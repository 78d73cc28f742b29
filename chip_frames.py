#!/usr/bin/env python3
"""Frame times and kernel A and C device times of the port on one CUDA card.

    python3 chip_frames.py [--root DIR] [--label NAME]

Renders the four cells of ``chip_smoke.py`` (``CASES``: ``stress_2d`` at
1024^2 and 2048^2 through ``pipeline2d.render_tile_block``; ``CASES_3D``:
``gyroid_sphere`` at 1024^3 and ``extruded_stress`` at 512^3 through
``pipeline3d.render3d_rows`` with normals) with the ``mpr_tpu_torch``
package found in DIR (default: this script's directory), so that two
checkouts can be timed in turns on one card.  For each cell it prints the
frame time (CUDA events around a frame, median of 20 frames in 2D and 10
in 3D, after warm-up) and the device time (torch.profiler, mean of 10
launches) of every launch of kernels A and C a frame makes, then one JSON
line with all of it and the card's name and power limit.  It checks
nothing: ``chip_smoke.py`` is the check.  Exits non-zero without a card.
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


def _recorded(tk, frame):
    """Every launch of kernels A and C one frame makes: {name: [(args,
    kwargs)]}."""
    seen = {name: [] for name in KERNELS}
    saved = {name: getattr(tk, name) for name in KERNELS}
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
