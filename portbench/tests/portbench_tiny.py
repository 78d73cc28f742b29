"""Cells of the benchmark cut to sizes the CPU runs in seconds, for the
CPU tests: the same drivers, references and comparisons, the port's plain
versions in place of its kernels."""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import core  # noqa: E402

TINY = {"frames2d": dict(size=128, warmup_frames=2, check_frames=2),
        "frames3d": dict(size=64, warmup_frames=2, check_frames=2),
        "fit2d": dict(size=16, fit_steps=6, read_every=2, starts=2,
                      warmup_frames=3, warmup_seconds=0.0)}
SEED = 2 ** 31 + 11


def cells():
    return [w["name"] for w in core.load_json(
        core.ROOT / "BENCHMARK.json")["workloads"]]


def tiny_cell(name: str) -> core.Cell:
    cell = core.find_cell(name)
    cell.traffic = dict(cell.traffic, **TINY[cell.traffic["driver"]],
                        trace_seconds=0.5)
    args = cell.config.get("args", {})
    if "n_blobs" in args:
        cell.config = dict(cell.config, args=dict(args, n_blobs=60))
    return cell


def run_tiny(name: str, trace: int = 0, seed: int = SEED,
             seconds: float = 0.5):
    """(result line, compared rows) of a tiny run on the CPU."""
    from portbench import run
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)
    return run.execute(args, tiny_cell(name), "cpu", check_device=False)
