"""Every cell run end to end on the CPU at a tiny size (the port's plain
versions in place of its kernels): the result line, the traced run's
metrics, and the entry point's refusals."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench_tiny import ROOT, cells, core, run_tiny  # noqa: F401

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", cells())
def test_untraced_line(name):
    line, rows = run_tiny(name)
    assert list(line) == KEYS
    assert line["correct"] is True and line["attempted"] >= 1
    assert line["failed"] == 0
    cell = core.find_cell(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert [r[0] for r in rows] == list(line["checks"]) == list(cell.limits)
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("name", cells())
def test_traced_line(name):
    line, _ = run_tiny(name, trace=1)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True
    cell = core.find_cell(name)
    names = {m["name"] for m in cell.per_layer}
    assert set(line["metrics"]) <= names
    # on the CPU no device operation runs: the device's metrics stay out
    assert {"compile_ms", } <= set(line["metrics"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(core.HERE / "run.py"), "--workload",
         cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_unknown_cell_no_result():
    out = subprocess.run(
        [sys.executable, str(core.HERE / "run.py"), "--workload",
         "no_such.cell", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_views_are_the_upstream_tables():
    from portbench.drivers import view
    m2 = view(core.find_cell("prospero_2d.frames_ahead_4096").config, 3)
    assert (m2 == np.eye(3)).all()
    m3 = view(core.find_cell("gyroid_3d.frames_interp_1024").config, 4)
    want = np.eye(4, dtype=np.float32)
    want[3, 2] = 0.3
    assert (m3 == want).all()
    with pytest.raises(ValueError):
        view(core.find_cell("gyroid_3d.frames_interp_1024").config, 3)


def test_fit_starts_are_the_seeds_own():
    from portbench.drivers import fit2d
    from portbench.scenes import stress_2d
    e0 = stress_2d.build(30, 2020)
    a = [fit2d.start(e0, 2 ** 33 + 5, j, 0.02) for j in range(3)]
    assert fit2d.start(e0, 2 ** 33 + 5, 1, 0.02) is a[1]
    assert len({id(e) for e in a}) == 3
    assert fit2d.start(e0, 2 ** 33 + 6, 0, 0.02) is not a[0]
    assert all([n.op for n in e.nodes()] == [n.op for n in e0.nodes()]
               for e in a)
