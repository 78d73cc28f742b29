"""The comparison has to fail what it should: the control (the reference in
bfloat16 in the program's place) and each fault a cell can have, planted
in the timed path underneath a tiny CPU run, come out not correct."""

from __future__ import annotations

import pytest
import torch

from portbench_tiny import SEED, core, run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["prospero_2d.frames_ahead_4096",
                                  "gyroid_3d.frames_interp_1024",
                                  "gyroid_3d.frames_unrolled_1024",
                                  "prospero_2d.fit_scan_256"])
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    got = core.driver(cell.traffic).control(cell, SEED, torch.device("cpu"))
    ok, rows = core.judge(got, cell.limits)
    assert not ok, rows


def _frame2d(fault):
    from mpr_tpu_torch.render import pipeline2d
    orig = pipeline2d.render_tile_block

    def broken(*a, **k):
        img, status = orig(*a, **k)
        img = img.clone()
        if fault == "altered":
            img[:64, :64] = ~img[:64, :64]
        else:
            img[img.shape[0] // 2:] = False
        return img, status
    return pipeline2d, "render_tile_block", broken


def _frame3d(fault):
    from mpr_tpu_torch import viewer
    orig = viewer.frame3d

    def broken(*a, **k):
        d, n = orig(*a, **k)
        d, n = d.clone(), n.clone()
        if fault == "altered":
            d[d > 0] += 3
        else:
            d[d.shape[0] // 2:] = 0
            n[n.shape[0] // 2:] = 0
        return d, n
    return viewer, "frame3d", broken


@pytest.mark.parametrize("name,make", [
    ("prospero_2d.frames_ahead_4096", _frame2d),
    ("gyroid_3d.frames_interp_1024", _frame3d),
    ("gyroid_3d.frames_unrolled_1024", _frame3d)])
@pytest.mark.parametrize("fault", ["altered", "half"])
def test_render_fault_is_not_correct(monkeypatch, name, make, fault):
    monkeypatch.setattr(*make(fault))
    line, rows = run_tiny(name)
    assert line["correct"] is False, rows


def test_fit_state_unchanged_is_not_correct(monkeypatch):
    from mpr_tpu_torch.parallel import sharded
    orig = sharded.make_fit_step

    def make(*a, **k):
        step = orig(*a, **k)

        def unchanged(td, target, *b, **c):
            loss, _ = step(td, target, *b, **c)
            return loss, td
        return unchanged
    monkeypatch.setattr(sharded, "make_fit_step", make)
    line, rows = run_tiny("prospero_2d.fit_scan_256")
    assert line["correct"] is False, rows
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_fit_half_batch_is_not_correct(monkeypatch):
    from mpr_tpu_torch.parallel import sharded
    # a mesh of two rows of which only the first is computed, the loss and
    # gradient of the other half left out
    monkeypatch.setattr(sharded, "make_mesh",
                        lambda group=None: sharded.Mesh(None, 1, 0, 2, 1))
    line, rows = run_tiny("prospero_2d.fit_scan_256")
    assert line["correct"] is False, rows


def test_fit_nonfinite_loss_is_not_correct(monkeypatch):
    from mpr_tpu_torch.parallel import sharded
    orig = sharded.make_fit_step

    def make(*a, **k):
        step = orig(*a, **k)
        calls = []

        def diverged(td, target, *b, **c):
            loss, td = step(td, target, *b, **c)
            calls.append(1)
            return (loss * float("nan") if len(calls) > 10 else loss), td
        return diverged
    monkeypatch.setattr(sharded, "make_fit_step", make)
    line, rows = run_tiny("prospero_2d.fit_scan_256")
    assert line["correct"] is False, rows
    assert line["failed"] >= 1
    assert line["checks"]["nonfinite_losses"]["value"] >= 1
