"""The program's spans and counters read from a traced window
(``portbench/spans.py``), on hand-made events: a kernel counts to every
``mpr.*`` span around its launch on the launching thread, the harness's
own work to none, host seconds and counter deltas; and on the card, that
no device operation of a traced window is a copy of a program range.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from portbench_tiny import core
from portbench import spans, trace


def _window():
    """Thread 7 renders: kernel 1 under mpr.3d.normals > mpr.3d.tapes >
    mpr.prepass, kernel 2 under mpr.3d.normals alone, kernel 3 under
    mpr.2d.B but inside the harness's aux range; thread 9 runs a backward
    pass: kernel 4 under mpr.fit.K2 there, while thread 7 sits in
    mpr.fit.apply."""
    cpu = [(0, 1000, "portbench.frame", 0, 7),
           (0, 900, "mpr.3d.normals", 0, 7),
           (100, 500, "mpr.3d.tapes", 0, 7),
           (200, 300, "mpr.prepass", 0, 7),
           (250, 255, "cudaLaunchKernel", 1, 7),
           (600, 610, "cudaLaunchKernel", 2, 7),
           (910, 990, "mpr.2d.B", 0, 7),
           (920, 980, "portbench.aux.count", 0, 7),
           (930, 935, "cudaLaunchKernel", 3, 7),
           (2000, 3000, "mpr.fit.apply", 0, 7),
           (2000, 3000, "mpr.fit.K2", 0, 9),
           (2500, 2505, "cudaLaunchKernel", 4, 9),
           (2100, 2140, "mpr.read", 0, 7),
           (2200, 2220, "mpr.upload", 0, 9)]
    dev = [(300, 310, "void at::native::elementwise_kernel<4>()", 1, 0),
           (700, 740, "void voxel_eval_kernel<4>()", 2, 0),
           (990, 1090, "void at::native::reduce_kernel<512>()", 3, 0),
           (2600, 2900, "void scan_adjoint_kernel<2>()", 4, 0)]
    return spans.Window(dev, cpu)


def test_a_launch_counts_to_every_span_around_it():
    w = _window()
    assert w.device_s(("mpr.prepass",)) == pytest.approx(10e-9)
    assert w.device_s(("mpr.3d.tapes",)) == pytest.approx(10e-9)
    assert w.device_s(("mpr.3d.normals",)) == pytest.approx(50e-9)
    assert w.device_s(("mpr.3d.V",)) == 0
    # the port's kernels and copies left out, as Trace.torch_ms does
    assert w.device_s(("mpr.3d.normals",),
                      spans.torch_kernel) == pytest.approx(10e-9)


def test_a_launch_on_another_thread_counts_to_that_threads_span():
    w = _window()
    assert w.device_s(("mpr.fit.K2",)) == pytest.approx(300e-9)
    assert w.device_s(("mpr.fit.apply",)) == 0


def test_the_harness_work_counts_to_no_span():
    assert _window().device_s(("mpr.2d.B",)) == 0


def test_host_seconds_on_any_thread():
    assert _window().host_s(("mpr.read", "mpr.upload")) == pytest.approx(
        60e-9)


def test_no_device_operation_no_device_time():
    w = spans.Window([], [(0, 10, "mpr.prepass", 0, 7)])
    assert w.device_s(("mpr.prepass",)) is None
    assert w.host_s(("mpr.prepass",)) == pytest.approx(10e-9)


def _run():
    return SimpleNamespace(tracer=SimpleNamespace(prof=None))


def test_counter_deltas_are_taken_at_the_restore():
    from mpr_tpu_torch.utils.trace import count
    restore = spans.program(_run(), None)
    count("host_reads", 3)
    count("uploads", 6)
    restore()
    count("host_reads", 5)
    assert spans.delta(("host_reads",)) == 3
    assert spans.delta(("host_reads", "uploads")) == 9
    t = trace.Trace(window_s=1.0, busy_s=0.5, frames=3)
    for name in ("syncs.ahead", "syncs.frame3d", "syncs.fit"):
        assert core.metric_reader(name).read(t) == pytest.approx(3.0)


def test_the_metrics_read_the_window():
    spans.program(_run(), None)()
    spans._STATE["window"] = _window()
    spans._STATE["tracer"] = SimpleNamespace(prof=object())
    t = trace.Trace(window_s=1.0, busy_s=0.5, frames=2)
    read = {n: core.metric_reader(n).read(t) for n in (
        "prepass_ms.ahead", "prepass_ms.frame3d", "torch_ms.voxel",
        "sync_ms.ahead", "sync_ms.frame3d", "sync_ms.fit")}
    assert read["prepass_ms.ahead"] == pytest.approx(1e3 * 10e-9 / 2)
    assert read["prepass_ms.frame3d"] == read["prepass_ms.ahead"]
    assert read["torch_ms.voxel"] == 0
    for n in ("sync_ms.ahead", "sync_ms.frame3d", "sync_ms.fit"):
        assert read[n] == pytest.approx(1e3 * 60e-9 / 2)


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    """An older checkout has no ``utils/trace.py``: the watcher installs
    nothing and every metric of this module gives None, with no error."""
    monkeypatch.setitem(sys.modules, "mpr_tpu_torch.utils.trace", None)
    restore = spans.program(_run(), None)
    restore()
    t = trace.Trace(window_s=1.0, busy_s=0.5, frames=2)
    for n in ("prepass_ms.ahead", "torch_ms.voxel", "sync_ms.fit",
              "syncs.ahead", "syncs.frame3d"):
        assert core.metric_reader(n).read(t) is None


def test_each_metric_installs_the_one_watcher():
    per = [{"name": n} for n in ("syncs.fit", "sync_ms.fit",
                                 "prepass_ms.ahead", "kernel_ms.B")]
    assert [w.__name__ for w in core.watchers(per)] == ["program"]


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_no_device_operation_is_a_program_range(cuda):
    """A traced window of a 2D frame, a 3D interpreter frame and two scan
    fit steps: the device operations the harness keeps hold no copy of a
    program range (``trace._user_annotation`` drops them), and the
    program's spans take their kernels, K2's on autograd's own thread
    too."""
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch import viewer
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.parallel import sharded
    from mpr_tpu_torch.render import camera, pipeline2d
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.stress_2d(40)),
                            device=cuda)
    eye, z = torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda)
    sphere = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    mat = torch.as_tensor(camera.gui3d_view(), device=cuda)
    step = sharded.make_fit_step(64)
    target = torch.zeros(64, 64, device=cuda)

    def work():
        pipeline2d.render_tile_block(td, eye, z, 512)
        viewer.frame3d(sphere, mat, 256, "interp")
        fit = td
        for _ in range(2):
            _, fit = step(fit, target)
        torch.cuda.synchronize()
    work()
    tr = trace.Tracer(True)
    with tr:
        work()
    t = tr.reduce(1.0, 1)
    names = [n for n, _, _ in t.kernels]
    assert names
    assert not any(n.startswith("mpr.") for n in names)
    w = spans.Window.of(tr.prof)
    for span in ("mpr.2d.A", "mpr.prepass", "mpr.2d.B", "mpr.3d.V",
                 "mpr.3d.normals", "mpr.fit.K2f", "mpr.fit.K2"):
        assert w.device_s((span,)) > 0, span
