"""The trace's reduction on hand-made events: busy time, the harness range
a launch lay in, the idle gaps by what the host was doing, and the
metrics read from them."""

from __future__ import annotations

import pytest

from portbench_tiny import core  # noqa: F401
from portbench import trace
from portbench.counts import bound_s


def test_union_merges_overlaps():
    busy, merged = trace._union([(0, 10), (5, 20), (30, 40), (40, 45),
                                 (50, 50)])
    assert merged == [[0, 20], [30, 45]] and busy == pytest.approx(35e-9)


def test_innermost_range():
    rows = [(0, 100, "portbench.frame", 1, 7),
            (10, 20, "portbench.B", 2, 7),
            (30, 40, "portbench.aux.count", 3, 7),
            (200, 300, "portbench.frame", 4, 8)]
    r = trace._Ranges(rows)
    assert r.innermost(7, 15) == "portbench.B"
    assert r.innermost(7, 25) == "portbench.frame"
    assert r.innermost(7, 150) is None
    assert r.innermost(8, 250) == "portbench.frame"
    assert r.innermost(9, 250) is None


def test_gaps_by_host_activity():
    merged = [[0, 10], [20, 30], [60, 70]]
    cpu = [(0, 100, "portbench.frame", 1, 7),
           (12, 28, "cudaStreamSynchronize", 2, 7),
           (35, 50, "aten::nonzero", 3, 7),
           (0, 5, "elsewhere", 4, 9)]
    got = dict((k, v) for k, v in trace._gaps(merged, cpu))
    assert got == {"portbench.frame/cudaStreamSynchronize": 10e-9,
                   "portbench.frame/aten::nonzero": 30e-9}


def test_metrics_from_a_trace():
    t = trace.Trace(window_s=2.0, busy_s=1.5, frames=10, kernels=[
        ("void pixel_eval_kernel<2, true>(...)", 0.02, "portbench.B"),
        ("void at::native::elementwise_kernel<...>", 0.03, "portbench.frame"),
        ("void at::native::reduce_kernel<...>", 0.01, "portbench.aux.count"),
        ("Memcpy DtoH (Device -> Pinned)", 0.05, "portbench.aux.copy"),
        ("mpr_unrolled_kernel(...)", 0.04, "portbench.unrolled_float"),
        ("mpr_unrolled_kernel(...)", 0.01, "portbench.frame")],
        counts={"B": [(1e9, 1e6)] * 10}, spans={"issue": [0.001, 0.003]},
        compile_s=0.05)
    assert t.idle_pct() == pytest.approx(25.0)
    assert t.kernel_ms("pixel_eval_kernel") == pytest.approx(2.0)
    assert t.kernel_ms("mpr_unrolled_kernel",
                       "portbench.unrolled_float") == pytest.approx(4.0)
    assert t.torch_ms() == pytest.approx(3.0)
    assert t.span_ms("issue") == pytest.approx(2.0)
    assert t.roofline_pct("B", "pixel_eval_kernel") == pytest.approx(
        100 * 10 * bound_s(1e9, 1e6) / 0.02)
    assert t.roofline_pct("V", "voxel_eval_kernel") is None
    assert core.metric_reader("compile_ms").read(t) == pytest.approx(50.0)


def test_port_kernels_are_read_from_the_sources(tmp_path):
    assert {"pixel_eval_kernel", "voxel_eval_kernel", "scan_adjoint_kernel",
            "reduce_partials_kernel", "mpr_unrolled_kernel"} <= \
        trace.port_kernels()
    (tmp_path / "new.cu").write_text(
        "template <int K>\n__global__ void __launch_bounds__(f<K>(), 1)\n"
        "folded_prepass_kernel(int* a) {}\n"
        "#define M \\\n  __global__ void \\\n      macro_kernel(int x)\n")
    (tmp_path / "t.py").write_text("@triton.jit\ndef tri_kernel(x):\n"
                                   "    pass\n")
    assert trace.kernel_names(tmp_path) == {
        "folded_prepass_kernel", "macro_kernel", "tri_kernel"}
    assert trace.is_port_kernel("void scan_adjoint_kernel<4>(Entry const*)")
    assert not trace.is_port_kernel(
        "void at::native::vectorized_elementwise_kernel<4>(int, float)")


def test_each_watcher_installs_once():
    per = [{"name": n} for n in ("kernel_ms.K2", "K2_roofline",
                                 "B_roofline", "idle_pct.fit")]
    assert sorted(w.__name__ for w in core.watchers(per)) == [
        "pixel_eval_runs", "scan_adjoint"]
