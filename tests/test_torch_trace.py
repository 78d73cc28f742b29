"""PyTorch port: the spans and counters of ``mpr_tpu_torch/utils/trace.py``
on the CPU.

With no profiler running, no ``record_function`` is entered on any hot
path (a spy counts them); under a CPU ``torch.profiler`` each path emits
its ``mpr.*`` spans, nested in stage order; the counters count the reads
back to the host and the uploads each path makes; the build counters
live in the registry and nowhere else.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import mpr_tpu_torch  # noqa: E402
from mpr_tpu_torch import viewer  # noqa: E402
from mpr_tpu_torch.frontend import shapes  # noqa: E402
from mpr_tpu_torch.ops import build, schedule  # noqa: E402
from mpr_tpu_torch.ops.tape_data import TapeData  # noqa: E402
from mpr_tpu_torch.parallel import sharded  # noqa: E402
from mpr_tpu_torch.render import camera, pipeline2d, unrolled  # noqa: E402
from mpr_tpu_torch.utils import trace  # noqa: E402

PACKAGE = Path(mpr_tpu_torch.__file__).parent


def _frame_2d():
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.stress_2d(12)),
                            device="cpu")

    def run():
        pipeline2d.render_tile_block(td, torch.eye(3), torch.tensor(0.0), 256)
    return run


def _frame_3d(engine):
    tape = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    mat = torch.as_tensor(camera.gui3d_view())
    if engine == "unrolled":
        # a renderer of its own: the first frame runs the full ladder
        unrolled._RENDERERS.pop(unrolled.tape_key(tape), None)
    return lambda: viewer.frame3d(tape, mat, 128, engine)


def _fit_step():
    tape = mpr_tpu_torch.compile_tree(shapes.stress_2d(6))
    td = TapeData.from_tape(tape, device="cpu")
    step = sharded.make_fit_step(32)
    target = torch.zeros(32, 32)
    return lambda: step(td, target)


PATHS = {"2d": _frame_2d, "3d_interp": lambda: _frame_3d("interp"),
         "3d_unrolled": lambda: _frame_3d("unrolled"), "fit": _fit_step}

# each path's spans as a tree: a span and, in brackets, the spans inside it
TREES = {
    "2d": ["mpr.upload", "mpr.upload", "mpr.2d.A", "mpr.2d.order",
           "mpr.prepass", "mpr.2d.C", "mpr.2d.B"],
    "3d_interp": [
        "mpr.3d.tapedata(mpr.upload, mpr.upload, mpr.upload)",
        "mpr.upload", "mpr.upload", "mpr.3d.A(mpr.read)",
        "mpr.3d.B(mpr.read)", "mpr.3d.tapes(mpr.prepass, mpr.upload)",
        "mpr.3d.V", "mpr.3d.compose",
        "mpr.3d.normals(mpr.read, mpr.3d.tapes(mpr.prepass, mpr.upload))"],
    "3d_unrolled": ["mpr.u3d.ready", "mpr.u3d.A(mpr.read)",
                    "mpr.u3d.B(mpr.read)", "mpr.u3d.Bp(mpr.read)",
                    "mpr.u3d.voxel", "mpr.u3d.normals(mpr.read)"],
    "fit": ["mpr.fit.inputs(mpr.upload, mpr.upload, mpr.upload)",
            "mpr.fit.apply"],
}
# reads back to the host and uploads a call makes on the CPU device: the
# interpreter's three counts, the unrolled ladder's four compactions; the
# tape's three planes, its metadata, the remap table, kernel C's two
# metadata rows; the fit's view, z and (a host tensor here) target
SYNCS = {"2d": {"host_reads": 0, "uploads": 2},
         "3d_interp": {"host_reads": 3, "uploads": 7},
         "3d_unrolled": {"host_reads": 4, "uploads": 0},
         "fit": {"host_reads": 0, "uploads": 3}}


def _tree(prof):
    """The ``mpr.*`` ranges of a finished profile as nested strings."""
    rows = sorted((e.start_ns(), -e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("mpr."))
    root, stack = [], []
    for a, neg_b, name in rows:
        while stack and stack[-1][0] <= a:
            stack.pop()
        node = (name, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((-neg_b, node[1]))

    def show(node):
        name, kids = node
        return (f"{name}({', '.join(show(k) for k in kids)})" if kids
                else name)
    return [show(n) for n in root]


def _profiled(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return prof


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_record_function_with_the_profiler_off(path, monkeypatch):
    """The gate: with no profiler, no span enters ``record_function``;
    under one, the same spy sees every span."""
    run = PATHS[path]()
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert not torch.autograd._profiler_enabled()
    run()
    assert entered == []
    _profiled(run)
    assert entered and all(n.startswith("mpr.") for n in entered)


def test_the_gate_shares_one_context():
    assert trace.span("mpr.a") is trace.span("mpr.b")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_in_stage_order(path):
    run = PATHS[path]()
    assert _tree(_profiled(run)) == TREES[path]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_span_names(path):
    """Every span is ``mpr.*``: none starts with ``cu`` (a runtime call's
    prefix, which the benchmark's trace reads as a launch) or with
    ``portbench.`` (the benchmark's own ranges)."""
    names = {e.name() for e in
             _profiled(PATHS[path]()).profiler.kineto_results.events()
             if e.name().startswith("mpr.")}
    assert names
    assert not any(n.startswith(("cu", "portbench.")) for n in names)


def test_span_names_in_the_sources():
    """Every span the package's sources open (outside the registry's own
    module) is named by a literal that starts with ``mpr.``."""
    opened = []
    for p in sorted(PACKAGE.rglob("*.py")):
        if p.name != "trace.py":
            opened += re.findall(r"\bspan\(([^)]*)\)", p.read_text())
    assert len(opened) > 20
    assert all(re.fullmatch(r'"mpr\.[A-Za-z0-9_.]+"', a) for a in opened), \
        opened


@pytest.mark.parametrize("path", sorted(SYNCS))
def test_reads_and_uploads_a_call(path):
    run = PATHS[path]()
    before = dict(trace.COUNTS)
    run()
    got = {k: trace.COUNTS[k] - before.get(k, 0) for k in SYNCS[path]}
    assert got == SYNCS[path]


@pytest.mark.parametrize("normals, reads", [(True, 3), (False, 2)])
def test_host_reads_of_an_interpreter_frame(normals, reads):
    """``render3d_rows`` reads three counts with normals, two without."""
    from mpr_tpu_torch.render import pipeline3d
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.two_spheres()),
                            device="cpu")
    mat = torch.as_tensor(camera.gui3d_view())
    before = trace.COUNTS["host_reads"]
    pipeline3d.render3d_rows(td, mat, 128, 0, 2, normals)
    assert trace.COUNTS["host_reads"] - before == reads


def test_skip4_frame_reads_three():
    """The unrolled ladder under ``skip4`` compacts three times: 64^3,
    16^3, the normals' tiles."""
    r = unrolled.UnrolledRenderer(mpr_tpu_torch.compile_tree(
        shapes.two_spheres()))
    mat = torch.as_tensor(camera.gui3d_view())
    before = trace.COUNTS["host_reads"]
    r.frame3d(mat, 128, True, skip4=True)
    assert trace.COUNTS["host_reads"] - before == 3


@pytest.mark.parametrize("what", ["read_int", "read_ids", "read_array",
                                  "upload", "upload_device"])
def test_helpers_count_one_transfer(what):
    key = "uploads" if what.startswith("upload") else "host_reads"
    before = trace.COUNTS[key]
    t = torch.tensor([0, 3, 0, 5])
    if what == "read_int":
        assert trace.read_int(t.sum()) == 8
    elif what == "read_ids":
        assert trace.read_ids(t > 0).tolist() == [1, 3]
    elif what == "read_array":
        assert trace.read_array(t).tolist() == [0, 3, 0, 5]
    elif what == "upload":
        got = trace.upload([1, 2], "cpu", torch.int32)
        assert got.dtype == torch.int32 and got.tolist() == [1, 2]
    else:
        # a tensor already on a device is passed through: no upload
        dev = torch.empty(3, device="meta")
        assert trace.upload(dev, "meta") is dev
        assert trace.COUNTS[key] == before
        return
    assert trace.COUNTS[key] == before + 1


@pytest.mark.parametrize("key", ["builds.schedule", "builds.compile",
                                 "builds.load"])
def test_build_counters_live_in_the_registry(key):
    """The builds are counted in ``COUNTS`` alone: the schedule's function
    attribute and the build statistics' class counters are gone."""
    assert not hasattr(schedule.tape_levels, "builds")
    assert not hasattr(build.BuildStats, "compiles")
    assert not hasattr(build.BuildStats, "loads")
    assert isinstance(trace.COUNTS[key], int)
    if key == "builds.schedule":
        before = trace.COUNTS[key]
        td = TapeData.from_tape(mpr_tpu_torch.compile_tree(
            shapes.stress_2d(6)), device="cpu")
        td.levels()
        td.levels()
        assert trace.COUNTS[key] == before + 1
