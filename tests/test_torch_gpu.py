"""PyTorch port on the card: each CUDA kernel equals its plain version.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``mpr_tpu``, so it also runs where JAX is not
installed; on the machine with the card run it without the suite's
conftest (which sets up JAX):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Integer outputs (status, codes, tapes, run headers, gmeta) and the fill
must be equal: the kernels and the plain versions run the same float32
operations, and on the card both reach CUDA's own sinf/cosf/expf/logf.
The float outputs of the 3D kernels (field values, gradients) must be
equal too, NaNs in the same places.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops import kernels3d as tk3
from mpr_tpu_torch.ops.tape_data import TapeData
import mpr_tpu_torch.render
from mpr_tpu_torch.render import camera, pipeline2d, pipeline3d
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (COMPACT_CASES, all_ops_clauses,
                              compact_planes, random_boxes, random_trees,
                              unpack_codes)

pytestmark = pytest.mark.gpu

_RANDOM = random_trees(T, mpr_tpu_torch.compile_tree, 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tape(name):
    if name == "all_ops":
        return Tape.from_arrays(**{k: v for k, v in all_ops_clauses().items()})
    if name.startswith("stress"):
        return mpr_tpu_torch.compile_tree(shapes.stress_2d(int(name[6:])))
    return mpr_tpu_torch.compile_tree(_RANDOM[int(name[len("random"):])])


NAMES = [f"random{i}" for i in range(8)] + ["all_ops", "stress40"]


@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_interval_shorten_kernel_matches_plain(cuda, name, widen):
    tape = _tape(name)
    td = TapeData.from_tape(tape, device=cuda)
    boxes = torch.from_numpy(random_boxes(np.random.default_rng(41), 300,
                                          width=1.0)).to(cuda)
    meta = td.meta()
    st, codes = tk.interval_shorten(meta, td.packed, td.imms, boxes,
                                    s_cap=128, widen=widen)
    pst, pcodes = tk.interval_shorten_plain(meta, td.packed, td.imms, boxes,
                                            s_cap=128, widen=widen)
    torch.cuda.synchronize()
    assert torch.equal(st, pst)
    assert np.array_equal(unpack_codes(codes.cpu(), tape.length),
                          unpack_codes(pcodes.cpu(), tape.length))


def _frame_inputs(tape, size, cuda):
    """Run one frame on the card, recording each kernel's inputs."""
    seen = {}
    wrapped = {}
    for name in ("interval_shorten", "compact_bitshift_batched",
                 "pixel_eval_runs"):
        fn = getattr(tk, name)

        def rec(*a, _fn=fn, _name=name, **k):
            seen[_name] = (a, k)
            return _fn(*a, **k)
        wrapped[name] = fn
        setattr(tk, name, rec)
    try:
        td = TapeData.from_tape(tape, device=cuda)
        img, _ = pipeline2d.render_tile_block(
            td, torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda),
            size)
    finally:
        for name, fn in wrapped.items():
            setattr(tk, name, fn)
    return img, seen


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
@pytest.mark.parametrize("size", [256, 1024])
def test_compact_and_pixel_kernels_match_plain(cuda, name, size):
    img, seen = _frame_inputs(_tape(name), size, cuda)
    a, k = seen["compact_bitshift_batched"]
    n_amb = int(a[0][0])
    got = tk.compact_bitshift_batched(*a, **k)
    want = tk.compact_bitshift_batched_plain(*a, **k)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[:n_amb], w[:n_amb])
    assert torch.equal(got[3][:n_amb, :3], want[3][:n_amb, :3])
    a, k = seen["pixel_eval_runs"]
    fill = tk.pixel_eval_runs(*a, **k)
    pfill = tk.pixel_eval_runs_plain(*a, **k)
    assert torch.equal(fill, pfill)


@pytest.mark.parametrize("name", ["circle", "camera", "union", "stress600"])
def test_render2d_cuda_matches_plain_on_card(cuda, name):
    """The whole frame through the kernels equals the frame through the
    plain versions, both on the card."""
    mat = None
    if name == "circle":
        t = shapes.circle(0.8)
    elif name == "camera":
        t = shapes.circle(0.5, 0.2, 0.1)
        mat = np.array([[0.63, -0.14, 0.035], [0.14, 0.63, -0.07], [0, 0, 1]],
                       np.float32)
    elif name == "union":
        t = shapes.union(shapes.circle(0.5, cx=-0.3),
                         shapes.rectangle(0.1, 0.6, -0.2, 0.4))
    else:
        t = shapes.stress_2d(600)
    tape = mpr_tpu_torch.compile_tree(t)
    img = mpr_tpu_torch.render.render2d(tape, mat=mat, size=512)
    saved = (tk.interval_shorten, tk.compact_bitshift_batched,
             tk.pixel_eval_runs)
    tk.interval_shorten = tk.interval_shorten_plain
    tk.compact_bitshift_batched = tk.compact_bitshift_batched_plain
    tk.pixel_eval_runs = tk.pixel_eval_runs_plain
    try:
        want = mpr_tpu_torch.render.render2d(tape, mat=mat, size=512)
    finally:
        (tk.interval_shorten, tk.compact_bitshift_batched,
         tk.pixel_eval_runs) = saved
    assert np.array_equal(img, want), int((img != want).sum())


# ---------------------------------------------------------------------------
# Kernels A and B at their launch shapes, on the four cells' tapes
# ---------------------------------------------------------------------------

def _cell_tree(name):
    if name == "stress600":
        return shapes.stress_2d(600)
    if name == "stress1500":
        return shapes.stress_2d(1500)
    if name == "stress40":
        return shapes.stress_2d(40)
    if name == "gyroid":
        return shapes.intersection(shapes.gyroid(0.4, 0.08),
                                   shapes.sphere(0.85))
    return shapes.extrude_z(shapes.stress_2d(300), -0.4, 0.4)


_RECORDED = {}


def _recorded(name, cuda):
    """Every launch of kernels A, B and C of one small frame of a cell's
    tape (2D at 512^2, or 256^2 for stress40, whose tiles then all overflow
    their cap; 3D at 128^3), with A's plain outputs: (A launches as (args,
    kwargs, plain), B launches as (args, kwargs), C launches as (args,
    kwargs))."""
    if name in _RECORDED:
        return _RECORDED[name]
    seen = {"interval_shorten": [], "pixel_eval_runs": [],
            "compact_bitshift_batched": []}
    saved = {}
    for kname in seen:
        fn = getattr(tk, kname)

        def rec(*a, _fn=fn, _name=kname, **k):
            seen[_name].append((a, k))
            return _fn(*a, **k)
        saved[kname] = fn
        setattr(tk, kname, rec)
    try:
        td = TapeData.from_tape(mpr_tpu_torch.compile_tree(_cell_tree(name)),
                                device=cuda)
        if name in ("gyroid", "extruded"):
            mat = (camera.gui3d_view(0.5, -0.9, 0.3) if name == "gyroid"
                   else camera.gui3d_view(0.7, -1.0, 0.3))
            pipeline3d.render3d_rows(td, torch.as_tensor(mat, device=cuda),
                                     128, 0, 2)
        else:
            pipeline2d.render_tile_block(
                td, torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda),
                256 if name == "stress40" else 512)
    finally:
        for kname, fn in saved.items():
            setattr(tk, kname, fn)
    a_runs = [(a, k, tk.interval_shorten_plain(*a, **k))
              for a, k in seen["interval_shorten"]]
    _RECORDED[name] = (a_runs, seen["pixel_eval_runs"],
                       seen["compact_bitshift_batched"])
    return _RECORDED[name]


def _levels(k):
    lv = k["levels"]
    return lv() if callable(lv) else lv


# Launch shapes forced on kernel A: a block a tile at 32 to 1024 threads
# and a thread a tile, the planes staged or read from global memory.  A shape that does not fit the tape is skipped, with the
# reason.
A_SHAPES = {
    "picked": None,
    "block32": dict(threads=32),
    "block128": dict(threads=128),
    "block1024": dict(threads=1024),
    "block256_staged": dict(threads=256, stage=True),
    "thread64": dict(threads=64, tiles=64, stage=False),
    "thread256_staged": dict(threads=256, tiles=256, stage=True),
}


@pytest.mark.parametrize("shape", sorted(A_SHAPES))
@pytest.mark.parametrize("name", ["stress600", "stress1500", "gyroid",
                                  "extruded"])
def test_interval_shorten_at_every_launch_shape_matches_plain(cuda, name,
                                                              shape):
    from mpr_tpu_torch.ops import launch as ln
    a_runs = _recorded(name, cuda)[0]
    assert len(a_runs) == (3 if name in ("gyroid", "extruded") else 1)
    for a, k, (pst, pcodes) in a_runs:
        lv, lanes = _levels(k), a[3].shape[1]
        launch = None
        if A_SHAPES[shape] is not None:
            try:
                launch = ln.interval_launch(lv.widths, lanes,
                                            **A_SHAPES[shape])
            except ValueError as e:
                pytest.skip(f"{shape} does not fit a tape of {lv.length} "
                            f"clauses: {e}")
        st, codes = tk.interval_shorten(*a, **{**k, "launch": launch})
        torch.cuda.synchronize()
        amb = pst == tk.ST_AMBIG
        assert torch.equal(st, pst)
        assert torch.equal(codes[amb], pcodes[amb])
        # the codes of every ambiguous lane, zero past the tape
        assert not codes[amb][:, -(-lv.length // 8):].any()


@pytest.mark.parametrize("shape", ["picked", "block128",
                                   "block256_staged", "thread64",
                                   "thread256_staged"])
@pytest.mark.parametrize("name", ["stress40", "random2"])
def test_interval_shorten_follows_new_imms_under_an_old_schedule(cuda, name,
                                                                 shape):
    """A schedule built before the tape's immediates changed (a fit step or
    a slider keeps the TapeData): kernel A must read each clause's
    immediate from its imms argument, whether the schedule's planes are
    staged in shared memory or not, and give the plain version's status
    and codes on the new imms.  A shape that does not fit the tape is
    skipped, with the reason."""
    from mpr_tpu_torch.ops import launch as ln
    td = TapeData.from_tape(_tape(name), device=cuda)
    old = td.levels()                       # built with the old imms
    rng = np.random.default_rng(56)
    imms = td.imms.clone()
    imms[:td.length] += torch.from_numpy(
        rng.normal(0.0, 0.25, td.length).astype(np.float32)).to(cuda)
    boxes = torch.from_numpy(random_boxes(np.random.default_rng(57), 300,
                                          width=0.5)).to(cuda)
    launch = None
    if A_SHAPES[shape] is not None:
        try:
            launch = ln.interval_launch(old.widths, 300, **A_SHAPES[shape])
        except ValueError as e:
            pytest.skip(f"{shape} does not fit a tape of {old.length} "
                        f"clauses: {e}")
    meta = td.meta()
    st, codes = tk.interval_shorten(meta, td.packed, imms, boxes, s_cap=128,
                                    levels=old, launch=launch)
    pst, pcodes = tk.interval_shorten_plain(meta, td.packed, imms, boxes,
                                            s_cap=128)
    torch.cuda.synchronize()
    assert torch.equal(st, pst)
    assert torch.equal(codes[pst == tk.ST_AMBIG], pcodes[pst == tk.ST_AMBIG])
    # the new imms change the outcome, so the case can tell them apart
    ost, ocodes = tk.interval_shorten_plain(meta, td.packed, td.imms, boxes,
                                            s_cap=128)
    assert not (torch.equal(ost, pst) and torch.equal(ocodes, pcodes))


# Launch shapes forced on kernels C and C2: a warp a row at 1, 4, 8 and 32
# rows a block, a block a row at 128, 256 and 1024 threads.  A shape that
# does not fit the plane is skipped, with the reason.
C_SHAPES = {
    "picked": None,
    "warp_rows1": dict(warp=True, threads=32),
    "warp_rows4": dict(warp=True, threads=128),
    "warp_rows8": dict(warp=True, threads=256),
    "warp_rows32": dict(warp=True, threads=1024),
    "block128": dict(warp=False, threads=128),
    "block256": dict(warp=False, threads=256),
    "block1024": dict(warp=False, threads=1024),
}


def _c_launch(shape, tcap, cap, n_rows):
    from mpr_tpu_torch.ops import launch as ln
    if C_SHAPES[shape] is None:
        return None
    try:
        return ln.compact_launch(tcap, cap, n_rows, **C_SHAPES[shape])
    except ValueError as e:
        pytest.skip(f"{shape} does not fit a {tcap}-clause plane at cap "
                    f"{cap}: {e}")


def _hand_compact(name, cuda):
    """A case of COMPACT_CASES on the card: (cmeta, lens, wrw, irw, rem),
    cap."""
    kept, tcap, cap, n_rows = COMPACT_CASES[name]
    planes = compact_planes(np.random.default_rng(61), kept, tcap)
    cmeta = torch.tensor([n_rows, cap, cap, 0, 0, 0, 0, 0],
                         dtype=torch.int32, device=cuda)
    return (cmeta, *(torch.from_numpy(p).to(cuda) for p in planes)), cap


def _assert_compact_same(got, want, n):
    """tw, ti and the run headers over the full cap, zeros included, and
    gmeta's [len, n_runs, overflow], on the rows below cmeta[0]."""
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[:n], w[:n])
    assert torch.equal(got[3][:n, :3], want[3][:n, :3])


@pytest.mark.parametrize("shape", sorted(C_SHAPES))
@pytest.mark.parametrize("name", ["stress600", "stress1500", "stress40",
                                  "gyroid", "extruded"]
                         + sorted(COMPACT_CASES))
def test_compact_at_every_launch_shape_matches_plain(cuda, name, shape):
    """Kernel C at each forced shape against its plain version: on every
    launch a small frame of a cell's tape records, and on the hand-made
    rows (over cap, empty, moves past 8192, rows past cmeta[0], one row, a
    cap not a multiple of 4)."""
    if name in COMPACT_CASES:
        a, cap = _hand_compact(name, cuda)
        runs = [(a, {"cap": cap})]
    else:
        runs = _recorded(name, cuda)[2]
        assert len(runs) == (2 if name in ("gyroid", "extruded") else 1)
    for a, k in runs:
        G, R, W = a[2].shape
        launch = _c_launch(shape, R * W, k["cap"], G)
        n = int(a[0][0])
        before = tk.compact_bitshift_batched.launches
        got = tk.compact_bitshift_batched(*a, **k, launch=launch)
        assert tk.compact_bitshift_batched.launches == before + 1
        want = tk.compact_bitshift_batched_plain(*a, **k)
        torch.cuda.synchronize()
        _assert_compact_same(got, want, n)


@pytest.mark.parametrize("shape", sorted(C_SHAPES))
@pytest.mark.parametrize("name", sorted(COMPACT_CASES))
def test_compact_order_at_every_launch_shape_matches_plain(cuda, name,
                                                           shape):
    """Kernel C2 on the hand-made rows, the planes in another tile order:
    row g compacts tile order[g]; a bad order entry leaves its row alone
    (the rows with good entries are compared)."""
    (cmeta, lens, wrw, irw, rem), cap = _hand_compact(name, cuda)
    G = wrw.shape[0]
    order = np.random.default_rng(62).permutation(G).astype(np.int32)
    inv = torch.from_numpy(order.argsort()).to(cuda)
    planes = [p[inv].contiguous() for p in (lens, wrw, irw, rem)]
    order_t = torch.from_numpy(order).to(cuda)
    good = torch.ones(G, dtype=torch.bool, device=cuda)
    if G > 2:
        order_t[1] = -1
        good[1] = False
    R, W = wrw.shape[1:]
    launch = _c_launch(shape, R * W, cap, G)
    got = tk.compact_bitshift(cmeta, order_t, *planes, G, cap, cap,
                              launch=launch)
    want = tk.compact_bitshift_batched_plain(cmeta, lens, wrw, irw, rem, cap)
    torch.cuda.synchronize()
    n = int(cmeta[0])
    keep = good[:n]
    _assert_compact_same([x[:n][keep] for x in got],
                         [x[:n][keep] for x in want], int(keep.sum()))


# Launch shapes forced on kernel B: each home of the register file, K = 1,
# 2, 4, P = 1 and 2, the full tape of an overflowed tile staged in shared
# memory or read from global memory.
B_SHAPES = {
    "picked": {},
    "local_k1": dict(home="local", k=1),
    "local_k4": dict(home="local", k=4),
    "local_p1": dict(home="local", k=2, parts=1),
    "local_p2": dict(home="local", k=2, parts=2),
    "local_staged": dict(home="local", k=2, stage_full=True),
    "local_global": dict(home="local", k=2, stage_full=False),
    "shared_k1": dict(home="shared", k=1),
    "shared_k4": dict(home="shared", k=4),
}


@pytest.mark.parametrize("shape", sorted(B_SHAPES))
@pytest.mark.parametrize("name", ["stress600", "stress1500", "stress40"])
def test_pixel_eval_runs_at_every_launch_shape_matches_plain(cuda, name,
                                                             shape):
    from mpr_tpu_torch.ops import launch as ln
    (a, k), = _recorded(name, cuda)[1]
    n = int(a[0][0])
    over = a[10][:n, 2] != 0
    # stress40's tiles at 256^2 all overflow their cap; at 512^2 some of
    # the others' tiles do, and some do not
    assert bool(over.all()) if name == "stress40" else (
        bool(over.any()) and not bool(over.all()))
    try:
        launch = ln.pixel_launch(k["s_cap"], a[7].shape[1], a[1].shape[0],
                                 a[3].shape[0], **B_SHAPES[shape])
    except ValueError as e:
        pytest.skip(f"{shape} does not fit s_cap {k['s_cap']}: {e}")
    got = tk.pixel_eval_runs(*a, **k, launch=launch)
    want = tk.pixel_eval_runs_plain(*a, **k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_a_second_frame_builds_no_schedule(cuda):
    """The schedule is built at the first launch of kernel A on a tape and
    kept on its TapeData: a second frame, 2D or 3D, builds none, and a 3D
    frame's three launches share one."""
    from mpr_tpu_torch.utils.trace import COUNTS
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.stress_2d(40)),
                            device=cuda)
    eye, z = torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda)
    before = COUNTS["builds.schedule"]
    pipeline2d.render_tile_block(td, eye, z, 256)
    assert COUNTS["builds.schedule"] == before + 1
    pipeline2d.render_tile_block(td, eye, z, 512)
    assert COUNTS["builds.schedule"] == before + 1
    td3 = TapeData.from_tape(mpr_tpu_torch.compile_tree(
        shapes.two_spheres()), device=cuda)
    mat = torch.as_tensor(camera.gui3d_view(), device=cuda)
    a_before = tk.interval_shorten.launches
    pipeline3d.render3d_rows(td3, mat, 128, 0, 2)
    assert tk.interval_shorten.launches == a_before + 3
    assert COUNTS["builds.schedule"] == before + 2
    pipeline3d.render3d_rows(td3, mat, 128, 0, 2)
    assert COUNTS["builds.schedule"] == before + 2


_TRAP_B = """
import sys
import torch
sys.path.insert(0, {root!r})
import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import pipeline2d
seen = {{}}
fn = tk.pixel_eval_runs
def rec(*a, **k):
    seen["x"] = (a, k)
    return fn(*a, **k)
tk.pixel_eval_runs = rec
td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.stress_2d(40)),
                        device="cuda")
pipeline2d.render_tile_block(td, torch.eye(3, device="cuda"),
                             torch.tensor(0.0, device="cuda"), 256)
torch.cuda.synchronize()
a, k = seen["x"]
a = list(a)
a[0] = a[0].clone()
a[0][1] = k["s_cap"] + 8          # more slots than the file holds
fn(*a, **k)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised at synchronize:", e)
    sys.exit(3)
print("no error")
"""


def test_pixel_eval_runs_traps_on_more_slots_than_s_cap(cuda):
    """nmeta[1] over s_cap: kernel B traps rather than index past its
    register file (in a subprocess: a trap leaves the context unusable)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _TRAP_B.format(root=root)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 3, (r.stdout, r.stderr[-2000:])
    assert "raised at synchronize" in r.stdout


# ---------------------------------------------------------------------------
# The 3D path: kernels V and D, and the frame
# ---------------------------------------------------------------------------

def _scene3d(name):
    if name == "two_spheres":
        return shapes.two_spheres(), camera.gui3d_view()
    if name == "gyroid":
        return (shapes.intersection(shapes.gyroid(0.4, 0.08),
                                    shapes.sphere(0.85)),
                camera.gui3d_view(0.5, -0.9, 0.3))
    if name == "extruded_stress":
        return (shapes.extrude_z(shapes.stress_2d(40), -0.4, 0.4),
                camera.gui3d_view())
    if name == "all_ops":
        return None, camera.bench3d_view()
    raise KeyError(name)


def _tape3d(name):
    tree, mat = _scene3d(name)
    if tree is None:
        return _tape(name), mat
    return mpr_tpu_torch.compile_tree(tree), mat


def _frame3d_inputs(tape, mat, size, cuda, **kw):
    """One 3D frame on the card, recording the inputs of V and D."""
    seen = {}
    saved = {}
    for name in ("voxel_eval_3d", "deriv_eval_3d"):
        fn = getattr(tk3, name)

        def rec(*a, _fn=fn, _name=name, **k):
            seen[_name] = (a, k)
            return _fn(*a, **k)
        saved[name] = fn
        setattr(tk3, name, rec)
    try:
        td = TapeData.from_tape(tape, device=cuda)
        out = pipeline3d.render3d_rows(td, torch.as_tensor(mat, device=cuda),
                                       size, **kw)
    finally:
        for name, fn in saved.items():
            setattr(tk3, name, fn)
    return out, seen


def _same(a, b):
    return torch.equal(torch.nan_to_num(a, nan=12345.0),
                       torch.nan_to_num(b, nan=12345.0))


# Launch shapes forced on kernels V and D: each home of the register files
# (shared, local, and for D split between the two), K = 1 and 4, P = 1 and
# the most, and D's overflowed rows' full tape staged in shared memory and
# read from global memory.  V takes the home and K of a shape (it has one
# block a cell and no staging).  A shape that does not fit the tape's slots
# is skipped, with the reason.
SHAPES = {
    "picked": {},
    "shared_k1": dict(home="shared", k=1),
    "shared_k4": dict(home="shared", k=4),
    "local_k1_p1": dict(home="local", k=1, parts=1),
    "local_k4_pmost": dict(home="local", k=4, parts="most"),
    "split_k1": dict(home="split", k=1, shared_warps=1),
    "split_k4": dict(home="split", k=4),
    "global_tape": dict(home="local", k=1, stage_full=False),
}
V_SHAPES = ("picked", "shared_k1", "shared_k4", "local_k1_p1",
            "local_k4_pmost")
KERNEL_SHAPES = ([("voxel_eval_3d", x) for x in V_SHAPES]
                 + [("deriv_eval_3d", x) for x in sorted(SHAPES)])


def _launch(kernel, shape, a, k):
    """The forced shape ``shape`` for a recorded launch (args, kwargs) of
    kernel V or D, None for the picked one; skips the test where the shape
    does not fit."""
    force = dict(SHAPES[shape])
    if not force:
        return None
    tw = a[8] if kernel == "voxel_eval_3d" else a[7]
    gcap, cap = tw.shape
    s_cap = k["s_cap"]
    try:
        if kernel == "voxel_eval_3d":
            return tk3.voxel_launch(s_cap, cap, home=force["home"],
                                    k=force["k"])
        tcap = a[3].shape[0]
        parts = force.pop("parts", None)
        launch = tk3.deriv_launch(s_cap, cap, gcap, tcap, **force,
                                  parts=None if parts == "most" else parts)
        if parts == "most":
            launch = tk3.deriv_launch(
                s_cap, cap, gcap, tcap, **force,
                parts=4096 // (launch.threads * launch.k))
        return launch
    except ValueError as e:
        pytest.skip(f"{shape} does not fit {kernel} at s_cap {s_cap}, cap "
                    f"{cap}: {e}")


@pytest.mark.parametrize("kernel,shape", KERNEL_SHAPES)
@pytest.mark.parametrize("name", ["two_spheres", "gyroid", "extruded_stress",
                                  "all_ops"])
@pytest.mark.parametrize("slab", [(128, 0, 2), (256, 1, 2)])
def test_voxel_and_deriv_kernels_match_plain(cuda, name, slab, kernel,
                                             shape):
    size, row0, n_rows = slab
    tape, mat = _tape3d(name)
    (_, _, counts), seen = _frame3d_inputs(tape, mat, size, cuda, row0=row0,
                                           n_rows=n_rows)
    assert counts["n_amb1"] > 0 and counts["n_act"] > 0
    a, k = seen[kernel]
    got = getattr(tk3, kernel)(*a, **k, launch=_launch(kernel, shape, a, k))
    want = getattr(tk3, kernel + "_plain")(*a, **k)
    torch.cuda.synchronize()
    n = counts["n_amb1" if kernel == "voxel_eval_3d" else "n_act"]
    assert _same(got[:n], want[:n])


@pytest.mark.parametrize("kernel,shape", KERNEL_SHAPES)
def test_3d_kernels_with_overflowed_rows_match_plain(cuda, kernel, shape):
    """A per-row capacity of 128 clauses: the cells keep 43 to 286 of the
    373 clauses, so some overflow it and some do not; the columns keep
    nearly all, so every one overflows.  Overflowed rows run the full tape,
    from global memory (V, and D's ``global_tape`` shape) or staged in
    shared memory (D's other shapes)."""
    from mpr_tpu_torch import config
    tape, mat = _tape3d("extruded_stress")
    with config.override(cap_div=4):
        (_, _, counts), seen = _frame3d_inputs(tape, mat, 128, cuda, row0=0,
                                               n_rows=2)
    n = counts["n_amb1" if kernel == "voxel_eval_3d" else "n_act"]
    a, k = seen[kernel]
    gmeta = a[11] if kernel == "voxel_eval_3d" else a[10]
    over = gmeta[:n, 2] != 0
    assert over.any()
    if kernel == "voxel_eval_3d":
        assert not over.all()
    launch = _launch(kernel, shape, a, k)
    if shape == "global_tape":
        assert not launch.stage_full
    got = getattr(tk3, kernel)(*a, **k, launch=launch)
    want = getattr(tk3, kernel + "_plain")(*a, **k)
    assert _same(got[:n], want[:n])


_TRAP = """
import sys
import torch
sys.path.insert(0, {root!r})
import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.ops import kernels3d as tk3
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import camera, pipeline3d
seen = {{}}
fn = getattr(tk3, {kernel!r})
def rec(*a, **k):
    seen["x"] = (a, k)
    return fn(*a, **k)
setattr(tk3, {kernel!r}, rec)
td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.two_spheres()),
                        device="cuda")
pipeline3d.render3d_rows(td, torch.as_tensor(camera.gui3d_view(),
                                             device="cuda"), 128, 0, 2)
torch.cuda.synchronize()
a, k = seen["x"]
a = list(a)
a[0] = a[0].clone()
a[0][1] = k["s_cap"] + 8          # more slots than the file holds
fn(*a, **k)
try:
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised at synchronize:", e)
    sys.exit(3)
print("no error")
"""


@pytest.mark.parametrize("kernel", ["voxel_eval_3d", "deriv_eval_3d"])
def test_a_tape_with_more_slots_than_s_cap_traps(cuda, kernel):
    """nmeta[1] over s_cap: the kernel traps rather than index past its
    register file, and the fault surfaces at torch.cuda.synchronize().  In
    a subprocess, because a trap leaves the CUDA context unusable."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c",
                        _TRAP.format(root=root, kernel=kernel)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 3, (r.stdout, r.stderr[-2000:])
    assert "raised at synchronize" in r.stdout


def test_3d_wrappers_raise_on_bad_inputs(cuda):
    tape, mat = _tape3d("two_spheres")
    _, seen = _frame3d_inputs(tape, mat, 128, cuda, row0=0, n_rows=2)
    a, k = seen["voxel_eval_3d"]
    bad = list(a)
    bad[3] = a[3].double()                        # matf dtype
    with pytest.raises(TypeError):
        tk3.voxel_eval_3d(*bad, **k)
    bad = list(a)
    bad[9] = a[9][:, :-1]                         # ti shape
    with pytest.raises(ValueError):
        tk3.voxel_eval_3d(*bad, **k)
    with pytest.raises(ValueError):
        tk3.voxel_eval_3d(*a, **{**k, "s_cap": 512})
    bad = list(a)
    bad[1] = a[1].cpu()                           # order on another device
    with pytest.raises(ValueError):
        tk3.voxel_eval_3d(*bad, **k)
    a, k = seen["deriv_eval_3d"]
    bad = list(a)
    bad[11] = a[11][:, :-1].contiguous()          # depth_blocks shape
    with pytest.raises(ValueError):
        tk3.deriv_eval_3d(*bad, **k)
    bad = list(a)
    bad[11] = a[11].float()                       # depth_blocks dtype
    with pytest.raises(TypeError):
        tk3.deriv_eval_3d(*bad, **k)


@pytest.mark.parametrize("name", ["two_spheres", "gyroid", "extruded_stress"])
@pytest.mark.parametrize("size", [128, 256])
def test_render3d_matches_brute_on_card(cuda, name, size):
    tape, mat = _tape3d(name)
    before = tk3.deriv_eval_3d.launches
    depth, normals = mpr_tpu_torch.render.render3d(tape, mat=mat, size=size)
    assert tk3.deriv_eval_3d.launches == before + 1
    want = mpr_tpu_torch.render.render3d_brute(tape, mat=mat, size=size)
    assert depth.dtype == np.int32 and np.array_equal(depth, want)
    m = depth > 0
    assert m.any() and not m.all()
    assert np.allclose(np.linalg.norm(normals[m], axis=-1), 1.0, atol=1e-3)
    assert not normals[~m].any()
    d2, none = mpr_tpu_torch.render.render3d(tape, mat=mat, size=size,
                                             with_normals=False)
    assert none is None and np.array_equal(d2, depth)
    assert tk3.deriv_eval_3d.launches == before + 1


# ---------------------------------------------------------------------------
# Kernels B1, C1, C2 (the earlier versions of B and C), on a frame's data
# ---------------------------------------------------------------------------

def _v1_inputs(tape, size, cuda):
    """The 2D frame's kernel A outputs, order and coordinates on the card,
    as the chain A -> C1 -> B1 (and the prepass -> C2) takes them."""
    from mpr_tpu_torch.render.pipeline2d import (TILE, _pixel_coords_2d,
                                                 _shorten_prepass,
                                                 _tile_boxes_2d)
    td = TapeData.from_tape(tape, device=cuda)
    n_side = size // TILE
    eye = torch.eye(3, device=cuda)
    z = torch.tensor(0.0, device=cuda)
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    status, codes = tk.interval_shorten(td.meta(), td.packed, td.imms,
                                        _tile_boxes_2d(n_side, eye, z),
                                        s_cap=s_cap)
    amb = status == tk.ST_AMBIG
    order = torch.argsort((~amb).to(torch.int32), stable=True).to(torch.int32)
    _, remap = tk.build_remap(td.ops_present)
    remap_t = torch.as_tensor(remap, device=cuda)
    planes = _shorten_prepass(codes, td.packed, td.imms, td.length, remap_t)
    return dict(td=td, status=status, codes=codes, order=order,
                n_amb=int(amb.sum()), remap=remap_t, s_cap=s_cap,
                planes=planes, coords=_pixel_coords_2d(n_side, eye, z))


def _cmeta(cuda, *vals):
    m = torch.zeros(8, dtype=torch.int32, device=cuda)
    m[:len(vals)] = torch.tensor(vals, dtype=torch.int32)
    return m


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
@pytest.mark.parametrize("cap_div", [1, 8])
def test_compact_runs_kernel_matches_plain(cuda, name, cap_div):
    f = _v1_inputs(_tape(name), 512, cuda)
    td, n = f["td"], f["n_amb"]
    cap = td.capacity // cap_div
    gcap = f["order"].shape[0]
    args = (_cmeta(cuda, n, td.capacity // 8, cap), td.packed, td.imms,
            f["order"], f["remap"], f["codes"], gcap, cap, cap)
    before = tk.compact_runs.launches
    got = tk.compact_runs(*args)
    assert tk.compact_runs.launches == before + 1
    want = tk.compact_runs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[3][:n, :3], want[3][:n, :3])
    gm = got[3][:n].cpu().numpy()
    for g in range(n):
        ln, nr = gm[g, 0], min(gm[g, 1], cap)
        assert torch.equal(got[0][g, :ln], want[0][g, :ln])
        assert torch.equal(got[1][g, :ln].view(torch.int32),
                           want[1][g, :ln].view(torch.int32))
        assert torch.equal(got[2][g, :nr], want[2][g, :nr])


def _b1_args(f, cuda, pixels=None):
    """B1's inputs from C1's tapes of the frame ``f`` (``_v1_inputs``) at
    cap = the tape's bucket, scattered back to TILE order as B1 reads them;
    ``pixels``: the first that many pixels of each tile."""
    td, n = f["td"], f["n_amb"]
    cap = td.capacity
    gcap = f["order"].shape[0]
    tw, ti, _, gmeta = tk.compact_runs(
        _cmeta(cuda, n, cap // 8, cap), td.packed, td.imms, f["order"],
        f["remap"], f["codes"], gcap, cap, cap)
    tiles = f["order"][:n].long()
    words = torch.zeros_like(tw)
    imms = torch.zeros_like(ti)
    lens = torch.zeros(gcap, dtype=torch.int32, device=cuda)
    words[tiles], imms[tiles], lens[tiles] = tw[:n], ti[:n], gmeta[:n, 0]
    nmeta = td.meta()
    nmeta[0] = n
    coords = f["coords"]
    if pixels is not None:
        coords = coords[:, :, :pixels].contiguous()
    return (nmeta, f["order"], lens, words, imms, coords)


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2",
                                  "random0"])
def test_pixel_eval_kernel_matches_plain(cuda, name):
    f = _v1_inputs(_tape(name), 512, cuda)
    n = f["n_amb"]
    args = _b1_args(f, cuda)
    before = tk.pixel_eval.launches
    got = tk.pixel_eval(*args, s_cap=f["s_cap"])
    assert tk.pixel_eval.launches == before + 1
    want = tk.pixel_eval_plain(*args, s_cap=f["s_cap"])
    torch.cuda.synchronize()
    assert _same(got[:n], want[:n])
    # and the chain gives the frame's fill on its ambiguous tiles
    img, _ = pipeline2d.render_tile_block(
        f["td"], torch.eye(3, device=cuda), torch.tensor(0.0, device=cuda),
        512)
    n_side = 512 // 64
    fill = img.reshape(n_side, 64, n_side, 64).permute(0, 2, 1, 3).reshape(
        n_side * n_side, 4096)
    assert torch.equal(got[:n] < 0, fill[f["order"][:n].long()])


# Forced launch shapes of B1 (launch.pixel_v1_launch's keyword arguments):
# each home of the register file at K = 1, 2 and 4, P = 1 and more, and no
# tape staged (every tape read from global memory).
B1_SHAPES = ([dict(home="local", k=kk) for kk in (1, 2, 4)]
             + [dict(home="shared", k=kk) for kk in (1, 2, 4)]
             + [dict(home="local", k=2, parts=p) for p in (1, 4, 32)]
             + [dict(home="local", k=2, threads=128, parts=16)]
             + [dict(stage=False), dict(home="shared", k=4, stage=False)])


def _b1_forced(args, s_cap, n, kws):
    """B1 at each forced shape of ``kws`` on ``args``, bit for bit against
    the plain version on rows below ``n``; returns the shapes run."""
    from mpr_tpu_torch.ops import launch as ln
    want = tk.pixel_eval_plain(*args, s_cap=s_cap)
    cap, gcap, P = args[3].shape[1], args[1].shape[0], args[5].shape[2]
    ran = []
    for kw in kws:
        launch = ln.pixel_v1_launch(s_cap, cap, gcap, P, **kw)
        got = tk.pixel_eval(*args, s_cap=s_cap, launch=launch)
        torch.cuda.synchronize()
        assert _same(got[:n], want[:n]), (kw, launch)
        ran.append(launch)
    return ran


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
def test_pixel_eval_forced_shapes_match_plain(cuda, name):
    f = _v1_inputs(_tape(name), 512, cuda)
    ran = _b1_forced(_b1_args(f, cuda), f["s_cap"], f["n_amb"], B1_SHAPES)
    assert {(sh.home, sh.k) for sh in ran} == {
        (h, kk) for h in ("shared", "local") for kk in (1, 2, 4)}
    assert {sh.blocks_per_row for sh in ran} >= {1, 4, 16, 32}
    assert min(sh.staged for sh in ran) == 0


@pytest.mark.parametrize("pixels", [1000, 999, 33])
def test_pixel_eval_ragged_pixels_match_plain(cuda, pixels):
    """P that is no multiple of a chunk (or of K): the last chunk of a row
    is masked, and coordinates come in 4-byte loads where P % K != 0."""
    f = _v1_inputs(_tape("stress40"), 512, cuda)
    args = _b1_args(f, cuda, pixels)
    _b1_forced(args, f["s_cap"], f["n_amb"],
               [{}, dict(home="local", k=4), dict(home="shared", k=4),
                dict(home="local", k=1, parts=4), dict(stage=False)])
    # coordinates and values off 16-byte alignment: 4-byte accesses
    c = args[5]
    off = torch.empty(c.numel() + 1, dtype=torch.float32, device=cuda)
    off[1:] = c.reshape(-1)
    moved = args[:5] + (off[1:].view(c.shape),)
    _b1_forced(moved, f["s_cap"], f["n_amb"], [dict(home="local", k=4)])


def test_pixel_eval_unstaged_long_tape_matches_plain(cuda):
    """The full stress_2d(1500) tape (13,365 clauses, past B1_STAGE) as
    every tile's tape: read from global memory at the picked shape, and
    staged whole in shared memory at a forced stage size."""
    from mpr_tpu_torch.ops import launch as ln
    td = TapeData.from_tape(_tape("stress1500"), device=cuda)
    assert td.length > ln.B1_STAGE
    n_tiles, P = 3, 1024
    words = td.packed[None].expand(n_tiles, -1).contiguous()
    imms = td.imms[None].expand(n_tiles, -1).contiguous()
    lens = torch.full((n_tiles,), td.length, dtype=torch.int32, device=cuda)
    coords = torch.from_numpy(np.random.default_rng(43).uniform(
        -1, 1, (n_tiles, 3, P)).astype(np.float32)).to(cuda)
    nmeta = td.meta()
    nmeta[0] = n_tiles
    order = torch.tensor([2, 0, 1], dtype=torch.int32, device=cuda)
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    ran = _b1_forced((nmeta, order, lens, words, imms, coords), s_cap,
                     n_tiles, [{}, dict(home="local", k=1),
                               dict(home="local", stage=td.length)])
    assert all(sh.staged < td.length for sh in ran[:2])
    assert ran[2].staged == td.length


# Forced launch shapes of C1 (launch.compact_runs_launch's keyword
# arguments): a warp a row at 1, 8 and 32 rows a block, a block a row at
# 128 to 1024 threads.
C1_SHAPES = ([dict(warp=True, threads=t) for t in (32, 256, 1024)]
             + [dict(warp=False, threads=t) for t in (128, 256, 1024)])


def _assert_c1_same(got, want, n, rcap):
    """C1's outputs against the plain version's over what is specified:
    gmeta[:, :3], each tape over [0, len), the headers over [0, n_runs)."""
    gm = got[3][:n]
    assert torch.equal(gm[:, :3], want[3][:n, :3])
    k = torch.arange(max(got[0].shape[1], rcap), device=gm.device)
    m = k[None, :got[0].shape[1]] < gm[:, :1]
    assert torch.equal(got[0][:n][m], want[0][:n][m])
    assert torch.equal(got[1][:n].view(torch.int32)[m],
                       want[1][:n].view(torch.int32)[m])
    mr = k[None, :rcap] < torch.clamp(gm[:, 1:2], max=rcap)
    assert torch.equal(got[2][:n][mr], want[2][:n][mr])


@pytest.mark.parametrize("name", ["stress40", "stress150", "all_ops"])
def test_compact_runs_forced_shapes_match_plain(cuda, name):
    """Every forced shape, on a short tape (a warp a row picked) and a
    long one (a block a row), at cap = the bucket, at a cap and rcap that
    are no multiple of 4 (4-byte stores) with cmeta[2] below cap, and at a
    cap some tapes overflow."""
    from mpr_tpu_torch.ops import launch as ln
    f = _v1_inputs(_tape(name), 512, cuda)
    td, n = f["td"], f["n_amb"]
    tcap = td.capacity
    gcap = f["order"].shape[0]
    picked = ln.compact_runs_launch(tcap, tcap, gcap)
    assert (picked.group == 32) == (tcap <= ln.C_WARP_TCAP)
    for cap, capm, rcap in ((tcap, tcap, tcap), (tcap // 4 + 3, tcap // 8,
                                                  tcap // 4 + 1),
                            (16, 16, 16)):
        args = (_cmeta(cuda, n, tcap // 8, capm), td.packed, td.imms,
                f["order"], f["remap"], f["codes"], gcap, cap, rcap)
        want = tk.compact_runs_plain(*args)
        for kw in [{}] + C1_SHAPES:
            try:
                launch = ln.compact_runs_launch(tcap, cap, gcap, **kw)
            except ValueError:
                # several rows of a long tape a block: past shared memory
                assert kw["warp"] and kw["threads"] > 32 and tcap > 1024
                continue
            got = tk.compact_runs(*args, launch=launch)
            torch.cuda.synchronize()
            _assert_c1_same(got, want, n, rcap)


def test_compact_runs_unaligned_code_rows_match_plain(cuda):
    """Code rows of 13 words (no 16-byte loads): seeded random nibbles
    over the all-ops tape cut to 104 clauses, a tile of exactly cap kept
    clauses (flagged), at cap = rcap = 40."""
    from mpr_tpu_torch.ops import launch as ln
    td = TapeData.from_tape(_tape("all_ops"), device=cuda)
    tcap, n_tiles, cap = 104, 16, 40
    words, imms = td.packed[:tcap].contiguous(), td.imms[:tcap].contiguous()
    rng = np.random.default_rng(44)
    nib = rng.choice(5, size=(n_tiles, tcap), p=[0.5, 0.2, 0.1, 0.1, 0.1])
    nz = np.flatnonzero(nib[4])
    nib[4, nz[cap:]] = 0                               # exactly cap kept
    nib[4, np.flatnonzero(nib[4] == 0)[:cap - min(cap, nz.size)]] = 1
    codes = torch.from_numpy(
        (nib.reshape(n_tiles, tcap // 8, 8) << (4 * np.arange(8))).sum(
            axis=2).astype(np.uint32).view(np.int32)).to(cuda)
    order = torch.from_numpy(rng.permutation(n_tiles).astype(np.int32)).to(
        cuda)
    _, remap = tk.build_remap(tuple(range(2, 32)))
    remap_t = torch.as_tensor(remap, device=cuda)
    args = (_cmeta(cuda, n_tiles, tcap // 8, cap), words, imms, order,
            remap_t, codes, n_tiles, cap, cap)
    want = tk.compact_runs_plain(*args)
    assert want[3][:, 2].any()
    for kw in [{}] + C1_SHAPES:
        got = tk.compact_runs(
            *args, launch=ln.compact_runs_launch(tcap, cap, n_tiles, **kw))
        torch.cuda.synchronize()
        _assert_c1_same(got, want, n_tiles, cap)


@pytest.mark.parametrize("name", ["stress40", "all_ops", "random2"])
def test_compact_bitshift_kernel_matches_plain_and_kernel_c(cuda, name):
    f = _v1_inputs(_tape(name), 512, cuda)
    td, n = f["td"], f["n_amb"]
    cap = td.capacity // 8
    gcap = f["order"].shape[0]
    wrw, irw, rem, lens = f["planes"]
    cmeta = _cmeta(cuda, n, cap, cap)
    args = (cmeta, f["order"], lens, wrw, irw, rem, gcap, cap, cap)
    before = tk.compact_bitshift.launches
    got = tk.compact_bitshift(*args)
    assert tk.compact_bitshift.launches == before + 1
    want = tk.compact_bitshift_plain(*args)
    sel = f["order"].long()
    c = tk.compact_bitshift_batched(cmeta, lens[sel].contiguous(),
                                    wrw[sel].contiguous(),
                                    irw[sel].contiguous(),
                                    rem[sel].contiguous(), cap)
    torch.cuda.synchronize()
    for g, w, k in zip(got[:3], want[:3], c[:3]):
        assert torch.equal(g[:n], w[:n]) and torch.equal(g[:n], k[:n])
    assert torch.equal(got[3][:n, :3], want[3][:n, :3])
    assert torch.equal(got[3][:n, :3], c[3][:n, :3])


def test_v1_wrappers_raise_on_bad_inputs(cuda):
    f = _v1_inputs(_tape("stress40"), 256, cuda)
    td = f["td"]
    cap = td.capacity
    gcap = f["order"].shape[0]
    good = (_cmeta(cuda, 1, cap // 8, cap), td.packed, td.imms, f["order"],
            f["remap"], f["codes"], gcap, cap, cap)
    bad = list(good)
    bad[5] = f["codes"].long()
    with pytest.raises(TypeError):
        tk.compact_runs(*bad)
    bad = list(good)
    bad[3] = f["order"].cpu()
    with pytest.raises(ValueError):
        tk.compact_runs(*bad)
    with pytest.raises(ValueError):
        tk.compact_runs(*good[:6], gcap, 1 << 20, cap)
    wrw, irw, rem, lens = f["planes"]
    with pytest.raises(ValueError):
        tk.compact_bitshift(_cmeta(cuda, 1, 64, 64), f["order"], lens, wrw,
                            irw, rem, gcap, cap * 2, cap)
    with pytest.raises(TypeError):
        tk.pixel_eval(td.meta(), f["order"], lens,
                      torch.zeros(gcap, cap, dtype=torch.int32, device=cuda),
                      torch.zeros(gcap, cap, dtype=torch.float64,
                                  device=cuda), f["coords"])


# ---------------------------------------------------------------------------
# Effects and the command line on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["two_spheres", "gyroid"])
@pytest.mark.parametrize("size", [128, 256])
def test_effects_on_the_card_match_the_cpu(cuda, name, size):
    """The same tensors through the effects on the card and on the CPU:
    both run the same IEEE operations, so the images agree to rounding of
    the few library calls that differ (none is expected to)."""
    from mpr_tpu_torch.render import effects
    tape, mat = _tape3d(name)
    depth, normals = mpr_tpu_torch.render.render3d(tape, mat=mat, size=size)
    for mode, scale in (("static", 1), ("gather", 1), ("gather", 2)):
        got = effects.draw_ssao(depth, normals, scale, mode).cpu()
        want = effects.draw_ssao(depth, normals, scale, mode, device="cpu")
        d = (got - want).abs()
        assert float((d > 1e-5).float().mean()) <= 0.01, mode
        assert float(d.max()) <= 0.05, mode
        assert got.min() >= 0 and got.max() <= 1
    got = effects.draw_shaded(depth, normals).cpu()
    want = effects.draw_shaded(depth, normals, device="cpu")
    d = (got - want).abs()
    assert float((d > 1e-5).float().mean()) <= 0.01
    assert float(d.max()) <= 0.05
    m = torch.as_tensor(depth > 0)
    assert not got[~m].any() and got[m].min() >= 0.2 - 1e-6


def test_cli_renders_on_the_card(cuda, tmp_path, capsys):
    from mpr_tpu_torch import cli
    from mpr_tpu_torch.io.png import read_png_gray
    before = tk.pixel_eval_runs.launches
    out = tmp_path / "a.png"
    cli.main(["render2d", "stress:40", "--size", "256", "--check", "--out",
              str(out)])
    assert "mismatch 0.00e+00" in capsys.readouterr().out
    assert tk.pixel_eval_runs.launches == before + 1
    assert read_png_gray(str(out)).shape == (256, 256)
    cli.main(["render3d", "stress:12", "--size", "128", "--out",
              str(tmp_path / "b.png")])
    for suffix in ("depth", "norm", "ssao", "shaded"):
        assert (tmp_path / f"b_{suffix}.png").exists()


# ---------------------------------------------------------------------------
# The unrolled engine: the kernels ops/unrolled_eval.py generates per tape
# ---------------------------------------------------------------------------

from mpr_tpu_torch.ops import unrolled_eval as ue  # noqa: E402
from mpr_tpu_torch.render import brute, unrolled  # noqa: E402

U_NAMES = NAMES + ["stress600"]
U_BUILDERS = {"float": ue.build_float, "interval": ue.build_interval,
              "deriv": ue.build_deriv}


def _u_tape(name):
    if name == "stress600":
        return mpr_tpu_torch.compile_tree(shapes.stress_2d(600))
    return _tape(name)


def _u_args(kind, dev, n=20_000, seed=61):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.uniform(-1.5, 1.5, n).astype(np.float32)
               for _ in range(3))
    if kind == "interval":
        w = rng.uniform(0.0, 0.6, (3, n)).astype(np.float32)
        vals = [x, x + w[0], y, y + w[1], z, z + w[2]]
    else:
        vals = [x, y, z]
    return [torch.from_numpy(v).to(dev) for v in vals]


def _bits_equal(got, want):
    """Every output bit for bit, NaNs (of any payload) in the same
    places."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        nan = torch.isnan(g)
        assert torch.equal(nan, torch.isnan(w))
        assert torch.equal(g.view(torch.int32)[~nan],
                           w.view(torch.int32)[~nan])


@pytest.fixture(scope="module")
def unrolled_built():
    """Every evaluator of the parity tapes, both modes, built at once (one
    nvcc process each, all started together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    evs = {(kind, name, take): U_BUILDERS[kind](_u_tape(name), take)
           for kind in U_BUILDERS for name in U_NAMES
           for take in (False, True)}
    ue.build_all(list(evs.values()))
    return evs


@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
@pytest.mark.parametrize("name", U_NAMES)
@pytest.mark.parametrize("kind", sorted(U_BUILDERS))
def test_unrolled_kernel_matches_plain(unrolled_built, cuda, kind, name,
                                       take):
    ev = unrolled_built[(kind, name, take)]
    args = _u_args(kind, cuda)
    imms = torch.as_tensor(ev.tape.imms, device=cuda) if take else None
    before = getattr(ue, f"unrolled_{kind}").launches
    got = ev(*args, imms=imms)
    torch.cuda.synchronize()
    assert getattr(ue, f"unrolled_{kind}").launches == before + 1
    _bits_equal(got, ev.plain(*args, imms=imms))


@pytest.mark.parametrize("flag", ["tight_sincos", "widen_intervals",
                                  "fast_transcendentals"])
@pytest.mark.parametrize("name", ["all_ops", "random3"])
def test_unrolled_kernel_under_config_flags_matches_plain(cuda, name, flag):
    from mpr_tpu_torch import config
    with config.override(**{flag: True}):
        evs = [b(_u_tape(name)) for b in U_BUILDERS.values()]
    ue.build_all(evs)
    for ev in evs:
        args = _u_args(ev.kind, cuda, seed=67)
        _bits_equal(ev(*args), ev.plain(*args))


# Every form of the float, interval and deriv kernels (ops/launch.py
# UnrolledLaunch: the lanes form at each K it is built at, the split form
# at each P of UNROLLED_PARTS, the serial form of the first design) against
# the plain version and the serial form, bit for bit (all outputs: the
# deriv kernel's four), at lane counts around a warp, a block, one wave of
# the lanes form and 2^20, a tenth of the lanes +-0, +-inf or NaN.
from mpr_tpu_torch.ops import launch as uln  # noqa: E402

U_FORM_TAPES = ["all_ops", "random3", "stress40"]


def _u_forms(kind):
    return ([uln.UnrolledLaunch("lanes", k=k) for k in uln.UNROLLED_KS[kind]]
            + [uln.UnrolledLaunch("split", parts=p)
               for p in uln.UNROLLED_PARTS]
            + [uln.UnrolledLaunch("serial")])


def _u_lanes(kind, n, dev, seed=71):
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)

    def plane():
        v = rng.uniform(-1.5, 1.5, n).astype(np.float32)
        m = rng.random(n) < 0.1
        v[m] = rng.choice(special, int(m.sum()))
        return v
    x, y, z = plane(), plane(), plane()
    vals = [x, y, z]
    if kind == "interval":
        w = rng.uniform(0.0, 0.6, (3, n)).astype(np.float32)
        vals = [x, x + w[0], y, y + w[1], z, z + w[2]]
    return [torch.from_numpy(v).to(dev) for v in vals]


@pytest.fixture(scope="module")
def unrolled_forms():
    """Every form of the float, interval and deriv evaluators of the form
    tapes, both modes, built at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    evs = {(kind, name, take): U_BUILDERS[kind](_u_tape(name), take)
           for kind in U_BUILDERS for name in U_FORM_TAPES
           for take in (False, True)}
    ue.build_all([ev.kernel(f) for ev in evs.values()
                  for f in _u_forms(ev.kind)])
    return evs


@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
@pytest.mark.parametrize("name", U_FORM_TAPES)
@pytest.mark.parametrize("kind", ["float", "interval", "deriv"])
def test_unrolled_every_form_matches_plain(unrolled_forms, cuda, kind, name,
                                           take):
    ev = unrolled_forms[(kind, name, take)]
    wave = uln.UNROLLED_WAVE
    imms = torch.as_tensor(ev.tape.imms, device=cuda) if take else None
    for n in (1, 31, 33, 127, 129, wave - 1, wave + 1, 1 << 20):
        args = _u_lanes(kind, n, cuda, seed=n)
        want = ev.plain(*args, imms=imms)
        first = ev(*args, imms=imms, launch=uln.UnrolledLaunch("serial"))
        _bits_equal(first, want)
        for form in _u_forms(kind):
            before = getattr(ue, f"unrolled_{kind}").launches
            got = ev(*args, imms=imms, launch=form)
            torch.cuda.synchronize()
            assert getattr(ue, f"unrolled_{kind}").launches == before + 1
            _bits_equal(got, want)
            _bits_equal(got, first)
        # the picker's own form
        _bits_equal(ev(*args, imms=imms), want)


def test_unrolled_min_max_nan_forms_match_torch_on_special_values(cuda):
    """min.NaN / max.NaN (the lanes and split forms) and nmin / nmax (the
    serial form) against torch.minimum / maximum on every pair of +-0,
    +-inf, NaN, a subnormal and ordinary values."""
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-40,
                     -3.5, 2.5e38], np.float32)
    a, b = (torch.from_numpy(v.ravel().copy()).to(cuda)
            for v in np.meshgrid(vals, vals))
    z = torch.zeros_like(a)
    for op in (18, 20):           # MIN_LHS_RHS, MAX_LHS_RHS
        tape = Tape.from_arrays(ops=[op], outs=[4], lhss=[1], rhss=[2],
                                imms=[0.0], axis_slots=(1, 2, 3),
                                result_slot=4, num_slots=5, num_choices=1)
        want = (torch.minimum if op == 18 else torch.maximum)(a, b)
        f, fi = ue.build_float(tape), ue.build_interval(tape)
        for form in _u_forms("float"):
            _bits_equal(f(a, b, z, launch=form), want)
        for form in _u_forms("interval"):
            lo, hi = fi(a, a, b, b, z, z, launch=form)
            _bits_equal((lo, hi), (want, want))


def test_unrolled_deriv_sincosf_matches_plain_on_special_values(cuda):
    """A deriv sin or cos clause (sincosf in the lanes and split forms,
    sinf and cosf in the serial one) against the plain version on +-0,
    +-inf, NaN, subnormals, arguments past the fast range reduction and
    100,000 seeded ones up to 1e4, at every form: all four outputs bit
    for bit."""
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 0.5,
                     -2.5, 3.1415927, 105615.0, -105616.0, 1e6, 3e8, 1e30,
                     -3.4e38], np.float32)
    rng = np.random.default_rng(73)
    x = torch.from_numpy(np.concatenate([vals, rng.uniform(
        -1e4, 1e4, 100_000).astype(np.float32)])).to(cuda)
    y = torch.linspace(-1, 1, x.numel(), device=cuda)
    for op in (5, 6):             # SIN_LHS, COS_LHS
        tape = Tape.from_arrays(ops=[op, 16], outs=[4, 4], lhss=[1, 4],
                                rhss=[0, 2], imms=[0.0, 0.0],
                                axis_slots=(1, 2, 3), result_slot=4,
                                num_slots=5, num_choices=0)
        fd = ue.build_deriv(tape)
        want = fd.plain(x, y, y)
        for form in _u_forms("deriv"):
            _bits_equal(fd(x, y, y, launch=form), want)


def test_unrolled_kernel_info_reports_the_grid_of_each_form(cuda):
    tape = mpr_tpu_torch.compile_tree(shapes.stress_2d(40))
    ev = ue.build_interval(tape)
    lanes = ue.kernel_info(ev.kernel(uln.UnrolledLaunch("lanes", k=2)))
    assert lanes["threads"] == uln.UNROLLED_THREADS
    assert lanes["block_lanes"] == 2 * uln.UNROLLED_THREADS
    assert lanes["blocks_per_sm"] >= 1 and lanes["sms"] >= 1
    assert lanes["local_bytes"] == 0
    sp = ue.kernel_info(ev.kernel(uln.UnrolledLaunch("split", parts=32)))
    assert sp["block_lanes"] == 32 and sp["threads"] % 32 == 0
    assert sp["threads"] <= 32 * 32 and sp["shared_bytes"] > 0


def test_unrolled_forced_form_that_does_not_fit_raises(cuda):
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.5))
    x = torch.linspace(-1, 1, 100, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        ue.build_interval(tape)(x, x, x, x, x, x,
                                launch=uln.UnrolledLaunch("lanes", k=4))
    with pytest.raises(ValueError, match="does not fit"):
        ue.build_deriv(tape).kernel(uln.UnrolledLaunch("lanes", k=4))
    with pytest.raises(ValueError, match="does not fit"):
        ue.build_deriv(tape).kernel(uln.UnrolledLaunch("split", parts=2))


def test_unrolled_imm_change_builds_nothing(cuda):
    """With the immediates an input, new values take the same kernel: no
    build, no new library, and the result follows the new values."""
    tape = mpr_tpu_torch.compile_tree(shapes.stress_2d(40))
    ev = ue.build_float(tape, take_imms=True)
    args = _u_args("float", cuda)
    ev(*args)
    n_builds, n_libs = len(ue.BUILDS), len(ue._libs)
    imms = torch.as_tensor(tape.imms * np.float32(1.25), device=cuda)
    other = ue.build_float(mpr_tpu_torch.compile_tree(shapes.stress_2d(40)),
                           take_imms=True)
    assert other.key == ev.key
    got = other(*args, imms=imms)
    assert (len(ue.BUILDS), len(ue._libs)) == (n_builds, n_libs)
    _bits_equal(got, ev.plain(*args, imms=imms))
    assert not torch.equal(got, ev(*args))


def test_unrolled_kernels_are_forward_only(cuda):
    """Baked, interval and deriv kernels do not differentiate in imms on
    the card; the imm-input float evaluator does, through kernel K1."""
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.5))
    x = torch.linspace(-1, 1, 100, device=cuda)
    imms = torch.as_tensor(tape.imms, device=cuda).requires_grad_(True)
    fi = ue.build_interval(tape, take_imms=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fi(x, x, x, x, x, x, imms=imms)
    with pytest.raises(RuntimeError, match="no imms to differentiate"):
        ue.build_float(tape).vjp
    ev = ue.build_float(tape, take_imms=True)
    before = ue.unrolled_float_vjp.launches
    ev(x, x, x, imms=imms).sum().backward()
    assert ue.unrolled_float_vjp.launches == before + 1
    im = imms.detach().clone().requires_grad_(True)
    ev.plain(x, x, x, imms=im).sum().backward()
    assert torch.allclose(imms.grad, im.grad, rtol=0,
                          atol=1e-5 * float(im.grad.abs().max()))


# The backward kernels K1 (generated per tape) and K2 (the interpreter's
# adjoint) against their plain versions, autograd through the plain walks,
# on the chip cells' tapes.  Tolerance: the largest difference within 1e-4
# of the largest component (float32 sums over the lanes in another order:
# warp shuffles, shared atomics, blocks; measured 4e-7).
BACKWARD_TAPES = {
    "stress_2d(600)": lambda: shapes.stress_2d(600),
    "gyroid": lambda: shapes.intersection(shapes.gyroid(0.4, 0.08),
                                          shapes.sphere(0.85)),
    "extruded_stress": lambda: shapes.extrude_z(shapes.stress_2d(300),
                                                -0.4, 0.4),
    "all_ops": None,
}


def _backward_case(name, cuda, n=70001):
    tape = (Tape.from_arrays(**all_ops_clauses()) if name == "all_ops"
            else mpr_tpu_torch.compile_tree(BACKWARD_TAPES[name]()))
    rng = np.random.default_rng(5)
    x, y, z, g = (torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                                  device=cuda) for _ in range(4))
    return tape, x, y, z, g


def _close(got, want):
    scale = float(want.abs().max())
    assert scale > 0 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("name", list(BACKWARD_TAPES))
def test_k1_matches_autograd_of_the_plain_walk(cuda, name):
    tape, x, y, z, g = _backward_case(name, cuda)
    ev = ue.build_float(tape, take_imms=True)
    imms = torch.as_tensor(tape.imms, device=cuda)
    before = ue.unrolled_float_vjp.launches
    got = ue.unrolled_float_vjp(ev.vjp, x, y, z, g, imms)
    chunk = ue.vjp_chunk(ev.vjp.plan, x.numel())     # lanes a launch
    assert ue.unrolled_float_vjp.launches - before == -(-x.numel() // chunk)
    im = imms.clone().requires_grad_(True)
    want, = torch.autograd.grad(ev.plain(x, y, z, imms=im), im, g)
    _close(got, want)


def test_k1_in_chunks_equals_one_launch(cuda, monkeypatch):
    tape, x, y, z, g = _backward_case("stress_2d(600)", cuda)
    ev = ue.build_float(tape, take_imms=True)
    imms = torch.as_tensor(tape.imms, device=cuda)
    one = ue.unrolled_float_vjp(ev.vjp, x, y, z, g, imms)
    monkeypatch.setattr(ue, "VJP_BYTES", ev.vjp.plan.k1_lane_bytes * 9000)
    before = ue.unrolled_float_vjp.launches
    chunked = ue.unrolled_float_vjp(ev.vjp, x, y, z, g, imms)
    chunk = 9000 - 9000 % 128           # whole blocks of the layout
    assert ue.unrolled_float_vjp.launches - before == -(-x.numel() // chunk)
    _close(chunked, one)


@pytest.mark.parametrize("name", list(BACKWARD_TAPES))
def test_k2_matches_autograd_of_the_plain_walk(cuda, name):
    from mpr_tpu_torch.ops import eval_scan
    tape, x, y, z, g = _backward_case(name, cuda)
    td = TapeData.from_tape(tape, device=cuda)
    v = eval_scan.scan_eval(td, x, y, z)
    assert torch.equal(torch.nan_to_num(v, 7.0), torch.nan_to_num(
        eval_scan.eval_f_plain(td, x, y, z), 7.0))
    before = eval_scan.scan_adjoint.launches
    got = eval_scan.scan_adjoint(td, x, y, z, g)
    plan = td.vjp_plan()[0]
    chunk = eval_scan.adj_chunk(plan, x.numel())     # lanes a launch
    assert eval_scan.scan_adjoint.launches - before == -(-x.numel() // chunk)
    im = td.imms.clone().requires_grad_(True)
    want, = torch.autograd.grad(
        eval_scan.eval_f_plain(td.replace_imms(im), x, y, z), im, g)
    _close(got, want)
    # in chunks of lanes (several K2f/K2 launches) the same
    old = eval_scan.ADJ_BYTES
    eval_scan.ADJ_BYTES = plan.k2_lane_bytes * 20000
    try:
        before = eval_scan.scan_adjoint.launches
        _close(eval_scan.scan_adjoint(td, x, y, z, g), want)
        assert eval_scan.scan_adjoint.launches - before == -(
            -x.numel() // 20000)
    finally:
        eval_scan.ADJ_BYTES = old


@pytest.mark.parametrize("name", [f"random{i}" for i in range(8)])
def test_k1_and_k2_on_random_trees(cuda, name):
    """K1 and K2 against autograd of their plain walks on random trees
    (every operand form), on a lane count that leaves dead lanes."""
    from mpr_tpu_torch.ops import eval_scan
    tape = _tape(name)
    rng = np.random.default_rng(6)
    n = 33333
    x, y, z, g = (torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                                  device=cuda) for _ in range(4))
    ev = ue.build_float(tape, take_imms=True)
    imms = torch.as_tensor(tape.imms, device=cuda)
    im = imms.clone().requires_grad_(True)
    want, = torch.autograd.grad(ev.plain(x, y, z, imms=im), im, g)
    _close(ue.unrolled_float_vjp(ev.vjp, x, y, z, g, imms), want)
    td = TapeData.from_tape(tape, device=cuda)
    im = td.imms.clone().requires_grad_(True)
    want, = torch.autograd.grad(
        eval_scan.eval_f_plain(td.replace_imms(im), x, y, z), im, g)
    _close(eval_scan.scan_adjoint(td, x, y, z, g), want)


def _k2_shapes():
    """(home, K, threads, s_cap) of every shape K2 is built at: each home
    and K, every local bucket."""
    out = [("shared", k, t, s_cap) for k in (2, 4)
           for t, s_cap in ((None, 176), (64, 16))]
    out += [("local", k, None, s_cap) for k in (2, 4)
            for s_cap in (16, 32, 64, 128, 256)]
    out += [("local", 2, 64, 176), ("local", 2, 256, 176),
            ("local", 4, 128, 176)]
    return out


@pytest.mark.parametrize("home,k,threads,s_cap", _k2_shapes())
def test_k2_at_every_launch_shape(cuda, home, k, threads, s_cap):
    """K2 at each home, K and bucket adjoint_launch can pick or a caller
    can force (a file of ``s_cap`` slots, at least the tape's), against
    autograd of the plain walk, on the tape that runs every opcode (8
    slots) and on stress_2d(40) where the file holds its slots."""
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops import launch as ln
    for name in ("all_ops", "stress40"):
        tape = _tape(name)
        td = TapeData.from_tape(tape, device=cuda)
        if td.num_slots > s_cap:
            continue
        shape = ln.adjoint_launch(s_cap, tape.length, home=home, k=k,
                                  threads=threads)
        rng = np.random.default_rng(8)
        n = 20001
        x, y, z, g = (torch.as_tensor(rng.uniform(-1, 1, n).astype(
            np.float32), device=cuda) for _ in range(4))
        im = td.imms.clone().requires_grad_(True)
        want, = torch.autograd.grad(
            eval_scan.eval_f_plain(td.replace_imms(im), x, y, z), im, g)
        got = eval_scan.scan_adjoint(td, x, y, z, g, launch=shape,
                                     s_cap=s_cap)
        _close(got, want)


def test_k2_refuses_a_shape_of_another_tape(cuda):
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops import launch as ln
    td = TapeData.from_tape(_tape("stress40"), device=cuda)
    x = torch.zeros(100, device=cuda)
    other = ln.adjoint_launch(eval_scan.adjoint_s_cap(td), 5373)
    with pytest.raises(ValueError, match="does not fit"):
        eval_scan.scan_adjoint(td, x, x, x, x, launch=other)


def _k2f_store(td, n):
    from mpr_tpu_torch.ops import vjp_plan as vp
    plan = td.vjp_plan()[0]
    return (torch.zeros(vp.blocked_size(plan.n_vals, n), device=td.device),
            torch.zeros(vp.blocked_size(plan.n_words, n), dtype=torch.int32,
                        device=td.device))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = (torch.nan_to_num(t, 7.0).view(torch.int32) for t in (a, b))
    return bool(torch.equal(a, b))


def _k2f_sweep():
    from mpr_tpu_torch.ops import launch as ln
    return [(s.threads, s.k) for s in ln.SCAN_SWEEP]


@pytest.mark.parametrize("store", [False, True], ids=["walk", "store"])
@pytest.mark.parametrize("threads,k", _k2f_sweep())
def test_k2f_at_every_swept_shape_matches_plain(cuda, threads, k, store):
    """K2f at every shape of ``SCAN_SWEEP`` (both libraries), storing the
    plan or not, bit for bit against its plain version (the tape-order
    walk and its store, ``scan_plan.store_plain``) and its first design
    (the stores' whole bytes), on random trees, the tape that runs every
    opcode and stress_2d(600), in chunks of lanes that leave a thread's
    lanes part dead."""
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops import scan_plan as spm
    shape = ln.ScanLaunch(threads, k)
    rng = np.random.default_rng(12)
    for name in [f"random{i}" for i in range(8)] + ["all_ops", "stress600"]:
        tape = (mpr_tpu_torch.compile_tree(shapes.stress_2d(600))
                if name == "stress600" else _tape(name))
        td = TapeData.from_tape(tape, device=cuda)
        n = 30001
        x, y, z = (torch.as_tensor(rng.uniform(-1.2, 1.2, n).astype(
            np.float32), device=cuda) for _ in range(3))
        for c0, c1 in ((0, 7), (7, 12345), (12345, n)):
            xs, ys, zs = x[c0:c1], y[c0:c1], z[c0:c1]
            m = c1 - c0
            st = _k2f_store(td, m) if store else None
            v = eval_scan.scan_eval(td, xs, ys, zs, store=st, launch=shape)
            st1 = _k2f_store(td, m) if store else None
            v1 = eval_scan.scan_eval_first(td, xs, ys, zs, store=st1)
            if store:
                pv, pvals, pwords = spm.store_plain(td, xs, ys, zs)
                assert _same_bits(st[0], st1[0]) and _same_bits(st[1], st1[1])
                assert _same_bits(st[0][:pvals.numel()], pvals), name
                assert _same_bits(st[1][:pwords.numel()], pwords), name
            else:
                pv = eval_scan.eval_f_plain(td, xs, ys, zs)
            assert _same_bits(v, pv), (name, c0)
            assert _same_bits(v1, pv), (name, c0)


def test_k2f_picks_its_shape_and_refuses_others(cuda):
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops import launch as ln
    td = TapeData.from_tape(_tape("stress40"), device=cuda)
    x = torch.linspace(-1, 1, 1000, device=cuda)
    before = eval_scan.scan_eval.launches
    eval_scan.scan_eval(td, x, x, x)
    assert eval_scan.scan_eval.launches == before + 1
    with pytest.raises(ValueError, match="SCAN_SWEEP"):
        eval_scan.scan_eval(td, x, x, x, launch=ln.ScanLaunch(64, 1))


@pytest.mark.parametrize("name", ["stress_2d(600)", "random3"])
def test_the_scan_fit_stores_once_a_step(cuda, name, monkeypatch):
    """Under autograd, eval_f's forward launch of K2f stores the plan and
    K2 reads it: one K2f launch a step where the lanes fit one chunk;
    otherwise the walk forward and K2f storing again in each chunk.  The
    gradient equals autograd of the plain walk either way."""
    from mpr_tpu_torch.ops import eval_scan
    tape = (mpr_tpu_torch.compile_tree(shapes.stress_2d(600))
            if name == "stress_2d(600)" else _tape(name))
    td = TapeData.from_tape(tape, device=cuda)
    rng = np.random.default_rng(13)
    n = 40000
    x, y, z, g = (torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                                  device=cuda) for _ in range(4))
    im = td.imms.clone().requires_grad_(True)
    want, = torch.autograd.grad(
        eval_scan.eval_f_plain(td.replace_imms(im), x, y, z), im, g)
    plan = td.vjp_plan()[0]
    for chunk, walks in ((n, 1), (15000, 1 + 3)):
        monkeypatch.setattr(eval_scan, "ADJ_BYTES",
                            plan.k2_lane_bytes * chunk)
        im = td.imms.clone().requires_grad_(True)
        before = (eval_scan.scan_eval.launches,
                  eval_scan.scan_adjoint.launches)
        v = eval_scan.eval_f(td.replace_imms(im), x, y, z)
        got, = torch.autograd.grad(v, im, g)
        assert (eval_scan.scan_eval.launches - before[0],
                eval_scan.scan_adjoint.launches - before[1]) == (
                    walks, -(-n // chunk))
        assert _same_bits(v.detach(), eval_scan.eval_f_plain(td, x, y, z))
        _close(got, want)


_TRAP_K2 = """
import sys
import torch
sys.path.insert(0, {root!r})
import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.ops import eval_scan
from mpr_tpu_torch.ops.tape_data import TapeData
td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.stress_2d(40)),
                        device="cuda")
x = torch.linspace(-1, 1, 4096, device="cuda")
assert td.num_slots > 8
try:
    eval_scan.scan_adjoint(td, x, x, x, x, s_cap=8)   # a file of 8 slots
    torch.cuda.synchronize()
except RuntimeError:
    print("raised by the kernel's fault")
    sys.exit(3)
sys.exit(0)
"""


def test_k2_with_more_slots_than_its_file_traps(cuda):
    """A tape with more slots than K2's adjoint file: the kernel traps
    rather than index past the file, and the fault raises (at the next
    launch of the call or at torch.cuda.synchronize(); in a subprocess: a
    trap leaves the context unusable)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _TRAP_K2.format(root=root)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 3, (r.stdout, r.stderr[-2000:])
    assert "raised by the kernel's fault" in r.stdout


@pytest.mark.parametrize("engine", ["scan", "unrolled", "culled", "3d",
                                    "window"])
def test_params_only_masks_on_the_card(cuda, engine):
    from mpr_tpu_torch.parallel import sharded
    mode = "3d" if engine in ("3d", "window") else "2d"
    if mode == "2d":
        tree = shapes.union(T.sqrt(T.square(T.x() - 0.1) + T.square(T.y()))
                            - T.var("r", 0.45), shapes.circle(0.2, cx=-0.5))
    else:
        tree = shapes.union(T.sqrt(T.square(T.x()) + T.square(T.y())
                                   + T.square(T.z())) - T.var("r", 0.5),
                            shapes.sphere(0.2, cx=0.6))
    tape = mpr_tpu_torch.compile_tree(tree)
    mask = np.zeros(tape.length, np.float32)
    mask[tape.params["r"]] = 1.0
    size = {"3d": 16, "window": 64, "culled": 128}.get(engine, 64)
    import dataclasses
    from mpr_tpu_torch import cli
    tt = dataclasses.replace(tape, imms=tape.imms_with({"r": 0.55}))
    tgt = (cli._oracle_fill(tt, size).astype(np.float32) if mode == "2d"
           else cli._oracle_depth(tt, size))
    kw = dict(lr=1e-2, grad_mask=mask)
    if engine == "scan":
        step, st = sharded.make_fit_step(size, **kw), TapeData.from_tape(tape)
    else:
        make = {"unrolled": sharded.make_fit_step_unrolled,
                "culled": sharded.make_fit_step_culled,
                "3d": sharded.make_fit_step_3d,
                "window": sharded.make_fit_step_3d_window}[engine]
        step, st = make(tape, size, **kw), torch.as_tensor(tape.imms,
                                                           device=cuda)
    launches = (ue.unrolled_float_vjp.launches,
                __import__("mpr_tpu_torch.ops.eval_scan",
                           fromlist=["x"]).scan_adjoint.launches)
    _, new = step(st, tgt)
    new = (new.imms if hasattr(new, "imms") else new).cpu().numpy()
    old = (st.imms if hasattr(st, "imms") else st).cpu().numpy()
    moved = np.flatnonzero(new[:tape.length] != old[:tape.length])
    assert len(moved) and set(moved) <= set(tape.params["r"])
    from mpr_tpu_torch.ops import eval_scan
    now = (ue.unrolled_float_vjp.launches, eval_scan.scan_adjoint.launches)
    assert now[engine == "scan"] > launches[engine == "scan"]


def test_hypot_padding_does_not_nan_poison_the_gradient(cuda):
    """A tape singular at the origin (hypot), on a lane count that leaves
    dead lanes in K1's and K2's last blocks and in the culled soft
    render: the gradient stays finite and equal to the plain one."""
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.parallel import sharded
    tree = T.hypot(T.x(), T.y()) - 0.5 if hasattr(T, "hypot") else (
        T.sqrt(T.square(T.x()) + T.square(T.y())) - 0.5)
    tape = mpr_tpu_torch.compile_tree(tree)
    n = 1000
    rng = np.random.default_rng(9)
    x, y, g = (torch.as_tensor(rng.uniform(0.05, 1, n).astype(np.float32),
                               device=cuda) for _ in range(3))
    z = torch.zeros_like(x)
    ev = ue.build_float(tape, take_imms=True)
    imms = torch.as_tensor(tape.imms, device=cuda)
    got = ue.unrolled_float_vjp(ev.vjp, x, y, z, g, imms)
    im = imms.clone().requires_grad_(True)
    want, = torch.autograd.grad(ev.plain(x, y, z, imms=im), im, g)
    _close(got, want)
    td = TapeData.from_tape(tape, device=cuda)
    got2 = eval_scan.scan_adjoint(td, x, y, z, g)
    assert torch.isfinite(got2).all()
    target = np.zeros((128, 128), np.float32)
    target[40:90, 40:90] = 1.0
    step = sharded.make_fit_step_culled(tape, 128, lr=2.0 ** 20)
    loss, new = step(imms, target)
    assert torch.isfinite(new).all() and bool(torch.isfinite(loss))
    assert not torch.equal(new, imms)


def test_a_failed_build_raises_with_no_fallback(cuda, monkeypatch,
                                                tmp_path):
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.25))
    ev = ue.build_float(tape)
    monkeypatch.setattr(ue, "UNROLLED_ROOT", tmp_path)
    monkeypatch.setattr(ue, "generate",
                        lambda *a: "this is not CUDA C++;\n")
    launches = ue.unrolled_float.launches
    x = torch.linspace(-1, 1, 100, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ev(x, x, x)
    assert ue.unrolled_float.launches == launches
    assert not (tmp_path / ev.key / "libunrolled.so").exists()


@pytest.mark.parametrize("name,size", [("stress40", 256), ("stress40", 1024),
                                       ("all_ops", 256), ("random2", 256)])
def test_unrolled_render2d_on_card_equals_brute(cuda, name, size,
                                                monkeypatch):
    tape = _tape(name)
    calls = []
    real = ue.UnrolledEval.plain
    monkeypatch.setattr(ue.UnrolledEval, "plain",
                        lambda self, *a, **k: calls.append(1) or real(
                            self, *a, **k))
    before = (ue.unrolled_interval.launches, ue.unrolled_float.launches)
    img = unrolled.render2d(tape, size=size)
    assert (ue.unrolled_interval.launches - before[0],
            ue.unrolled_float.launches - before[1]) == (2, 1)
    assert not calls
    assert np.array_equal(img, brute.render2d_brute(tape, size=size))


@pytest.mark.parametrize("skip4", [False, True], ids=["full", "skip4"])
@pytest.mark.parametrize("name", ["two_spheres", "gyroid", "extruded_stress"])
def test_unrolled_render3d_on_card_equals_brute(cuda, name, skip4):
    trees = {"two_spheres": shapes.two_spheres(),
             "gyroid": shapes.intersection(shapes.gyroid(0.4, 0.08),
                                           shapes.sphere(0.85)),
             "extruded_stress": shapes.extrude_z(shapes.stress_2d(300),
                                                 -0.4, 0.4)}
    tape = mpr_tpu_torch.compile_tree(trees[name])
    mat = camera.gui3d_view()
    r = unrolled.UnrolledRenderer(tape)
    before = ue.unrolled_deriv.launches
    depth, normals = r.render3d(mat=mat, size=256, skip4=skip4)
    assert ue.unrolled_deriv.launches == before + 1
    assert np.array_equal(depth, brute.render3d_brute(tape, mat=mat,
                                                      size=256))
    idepth, inormals = pipeline3d.render3d(tape, mat=mat, size=256)
    assert np.array_equal(depth, idepth)
    assert float(np.abs(normals - inormals).max()) <= 1e-4


@pytest.mark.parametrize("option", ["two_phase", "refine2"])
def test_unrolled_option_on_card_equals_the_cpu_frame(cuda, option,
                                                     monkeypatch):
    """The two-phase voxel stage and the 2^3 sub-refinement on the card:
    the generated kernels launch (no plain evaluator runs), and the frame
    equals the same frame on the CPU (depth bit for bit, normals within
    1e-4) and the card's single-phase frame (depth and normals bit for
    bit)."""
    tape = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    mat = camera.gui3d_view()
    size = 256
    r = unrolled.UnrolledRenderer(tape)
    dev_mat = torch.as_tensor(mat, device=cuda)
    d1, n1, _ = unrolled._render3d_impl(r.fi, r.f, r.fd, dev_mat, size, True)
    calls = []
    real = ue.UnrolledEval.plain
    monkeypatch.setattr(ue.UnrolledEval, "plain",
                        lambda self, *a, **k: calls.append(1) or real(
                            self, *a, **k))
    before = (ue.unrolled_interval.launches, ue.unrolled_float.launches,
              ue.unrolled_deriv.launches)
    depth, normals, cnt = unrolled._render3d_impl(
        r.fi, r.f, r.fd, dev_mat, size, True, **{option: True})
    torch.cuda.synchronize()
    got = (ue.unrolled_interval.launches - before[0],
           ue.unrolled_float.launches - before[1],
           ue.unrolled_deriv.launches - before[2])
    if option == "two_phase":
        want = (3, unrolled.voxel_launches(cnt[3], 4)
                + unrolled.voxel_launches(cnt[4], 4), 1)
    else:
        want = (3 + unrolled.voxel_launches(cnt[2], 2),
                unrolled.voxel_launches(cnt[3], 2), 1)
    assert got == want and not calls
    monkeypatch.undo()
    cd, cn, ccnt = unrolled._render3d_impl(
        r.fi, r.f, r.fd, torch.as_tensor(mat), size, True, **{option: True})
    assert cnt == ccnt
    assert torch.equal(depth.cpu(), cd) and torch.equal(depth, d1)
    assert torch.equal(normals, n1)
    assert float((normals.cpu() - cn).abs().max()) <= 1e-4


# ---- the unrolled voxel stage's glue kernels (csrc/voxel_glue.cu) ------------

from mpr_tpu_torch.utils.trace import COUNTS  # noqa: E402

_GYROID = shapes.intersection(shapes.gyroid(0.4, 0.08), shapes.sphere(0.85))
# case: (k, first_only, r0, rows of the slab, VOXEL_LANES or None, cells)
_GLUE = {"k2": (2, False, 0, 4, None, 6000),
         "k4": (4, False, 0, 4, None, 3000),
         "k16": (16, False, 0, 4, None, 400),
         "first_only": (4, True, 0, 4, 64 * 500, 3000),
         "slab": (16, False, 1, 2, None, 300),
         "chunked": (4, False, 0, 4, 64 * 1000, 3000),
         "empty": (4, False, 0, 4, None, 0),
         "nan": (4, False, 0, 4, None, 3000)}


def _glue_counts():
    return (COUNTS["voxel.kernels"], unrolled.voxel_centers.launches,
            unrolled.voxel_columns.launches, ue.unrolled_float.launches)


@pytest.mark.parametrize("case", sorted(_GLUE))
def test_voxel_stage_glue_kernels_equal_the_plain_glue(cuda, case,
                                                       monkeypatch):
    """_voxel_stage with the centers and columns kernels: its depth equals
    the plain glue's on the card bit for bit (the same float launches in
    between), the centers too, and each chunk launches each kernel once."""
    k, first_only, r0, rows, lanes, n = _GLUE[case]
    size = 256
    tree = (shapes.sphere(0.7) + T.sqrt(T.x()) * 1e-3 if case == "nan"
            else _GYROID)
    r = unrolled.UnrolledRenderer(mpr_tpu_torch.compile_tree(tree))
    rng = np.random.default_rng(sorted(_GLUE).index(case))
    g, y0 = size // k, 64 * r0 // k
    flat = rng.choice(g * g * (64 * rows // k), n, replace=False)
    cells = tuple(torch.as_tensor(a, device=cuda) for a in (
        flat % g, (flat // g) % (64 * rows // k) + y0,
        flat // (g * 64 * rows // k)))
    mat = torch.as_tensor(camera.gui3d_view(), device=cuda)
    depth0 = torch.as_tensor(rng.integers(0, size // 2, rows * 64 * size),
                             device=cuda)
    if lanes:
        monkeypatch.setattr(unrolled, "VOXEL_LANES", lanes)
    before = _glue_counts()
    got = unrolled._voxel_stage(r.f, mat, cells, k, size, depth0.clone(),
                                None, r0, first_only)
    torch.cuda.synchronize()
    chunks = min(1, n) if first_only else unrolled.voxel_launches(n, k)
    assert chunks == (0 if case == "empty" else 1 if first_only else
                      3 if case == "chunked" else 1)
    assert tuple(a - b for a, b in zip(_glue_counts(), before)) == \
        (chunks,) * 4
    if n:
        step = max(1, unrolled.VOXEL_LANES // k ** 3)
        part = tuple(c[:step] for c in cells)
        wxyz = unrolled.voxel_centers(mat, *part, k, size)
        _bits_equal(wxyz, unrolled.voxel_centers_plain(mat, *part, k, size))
        if case == "nan":
            assert bool(torch.isnan(r.f(*wxyz)).any())
        assert bool((got != depth0).any())
    else:
        assert torch.equal(got, depth0)
    monkeypatch.setattr(unrolled, "voxel_centers",
                        unrolled.voxel_centers_plain)
    monkeypatch.setattr(unrolled, "voxel_columns",
                        unrolled.voxel_columns_plain)
    want = unrolled._voxel_stage(r.f, mat, cells, k, size, depth0.clone(),
                                 None, r0, first_only)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["full", "skip4", "two_phase", "refine2"])
def test_unrolled_frame_on_the_glue_kernels_equals_brute(cuda, mode,
                                                         monkeypatch):
    """Whole unrolled frames on the card, their voxel stages in several
    chunks: the depth equals render3d_brute's, and COUNTS["voxel.kernels"]
    and each glue kernel's launches equal voxel_launches(...) of the
    frame's counts."""
    tape = mpr_tpu_torch.compile_tree(_GYROID)
    mat = camera.gui3d_view()
    size = 256
    r = unrolled.UnrolledRenderer(tape)
    monkeypatch.setattr(unrolled, "VOXEL_LANES", 4096 * 16)
    before = _glue_counts()
    depth, normals, cnt = unrolled._render3d_impl(
        r.fi, r.f, r.fd, torch.as_tensor(mat, device=cuda), size, True,
        skip4=mode == "skip4", two_phase=mode == "two_phase",
        refine2=mode == "refine2")
    torch.cuda.synchronize()
    vl = unrolled.voxel_launches
    want = {"full": vl(cnt[2], 4), "skip4": vl(cnt[1], 16),
            "two_phase": vl(cnt[3], 4) + vl(cnt[4], 4),
            "refine2": vl(cnt[3], 2)}[mode]
    assert want > 1
    assert tuple(a - b for a, b in zip(_glue_counts(), before)) == \
        (want,) * 4
    assert np.array_equal(depth.cpu().numpy(),
                          brute.render3d_brute(tape, mat=mat, size=size))
    assert normals is not None


def test_voxel_glue_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """For CUDA tensors the glue wrappers launch or raise: a cell edge
    without a kernel, int32 coordinates, a value plane of the wrong
    length; no fallback to the plain glue."""
    cells = tuple(torch.zeros(5, dtype=torch.int64, device=cuda)
                  for _ in range(3))
    mat = torch.eye(4, device=cuda)
    depth = torch.zeros(64 * 64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="k 8"):
        unrolled.voxel_centers(mat, *cells, 8, 64)
    with pytest.raises(TypeError, match="bx"):
        unrolled.voxel_centers(mat, cells[0].int(), *cells[1:], 4, 64)
    with pytest.raises(ValueError, match="val"):
        unrolled.voxel_columns(torch.zeros(5 * 63, device=cuda), *cells, 4,
                               64, depth)


# ---- the viewer on the card --------------------------------------------------

from mpr_tpu_torch import viewer  # noqa: E402

_EXAMPLES = __import__("pathlib").Path(__file__).resolve().parents[1] / \
    "examples"
_VIEW_CAM = {"yaw": 0.5, "pitch": -0.9, "persp": 0.3, "scale": 1.0,
             "panx": 0.0, "pany": 0.0}


def _composed(shapes_, cam, mode, size, engine):
    """The image the viewer should send, made from the engines' public
    renders (numpy, on the card) and the effects on the card."""
    r2 = unrolled.render2d if engine == "unrolled" else pipeline2d.render2d
    r3 = unrolled.render3d if engine == "unrolled" else pipeline3d.render3d
    mat = viewer.view_matrix(cam, mode)
    if mode == "2d":
        acc = np.zeros((size, size), bool)
        for s in shapes_:
            acc |= r2(mpr_tpu_torch.compile_tree(s), mat=mat, size=size)
        return np.where(acc[::-1], 255, 0).astype(np.uint8)
    depth = np.zeros((size, size), np.int32)
    normals = np.zeros((size, size, 3), np.float32)
    for s in shapes_:
        d, n = r3(mpr_tpu_torch.compile_tree(s), mat=mat, size=size)
        win = d > depth
        depth = np.where(win, d, depth)
        normals = np.where(win[..., None], n, normals)
    if mode == "heightmap":
        return (depth / size * 255).astype(np.uint8)[::-1]
    if mode == "normals":
        return ((normals * 127) + 128).clip(0, 255).astype(np.uint8)[::-1]
    from mpr_tpu_torch.render import effects
    fn = effects.draw_ssao if mode == "ssao" else effects.draw_shaded
    img = fn(torch.as_tensor(depth).cuda(), torch.as_tensor(normals).cuda())
    return (img * 255).to(torch.uint8).cpu().numpy()[::-1]


@pytest.mark.parametrize("mode", ["2d", "heightmap", "normals", "ssao",
                                  "shaded"])
@pytest.mark.parametrize("engine", ["interp", "unrolled"])
def test_viewer_render_scene_on_card_equals_composed(cuda, engine, mode):
    src = ("shapes = [stress_2d(40), circle(0.3, 0.5, 0.5)]" if mode == "2d"
           else (_EXAMPLES / "gyroid_demo.py").read_text())
    shapes_, _ = viewer._eval_src(src)
    img, ms, _ = viewer.render_scene(src, _VIEW_CAM, mode, 256, engine)
    want = _composed(shapes_, _VIEW_CAM, mode, 256, engine)
    assert img.dtype == want.dtype == np.uint8 and ms > 0
    assert np.array_equal(img, want), int((img != want).sum())


def test_viewer_slider_builds_nothing(cuda):
    """examples/parametric.io on the unrolled engine: after the first
    frame, slider moves build and load no generated kernel, and each image
    equals a fresh render of ``with_params`` of the tree."""
    path = _EXAMPLES / "parametric.io"
    src = path.read_text()
    viewer.render_scene(src, _VIEW_CAM, "normals", 256, "unrolled",
                        str(path))
    builds, libs = len(ue.BUILDS), len(ue._libs)
    (tree,), _ = viewer._eval_src(src, str(path))
    for vv in ({"radius": 0.8}, {"bore-r": 0.15, "tilt": 1.0},
               {"radius": 0.5, "tilt": 0.2}):
        img, _, _ = viewer.render_scene(src, _VIEW_CAM, "normals", 256,
                                        "unrolled", str(path),
                                        var_values=vv)
        assert (len(ue.BUILDS), len(ue._libs)) == (builds, libs), vv
        want = _composed([T.with_params(tree, vv)], _VIEW_CAM, "normals",
                         256, "unrolled")
        assert np.array_equal(img, want), vv
