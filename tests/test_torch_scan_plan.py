"""PyTorch port: kernel K2f's re-slotted walk (``ops/scan_plan.py``) and
its launch shapes, on the CPU.

The walk the kernel runs (the clauses depth first, a file of the live
peak, operands from the previous clause in registers, choice words
gathered in the file) is replayed in plain PyTorch from its entries
alone (``scan_plan.replay``) and held bit for bit to the tape-order walk
and its store (``scan_plan.store_plain``: ``_walk_f``'s clauses and
``vjp_plan.forward_store``), on the chip cells' tapes, the examples and
random trees; its result also to ``mpr_tpu``'s ``eval_f`` (interpreter's
float walk under XLA: equal where the tape has no op whose CPU rounding
differs from XLA's, else within ``ULPS``), and K2's gradient from the
replayed store (``vjp_plan.replay_k2``) to ``jax.grad`` within PR 9's
tolerance (1e-5 of the largest component).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from mpr_tpu.ops import eval_scan as jes
from mpr_tpu.ops import tape_data as jtd
from mpr_tpu.tape.tape import Tape as JTape

import mpr_tpu_torch
from mpr_tpu_torch.frontend import scheme, shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.ops import eval_scan
from mpr_tpu_torch.ops import launch as ln
from mpr_tpu_torch.ops import scan_plan as spm
from mpr_tpu_torch.ops import vjp_plan as vp
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (all_ops_clauses, one_torch_thread,  # noqa: F401
                              random_trees)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
GRAD_TOL = 1e-5
ULPS = 4
# opcodes whose rounding differs between torch's CPU math and XLA's
INEXACT_OPS = frozenset({3, 5, 6, 7, 8, 9, 10, 12, 30})
_RANDOM = random_trees(T, mpr_tpu_torch.compile_tree, 6, seed=20261018)


def _example(name):
    path = EXAMPLES / name
    if name.endswith(".io"):
        return shapes.union(*scheme.run_file(str(path)).shapes)
    # the viewer's script protocol: the shape library and the tree
    # builders in scope, ``shape`` or a list ``shapes`` out
    ns = {k: getattr(shapes, k) for k in dir(shapes) if not k.startswith("_")}
    ns.update({k: getattr(T, k) for k in (
        "x", "y", "z", "const", "var", "minimum", "maximum", "sqrt",
        "square", "sin", "cos", "tan", "asin", "acos", "atan", "exp", "log",
        "neg", "abs_", "atan2", "pow_", "nth_root", "compare", "recip",
        "Tree") if hasattr(T, k)})
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return (shapes.union(*ns["shapes"]) if "shapes" in ns
            and isinstance(ns["shapes"], list) else ns["shape"])


TAPES = {"stress_2d(600)": lambda: shapes.stress_2d(600),
         "stress_2d(1500)": lambda: shapes.stress_2d(1500),
         "extruded": lambda: shapes.extrude_z(shapes.stress_2d(300), -0.4,
                                              0.4),
         "gyroid": lambda: shapes.intersection(shapes.gyroid(0.4, 0.08),
                                               shapes.sphere(0.85))}
TAPES.update({p.name: (lambda n=p.name: _example(n))
              for p in sorted(EXAMPLES.glob("*.py"))
              + sorted(EXAMPLES.glob("*.io"))})
TAPES.update({f"random{k}": (lambda k=k: _RANDOM[k]) for k in range(6)})
LANES = {"stress_2d(1500)": 1000}


def _td(name):
    if name == "all_ops":
        return TapeData.from_tape(Tape.from_arrays(**all_ops_clauses()),
                                  device="cpu")
    return TapeData.from_tape(mpr_tpu_torch.compile_tree(TAPES[name]()),
                              device="cpu")


def _lanes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1.2, 1.2, n).astype(np.float32))
            for _ in range(3)]


def _bits(t):
    return torch.nan_to_num(t, 7.0).view(torch.int32)


def _rows(flat, rows, n):
    """The blocked layout's (rows, n) rows."""
    rows = max(rows, 1)
    nb = -(-n // vp.LANE_BLOCK)
    return flat[:rows * nb * vp.LANE_BLOCK].reshape(
        nb, rows, vp.LANE_BLOCK).transpose(0, 1).reshape(rows, -1)[:, :n]


@pytest.mark.parametrize("name", list(TAPES) + ["all_ops"])
def test_replay_equals_the_tape_order_walk(name):
    """v, the stored values and the choice words of the re-slotted walk
    equal the tape-order walk's bit for bit; the file is far smaller than
    the tape's slots on the chip cells' tapes."""
    td = _td(name)
    plan = td.vjp_plan()[0]
    sp = td.scan_plan()[0]
    n = LANES.get(name, 2000)
    x, y, z = _lanes(n)
    v, vals, words = spm.replay(sp, plan, td.imms, x, y, z)
    pv, pvals, pwords = spm.store_plain(td, x, y, z)
    assert torch.equal(_bits(v), _bits(pv))
    assert torch.equal(_bits(pv), _bits(eval_scan._walk_f(td, x, y, z)))
    assert torch.equal(_bits(vals), _bits(pvals))
    assert torch.equal(words, pwords)
    assert sp.form == "depth" and 1 <= sp.slots <= spm.MAX_FILE
    if name.startswith(("stress", "extruded")):
        assert sp.slots <= 32 < 170 <= td.num_slots
    # the CPU wrapper's plain version fills the store alike
    st = (torch.zeros(vp.blocked_size(plan.n_vals, n)),
          torch.zeros(vp.blocked_size(plan.n_words, n), dtype=torch.int32))
    assert torch.equal(_bits(eval_scan.scan_eval(td, x, y, z, store=st)),
                       _bits(pv))
    assert torch.equal(_bits(st[0]), _bits(pvals))
    assert torch.equal(st[1], pwords)


@pytest.mark.parametrize("name", ["stress_2d(600)", "extruded", "random1",
                                  "all_ops"])
def test_tape_order_form_equals_the_walk(name, monkeypatch):
    """The tape-order form (the clauses in the tape's order, re-slotted
    alike) replays bit for bit too; the plan takes it where depth first
    needs more than ``MAX_FILE`` slots and tape order does not, and
    refuses a tape that neither fits."""
    td = _td(name)
    plan = td.vjp_plan()[0]
    tape = spm._allocate(plan, spm.walk_order(plan, "tape"), "tape")
    assert np.all(np.diff(tape.order) > 0)
    x, y, z = _lanes(700, 1)
    got = spm.replay(tape, plan, td.imms, x, y, z)
    want = spm.store_plain(td, x, y, z)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    depth = spm.scan_plan(plan)
    assert depth.form == "depth" and depth.slots <= tape.slots
    monkeypatch.setattr(spm, "MAX_FILE", depth.slots - 1)
    if tape.slots <= depth.slots - 1:
        assert spm.scan_plan(plan).form == "tape"
    else:
        with pytest.raises(ValueError):
            spm.scan_plan(plan)


def _live_peak(sp, plan):
    """The most file slots in use at one clause of the walk, counted from
    the entries apart from the allocator: the values still to be read
    from the file after it (made before it; the inputs from the start),
    its own value if it goes to the file, and the words open across it
    or opened by it."""
    P = sp.length
    f = sp.fl.astype(np.int64) & 0xFFFFFFFF
    c = (sp.st.astype(np.int64) & 0xFFFFFFFF) >> 16
    pos = {int(t): p for p, t in enumerate(sp.order)}
    last = {plan.result: P}
    for p, t in enumerate(sp.order):
        for k, s in spm._reads(plan, int(t)):
            if not f[p] & (spm.A_ACC, spm.B_ACC)[k]:
                last[s] = max(last.get(s, p), p)
    cnt = np.zeros(P + 1, np.int64)
    for s, q in last.items():
        born = pos[s] if s >= 0 else -1
        cnt[born + 1] += 1
        cnt[q] -= 1
    cnt = np.cumsum(cnt)[:P] + ((f & spm.KEEP) != 0)
    words = {}
    for p in np.flatnonzero(c != spm.NONE16):
        lo, hi = words.get(int(c[p]) >> 4, (p, p))
        words[int(c[p]) >> 4] = (min(lo, p), max(hi, p))
    for lo, hi in words.values():
        if lo < hi:
            cnt[lo:hi + 1] += 1
    inputs = sum(s < 0 for s in last)
    return max(inputs, int(cnt.max(initial=0)))


@pytest.mark.parametrize("name", ["stress_2d(600)", "extruded", "gyroid",
                                  "random0", "random3", "all_ops"])
def test_file_slots_never_collide(name):
    """Replaying the entries with a file that poisons each slot as it is
    freed reads no poisoned slot: each value stays in its slot from its
    clause to its last reader and each word from its first code to its
    last; the allocator uses no more slots than values and words live at
    once."""
    td = _td(name)
    plan = td.vjp_plan()[0]
    sp = td.scan_plan()[0]
    e = np.stack([sp.w, sp.st, sp.fl], 1).astype(np.int64) & 0xFFFFFFFF
    owner = {s: ("in", k) for k, s in enumerate(sp.inputs) if s >= 0}
    for p, t in enumerate(sp.order):
        w, st, f = e[p]
        reads = spm._reads(plan, int(t))
        for k, s in reads:
            if f & (spm.A_ACC, spm.B_ACC)[k]:
                assert s >= 0 and sp.order[p - 1] == s
            else:
                slot = int(w >> (16 + 8 * k)) & 0xFF
                want = ("in", -1 - s) if s < 0 else ("v", s)
                assert owner.get(slot) == want, (p, k, slot)
        if f & spm.KEEP:                 # the kernel's order: value first
            owner[int(w >> 8) & 0xFF] = ("v", int(t))
        if st >> 16 != spm.NONE16:
            ws, wd = int(f >> 8) & 0xFF, int(st >> 20)
            if not f & spm.W_FIRST:
                assert owner.get(ws) == ("w", wd)
            if not f & spm.W_LAST:
                owner[ws] = ("w", wd)
    res = plan.result
    assert owner.get(sp.result) == (("v", res) if res >= 0
                                    else ("in", -1 - res))
    assert sp.slots == _live_peak(sp, plan)


@pytest.mark.parametrize("name", ["stress_2d(600)", "extruded", "gyroid",
                                  "random2", "random4", "csg_demo.py"])
def test_walk_matches_mpr_tpu_eval_f(name):
    """The re-slotted walk's result against ``mpr_tpu``'s interpreter
    (``mpr_tpu.ops.eval_scan.eval_f``): bit for bit where the tape has no
    op whose CPU rounding differs from XLA's, else within ``ULPS``."""
    td = _td(name)
    plan = td.vjp_plan()[0]
    sp = td.scan_plan()[0]
    x, y, z = _lanes(1500, 2)
    v = spm.replay(sp, plan, td.imms, x, y, z)[0].numpy()
    jd = jtd.TapeData.from_tape(_jtape(td))
    want = np.asarray(jes.eval_f(jd, x.numpy(), y.numpy(), z.numpy()))
    ops = set(plan.ops.tolist())
    if ops & INEXACT_OPS:
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(v))
        gap = np.abs(v[fin] - want[fin])
        assert (gap <= ULPS * np.spacing(np.abs(want[fin])) + 1e-6).all()
    else:
        assert np.array_equal(v.view(np.int32), want.view(np.int32))


def _jtape(td):
    w = td.packed[:td.length].numpy().astype(np.int64) & 0xFFFFFFFF
    return JTape(ops=(w & 0xFF).astype(np.uint8),
                 outs=((w >> 8) & 0xFF).astype(np.uint8),
                 lhss=((w >> 16) & 0xFF).astype(np.uint8),
                 rhss=(w >> 24).astype(np.uint8),
                 imms=td.imms[:td.length].numpy(),
                 axis_slots=td.axis_slots, result_slot=td.result_slot,
                 num_slots=td.num_slots, num_choices=td.num_choices)


@pytest.mark.parametrize("name", ["stress_2d(600)", "random0", "random5",
                                  "all_ops"])
def test_k2_from_the_replayed_store_matches_jax_grad(name):
    """K2's algorithm (``vjp_plan.replay_k2``) on the store the re-slotted
    walk fills equals ``jax.grad`` of ``mpr_tpu``'s ``eval_f`` within
    1e-5 of the largest component."""
    td = _td(name)
    plan = td.vjp_plan()[0]
    sp = td.scan_plan()[0]
    n = 257
    x, y, z = _lanes(n, 3)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=n).astype(
        np.float32))
    _, vals, words = spm.replay(sp, plan, td.imms, x, y, z)
    vals = _rows(vals, plan.n_vals, n)
    words = _rows(words.to(torch.int64) & 0xFFFFFFFF, plan.n_words, n)
    got = vp.replay_k2(plan, td.packed.numpy(), td.imms.numpy(), vals,
                       words, x, y, z, g, td.num_slots,
                       td.result_slot).numpy()
    jd = jtd.TapeData.from_tape(_jtape(td))
    xs, ys, zs, gs = (a.numpy() for a in (x, y, z, g))
    want = np.asarray(jax.grad(lambda im: jnp.sum(jes.eval_f(
        jd.replace_imms(im), xs, ys, zs) * gs))(jd.imms))[:td.length]
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= GRAD_TOL * scale


# ---- launch shapes ----------------------------------------------------------

def test_scan_launch_picks():
    """K = 1 for the scan fit's 65,536 lanes, K = 4 for a brute frame's
    2^20 and a slab's 2^22, at the threads that leave an SM the most
    warps (128 at a tie); a file too large for K = 4 takes K = 1; every
    pick is a shape of the sweep, and every shape of the sweep is some
    cell's pick."""
    picks = {"fit": ln.scan_launch(21, 65536),
             "brute 1024^2": ln.scan_launch(21, 1 << 20),
             "brute 2048^2": ln.scan_launch(24, 1 << 22),
             "gyroid slab": ln.scan_launch(7, 1 << 22),
             "extruded slab": ln.scan_launch(22, 1 << 22),
             "a small file": ln.scan_launch(1, 1000)}
    assert picks == {"fit": ln.ScanLaunch(256, 1),
                     "brute 1024^2": ln.ScanLaunch(128, 4),
                     "brute 2048^2": ln.ScanLaunch(256, 4),
                     "gyroid slab": ln.ScanLaunch(256, 4),
                     "extruded slab": ln.ScanLaunch(128, 4),
                     "a small file": ln.ScanLaunch(128, 1)}
    assert set(picks.values()) == set(ln.SCAN_SWEEP)
    assert ln.scan_launch(256, 1 << 22) == ln.ScanLaunch(128, 1)
    for slots in (1, 21, 256):
        for n in (1, 65536, 1 << 22):
            shape = ln.scan_launch(slots, n)
            assert shape in ln.SCAN_SWEEP
            assert shape.smem(slots) <= ln.SMEM_LIMIT
    # forced: the missing part defaults
    assert ln.scan_launch(21, 10, k=4) == ln.ScanLaunch(128, 4)
    assert ln.scan_launch(21, 10, threads=256) == ln.ScanLaunch(256, 1)


@pytest.mark.parametrize("threads,k,slots", [(64, 1, 21), (128, 8, 21),
                                             (512, 1, 21), (128, 2, 21),
                                             (256, 4, 256)])
def test_scan_launch_refuses_shapes_outside_the_sweep(threads, k, slots):
    with pytest.raises(ValueError):
        ln.scan_launch(slots, 65536, threads=threads, k=k)
    with pytest.raises(ValueError):
        ln.check_scan_launch(ln.ScanLaunch(threads, k), slots)


def test_scan_blocks_cover_the_lanes_within_the_card():
    for shape in ln.SCAN_SWEEP:
        for n in (1, 127, 65536, 1 << 22):
            b = ln.scan_blocks(shape, 21, n)
            assert 1 <= b <= -(-n // shape.lanes)
            assert b <= ln.SM_COUNT * ln.SM_THREADS // shape.threads
