"""PyTorch port: the statement plan of the generated float, interval and
deriv kernels (``ops/unrolled_plan.py``) and their launch forms, on the CPU.

The generated kernels run the recorded statements in one of three forms
(``ops/launch.py::unrolled_launch``): serial (tape order), lanes (the
register-pressure schedule) and split (the tape cut among the warps of a
block).  The CUDA kernels need the card (tests/test_torch_gpu.py); here
their plans are checked for structure (every statement once, each operand
before its reader, each part reading only its own statements), and their
plain replays in PyTorch are held against the evaluator's plain walk
(``UnrolledEval.plain``) bit for bit, NaNs in the same places: a replay
runs the same float32 operations, only in another order and place.  The
plain walk itself is held against ``mpr_tpu``'s evaluator at one size, with
tests/test_torch_unrolled.py's tolerances.

Inputs are made with numpy from a seed; a tenth of the lanes hold +-0,
+-inf or NaN.
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax

from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as JT
from mpr_tpu.ops import unrolled_eval as jue
from mpr_tpu.tape.tape import compile_tree as jcompile

import mpr_tpu_torch
from mpr_tpu_torch import config
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.ops import launch as ln
from mpr_tpu_torch.ops import unrolled_eval as ue
from mpr_tpu_torch.ops import unrolled_plan as up
from mpr_tpu_torch.tape.opcodes import Op
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (all_ops_clauses, one_torch_thread,  # noqa: F401
                              random_trees)

KINDS = ("float", "interval", "deriv")
_PRAND = random_trees(T, mpr_tpu_torch.compile_tree, 8)
_JRAND = random_trees(JT, jcompile, 8)
_TAPES = {}


def _tape(name):
    if name not in _TAPES:
        if name == "all_ops":
            t = Tape.from_arrays(**all_ops_clauses())
        elif name.startswith("random"):
            t = mpr_tpu_torch.compile_tree(_PRAND[int(name[6:])])
        else:
            t = mpr_tpu_torch.compile_tree({
                "stress12": lambda: shapes.stress_2d(12),
                "stress600": lambda: shapes.stress_2d(600),
                "extruded": lambda: shapes.extrude_z(shapes.stress_2d(300),
                                                     -0.4, 0.4),
                "gyroid": lambda: shapes.intersection(
                    shapes.gyroid(0.4, 0.08), shapes.sphere(0.85))}[name]())
        _TAPES[name] = t
    return _TAPES[name]


NAMES = ["all_ops"] + [f"random{k}" for k in range(8)] + ["stress12",
                                                          "gyroid"]


def _lanes(kind, n=2048, seed=7):
    """Seeded lanes, a tenth of them +-0, +-inf or NaN."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)

    def plane():
        v = rng.uniform(-1.5, 1.5, n).astype(np.float32)
        m = rng.random(n) < 0.1
        v[m] = rng.choice(special, int(m.sum()))
        return v
    x, y, z = plane(), plane(), plane()
    if kind != "interval":
        return [torch.from_numpy(v) for v in (x, y, z)]
    w = rng.uniform(0.0, 0.6, (3, n)).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, x + w[0], y, y + w[1], z,
                                          z + w[2])]


def _bits_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        assert torch.equal(g.view(torch.int32)[~nan],
                           w.view(torch.int32)[~nan])


def _evaluator(kind, tape, take):
    return {"float": ue.build_float, "interval": ue.build_interval,
            "deriv": ue.build_deriv}[kind](tape, take)


def _imms(ev):
    return (torch.as_tensor(ev.tape.imms, dtype=torch.float32)
            if ev.take_imms else None)


def _reads_before(order, defined=()):
    """Every operand of ``order`` is made earlier in it (or in
    ``defined``)."""
    seen = set(defined)
    for s in order:
        for a in up.operands(s):
            assert a in seen, (s, a)
        assert s.name not in seen or s.op == "part", s
        seen.add(s.name)
    return seen


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
@pytest.mark.parametrize("name", NAMES + ["extruded"])
@pytest.mark.parametrize("kind", KINDS)
def test_the_schedule_is_a_topological_order_of_the_same_statements(
        kind, name, take):
    prog = _evaluator(kind, _tape(name), take).program()
    order = up.schedule(prog.stmts, prog.outs)
    assert sorted(s.name for s in order) == sorted(s.name for s in
                                                   prog.stmts)
    assert sorted(map(repr, order)) == sorted(map(repr, prog.stmts))
    _reads_before(order)
    # each clause's statements stay together, in walk order
    pos = {s.name: i for i, s in enumerate(order)}
    for c in {s.clause for s in prog.stmts if s.clause >= 0}:
        p = [pos[s.name] for s in prog.stmts if s.clause == c]
        assert p == list(range(p[0], p[0] + len(p))), c


@pytest.mark.parametrize("name,most", [("extruded", 10), ("stress600", 12)])
def test_the_schedule_keeps_a_dozen_values_live_where_tape_order_keeps_170(
        name, most):
    prog = ue.build_float(_tape(name)).program()
    assert up.live_peak(prog.stmts, prog.outs) == 170
    assert up.live_peak(up.schedule(prog.stmts, prog.outs),
                        prog.outs) <= most


@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
@pytest.mark.parametrize("name,tape_order", [("extruded", 503),
                                             ("stress600", 515)])
def test_the_deriv_schedule_keeps_under_64_values_live_where_tape_order_keeps_500(
        name, tape_order, take):
    """Dual numbers hold four values a clause: tape order keeps about 500
    live on the chip cells' tapes, the schedule under 64 (39 and 43)."""
    prog = ue.build_deriv(_tape(name), take).program()
    assert up.live_peak(prog.stmts, prog.outs) == tape_order
    assert up.live_peak(up.schedule(prog.stmts, prog.outs), prog.outs) < 64


@pytest.mark.parametrize("name", NAMES + ["extruded"])
@pytest.mark.parametrize("kind", KINDS)
def test_the_schedule_keeps_no_more_values_live_than_tape_order(kind, name):
    """On every tape of these tests, the float, interval and dual-number
    forms alike, Sethi-Ullman's order keeps at most as many values live
    as tape order does."""
    prog = _evaluator(kind, _tape(name), False).program()
    order = up.schedule(prog.stmts, prog.outs)
    assert up.live_peak(order, prog.outs) <= up.live_peak(prog.stmts,
                                                          prog.outs)


def test_live_peak_counts_values_between_statements():
    s = [up.Stmt("a", "float", "in", (0,), -1),
         up.Stmt("b", "float", "mul", ("a", 2.0), 0),
         up.Stmt("c", "float", "add", ("a", 1.0), 1),
         up.Stmt("d", "float", "add", ("b", "c"), 2),
         up.Stmt("e", "float", "neg", ("a",), 3)]
    # b and c live across the point before d; d and then e to the end
    assert up.live_peak(s, ("d", "e")) == 2
    assert up.live_peak(s, ("d",)) == 2
    assert up.live_peak(s[:2], ("b",)) == 1


def test_an_unread_clause_follows_the_last_clause_it_reads():
    s = [up.Stmt("x", "float", "in", (0,), -1),
         up.Stmt("a", "float", "mul", ("x", 2.0), 0),
         up.Stmt("b", "float", "add", ("x", 1.0), 1),
         up.Stmt("dead", "float", "mul", ("a", 3.0), 2),
         up.Stmt("c", "float", "nmin", ("a", "b"), 3)]
    order = [t.name for t in up.schedule(s, ("c",))]
    assert order == ["x", "a", "dead", "b", "c"]


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------

def _check_split(prog, sp, P):
    assert 1 <= sp.warps <= P and len(sp.parts) == P
    assert all(not p.order for p in sp.parts[sp.warps:])
    made, slots = set(), {}
    for p in sp.parts:
        # a part reads inputs, immediates and its own statements only
        assert all(s.op != "part" for s in p.order)
        made |= _reads_before(p.order)
        own = {s.name for s in p.order}
        for n, k in p.outs:
            assert n in own and k not in slots
            slots[k] = n
    assert sorted(slots) == list(range(sp.n_slots)) and sp.n_slots \
        <= up.MAX_SLOTS
    # the top reads the parts' results (its "part" loads) and its own
    # statements only
    for s in sp.top:
        if s.op == "part":
            assert slots[s.args[0]] == s.name
    _reads_before(sp.top)
    top = {s.name for s in sp.top if s.op not in ("part", "in")}
    assert {s.clause for s in sp.top if s.op not in ("part", "in")} \
        == set(sp.top_clauses)
    # every statement is made, the top's apart from the parts'
    loads = {s.name for s in sp.top if s.op == "in"}
    assert made | top | loads == {s.name for s in prog.stmts}
    assert not made & top
    for o in sp.outs:
        assert isinstance(o, float) or o in {s.name for s in sp.top}
    # a statement two parts share is computed in each: counted
    copies = {}
    for p in sp.parts:
        for s in p.order:
            if s.op != "in":
                copies[s.name] = copies.get(s.name, 0) + 1
    assert sp.duplicated() == sum(c > 1 for c in copies.values())
    assert sp.longest() == max(
        [len(p.order) for p in sp.parts[1:]]
        + [len(sp.parts[0].order) + len(sp.top)])


@pytest.mark.parametrize("P", [1, 4, 32])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", KINDS)
def test_the_split_covers_every_statement_and_parts_read_their_own(
        kind, name, P):
    for take in (False, True):
        prog = _evaluator(kind, _tape(name), take).program()
        _check_split(prog, up.split(prog, P), P)


@pytest.mark.parametrize("name", ["extruded", "stress600"])
def test_the_split_of_the_chip_cells_tapes(name):
    """32 warps, none shares a statement, and the longest walks a few
    percent of the tape."""
    for kind in KINDS:
        prog = _evaluator(kind, _tape(name), False).program()
        sp = up.split(prog, 32)
        _check_split(prog, sp, 32)
        assert sp.warps == 32 and sp.duplicated() == 0
        assert sp.longest() <= len(prog.stmts) // 8
        assert len(sp.top_clauses) <= 4 * 32


def test_a_shared_subtree_is_computed_in_each_part_that_reads_it():
    """min(s + 1, s * 2) with s = sqrt(x): cut at the min, both parts
    compute s."""
    prog = up.Program([up.Stmt("x", "float", "in", (0,), -1),
                       up.Stmt("s", "float", "sqrtf", ("x",), 0),
                       up.Stmt("a", "float", "add", ("s", 1.0), 1),
                       up.Stmt("b", "float", "mul", ("s", 2.0), 2),
                       up.Stmt("c", "float", "nmin", ("a", "b"), 3)], ("c",))
    sp = up.split(prog, 2)
    _check_split(prog, sp, 2)
    assert sp.top_clauses == [3] and sp.duplicated() == 1
    assert sorted([s.name for s in p.order] for p in sp.parts) == [
        ["x", "s", "a"], ["x", "s", "b"]]
    x = torch.tensor([4.0, -1.0, 0.0, np.inf, np.nan])
    _bits_equal(up.replay_split(sp, [x]),
                (torch.minimum(torch.sqrt(x) + 1.0, torch.sqrt(x) * 2.0),))


# ---------------------------------------------------------------------------
# the replays against the plain walk
# ---------------------------------------------------------------------------

FORMS = ["schedule", "split4", "split32"]
FLAGS = [{}, {"fast_transcendentals": True}]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", KINDS)
def test_the_replay_of_each_form_equals_the_plain_walk(kind, name, take,
                                                       form):
    ev = _evaluator(kind, _tape(name), take)
    ins = _lanes(kind)
    want = ev.plain(*ins, imms=_imms(ev))
    want = want if isinstance(want, tuple) else (want,)
    prog = ev.program()
    if form == "schedule":
        env = up.replay(up.schedule(prog.stmts, prog.outs), ins, _imms(ev))
        got = up.outputs(env, prog.outs, ins[0])
    else:
        got = up.replay_split(up.split(prog, int(form[5:])), ins, _imms(ev))
    _bits_equal(got, want)


@pytest.mark.parametrize("flag", ["tight_sincos", "widen_intervals",
                                  "fast_transcendentals"])
@pytest.mark.parametrize("form", FORMS)
def test_the_replays_under_config_flags(flag, form):
    """The flags that change the interval and float statements."""
    with config.override(**{flag: True}):
        evs = [_evaluator(k, _tape("all_ops"), take) for k in KINDS
               for take in (False, True)]
    for ev in evs:
        ins = _lanes(ev.kind, seed=11)
        want = ev.plain(*ins, imms=_imms(ev))
        want = want if isinstance(want, tuple) else (want,)
        prog = ev.program()
        if form == "schedule":
            got = up.outputs(up.replay(up.schedule(prog.stmts, prog.outs),
                                       ins, _imms(ev)), prog.outs, ins[0])
        else:
            got = up.replay_split(up.split(prog, int(form[5:])), ins,
                                  _imms(ev))
        _bits_equal(got, want)


def test_a_part_that_reads_another_parts_statement_fails_its_replay():
    """The replay gives each part only its own statements: a part that
    depended on another's would raise, which is what the replays above
    rule out."""
    prog = ue.build_float(_tape("stress12")).program()
    sp = up.split(prog, 4)
    a, b = [p for p in sp.parts if p.outs][:2]
    victim = next(s for s in b.order if s.op not in ("in",))
    a.order.append(up.Stmt("probe", "float", "add", (victim.name, 1.0), -2))
    with pytest.raises(KeyError):
        up.replay_split(sp, _lanes("float"))


def test_the_plain_walk_and_its_replays_agree_with_mpr_tpu():
    """mpr_tpu's evaluator (XLA under jit) against the port's plain walk
    and its scheduled replay on one tape without inexact ops, bit for bit
    but for the sign of a zero (tests/test_torch_unrolled.py)."""
    k = 2
    jtape, ptape = jcompile(_JRAND[k]), mpr_tpu_torch.compile_tree(_PRAND[k])
    rng = np.random.default_rng(3)
    x, y, z = (rng.uniform(-1.5, 1.5, 4000).astype(np.float32)
               for _ in range(3))
    for kind, jb in (("float", jue.build_float),
                     ("interval", jue.build_interval),
                     ("deriv", jue.build_deriv)):
        args = [x, y, z] if kind != "interval" else [x, x + 0.25, y,
                                                     y + 0.25, z, z + 0.25]
        want = jax.jit(jb(jtape))(*args)
        want = want if isinstance(want, tuple) else (want,)
        ev = _evaluator(kind, ptape, False)
        ins = [torch.from_numpy(np.asarray(a)) for a in args]
        plain = ev.plain(*ins)
        plain = plain if isinstance(plain, tuple) else (plain,)
        prog = ev.program()
        got = up.outputs(up.replay(up.schedule(prog.stmts, prog.outs), ins),
                         prog.outs, ins[0])
        for g, p, w in zip(got, plain, want):
            w = np.asarray(w)
            assert np.array_equal(np.isnan(g.numpy()), np.isnan(w))
            m = ~np.isnan(w)
            assert np.array_equal(p.numpy()[m], w[m])
            assert np.array_equal(g.numpy()[m], w[m])
    assert set(ptape.ops.tolist()) & {3, 5, 6, 7, 8, 9, 10, 12, 30} == set()


# tests/test_torch_unrolled.py's limits of the dual-number form on a tape
# with an inexact op: N ulp of mpr_tpu's value and a floor
DERIV_ULPS, DERIV_FLOOR = 12, 4e-6


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
def test_the_deriv_replays_agree_with_mpr_tpu_on_the_gyroid(take, form):
    """mpr_tpu's build_deriv (XLA under jit) against the scheduled and
    split replays of the port's deriv program on the gyroid model (sin,
    cos, sqrt): NaNs and infinities in the same places, elsewhere within
    12 ulp of mpr_tpu's value and 4e-6."""
    jtape = jcompile(jshapes.intersection(jshapes.gyroid(0.4, 0.08),
                                          jshapes.sphere(0.85)))
    rng = np.random.default_rng(13)
    args = [rng.uniform(-1.2, 1.2, 4000).astype(np.float32)
            for _ in range(3)]
    jkw = {"imms": jax.numpy.asarray(jtape.imms)} if take else {}
    want = jax.jit(lambda *a, **k: jue.build_deriv(jtape, take)(*a, **k))(
        *args, **jkw)
    ev = ue.build_deriv(_tape("gyroid"), take)
    ins = [torch.from_numpy(a) for a in args]
    prog = ev.program()
    if form == "schedule":
        got = up.outputs(up.replay(up.schedule(prog.stmts, prog.outs), ins,
                                   _imms(ev)), prog.outs, ins[0])
    else:
        got = up.replay_split(up.split(prog, int(form[5:])), ins, _imms(ev))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        m = ~np.isnan(w)
        g, w = g[m], w[m]
        fin = np.isfinite(w)
        assert np.array_equal(g[~fin], w[~fin])
        lim = DERIV_ULPS * np.spacing(np.abs(w[fin])).astype(np.float64) \
            + DERIV_FLOOR
        assert np.all(np.abs(g[fin].astype(np.float64) - w[fin]) <= lim)


# ---------------------------------------------------------------------------
# the sources and the launch picker
# ---------------------------------------------------------------------------

def test_lane_invariant_statements_are_the_immediates_and_what_they_feed():
    prog = ue.build_float(_tape("all_ops"), True).program()
    inv = up.lane_invariant(prog.stmts)
    imm = {s.name for s in prog.stmts if s.op == "imm"}
    assert imm <= inv
    assert all(s.op != "in" for s in prog.stmts if s.name in inv)
    # a baked tape of lane operations has none
    assert not up.lane_invariant(ue.build_float(_tape("stress12"))
                                 .program().stmts)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_the_lanes_source_writes_each_statement_for_k_lanes(k):
    tape = _tape("all_ops")
    ev = ue.build_float(tape, take_imms=True)
    src = ev.source(ln.UnrolledLaunch("lanes", k=k))
    prog = ev.program()
    inv = up.lane_invariant(prog.stmts)
    # an immediate is read once for the thread's k lanes
    assert src.count("__ldg(imms + ") == tape.length
    for s in prog.stmts:
        if s.name in inv:
            assert f" {s.name} = " in src
        else:
            for j in range(k):
                assert f" {s.name}_{j} = " in src
            assert f" {s.name}_{k} = " not in src
    assert f"MPR_BLOCK_LANES {128 * k}" in src and "MPR_RESIDENT" not in src
    assert "asm volatile" in src
    assert "mpr_min_nan(" in src and "nmin(" not in src
    assert "asm volatile" not in ue.build_float(tape).source(
        ln.UnrolledLaunch("lanes", k=k))


@pytest.mark.parametrize("k", [1, 2])
def test_the_deriv_lanes_source_stores_four_planes_for_k_lanes(k):
    """A dual number's four outputs (value, d/dx, d/dy, d/dz) for each of
    a thread's k lanes, min/max as selects (no min.NaN: ``_DerivSem``
    picks an operand with < / >), the immediates read once."""
    tape = _tape("all_ops")
    ev = ue.build_deriv(tape, take_imms=True)
    src = ev.source(ln.UnrolledLaunch("lanes", k=k))
    assert src.count("__ldg(imms + ") == tape.length
    assert f"MPR_BLOCK_LANES {128 * k}" in src and "MPR_RESIDENT" not in src
    # launch bounds of one block an SM at least: the registers it needs
    assert "#define MPR_MIN_BLOCKS 1" in src
    assert "MPR_MIN_BLOCKS" not in ue.build_float(tape).source(
        ln.UnrolledLaunch("lanes", k=k))
    for j in range(k):
        for q in range(4):
            assert src.count(f"out{q}[l{j}] = ") == 1
    assert "out4" not in src and f"out0[l{k}]" not in src
    assert "nmin(" not in src and "mpr_min_nan(" not in src


@pytest.mark.parametrize("take", [False, True], ids=["baked", "imms"])
def test_a_dual_numbers_sine_and_cosine_are_one_sincosf(take):
    """A deriv sin or cos clause takes sinf and cosf of one operand: the
    lanes and split forms write the pair as one sincosf call (for each of
    a thread's lanes), the serial first design and the float and interval
    kernels (no such pair in one clause) keep sinf and cosf."""
    tape = _tape("gyroid")
    trig = sum(op in (Op.SIN_LHS, Op.COS_LHS) for op in tape.ops.tolist())
    assert trig == 6
    ev = ue.build_deriv(tape, take)
    for form in ([ln.UnrolledLaunch("lanes", k=k)
                  for k in ln.UNROLLED_KS["deriv"]]
                 + [ln.UnrolledLaunch("split", parts=p)
                    for p in ln.UNROLLED_PARTS]):
        src = ev.source(form)
        assert src.count("sincosf(") == trig * form.k, form
        assert " sinf(" not in src and " cosf(" not in src, form
    serial = ev.source(ln.UnrolledLaunch("serial"))
    assert "sincosf(" not in serial and serial.count(" sinf(") == trig
    for kind in ("float", "interval"):
        src = _evaluator(kind, tape, take).source(
            ln.UnrolledLaunch("lanes", k=1))
        assert "sincosf(" not in src


@pytest.mark.parametrize("P", [4, 32])
def test_the_split_source_has_a_case_a_warp_and_the_top_on_warp_0(P):
    tape = _tape("stress12")
    for kind in KINDS:
        ev = _evaluator(kind, tape, False)
        sp = up.split(ev.program(), P)
        src = ev.source(ln.UnrolledLaunch("split", parts=P))
        assert f"#define MPR_BLOCK_THREADS {32 * sp.warps}" in src
        assert src.count("  case ") == sp.warps
        assert "__syncthreads();" in src and "MPR_BLOCK_LANES 32" in src
        assert src.count("mpr_part[") == 2 * sp.n_slots + 1


def test_the_serial_form_is_the_first_design():
    tape = _tape("all_ops")
    src = ue.build_float(tape).source(ln.UnrolledLaunch("serial"))
    assert "MPR_UNROLLED_KERNEL" in src and "nmin(" in src
    assert "mpr_min_nan" not in src
    assert src == ue.generate(tape, "float", False, ue._flags())


def test_each_form_has_its_own_library_key_and_the_defaults_build():
    tape = _tape("stress12")
    f, fi, fd = (ue.build_float(tape), ue.build_interval(tape),
                 ue.build_deriv(tape))
    for ev in (f, fi):
        keys = [k.key for k in ev.kernels()]
        k = (ln.UNROLLED_K_SHORT if ev.short else ln.UNROLLED_K)[ev.kind]
        assert keys == [f"{ev.key}-split-p{ln.UNROLLED_P}",
                        f"{ev.key}-lanes-k{k}"]
        assert ev.kernel(ln.UnrolledLaunch("serial")).key == \
            f"{ev.key}-serial"
        assert ev.kernel(ln.UnrolledLaunch("split", parts=32)) is \
            ev.kernel(ln.UnrolledLaunch("split", parts=32))
    keys = [k.key for k in fd.kernels()]
    assert not fd.short and keys == [
        f"{fd.key}-split-p{ln.UNROLLED_P}",
        f"{fd.key}-lanes-k{ln.UNROLLED_K['deriv']}"]
    # the first design is a forced form of its own library
    assert fd.kernel(ln.UnrolledLaunch("serial")).key == f"{fd.key}-serial"
    assert fd.kernel(ln.UnrolledLaunch("serial")).source() == ue.generate(
        tape, "deriv", False, ue._flags())
    for form in ([ln.UnrolledLaunch("lanes", k=k)
                  for k in ln.UNROLLED_KS["deriv"]]
                 + [ln.UnrolledLaunch("split", parts=p)
                    for p in ln.UNROLLED_PARTS]):
        assert fd.kernel(form).key == f"{fd.key}-{form.tag}"
    with pytest.raises(ValueError):
        fd.kernel(ln.UnrolledLaunch("lanes", k=4))


@pytest.mark.parametrize("module", [up, ln])
def test_the_library_key_follows_the_schedule_and_launch_modules(
        module, tmp_path, monkeypatch):
    """The schedule, the split and the block size baked into every source
    come from these modules: an edit of either must give new keys, or an
    old build would be loaded."""
    before = ue._generator_hash()
    copy = tmp_path / Path(module.__file__).name
    copy.write_bytes(Path(module.__file__).read_bytes() + b"\n# edited\n")
    monkeypatch.setattr(module, "__file__", str(copy))
    assert ue._generator_hash() != before


@pytest.mark.parametrize("name,short", [("gyroid", True), ("all_ops", True),
                                        ("extruded", False),
                                        ("stress600", False)])
def test_a_tape_bound_by_bytes_is_short(name, short):
    """Short: at most OPS_PER_BYTE float operations a byte a lane moves
    (16 bytes a float lane, 32 an interval one, 28 a deriv one).  The
    all-opcodes tape's dual numbers (317 operations a lane, over 280) are
    not short where its float and interval forms are."""
    for kind in KINDS:
        if kind == "deriv" and name == "all_ops":
            short = False
        ev = _evaluator(kind, _tape(name), False)
        ops = up.float_ops(ev.program())
        limit = ln.OPS_PER_BYTE * 4 * (ue.N_IN[kind] + ue.N_OUT[kind])
        assert ev.short == (ops <= limit) == short, (kind, ops)
        k = (ln.UNROLLED_K_SHORT if short else ln.UNROLLED_K)[kind]
        assert ev.launch(10 ** 7) == ln.UnrolledLaunch("lanes", k=k)
        assert ev.launch(10) == ln.UnrolledLaunch("split",
                                                  parts=ln.UNROLLED_P)


@pytest.mark.parametrize("kind", KINDS)
def test_unrolled_launch_picks_split_under_a_wave_and_lanes_above(kind):
    wave = ln.UNROLLED_WAVE
    assert wave == ln.SM_COUNT * ln.UNROLLED_WAVE_WARPS * 32
    for short in (False, True):
        k = (ln.UNROLLED_K_SHORT if short else ln.UNROLLED_K)[kind]
        for n in (1, 31, 256, 512, 15_552, 20_928, wave - 1):
            assert ln.unrolled_launch(n, kind, short) == ln.UnrolledLaunch(
                "split", parts=ln.UNROLLED_P)
        for n in (wave, wave + 1, 225_024, 659_648, 9_289_664):
            assert ln.unrolled_launch(n, kind, short) == ln.UnrolledLaunch(
                "lanes", k=k)
        assert ln.unrolled_defaults(kind, short) == [
            ln.unrolled_launch(1, kind, short),
            ln.unrolled_launch(wave, kind, short)]
    # the chip cells' launches: both 2D interval launches and the first 3D
    # one split, the extruded float launch in lanes, the normals of both 3D
    # cells in lanes, a small mesh's normals split
    if kind == "interval":
        assert {ln.unrolled_launch(n, kind).form
                for n in (256, 15_552, 512)} == {"split"}
    elif kind == "deriv":
        assert {ln.unrolled_launch(n, kind).form
                for n in (237_568, 724_992)} == {"lanes"}
        assert ln.unrolled_launch(4_000, kind).form == "split"
    else:
        assert ln.unrolled_launch(9_289_664, kind).form == "lanes"
    # K1's forward half is serial only
    for kind2 in ("vjpf", "vjp"):
        assert ln.unrolled_launch(10 ** 7, kind2) == ln.UnrolledLaunch(
            "serial")


@pytest.mark.parametrize("kind", KINDS)
def test_unrolled_launch_forces_a_shape_and_refuses_one_that_does_not_fit(
        kind):
    for k in ln.UNROLLED_KS[kind]:
        assert ln.unrolled_launch(10, kind, k=k) == ln.UnrolledLaunch(
            "lanes", k=k)
    for p in ln.UNROLLED_PARTS:
        assert ln.unrolled_launch(10 ** 8, kind, parts=p) == \
            ln.UnrolledLaunch("split", parts=p)
    assert ln.unrolled_launch(5, kind, form="serial") == ln.UnrolledLaunch(
        "serial")
    assert ln.unrolled_launch(5, kind, form="lanes").k == ln.UNROLLED_K[kind]
    bad = [dict(k=3), dict(k=8), dict(parts=64), dict(parts=3),
           dict(parts=1), dict(parts=2), dict(parts=16),
           dict(form="split", k=2), dict(form="lanes", parts=4),
           dict(form="serial", k=2), dict(form="warp")]
    if kind != "float":
        bad.append(dict(k=4))
    for kw in bad:
        with pytest.raises(ValueError):
            ln.unrolled_launch(1000, kind, **kw)
    with pytest.raises(ValueError):
        ln.unrolled_launch(1000, "vjpf", form="lanes")
    with pytest.raises(ValueError):
        ln.check_unrolled_launch(ln.UnrolledLaunch("split", parts=32),
                                 "vjpf")
