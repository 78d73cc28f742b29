"""PyTorch port: differentiable fitting against mpr_tpu's, on the CPU.

The five fit steps of ``mpr_tpu_torch/parallel/sharded.py`` (interpreter,
unrolled dense, culled, 3D dense, 3D window) against ``mpr_tpu``'s on the
same tape, target and camera, one device each.  On the CPU the port's
steps differentiate its plain walks, the plain versions of kernels K1
(unrolled) and K2 (interpreter); ``tests/test_torch_gpu.py`` holds the
kernels to these on the card.

Tolerances:
  * the first step's loss within 1e-6 relative: the two sum the same
    per-pixel terms in another order (measured: at most 6e-7);
  * gradients within 1e-5 of the largest component: sum order again,
    and the rounding form of a few rules (``jax.grad`` writes the sqrt
    rule ``g * (0.5 / r)``, torch ``g / (2 r)``; measured at most 1e-7);
  * a 5-step trajectory of losses within 2e-6 relative: the first step's
    1e-6, and the parameters moved by last-bit different gradients;
  * each opcode's rule against ``jax.grad``: NaN and infinities in the
    same places, finite partials within 4e-7 relative (a few ulp: the
    exp and division rules round differently; measured 1.2e-7).

A gradient is read from one step at ``lr = 2**20`` (``(imms - new) /
lr``): the step is the package's public contract, and at that rate the
update dominates the immediates, so the difference recovers the gradient
to float32 precision.
"""

import dataclasses
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import mpr_tpu
from mpr_tpu import cli as jcli
from mpr_tpu import oracle as joracle
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.io import checkpoint as jckpt
from mpr_tpu.ops import eval_scan as jes
from mpr_tpu.ops import tape_data as jtd
from mpr_tpu.ops import unrolled_eval as jue
from mpr_tpu.parallel import sharded as jsh
from mpr_tpu.render import camera as jcam
from mpr_tpu.tape.tape import Tape as JTape

import mpr_tpu_torch
from mpr_tpu_torch import cli
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.io import checkpoint
from mpr_tpu_torch.ops import eval_scan, kernels, unrolled_eval as ue
from mpr_tpu_torch.ops import vjp_plan as vp
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.parallel import sharded
from mpr_tpu_torch.tape.opcodes import Op
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (all_ops_clauses, one_torch_thread,  # noqa: F401
                              random_trees)

SIZE, SIZE_CULLED, GRID, WSIZE = 64, 128, 16, 64
PROBE_LR = 2.0 ** 20
STEPS = 5
ENGINES = ["scan", "unrolled", "culled", "3d", "window"]
LOSS_RTOL, GRAD_TOL, TRAJ_RTOL, RULE_RTOL = 1e-6, 1e-5, 2e-6, 4e-7


def _tree2(S):
    return S.stress_2d(6)


def _tree3(S):
    return S.union(S.sphere(0.5), S.sphere(0.3, cx=0.4))


def _tree_params(S, Tm, mode):
    """A shape with a named parameter (frontend var())."""
    if mode == "2d":
        r = Tm.var("r", 0.45)
        return S.union(Tm.sqrt(Tm.square(Tm.x() - 0.1) + Tm.square(Tm.y()))
                       - r, S.circle(0.2, cx=-0.5))
    r = Tm.var("r", 0.5)
    return S.union(Tm.sqrt(Tm.square(Tm.x()) + Tm.square(Tm.y())
                           + Tm.square(Tm.z())) - r,
                   S.sphere(0.2, cx=0.6))


def _perturbed(tape, seed):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(tape, imms=(tape.imms * (
        1.0 + 0.05 * rng.standard_normal(tape.length))).astype(np.float32))


def _fill(tape, size):
    p = jcam.pixel_centers(size)
    X, Y = np.meshgrid(p, p)
    return (joracle.eval_f(tape, X, Y) < 0).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    """Per engine: (mpr_tpu tape, port tape, target, size)."""
    j2, j3 = (mpr_tpu.compile_tree(_tree2(jshapes)),
              mpr_tpu.compile_tree(_tree3(jshapes)))
    p2, p3 = (mpr_tpu_torch.compile_tree(_tree2(shapes)),
              mpr_tpu_torch.compile_tree(_tree3(shapes)))
    t2, t3 = _perturbed(j2, 3), _perturbed(j3, 4)
    return {"scan": (j2, p2, _fill(t2, SIZE), SIZE),
            "unrolled": (j2, p2, _fill(t2, SIZE), SIZE),
            "culled": (j2, p2, _fill(t2, SIZE_CULLED), SIZE_CULLED),
            "3d": (j3, p3, jcli._oracle_depth(t3, GRID), GRID),
            "window": (j3, p3, jcli._oracle_depth(t3, WSIZE), WSIZE)}


def _jax_step(engine, jt, size, lr, mask=None):
    """mpr_tpu's step on one device as f(state) -> (loss, new state),
    with the state its initial value."""
    mesh = jsh.make_mesh(1)
    m2, m3 = jnp.asarray(jcam.identity2()), jnp.asarray(jcam.identity3())
    if engine == "scan":
        step = jsh.make_fit_step(size, mesh, lr=lr, grad_mask=mask)
        return (lambda st, tg: step(st, jnp.asarray(tg), m2,
                                    jnp.float32(0.0)),
                jtd.TapeData.from_tape(jt))
    imms = jnp.asarray(jt.imms)
    if engine == "unrolled":
        step = jsh.make_fit_step_unrolled(jt, size, mesh, lr=lr,
                                          grad_mask=mask)
        return (lambda st, tg: step(st, jnp.asarray(tg), m2,
                                    jnp.float32(0.0)), imms)
    if engine == "culled":
        step = jsh.make_fit_step_culled(jt, size, mesh, lr=lr,
                                        grad_mask=mask)
        return (lambda st, tg: step(st, tg), imms)
    if engine == "3d":
        step = jsh.make_fit_step_3d(jt, size, mesh, lr=lr, grad_mask=mask)
        return (lambda st, tg: step(st, jnp.asarray(tg), m3), imms)
    step = jsh.make_fit_step_3d_window(jt, size, mesh, lr=lr,
                                       grad_mask=mask)
    return (lambda st, tg: step(st, tg), imms)


def _port_step(engine, pt, size, lr, mask=None):
    kw = dict(lr=lr, grad_mask=mask)
    if engine == "scan":
        return (sharded.make_fit_step(size, **kw),
                TapeData.from_tape(pt, device="cpu"))
    dev = dict(device="cpu")
    step = {"unrolled": lambda: sharded.make_fit_step_unrolled(
                pt, size, **kw, **dev),
            "culled": lambda: sharded.make_fit_step_culled(
                pt, size, **kw, **dev),
            "3d": lambda: sharded.make_fit_step_3d(pt, size, **kw, **dev),
            "window": lambda: sharded.make_fit_step_3d_window(
                pt, size, **kw, **dev)}[engine]()
    return step, torch.as_tensor(pt.imms)


def _imms(state):
    im = state.imms if hasattr(state, "imms") else state
    return np.asarray(im.detach().numpy() if torch.is_tensor(im) else im,
                      np.float64)


def _default_lr(engine):
    return {"3d": 3e-4, "window": 3e-4}.get(engine, 1e-2)


def _run(step, state, target, steps):
    losses = []
    for _ in range(steps):
        loss, state = step(state, target)
        losses.append(float(loss))
    return losses, state


def _grad(step, state, target, n):
    loss, new = step(state, target)
    return float(loss), ((_imms(state) - _imms(new)) / PROBE_LR)[:n]


@pytest.fixture(scope="module")
def jax_results(cases):
    out = {}
    for engine in ENGINES:
        jt, _, tgt, size = cases[engine]
        step, st = _jax_step(engine, jt, size, PROBE_LR)
        loss0, g0 = _grad(step, st, tgt, jt.length)
        step, st = _jax_step(engine, jt, size, _default_lr(engine))
        losses, _ = _run(step, st, tgt, STEPS)
        out[engine] = (loss0, g0, losses)
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_fit_step_matches_mpr_tpu(cases, jax_results, engine):
    _, pt, tgt, size = cases[engine]
    loss0, g0, losses = jax_results[engine]
    step, st = _port_step(engine, pt, size, PROBE_LR)
    got_loss, got_g = _grad(step, st, tgt, pt.length)
    assert abs(got_loss - loss0) <= LOSS_RTOL * abs(loss0)
    assert np.abs(got_g - g0).max() <= GRAD_TOL * np.abs(g0).max()
    assert np.abs(g0).max() > 0
    step, st = _port_step(engine, pt, size, _default_lr(engine))
    got, _ = _run(step, st, tgt, STEPS)
    np.testing.assert_allclose(got, losses, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]                 # the loss falls


def test_culled_gradients_match_dense(cases):
    """The culled step's gradient equals the dense one's to mpr_tpu's own
    tolerance (tests/test_fit_culled.py: 1e-3 relative): only pixels
    within 4 / sharpness of the surface differ, by O(sech^2(4))."""
    _, pt, tgt, size = cases["culled"]
    grads = {}
    for engine in ("unrolled", "culled"):
        step, st = _port_step(engine, pt, size, PROBE_LR)
        _, grads[engine] = _grad(step, st, tgt, pt.length)
    d = grads["unrolled"]
    assert np.abs(grads["culled"] - d).max() <= 1e-3 * np.abs(d).max()


@pytest.mark.parametrize("engine", ENGINES)
def test_params_only_moves_only_the_parameters(engine):
    mode = "3d" if engine in ("3d", "window") else "2d"
    pt = mpr_tpu_torch.compile_tree(_tree_params(shapes, T, mode))
    idx = pt.params["r"]
    mask = np.zeros(pt.length, np.float32)
    mask[idx] = 1.0
    size = {"3d": GRID, "window": WSIZE, "culled": SIZE_CULLED}.get(engine,
                                                                   SIZE)
    tgt_tape = dataclasses.replace(pt, imms=pt.imms_with({"r": 0.55}))
    if mode == "2d":
        tgt = cli._oracle_fill(tgt_tape, size).astype(np.float32)
    else:
        tgt = cli._oracle_depth(tgt_tape, size)
    step, st = _port_step(engine, pt, size, 1e-2, mask=mask)
    _, new = step(st, tgt)
    before, after = _imms(st)[:pt.length], _imms(new)[:pt.length]
    moved = np.flatnonzero(before != after)
    assert len(moved) and set(moved) <= set(idx)


def _rule_tape(op, imm):
    """x + P -> a, y - Q -> b, then ``op`` on (a, b, imm): the lanes below
    put a and b at 0, at each other and at the immediate."""
    cl = [(13, 3, 1, 0, 0.25), (21, 4, 2, 0, 0.5), (op, 5, 3, 4, imm)]
    ops, outs, lhss, rhss, imms = (np.asarray(c) for c in zip(*cl))
    return dict(ops=ops.astype(np.int32), outs=outs.astype(np.int32),
                lhss=lhss.astype(np.int32), rhss=rhss.astype(np.int32),
                imms=imms.astype(np.float32), axis_slots=(1, 2, 0),
                result_slot=5, num_slots=6,
                num_choices=int(17 <= op <= 20))


def _rule_lanes(imm):
    xs = np.float32([-0.25, -0.25, 0.3, imm - 0.25, -0.5, 0.65, 0.75,
                     -1.25, 0.1])
    ys = np.float32([0.5, 0.5, 1.05, imm + 0.5, 0.5, 0.2, 0.2, 0.7, -0.0])
    return xs, ys


def _assert_same_partials(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    err = np.abs(got[fin] - want[fin])
    assert (err <= RULE_RTOL * np.abs(want[fin]) + 1e-30).all(), (
        got[fin], want[fin])


@pytest.mark.parametrize("op", list(range(2, 32)))
def test_gradient_rule_matches_jax_grad(op):
    """Per lane, d(result)/d(each immediate) of a three-clause tape around
    ``op``, through the interpreter and the unrolled evaluator, against
    ``jax.grad`` of mpr_tpu's (jacobians)."""
    imm = 0.37
    arr = _rule_tape(op, imm)
    jt, pt = JTape(**arr), Tape.from_arrays(**arr)
    x, y = _rule_lanes(imm)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    jd = jtd.TapeData.from_tape(jt)
    want = np.asarray(jax.jacrev(
        lambda im: jes.eval_f(jd.replace_imms(im), x, y))(jd.imms))[:, :3]
    td = TapeData.from_tape(pt, device="cpu")
    got = torch.autograd.functional.jacobian(
        lambda im: eval_scan.eval_f(td.replace_imms(
            torch.cat([im, td.imms[3:]])), xt, yt), td.imms[:3].clone())
    _assert_same_partials(got.numpy(), want)
    fj = jue.build_float(jt, take_imms=True)
    want = np.asarray(jax.jacrev(lambda im: fj(x, y, jnp.zeros_like(x), im))(
        jnp.asarray(jt.imms)))
    fp = ue.build_float(pt, take_imms=True)
    got = torch.autograd.functional.jacobian(
        lambda im: fp.plain(xt, yt, torch.zeros_like(xt), imms=im),
        torch.as_tensor(pt.imms))
    _assert_same_partials(got.numpy(), want)


def test_vjp_plain_version_is_autograd_of_the_walk():
    """unrolled_float_vjp and scan_adjoint on CPU tensors: the plain
    versions of K1 and K2, equal to autograd of the plain walks."""
    tape = mpr_tpu_torch.compile_tree(shapes.stress_2d(4))
    rng = np.random.default_rng(7)
    x, y, z, g = (torch.as_tensor(rng.uniform(-1, 1, 500).astype(np.float32))
                  for _ in range(4))
    f = ue.build_float(tape, take_imms=True)
    im = torch.as_tensor(tape.imms).clone().requires_grad_(True)
    (f(x, y, z, imms=im) * g).sum().backward()
    assert torch.equal(ue.unrolled_float_vjp(f.vjp, x, y, z, g, tape.imms),
                       im.grad)
    td = TapeData.from_tape(tape, device="cpu")
    im = td.imms.clone().requires_grad_(True)
    (eval_scan.eval_f(td.replace_imms(im), x, y, z) * g).sum().backward()
    assert torch.equal(eval_scan.scan_adjoint(td, x, y, z, g), im.grad)


def test_vjp_of_a_baked_evaluator_raises():
    f = ue.build_float(mpr_tpu_torch.compile_tree(shapes.circle(0.5)))
    with pytest.raises(RuntimeError, match="no imms to differentiate"):
        f.vjp


def test_replace_imms_keeps_the_schedule_and_sources():
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(shapes.stress_2d(4)),
                            device="cpu")
    lv, src = td.levels(), td.sources()
    td2 = td.replace_imms(td.imms * 2.0)
    assert td2.levels() is lv and td2.sources() is src
    assert torch.equal(td2.imms, td.imms * 2.0)
    assert td2.packed is td.packed and td2.length == td.length
    with pytest.raises(ValueError, match="shape"):
        td.replace_imms(td.imms[:5])


@pytest.mark.parametrize("argv", [
    ["--engine", "scan"], ["--engine", "unrolled"],
    ["--engine", "culled", "--size", "128"],
    ["--mode", "3d", "--size", "16"],
    ["--mode", "3d", "--engine", "culled", "--size", "64"],
    ["--params-only"]])
def test_cli_fit_on_the_cpu(tmp_path, capsys, argv):
    src = "stress:5"
    if "--params-only" in argv:
        scene = tmp_path / "p.io"
        scene.write_text("(circle (var r 0.4) [0.1 0])\n")
        src = str(scene)
    out = str(tmp_path / "f.npz")
    cli.main(["fit", src, "--target", "stress:6", "--steps", "3",
              "--out", out, "--device", "cpu"]
             + (["--size", "64"] if "--size" not in argv else []) + argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 3
    fitted = checkpoint.load_tape(out)
    tape = cli._load(src)
    assert fitted.length == tape.length
    moved = np.flatnonzero(fitted.imms != tape.imms)
    if "--params-only" in argv:
        assert set(moved) <= set(tape.params["r"])
    # the checkpoint carries across: mpr_tpu loads the port's
    assert np.array_equal(jckpt.load_tape(out).imms, fitted.imms)


def test_cli_fit_writes_frep_and_png_and_runs_as_a_script(tmp_path):
    out, frep, png = (str(tmp_path / n) for n in ("f.npz", "f.frep", "f.png"))
    r = subprocess.run(
        [sys.executable, "-m", "mpr_tpu_torch.cli", "fit", "stress:5",
         "--target", "stress:6", "--size", "64", "--steps", "2", "--out",
         out, "--out-frep", frep, "--render-out", png, "--device", "cpu"],
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "step 1: loss" in r.stdout
    for p in (frep, png):
        assert __import__("os").path.getsize(p) > 0
    # and mpr_tpu's checkpoint loads in the port
    jt = mpr_tpu.compile_tree(jshapes.stress_2d(5))
    jout = str(tmp_path / "j.npz")
    jckpt.save_tape(jout, jt, imms=jt.imms * 1.5)
    assert np.array_equal(checkpoint.load_tape(jout).imms, jt.imms * 1.5)


def test_k1_is_generated_in_segments(monkeypatch):
    """K1's sources (the card builds them): a forward half storing only
    the plan's values and choice words, and reverse segments covering the
    tape, each with its clause range, the last one seeded by g, adjoints
    handed over through ``hand`` (stored by the first contributor, added
    to by the rest), the immediates' shares reduced eight at a time (the
    lanes past n counting 0), nothing zero-filled."""
    monkeypatch.setattr(ue, "VJP_SEGMENT", 16)
    monkeypatch.setattr(ue, "VJP_LIVE", 6)
    tape = mpr_tpu_torch.compile_tree(shapes.stress_2d(4))
    vjp = ue.build_float(tape, take_imms=True).vjp
    plan = vjp.plan
    assert [e.kind for e in vjp.evals] == ["vjpf"] + ["vjp"] * len(
        vjp.segments)
    assert len({e.key for e in vjp.evals}) == len(vjp.evals)
    assert vjp.segments[0].seg[0] == 0
    assert vjp.segments[-1].seg[1] == tape.length
    assert all(a.seg[1] == b.seg[0]
               for a, b in zip(vjp.segments, vjp.segments[1:]))
    fwd = vjp.fwd.source()
    assert "MPR_UNROLLED_ENTRY" in fwd
    assert fwd.count("vals[vb + ") == plan.n_vals < tape.length - 1
    assert fwd.count("ch[cb + ") == plan.n_words > 0
    assert fwd.count("cw |= ") == plan.n_choices
    srcs = [e.source() for e in vjp.segments]
    assert all("MPR_UNROLLED_VJP_ENTRY" in s_ for s_ in srcs)
    assert "in3[i]" in srcs[-1]
    lines = [ln for s_ in srcs for ln in s_.splitlines()]
    assert not any("adj[" in ln or "zero_" in ln for ln in lines)
    # every immediate share, masked for the lanes past n, reduced once
    n_got = 0
    for s_ in srcs:
        shares = [ln.split()[2] for ln in s_.splitlines()
                  if re.match(r"\s*const float v\d+ = live \? ", ln)]
        batches = [re.search(r"acc_imm8<([\d, ]+)>\(acc, (.*)\);", ln)
                   for ln in s_.splitlines() if "acc_imm8<" in ln]
        assert all(batches)
        got = [v for b in batches for v in b.group(2).split(", ")
               if v != "0.0f"]
        assert sorted(got) == sorted(shares)
        n_got += len(got)
    assert n_got == int(vp.USES_I[tape.ops][plan.has].sum()) > 0
    # each handed-over adjoint: stored first by its first contributor,
    # before any addition or read, in the segments' run order
    stored, order = set(), []
    for s_ in reversed(srcs):
        for ln in s_.splitlines():
            for m in re.finditer(r"__(ldcg|stcg)\(hand \+ hb \+ (\d+)", ln):
                order.append((int(m.group(2)) // vp.LANE_BLOCK, m.group(1)))
    for h, how in order:
        if how == "stcg":
            stored.add(h)
        else:
            assert h in stored
    assert stored == set(range(plan.n_handover))
    assert sum(how == "stcg" for _, how in order) == plan.contributions


# Tapes for the storage plan and the kernels' algorithms replayed in plain
# PyTorch: the chip cells' kinds (a long min/max union, its extrusion), the
# tape that runs every opcode, and random trees with every operand form
# (tests/test_random_trees.py's generator, on the port's tree module).
_RANDOM = random_trees(T, mpr_tpu_torch.compile_tree, 6, seed=20261017)
PLAN_TAPES = {"stress_2d(40)": lambda: mpr_tpu_torch.compile_tree(
                  shapes.stress_2d(40)),
              "extruded": lambda: mpr_tpu_torch.compile_tree(
                  shapes.extrude_z(shapes.stress_2d(30), -0.4, 0.4)),
              "all_ops": lambda: Tape.from_arrays(**all_ops_clauses())}
PLAN_TAPES.update({f"random{k}": (lambda k=k: mpr_tpu_torch.compile_tree(
    _RANDOM[k])) for k in range(6)})


@pytest.mark.parametrize("name", list(PLAN_TAPES))
@pytest.mark.parametrize("segment,live", [(512, 64), (16, 4)])
def test_vjp_plan_sets(name, segment, live):
    """The plan stores exactly the values the partials of clauses with an
    adjoint read (no linear clause's operands), codes every min/max clause
    in order, hands over every adjoint whose readers lie in another
    segment, and keeps at most ``live`` in registers."""
    tape = PLAN_TAPES[name]()
    plan = vp.plan_of_tape(tape, segment, live)
    L, src, ops = tape.length, plan.src, tape.ops
    want = set()
    for t in np.flatnonzero(plan.has):
        op = int(ops[t])
        if vp.NEEDS_A[op] and src[0, t] >= 0:
            want.add(int(src[0, t]))
        if vp.NEEDS_B[op] and src[1, t] >= 0:
            want.add(int(src[1, t]))
        if vp.NEEDS_R[op]:
            want.add(int(t))
    assert set(np.flatnonzero(plan.vpos >= 0).tolist()) == want
    assert sorted(plan.vpos[plan.vpos >= 0]) == list(range(plan.n_vals))
    linear = {int(o) for o in (Op.ADD_LHS_IMM, Op.ADD_LHS_RHS, Op.SUB_LHS_IMM,
                               Op.SUB_IMM_RHS, Op.SUB_LHS_RHS, Op.NEG_LHS,
                               Op.COPY_IMM, Op.COPY_LHS, Op.COPY_RHS)}
    for t in range(L):
        if int(ops[t]) in linear:    # a linear clause's rule reads nothing
            assert not (vp.NEEDS_A[ops[t]] or vp.NEEDS_B[ops[t]]
                        or vp.NEEDS_R[ops[t]])
    ch = np.flatnonzero(vp.CHOICE[ops])
    assert plan.cidx[ch].tolist() == list(range(len(ch)))
    assert (plan.cidx[np.setdiff1d(np.arange(L), ch)] == -1).all()
    assert plan.n_words == -(-len(ch) // 16)
    # who reads each adjoint
    readers = {}
    for t in np.flatnonzero(plan.has):
        for k, uses in ((0, vp.USES_A), (1, vp.USES_B)):
            s_ = int(src[k, t])
            if uses[int(ops[t])] and s_ >= 0:
                readers.setdefault(s_, set()).add(int(t))
    assert set(np.flatnonzero(plan.has).tolist()) == set(readers) | (
        {plan.result} if plan.result >= 0 else set())
    for s_, rs in readers.items():
        if any(t // segment != s_ // segment for t in rs):
            assert plan.hpos[s_] >= 0
        if plan.hpos[s_] >= 0:
            assert plan.first[s_] == max(rs)
    assert sorted(plan.hpos[plan.hpos >= 0]) == list(range(plan.n_handover))
    assert plan.contributions == sum(len(readers[s_]) for s_ in readers
                                     if plan.hpos[s_] >= 0)
    assert vp.register_live(plan) <= live
    assert plan.k1_lane_bytes == 4 * (plan.n_vals + plan.n_words
                                      + plan.n_handover)


def test_partials_tables_agree_with_the_rules():
    """NEEDS_* / USES_* say what :func:`vjp_plan.partials` reads and gives
    a share to, opcode by opcode."""
    class Rec:
        def __init__(self):
            self.read = set()

        def _op(self, *args):
            self.read.update(a for a in args if isinstance(a, str))
            return "t"
        mul = div = add = sub = _op

        def neg(self, a):
            return self._op(a)
        sqrt = sin = cos = neg

        def sel_ge0(self, a, p, q):
            return self._op(a, p, q)

        def bal(self, code, side):
            return self._op(code)
    for op in range(32):
        K = Rec()
        da, db, di = vp.partials(op, K, "g", "a", "b", "r", "i", "c")
        assert ("a" in K.read) == bool(vp.NEEDS_A[op]), op
        assert ("b" in K.read) == bool(vp.NEEDS_B[op]), op
        assert ("r" in K.read) == bool(vp.NEEDS_R[op]), op
        assert ("c" in K.read) == bool(vp.CHOICE[op]), op
        assert ("i" in K.read) == bool(vp.READS_IMM[op]), op
        assert (da is not None, db is not None, di is not None) == (
            bool(vp.USES_A[op]), bool(vp.USES_B[op]), bool(vp.USES_I[op]))
        assert vp.vjp_ops(op) >= 1


def _unrolled_values(tape, x, y, z):
    """Every clause's value under the unrolled float semantics."""
    K = ue._TorchOps(False)
    sem = ue._FloatSem(K)
    vals = []

    def keep(v):
        vals.append(torch.as_tensor(v, dtype=torch.float32).expand_as(x))
        return v
    sem.post = keep
    ue._walk(tape, sem, x, y, z, [float(v) for v in tape.imms])
    return torch.stack(vals)


def _interp_values(td, x, y, z):
    """Every clause's value under the interpreter's float walk."""
    regs = [torch.zeros_like(x)] * max(td.num_slots, 1)
    for s_, v in zip(td.axis_slots, (x, y, z)):
        if s_:
            regs[s_] = v
    ops, outs, lhss, rhss = kernels._decode(td.packed[:td.length])
    out = []
    for t in range(td.length):
        a, b = regs[lhss[t]], regs[rhss[t]]
        r = (a * 0.0 if ops[t] <= Op.JUMP
             else kernels.float_clause(ops[t], a, b, td.imms[t]))
        regs[outs[t]] = r
        out.append(r.expand_as(x))
    return torch.stack(out)


def _jtape(pt):
    return JTape(ops=pt.ops, outs=pt.outs, lhss=pt.lhss, rhss=pt.rhss,
                 imms=pt.imms, axis_slots=pt.axis_slots,
                 result_slot=pt.result_slot, num_slots=pt.num_slots,
                 num_choices=pt.num_choices)


@pytest.mark.parametrize("name", [n for n in PLAN_TAPES if n != "all_ops"]
                         + ["all_ops"])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_replay_matches_autograd_and_jax(name, kernel):
    """K1's and K2's algorithms replayed in plain PyTorch from what the
    forward half stores (the plan's values and choice words) and the
    handed-over adjoints alone (small segments and register budget, so
    that many are handed over) equal autograd of the plain walk and
    ``jax.grad`` through mpr_tpu's unrolled float evaluator (K1) or
    ``eval_f`` (K2), within GRAD_TOL of the largest component."""
    pt = PLAN_TAPES[name]()
    jt = _jtape(pt)
    rng = np.random.default_rng(11)
    n = 257
    xs, ys, zs = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3))
    gs = rng.normal(size=n).astype(np.float32)
    x, y, z, g = (torch.from_numpy(a) for a in (xs, ys, zs, gs))
    if kernel == "K1":
        plan = vp.plan_of_tape(pt, 16, 4)
        vals, words = vp.forward_store(plan, pt.imms,
                                       _unrolled_values(pt, x, y, z), x, y, z)
        got = vp.replay_k1(plan, pt.imms, vals, words, x, y, z, g).numpy()
        f = ue.build_float(pt, take_imms=True)
        plain = ue.unrolled_float_vjp(f.vjp, x, y, z, g, pt.imms).numpy()
        fj = jue.build_float(jt, take_imms=True)
        want = np.asarray(jax.grad(lambda im: jnp.sum(
            fj(xs, ys, zs, im) * gs))(jnp.asarray(jt.imms)))
    else:
        td = TapeData.from_tape(pt, device="cpu")
        plan = td.vjp_plan()[0]
        vals, words = vp.forward_store(plan, td.imms.numpy(),
                                       _interp_values(td, x, y, z), x, y, z)
        got = vp.replay_k2(plan, td.packed.numpy(), td.imms.numpy(), vals,
                           words, x, y, z, g, td.num_slots,
                           td.result_slot).numpy()
        plain = eval_scan.scan_adjoint(td, x, y, z, g).numpy()[:pt.length]
        jd = jtd.TapeData.from_tape(jt)
        want = np.asarray(jax.grad(lambda im: jnp.sum(jes.eval_f(
            jd.replace_imms(im), xs, ys, zs) * gs))(jd.imms))[:pt.length]
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - plain).max() <= GRAD_TOL * scale
    assert np.abs(got - want).max() <= GRAD_TOL * scale
