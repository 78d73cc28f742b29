"""PyTorch port: the unrolled engine on the CPU against ``mpr_tpu``'s.

``mpr_tpu_torch.ops.unrolled_eval``'s three evaluators (their plain torch
versions: the generated CUDA kernels need the card, tests/test_torch_gpu.py)
are held against ``mpr_tpu.ops.unrolled_eval``'s under ``jax.jit`` (XLA
rewrites the traced graph, and the port reproduces what it computes), in
both modes (immediates baked, immediates an input) and under the config
flags that change them.  The renders of ``mpr_tpu_torch.render.unrolled``
are held against ``mpr_tpu.render.unrolled``, the port's interpreter
engine and the brute renderers.

Tolerances.
  * A tape without sqrt, sin, cos, asin, acos, atan, exp, log and hypot:
    every output bit for bit, NaNs in the same places, but for the sign of
    a zero: XLA drops an addition of a constant 0 (``-0 + 0`` stays
    ``-0``), which the derivatives of constants reach, where IEEE
    arithmetic (the port's kernels and plain versions alike) gives ``+0``.
    The port does reproduce XLA's other rewrites of a baked tape: a
    division by a constant is a product with its reciprocal, and chains of
    constant additions or products are folded (``ue._Folding``).
  * A tape with one of them: NaNs and infinities in the same places, and
    elsewhere |port - jax| <= N ulp(jax) + FLOOR, N = 4 and FLOOR = 1e-6
    in the float and interval forms, N = 12 and FLOOR = 4e-6 in the
    dual-number form (ULPS, FLOOR).  Torch's CPU math library and XLA's
    round these ops differently: on their own (``test_transcendental_op``)
    they differ by at most 4 ulp in the float and interval forms (2 ulp
    but for the Cephes acos, 4) and 12 ulp in the dual-number form (XLA
    rewrites ``c / sqrt(v)`` into ``c * rsqrt(v)``, which its CPU backend
    rounds ~11 ulp away for asin/acos).  A later subtraction keeps such a
    difference's absolute size but cancels the value, so a result near
    zero needs the floor: over these cases the most beyond N ulp is
    5.1e-7 (float, interval) and 2.8e-6 (dual numbers).
  * Images and depth: equal to ``mpr_tpu``'s and to the interpreter
    engine's; equal to the brute renderers' except, for tapes whose float
    pass runs sin/cos/exp/log or divides by a baked immediate, where the
    oracle's |f| <= FILL_BAND (the port's existing exemption); normals
    within 1e-4 of ``mpr_tpu``'s.
  * Gradients in the immediates: rtol 1e-4, atol 1e-5 of ``jax.grad``
    (sums over the lanes are taken in another order).
"""

import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax
import jax.numpy as jnp

from mpr_tpu import config as jconfig
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as JT
from mpr_tpu.ops import unrolled_eval as jue
from mpr_tpu.render import brute as jbrute
from mpr_tpu.render import unrolled as jun
from mpr_tpu.tape.tape import Tape as JTape
from mpr_tpu.tape.tape import compile_tree as jcompile

import mpr_tpu_torch
from mpr_tpu_torch import config, oracle
from mpr_tpu_torch.frontend import scheme, shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.ops import unrolled_eval as ue
from mpr_tpu_torch.render import (brute, camera, pipeline2d, pipeline3d,
                                  unrolled)
from mpr_tpu_torch.tape.opcodes import Op
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (FILL_BAND, all_ops_clauses, assert_depth,
                              depth_field, one_torch_thread,  # noqa: F401
                              random_trees)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
# opcodes whose rounding differs between torch's CPU math and XLA's
INEXACT_OPS = frozenset({3, 5, 6, 7, 8, 9, 10, 12, 30})
SEMS = ("float", "interval", "deriv")
# whole-tape limits of a tape with an inexact op (module docstring)
ULPS = {"float": 4, "interval": 4, "deriv": 12}
FLOOR = {"float": 1e-6, "interval": 1e-6, "deriv": 4e-6}
# the config flags that change each semantics
FLAGS = {"float": ({}, {"fast_transcendentals": True}),
         "interval": ({}, {"tight_sincos": True}, {"widen_intervals": True},
                      {"fast_transcendentals": True}),
         "deriv": ({}, {"fast_transcendentals": True})}

_JRAND = random_trees(JT, jcompile, 8)
_PRAND = random_trees(T, mpr_tpu_torch.compile_tree, 8)


def _tapes(name):
    """(mpr_tpu tape, port tape) of one parity case."""
    if name == "all_ops":
        c = all_ops_clauses()
        return JTape(**c), Tape.from_arrays(**c)
    if name.startswith("random"):
        k = int(name[len("random"):])
        return jcompile(_JRAND[k]), mpr_tpu_torch.compile_tree(_PRAND[k])
    build = {"stress12": lambda S: S.stress_2d(12),
             "gyroid": lambda S: S.intersection(S.gyroid(0.4, 0.08),
                                                S.sphere(0.85)),
             "scaled": lambda S: S.scale(S.rotate_z(S.box(
                 -0.5, 0.5, -0.3, 0.3, -0.4, 0.4), 0.3), 1.3, 0.7, 0.9)}[name]
    return jcompile(build(jshapes)), mpr_tpu_torch.compile_tree(build(shapes))


NAMES = [f"random{k}" for k in range(8)] + ["all_ops", "stress12", "gyroid",
                                            "scaled"]


def _inputs(kind, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.uniform(-1.5, 1.5, n).astype(np.float32)
               for _ in range(3))
    if kind != "interval":
        return [x, y, z]
    w = rng.uniform(0.0, 0.6, (3, n)).astype(np.float32)
    return [x, x + w[0], y, y + w[1], z, z + w[2]]


def _builders(kind):
    return {"float": (jue.build_float, ue.build_float),
            "interval": (jue.build_interval, ue.build_interval),
            "deriv": (jue.build_deriv, ue.build_deriv)}[kind]


def _run_both(jtape, ptape, kind, take, args):
    jb, pb = _builders(kind)
    jf, pf = jb(jtape, take), pb(ptape, take)
    jkw = {"imms": jnp.asarray(jtape.imms)} if take else {}
    pkw = {"imms": torch.as_tensor(ptape.imms)} if take else {}
    want = jax.jit(lambda *a, **k: jf(*a, **k))(*args, **jkw)
    got = pf(*[torch.from_numpy(a) for a in args], **pkw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _ulps(a, b):
    """Largest distance in units in the last place, NaNs excluded."""
    def key(v):
        i = v.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    m = ~np.isnan(a)
    return int(np.abs(key(a) - key(b))[m].max(initial=0))


def _assert_outputs(got, want, exact, label, kind="float"):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32, (label, k)
        assert np.array_equal(np.isnan(g), np.isnan(w)), (label, k)
        m = ~np.isnan(w)
        if exact:
            # equal floats: bit for bit but for the sign of a zero
            assert np.array_equal(g[m], w[m]), (label, k, _ulps(g, w))
            continue
        g, w = g[m], w[m]
        fin = np.isfinite(w)
        assert np.array_equal(g[~fin], w[~fin]), (label, k)
        g, w = g[fin].astype(np.float64), w[fin]
        lim = (ULPS[kind] * np.spacing(np.abs(w)).astype(np.float64)
               + FLOOR[kind])
        over = np.abs(g - w) - lim
        assert over.max(initial=-1.0) <= 0, (label, k, float(over.max()))


# ---------------------------------------------------------------------------
# the evaluators against mpr_tpu's
# ---------------------------------------------------------------------------

CASES = [(kind, name, take, i) for kind in SEMS for name in NAMES
         for take in (False, True) for i in range(len(FLAGS[kind]))]


@pytest.mark.parametrize("kind,name,take,fi", CASES,
                         ids=[f"{k}-{n}-{'imms' if t else 'baked'}-"
                              f"{'-'.join(FLAGS[k][i]) or 'default'}"
                              for k, n, t, i in CASES])
def test_evaluator_matches_jax(kind, name, take, fi):
    flags = FLAGS[kind][fi]
    jtape, ptape = _tapes(name)
    with jconfig.override(**flags), config.override(**flags):
        want, got = _run_both(jtape, ptape, kind, take, _inputs(kind))
    exact = not set(ptape.ops.tolist()) & INEXACT_OPS
    _assert_outputs(got, want, exact, f"{kind} {name} {flags}", kind)


def _one_clause(op):
    kw = dict(ops=np.array([op], np.int32), outs=np.array([1], np.int32),
              lhss=np.array([1], np.int32), rhss=np.array([2], np.int32),
              imms=np.zeros(1, np.float32), axis_slots=(1, 2, 3),
              result_slot=1, num_slots=4, num_choices=0)
    return JTape(**kw), Tape.from_arrays(**kw)


OP_DOMAIN = {3: (0.01, 30.0), 7: (-0.99, 0.99), 8: (-0.99, 0.99),
             12: (0.01, 30.0)}


@pytest.mark.parametrize("fast", [False, True], ids=["libm", "cephes"])
@pytest.mark.parametrize("kind", SEMS)
@pytest.mark.parametrize("op", sorted(INEXACT_OPS),
                         ids=[Op(o).name for o in sorted(INEXACT_OPS)])
def test_transcendental_op_within_ulps(op, kind, fast):
    """Each inexact op alone, on 20,000 lanes of its domain: at most 4 ulp
    (float, interval) and 12 ulp (dual numbers) from mpr_tpu's."""
    jtape, ptape = _one_clause(op)
    rng = np.random.default_rng(op)
    lo, hi = OP_DOMAIN.get(op, (-3.0, 3.0))
    a = rng.uniform(lo, hi, 20000).astype(np.float32)
    b = rng.uniform(-3.0, 3.0, 20000).astype(np.float32)
    args = ([a, a + np.float32(0.01), b, b + np.float32(1.0), b, b]
            if kind == "interval" else [a, b, b])
    flags = {"fast_transcendentals": fast}
    with jconfig.override(**flags), config.override(**flags):
        want, got = _run_both(jtape, ptape, kind, False, args)
    limit = 12 if kind == "deriv" else 4
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert _ulps(g, w) <= limit, _ulps(g, w)


@pytest.mark.parametrize("kind", SEMS)
def test_division_by_an_immediate_baked_and_as_input(kind):
    """x/3 + y/7: baked, mpr_tpu (XLA) multiplies by the reciprocal
    rounded once in f32, and so does the port; with the immediates an
    input both divide.  Both hold bit for bit, and the two modes do differ
    (in about 45% of the lanes of the float form)."""
    jtape = jcompile(JT.x() / 3.0 + JT.y() / 7.0)
    ptape = mpr_tpu_torch.compile_tree(T.x() / 3.0 + T.y() / 7.0)
    assert ptape.ops.tolist().count(int(Op.DIV_LHS_IMM)) == 2
    args = _inputs(kind, n=100_000, seed=11)
    outs = {}
    for take in (False, True):
        want, got = _run_both(jtape, ptape, kind, take, args)
        _assert_outputs(got, want, True, f"{kind} take_imms={take}")
        outs[take] = got
    x, y = args[0], args[2] if kind == "interval" else args[1]
    r3, r7 = np.float32(1) / np.float32(3), np.float32(1) / np.float32(7)
    assert np.array_equal(outs[False][0], x * r3 + y * r7)
    assert np.array_equal(outs[True][0], x / np.float32(3) + y / np.float32(7))
    assert (outs[False][0] != outs[True][0]).mean() > 0.3


@pytest.mark.parametrize("name", ["random0", "random3", "stress12",
                                  "scaled"])
def test_imm_gradient_matches_jax_grad(name):
    """d(sum f^2)/d(imms) of the plain take_imms evaluator by autograd
    equals jax.grad through mpr_tpu's."""
    jtape, ptape = _tapes(name)
    x, y, z = _inputs("float", n=2000, seed=13)
    jf = jue.build_float(jtape, take_imms=True)
    g_j = jax.grad(lambda im: jnp.sum(jf(x, y, z, imms=im) ** 2))(
        jnp.asarray(jtape.imms))
    imms = torch.tensor(ptape.imms, requires_grad=True)
    pf = ue.build_float(ptape, take_imms=True)
    (pf(*(torch.from_numpy(a) for a in (x, y, z)), imms=imms) ** 2).sum(
        ).backward()
    np.testing.assert_allclose(imms.grad.numpy(), np.asarray(g_j),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["random1", "stress12", "all_ops"])
def test_build_unrolled_f_matches_jax(name):
    jtape, ptape = _tapes(name)
    x, y, z = _inputs("float", seed=17)
    want = np.asarray(jbrute.build_unrolled_f(jtape)(x, y, z))
    got = brute.build_unrolled_f(ptape)(*(torch.from_numpy(a)
                                          for a in (x, y, z))).numpy()
    exact = not set(ptape.ops.tolist()) & INEXACT_OPS
    _assert_outputs([got], [want], exact, name)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def test_the_key_follows_structure_and_flags_not_imms_under_take_imms():
    tape = mpr_tpu_torch.compile_tree(shapes.stress_2d(12))
    moved = Tape.from_arrays(tape.ops, tape.outs, tape.lhss, tape.rhss,
                             tape.imms * np.float32(1.5),
                             axis_slots=tape.axis_slots,
                             result_slot=tape.result_slot,
                             num_slots=tape.num_slots,
                             num_choices=tape.num_choices)
    other = mpr_tpu_torch.compile_tree(shapes.stress_2d(13))
    for build in (ue.build_float, ue.build_interval, ue.build_deriv):
        base = build(tape).key
        assert build(tape).key == base
        assert build(tape, True).key == build(moved, True).key
        assert build(moved).key != base
        assert build(tape, True).key != base
        assert build(other).key != base
        for flag in ("tight_sincos", "fast_transcendentals",
                     "widen_intervals"):
            with config.override(**{flag: True}):
                assert build(tape).key != base, flag
                assert build(tape, True).key == build(moved, True).key
    keys = {e.key for e in (ue.build_float(tape), ue.build_interval(tape),
                            ue.build_deriv(tape))}
    assert len(keys) == 3
    assert unrolled.tape_key(tape, True) == unrolled.tape_key(moved, True)
    assert unrolled.tape_key(tape) != unrolled.tape_key(moved)


@pytest.mark.parametrize("kind", SEMS)
def test_the_source_holds_every_opcode_and_exact_immediates(kind):
    tape = Tape.from_arrays(**all_ops_clauses())
    src = ue.build_float(tape).source() if kind == "float" else (
        ue.build_interval(tape).source() if kind == "interval"
        else ue.build_deriv(tape).source())
    for op in set(tape.ops.tolist()):
        assert f"= {Op(op).name} " in src, Op(op).name
    imm_ops = {int(o) for o in (Op.ADD_LHS_IMM, Op.MUL_LHS_IMM,
                                Op.MIN_LHS_IMM, Op.MAX_LHS_IMM,
                                Op.SUB_LHS_IMM, Op.SUB_IMM_RHS,
                                Op.DIV_IMM_RHS, Op.COPY_IMM)}
    for op, imm in zip(tape.ops.tolist(), tape.imms.tolist()):
        if op == Op.SUB_LHS_IMM:
            # a - c is written a + (-c), as XLA canonicalizes it
            assert ue.lit(-imm) in src, (Op(op).name, imm)
        elif op in imm_ops:
            assert ue.lit(imm) in src, (Op(op).name, imm)
        if op == Op.DIV_LHS_IMM:
            assert ue.lit(ue.recip(imm)) in src
    # every immediate is written bit-exactly: the literal parses back to
    # the same float32
    for v in (0.1, -1.0 / 3.0, 1e-38, 3.4e38, -0.0, np.inf, np.nan):
        text = ue.lit(v)
        if text.startswith("(0x") or text.startswith("(-0x"):
            back = np.float32(float.fromhex(text[1:-2]))
        else:
            back = np.uint32(int(text.split("0x")[1].rstrip(")"), 16)).view(
                np.float32)
        assert back.tobytes() == np.float32(v).tobytes(), v
    # with the immediates an input, the source reads them from the pointer
    src = ue.build_float(tape, take_imms=True).source()
    assert src.count("__ldg(imms + ") == tape.length


def test_cpu_inputs_take_the_plain_version_and_count_no_launch():
    tape = mpr_tpu_torch.compile_tree(shapes.circle(0.5))
    before = (ue.unrolled_float.launches, ue.unrolled_interval.launches,
              ue.unrolled_deriv.launches)
    x = torch.linspace(-1, 1, 50)
    v = ue.build_float(tape)(x, x)
    lo, hi = ue.build_interval(tape)(x, x + 0.1, x, x + 0.1, x, x)
    d = ue.build_deriv(tape)(x, x)
    assert v.shape == lo.shape == d[0].shape == (50,)
    assert torch.equal(v, ue.build_float(tape).plain(x, x, torch.zeros(50)))
    assert (ue.unrolled_float.launches, ue.unrolled_interval.launches,
            ue.unrolled_deriv.launches) == before
    with pytest.raises(ValueError, match="opcode"):
        bad = Tape.from_arrays([1], [1], [1], [0], [0.0], axis_slots=(1, 2, 3),
                               result_slot=1, num_slots=4, num_choices=0)
        ue.build_float(bad)(x, x)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _brute_band_2d(ptape, mat, size):
    p = camera.pixel_centers(size)
    X, Y = np.meshgrid(p, p)
    if mat is not None:
        X, Y = camera.transform2(mat, X, Y)
    return np.abs(oracle.eval_f(ptape, X, Y)) <= FILL_BAND


R2 = {"circle": (lambda S: S.circle(0.7), None, 256),
      "stress12_mat": (lambda S: S.stress_2d(12),
                       np.array([[0.9, 0.3, 0.05], [-0.25, 1.1, 0.0],
                                 [0.02, 0.05, 1.0]], np.float32), 128),
      "scaled": (lambda S: S.scale(S.ring(0.8, 0.4), 1.1, 0.8), None, 128)}


@pytest.mark.parametrize("name", sorted(R2))
def test_render2d_matches_jax_interp_and_brute(name):
    build, mat, size = R2[name]
    jtape, ptape = jcompile(build(jshapes)), mpr_tpu_torch.compile_tree(
        build(shapes))
    img = unrolled.render2d(ptape, mat=mat, size=size, device="cpu")
    assert img.shape == (size, size) and img.dtype == bool
    assert np.array_equal(img, jun.render2d(jtape, mat=mat, size=size))
    # the interpreters divide where a baked evaluator multiplies by the
    # reciprocal: pixels on the surface may differ
    band = _brute_band_2d(ptape, mat, size)
    for other in (pipeline2d.render2d(ptape, mat=mat, size=size,
                                      device="cpu"),
                  brute.render2d_brute(ptape, mat=mat, size=size,
                                       device="cpu")):
        assert not ((img != other) & ~band).any()


@pytest.mark.parametrize("name", ["random2", "random5", "all_ops"])
def test_render2d_of_random_tapes_equals_brute(name):
    _, ptape = _tapes(name)
    for mat in (None, camera.scale2(0.8)):
        img = unrolled.render2d(ptape, mat=mat, size=128, device="cpu")
        diff = img != brute.render2d_brute(ptape, mat=mat, size=128,
                                           device="cpu")
        assert not (diff & ~_brute_band_2d(ptape, mat, 128)).any()


def test_render2d_of_a_parametric_scene_takes_the_imms_input():
    """A tape with named parameters (examples/parametric.io) renders with
    imm-input evaluators; a parameter edit keeps the renderer's key."""
    res = scheme.run_file(str(EXAMPLES / "parametric.io"))
    tape = mpr_tpu_torch.compile_tree(shapes.union(*res.shapes))
    assert tape.params
    img = unrolled.render2d(tape, size=128, device="cpu")
    r = unrolled.get_renderer(tape, imm_inputs=True)
    assert r.imm_inputs and r.f.take_imms
    assert np.array_equal(img, brute.render2d_brute(tape, size=128,
                                                    device="cpu"))
    name = sorted(tape.params)[0]
    import dataclasses
    edited = dataclasses.replace(tape, imms=tape.imms_with(
        {name: float(tape.imms[tape.params[name][0]]) * 0.8}))
    assert unrolled.get_renderer(edited, imm_inputs=True) is r
    assert np.array_equal(unrolled.render2d(edited, size=128, device="cpu"),
                          brute.render2d_brute(edited, size=128,
                                               device="cpu"))
    with pytest.raises(ValueError, match="imm_inputs"):
        unrolled.UnrolledRenderer(tape).render2d(size=64, imms=tape.imms,
                                                 device="cpu")


R3 = {"spheres": (lambda S: S.union(S.sphere(0.6, cx=-0.2),
                                    S.sphere(0.4, cx=0.5, cy=0.3)), 128),
      "gyroid": (lambda S: S.intersection(S.gyroid(0.4, 0.08),
                                          S.sphere(0.85)), 128)}


@pytest.fixture(scope="module")
def jax_frames3d():
    """mpr_tpu's unrolled 3D frames under gui3d_view, with and without
    skip4, rendered once: {(name, skip4): (depth, normals)}."""
    mat = camera.gui3d_view()
    out = {}
    for name, (build, size) in R3.items():
        jtape = jcompile(build(jshapes))
        out[(name, False)] = jun.render3d(jtape, mat=mat, size=size)
        r = jun.UnrolledRenderer(jtape)
        r._obs[("3d", size)] = (8, 30, 1920, 4)   # far past the threshold
        assert r._skip4(size)
        out[(name, True)] = r.render3d(mat=mat, size=size)
    return out


@pytest.mark.parametrize("skip4", [False, True], ids=["full", "skip4"])
@pytest.mark.parametrize("name", sorted(R3))
def test_render3d_matches_jax_interp_and_brute(jax_frames3d, name, skip4):
    build, size = R3[name]
    ptape = mpr_tpu_torch.compile_tree(build(shapes))
    mat = camera.gui3d_view()
    r = unrolled.UnrolledRenderer(ptape)
    if skip4:
        r._obs[("3d", size)] = (8, 30, 1920, 4)
        assert r._skip4(size)
    depth, normals = r.render3d(mat=mat, size=size, device="cpu")
    jd, jn = jax_frames3d[(name, skip4)]
    assert depth.dtype == np.int32 and depth.shape == (size, size)
    assert np.array_equal(depth, jd)
    np.testing.assert_allclose(normals, jn, atol=1e-4, rtol=0)
    idepth, inormals = pipeline3d.render3d(ptape, mat=mat, size=size,
                                           device="cpu")
    assert np.array_equal(depth, idepth)
    np.testing.assert_allclose(normals, inormals, atol=1e-4, rtol=0)
    assert_depth(depth, brute.render3d_brute(ptape, mat=mat, size=size,
                                             device="cpu"),
                 ptape, depth_field(oracle.eval_f, ptape, mat, size))
    # counts of the stages that ran
    cnt = r._obs[("3d", size)]
    assert cnt[0] > 0 and cnt[1] > 0 and cnt[5] > 0


def test_render3d_without_normals_and_of_an_empty_and_a_full_volume():
    mat = camera.bench3d_view()
    for tree in (shapes.sphere(0.5, cz=5.0), shapes.sphere(5.0),
                 shapes.capped_sphere()):
        tape = mpr_tpu_torch.compile_tree(tree)
        depth, normals = unrolled.render3d(tape, mat=mat, size=64,
                                           with_normals=False, device="cpu")
        assert normals is None
        want = brute.render3d_brute(tape, mat=mat, size=64, device="cpu")
        assert np.array_equal(depth, want)
        d2, n2 = unrolled.render3d(tape, mat=mat, size=64, device="cpu")
        assert np.array_equal(d2, want)
        assert np.all(n2[want == 0] == 0)


def test_skip4_decision_follows_the_counts_and_refreshes():
    tape = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    r = unrolled.UnrolledRenderer(tape)
    key = ("3d", 64)
    assert not r._skip4_decide(key)
    r._obs[key] = (8, 30, 1920, 0, 0, 4)
    decisions = [r._skip4_decide(key) for _ in range(130)]
    # skipping, with the full ladder every 65th frame to refresh the count
    assert decisions[:64] == [True] * 64 and decisions[64] is False
    assert decisions[65:129] == [True] * 64 and decisions[129] is False
    r._obs[key] = (8, 30, 60, 0, 0, 4)
    assert not r._skip4_decide(key)


def test_steady_frame3d_returns_tensors_of_the_frame():
    tape = mpr_tpu_torch.compile_tree(shapes.two_spheres())
    r = unrolled.get_renderer(tape)
    mat = camera.bench3d_view()
    frame = r.steady_frame3d(mat, 64, device="cpu")
    depth, normals = frame(torch.as_tensor(mat))
    assert isinstance(depth, torch.Tensor) and depth.shape == (64, 64)
    assert normals.shape == (64, 64, 3)
    assert np.array_equal(depth.numpy(), brute.render3d_brute(
        tape, mat=mat, size=64, device="cpu"))


@pytest.mark.parametrize("skip4", [False, True], ids=["full", "skip4"])
def test_voxel_stage_in_chunks_equals_one_pass(monkeypatch, skip4):
    """The voxel stage takes at most VOXEL_LANES lanes a float launch: cut
    into many chunks, the frame's depth and normals equal the one-pass
    frame's, with voxel_launches(...) float evaluations."""
    build, size = R3["gyroid"]
    tape = mpr_tpu_torch.compile_tree(build(shapes))
    mat = camera.gui3d_view()
    one = unrolled.UnrolledRenderer(tape).render3d(
        mat=mat, size=size, device="cpu", skip4=skip4)
    calls = []
    real = ue.unrolled_float
    monkeypatch.setattr(ue, "unrolled_float",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(unrolled, "VOXEL_LANES", 4096 * 3)
    r = unrolled.UnrolledRenderer(tape)
    depth, normals = r.render3d(mat=mat, size=size, device="cpu",
                                skip4=skip4)
    n0, n1, n2 = r._obs[("3d", size)][:3]
    want = (unrolled.voxel_launches(n1, 16) if skip4
            else unrolled.voxel_launches(n2, 4))
    assert want > 2 and len(calls) == want
    assert np.array_equal(depth, one[0])
    assert np.array_equal(normals, one[1])
