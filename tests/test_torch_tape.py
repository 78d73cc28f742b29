"""PyTorch port: the tape layers agree with mpr_tpu bit for bit.

The port keeps its own copies of the JAX-free layers (frontend, tape
compiler, camera, config) and its own device tape; these tests hold each
against the JAX package on the same inputs, built from seeds with numpy.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import mpr_tpu
from mpr_tpu.frontend import frep as jfrep
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jtree
from mpr_tpu.ops import interval_math as jim
from mpr_tpu.ops import transcendental as jtc
from mpr_tpu.ops.tape_data import TapeData as JTapeData
from mpr_tpu.render import camera as jcamera

import mpr_tpu_torch
from mpr_tpu_torch.frontend import frep, shapes
from mpr_tpu_torch.frontend import tree as ttree
from mpr_tpu_torch.ops import interval_math as im
from mpr_tpu_torch.ops import transcendental as tc
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import camera
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import one_torch_thread, random_trees  # noqa: F401

FIELDS = ("ops", "outs", "lhss", "rhss", "imms")
N_RANDOM = 6
_JT = random_trees(jtree, mpr_tpu.compile_tree, N_RANDOM)
_TT = random_trees(ttree, mpr_tpu_torch.compile_tree, N_RANDOM)

NAMED = {
    "circle": lambda S: S.circle(0.8),
    "ring": lambda S: S.ring(),
    "stress40": lambda S: S.stress_2d(40),
}


def _same_tape(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("axis_slots", "result_slot", "num_slots", "num_choices"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name", sorted(NAMED))
def test_compile_tree_matches_jax(name):
    _same_tape(mpr_tpu_torch.compile_tree(NAMED[name](shapes)),
               mpr_tpu.compile_tree(NAMED[name](jshapes)))


@pytest.mark.parametrize("i", range(N_RANDOM))
def test_compile_tree_matches_jax_random(i):
    _same_tape(mpr_tpu_torch.compile_tree(_TT[i]),
               mpr_tpu.compile_tree(_JT[i]))


@pytest.mark.parametrize("name", ["stress40", "random0", "random3"])
def test_tape_data_matches_jax(name):
    if name in NAMED:
        t = mpr_tpu_torch.compile_tree(NAMED[name](shapes))
        jt = mpr_tpu.compile_tree(NAMED[name](jshapes))
    else:
        i = int(name[len("random"):])
        t = mpr_tpu_torch.compile_tree(_TT[i])
        jt = mpr_tpu.compile_tree(_JT[i])
    td = TapeData.from_tape(t, device="cpu")
    jtd = JTapeData.from_tape(jt)
    for f in ("packed", "imms", "runs"):
        assert np.array_equal(getattr(td, f).numpy(),
                              np.asarray(getattr(jtd, f))), f
    for f in ("length", "num_slots", "axis_slots", "result_slot",
              "num_choices", "ops_present", "num_runs", "capacity"):
        assert getattr(td, f) == getattr(jtd, f), f


def test_tape_data_from_arrays_round_trip():
    """A JAX TapeData carried across with from_arrays equals the port's
    own from_tape of the same tape."""
    jtd = JTapeData.from_tape(mpr_tpu.compile_tree(jshapes.stress_2d(40)))
    td = TapeData.from_arrays(
        np.asarray(jtd.packed), np.asarray(jtd.imms), np.asarray(jtd.runs),
        length=jtd.length, num_slots=jtd.num_slots,
        axis_slots=jtd.axis_slots, result_slot=jtd.result_slot,
        num_choices=jtd.num_choices, ops_present=jtd.ops_present,
        num_runs=jtd.num_runs, device="cpu")
    own = TapeData.from_tape(
        mpr_tpu_torch.compile_tree(shapes.stress_2d(40)), device="cpu")
    for f in ("packed", "imms", "runs"):
        assert torch.equal(getattr(td, f), getattr(own, f)), f
    assert td.meta().tolist() == own.meta().tolist()
    assert td.device == torch.device("cpu")


def test_tape_from_arrays_round_trip():
    jt = mpr_tpu.compile_tree(_JT[1])
    t = Tape.from_arrays(*(np.asarray(getattr(jt, f)) for f in FIELDS),
                         axis_slots=jt.axis_slots, result_slot=jt.result_slot,
                         num_slots=jt.num_slots, num_choices=jt.num_choices)
    _same_tape(t, jt)
    assert t.tree is None


def test_frep_archives_cross_load():
    """.frep archives written by either package load in the other to the
    same tape."""
    blob = jfrep.dumps([jfrep.ArchiveShape(tree=_JT[2], name="s")])
    back = frep.loads(blob)[0]
    _same_tape(mpr_tpu_torch.compile_tree(back.tree),
               mpr_tpu.compile_tree(_JT[2]))
    blob2 = frep.dumps([frep.ArchiveShape(tree=_TT[4], name="t")])
    assert blob2 == jfrep.dumps([jfrep.ArchiveShape(tree=_JT[4], name="t")])


def test_cephes_forms_match_jax():
    """atan/asin/acos on torch round exactly as the JAX package's forms
    (the CUDA header repeats the same operations)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4000),
                        rng.uniform(-60, 60, 4000),
                        [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.414213562373095,
                         0.4142135623730951, np.inf, -np.inf, np.nan]]
                       ).astype(np.float32)
    xt = torch.from_numpy(x)
    for f, jf in ((tc.atan, jtc.atan), (tc.asin, jtc.asin),
                  (tc.acos, jtc.acos)):
        got = f(xt).numpy()
        want = np.asarray(jf(jnp.asarray(x)))
        assert np.array_equal(got, want, equal_nan=True), f.__name__


def test_interval_math_on_torch_matches_jax():
    """interval_math with xp=torch (its select stands in for np.select)
    equals the JAX package's with xp=jnp, including spanning divisors."""
    import jax.numpy as jnp
    rng = np.random.default_rng(6)
    n = 2000
    al = rng.uniform(-2, 2, n).astype(np.float32)
    ah = (al + rng.uniform(0, 2, n)).astype(np.float32)
    bl = rng.uniform(-2, 2, n).astype(np.float32)
    bh = (bl + rng.uniform(0, 2, n)).astype(np.float32)
    bl[:50] = 0.0
    t = [torch.from_numpy(v) for v in (al, ah, bl, bh)]
    j = [jnp.asarray(v) for v in (al, ah, bl, bh)]
    for name in ("i_div", "i_mul"):
        got = getattr(im, name)(torch, *t)
        want = getattr(jim, name)(jnp, *j)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), name
    for g, w in zip(im.widen(torch, t[0], t[1]), jim.widen(jnp, j[0], j[1])):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_camera_matches_jax():
    for name in ("identity2", "identity3", "bench3d_view"):
        assert np.array_equal(getattr(camera, name)(),
                              getattr(jcamera, name)())
    assert np.array_equal(camera.scale2(0.7), jcamera.scale2(0.7))
    assert np.array_equal(camera.pixel_centers(96),
                          jcamera.pixel_centers(96))
