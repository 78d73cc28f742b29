"""PyTorch port: the copied JAX-free layers against their originals.

The Scheme and font frontends, the tape decompiler, the checkpoint and PNG
I/O and the NumPy oracle are copies kept inside ``mpr_tpu_torch`` so that
the port imports nothing of ``mpr_tpu``.  Each is held to the original on
the same inputs: tapes must be equal field by field (ops, slots, immediates
as bits, length), files byte for byte, and the oracle's three interpreters
bit for bit (NaNs in the same places).  The copy's ``eval_d`` is also held
against autograd of the port's plain interpreter (``eval_scan.eval_f``),
``rtol 1e-5``: the two differentiate the same clauses in another order of
operations.
"""

import pytest

torch = pytest.importorskip("torch")

import pathlib

import numpy as np

import mpr_tpu
from mpr_tpu import oracle as joracle
from mpr_tpu.frontend import font as jfont
from mpr_tpu.frontend import frep as jfrep
from mpr_tpu.frontend import scheme as jscheme
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jtree
from mpr_tpu.io import checkpoint as jcheckpoint
from mpr_tpu.io import png as jpng
from mpr_tpu.tape.decompile import tape_to_tree as jtape_to_tree
from mpr_tpu.tape.tape import Tape as JTape

import mpr_tpu_torch
from mpr_tpu_torch import oracle
from mpr_tpu_torch.frontend import font, frep, scheme, shapes
from mpr_tpu_torch.frontend import tree as ttree
from mpr_tpu_torch.io import checkpoint, png
from mpr_tpu_torch.ops import eval_scan
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.tape.decompile import tape_to_tree
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (all_ops_clauses, one_torch_thread,  # noqa: F401
                              random_boxes, random_trees)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
FIELDS = ("ops", "outs", "lhss", "rhss")


def _assert_same_tape(t, j):
    assert t.length == j.length and t.num_slots == j.num_slots
    assert t.axis_slots == j.axis_slots and t.result_slot == j.result_slot
    assert t.num_choices == j.num_choices
    for f in FIELDS:
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
    assert np.array_equal(t.imms.view(np.int32), j.imms.view(np.int32))
    assert np.array_equal(t.pack_words(), j.pack_words())
    assert {k: list(v) for k, v in t.params.items()} == \
        {k: list(v) for k, v in j.params.items()}


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        return bool(np.all((a.view(np.int32) == b.view(np.int32))
                           | (np.isnan(a) & np.isnan(b))))
    return bool(np.array_equal(a, b))


def _as_jtape(t):
    return JTape(**{k: getattr(t, k) for k in (
        "ops", "outs", "lhss", "rhss", "imms", "axis_slots", "result_slot",
        "num_slots", "num_choices")})


# ---- Scheme and font --------------------------------------------------------

@pytest.mark.parametrize("name", ["text_demo.io", "parametric.io"])
def test_scheme_scene_compiles_to_the_same_tape(name):
    path = str(EXAMPLES / name)
    res, jres = scheme.run_file(path), jscheme.run_file(path)
    assert len(res.shapes) == len(jres.shapes) >= 1
    assert res.bounds == jres.bounds
    t = mpr_tpu_torch.compile_tree(shapes.union(*res.shapes))
    j = mpr_tpu.compile_tree(jshapes.union(*jres.shapes))
    assert t.length > 20
    _assert_same_tape(t, j)


def test_scheme_string_builtins_match():
    src = """
    (define r (var r 0.4 0.1 0.9))
    (define a (move (circle r) (list 0.2 -0.1)))
    (define b (rotate-z (rectangle (list -0.3 -0.2) (list 0.3 0.2)) 0.4))
    (union (difference a b) (scale-x (circle 0.2 (list -0.5 0.5)) 1.5))
    """
    res, jres = scheme.run_string(src), jscheme.run_string(src)
    t = mpr_tpu_torch.compile_tree(shapes.union(*res.shapes))
    j = mpr_tpu.compile_tree(jshapes.union(*jres.shapes))
    _assert_same_tape(t, j)
    assert "r" in t.params


@pytest.mark.parametrize("chars", ["ABCDEFGHIJKLM", "NOPQRSTUVWXYZ",
                                   "abcdefghijklm", "nopqrstuvwxyz",
                                   "0123456789", " .,:;!?-+=/()'\""])
def test_font_glyphs_compile_to_the_same_tapes(chars):
    n = 0
    for ch in chars:
        assert font.have_glyph(ch) == jfont.have_glyph(ch), ch
        if not font.have_glyph(ch) or ch == " ":
            continue
        t = mpr_tpu_torch.compile_tree(font.glyph(ch, ttree.x(), ttree.y(),
                                                  0.1, -0.2))
        j = mpr_tpu.compile_tree(jfont.glyph(ch, jtree.x(), jtree.y(),
                                             0.1, -0.2))
        _assert_same_tape(t, j)
        n += 1
    assert n >= len(chars) // 2
    _assert_same_tape(mpr_tpu_torch.compile_tree(font.text(chars, -0.9, 0.1)),
                      mpr_tpu.compile_tree(jfont.text(chars, -0.9, 0.1)))


# ---- decompile, checkpoint, png --------------------------------------------

_RANDOM = random_trees(ttree, mpr_tpu_torch.compile_tree, 4)


def _pts(n=2048, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3))


def _tape(name):
    if name == "all_ops":
        return Tape.from_arrays(**all_ops_clauses())
    if name == "stress12":
        return mpr_tpu_torch.compile_tree(shapes.stress_2d(12))
    if name == "ring":
        return mpr_tpu_torch.compile_tree(shapes.ring())
    return mpr_tpu_torch.compile_tree(_RANDOM[int(name[len("random"):])])


TAPES = ["random0", "random1", "random2", "random3", "stress12", "ring"]


@pytest.mark.parametrize("name", TAPES)
def test_decompile_roundtrip(name):
    """tape -> tree -> tape computes the same values bit for bit, and the
    decompiled tree is the one the JAX package's decompiler builds."""
    tape = _tape(name)
    back = mpr_tpu_torch.compile_tree(tape_to_tree(tape))
    x, y, z = _pts()
    assert _bits_equal(oracle.eval_f(tape, x, y, z),
                       oracle.eval_f(back, x, y, z))
    jback = mpr_tpu.compile_tree(jtape_to_tree(_as_jtape(tape)))
    _assert_same_tape(back, jback)


def test_decompile_through_frep_reads_in_both_packages(tmp_path):
    tape = _tape("ring")
    p = str(tmp_path / "ring.frep")
    frep.dump([frep.ArchiveShape(tree=tape_to_tree(tape), name="ring")], p)
    back = mpr_tpu_torch.compile_tree(frep.load(p)[0].tree)
    jback = mpr_tpu.compile_tree(jfrep.load(p)[0].tree)
    _assert_same_tape(back, jback)
    x, y, z = _pts()
    assert _bits_equal(oracle.eval_f(tape, x, y, z),
                       oracle.eval_f(back, x, y, z))


def test_checkpoint_save_load(tmp_path):
    tape = _tape("stress12")
    fitted = (tape.imms + np.float32(0.125)).astype(np.float32)
    p = str(tmp_path / "t.npz")
    checkpoint.save_tape(p, tape, imms=fitted)
    back = checkpoint.load_tape(p)
    for f in FIELDS:
        assert np.array_equal(getattr(back, f), getattr(tape, f))
    assert np.array_equal(back.imms, fitted)
    assert back.axis_slots == tape.axis_slots
    # the JAX package reads the port's checkpoint, and the other way round
    jback = jcheckpoint.load_tape(p)
    _assert_same_tape(back, jback)
    q = str(tmp_path / "j.npz")
    jcheckpoint.save_tape(q, _as_jtape(tape))
    _assert_same_tape(checkpoint.load_tape(q), _as_jtape(tape))


def test_png_bytes_equal_and_read_back(tmp_path):
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (40, 56), dtype=np.uint8)
    rgb = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    for name, img in (("g", gray), ("c", rgb), ("b", gray > 127)):
        a, b = tmp_path / f"{name}_t.png", tmp_path / f"{name}_j.png"
        png.write_png(str(a), img)
        jpng.write_png(str(b), img)
        assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(png.read_png_gray(str(tmp_path / "g_t.png")), gray)
    assert np.array_equal(png.read_png_gray(str(tmp_path / "g_t.png")),
                          jpng.read_png_gray(str(tmp_path / "g_t.png")))


# ---- the NumPy oracle --------------------------------------------------------

ORACLE_TAPES = TAPES + ["all_ops"]


@pytest.mark.parametrize("name", ORACLE_TAPES)
def test_oracle_eval_f_and_eval_d_equal_bit_for_bit(name):
    tape = _tape(name)
    jt = _as_jtape(tape)
    x, y, z = _pts()
    assert _bits_equal(oracle.eval_f(tape, x, y, z),
                       joracle.eval_f(jt, x, y, z))
    for a, b in zip(oracle.eval_d(tape, x, y, z),
                    joracle.eval_d(jt, x, y, z)):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("name", ORACLE_TAPES)
def test_oracle_eval_i_equals_bit_for_bit(name, widen):
    from mpr_tpu import config as jconfig
    from mpr_tpu_torch import config
    tape = _tape(name)
    jt = _as_jtape(tape)
    b = random_boxes(np.random.default_rng(11), 256)
    with config.override(widen_intervals=widen):
        got = oracle.eval_i(tape, *b)
    with jconfig.override(widen_intervals=widen):
        want = joracle.eval_i(jt, *b)
    assert len(got) == len(want) == 3
    for a, w in zip(got, want):
        assert _bits_equal(a, w)


def test_oracle_tight_sincos_equals_bit_for_bit():
    from mpr_tpu import config as jconfig
    from mpr_tpu_torch import config
    tape = mpr_tpu_torch.compile_tree(
        ttree.sin(ttree.x() * 3.0) + ttree.cos(ttree.y() * 2.0))
    b = random_boxes(np.random.default_rng(12), 256)
    with config.override(tight_sincos=True):
        got = oracle.eval_i(tape, *b)
    with jconfig.override(tight_sincos=True):
        want = joracle.eval_i(_as_jtape(tape), *b)
    for a, w in zip(got[:2], want[:2]):
        assert _bits_equal(a, w)
    loose = oracle.eval_i(tape, *b)
    assert (got[1] - got[0] <= loose[1] - loose[0]).all()


def test_oracle_shorten_equals(tmp_path):
    tape = _tape("stress12")
    b = random_boxes(np.random.default_rng(13), 8, width=0.3)
    _, _, ch = oracle.eval_i(tape, *b)
    for lane in range(8):
        got = oracle.shorten(tape, ch[:, lane])
        want = joracle.shorten(_as_jtape(tape), ch[:, lane])
        _assert_same_tape(got, want)


@pytest.mark.parametrize("name", ["random0", "random2", "stress12", "ring"])
def test_oracle_eval_d_agrees_with_autograd(name):
    """Forward-mode dual numbers (the oracle) against reverse-mode autograd
    of the plain interpreter, away from the kinks of min, max and abs."""
    tape = _tape(name)
    td = TapeData.from_tape(tape, device="cpu")
    x, y, z = _pts(512, seed=8)
    v, dx, dy, dz = oracle.eval_d(tape, x, y, z)
    p = torch.from_numpy(np.stack([x, y, z])).requires_grad_(True)
    out = eval_scan.eval_f(td, p[0], p[1], p[2])
    out.sum().backward()
    g = p.grad.numpy()
    assert np.allclose(out.detach().numpy(), v, rtol=1e-6, atol=1e-6)
    ok = np.isfinite(g).all(axis=0) & np.isfinite(dx)
    assert ok.mean() > 0.9
    for got, want in zip((dx, dy, dz), g):
        assert np.allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
