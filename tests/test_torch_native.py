"""The port's native (C++) tape compiler (mpr_tpu_torch/native/).

Its tapes must be BIT-IDENTICAL to the port's Python passes and to the JAX
package's native compiler on the same trees (made in each package from the
same builders): clause order (the op-run scheduler's tie-breaking
included), slots, immediates and metadata, in both schedules.  Also: the
edge cases keep the JAX package's behaviour and messages, ``'auto'`` takes
the native path, the C++ source is a copy of the JAX package's, and the
library is built under ``build/mpr_tpu_torch/native/<source key>/``.
"""

import pathlib
import re

import numpy as np
import pytest

import mpr_tpu_torch
from mpr_tpu import native as jnative
from mpr_tpu.frontend import scheme as jscheme
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jT
from mpr_tpu.tape.tape import TapeError as JTapeError
from mpr_tpu.tape.tape import compile_tree as jcompile
from mpr_tpu_torch import native
from mpr_tpu_torch.frontend import scheme, shapes
from mpr_tpu_torch.frontend import tree as T
from mpr_tpu_torch.tape.tape import TapeError, compile_tree
from torch_port_cases import random_trees

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
SCHEDULES = ("opruns", "dfs")
N_RANDOM = 10
PORT = (shapes, T, scheme)
JAX = (jshapes, jT, jscheme)


def _example(pkg, name):
    """A tree of ``examples/<name>`` built with one package's frontend: a
    ``.io`` scene's shapes or a script's ``shape``/``shapes`` under the
    viewer's script protocol, unioned."""
    shp, tr, sch = pkg
    path = EXAMPLES / name
    if name.endswith(".io"):
        return shp.union(*sch.run_file(str(path)).shapes)
    ns = {k: getattr(shp, k) for k in dir(shp) if not k.startswith("_")}
    ns.update({k: getattr(tr, k) for k in (
        "x", "y", "z", "const", "var", "minimum", "maximum", "sqrt",
        "square", "sin", "cos", "tan", "asin", "acos", "atan", "exp", "log",
        "neg", "abs_", "atan2", "pow_", "nth_root", "compare", "recip",
        "Tree") if hasattr(tr, k)})
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return (shp.union(*ns["shapes"]) if isinstance(ns.get("shapes"), list)
            else ns["shape"])


def _random(pkg, k):
    _, tr, _ = pkg
    comp = jcompile if pkg is JAX else compile_tree
    return random_trees(tr, lambda t: comp(t, backend="python"),
                        N_RANDOM)[k]


TREES = {
    "circle": lambda p: p[0].circle(0.7),
    "sphere": lambda p: p[0].sphere(0.6, 0.1, -0.2, 0.05),
    "two_spheres": lambda p: p[0].two_spheres(),
    "capped_sphere": lambda p: p[0].capped_sphere(),
    "menger(2)": lambda p: p[0].menger(2),
    "gyroid": lambda p: p[0].gyroid(),
    "ring": lambda p: p[0].ring(),
    "torus_z": lambda p: p[0].torus_z(0.6, 0.2),
    "stress_2d(600)": lambda p: p[0].stress_2d(600),
    "stress_2d(1500)": lambda p: p[0].stress_2d(1500),
    "gyroid_scene": lambda p: p[0].intersection(p[0].gyroid(0.4, 0.08),
                                                p[0].sphere(0.85)),
    "extruded": lambda p: p[0].extrude_z(p[0].stress_2d(300), -0.4, 0.4),
}
PARAM_EXAMPLES = ("parametric.io",)
TREES.update({p.name: (lambda pkg, n=p.name: _example(pkg, n))
              for p in sorted(EXAMPLES.glob("*.py"))
              + sorted(EXAMPLES.glob("*.io"))
              if p.name not in PARAM_EXAMPLES})
TREES.update({f"random{k}": (lambda pkg, k=k: _random(pkg, k))
              for k in range(N_RANDOM)})

_cache = {}


def _tree(pkg, name):
    key = (pkg is JAX, name)
    if key not in _cache:
        _cache[key] = TREES[name](pkg)
    return _cache[key]


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.ops, b.ops)
    np.testing.assert_array_equal(a.outs, b.outs)
    np.testing.assert_array_equal(a.lhss, b.lhss)
    np.testing.assert_array_equal(a.rhss, b.rhss)
    assert a.imms.dtype == b.imms.dtype == np.float32
    np.testing.assert_array_equal(a.imms.view(np.int32),
                                  b.imms.view(np.int32))
    assert tuple(a.axis_slots) == tuple(b.axis_slots)
    assert a.result_slot == b.result_slot
    assert a.num_slots == b.num_slots
    assert a.num_choices == b.num_choices


def test_library_builds_and_loads():
    assert native.lib() is not None


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(TREES))
def test_native_matches_python(name, schedule):
    tree = _tree(PORT, name)
    nat = compile_tree(tree, schedule=schedule, backend="native")
    py = compile_tree(tree, schedule=schedule, backend="python")
    _assert_equal(nat, py)
    assert nat.length >= 1 and not nat.params


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(TREES))
def test_native_matches_jax_native(name, schedule):
    """The port's native tape equals the JAX package's native tape, and
    neither compiler took its silent fallback (``None``: the library's
    internal-mismatch code -2)."""
    from mpr_tpu.frontend.tree import lower_extended as jlower
    from mpr_tpu.tape.fuse import fuse_tree as jfuse
    from mpr_tpu_torch.frontend.tree import lower_extended
    from mpr_tpu_torch.tape.fuse import fuse_tree
    jt = _tree(JAX, name)
    pt = _tree(PORT, name)
    ours = native.compile_native(fuse_tree(lower_extended(pt)), schedule)
    theirs = jnative.compile_native(jfuse(jlower(jt)), schedule)
    assert ours is not None and theirs is not None
    _assert_equal(ours, theirs)
    _assert_equal(compile_tree(pt, schedule=schedule, backend="native"),
                  jcompile(jt, schedule=schedule, backend="native"))


def test_auto_takes_the_native_path(monkeypatch):
    calls = []
    real = native.compile_native

    def spy(tree, schedule="opruns"):
        calls.append(schedule)
        return real(tree, schedule)

    monkeypatch.setattr(native, "compile_native", spy)
    tree = shapes.stress_2d(40)
    auto = mpr_tpu_torch.compile_tree(tree)
    assert calls == ["opruns"]
    mpr_tpu_torch.compile_tree(tree, schedule="dfs")
    assert calls == ["opruns", "dfs"]
    mpr_tpu_torch.compile_tree(tree, backend="python")
    assert calls == ["opruns", "dfs"]
    _assert_equal(auto, compile_tree(tree, backend="python"))


def test_auto_falls_back_only_without_the_library(tmp_path, monkeypatch,
                                                  capsys):
    """Where the library cannot be built, ``'auto'`` runs the Python
    passes after one stderr line and ``'native'`` raises."""
    broken = tmp_path / "tape_compiler.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "SRC", broken)
    tree = shapes.circle(0.5)
    t = compile_tree(tree)
    err = capsys.readouterr().err
    assert err.count("\n") == 1
    assert "build failed" in err and "using pure-Python tape compiler" in err
    _assert_equal(t, compile_tree(tree, backend="python"))
    with pytest.raises(RuntimeError, match="native tape compiler "
                       "unavailable"):
        compile_tree(tree, backend="native")


@pytest.mark.parametrize("backend", ["auto", "python", "native"])
def test_constant_only_tree(backend):
    t = compile_tree(T.const(1.5) * T.const(2.0), backend=backend)
    j = jcompile(jT.const(1.5) * jT.const(2.0), backend=backend)
    _assert_equal(t, j)
    assert t.length == 1 and t.imms[0] == np.float32(3.0)


def _too_many_slots(tr, n=240):
    """Every ``t_i`` is live at once: the sum consumes them first to last,
    the product last to first."""
    ts = [tr.sin(tr.x() * tr.const(1.0 + 0.01 * i)) for i in range(n)]
    s = ts[0]
    for t in ts[1:]:
        s = s + t
    p = ts[-1]
    for t in reversed(ts[:-1]):
        p = p * t
    return s - p


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", ["native", "python"])
def test_past_224_slots(backend, schedule):
    with pytest.raises(JTapeError) as want:
        jcompile(_too_many_slots(jT), schedule=schedule, backend=backend)
    with pytest.raises(TapeError) as got:
        compile_tree(_too_many_slots(T), schedule=schedule, backend=backend)
    assert str(got.value) == str(want.value) == \
        "tape needs more than 224 slots"


def _msg(e):
    """A compiler message without its citation of the reference source,
    whose path differs between the packages' texts."""
    return re.sub(r" \(parity with .*\)$", "", str(e))


@pytest.mark.parametrize("op", ["mod", "var-free"])
@pytest.mark.parametrize("backend", ["native", "python"])
def test_unsupported_op(op, backend):
    def tree(tr):
        bad = (tr.Tree(op, tr.x(), tr.y()) if op == "mod"
               else tr.Tree(op))
        return tr.sqrt(tr.square(tr.x()) + tr.const(1.0)) + bad
    with pytest.raises(JTapeError) as want:
        jcompile(tree(jT), backend=backend)
    with pytest.raises(TapeError) as got:
        compile_tree(tree(T), backend=backend)
    assert _msg(got.value) == _msg(want.value) == \
        f"unimplemented opcode {op!r} in tape compiler"
    assert str(got.value).endswith(
        "(parity with reference/src/tape.cpp:182-196)")
    with pytest.raises(TapeError) as flat:
        native.flatten_tree(tree(T))
    assert str(flat.value) == str(got.value)


@pytest.mark.parametrize("name", PARAM_EXAMPLES)
def test_param_tree(name):
    """A tree with named parameters: ``'auto'`` gives the Python tape with
    its ``params``, ``'native'`` raises."""
    tree = _example(PORT, name)
    assert T.params_of(tree)
    t = compile_tree(tree)
    assert t.params and set(t.params) == set(T.params_of(tree))
    _assert_equal(t, compile_tree(tree, backend="python"))
    with pytest.raises(RuntimeError, match="does not support param"):
        compile_tree(tree, backend="native")
    jt = jcompile(_example(JAX, name))
    _assert_equal(t, jt)
    assert t.params == jt.params


def test_unknown_backend():
    with pytest.raises(ValueError, match="unknown tape compiler backend"):
        compile_tree(shapes.circle(0.5), backend="gpu")


def _code(path):
    """The C++ source without ``//`` comments and blank lines."""
    lines = (re.sub(r"//.*$", "", ln).rstrip()
             for ln in pathlib.Path(path).read_text().splitlines())
    return [ln for ln in lines if ln.strip()]


def test_source_is_a_copy_outside_comments():
    ours = _code(REPO / "mpr_tpu_torch/native/tape_compiler.cpp")
    theirs = _code(REPO / "mpr_tpu/native/tape_compiler.cpp")
    assert len(ours) > 200
    assert ours == theirs


def test_library_location_and_key(tmp_path, monkeypatch):
    so = native.library_path()
    assert so.parent.parent == REPO / "build" / "mpr_tpu_torch" / "native"
    assert so.name == "libmpr_tape.so"
    assert so.parent.name == native.source_key()
    native.lib()
    assert so.is_file()
    key = native.source_key()
    edited = tmp_path / "tape_compiler.cpp"
    edited.write_text(native.SRC.read_text() + "\n// an edit\n")
    monkeypatch.setattr(native, "SRC", edited)
    assert native.source_key() != key
    assert native.library_path().parent.name == native.source_key()


def test_build_replaces_atomically(tmp_path, monkeypatch):
    """A forced build goes through a temporary file renamed into place and
    leaves no temporary file behind."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    so = native.build(force=True)
    assert so is not None and pathlib.Path(so).is_file()
    assert pathlib.Path(so).parent.parent == tmp_path
    left = [p.name for p in pathlib.Path(so).parent.iterdir()]
    assert left == ["libmpr_tape.so"]
