"""The plain reference against values worked by hand on tiny scenes, the
frozen scene builders against the port's own, and the import guard."""

from __future__ import annotations

import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench_tiny import ROOT, core
from portbench import expr
from portbench.expr import sqrt, square, x, y, z
from portbench.reference import fit, render

I3 = np.eye(3, dtype=np.float32)
I4 = np.eye(4, dtype=np.float32)


def test_centers():
    assert render.centers(4, "cpu").tolist() == [-0.75, -0.25, 0.25, 0.75]


def test_fill_of_a_disc():
    # 4 x 4 pixels, centres +-0.25 and +-0.75: only the middle four lie
    # within 0.5 of the origin (0.354 against 0.791 and 1.061)
    e = sqrt(square(x()) + square(y())) - 0.5
    want = torch.zeros(4, 4, dtype=torch.bool)
    want[1:3, 1:3] = True
    assert render.fill_gap(e, I3, 4, lambda a, b: want[a:b], "cpu") == (
        0.0, 0)
    off = want.clone()
    off[0, 0] = True
    gap, n = render.fill_gap(e, I3, 4, lambda a, b: off[a:b], "cpu")
    assert n == 1 and gap == pytest.approx(math.hypot(0.75, 0.75) - 0.5)


def test_fill_follows_the_view():
    # scale 0.5 and a shift of 0.25 in x: pixel centre c lands at c/2+1/4
    e = x() - 0.3
    m = I3.copy()
    m[0, 0] = m[1, 1] = 0.5
    m[0, 2] = 0.25
    f = render.field2d(e, m, 4, 0, 4, "cpu")
    assert f[0].tolist() == pytest.approx([-0.425, -0.175, 0.075, 0.325])


def test_depth_and_normals_of_a_sphere():
    # 4^3 voxels: (+-0.25, +-0.25, 0.25) is the top filled voxel (0.433 <
    # 0.5 < 0.829), z index 2, so depth 3; the normal is taken at z index 3
    e = sqrt(square(x()) + square(y()) + square(z())) - 0.5
    d, n = render.render3d(e, I4, 4, "cpu")
    want = torch.zeros(4, 4, dtype=torch.int32)
    want[1:3, 1:3] = 3
    assert torch.equal(d, want)
    g = np.array([0.25, 0.25, 0.75]) / math.sqrt(0.25 ** 2 * 2 + 0.75 ** 2)
    assert n[2, 2].tolist() == pytest.approx(g.tolist(), abs=1e-6)
    assert n[1, 1].tolist() == pytest.approx([-g[0], -g[1], g[2]], abs=1e-6)
    assert not n[0].any()
    assert render.depth_gaps(e, I4, 4, d, n, "cpu") == (0.0, 0, 0.0)
    deeper = d.clone()
    deeper[1, 1] = 4
    dgap, n_off, _ = render.depth_gaps(e, I4, 4, deeper, n, "cpu")
    assert n_off == 1 and dgap == pytest.approx(
        math.sqrt(0.25 ** 2 * 2 + 0.75 ** 2) - 0.5, abs=1e-6)


def test_seam_takes_either_side():
    # max(x, y) on the diagonal: both gradients are normals there
    e = expr.maximum(x() - 0.1, y() - 0.1)
    xs = torch.tensor([0.5])
    ys = torch.tensor([0.5])
    for flip, want in ((None, [1.0, 0.0]), (1e-4, [0.0, 1.0])):
        p = [xs.clone().requires_grad_(True), ys.clone().requires_grad_(True)]
        from portbench.reference import evaluate
        v = evaluate(e, p[0], p[1], flip=flip)
        g = torch.autograd.grad(v.sum(), p)
        assert [float(t) for t in g] == want


def test_one_fit_step_by_hand():
    # f = x - c on a 2 x 2 image (centres +-0.5) against the fill of x < 0
    c0, lr, k = 0.1, 0.5, 20.0
    e = x() - c0
    target = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    losses, states = fit.steps(e, target, lr, 1, sharpness=k)
    f = np.array([-0.5 - c0, 0.5 - c0])
    soft = np.tanh(-k * f) / 2 + 0.5
    loss = ((soft - [1.0, 0.0]) ** 2).mean()
    # d soft / d c = (k / 2) (1 - tanh^2(-k f)), since d f / d c = -1
    dsoft = k / 2 * (1 - np.tanh(-k * f) ** 2)
    grad = (2 * (soft - [1.0, 0.0]) * dsoft).mean()
    assert losses[0] == pytest.approx(loss, rel=1e-5)
    assert float(states[1][0]) == pytest.approx(c0 - lr * grad, rel=1e-5)


def test_fit_gaps():
    s = [torch.tensor([1.0, 2.0]), torch.tensor([0.9, 2.0]),
         torch.tensor([0.8, 2.0])]
    g = fit.gaps([1.0, 0.5], s, [1.0, 0.5], s, 0.1)
    assert g == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    g = fit.gaps([1.0, 0.5], [s[0]] * 3, [1.0, 0.25], s, 0.1)
    assert g["loss_gap"] == 1.0 and g["grad_gap"] == pytest.approx(1.0)
    assert g["change_gap"] == pytest.approx(1.0)


def test_parameters_are_the_tape_immediates():
    from portbench.scenes import stress_2d
    from portbench.reference.evaluate import leaf_params
    e = stress_2d.build(60, 2020)
    # a compiled tape has one immediate a node with a constant operand
    imms = sum(any(a.op == "const" for a in n.args) for n in e.nodes())
    assert len(leaf_params(e)[0]) == imms


@pytest.mark.parametrize("scene,port", [
    ("stress_2d", lambda S: S.stress_2d(600)),
    ("gyroid_sphere", lambda S: S.intersection(S.gyroid(0.4, 0.08),
                                               S.sphere(0.85)))])
def test_scenes_are_the_ports_own(scene, port):
    from mpr_tpu_torch.frontend import shapes
    from portbench import program
    cfg = {"prospero_2d": "stress_2d", "gyroid_3d": "gyroid_sphere"}
    name = next(k for k, v in cfg.items() if v == scene)
    e = core.scene(core.load_json(core.HERE / "configs" / f"{name}.json"))
    assert program.to_tree(e) is port(shapes)


def test_perturbed_keeps_the_structure():
    from portbench.scenes import stress_2d
    e = stress_2d.build(30, 2020)
    p = expr.perturbed(e, 5, 0.02)
    a, b = e.nodes(), p.nodes()
    assert [n.op for n in a] == [n.op for n in b]
    ratio = [m.value / n.value for n, m in zip(a, b) if n.op == "const"
             and n.value]
    assert 0.9 < min(ratio) and max(ratio) < 1.1 and ratio != [1.0] * len(
        ratio)
    assert expr.perturbed(e, 5, 0.02) is p


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.render, portbench.reference.fit; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mpr_tpu', 'mpr_tpu_torch')]; "
            "print(bad)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("mpr_tpu_torch.fake", "jaxlike", "portbench_jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.forbidden_modules() == [
        m for m in sorted(sys.modules) if m.split(".")[0] in core.FORBIDDEN]
    assert not any(m.startswith(("mpr_tpu_torch", "jaxlike", "portbench"))
                   for m in core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "mpr_tpu.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"mpr_tpu.fake", "jax"} <= set(core.forbidden_modules())
