"""PyTorch port: the 3D kernels' plain PyTorch versions equal the JAX kernels.

One slab of a 128^3 frame is rendered by the port on the CPU with the
inputs of kernels V (``voxel_eval_3d``) and D (``deriv_eval_3d``) recorded;
the same numpy arrays then go through ``mpr_tpu.ops.kernels3d`` as the rest
of the suite runs it on the CPU (Pallas in interpret mode) and through the
port's wrappers, which take their plain versions because the tensors lie on
the CPU.  The ``all_ops`` case has a per-row capacity of 4 clauses, so
some of its cells and all of its columns overflow it and run the full
tape.  Every branch of the port's
``deriv_clause`` is also held against ``_deriv_branch_list``.

Tolerance: values and gradients ``rtol 1e-6, atol 1e-6`` for tapes without
sin, cos, exp or log (the same IEEE float32 operations on both sides; NaNs
in the same places), and ``1e-5`` with them (torch's CPU kernels and XLA's
round those functions an ulp apart).  Single branches without those four
functions must be equal.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

from mpr_tpu.ops import kernels3d as jk3

import mpr_tpu_torch
from mpr_tpu_torch import config
from mpr_tpu_torch.frontend import shapes
from mpr_tpu_torch.frontend import tree as ttree
from mpr_tpu_torch.ops import kernels3d as tk3
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import camera, pipeline3d
from mpr_tpu_torch.tape.tape import Tape

from torch_port_cases import (TRANSCENDENTAL_OPS, all_ops_clauses,
                              one_torch_thread,  # noqa: F401
                              random_trees)

SIZE = 128
N_SIDE = SIZE // 64
S_CAP = 16
V_ROWS = 16            # cells handed to the JAX kernel (a multiple of cpi)
PROJECTIVE = camera.gui3d_view(0.4, -0.8, 0.35)

# name -> (tape, mat, row0, n_rows, cap_div); the tapes' capacity is 256, so
# the per-row capacity is 32 clauses, and 4 for all_ops (whose cells keep 3
# to 7 of its 68 clauses and whose columns keep about 20)
CASES = {
    "two_spheres": (lambda: mpr_tpu_torch.compile_tree(shapes.two_spheres()),
                    camera.gui3d_view(), 0, 2, 8),
    "all_ops": (lambda: Tape.from_arrays(**all_ops_clauses()),
                PROJECTIVE, 0, 2, 64),
    # cos and exp; the lower slab alone, under the identity
    "random": (lambda: mpr_tpu_torch.compile_tree(
        random_trees(ttree, mpr_tpu_torch.compile_tree, 1)[0]),
        camera.identity3(), 1, 1, 8),
}
_FRAMES = {}


def _tol(tape):
    if set(np.unique(tape.ops).tolist()) & TRANSCENDENTAL_OPS:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=1e-6, atol=1e-6)


def _frame(name):
    """The port's slab on the CPU with V's and D's inputs recorded, once
    per case: (tape, counts, {wrapper name: (args, kwargs)})."""
    if name in _FRAMES:
        return _FRAMES[name]
    make, mat, row0, n_rows, cap_div = CASES[name]
    tape = make()
    seen, saved = {}, {}
    for w in ("voxel_eval_3d", "deriv_eval_3d"):
        fn = saved[w] = getattr(tk3, w)

        def rec(*a, _fn=fn, _w=w, **k):
            seen[_w] = (a, k)
            return _fn(*a, **k)
        setattr(tk3, w, rec)
    try:
        td = TapeData.from_tape(tape, device="cpu")
        assert td.capacity == 256 and td.num_slots <= S_CAP
        with config.override(cap_div=cap_div):
            _, _, counts = pipeline3d.render3d_rows(
                td, torch.from_numpy(mat), SIZE, row0, n_rows, s_cap=S_CAP)
    finally:
        for w, fn in saved.items():
            setattr(tk3, w, fn)
    assert counts["n_amb1"] > 0 and counts["n_act"] > 0, counts
    _FRAMES[name] = (tape, counts, seen)
    return _FRAMES[name]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else t


def _pad_rows(a, rows):
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_voxel_eval_matches_jax(name):
    tape, counts, seen = _frame(name)
    a, k = seen["voxel_eval_3d"]
    (nmeta, order, order0, matf, words, imms, runs_full, branch_ops, tw, ti,
     runs, gmeta) = (_np(v) for v in a)
    # a sample of V_ROWS cells: overflowed rows first, then the others
    over = gmeta[:, 2] != 0
    rows = np.r_[np.flatnonzero(over)[:V_ROWS // 2],
                 np.flatnonzero(~over)][:V_ROWS]
    n = rows.size
    if name == "all_ops":
        assert over[rows].any() and not over[rows].all()
    nm = nmeta.copy()
    nm[0] = n
    sel = dict(order=_pad_rows(order[rows], V_ROWS),
               tw=_pad_rows(tw[rows], V_ROWS), ti=_pad_rows(ti[rows], V_ROWS),
               runs=_pad_rows(runs[rows], V_ROWS),
               gmeta=_pad_rows(gmeta[rows], V_ROWS))
    parents = _pad_rows(order0, N_SIDE ** 3)
    want = np.asarray(jk3.voxel_eval_3d(
        jnp.asarray(nm), jnp.asarray(sel["order"]), jnp.asarray(parents),
        jnp.asarray(matf), jnp.asarray(words), jnp.asarray(imms),
        jnp.asarray(runs_full), branch_ops, jnp.asarray(sel["tw"]),
        jnp.asarray(sel["ti"]), jnp.asarray(sel["runs"]),
        jnp.asarray(sel["gmeta"]), **k))
    got = tk3.voxel_eval_3d(
        torch.from_numpy(nm), torch.from_numpy(sel["order"]),
        torch.from_numpy(parents), *(torch.from_numpy(v) for v in (
            matf, words, imms, runs_full)), branch_ops,
        *(torch.from_numpy(sel[f]) for f in ("tw", "ti", "runs", "gmeta")),
        **k).numpy()
    assert got.shape == want.shape == (V_ROWS, 4096)
    assert np.allclose(got[:n], want[:n], equal_nan=True, **_tol(tape))
    assert np.isfinite(want[:n]).any() and (want[:n] < 0).any()
    assert not got[n:].any()        # rows past nmeta[0] come back zero


@pytest.mark.parametrize("name", sorted(CASES))
def test_deriv_eval_matches_jax(name):
    tape, counts, seen = _frame(name)
    a, k = seen["deriv_eval_3d"]
    (nmeta, order, matf, words, imms, runs_full, branch_ops, tw, ti, runs,
     gmeta, blocks) = (_np(v) for v in a)
    n_cols = blocks.shape[0]
    n = counts["n_act"]
    assert int(nmeta[0]) == n and tw.shape[0] == n
    if name == "all_ops":
        assert (gmeta[:n, 2] != 0).any()
    padded = [_pad_rows(v, n_cols) for v in (tw, ti, runs, gmeta)]
    want = np.asarray(jk3.deriv_eval_3d(
        *(jnp.asarray(v) for v in (nmeta, order, matf, words, imms,
                                   runs_full)), branch_ops,
        *(jnp.asarray(v) for v in padded), jnp.asarray(blocks), **k))
    got = tk3.deriv_eval_3d(*a, **k).numpy()
    assert got.shape == (n, 4, 4096) and want.shape == (n_cols, 4, 4096)
    assert np.allclose(got, want[:n], equal_nan=True, **_tol(tape))
    assert np.abs(np.nan_to_num(want[:n, 1:])).max() > 0


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.5, 1.5, (4, 96)).astype(np.float32)
    b = rng.uniform(-1.5, 1.5, (4, 96)).astype(np.float32)
    a[0, :8] = b[0, :8]                 # ties for min/max
    a[0, 8:12] = [0.0, -0.0, 1.0, -1.0]
    return a, b


@pytest.mark.parametrize("op", range(32))
def test_deriv_clause_matches_jax_branch(op):
    a, b = _operands(60 + op)
    imm = np.float32(0.37 + 0.11 * op) * (-1 if op % 3 == 0 else 1)
    want = jk3._deriv_branch_list()[op](tuple(jnp.asarray(v) for v in a),
                                        tuple(jnp.asarray(v) for v in b),
                                        jnp.float32(imm))
    got = tk3.deriv_clause(op, tuple(torch.from_numpy(v) for v in a),
                           tuple(torch.from_numpy(v) for v in b),
                           torch.tensor(imm))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (96,)
        if op in TRANSCENDENTAL_OPS:
            assert np.allclose(g, w, rtol=1e-6, atol=1e-6, equal_nan=True)
        else:
            assert np.array_equal(g, w, equal_nan=True), op


def test_deriv_clause_rejects_unknown_op():
    a, b = _operands(1)
    with pytest.raises(ValueError):
        tk3.deriv_clause(32, tuple(torch.from_numpy(v) for v in a),
                         tuple(torch.from_numpy(v) for v in b),
                         torch.tensor(0.5))


def test_plain_versions_work_in_chunks(monkeypatch):
    """The plain versions bound their register files by interpreting a
    chunk of rows at a time; the chunk size is no part of the result."""
    tape, counts, seen = _frame("two_spheres")
    a, k = seen["voxel_eval_3d"]
    whole_v = tk3.voxel_eval_3d_plain(*a, **k)
    a_d, k_d = seen["deriv_eval_3d"]
    whole_d = tk3.deriv_eval_3d_plain(*a_d, **k_d)
    assert counts["n_amb1"] > 7 and counts["n_act"] > 1
    monkeypatch.setattr(tk3, "PLAIN_ROWS", 7 * S_CAP * 4096)  # 7 cells, 1 tile
    assert torch.equal(tk3.voxel_eval_3d_plain(*a, **k), whole_v)
    assert torch.equal(tk3.deriv_eval_3d_plain(*a_d, **k_d), whole_d)


def test_cpu_inputs_take_the_plain_versions():
    """CPU tensors run the plain versions: no launch is counted and no
    kernel library is built."""
    from mpr_tpu_torch.utils.trace import COUNTS
    before = (tk3.voxel_eval_3d.launches, tk3.deriv_eval_3d.launches,
              COUNTS["builds.compile"], COUNTS["builds.load"])
    _, _, seen = _frame("two_spheres")
    for w in ("voxel_eval_3d", "deriv_eval_3d"):
        a, k = seen[w]
        getattr(tk3, w)(*a, **k)
    # and with s_cap passed and a launch shape forced: still the plain
    # version, equal to it
    forced = {"voxel_eval_3d": tk3.voxel_launch(S_CAP, 32, home="local",
                                                k=4),
              "deriv_eval_3d": tk3.deriv_launch(S_CAP, 32, 1, 256, k=2,
                                                parts=2)}
    for w, launch in forced.items():
        a, k = seen[w]
        got = getattr(tk3, w)(*a, **{**k, "s_cap": S_CAP, "launch": launch})
        want = getattr(tk3, w + "_plain")(*a, **{**k, "s_cap": S_CAP})
        assert torch.equal(got, want)
    assert (tk3.voxel_eval_3d.launches, tk3.deriv_eval_3d.launches,
            COUNTS["builds.compile"], COUNTS["builds.load"]) == before
