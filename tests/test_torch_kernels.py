"""PyTorch port: each kernel's plain PyTorch version equals the JAX kernel.

Inputs are built with numpy from seeds, the JAX side runs exactly as the
rest of the suite runs it on the CPU (Pallas in interpret mode), and the
port's wrappers take their plain versions because the tensors lie on the
CPU.  All JAX kernel calls share one branch set (every opcode) and one
capacity, so each JAX kernel compiles once per module.

Tolerance: status, codes, compacted tapes, run headers and gmeta are
integers and must be equal.  Kernel B's fill must be equal too, except
that for tapes whose float pass runs sin, cos, exp or log (torch's CPU
kernels and XLA's round those differently by an ulp) a pixel may differ
where the NumPy oracle's |f| <= FILL_BAND; each test counts those pixels.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import mpr_tpu
from mpr_tpu import oracle
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jtree
from mpr_tpu.ops import kernels as jk
from mpr_tpu.ops.tape_data import TapeData as JTapeData
from mpr_tpu.render import pipeline2d as jp2d
from mpr_tpu.tape.tape import Tape as JTape

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes as tshapes
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import pipeline2d as tp2d
from mpr_tpu_torch.tape.opcodes import Op

from torch_port_cases import (all_ops_clauses, one_torch_thread,  # noqa: F401
                              random_boxes, random_trees, unpack_codes)

TCAP = 512
S_CAP = 128
FILL_BAND = 1e-5
ALL_BRANCHES, ALL_REMAP = jk.build_remap(tuple(range(2, 32)))
_TRANSCENDENTAL = {int(Op.SIN_LHS), int(Op.COS_LHS), int(Op.EXP_LHS),
                   int(Op.LOG_LHS)}

_RANDOM = random_trees(jtree, mpr_tpu.compile_tree, 6)


def _jtape(name):
    if name == "all_ops":
        return JTape(**all_ops_clauses())
    if name == "stress40":
        return mpr_tpu.compile_tree(jshapes.stress_2d(40))
    if name == "ring":
        return mpr_tpu.compile_tree(jshapes.ring())
    return mpr_tpu.compile_tree(_RANDOM[int(name[len("random"):])])


NAMES = ["random0", "random1", "random2", "random3", "random4", "random5",
         "all_ops", "stress40"]


def _tape_arrays(name):
    jt = _jtape(name)
    jtd = JTapeData.from_tape(jt, pad_to=TCAP)
    assert jtd.num_slots <= S_CAP
    meta = np.array([jtd.length, jtd.num_slots, jtd.result_slot,
                     *jtd.axis_slots, jtd.num_runs, 0], np.int32)
    runs = np.asarray(jtd.runs)
    runs_b = (ALL_REMAP[runs & 0xFF] | (runs & ~0xFF)).astype(np.int32)
    return jt, jtd, meta, runs_b


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_a(jtd, meta, runs_b, boxes, widen=False):
    st, codes = jk.interval_shorten(
        jnp.asarray(meta), jtd.packed, jtd.imms, jnp.asarray(runs_b),
        jnp.asarray(boxes), branch_ops=ALL_BRANCHES, s_cap=S_CAP, widen=widen)
    return np.asarray(st), np.asarray(codes)


def _plain_a(jtd, meta, boxes, widen=False):
    st, codes = tk.interval_shorten(_t(meta), _t(jtd.packed), _t(jtd.imms),
                                    _t(boxes), s_cap=S_CAP, widen=widen)
    return st.numpy(), codes.numpy()


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_interval_shorten_matches_jax(name):
    jt, jtd, meta, runs_b = _tape_arrays(name)
    boxes = random_boxes(np.random.default_rng(31), 64)
    st, codes = _jax_a(jtd, meta, runs_b, boxes)
    pst, pcodes = _plain_a(jtd, meta, boxes)
    assert np.array_equal(pst, st)
    assert np.array_equal(unpack_codes(pcodes, jt.length),
                          unpack_codes(codes, jt.length))


@pytest.mark.parametrize("name", ["random1", "stress40"])
def test_interval_shorten_widen_matches_jax(name):
    jt, jtd, meta, runs_b = _tape_arrays(name)
    boxes = random_boxes(np.random.default_rng(32), 64)
    st, codes = _jax_a(jtd, meta, runs_b, boxes, widen=True)
    pst, pcodes = _plain_a(jtd, meta, boxes, widen=True)
    assert np.array_equal(pst, st)
    assert np.array_equal(unpack_codes(pcodes, jt.length),
                          unpack_codes(codes, jt.length))


def test_interval_shorten_lane_skip():
    """meta[7] = n_active: lanes below it are computed exactly; the lanes
    past it are garbage by design and not compared."""
    jt, jtd, meta, runs_b = _tape_arrays("stress40")
    boxes = random_boxes(np.random.default_rng(33), 64)
    meta = meta.copy()
    meta[7] = 40
    st, codes = _jax_a(jtd, meta, runs_b, boxes)
    pst, pcodes = _plain_a(jtd, meta, boxes)
    assert np.array_equal(pst[:40], st[:40])
    assert np.array_equal(unpack_codes(pcodes[:40], jt.length),
                          unpack_codes(codes[:40], jt.length))


# ---------------------------------------------------------------------------
# Prepass and kernel C
# ---------------------------------------------------------------------------

def _stage_inputs(name, lanes=32, seed=34):
    """Kernel A outputs on random boxes plus one box over the whole view
    (whose tape barely shortens, so it overflows a small cap), ambiguous
    rows first."""
    jt, jtd, meta, runs_b = _tape_arrays(name)
    boxes = random_boxes(np.random.default_rng(seed), lanes)
    boxes[:, 0] = [-1, 1, -1, 1, -1, 1]
    st, codes = _jax_a(jtd, meta, runs_b, boxes)
    order = np.argsort(st != tk.ST_AMBIG, kind="stable").astype(np.int32)
    return jt, jtd, meta, runs_b, st, codes, order


def test_shorten_prepass_matches_jax():
    jt, jtd, meta, runs_b, st, codes, order = _stage_inputs("stress40")
    csel = codes[order]
    want = jp2d._shorten_prepass(jnp.asarray(csel), jtd.packed, jtd.imms,
                                 jnp.int32(jt.length), jnp.asarray(ALL_REMAP))
    got = tp2d._shorten_prepass(_t(csel), _t(jtd.packed), _t(jtd.imms),
                                jt.length, _t(ALL_REMAP))
    for g, w in zip(got, want):
        w = np.asarray(w)[:csel.shape[0]]
        assert np.array_equal(g.numpy(), w)


def _prepass(jt, jtd, codes, order, rows=8):
    return tp2d._shorten_prepass(_t(codes[order]), _t(jtd.packed),
                                 _t(jtd.imms), jt.length, _t(ALL_REMAP),
                                 rows=rows)


# rows = 8 is the 2D pipeline's plane shape; rows = 2 the 3D child stage's
@pytest.mark.parametrize("name,cap,rows", [("stress40", TCAP // 8, 8),
                                           ("stress40", TCAP // 4, 8),
                                           ("all_ops", TCAP // 8, 8),
                                           ("stress40", TCAP // 2, 2)])
def test_compact_matches_jax(name, cap, rows):
    jt, jtd, meta, runs_b, st, codes, order = _stage_inputs(name)
    wrw, irw, rem, lens = _prepass(jt, jtd, codes, order, rows)
    n_amb = int((st == tk.ST_AMBIG).sum())
    cmeta = np.array([n_amb, cap, cap, 0, 0, 0, 0, 0], np.int32)
    want = jk.compact_bitshift_batched(
        jnp.asarray(cmeta), jnp.asarray(lens.numpy()),
        jnp.asarray(wrw.numpy()), jnp.asarray(irw.numpy()),
        jnp.asarray(rem.numpy()), cap=cap, tpi=16)
    got = tk.compact_bitshift_batched(_t(cmeta), lens, wrw, irw, rem, cap)
    tw, ti, runs, gmeta = (np.asarray(w)[:n_amb] for w in want)
    ptw, pti, pruns, pgmeta = (g.numpy()[:n_amb] for g in got)
    assert np.array_equal(pgmeta[:, :3], gmeta[:, :3])
    over = gmeta[:, 2] == 1
    if name == "stress40" and cap == TCAP // 8 and rows == 8:
        assert over.any() and not over.all()
    for r in range(n_amb):
        n, nr = min(gmeta[r, 0], cap), min(gmeta[r, 1], cap)
        assert np.array_equal(ptw[r, :n], tw[r, :n]), r
        assert np.array_equal(pti[r, :n], ti[r, :n]), r
        assert np.array_equal(pruns[r, :nr], runs[r, :nr]), r
    # zero past the tape, as the JAX kernel writes
    assert np.array_equal(ptw, tw) and np.array_equal(pruns, runs)


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------

def _fill_case(name, cap, n_side):
    """Every stage of an (n_side*64)^2 frame up to kernel B's inputs,
    through the JAX kernels, with a per-tile cap small enough that some
    tiles overflow into the full-tape fallback."""
    jt, jtd, meta, runs_b = _tape_arrays(name)
    mat = jnp.asarray(np.eye(3, dtype=np.float32))
    z = jnp.float32(0.0)
    boxes = np.asarray(jp2d._tile_boxes_2d(n_side, mat, z))
    st, codes = _jax_a(jtd, meta, runs_b, boxes)
    order = np.argsort(st != tk.ST_AMBIG, kind="stable").astype(np.int32)
    n_amb = int((st == tk.ST_AMBIG).sum())
    wrw, irw, rem, lens = _prepass(jt, jtd, codes, order)
    cmeta = np.array([n_amb, cap, cap, 0, 0, 0, 0, 0], np.int32)
    tw, ti_bits, runs, gmeta = (np.asarray(v) for v in
                                jk.compact_bitshift_batched(
        jnp.asarray(cmeta), jnp.asarray(lens.numpy()),
        jnp.asarray(wrw.numpy()), jnp.asarray(irw.numpy()),
        jnp.asarray(rem.numpy()), cap=cap, tpi=16))
    ti = ti_bits.view(np.float32)
    nmeta = meta.copy()
    nmeta[0] = n_amb
    coords = np.asarray(jp2d._pixel_coords_2d(n_side, mat, z))
    return (jt, dict(nmeta=nmeta, order=order, status=st,
                     words=np.asarray(jtd.packed), imms=np.asarray(jtd.imms),
                     runs_full=runs_b, tw=tw, ti=ti, runs=runs, gmeta=gmeta,
                     coords=coords))


@pytest.mark.parametrize("name,n_side", [("stress40", 8), ("all_ops", 4),
                                         ("random3", 4)])
def test_pixel_eval_matches_jax(name, n_side):
    cap = TCAP // 8
    jt, a = _fill_case(name, cap, n_side)
    n_amb = a["nmeta"][0]
    over = a["gmeta"][:n_amb, 2] == 1
    st = a["status"]
    want = np.asarray(jk.pixel_eval_runs(
        *(jnp.asarray(a[k]) for k in ("nmeta", "order", "status", "words",
                                      "imms", "runs_full")),
        ALL_BRANCHES,
        *(jnp.asarray(a[k]) for k in ("tw", "ti", "runs", "gmeta",
                                      "coords")), s_cap=S_CAP))
    got = tk.pixel_eval_runs(
        *(_t(a[k]) for k in ("nmeta", "order", "status", "words", "imms",
                             "runs_full")),
        ALL_BRANCHES,
        *(_t(a[k]) for k in ("tw", "ti", "runs", "gmeta", "coords")),
        s_cap=S_CAP).numpy()
    assert got.shape == want.shape == (n_side * n_side, 4096)
    if name == "stress40":
        # the case covers decided tiles, short tapes and the fallback
        assert (st != tk.ST_AMBIG).any() and over.any() and not over.all()
    diff = got != want
    if set(np.unique(jt.ops).tolist()) & _TRANSCENDENTAL:
        c = a["coords"]
        f = oracle.eval_f(jt, c[:, 0], c[:, 1], c[:, 2])
        band = np.abs(f) <= FILL_BAND
        assert not (diff & ~band).any(), int((diff & ~band).sum())
        assert diff.sum() <= band.sum()
    else:
        assert not diff.any(), int(diff.sum())


# ---------------------------------------------------------------------------
# Wrapper contract
# ---------------------------------------------------------------------------

def test_build_remap_matches_jax():
    for ops in [(16, 2, 14), (30, 21, 5, 18, 20, 15, 13, 22), ()]:
        b, r = tk.build_remap(ops)
        jb, jr = jk.build_remap(ops)
        assert b == jb and np.array_equal(r, jr)
        table = tk.bid_table(b)
        assert all(table[i + 1] == o for i, o in enumerate(b))


def test_cpu_inputs_take_the_plain_versions():
    """CPU tensors run the plain versions: no launch is counted and no
    kernel library is built."""
    from mpr_tpu_torch.utils.trace import COUNTS
    before = (tk.interval_shorten.launches,
              tk.compact_bitshift_batched.launches,
              tk.pixel_eval_runs.launches, COUNTS["builds.compile"],
              COUNTS["builds.load"])
    jt, a = _fill_case("stress40", TCAP // 4, 4)
    tk.pixel_eval_runs(*(_t(a[k]) for k in ("nmeta", "order", "status",
                                            "words", "imms", "runs_full")),
                       ALL_BRANCHES,
                       *(_t(a[k]) for k in ("tw", "ti", "runs", "gmeta",
                                            "coords")), s_cap=S_CAP)
    tape = mpr_tpu_torch.compile_tree(tshapes.stress_2d(40))
    tp2d.render_tile_block(TapeData.from_tape(tape, device="cpu"),
                           torch.eye(3), torch.tensor(0.0), 256)
    after = (tk.interval_shorten.launches,
             tk.compact_bitshift_batched.launches,
             tk.pixel_eval_runs.launches, COUNTS["builds.compile"],
             COUNTS["builds.load"])
    assert after == before



def test_compact_moves_past_8192():
    """Clauses that move left by 8192 or more (tapes in the 16384 bucket)
    land where a plain loop puts them.  (The JAX kernel's 13 binary move
    passes stop at 8191; see ROADMAP.md, faults found.)"""
    G, R, W, cap = 2, 8, 2048, 2048
    tcap = R * W
    rng = np.random.default_rng(35)
    wrw = np.zeros((G, tcap), np.int32)
    irw = np.zeros_like(wrw)
    rem = np.zeros_like(wrw)
    lens = np.zeros(G, np.int32)
    for g in range(G):
        kept = np.sort(rng.choice(tcap, 300, replace=False))
        kept[-1] = tcap - 1 - g
        bids = 1 + (np.arange(kept.size) // 7) % 3
        wrw[g, kept] = bids | (kept % 200) << 8
        irw[g, kept] = rng.integers(-2**31, 2**31 - 1, kept.size)
        rem[g, kept] = kept - np.arange(kept.size)
        lens[g] = kept.size
    got = tk.compact_bitshift_batched(
        _t(np.array([G, cap, cap, 0, 0, 0, 0, 0], np.int32)), _t(lens),
        *(_t(p.reshape(G, R, W)) for p in (wrw, irw, rem)), cap)
    for g in range(G):
        keep = wrw[g] != 0
        n = int(keep.sum())
        assert np.array_equal(got[0][g, :n].numpy(), wrw[g, keep])
        assert np.array_equal(got[1][g, :n].numpy(), irw[g, keep])
        bid = wrw[g, keep] & 0xFF
        heads = np.flatnonzero(np.r_[True, bid[1:] != bid[:-1]])
        counts = np.diff(np.r_[heads, n])
        want = bid[heads] | counts << 8
        assert int(got[3][g, 1]) == heads.size
        assert np.array_equal(got[2][g, :heads.size].numpy(), want)
        assert not got[2][g, heads.size:].any()
