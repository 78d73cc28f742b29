"""PyTorch port: kernels B1, C1 and C2 (``pixel_eval``, ``compact_runs``,
``compact_bitshift``) against the JAX kernels of the same names.

No render path of either package calls these three any more, so the tests
drive them the way their one-time caller did: kernel A's real codes for the
16 tiles of a 256^2 frame go through C1 (or the prepass and C2) and the
tapes through B1.  The JAX side runs as the rest of the suite runs it on the
CPU (Pallas in interpret mode); the port's wrappers take their plain
versions because the tensors lie on the CPU.  One tape capacity and one
branch set serve every case, so each JAX kernel compiles once per shape.

Tolerance.  Tape words, immediates (as bits), run headers and gmeta[:, :3]
are integers and must be equal over what the kernels specify: rows
``g < n_groups``, tape slots ``[0, len)``, headers ``[0, n_runs)``.  B1's
values must be equal bit for bit, NaNs in the same places, except on tapes
whose float pass runs sin, cos, exp or log: torch's CPU kernels and XLA's
round those an ulp apart, so there a value may differ by a few ulps of the
largest value of its tile (ULPS below; the tests print the count).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import jax.numpy as jnp

import mpr_tpu
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jtree
from mpr_tpu.ops import kernels as jk
from mpr_tpu.ops.tape_data import TapeData as JTapeData
from mpr_tpu.render import pipeline2d as jp2d
from mpr_tpu.tape.tape import Tape as JTape

from mpr_tpu_torch import oracle as toracle
from mpr_tpu_torch.ops import build
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.render import pipeline2d as tp2d
from mpr_tpu_torch.tape.opcodes import Op
from mpr_tpu_torch.tape.tape import Tape as TTape

from torch_port_cases import (FILL_BAND, TRANSCENDENTAL_OPS,  # noqa: F401
                              all_ops_clauses, one_torch_thread,
                              random_trees)

TCAP = 512
TW = TCAP // 8
S_CAP = 128
N_SIDE = 4
N_TILES = N_SIDE * N_SIDE
ULPS = 8
ALL_BRANCHES, ALL_REMAP = jk.build_remap(tuple(range(2, 32)))
_RANDOM = random_trees(jtree, mpr_tpu.compile_tree, 3)
NAMES = ["stress12", "stress40", "random0", "random2"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtape(name):
    if name == "all_ops":
        return JTape(**all_ops_clauses())
    if name.startswith("stress"):
        return mpr_tpu.compile_tree(jshapes.stress_2d(int(name[6:])))
    return mpr_tpu.compile_tree(_RANDOM[int(name[len("random"):])])


_FRAMES = {}


def _frame(name):
    """Kernel A (the JAX kernel) over the 16 tiles of a 256^2 frame at
    z = 0.1: the tape planes, A's status and codes, the ambiguous-first
    order and the pixel coordinates, as numpy."""
    if name in _FRAMES:
        return _FRAMES[name]
    jt = _jtape(name)
    jtd = JTapeData.from_tape(jt, pad_to=TCAP)
    assert jtd.num_slots <= S_CAP
    meta = np.array([jtd.length, jtd.num_slots, jtd.result_slot,
                     *jtd.axis_slots, jtd.num_runs, 0], np.int32)
    runs = np.asarray(jtd.runs)
    runs_b = (ALL_REMAP[runs & 0xFF] | (runs & ~0xFF)).astype(np.int32)
    mat = jnp.asarray(np.eye(3, dtype=np.float32))
    z = jnp.float32(0.1)
    boxes = np.asarray(jp2d._tile_boxes_2d(N_SIDE, mat, z))
    st, codes = jk.interval_shorten(
        jnp.asarray(meta), jtd.packed, jtd.imms, jnp.asarray(runs_b),
        jnp.asarray(boxes), branch_ops=ALL_BRANCHES, s_cap=S_CAP)
    st, codes = np.asarray(st), np.asarray(codes)
    f = dict(tape=jt, meta=meta, words=np.asarray(jtd.packed),
             imms=np.asarray(jtd.imms), boxes=boxes, status=st, codes=codes,
             order=np.argsort(st != tk.ST_AMBIG,
                              kind="stable").astype(np.int32),
             n_amb=int((st == tk.ST_AMBIG).sum()),
             coords=np.asarray(jp2d._pixel_coords_2d(N_SIDE, mat, z)))
    _FRAMES[name] = f
    return f


def _cmeta_c1(n_groups, cap):
    return np.array([n_groups, TW, cap, 0, 0, 0, 0, 0], np.int32)


def _c1_both(f, n_groups, order, codes, cap, capm=None):
    """C1 through the JAX kernel and through the port, as numpy tuples:
    outputs of ``cap`` entries a row, ``capm`` (default ``cap``) in
    cmeta[2]."""
    cmeta = _cmeta_c1(n_groups, cap if capm is None else capm)
    want = jk.compact_runs(jnp.asarray(cmeta), jnp.asarray(f["words"]),
                           jnp.asarray(f["imms"]), jnp.asarray(order),
                           jnp.asarray(ALL_REMAP), jnp.asarray(codes),
                           N_TILES, cap, cap)
    got = tk.compact_runs(_t(cmeta), _t(f["words"]), _t(f["imms"]),
                          _t(order), _t(ALL_REMAP), _t(codes), N_TILES, cap,
                          cap)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def _assert_c1_equal(want, got, n_groups, cap):
    tw, ti, runs, gmeta = want
    ptw, pti, pruns, pgmeta = got
    assert pti.dtype == np.float32 and ptw.shape == tw.shape
    assert np.array_equal(pgmeta[:n_groups, :3], gmeta[:n_groups, :3])
    for g in range(n_groups):
        n, nr = gmeta[g, 0], gmeta[g, 1]
        assert 0 <= n <= cap and nr <= n
        assert np.array_equal(ptw[g, :n], tw[g, :n]), g
        assert np.array_equal(pti[g, :n].view(np.int32),
                              ti[g, :n].view(np.int32)), g
        assert np.array_equal(pruns[g, :nr], runs[g, :nr]), g


# ---------------------------------------------------------------------------
# Kernel C1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cap", [(n, TCAP) for n in NAMES]
                         + [("stress12", TCAP // 4)])
def test_compact_runs_matches_jax(name, cap):
    f = _frame(name)
    assert f["n_amb"] > 0
    want, got = _c1_both(f, f["n_amb"], f["order"], f["codes"], cap)
    _assert_c1_equal(want, got, f["n_amb"], cap)
    over = want[3][:f["n_amb"], 2] == 1
    if cap == TCAP:
        assert not over.any()
    else:
        assert over.any() and not over.all()


@pytest.mark.parametrize("name,cap,capm", [("stress12", TCAP // 4, TCAP // 8),
                                           ("stress40", TCAP, TCAP // 4)])
def test_compact_runs_capacity_below_cap_matches_jax(name, cap, capm):
    """cmeta[2] below the outputs' capacity: each length is min(count,
    cmeta[2]) and the flag count >= cmeta[2], as in the JAX kernel."""
    f = _frame(name)
    n = f["n_amb"]
    want, got = _c1_both(f, n, f["order"], f["codes"], cap, capm)
    _assert_c1_equal(want, got, n, capm)
    over = want[3][:n, 2] == 1
    assert over.any()
    assert (want[3][:n, 0][over] == capm).all()


def test_compact_runs_random_codes_match_jax():
    """Seeded random code words over the tape with every opcode: every
    rewrite is hit, one tile keeps exactly ``cap`` clauses (flagged, unlike
    kernel C), one keeps none, the order is a permutation and only the
    first 12 of 16 groups are compacted."""
    cap = TCAP // 16
    f = _frame("all_ops")
    T = f["tape"].length
    rng = np.random.default_rng(41)
    nib = rng.choice(5, size=(N_TILES, TCAP),
                     p=[0.6, 0.1, 0.1, 0.1, 0.1]).astype(np.int64)
    nib[:, T:] = 0
    nib[3] = 0                                    # an all-dropped tile
    nib[5, :T] = np.maximum(nib[5, :T], 1)
    nz = np.flatnonzero(nib[5])
    assert nz.size > cap
    nib[5, nz[cap:]] = 0                          # exactly cap kept
    nib[6, :T] = np.maximum(nib[6, :T], 1)        # more than cap kept
    ops = f["words"][:T] & 0xFF
    imm = np.isin(ops, [int(Op.MIN_LHS_IMM), int(Op.MAX_LHS_IMM)])
    nib[7, :T] = np.where(imm, tk.CODE_COPY_LHS, 0)   # imm := +inf / -inf
    codes = (nib.reshape(N_TILES, TW, 8) << (4 * np.arange(8))).sum(
        axis=2).astype(np.uint32).view(np.int32)
    order = rng.permutation(N_TILES).astype(np.int32)
    order[:4] = [5, 3, 6, 7]
    order[4:] = [t for t in rng.permutation(N_TILES)
                 if t not in (5, 3, 6, 7)]
    n_groups = 12
    want, got = _c1_both(f, n_groups, order, codes, cap)
    _assert_c1_equal(want, got, n_groups, cap)
    gmeta = got[3]
    assert gmeta[0].tolist()[:3] == [cap, gmeta[0, 1], 1]
    assert gmeta[1].tolist()[:3] == [0, 0, 0]
    assert gmeta[2].tolist()[:3] == [cap, gmeta[2, 1], 1]
    # every rewrite occurs among the clauses compared
    kept = nib[order[:n_groups], :T]
    two = np.isin(ops, [int(Op.MIN_LHS_RHS), int(Op.MAX_LHS_RHS)])
    assert (kept[:, two] == tk.CODE_COPY_LHS).any()
    assert (kept[:, imm] == tk.CODE_COPY_LHS).any()
    assert (kept == tk.CODE_COPY_RHS).any()
    assert (kept == tk.CODE_COPY_IMM).any()
    ti = got[1][:n_groups]
    assert np.isposinf(ti).any() and np.isneginf(ti).any()


def test_compact_runs_walks_past_the_tape_length():
    """C1 has no mask by the tape's length: codes past it are kept like
    any other.  (The prepass of kernel C masks them.)"""
    f = _frame("stress12")
    T = f["tape"].length
    codes = f["codes"].copy()
    w = T // 8 + 1
    codes[:, w] |= 0x11
    cmeta = _cmeta_c1(N_TILES, TCAP)
    order = np.arange(N_TILES, dtype=np.int32)
    base = tk.compact_runs(_t(cmeta), _t(f["words"]), _t(f["imms"]),
                           _t(order), _t(ALL_REMAP), _t(f["codes"]), N_TILES,
                           TCAP, TCAP)
    more = tk.compact_runs(_t(cmeta), _t(f["words"]), _t(f["imms"]),
                           _t(order), _t(ALL_REMAP), _t(codes), N_TILES,
                           TCAP, TCAP)
    assert np.array_equal(more[3][:, 0].numpy(), base[3][:, 0].numpy() + 2)


# ---------------------------------------------------------------------------
# Kernel B1
# ---------------------------------------------------------------------------

def _tapes_in_tile_order(f):
    """The port's C1 over the frame's ambiguous tiles at cap = TCAP, with
    the tapes scattered back to TILE order as B1 reads them."""
    n = f["n_amb"]
    tw, ti, runs, gmeta = tk.compact_runs(
        _t(_cmeta_c1(n, TCAP)), _t(f["words"]), _t(f["imms"]),
        _t(f["order"]), _t(ALL_REMAP), _t(f["codes"]), N_TILES, TCAP, TCAP)
    tiles = f["order"][:n]
    words = np.zeros((N_TILES, TCAP), np.int32)
    imms = np.zeros((N_TILES, TCAP), np.float32)
    lens = np.zeros(N_TILES, np.int32)
    words[tiles] = tw.numpy()[:n]
    imms[tiles] = ti.numpy()[:n]
    lens[tiles] = gmeta.numpy()[:n, 0]
    nmeta = f["meta"].copy()
    nmeta[0] = n
    nmeta[6] = 0
    return nmeta, lens, words, imms, gmeta.numpy()[:n]


def _bits_equal(a, b):
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))


@pytest.mark.parametrize("name", NAMES + ["all_ops"])
def test_pixel_eval_matches_jax(name):
    f = _frame(name)
    n = f["n_amb"]
    nmeta, lens, words, imms, _ = _tapes_in_tile_order(f)
    args = (nmeta, f["order"], lens, words, imms, f["coords"])
    want = np.asarray(jk.pixel_eval(*(jnp.asarray(a) for a in args),
                                    s_cap=S_CAP))[:n]
    got = tk.pixel_eval(*(_t(a) for a in args), s_cap=S_CAP).numpy()[:n]
    assert got.shape == want.shape == (n, 4096) and got.dtype == np.float32
    _assert_values_match(name, f, got, want)


def _assert_values_match(name, f, got, want):
    """B1's values against the JAX kernel's: bit-equal, or on a tape that
    runs sin, cos, exp or log within ULPS of the tile's largest value."""
    same = _bits_equal(got, want)
    if set(np.unique(f["tape"].ops).tolist()) & TRANSCENDENTAL_OPS:
        # sin, cos, exp, log: an ulp apart between torch's CPU kernels and
        # XLA's, carried through the rest of the tape
        print(f"{name}: {int((~same).sum())} of {same.size} values differ "
              "in their bits")
        assert np.array_equal(np.isnan(got), np.isnan(want))
        scale = np.nanmax(np.abs(want), axis=1, keepdims=True)
        tol = ULPS * np.finfo(np.float32).eps * np.maximum(scale, 1.0)
        ok = same | (np.abs(got - want) <= tol)
        assert ok.all(), float(np.nanmax(np.abs(got - want)))
    else:
        assert same.all(), int((~same).sum())


@pytest.mark.parametrize("name", NAMES)
def test_chain_a_c1_b1_gives_the_oracle_sign(name):
    """The port alone: plain A -> plain C1 -> plain B1 gives the sign of
    the port's NumPy oracle on every ambiguous tile that C1 did not flag."""
    f = _frame(name)
    tt = TTape(**{k: getattr(f["tape"], k) for k in (
        "ops", "outs", "lhss", "rhss", "imms", "axis_slots", "result_slot",
        "num_slots", "num_choices")})
    st, codes = tk.interval_shorten(_t(f["meta"]), _t(f["words"]),
                                    _t(f["imms"]), _t(f["boxes"]),
                                    s_cap=S_CAP)
    assert np.array_equal(st.numpy(), f["status"])
    g = dict(f, codes=codes.numpy())
    nmeta, lens, words, imms, gmeta = _tapes_in_tile_order(g)
    n = f["n_amb"]
    assert not gmeta[:, 2].any()
    vals = tk.pixel_eval(_t(nmeta), _t(f["order"]), _t(lens), _t(words),
                         _t(imms), _t(f["coords"]), s_cap=S_CAP).numpy()[:n]
    c = f["coords"][f["order"][:n]]
    want = toracle.eval_f(tt, c[:, 0], c[:, 1], c[:, 2])
    diff = (vals < 0) != (want < 0)
    if set(np.unique(tt.ops).tolist()) & TRANSCENDENTAL_OPS:
        band = np.abs(want) <= FILL_BAND
        assert not (diff & ~band).any(), int((diff & ~band).sum())
    else:
        assert not diff.any(), int(diff.sum())
        assert np.allclose(vals, want, rtol=0, atol=1e-6)


def test_pixel_eval_runs_opcodes_0_and_1_as_zero():
    """The full branch list: INVALID and JUMP write ``a * 0`` to their
    output slot, as the JAX kernel's switch does."""
    words = np.zeros((1, 8), np.int32)
    imms = np.zeros((1, 8), np.float32)
    # s3 = x + y; s3 = JUMP(s3) -> 0; s4 = s3 + 2.5
    words[0, :3] = [14 | 3 << 8 | 1 << 16 | 2 << 24, 1 | 3 << 8 | 3 << 16,
                    13 | 4 << 8 | 3 << 16]
    imms[0, 2] = 2.5
    nmeta = np.array([1, 5, 4, 1, 2, 0, 0, 0], np.int32)
    coords = np.random.default_rng(42).uniform(
        -1, 1, (1, 3, 4096)).astype(np.float32)
    args = (nmeta, np.zeros(1, np.int32), np.array([3], np.int32), words,
            imms, coords)
    want = np.asarray(jk.pixel_eval(*(jnp.asarray(a) for a in args),
                                    s_cap=8))
    got = tk.pixel_eval(*(_t(a) for a in args), s_cap=8).numpy()
    assert np.array_equal(got, want) and (got == 2.5).all()


@pytest.mark.parametrize("pixels", [1000, 200])
@pytest.mark.parametrize("name", ["stress40", "random2"])
def test_pixel_eval_ragged_pixels_match_jax(name, pixels):
    """P that is no multiple of the kernel's chunks (32 K pixels): the
    first ``pixels`` of each tile (a multiple of 8, which the JAX kernel's
    (8, P/8) blocks need), equal to those pixels of the full tile.  The
    tolerance of :func:`_assert_values_match`."""
    f = _frame(name)
    n = f["n_amb"]
    nmeta, lens, words, imms, _ = _tapes_in_tile_order(f)
    coords = np.ascontiguousarray(f["coords"][:, :, :pixels])
    args = (nmeta, f["order"], lens, words, imms, coords)
    want = np.asarray(jk.pixel_eval(*(jnp.asarray(a) for a in args),
                                    s_cap=S_CAP))[:n]
    got = tk.pixel_eval(*(_t(a) for a in args), s_cap=S_CAP).numpy()[:n]
    assert got.shape == want.shape == (n, pixels)
    full = tk.pixel_eval(*(_t(a) for a in args[:5]), _t(f["coords"]),
                         s_cap=S_CAP).numpy()[:n]
    assert _bits_equal(got, full[:, :pixels]).all()
    _assert_values_match(name, f, got, want)


def test_pixel_eval_opcodes_0_1_and_past_31_inside_the_tape():
    """Opcodes 0 and 1 inside [0, len) give ``a * 0`` (runs of their own
    between runs of other opcodes), an opcode past 31 runs the last branch
    (ADDSQ: a * a + b), at a ragged P (264 pixels); a tile's length past
    cap is clamped to cap."""
    def w(op, out, lhs, rhs):
        return op | out << 8 | lhs << 16 | rhs << 24
    cap = 12
    words = np.zeros((2, cap), np.int32)
    imms = np.zeros((2, cap), np.float32)
    rows = [[w(14, 4, 1, 2), w(14, 5, 4, 2), w(0, 6, 4, 0), w(1, 6, 6, 0),
             w(13, 6, 6, 0), w(40, 7, 4, 5), w(255, 7, 7, 6),
             w(14, 4, 7, 6)],
            [w(16, 4, 1, 2), w(0, 5, 4, 0), w(0, 5, 5, 0), w(13, 5, 5, 0),
             w(31, 4, 4, 5), w(1, 6, 5, 0), w(15, 4, 4, 0), w(14, 4, 4, 3),
             w(33, 4, 4, 4), w(14, 4, 4, 2), w(13, 4, 4, 0), w(14, 4, 4, 1)]]
    for r, ws in enumerate(rows):
        words[r, :len(ws)] = np.array(ws, np.int64).astype(np.int32)
    imms[0, 4] = 1.5
    imms[1, [3, 6, 10]] = [0.25, -2.0, 0.125]
    nmeta = np.array([2, 8, 4, 1, 2, 3, 0, 0], np.int32)
    coords = np.random.default_rng(45).uniform(
        -1, 1, (2, 3, 264)).astype(np.float32)
    order = np.array([1, 0], np.int32)
    args = (nmeta, order, np.array([8, 12], np.int32), words, imms, coords)
    want = np.asarray(jk.pixel_eval(*(jnp.asarray(a) for a in args),
                                    s_cap=8))
    got = tk.pixel_eval(*(_t(a) for a in args), s_cap=8).numpy()
    assert _bits_equal(got, want).all()
    # tile 0's walk by hand, in float32
    x, y = coords[0, 0], coords[0, 1]
    s4 = x + y
    s5 = s4 + y
    s6 = (s4 * np.float32(0)) * np.float32(0) + np.float32(1.5)
    s7 = s4 * s4 + s5
    s7 = s7 * s7 + s6
    assert _bits_equal(got[1], s7 + s6).all()
    clamped = args[:2] + (np.array([8, 99], np.int32),) + args[3:]
    assert _bits_equal(
        tk.pixel_eval(*(_t(a) for a in clamped), s_cap=8).numpy(), got).all()


# ---------------------------------------------------------------------------
# Kernel C2
# ---------------------------------------------------------------------------

def _planes(f):
    return tp2d._shorten_prepass(_t(f["codes"]), _t(f["words"]),
                                 _t(f["imms"]), f["tape"].length,
                                 _t(ALL_REMAP))


@pytest.mark.parametrize("name,cap", [("stress12", TCAP // 8),
                                      ("stress40", TCAP // 2)])
def test_compact_bitshift_matches_jax(name, cap):
    f = _frame(name)
    n = f["n_amb"]
    wrw, irw, rem, lens = _planes(f)               # TILE order
    cmeta = np.array([n, cap, cap, 0, 0, 0, 0, 0], np.int32)
    want = jk.compact_bitshift(
        jnp.asarray(cmeta), jnp.asarray(f["order"]),
        *(jnp.asarray(p.numpy()) for p in (lens, wrw, irw, rem)),
        N_TILES, cap, cap)
    got = tk.compact_bitshift(_t(cmeta), _t(f["order"]), lens, wrw, irw, rem,
                              N_TILES, cap, cap)
    tw, ti, runs, gmeta = (np.asarray(w)[:n] for w in want)
    ptw, pti, pruns, pgmeta = (g.numpy()[:n] for g in got)
    assert np.array_equal(pgmeta[:, :3], gmeta[:, :3])
    assert np.array_equal(gmeta[:, 0], lens.numpy()[f["order"][:n]])
    if name == "stress12":
        assert gmeta[:, 2].any() and not gmeta[:, 2].all()
    # zero past the tape and the last run, as the JAX kernel writes
    assert np.array_equal(ptw, tw) and np.array_equal(pti, ti)
    assert np.array_equal(pruns, runs)


def test_compact_bitshift_identity_order_is_the_batched_kernel():
    f = _frame("stress12")
    cap = TCAP // 8
    wrw, irw, rem, lens = _planes(f)
    cmeta = _t(np.array([N_TILES, cap, cap, 0, 0, 0, 0, 0], np.int32))
    order = torch.arange(N_TILES, dtype=torch.int32)
    got = tk.compact_bitshift(cmeta, order, lens, wrw, irw, rem, N_TILES,
                              cap, cap)
    want = tk.compact_bitshift_batched(cmeta, lens, wrw, irw, rem, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Wrapper contract
# ---------------------------------------------------------------------------

def test_v1_cpu_inputs_take_the_plain_versions():
    """CPU tensors run the plain versions: no launch is counted and no
    kernel library is built."""
    def counts():
        return (tk.pixel_eval.launches, tk.compact_runs.launches,
                tk.compact_bitshift.launches, build.BuildStats.compiles,
                build.BuildStats.loads)
    before = counts()
    f = _frame("stress12")
    nmeta, lens, words, imms, _ = _tapes_in_tile_order(f)
    tk.pixel_eval(_t(nmeta), _t(f["order"]), _t(lens), _t(words), _t(imms),
                  _t(f["coords"]), s_cap=S_CAP)
    wrw, irw, rem, plens = _planes(f)
    tk.compact_bitshift(_t(np.array([1, 64, 64, 0, 0, 0, 0, 0], np.int32)),
                        _t(f["order"]), plens, wrw, irw, rem, N_TILES, 64, 64)
    assert counts() == before


def test_v1_wrappers_refuse_inputs_on_two_devices():
    f = _frame("stress12")
    meta_dev = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        tk.compact_runs(meta_dev, _t(f["words"]), _t(f["imms"]),
                        _t(f["order"]), _t(ALL_REMAP), _t(f["codes"]),
                        N_TILES, TCAP, TCAP)
