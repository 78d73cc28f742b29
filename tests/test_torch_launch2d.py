"""PyTorch port: kernel A's dependency schedule and the launch shapes of
kernels A and B (host code, and kernel A's algorithm in plain PyTorch).

Kernel A walks a tape's dependency levels (``ops/schedule.py::
tape_levels``): a clause's level lies above those of its forward producers
and of the clauses its backward marks go to.  ``_interval_shorten_levels``
runs the kernel's algorithm (the clauses in level order, one interval a
clause, marks by level-order position) in plain PyTorch; its status and
codes must equal the slot walk of ``interval_shorten_plain`` and the JAX
kernel in interpret mode bit for bit, on the parity cases of
``tests/test_torch_kernels.py``, with ``n_active``, on random trees and on
tapes made by hand for each quirk of the slot walk.  ``interval_launch``
and ``pixel_launch`` must give shapes that fit the card's shared memory,
and a forced shape is checked as ``kernels3d.check_launch`` checks V's and
D's.

Tolerance: none; status and codes are integers.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import mpr_tpu
from mpr_tpu.frontend import shapes as jshapes
from mpr_tpu.frontend import tree as jtree
from mpr_tpu.ops import kernels as jk
from mpr_tpu.ops.tape_data import TapeData as JTapeData
from mpr_tpu.tape.tape import Tape as JTape

import mpr_tpu_torch
from mpr_tpu_torch.frontend import shapes as tshapes
from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops import launch as ln
from mpr_tpu_torch.ops import schedule as sch
from mpr_tpu_torch.ops.tape_data import TapeData
from mpr_tpu_torch.render import pipeline2d as tp2d

from torch_port_cases import (all_ops_clauses, one_torch_thread,  # noqa: F401
                              random_boxes, random_trees, unpack_codes)

TCAP = 512
S_CAP = 128
ALL_BRANCHES, ALL_REMAP = jk.build_remap(tuple(range(2, 32)))

# ---------------------------------------------------------------------------
# Tapes
# ---------------------------------------------------------------------------

_RANDOM = random_trees(jtree, mpr_tpu.compile_tree, 10, seed=20261017)


def _clauses(rows, result_slot, num_slots=8):
    """Tape fields from (op, out, lhs, rhs, imm) rows; axis slots 1, 2, 3."""
    ops, outs, lhss, rhss, imms = (np.asarray(c) for c in zip(*rows))
    return dict(ops=ops.astype(np.int32), outs=outs.astype(np.int32),
                lhss=lhss.astype(np.int32), rhss=rhss.astype(np.int32),
                imms=imms.astype(np.float32), axis_slots=(1, 2, 3),
                result_slot=result_slot, num_slots=num_slots,
                num_choices=int(((ops >= 17) & (ops <= 20)).sum()))


# One hand-made tape for each quirk of the slot walk that the schedule has
# to reproduce.
QUIRKS = {
    # a clause writes slot 0; a later unary clause's unused rhs operand is
    # slot 0, so under KEEP it marks that writer (act[rhs] with rhs == 0),
    # and the writer is kept
    "rhs_slot0_marked": _clauses([
        (14, 0, 1, 2, 0.0),      # s0 = x + y
        (4, 4, 1, 0, 0.0),       # s4 = -x        (rhs 0 read, unused)
        (20, 5, 4, 2, 0.0),      # s5 = max(s4, y)
        (21, 5, 5, 0, 0.3),      # s5 = s5 - 0.3  (rhs 0 read, unused)
    ], 5),
    # a choice of lhs onto its own slot (acc = min(acc, .)) is elided, one
    # of rhs onto its own slot too
    "copy_onto_itself": _clauses([
        (11, 4, 1, 0, 0.0),      # s4 = |x|
        (17, 4, 4, 0, 0.25),     # s4 = min(s4, 0.25)   (lhs == out)
        (21, 5, 2, 0, 0.5),      # s5 = y - 0.5
        (18, 5, 4, 5, 0.0),      # s5 = min(s4, s5)     (rhs == out)
        (20, 6, 5, 3, 0.0),      # s6 = max(s5, z)
        (19, 6, 6, 0, -0.4),     # s6 = max(s6, -0.4)   (lhs == out)
    ], 6),
    # operands that were never written read [0, 0]
    "never_written": _clauses([
        (14, 4, 1, 7, 0.0),      # s4 = x + s7          (s7 never written)
        (18, 5, 4, 6, 0.0),      # s5 = min(s4, s6)     (s6 never written)
        (16, 5, 5, 2, 0.0),      # s5 = s5 * y
        (21, 5, 5, 0, 0.1),      # s5 = s5 - 0.1
    ], 5),
    # words with opcode INVALID (0) or JUMP (1) inside the tape: no forward
    # step, but backward they kill their out slot and, when active, mark
    # their operands
    "jump_words": _clauses([
        (14, 4, 1, 2, 0.0),      # t0: s4 = x + y
        (4, 5, 1, 0, 0.0),       # t1: s5 = -x
        (1, 4, 3, 5, 0.0),       # t2: JUMP onto s4  (marks z, s5 = t1)
        (18, 6, 4, 2, 0.0),      # t3: s6 = min(s4 = t0, y)
        (0, 6, 2, 1, 0.0),       # t4: INVALID onto s6, the result slot
        (20, 7, 6, 4, 0.0),      # t5: s7 = max(s6 = t3, s4 = t0)
        (1, 7, 7, 0, 0.0),       # t6: JUMP onto s7 (lhs == out)
        (21, 6, 7, 0, 0.2),      # t7: s6 = s7 - 0.2, the result
    ], 6),
}

NAMES = ["random0", "random1", "random2", "random3", "random4", "random5",
         "all_ops", "stress40"]


def _jtape(name):
    if name == "all_ops":
        return JTape(**all_ops_clauses())
    if name == "stress40":
        return mpr_tpu.compile_tree(jshapes.stress_2d(40))
    if name in QUIRKS:
        return JTape(**QUIRKS[name])
    return mpr_tpu.compile_tree(_RANDOM[int(name[len("random"):])])


def _case(name):
    jt = _jtape(name)
    jtd = JTapeData.from_tape(jt, pad_to=TCAP)
    meta = np.array([jtd.length, jtd.num_slots, jtd.result_slot,
                     *jtd.axis_slots, jtd.num_runs, 0], np.int32)
    runs = np.asarray(jtd.runs)
    runs_b = (ALL_REMAP[runs & 0xFF] | (runs & ~0xFF)).astype(np.int32)
    levels = sch.tape_levels(np.asarray(jtd.packed), jtd.length,
                             jtd.result_slot, jtd.axis_slots)
    return jt, jtd, meta, runs_b, levels


def _t(a):
    return torch.from_numpy(np.array(a))


def _three(name, boxes, widen=False, meta=None):
    """(JAX, slot walk, level walk) outputs as numpy (status, codes), and
    the tape's length."""
    jt, jtd, meta0, runs_b, levels = _case(name)
    meta = meta0 if meta is None else meta
    st, codes = jk.interval_shorten(
        jnp.asarray(meta), jtd.packed, jtd.imms, jnp.asarray(runs_b),
        jnp.asarray(boxes), branch_ops=ALL_BRANCHES, s_cap=S_CAP, widen=widen)
    args = (_t(meta), _t(jtd.packed), _t(jtd.imms), _t(boxes))
    plain = tk.interval_shorten_plain(*args, s_cap=S_CAP, widen=widen)
    lv = tk._interval_shorten_levels(*args, levels, widen=widen)
    return ((np.asarray(st), np.asarray(codes)),
            tuple(x.numpy() for x in plain),
            tuple(x.numpy() for x in lv)), jt.length


def _assert_same(outs, length, lanes=None, jax=True):
    """The level walk equals the slot walk in every code word and, with
    ``jax``, the JAX kernel in status and in the codes of the tape's
    clauses (it may write garbage past the tape)."""
    (st, codes), (pst, pcodes), (lst, lcodes) = outs
    s = slice(None) if lanes is None else slice(0, lanes)
    assert np.array_equal(lst[s], pst[s])
    assert np.array_equal(lcodes[s], pcodes[s])
    if jax:
        assert np.array_equal(lst[s], st[s])
        assert np.array_equal(unpack_codes(lcodes[s], length),
                              unpack_codes(codes[s], length))


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def _assert_topological(lv):
    h = lv.host
    level = h["level"]
    assert np.all(np.diff(level) >= 0)                     # level order
    offs = lv.offsets.numpy()
    assert offs[0] == 0 and offs[-1] == lv.length
    assert np.array_equal(np.repeat(np.arange(lv.n_levels), np.diff(offs)),
                          level)
    ops = lv.planes.numpy()[0] & 0xFF
    runs = (ops[:lv.length] > 1) & (ops[:lv.length] < 32)
    for name in ("lhs_src", "rhs_src", "mark_l", "mark_r"):
        src = h[name]
        has = src >= 0
        if name.endswith("src"):
            has &= runs                   # a JUMP word reads nothing forward
            assert np.all(src >= sch.SEED_Z)
        else:
            assert np.all(src >= sch.NO_MARK)
        assert np.all(level[src[has]] < level[has]), name
    # the clause order is a permutation of the tape
    assert np.array_equal(np.sort(h["order"]), np.arange(lv.length))
    assert lv.widest == np.diff(offs).max()


@pytest.mark.parametrize("case,want", [
    ("stress_2d(600)", 17), ("stress_2d(1500)", 18), ("gyroid_sphere", 8),
    ("extruded_stress", 18)])
def test_tape_levels_are_topological_with_the_cells_depths(case, want):
    tree = {"stress_2d(600)": lambda: tshapes.stress_2d(600),
            "stress_2d(1500)": lambda: tshapes.stress_2d(1500),
            "gyroid_sphere": lambda: tshapes.intersection(
                tshapes.gyroid(0.4, 0.08), tshapes.sphere(0.85)),
            "extruded_stress": lambda: tshapes.extrude_z(
                tshapes.stress_2d(300), -0.4, 0.4)}[case]()
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(tree), device="cpu")
    lv = td.levels()
    assert lv.n_levels == want
    assert lv.key == (td.length, td.result_slot, *td.axis_slots)
    _assert_topological(lv)


@pytest.mark.parametrize("name", NAMES + sorted(QUIRKS))
def test_tape_levels_of_the_parity_tapes_are_topological(name):
    _assert_topological(_case(name)[4])


def test_jump_words_are_modelled_in_the_schedule():
    """The schedule models a word with opcode <= JUMP (no sequential
    fallback): it gets a level, the clause after it that reads its out
    slot reads the earlier writer forward but marks the JUMP word
    backward, and the JUMP word marks its own operands."""
    lv = _case("jump_words")[4]
    h = lv.host
    pos = {int(t): i for i, t in enumerate(h["order"])}
    # t3 reads s4: forward from t0, its mark goes to the JUMP word t2
    assert h["lhs_src"][pos[3]] == pos[0]
    assert h["mark_l"][pos[3]] == pos[2]
    # t2 marks its rhs s5 (t1) and nothing for its lhs (the z seed)
    assert h["mark_r"][pos[2]] == pos[1] and h["mark_l"][pos[2]] == -1
    # the result: forward t7's value, marked at t7; t4 (INVALID onto the
    # result slot before it) is a writer nobody reads
    assert lv.res_src == pos[7] and lv.res_mark == pos[7]
    assert h["level"][pos[2]] > h["level"][pos[1]]
    assert h["level"][pos[3]] > h["level"][pos[2]]


def test_levels_are_built_once_a_tape_and_never_on_the_cpu_path():
    """``TapeData.levels`` builds the schedule at its first call and keeps
    it; a frame on the CPU (plain versions) never asks for it."""
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(
        tshapes.stress_2d(12)), device="cpu")
    before = sch.tape_levels.builds
    tp2d.render_tile_block(td, torch.eye(3), torch.tensor(0.0), 256)
    assert sch.tape_levels.builds == before and td._levels is None
    lv = td.levels()
    assert td.levels() is lv and sch.tape_levels.builds == before + 1


def test_a_chain_tape_takes_one_level_a_clause():
    """A chain (each clause reads the one before) is as deep as it is
    long: past the vectorised rounds the levels come from one pass."""
    n = 150
    rows = [(13, 4, 1, 0, 0.5)] + [(15 + 2 * (i % 2), 4, 4, 0, 0.9)
                                   for i in range(n - 1)]
    f = _clauses(rows, 4)
    words = (f["ops"] | f["outs"] << 8 | f["lhss"] << 16 | f["rhss"] << 24)
    lv = sch.tape_levels(words.astype(np.int32), n, 4, (1, 2, 3))
    assert lv.n_levels == n and lv.widest == 1
    _assert_topological(lv)


# ---------------------------------------------------------------------------
# Kernel A's algorithm against the slot walk and the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_level_walk_matches_slot_walk_and_jax(name, widen):
    boxes = random_boxes(np.random.default_rng(51), 48)
    _assert_same(*_three(name, boxes, widen))


@pytest.mark.parametrize("name", ["stress40", "random2"])
def test_level_walk_with_n_active(name):
    boxes = random_boxes(np.random.default_rng(52), 48)
    meta = _case(name)[2].copy()
    meta[7] = 29
    outs, length = _three(name, boxes, meta=meta)
    _assert_same(outs, length, lanes=29)
    # lanes past n_active come back zero from both plain PyTorch walks
    for st, codes in outs[1:]:
        assert not st[29:].any() and not codes[29:].any()


@pytest.mark.parametrize("name", ["random6", "random7", "random8",
                                  "random9"])
def test_level_walk_matches_on_random_trees(name):
    boxes = random_boxes(np.random.default_rng(53), 48, width=1.0)
    _assert_same(*_three(name, boxes))


@pytest.mark.parametrize("name", sorted(QUIRKS))
def test_level_walk_reproduces_each_quirk(name):
    """Boxes spread over the view so that choices go every way."""
    rng = np.random.default_rng(54)
    boxes = random_boxes(rng, 64, width=0.8)
    outs, length = _three(name, boxes)
    # the JAX kernel does not clear its register file, so a slot that was
    # never written reads whatever its scratch holds there: that case is
    # held against the slot walk alone, which reads [0, 0]
    _assert_same(outs, length, jax=name != "never_written")
    _, (st, codes), _ = outs
    assert (st == tk.ST_AMBIG).any()
    nib = (codes[:, :1] >> (4 * np.arange(8))) & 0xF
    assert nib.any()


def test_level_walk_follows_new_imms_under_an_old_schedule():
    """A schedule outlives a change of the tape's immediates (a fit step or
    a slider keeps the TapeData and its schedule): the level walk must take
    each clause's immediate from the call's imms, not from the schedule,
    and so equal the slot walk and the JAX kernel on the new imms."""
    jt, jtd, meta, runs_b, _ = _case("stress40")
    td = TapeData.from_arrays(np.asarray(jtd.packed), np.asarray(jtd.imms),
                              np.asarray(jtd.runs), length=jtd.length,
                              num_slots=jtd.num_slots,
                              axis_slots=jtd.axis_slots,
                              result_slot=jtd.result_slot,
                              num_choices=jtd.num_choices,
                              ops_present=(), num_runs=jtd.num_runs,
                              device="cpu")
    old = td.levels()                        # built with the old imms
    rng = np.random.default_rng(56)
    imms = np.array(jtd.imms)
    imms[:jt.length] += rng.normal(0.0, 0.25, jt.length).astype(np.float32)
    boxes = random_boxes(np.random.default_rng(57), 48, width=0.5)
    st, codes = jk.interval_shorten(
        jnp.asarray(meta), jtd.packed, jnp.asarray(imms), jnp.asarray(runs_b),
        jnp.asarray(boxes), branch_ops=ALL_BRANCHES, s_cap=S_CAP)
    args = (_t(meta), _t(jtd.packed), _t(imms), _t(boxes))
    plain = tk.interval_shorten_plain(*args, s_cap=S_CAP)
    lv = tk._interval_shorten_levels(*args, old)
    outs = ((np.asarray(st), np.asarray(codes)),
            tuple(x.numpy() for x in plain), tuple(x.numpy() for x in lv))
    _assert_same(outs, jt.length)
    # the new imms change the outcome, so the case can tell them apart
    before = tk.interval_shorten_plain(_t(meta), _t(jtd.packed),
                                       _t(jtd.imms), _t(boxes), s_cap=S_CAP)
    assert not (torch.equal(before[0], plain[0])
                and torch.equal(before[1], plain[1]))


def test_the_quirks_show_in_the_codes():
    """Each quirk changes a code somewhere, so that the cases above hold
    the schedule to it: the slot-0 writer is kept, an in-place copy is
    dropped, and the forward producer under an INVALID word is dropped."""
    def nibbles(name, seed=55):
        boxes = random_boxes(np.random.default_rng(seed), 64, width=0.8)
        _, (st, codes), _ = _three(name, boxes)[0]
        amb = st == tk.ST_AMBIG
        return ((codes[amb, :1] >> (4 * np.arange(8))) & 0xF)
    nib = nibbles("rhs_slot0_marked")
    # nothing uses s0 = x + y, but the result clause (s5 - 0.3, rhs slot
    # 0) marks it in every ambiguous tile, also where s4 = -x is dropped
    assert (nib[:, 0] == tk.CODE_KEEP).all() and (nib[:, 1] == 0).any()
    nib = nibbles("copy_onto_itself")
    assert (nib[:, 1] == tk.CODE_DROP).any()             # min(s4, .) elided
    nib = nibbles("jump_words")
    # t5 reads s6 forward from t3, but its mark goes to the INVALID word
    # t4 over it: t3 is dropped in every tile, t4 kept where t5 keeps its
    # lhs
    assert (nib[:, 3] == tk.CODE_DROP).all()
    assert np.array_equal(nib[:, 4] != 0, np.isin(
        nib[:, 5], (tk.CODE_KEEP, tk.CODE_COPY_LHS)))
    assert (nib[:, 4] == tk.CODE_KEEP).any()


# ---------------------------------------------------------------------------
# Launch shapes of kernel A
# ---------------------------------------------------------------------------

LENGTHS = [1, 22, 369, 2727, 5373, 13365, 16383]


def _widths(length, widest):
    widest = max(1, min(widest, length))
    return [widest] * (length // widest) + ([length % widest]
                                            if length % widest else [])


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("widest", [1, 7, 40, 300, 1249, 3152])
def test_interval_launch_fits(length, widest):
    widths = _widths(length, widest)
    for lanes in (1, 256, 148_000):
        a = ln.interval_launch(widths, lanes)
        assert a.smem <= ln.SMEM_LIMIT
        assert a.threads in ln.A_THREADS
        # a block or a thread a tile
        assert a.tiles in (1, a.threads)
        assert a.smem == (ln.a_plane_bytes(length) if a.stage else 0) \
            + a.tiles * 11 * ln.padded_length(length)
        assert ln.check_interval_launch(a, length) is a

        # no block-a-tile or thread-a-tile shape costs less in the model
        others = [ln.interval_launch(widths, lanes, threads=g)
                  for g in ln.A_THREADS[1:]]
        for g in ln.A_OWN_THREADS:
            try:
                others.append(ln.interval_launch(widths, lanes, threads=g,
                                                 tiles=g))
            except ValueError:
                pass
        for other in others:
            assert ln._a_cost(a, widths, lanes) <= \
                ln._a_cost(other, widths, lanes)


@pytest.mark.parametrize("cell,lanes,want", [
    # a block a tile
    ("stress_2d(600)", 256, (256, 1, False)),
    ("stress_2d(1500)", 1024, (1024, 1, False)),
    # the 64^3 tiles and the 16^3 children of the 512^3 frame
    ("extruded_stress", 512, (128, 1, False)),
    ("extruded_stress", 20_928, (128, 1, False)),
    # a 22-clause tape: a thread a tile, at the 4,096 64^3 tiles and the
    # about 148k 16^3 children of the 1024^3 frame
    ("gyroid_sphere", 4096, (64, 64, True)),
    ("gyroid_sphere", 148_000, (64, 64, True)),
])
def test_the_cells_get_their_designed_a_shapes(cell, lanes, want):
    tree = {"stress_2d(600)": lambda: tshapes.stress_2d(600),
            "stress_2d(1500)": lambda: tshapes.stress_2d(1500),
            "gyroid_sphere": lambda: tshapes.intersection(
                tshapes.gyroid(0.4, 0.08), tshapes.sphere(0.85)),
            "extruded_stress": lambda: tshapes.extrude_z(
                tshapes.stress_2d(300), -0.4, 0.4)}[cell]()
    lv = TapeData.from_tape(mpr_tpu_torch.compile_tree(tree),
                            device="cpu").levels()
    a = ln.interval_launch(lv.widths, lanes)
    assert (a.threads, a.tiles, a.stage) == want
    if cell == "stress_2d(1500)":
        # 11 B a clause: one tile of the 16,384 bucket fits a block
        assert 140_000 < a.smem < 150_000


def test_forced_a_shapes_are_checked():
    for length in (22, 2727, 5373):
        for kw in (dict(threads=64), dict(threads=512, stage=True),
                   dict(threads=32), dict(threads=128, tiles=128),
                   dict(threads=64, tiles=64, stage=False)):
            try:
                a = ln.interval_launch(_widths(length, 100), 256, **kw)
            except ValueError:
                # many tiles a block of a long tape, or its planes beside
                # a tile, do not fit
                assert length > 22 and kw.get("tiles", 1) > 1 or \
                    kw.get("stage") and length > 2727
                continue
            assert ln.check_interval_launch(a, length) is a
            for bad in (replace(a, smem=a.smem + 16),
                        replace(a, stage=not a.stage),
                        replace(a, threads=96),
                        replace(a, tiles=2)):
                with pytest.raises(ValueError):
                    ln.check_interval_launch(bad, length)
    # a block or a thread a tile: nothing in between (a warp a tile, tried
    # first, ran slower than a thread a tile where short tapes are)
    with pytest.raises(ValueError):
        ln.check_interval_launch(ln.IntervalLaunch(64, 2, False, 2 * 11 * 32),
                                 22)
    own = ln.interval_launch(_widths(22, 7), 256, threads=128, tiles=128)
    assert own.group == 1 and own.stage
    assert ln.check_interval_launch(own, 22) is own


def test_a_tape_past_shared_memory_is_refused():
    longest = ln.SMEM_LIMIT // 11
    ln.interval_launch(_widths(16384, 3000), 1024)
    with pytest.raises(ValueError, match="shared bytes a tile"):
        ln.interval_launch(_widths(longest + 64, 3000), 1024)


# ---------------------------------------------------------------------------
# Launch shapes of kernel B
# ---------------------------------------------------------------------------

def _items(launch):
    """Pixel index of every (block of the row, chunk of the block's work
    queue, lane, k), as kernel B computes it: l = j * 4096/P + chunk * 32K
    + lane * K + k (a thread's K pixels side by side)."""
    per = 4096 // launch.blocks_per_row
    step = 32 * launch.k
    j, c, t, k = np.meshgrid(np.arange(launch.blocks_per_row),
                             np.arange(per // step), np.arange(32),
                             np.arange(launch.k), indexing="ij")
    return (j * per + c * step + t * launch.k + k).ravel()


@pytest.mark.parametrize("cap,tcap", [(64, 256), (128, 512), (1024, 8192),
                                      (2048, 16384)])
@pytest.mark.parametrize("s_cap", [8, 16, 56, 120, 176, 256])
def test_pixel_launch_fits_and_covers_every_pixel(s_cap, cap, tcap):
    for n_rows in (1, 16, 256, 1024):
        b = ln.pixel_launch(s_cap, cap, n_rows, tcap)
        assert b.smem <= ln.SMEM_LIMIT and b.home in ("shared", "local")
        assert np.array_equal(np.sort(_items(b)), np.arange(4096))
        assert ln.library("pixel_eval_runs", b) == "main"
        most = 4096 // (b.threads * b.k)
        full = ln.SM_COUNT * ln._resident(b.smem, b.threads)
        assert n_rows * b.blocks_per_row >= ln.B_WAVES * full \
            or b.blocks_per_row == most
        if b.stage_full:
            assert 12 * tcap <= ln.STAGE_MAX
        if b.home == "local":
            assert b.bucket >= s_cap and b.shared_warps == 0
        assert ln.check_pixel_launch(b, s_cap, cap, tcap) is b
    for home in ("shared", "local"):
        for k in (1, 2, 4):
            try:
                f = ln.pixel_launch(s_cap, cap, 256, tcap, home=home, k=k)
            except ValueError:
                assert home == "shared"
                continue
            assert (f.home, f.k) == (home, k)
            assert np.array_equal(np.sort(_items(f)), np.arange(4096))
            assert ln.check_pixel_launch(f, s_cap, cap, tcap) is f


@pytest.mark.parametrize("cell,s_cap,cap,rows,tcap,want", [
    # stress_2d(600) at 1024^2: 173 slots, 8192 bucket, cap 1024, 256 tiles
    ("stress_2d(600)", 176, 1024, 256, 8192, ("local", 256, 2, 8)),
    # stress_2d(1500) at 2048^2: 176 slots, 16384 bucket, 1024 tiles
    ("stress_2d(1500)", 176, 2048, 1024, 16384, ("local", 256, 2, 8)),
    # a short tape (16 slots) takes the shared home
    ("stress40 at 256^2", 120, 128, 16, 512, ("local", 256, 2, 8)),
    ("two circles", 8, 64, 16, 256, ("shared", 256, 4, 4)),
])
def test_the_cells_get_their_designed_b_shapes(cell, s_cap, cap, rows, tcap,
                                                want):
    b = ln.pixel_launch(s_cap, cap, rows, tcap)
    assert (b.home, b.threads, b.k, b.blocks_per_row) == want
    if b.home == "local":
        assert b.bucket == ln.local_bucket(s_cap)


def test_forced_b_shapes_are_checked():
    for s_cap, cap, tcap in ((16, 128, 512), (176, 1024, 8192)):
        for kw in (dict(home="local", k=1), dict(home="local", k=4),
                   dict(home="shared", k=1), dict(home="local", parts=1),
                   dict(home="local", stage_full=True),
                   dict(home="shared", k=4, threads=128)):
            try:
                b = ln.pixel_launch(s_cap, cap, 256, tcap, **kw)
            except ValueError:
                assert s_cap == 176 and kw["home"] == "shared" or \
                    kw.get("stage_full")
                continue
            assert ln.check_pixel_launch(b, s_cap, cap, tcap) is b
            for bad in (replace(b, smem=b.smem + 16),
                        replace(b, bucket=0 if b.bucket else 16),
                        replace(b, stage_full=not b.stage_full),
                        replace(b, k=3), replace(b, blocks_per_row=3),
                        replace(b, home="split", shared_warps=1)):
                with pytest.raises(ValueError):
                    ln.check_pixel_launch(bad, s_cap, cap, tcap)
    with pytest.raises(ValueError):
        ln.pixel_launch(264, 128, 16, 512, home="local")
