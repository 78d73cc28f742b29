"""PyTorch port: the launch shapes of kernels C and C2, and the plain
version of kernel C on hand-made edge cases.

Kernels C and C2 (``csrc/compact.cu``, ``compact_order.cu``) take a row
with a warp (short planes, several rows a block) or with a whole block
(long planes): ``launch.compact_launch`` picks the shape, and a forced
one is checked by ``check_compact_launch``.  The plain version, which the
card's tests and ``chip_smoke.py`` hold the kernels against, must equal
a loop over the clauses on the cases the card tests use
(``torch_port_cases.COMPACT_CASES``): rows over cap, empty rows, moves
past 8192, a cap that is not a multiple of 4.  The kernels themselves run
only on a card (``tests/test_torch_gpu.py``).

Tolerance: none; every output is an integer.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpr_tpu_torch.ops import kernels as tk
from mpr_tpu_torch.ops import launch as ln

from torch_port_cases import (COMPACT_CASES, compact_planes,  # noqa: F401
                              one_torch_thread)

# (plane length, cap, rows) of the four cells' launches of kernel C
CELLS = {"stress_2d(600) 1024^2": (8192, 1024, 256),
         "stress_2d(1500) 2048^2": (16384, 2048, 1024),
         "gyroid_sphere cells": (256, 128, 107_466),
         "extruded_stress cells": (4096, 2048, 10_307),
         "extruded_stress columns": (4096, 2048, 58)}


@pytest.mark.parametrize("tcap", [32, 96, 256, 512, 1024, 2048, 4096, 8192,
                                  16384])
@pytest.mark.parametrize("cap_div", [1, 2, 8, 16])
def test_compact_launch_fits(tcap, cap_div):
    cap = max(1, tcap // cap_div)
    for n_rows in (1, 100, 1000, 200_000):
        c = ln.compact_launch(tcap, cap, n_rows)
        assert c.smem <= ln.SMEM_LIMIT and c.threads in ln.C_THREADS
        assert c.smem == c.rows * ln.c_row_bytes(tcap, cap)
        assert ln.check_compact_launch(c, tcap, cap) is c
        # a warp a row for short planes, a block a row for long ones
        assert (c.group == 32) == (tcap <= ln.C_WARP_TCAP)
        if c.group == 32:
            assert 1 <= c.rows <= ln.C_WARP_ROWS
            # fewer rows a block only where the grid would leave SMs idle
            if c.rows < ln.C_WARP_ROWS:
                assert -(-n_rows // (2 * c.rows)) < ln.SM_COUNT
        else:
            assert 128 <= c.threads <= ln.C_BLOCK_THREADS
            assert c.threads * ln.C_WORDS >= min(
                tcap, ln.C_BLOCK_THREADS * ln.C_WORDS)


def test_c_row_bytes():
    for tcap, cap in ((256, 128), (1024, 13), (16384, 16384), (32, 1)):
        b = ln.c_row_bytes(tcap, cap)
        cap4 = -(-cap // 4) * 4
        # staged words and immediates, the run starts (cap + 1), the
        # branch ids; 16-byte rows
        assert b % 16 == 0 and b >= 4 * (2 * cap4 + cap + 1) + tcap
    # the largest row, a 16384-clause plane at cap = Tcap, fits a block
    assert ln.c_row_bytes(16384, 16384) <= ln.SMEM_LIMIT


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_cells_get_their_designed_c_shapes(cell):
    tcap, cap, rows = CELLS[cell]
    c = ln.compact_launch(tcap, cap, rows)
    want = {"stress_2d(600) 1024^2": (512, 512),
            "stress_2d(1500) 2048^2": (512, 512),
            "gyroid_sphere cells": (256, 32),
            "extruded_stress cells": (256, 256),
            "extruded_stress columns": (256, 256)}[cell]
    assert (c.threads, c.group) == want


def test_forced_c_shapes_are_checked():
    for tcap, cap in ((256, 128), (4096, 2048), (16384, 2048)):
        for kw in (dict(warp=True), dict(warp=True, threads=32),
                   dict(warp=True, threads=1024), dict(warp=False),
                   dict(warp=False, threads=128),
                   dict(warp=False, threads=1024)):
            try:
                c = ln.compact_launch(tcap, cap, 1000, **kw)
            except ValueError:
                # 32 rows of a long plane a block do not fit
                assert kw.get("threads") == 1024 and kw["warp"] \
                    and tcap > 1024
                continue
            assert (c.group == 32) == kw["warp"]
            assert ln.check_compact_launch(c, tcap, cap) is c
            for bad in (replace(c, smem=c.smem + 16),
                        replace(c, threads=96),
                        replace(c, group=64 if c.threads > 64 else 16),
                        replace(c, smem=ln.c_row_bytes(tcap, cap // 2)
                                * c.rows)):
                with pytest.raises(ValueError):
                    ln.check_compact_launch(bad, tcap, cap)
    with pytest.raises(ValueError):
        ln.compact_launch(16384, 16384, 10, warp=True, threads=64)


def _loop(lens, wrw, irw, rem, cap):
    """Kernel C's function as a loop over each row's clauses."""
    G = wrw.shape[0]
    wrw, irw, rem = (p.reshape(G, -1) for p in (wrw, irw, rem))
    tw = np.zeros((G, cap), np.int32)
    ti = np.zeros_like(tw)
    runs = np.zeros_like(tw)
    gmeta = np.zeros((G, 8), np.int32)
    for g in range(G):
        keep = np.flatnonzero(wrw[g] & 0xFF)
        k = keep - rem[g, keep]
        n = int(lens[g])
        assert np.array_equal(k, np.arange(n))
        w, i = wrw[g, keep], irw[g, keep]
        tw[g, :min(n, cap)] = w[:cap]
        ti[g, :min(n, cap)] = i[:cap]
        bid = w & 0xFF
        heads = np.flatnonzero(np.r_[True, bid[1:] != bid[:-1]]) if n \
            else np.zeros(0, np.int64)
        hdr = bid[heads] | np.diff(np.r_[heads, n]) << 8
        runs[g, :min(heads.size, cap)] = hdr[:cap]
        gmeta[g, :3] = n, heads.size, n > cap
    return tw, ti, runs, gmeta


@pytest.mark.parametrize("name", sorted(COMPACT_CASES))
def test_plain_compact_equals_a_loop_on_the_edge_cases(name):
    kept, tcap, cap, n_rows = COMPACT_CASES[name]
    lens, wrw, irw, rem = compact_planes(np.random.default_rng(61), kept,
                                         tcap)
    cmeta = torch.tensor([n_rows, cap, cap, 0, 0, 0, 0, 0],
                         dtype=torch.int32)
    got = tk.compact_bitshift_batched(
        cmeta, *(torch.from_numpy(p) for p in (lens, wrw, irw, rem)), cap,
        launch=ln.compact_launch(tcap, cap, len(kept)))
    want = _loop(lens, wrw, irw, rem, cap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy()[:n_rows], w[:n_rows])
    over = want[3][:n_rows, 2] == 1
    assert over.any() and (name == "one_row" or not over.all())
    # C2 over the same planes in another tile order: row g is tile order[g]
    order = np.random.default_rng(62).permutation(len(kept)).astype(np.int32)
    got2 = tk.compact_bitshift(
        cmeta, torch.from_numpy(order),
        *(torch.from_numpy(p[order.argsort()])
          for p in (lens, wrw, irw, rem)), len(kept), cap, cap)
    for g, w in zip(got2, want):
        assert np.array_equal(g.numpy()[:n_rows], w[:n_rows])
