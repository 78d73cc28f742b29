"""PyTorch port: the launch shapes of kernels V and D (pure host code).

``voxel_launch`` and ``deriv_launch`` pick where the interpreter's
register file lives (shared or local memory), the threads of a block, the
items a thread runs a pass (K) and the blocks a row (P), and the dynamic
shared memory that takes.  For every slot bucket and row capacity the
render path can give, each shape must fit the card's shared memory, its
items must cover a row's 4096 voxels or pixels exactly once in the
kernels' own indexing, and K and P must be ones the kernels are built for.
The two 3D cells of ``chip_smoke.py`` must get the shapes their kernels
were designed for.  No JAX is imported.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpr_tpu_torch.ops import kernels3d as tk3

S_CAPS = list(range(8, 257, 8))
CAPS = [128, 2048, 8192]


def _items(launch):
    """Item index of every (block of the row, chunk of the block's work
    queue, k, lane), as the kernels compute it: l = j * 4096/P + chunk *
    32K + k * 32 + lane; a warp takes whole chunks, whichever warp it is."""
    per = 4096 // launch.blocks_per_row
    step = 32 * launch.k
    j, c, k, t = np.meshgrid(np.arange(launch.blocks_per_row),
                             np.arange(per // step), np.arange(launch.k),
                             np.arange(32), indexing="ij")
    return (j * per + c * step + k * 32 + t).ravel()


def _check(launch, s_cap, kernel):
    assert launch.smem <= tk3.SMEM_LIMIT == 232_448
    assert launch.k in (1, 2, 4)
    assert launch.blocks_per_row in tk3.PARTS
    assert launch.threads in tk3.THREADS
    assert np.array_equal(np.sort(_items(launch)), np.arange(4096))
    # every warp can take a chunk
    assert launch.threads * launch.k * launch.blocks_per_row <= 4096
    warps = launch.threads // 32
    if launch.home == "shared":
        assert launch.bucket == 0 and launch.shared_warps == warps
    else:
        assert launch.home in (("split", "local") if kernel == "deriv_eval_3d"
                               else ("local",))
        assert (0 < launch.shared_warps < warps if launch.home == "split"
                else launch.shared_warps == 0)
        assert launch.bucket in (16, 32, 64, 128, 256)
        assert launch.bucket >= s_cap and launch.bucket < 2 * max(s_cap, 16)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("s_cap", S_CAPS)
def test_launch_shapes_fit_and_cover_every_item(s_cap, cap):
    v = tk3.voxel_launch(s_cap, cap)
    _check(v, s_cap, "voxel_eval_3d")
    assert v.blocks_per_row == 1 and not v.stage_full
    assert v.smem == tk3.SMEM_HEADER + 12 * cap + 4 * s_cap * v.k * 32 \
        * v.shared_warps
    # the render path's shapes are built into the main library
    assert tk3.library("voxel_eval_3d", v) == "main"
    for n_rows in (1, 58, 240, 4096):
        tcap = 2 * cap
        d = tk3.deriv_launch(s_cap, cap, n_rows, tcap)
        _check(d, s_cap, "deriv_eval_3d")
        assert tk3.library("deriv_eval_3d", d) == "main"
        # the grid fills the card where the rows allow it
        most = 4096 // (d.threads * d.k)
        assert n_rows * d.blocks_per_row >= 2 * tk3.SM_COUNT \
            or d.blocks_per_row == most
        if d.stage_full:
            assert 12 * tcap <= tk3.D_STAGE_MAX
    # every forced shape either fits and covers or is refused; V has no
    # split home
    with pytest.raises(ValueError):
        tk3.voxel_launch(s_cap, cap, home="split")
    for home in ("shared", "split", "local"):
        for k in (1, 2, 4):
            if home != "split":
                try:
                    f = tk3.voxel_launch(s_cap, cap, home=home, k=k)
                except ValueError:
                    assert home != "local"
                else:
                    assert (f.home, f.k) == (home, k)
                    _check(f, s_cap, "voxel_eval_3d")
            try:
                f = tk3.deriv_launch(s_cap, cap, 58, 2 * cap, home=home, k=k)
            except ValueError:
                assert home != "local"
            else:
                assert (f.home, f.k) == (home, k)
                _check(f, s_cap, "deriv_eval_3d")
                # four dual numbers a thread take more than 128 registers
                assert k < 4 or f.threads <= 256


@pytest.mark.parametrize("cell,want", [
    # gyroid_sphere at 1024^3: 10 slots, 256-clause bucket (cap 128)
    ("gyroid_sphere", dict(v=("shared", 256, 4, 8), d=("shared", 256, 1, 8))),
    # extruded_stress at 512^3: 174 slots, 4096-clause bucket (cap 2048),
    # 58 tiles with content
    ("extruded_stress", dict(v=("local", 256, 2, 0),
                             d=("split", 256, 1, 2))),
])
def test_the_3d_cells_get_their_designed_shapes(cell, want):
    s_cap, cap, n_act = ((16, 128, 177) if cell == "gyroid_sphere"
                         else (176, 2048, 58))
    v = tk3.voxel_launch(s_cap, cap)
    assert (v.home, v.threads, v.k, v.shared_warps) == want["v"]
    d = tk3.deriv_launch(s_cap, cap, n_act, 2 * cap)
    assert (d.home, d.threads, d.k, d.shared_warps) == want["d"]
    # the grid holds at least two blocks an SM
    assert n_act * d.blocks_per_row >= 2 * tk3.SM_COUNT
    if cell == "extruded_stress":
        # every column overflows cap there: its 48 KB tape is staged
        assert d.stage_full and d.bucket == 256 and v.bucket == 256


def test_a_small_shared_limit_forces_the_global_tape():
    d = tk3.deriv_launch(176, 2048, 58, 4096)
    small = tk3.deriv_launch(176, 2048, 58, 4096, home="local",
                             smem_limit=tk3.SMEM_HEADER + 12 * 2048)
    assert d.stage_full and not small.stage_full
    assert small.smem == tk3.SMEM_HEADER + 12 * 2048
    with pytest.raises(ValueError):
        tk3.voxel_launch(176, 2048, home="shared", k=4, threads=512)
    with pytest.raises(ValueError):
        tk3.local_bucket(264)


def _forced_shapes(s_cap, cap, tcap):
    """(kernel, launch) for the picked and a spread of forced shapes."""
    out = [("voxel_eval_3d", tk3.voxel_launch(s_cap, cap)),
           ("deriv_eval_3d", tk3.deriv_launch(s_cap, cap, 58, tcap))]
    for home in ("shared", "local"):
        for k in (1, 2, 4):
            try:
                out.append(("voxel_eval_3d",
                            tk3.voxel_launch(s_cap, cap, home=home, k=k)))
            except ValueError:
                pass
    for home in ("shared", "split", "local"):
        for k in (1, 2, 4):
            for parts in (None, 1):
                try:
                    out.append(("deriv_eval_3d", tk3.deriv_launch(
                        s_cap, cap, 58, tcap, home=home, k=k, parts=parts)))
                except ValueError:
                    pass
    return out


@pytest.mark.parametrize("s_cap,cap", [(16, 128), (176, 2048), (64, 8192)])
def test_forced_launch_shapes_are_checked(s_cap, cap):
    """The wrappers take a forced shape only as the launch functions give
    it: its bucket, shared bytes and staging must follow from its home,
    threads, K, P and shared warps."""
    from dataclasses import replace
    tcap = 2 * cap
    for kernel, launch in _forced_shapes(s_cap, cap, tcap):
        assert tk3.check_launch(kernel, launch, s_cap, cap, tcap) is launch
        assert tk3.library(kernel, launch) == (
            "main" if launch.k == tk3.MAIN_K[kernel][launch.bucket != 0]
            else "extra")
        for bad in (replace(launch, smem=launch.smem + 16),
                    replace(launch, bucket=0 if launch.bucket else 16),
                    replace(launch, stage_full=not launch.stage_full),
                    replace(launch, k=3)):
            if bad.stage_full != launch.stage_full and tcap <= cap:
                continue
            with pytest.raises(ValueError):
                tk3.check_launch(kernel, bad, s_cap, cap, tcap)
    # V has no split home, nor more than 256 threads for D at K = 4
    v = tk3.voxel_launch(s_cap, cap, home="local")
    with pytest.raises(ValueError):
        tk3.check_launch("voxel_eval_3d",
                         replace(v, home="split", shared_warps=1), s_cap, cap)
    d = tk3.deriv_launch(s_cap, cap, 58, tcap, home="local", k=4, parts=1)
    with pytest.raises(ValueError):
        tk3.check_launch("deriv_eval_3d", replace(d, threads=512), s_cap,
                         cap, tcap)
