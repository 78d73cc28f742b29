"""The 3D kernels: voxel evaluation and normals, CUDA wrappers and their
plain PyTorch versions.

Two kernels complement ops/kernels.py on the 3D render path, each written
by hand in CUDA for Hopper (sources in ``csrc/``, built by ``build.py``):

  * kernel V, :func:`voxel_eval_3d` — the value of the field at the 4096
    voxels of each ambiguous 16^3 cell, run with the cell's own shortened
    tape; the voxels' world coordinates are made in the kernel from the
    cell id and the camera matrix;
  * kernel D, :func:`deriv_eval_3d` — value and gradient (v, d/dx, d/dy,
    d/dz) by forward-mode dual numbers at each pixel of each 64-px screen
    tile with content, sampled one voxel in front of the depth surface and
    run with the tile's z-column tape (valid at every depth of the column).

Both take per-row tapes with branch-id run headers (kernel C's outputs)
and fall back to the full tape for a row whose tape overflowed its
capacity.  As in ops/kernels.py, a wrapper launches its kernel for CUDA
tensors (and raises if it cannot) and runs the plain version beside it
only when its inputs lie on the CPU; ``<wrapper>.launches`` counts the
launches.

Each kernel's launch shape (where its register file lives, threads, items
a thread, blocks a row, dynamic shared memory) is chosen on the host by
:func:`voxel_launch` and :func:`deriv_launch`, pure functions of the slot
bucket, the row capacity and, for D, the rows; a caller may pass another
shape (``launch=``), which the wrapper checks.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..tape.opcodes import Op
from . import build
from . import transcendental as tc
from .kernels import (REG_CAP, _bid_table_on, _check, _launch, _on_cuda,
                      _run_programs, _stream, _tile_programs, bid_table,
                      float_clause)
from .launch import (BUCKETS, KS, MAIN_K, PARTS, SM_COUNT, SM_SHARED,  # noqa: F401
                     SMEM_HEADER, SMEM_LIMIT, STAGE_MAX, THREADS, Launch,
                     _check_shape, _most_shared_warps, _resident, _shape,
                     _tape_bytes, library, local_bucket)

CELL = 16          # voxels per cell edge
CELL_VOXELS = CELL ** 3
TILE = 64          # pixels per screen-tile edge
TILE_PIXELS = TILE * TILE
# Rows the plain versions interpret at once (bounds their register files:
# rows x s_cap x 4096 floats for V, four times that for D).
PLAIN_ROWS = 1 << 26


# ---------------------------------------------------------------------------
# Launch shapes of kernels V and D (csrc/regfile.cuh; the shape helpers
# they share with kernel B are in ops/launch.py)
# ---------------------------------------------------------------------------

V_SHARED = (256, 4)      # V, files in shared memory: threads, K
V_LOCAL = (256, 2)       # V, files in local memory: threads, K
D_SPLIT = (256, 1)       # D, files split or local: threads, K
D_MIN_WARPS = 4          # D: warps an SM needs in the shared home
D_STAGE_MAX = STAGE_MAX  # D: an overflowed row's full tape is staged in
#                          shared memory where it takes at most this
# D at K = 4 needs more than 128 registers a thread: its instantiations are
# built for at most 256 threads (csrc/deriv_eval.cu, max_threads)
D_MAX_THREADS_K4 = 256


def _deriv_max_threads(k):
    return D_MAX_THREADS_K4 if k == 4 else THREADS[0]


def _voxel_fixed(cap):
    return SMEM_HEADER + _tape_bytes(cap)


def _deriv_fixed(cap, tcap, stage_full):
    return SMEM_HEADER + _tape_bytes(max(cap, tcap) if stage_full else cap)


def voxel_launch(s_cap: int, cap: int, smem_limit: int = SMEM_LIMIT, *,
                 home: str = None, threads: int = None,
                 k: int = None) -> Launch:
    """Kernel V's launch shape for slot bucket ``s_cap`` and row capacity
    ``cap``.

    Where the files of ``V_SHARED`` (threads, K) fit in shared memory and
    leave an SM two blocks, they live there (a short tape, whose decode K
    amortises); otherwise in local memory, ``V_LOCAL`` (threads, K) (a
    long tape: the shared home holds too few voxels an SM to hide its
    latency).  ``home`` (``"shared"`` or ``"local"``), ``threads`` and
    ``k`` force a shape, its missing parts chosen as above; a forced shape
    that does not fit raises."""
    fixed = _voxel_fixed(cap)

    def shape(h, t, kk):
        return _check_shape(_shape(h, t, kk, s_cap, 4, fixed), smem_limit,
                            homes=("shared", "local"))

    if home is None and threads is None and k is None:
        sh = _shape("shared", *V_SHARED, s_cap, 4, fixed)
        if sh.smem <= min(smem_limit, SM_SHARED // 2 - 1024):
            return sh
        return shape("local", *V_LOCAL)
    home = home or "shared"
    k = k or (V_SHARED if home == "shared" else V_LOCAL)[1]
    if threads is None:
        if home == "shared":
            fits = [t for t in THREADS if t * k <= 4096 and _shape(
                home, t, k, s_cap, 4, fixed).smem <= smem_limit]
            threads = fits[0] if fits else THREADS[-1]
        else:
            threads = V_LOCAL[0] * V_LOCAL[1] // k
    return shape(home, threads, k)


def deriv_launch(s_cap: int, cap: int, n_rows_active: int, tcap: int,
                 smem_limit: int = SMEM_LIMIT, *, home: str = None,
                 threads: int = None, k: int = None, parts: int = None,
                 stage_full: bool = None,
                 shared_warps: int = None) -> Launch:
    """Kernel D's launch shape for slot bucket ``s_cap``, row capacity
    ``cap``, ``n_rows_active`` rows and a full tape of ``tcap`` clauses.

    The dual-number files (16 bytes a slot) take the shared home, K = 1,
    with 256 or 128 threads where that fits and leaves an SM at least
    ``D_MIN_WARPS`` warps; else the block is ``D_SPLIT`` (threads, K) with
    as many warps in shared memory as fit and the rest in local memory
    (all local when none fits).  An overflowed row's full tape is staged in
    shared memory where it takes at most ``D_STAGE_MAX`` bytes and fits.
    P, the blocks a row, is the smallest power of two that gives the grid
    at least as many blocks as the card holds at once (and at least two an
    SM).  ``home``, ``threads``, ``k``, ``parts``, ``stage_full`` and
    ``shared_warps`` force a shape; a forced shape that does not fit
    raises."""
    def shape(h, t, kk, sw=None):
        stage = stage_full
        if stage is None:
            stage = (_tape_bytes(tcap) <= D_STAGE_MAX and _shape(
                h, t, kk, s_cap, 16, _deriv_fixed(cap, tcap, True),
                sw).smem <= smem_limit)
        return _shape(h, t, kk, s_cap, 16, _deriv_fixed(cap, tcap, stage),
                      sw, stage)

    most_threads = _deriv_max_threads(k)
    if home is None and threads is None and k is None \
            and shared_warps is None:
        for t in (256, 128):
            sh = shape("shared", t, 1)
            if sh.smem <= smem_limit and \
                    _resident(sh.smem, t) * t // 32 >= D_MIN_WARPS:
                home, threads, k = "shared", t, 1
                break
        if home is None:
            threads, k = D_SPLIT
            # the files first, the full tape where room is left
            shared_warps = _most_shared_warps(
                threads, k, s_cap, 16, _deriv_fixed(cap, tcap, False),
                smem_limit)
            home = "split" if shared_warps else "local"
    else:
        home = home or ("split" if shared_warps else "shared")
        k = k or 1
        if threads is None:
            if home == "shared":
                fits = [t for t in THREADS if t <= most_threads
                        and t * k <= 4096
                        and shape(home, t, k).smem <= smem_limit]
                threads = fits[0] if fits else THREADS[-1]
            else:
                threads = min(D_SPLIT[0], most_threads)
        if home == "split" and shared_warps is None:
            shared_warps = _most_shared_warps(
                threads, k, s_cap, 16, _deriv_fixed(cap, tcap, False),
                smem_limit)
    launch = shape(home, threads, k, shared_warps)
    if parts is None:
        target = max(2 * SM_COUNT,
                     SM_COUNT * _resident(launch.smem, threads))
        most = 4096 // (threads * k)
        parts = 1
        while parts < most and 0 < n_rows_active * parts < target:
            parts *= 2
    return _check_shape(replace(launch, blocks_per_row=parts), smem_limit,
                        _deriv_max_threads(k))


def check_launch(kernel: str, launch: Launch, s_cap: int, cap: int,
                 tcap: int = 0) -> Launch:
    """A caller's ``launch`` of ``kernel`` (``"voxel_eval_3d"`` or
    ``"deriv_eval_3d"``) for slot bucket ``s_cap``, row capacity ``cap``
    and (D) a full tape of ``tcap`` clauses, checked: a shape the kernel
    can run, whose bucket, shared bytes and staging are the ones its home,
    threads, K, P and shared warps give."""
    if kernel == "voxel_eval_3d":
        want = _shape(launch.home, launch.threads, launch.k, s_cap, 4,
                      _voxel_fixed(cap))
        _check_shape(launch, SMEM_LIMIT, homes=("shared", "local"))
    else:
        want = _shape(launch.home, launch.threads, launch.k, s_cap, 16,
                      _deriv_fixed(cap, tcap, launch.stage_full),
                      launch.shared_warps, launch.stage_full,
                      launch.blocks_per_row)
        _check_shape(launch, SMEM_LIMIT, _deriv_max_threads(launch.k))
    if launch != want:
        raise ValueError(f"launch shape {launch} is not {want}")
    return launch


def _mat4_apply(matf, wx, wy, wz):
    """Projective mat4 transform with scalar matrix entries, in the
    kernels' order of operations: four dot products left to right, then
    three divisions by w (reference/src/context.cu:739-747)."""
    def m(r, c):
        return matf[r * 4 + c]
    w = m(3, 0) * wx + m(3, 1) * wy + m(3, 2) * wz + m(3, 3)
    x = (m(0, 0) * wx + m(0, 1) * wy + m(0, 2) * wz + m(0, 3)) / w
    y = (m(1, 0) * wx + m(1, 1) * wy + m(1, 2) * wz + m(1, 3)) / w
    z = (m(2, 0) * wx + m(2, 1) * wy + m(2, 2) * wz + m(2, 3)) / w
    return x, y, z


def _world(idx, size: int):
    """Voxel index (float tensor) -> render-space coordinate."""
    return tc.div_scalar(idx + 0.5, size) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# Kernel V: voxel evaluation (3D leaf stage)
# ---------------------------------------------------------------------------

def voxel_eval_3d_plain(nmeta, order, order0, matf, words, imms, runs_full,
                        branch_ops, tw, ti, runs, gmeta, n_side, n_rows,
                        s_cap):
    """Plain PyTorch kernel V, a chunk of cells at a time.  Same signature
    and outputs as :func:`voxel_eval_3d`; rows at or past ``nmeta[0]``
    come back zero."""
    gcap = tw.shape[0]
    dev = tw.device
    nm = [int(v) for v in nmeta.tolist()]
    n_amb1, res, sx, sy, sz, row0 = nm[0], nm[2], nm[3], nm[4], nm[5], nm[7]
    n_amb1 = min(n_amb1, gcap)
    size = n_side * TILE
    vals = torch.zeros(gcap, CELL_VOXELS, dtype=torch.float32, device=dev)
    l = torch.arange(CELL_VOXELS, device=dev)
    vx = (l % CELL).to(torch.float32)
    vy = ((l // CELL) % CELL).to(torch.float32)
    vz = (l // (CELL * CELL)).to(torch.float32)
    table = bid_table(branch_ops)
    chunk = max(1, PLAIN_ROWS // (s_cap * CELL_VOXELS))
    for g0 in range(0, n_amb1, chunk):
        sel = np.arange(g0, min(g0 + chunk, n_amb1))
        child = order[g0:g0 + sel.size].long()
        c = child % 64
        p = order0[child // 64].long()
        # slab-local parent id p = (tz * n_rows + ty_l) * n + tx; child
        # c = (czi * 4 + cyi) * 4 + cxi
        tx = p % n_side
        ty = row0 + (p // n_side) % n_rows
        tz = p // (n_side * n_rows)
        bx = (tx * TILE + (c % 4) * CELL).to(torch.float32)
        by = (ty * TILE + ((c // 4) % 4) * CELL).to(torch.float32)
        bz = (tz * TILE + (c // 16) * CELL).to(torch.float32)
        x, y, z = _mat4_apply(matf, _world(bx[:, None] + vx, size),
                              _world(by[:, None] + vy, size),
                              _world(bz[:, None] + vz, size))
        progs = _tile_programs(sel, nmeta, words, imms, runs_full, table, tw,
                               ti, runs, gmeta)
        regs = torch.zeros(sel.size, s_cap, CELL_VOXELS, dtype=torch.float32,
                           device=dev)
        regs[:, sx] = x
        regs[:, sy] = y
        regs[:, sz] = z
        regs[:, 0] = 0.0
        _run_programs(progs, regs, float_clause)
        vals[g0:g0 + sel.size] = regs[:, res]
    return vals


def _check_row_tapes(words, imms, runs_full, tw, ti, runs, gmeta):
    tcap = words.shape[0]
    gcap, cap = tw.shape
    _check(words, "words", torch.int32, (tcap,))
    _check(imms, "imms", torch.float32, (tcap,))
    _check(runs_full, "runs_full", torch.int32, (tcap,))
    _check(tw, "tw", torch.int32, (gcap, cap))
    _check(ti, "ti", torch.float32, (gcap, cap))
    _check(runs, "runs", torch.int32, (gcap, cap))
    _check(gmeta, "gmeta", torch.int32, (gcap, 8))
    if cap > 16384:
        raise ValueError(f"per-row tape capacity {cap} out of range")


def voxel_eval_3d(nmeta, order, order0, matf, words, imms, runs_full,
                  branch_ops, tw, ti, runs, gmeta, n_side: int, n_rows: int,
                  s_cap: int, launch: Launch = None):
    """Kernel V: evaluate the 4096 voxels of each ambiguous 16^3 cell.

    nmeta: (8,) int32 [n_amb1, S, res, sx, sy, sz, n_runs_full, row0];
    order: (>= gcap,) int32 child lane per row (lane = parent slot * 64 +
    child, child = (czi*4 + cyi)*4 + cxi); order0: (P0,) int32 slab-local
    parent tile id per parent slot ((tz*n_rows + ty_local)*n_side + tx);
    matf: (16,) f32 row-major mat4; words/imms/runs_full: the full tape,
    runs' op byte a branch id; branch_ops: build_remap's tuple;
    tw/ti/runs/gmeta: kernel C outputs, one row per cell in ``order``
    order; the frame is (n_side*64)^3 voxels and the slab starts at screen
    tile row ``row0``.

    Returns vals (gcap, 4096) f32, lane l = vz*256 + vy*16 + vx; rows at or
    past ``n_amb1`` are not written.  ``launch`` forces a launch shape (one
    :func:`voxel_launch` can give; default: the one it picks); the plain
    version takes none.
    """
    if not _on_cuda(nmeta, order, order0, matf, words, imms, runs_full, tw,
                    ti, runs, gmeta):
        return voxel_eval_3d_plain(nmeta, order, order0, matf, words, imms,
                                   runs_full, branch_ops, tw, ti, runs, gmeta,
                                   n_side, n_rows, s_cap)
    gcap, cap = tw.shape
    _check(nmeta, "nmeta", torch.int32, (8,))
    _check(order, "order", torch.int32, (order.shape[0],))
    _check(order0, "order0", torch.int32, (order0.shape[0],))
    _check(matf, "matf", torch.float32, (16,))
    _check_row_tapes(words, imms, runs_full, tw, ti, runs, gmeta)
    if order.shape[0] < gcap:
        raise ValueError(f"{order.shape[0]} order rows for {gcap} tape rows")
    if not s_cap <= REG_CAP or len(branch_ops) > 255:
        raise ValueError(f"s_cap {s_cap} or {len(branch_ops)} branches "
                         "out of range")
    if not 1 <= n_rows <= n_side:
        raise ValueError(f"bad slab: {n_rows} rows of {n_side}")
    if launch is None:
        launch = voxel_launch(s_cap, cap)
    else:
        check_launch("voxel_eval_3d", launch, s_cap, cap)
    dev = tw.device
    table = _bid_table_on(branch_ops, dev)
    vals = torch.empty(gcap, CELL_VOXELS, dtype=torch.float32, device=dev)
    if gcap:
        fn = build.lib(library("voxel_eval_3d", launch)).mpr_voxel_eval
        with torch.cuda.device(dev):
            _launch(fn, nmeta.data_ptr(), order.data_ptr(),
                    order0.data_ptr(), matf.data_ptr(), words.data_ptr(),
                    imms.data_ptr(), runs_full.data_ptr(), table.data_ptr(),
                    tw.data_ptr(), ti.data_ptr(), runs.data_ptr(),
                    gmeta.data_ptr(), vals.data_ptr(), gcap, cap, n_side,
                    n_rows, s_cap, launch.bucket, launch.threads, launch.k,
                    launch.smem, _stream())
        _voxel_eval_3d.launches += 1
    return vals


voxel_eval_3d.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_voxel_eval_3d = voxel_eval_3d


# ---------------------------------------------------------------------------
# Kernel D: forward-mode dual-number evaluation (normals)
# ---------------------------------------------------------------------------

def deriv_clause(op: int, a, b, imm):
    """One clause on 4-tuples (v, dx, dy, dz): the dual-number rules of
    the reference's ``Deriv`` (reference/inc/gpu_deriv.hpp), operation for
    operation as the CUDA kernel runs them.  min/max pick the winning
    side's whole tuple; an immediate has zero derivatives."""
    def d0(v):
        z = a[1] * 0.0
        return (v, z, z, z)

    def lift(v, c):
        return (v, c * a[1], c * a[2], c * a[3])

    def select(c, p, q):
        return tuple(torch.where(c, s, t) for s, t in zip(p, q))

    av, bv = a[0], b[0]
    if op in (Op.INVALID, Op.JUMP):
        return d0(av * 0.0)
    if op == Op.SQUARE_LHS:
        return lift(av * av, 2.0 * av)
    if op == Op.SQRT_LHS:
        return lift(tc.sqrt(av), 0.5 / tc.sqrt(av))
    if op == Op.NEG_LHS:
        return (-av, -a[1], -a[2], -a[3])
    if op == Op.SIN_LHS:
        return lift(torch.sin(av), torch.cos(av))
    if op == Op.COS_LHS:
        return lift(torch.cos(av), -torch.sin(av))
    if op == Op.ASIN_LHS:
        return lift(tc.asin(av), 1.0 / tc.sqrt(1.0 - av * av))
    if op == Op.ACOS_LHS:
        return lift(tc.acos(av), -1.0 / tc.sqrt(1.0 - av * av))
    if op == Op.ATAN_LHS:
        return lift(tc.atan(av), 1.0 / (1.0 + av * av))
    if op == Op.EXP_LHS:
        return lift(torch.exp(av), torch.exp(av))
    if op == Op.ABS_LHS:
        return lift(torch.abs(av), torch.where(av < 0.0, -1.0, 1.0))
    if op == Op.LOG_LHS:
        return lift(torch.log(av), 1.0 / av)
    if op == Op.ADD_LHS_IMM:
        return (av + imm, a[1], a[2], a[3])
    if op == Op.ADD_LHS_RHS:
        return tuple(s + t for s, t in zip(a, b))
    if op == Op.MUL_LHS_IMM:
        return tuple(s * imm for s in a)
    if op == Op.MUL_LHS_RHS:
        return (av * bv, av * b[1] + bv * a[1], av * b[2] + bv * a[2],
                av * b[3] + bv * a[3])
    if op == Op.MIN_LHS_IMM:
        return select(av < imm, a, d0(imm.expand_as(av)))
    if op == Op.MIN_LHS_RHS:
        return select(av < bv, a, b)
    if op == Op.MAX_LHS_IMM:
        return select(av > imm, a, d0(imm.expand_as(av)))
    if op == Op.MAX_LHS_RHS:
        return select(av > bv, a, b)
    if op == Op.SUB_LHS_IMM:
        return (av - imm, a[1], a[2], a[3])
    if op == Op.SUB_IMM_RHS:
        return (imm - bv, -b[1], -b[2], -b[3])
    if op == Op.SUB_LHS_RHS:
        return tuple(s - t for s, t in zip(a, b))
    if op == Op.DIV_LHS_IMM:
        inv = 1.0 / imm
        return tuple(s * inv for s in a)
    if op == Op.DIV_IMM_RHS:
        v = imm / bv
        c = -v / bv
        return (v, c * b[1], c * b[2], c * b[3])
    if op == Op.DIV_LHS_RHS:
        inv = 1.0 / bv
        v = av * inv
        return (v, (a[1] - v * b[1]) * inv, (a[2] - v * b[2]) * inv,
                (a[3] - v * b[3]) * inv)
    if op == Op.COPY_IMM:
        return d0(imm.expand_as(av))
    if op == Op.COPY_LHS:
        return tuple(a)
    if op == Op.COPY_RHS:
        return tuple(b)
    if op == Op.HYPOT_LHS_RHS:
        v = tc.sqrt(av * av + bv * bv)
        inv = 1.0 / v
        return (v, (av * a[1] + bv * b[1]) * inv,
                (av * a[2] + bv * b[2]) * inv, (av * a[3] + bv * b[3]) * inv)
    if op == Op.ADDSQ_LHS_RHS:
        c = 2.0 * av
        return (av * av + bv, c * a[1] + b[1], c * a[2] + b[2],
                c * a[3] + b[3])
    raise ValueError(f"no deriv branch for op {op}")


def _deriv_planes(op, a, b, imm):
    """:func:`deriv_clause` on stacked operands (rows, 4, lanes)."""
    return torch.stack(deriv_clause(op, a.unbind(1), b.unbind(1), imm[:, 0]),
                       dim=1)


def deriv_eval_3d_plain(nmeta, order, matf, words, imms, runs_full,
                        branch_ops, tw, ti, runs, gmeta, depth_blocks,
                        n_side, n_rows, s_cap):
    """Plain PyTorch kernel D, a chunk of tiles at a time.  Same signature
    and outputs as :func:`deriv_eval_3d`; rows at or past ``nmeta[0]``
    come back zero."""
    gcap = tw.shape[0]
    dev = tw.device
    nm = [int(v) for v in nmeta.tolist()]
    n_act, res, sx, sy, sz, row0 = nm[0], nm[2], nm[3], nm[4], nm[5], nm[7]
    n_act = min(n_act, gcap)
    size = n_side * TILE
    out = torch.zeros(gcap, 4, TILE_PIXELS, dtype=torch.float32, device=dev)
    l = torch.arange(TILE_PIXELS, device=dev)
    px = (l % TILE).to(torch.float32)
    py = (l // TILE).to(torch.float32)
    table = bid_table(branch_ops)
    chunk = max(1, PLAIN_ROWS // (4 * s_cap * TILE_PIXELS))
    for g0 in range(0, n_act, chunk):
        sel = np.arange(g0, min(g0 + chunk, n_act))
        t = order[g0:g0 + sel.size].long()      # slab-local xy tile id
        tx = (t % n_side * TILE).to(torch.float32)
        ty = ((row0 + t // n_side) * TILE).to(torch.float32)
        # depth stores the top filled voxel's index + 1, so voxel d is the
        # first empty one: the sample lies one voxel in front of the surface
        zi = torch.clamp_max(depth_blocks[t], size - 1).to(torch.float32)
        x, y, z = _mat4_apply(matf, _world(tx[:, None] + px, size),
                              _world(ty[:, None] + py, size),
                              _world(zi, size))
        progs = _tile_programs(sel, nmeta, words, imms, runs_full, table, tw,
                               ti, runs, gmeta)
        regs = torch.zeros(sel.size, s_cap, 4, TILE_PIXELS,
                           dtype=torch.float32, device=dev)
        # seeds: transformed coordinates with unit derivatives (not pushed
        # through the matrix; reference/src/context.cu:1009-1029)
        for k, (s, v) in enumerate(((sx, x), (sy, y), (sz, z))):
            regs[:, s] = 0.0
            regs[:, s, 0] = v
            regs[:, s, k + 1] = 1.0
        regs[:, 0] = 0.0
        _run_programs(progs, regs, _deriv_planes)
        out[g0:g0 + sel.size] = regs[:, res]
    return out


def deriv_eval_3d(nmeta, order, matf, words, imms, runs_full, branch_ops,
                  tw, ti, runs, gmeta, depth_blocks, n_side: int, n_rows: int,
                  s_cap: int, launch: Launch = None):
    """Kernel D: value and gradient at every pixel of each 64-px screen
    tile with content, one voxel in front of the depth surface.

    nmeta: (8,) int32 [n_act, S, res, sx, sy, sz, n_runs_full, row0];
    order: (>= gcap,) int32 slab-local xy tile id per row (tiles with
    content first); matf: (16,) f32 row-major mat4; words/imms/runs_full:
    the full tape; tw/ti/runs/gmeta: kernel C outputs, one z-column tape
    per row in ``order`` order; depth_blocks: (n_rows*n_side, 4096) int32
    depth per tile, pixel l = py*64 + px, indexed by TILE id.

    Returns (gcap, 4, 4096) f32 — v, d/dx, d/dy, d/dz per pixel, rows in
    ``order`` order; rows at or past ``n_act`` are not written.
    ``launch`` forces a launch shape (one :func:`deriv_launch` can give;
    default: the one it picks for ``gcap`` rows); the plain version takes
    none.
    """
    if not _on_cuda(nmeta, order, matf, words, imms, runs_full, tw, ti, runs,
                    gmeta, depth_blocks):
        return deriv_eval_3d_plain(nmeta, order, matf, words, imms, runs_full,
                                   branch_ops, tw, ti, runs, gmeta,
                                   depth_blocks, n_side, n_rows, s_cap)
    gcap, cap = tw.shape
    _check(nmeta, "nmeta", torch.int32, (8,))
    _check(order, "order", torch.int32, (order.shape[0],))
    _check(matf, "matf", torch.float32, (16,))
    _check_row_tapes(words, imms, runs_full, tw, ti, runs, gmeta)
    _check(depth_blocks, "depth_blocks", torch.int32,
           (n_rows * n_side, TILE_PIXELS))
    if not gcap <= order.shape[0] <= n_rows * n_side:
        raise ValueError(f"{order.shape[0]} order rows for {gcap} tape rows "
                         f"and {n_rows * n_side} tiles")
    if not s_cap <= REG_CAP or len(branch_ops) > 255:
        raise ValueError(f"s_cap {s_cap} or {len(branch_ops)} branches "
                         "out of range")
    tcap = words.shape[0]
    if launch is None:
        launch = deriv_launch(s_cap, cap, gcap, tcap)
    else:
        check_launch("deriv_eval_3d", launch, s_cap, cap, tcap)
    dev = tw.device
    table = _bid_table_on(branch_ops, dev)
    out = torch.empty(gcap, 4, TILE_PIXELS, dtype=torch.float32, device=dev)
    if gcap:
        fn = build.lib(library("deriv_eval_3d", launch)).mpr_deriv_eval
        with torch.cuda.device(dev):
            _launch(fn, nmeta.data_ptr(), order.data_ptr(), matf.data_ptr(),
                    words.data_ptr(), imms.data_ptr(), runs_full.data_ptr(),
                    table.data_ptr(), tw.data_ptr(), ti.data_ptr(),
                    runs.data_ptr(), gmeta.data_ptr(),
                    depth_blocks.data_ptr(), out.data_ptr(), gcap, cap,
                    n_side, s_cap, tcap, launch.bucket, launch.threads,
                    launch.k, launch.blocks_per_row, int(launch.stage_full),
                    launch.shared_warps, launch.smem, _stream())
        _deriv_eval_3d.launches += 1
    return out


deriv_eval_3d.launches = 0
# the counter's home, kept if the module attribute is rebound (a recorder)
_deriv_eval_3d = deriv_eval_3d
