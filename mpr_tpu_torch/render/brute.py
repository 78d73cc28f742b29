"""Brute-force renderers: the full tape at every pixel or voxel, no culling.

Counterpart of ``mpr_tpu.render.brute`` (``render2d_brute``,
``render3d_brute``; functional parity with the reference's
``Context::render2D_brute``, reference/src/context.cu:1461-1508).  They
are the correctness backstop of the staged pipelines: both run the plain
interpreter of ops/eval_scan.py, one executable for every tape.

``render3d_brute`` works through the volume in slabs of image rows, so a
frame never holds more than ``SLAB_VOXELS`` voxels per tape register.
:func:`build_unrolled_f` is the other way round: the tape compiled, not
interpreted (the reference's ``dump_tape`` codegen).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import eval_scan
from ..ops import transcendental as tc
from ..ops.tape_data import TapeData, resolve_device
from ..tape.tape import Tape
from . import camera

# voxels evaluated at once by render3d_brute (per tape register: 16 MB)
SLAB_VOXELS = 1 << 22


def _centers(size: int, dev) -> torch.Tensor:
    """Pixel centers in exactly this order of operations: another rounding
    of it costs one-voxel depth errors against the staged pipeline."""
    i = torch.arange(size, dtype=torch.float32, device=dev)
    return tc.div_scalar(i + 0.5, size) * 2.0 - 1.0


def render2d_brute(tape: Tape, mat=None, z: float = 0.0, size: int = 256,
                   device=None) -> np.ndarray:
    """Render a bool fill image; row index = y (y-up), col = x."""
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity2() if mat is None else np.asarray(mat, np.float32)
    m = torch.as_tensor(mat, device=dev)
    p = _centers(size, dev)
    x, y = camera.transform2(m, p[None, :], p[:, None])
    zz = torch.tensor(z, dtype=torch.float32, device=dev)
    v = eval_scan.eval_f(td, x.expand(size, size), y.expand(size, size), zz)
    return (v < 0.0).cpu().numpy()


def render3d_brute(tape: Tape, mat=None, size: int = 128,
                   device=None) -> np.ndarray:
    """Render an int32 heightmap: 0 = empty, else the top filled voxel's z
    index + 1 (the reference's atomicMax depth image,
    reference/src/context.cu:932-948)."""
    dev = resolve_device(device)
    td = TapeData.from_tape(tape, device=dev)
    mat = camera.identity3() if mat is None else np.asarray(mat, np.float32)
    m = torch.as_tensor(mat, device=dev)
    p = _centers(size, dev)
    zidx = torch.arange(1, size + 1, dtype=torch.int32, device=dev)
    rows = max(1, SLAB_VOXELS // (size * size))
    out = torch.empty(size, size, dtype=torch.int32, device=dev)
    for r0 in range(0, size, rows):
        fy = p[r0:r0 + rows, None, None]
        x, y, z = camera.transform3(m, p[None, :, None], fy,
                                    p[None, None, :])
        v = eval_scan.eval_f(td, x, y, z)          # (rows, W, D)
        out[r0:r0 + rows] = torch.where(v < 0.0, zidx, 0).amax(dim=2)
    return out.cpu().numpy()


def build_unrolled_f(tape: Tape):
    """The tape as straight-line code, ``f(x, y, z=None, imms=None)``: the
    float evaluator of ops/unrolled_eval.py (the reference's dump_tape
    codegen, reference/benchmark/dump_tape.cpp:43-171) with the immediates
    an input, so one build serves every value of them.  ``imms`` defaults
    to the tape's constants; the plain version is differentiable in
    them."""
    from ..ops import unrolled_eval
    return unrolled_eval.build_float(tape, take_imms=True)
