"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

Everything here is built from a seed with numpy and takes the tree module
(``mpr_tpu.frontend.tree`` or ``mpr_tpu_torch.frontend.tree``) as an
argument, so the same trees can be built in both packages and compiled by
each.  Imports neither package itself.
"""

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Autouse in every module that imports it.  The suite runs several
    test files at once; torch's default of one CPU thread per core then
    oversubscribes the host, and the plain versions' many small ops slow
    down a hundredfold."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_tree(T, rng, depth):
    """The random-tree generator of tests/test_random_trees.py, over the
    tree module ``T``: every operand form, domain-safe unary ops."""
    if depth == 0 or rng.random() < 0.15:
        leaves = [T.x(), T.y(), T.z(),
                  T.const(float(np.round(rng.uniform(-2, 2), 3)))]
        return leaves[rng.integers(len(leaves))]
    r = rng.random()
    a = rand_tree(T, rng, depth - 1)
    if r < 0.45:                          # binary, all operand forms
        b = rand_tree(T, rng, depth - 1)
        op = rng.integers(6)
        if op == 0:
            return a + b
        if op == 1:
            return a - b
        if op == 2:
            return a * b
        if op == 3:                       # safe division
            return a / (T.square(b) + T.const(0.5))
        if op == 4:
            return T.minimum(a, b)
        return T.maximum(a, b)
    if r < 0.6:                           # imm forms (const on one side)
        c = T.const(float(np.round(rng.uniform(-2, 2), 3)))
        forms = [a + c, c - a, a * c, c / (T.square(a) + T.const(0.5))]
        return forms[rng.integers(len(forms))]
    op = rng.integers(9)                  # unary, domain-safe
    if op == 0:
        return -a
    if op == 1:
        return T.square(a)
    if op == 2:
        return T.sqrt(T.square(a) + T.const(0.01))
    if op == 3:
        return T.sin(a)
    if op == 4:
        return T.cos(a)
    if op == 5:
        return abs(a)
    if op == 6:
        return T.exp(T.minimum(a, T.const(3.0)))
    if op == 7:
        return T.log(T.square(a) + T.const(0.5))
    return T.atan(a)


def random_trees(T, compile_tree, n, seed=20260817):
    """The first ``n`` random trees whose tapes have >= 8 clauses."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t = rand_tree(T, rng, 5)
        if compile_tree(t).length >= 8:
            out.append(t)
    return out


def all_ops_clauses():
    """A hand-built tape that runs every opcode 2..31, each result folded
    into a running min/max accumulator so every clause stays live.

    Slots: 1 = x, 2 = y, 3 = z, 4 = scratch, 5 = accumulator, 6 = |x|+0.1
    (a positive operand for sqrt, log and divisors), 7 = 0.9*sin(x) (an
    operand inside asin/acos's domain).  Returns the fields for
    ``Tape.from_arrays``."""
    cl = [(14, 5, 1, 2, 0.0),             # acc = x + y
          (11, 6, 1, 0, 0.0),             # s6 = |x|
          (13, 6, 6, 0, 0.1),             # s6 += 0.1
          (5, 7, 1, 0, 0.0),              # s7 = sin(x)
          (15, 7, 7, 0, 0.9)]             # s7 *= 0.9
    operands = {3: (6, 0), 12: (6, 0), 7: (7, 0), 8: (7, 0),
                22: (0, 2), 25: (0, 6), 26: (1, 6), 27: (0, 0),
                29: (0, 2)}
    for k, op in enumerate(range(2, 32)):
        imm = float(np.float32(0.37 + 0.11 * k))
        lhs, rhs = operands.get(op, (1, 2))
        cl.append((op, 4, lhs, rhs, imm))
        cl.append((18 if k % 2 else 20, 5, 5, 4, 0.0))   # acc = min/max
    cl += [(17, 5, 5, 0, 0.6),            # acc = min(acc, 0.6)
           (19, 5, 5, 0, -0.8),           # acc = max(acc, -0.8)
           (21, 5, 5, 0, 0.25)]           # acc -= 0.25
    ops, outs, lhss, rhss, imms = (np.asarray(c) for c in zip(*cl))
    n_choice = int(((ops >= 17) & (ops <= 20)).sum())
    return dict(ops=ops.astype(np.int32), outs=outs.astype(np.int32),
                lhss=lhss.astype(np.int32), rhss=rhss.astype(np.int32),
                imms=imms.astype(np.float32), axis_slots=(1, 2, 3),
                result_slot=5, num_slots=8, num_choices=n_choice)


def random_boxes(rng, lanes, width=0.5):
    """(6, lanes) f32 boxes xl xh yl yh zl zh inside [-1, 1.5]."""
    lo = rng.uniform(-1, 1, (3, lanes)).astype(np.float32)
    hi = (lo + rng.uniform(0, width, (3, lanes))).astype(np.float32)
    return np.stack([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]])


def unpack_codes(codes, length):
    """(lanes, Tcap/8) packed codes -> (lanes, length) nibbles."""
    c = np.asarray(codes).astype(np.int64) & 0xFFFFFFFF
    nib = (c[:, :, None] >> (4 * np.arange(8))) & 15
    return nib.reshape(c.shape[0], -1)[:, :length]


FILL_BAND = 1e-5
# sin, cos, exp, log: torch's CPU kernels round them an ulp apart from
# XLA's and numpy's
TRANSCENDENTAL_OPS = frozenset({5, 6, 10, 12})


def depth_field(eval_f, tape, mat, size):
    """The oracle's f (``eval_f(tape, x, y, z)``) over the whole volume,
    (H, W, D), at the brute renderers' sample points."""
    p = ((np.arange(size, dtype=np.float32) + 0.5) / size * 2.0
         - 1.0).astype(np.float32)
    fx, fy, fz = p[None, :, None], p[:, None, None], p[None, None, :]
    if mat is not None:
        w = mat[3, 0] * fx + mat[3, 1] * fy + mat[3, 2] * fz + mat[3, 3]
        fx, fy, fz = ((mat[r, 0] * fx + mat[r, 1] * fy + mat[r, 2] * fz
                       + mat[r, 3]) / w for r in range(3))
    shape = (size, size, size)
    return eval_f(tape, np.broadcast_to(fx, shape), np.broadcast_to(fy, shape),
                  np.broadcast_to(fz, shape))


def assert_depth(depth, want, tape, f):
    """Depth images equal; for tapes with sin/cos/exp/log a pixel may differ
    where some voxel of its column has |f| <= FILL_BAND (``f`` from
    :func:`depth_field`), and there are no more such pixels than columns
    in the band."""
    assert depth.shape == want.shape and depth.dtype == np.int32
    diff = depth != want
    if set(np.unique(tape.ops).tolist()) & TRANSCENDENTAL_OPS:
        band = (np.abs(f) <= FILL_BAND).any(axis=2)
        assert not (diff & ~band).any(), int((diff & ~band).sum())
        assert diff.sum() <= band.sum()
    else:
        assert not diff.any(), f"{int(diff.sum())} pixels differ"


def compact_planes(rng, kept, tcap, rows=8):
    """Prepass planes for kernels C and C2 made by hand: row g keeps
    ``kept[g]`` clauses of a ``tcap``-clause plane at seeded places, with
    branch ids in runs of 1 to 6 clauses (low byte 1..255, the word's other
    bytes random, so that many words are negative as int32), random imm
    bits, and each kept clause's leftward move to its place.  Dropped
    clauses hold 0 in every plane, as the prepass leaves them.  Returns
    numpy (lens (G,), wrw, irw, rem (G, rows, tcap // rows)) int32."""
    G = len(kept)
    wrw = np.zeros((G, tcap), np.int64)
    irw = np.zeros((G, tcap), np.int64)
    rem = np.zeros((G, tcap), np.int64)
    for g, n in enumerate(kept):
        t = np.sort(rng.choice(tcap, n, replace=False))
        bid = np.repeat(rng.integers(1, 256, n),
                        rng.integers(1, 7, n))[:n]
        wrw[g, t] = bid | rng.integers(0, 1 << 24, n) << 8
        irw[g, t] = rng.integers(-2**31, 2**31, n)
        rem[g, t] = t - np.arange(n)
    shape = (G, rows, tcap // rows)
    return (np.asarray(kept, np.int32),
            *(p.astype(np.uint32).view(np.int32).reshape(shape)
              for p in (wrw, irw, rem)))


# Hand-made inputs of kernels C and C2: name -> (kept clauses of each row,
# plane length, cap, rows to compact (cmeta[0]))
COMPACT_CASES = {
    # the gyroid bucket: rows that overflow cap, empty rows, rows past
    # cmeta[0]
    "short": ([0, 1, 22, 128, 129, 256, 60, 7] * 5, 256, 128, 33),
    # one row, over cap
    "one_row": ([300], 512, 64, 1),
    # the 16384 bucket: moves past 8192, a row over cap, an empty row
    "far": ([300, 2500, 0, 16384], 16384, 2048, 4),
    # extruded's bucket: rows that keep most of the plane overflow
    "long": ([2659, 164, 0, 4096, 2048, 2049, 1000, 3] * 2, 4096, 2048, 13),
    # a cap that is not a multiple of 4
    "odd_cap": ([0, 5, 13, 14, 700, 1024, 50], 1024, 13, 7),
}
