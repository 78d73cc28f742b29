"""The yardstick of the roofline metrics: the card's peaks and the
operations and bytes of a kernel's work, counted from the tape clauses
each lane is given, never from generated source or SASS.

Operations are single IEEE float operations (the port builds with
``--fmad=false``, so no multiply-add fuses), against one a lane a clock:
132 SMs x 128 lanes x 1.98 GHz = 33.5e12 a second, half the data sheet's
67 TFLOP/s, which counts an FMA as two.  Bytes: each input read once and
each output written once, against 3.35 TB/s of HBM3.  Both are the NVIDIA
H100 SXM's published peaks at its 700 W limit.
"""

from __future__ import annotations

import numpy as np

PEAK_F32_PER_S = 33.5e12
PEAK_BYTES_PER_S = 3.35e12

# Float operations of a clause a lane, by opcode: one per IEEE arithmetic
# operation or math-library call of the clause's formula (the Cephes forms
# of asin, acos and atan counted out), none for compares, selects and
# copies.  The same for a reverse step (the rule's operations and one
# addition a share it hands on).
FLOAT_OPS = {2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 14, 8: 15, 9: 15, 10: 1,
             11: 1, 12: 1, 13: 1, 14: 1, 15: 1, 16: 1, 17: 1, 18: 1, 19: 1,
             20: 1, 21: 1, 22: 1, 23: 1, 24: 1, 25: 1, 26: 1, 27: 0, 28: 0,
             29: 0, 30: 4, 31: 2}
VJP_OPS = {2: 3, 3: 3, 4: 2, 5: 3, 6: 4, 7: 5, 8: 6, 9: 4, 10: 2, 11: 2,
           12: 2, 13: 2, 14: 2, 15: 4, 16: 4, 17: 4, 18: 4, 19: 4, 20: 4,
           21: 3, 22: 3, 23: 3, 24: 7, 25: 7, 26: 7, 27: 1, 28: 1, 29: 1,
           30: 8, 31: 4}
# a voxel's coordinates from its index: three conversions and the 4x4 view
COORD_OPS = 42
# a clause of a shortened tape as a kernel reads it: its word and its
# immediate; a run header
CLAUSE_BYTES = 8
RUN_BYTES = 4


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(ops / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S)


def tape_ops(ops) -> int:
    """Float operations a lane of a whole tape (its opcodes ``ops``)."""
    return int(sum(FLOAT_OPS.get(int(o), 0) for o in ops))


def reaching(ops, outs, lhss, rhss, result_slot: int) -> np.ndarray:
    """The clauses whose output reaches the result (bool a clause)."""
    live = {int(result_slot)}
    out = np.zeros(len(ops), bool)
    for t in range(len(ops) - 1, -1, -1):
        o = int(outs[t])
        if o in live:
            out[t] = True
            live.discard(o)
            live.update(s for s in (int(lhss[t]), int(rhss[t])) if s)
    return out


def row_counts(gmeta, runs, branch_ops, full_ops: int, full_len: int,
               n_valid=None):
    """Float operations a lane, and clauses and run headers read, summed
    over the rows of kernel C's output that a kernel evaluates, as 0-d
    int64 tensors on their device (no read back to the host).

    ``gmeta`` (G, 8) int32 ``[length, runs, overflowed, ..]`` a row;
    ``runs`` (G, cap) headers ``branch id | count << 8``; ``branch_ops``
    the opcodes of the branch ids 1, 2, ...; a row that overflowed runs
    the full tape (``full_ops`` a lane, ``full_len`` clauses); rows from
    ``n_valid`` (a 0-d tensor) on are not evaluated."""
    import torch
    dev = runs.device
    lut = torch.zeros(256, dtype=torch.int64, device=dev)
    for i, o in enumerate(branch_ops):
        lut[i + 1] = FLOAT_OPS.get(int(o), 0)
    g = gmeta.long()
    idx = torch.arange(runs.shape[1], device=dev)
    hdr = runs.long()
    per = torch.where(idx[None, :] < g[:, 1:2],
                      lut[hdr & 0xFF] * (hdr >> 8), 0).sum(1)
    over = g[:, 2] != 0
    ops = torch.where(over, full_ops, per)
    clauses = torch.where(over, full_len, g[:, 0])
    nruns = torch.where(over, 0, g[:, 1])
    if n_valid is not None:
        keep = torch.arange(g.shape[0], device=dev) < n_valid.long()
        ops, clauses, nruns = (torch.where(keep, t, 0)
                               for t in (ops, clauses, nruns))
    return ops.sum(), clauses.sum(), nruns.sum()
