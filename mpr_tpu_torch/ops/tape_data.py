"""Device-side tape representation.

The reference packs clauses into ``uint64`` words in a CUDA buffer
(reference/src/tape.cpp:223-227).  The port keeps the JAX package's
struct-of-arrays layout: one int32 word per clause
(``op | out<<8 | lhs<<16 | rhs<<24``), a float32 immediate plane, and the
full tape's opcode runs (``op | count<<8``), each padded to a capacity
bucket, plus the static metadata the kernels read from ``meta``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..tape.tape import Tape


def _round_bucket(n: int, buckets=(256, 512, 1024, 2048, 4096, 8192, 16384)) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"tape too long: {n}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no card and no explicit device this raises — the port
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class TapeData:
    """Device tape tensors + static metadata.

    ``packed`` (int32), ``imms`` (float32) and ``runs`` (int32) live on one
    device, each of length ``capacity``; the remaining fields are Python
    values.  ``ops_present`` lists the opcodes in the tape, most frequent
    first; it fixes the branch-id table of the kernels (build_remap).
    """

    def __init__(self, packed: torch.Tensor, imms: torch.Tensor,
                 runs: torch.Tensor, length: int, num_slots: int,
                 axis_slots: Tuple[int, int, int], result_slot: int,
                 num_choices: int, ops_present: Tuple[int, ...] = (),
                 num_runs: int = 0):
        self.packed = packed
        self.imms = imms
        self.runs = runs
        self.num_runs = int(num_runs)
        self.length = int(length)
        self.num_slots = int(num_slots)
        self.axis_slots = tuple(int(a) for a in axis_slots)
        self.result_slot = int(result_slot)
        self.num_choices = int(num_choices)
        self.ops_present = tuple(int(o) for o in ops_present)
        self._levels = None

    @classmethod
    def from_tape(cls, tape: Tape, device=None) -> "TapeData":
        n = tape.length
        cap = _round_bucket(n + 1)
        packed = np.zeros(cap, dtype=np.int32)
        imms = np.zeros(cap, dtype=np.float32)
        word = (tape.ops.astype(np.uint32)
                | (tape.outs.astype(np.uint32) << 8)
                | (tape.lhss.astype(np.uint32) << 16)
                | (tape.rhss.astype(np.uint32) << 24))
        packed[:n] = word.astype(np.int32)
        imms[:n] = tape.imms
        # full-tape opcode runs (op | count << 8)
        ops = tape.ops
        bounds = np.flatnonzero(np.diff(ops)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [n]])
        rn = starts.shape[0]
        runs = np.zeros(cap, dtype=np.int32)
        runs[:rn] = (ops[starts].astype(np.int64)
                     | ((ends - starts).astype(np.int64) << 8)).astype(np.int32)
        # ops ordered by descending clause count (the branch-id order)
        counts = np.bincount(ops, minlength=32)
        by_freq = np.argsort(-counts, kind="stable")
        ops_present = tuple(int(o) for o in by_freq if counts[o] > 0)
        return cls.from_arrays(packed, imms, runs, length=n,
                               num_slots=tape.num_slots,
                               axis_slots=tape.axis_slots,
                               result_slot=tape.result_slot,
                               num_choices=tape.num_choices,
                               ops_present=ops_present, num_runs=rn,
                               device=device)

    @classmethod
    def from_arrays(cls, packed, imms, runs, *, length: int, num_slots: int,
                    axis_slots, result_slot: int, num_choices: int,
                    ops_present, num_runs: int, device=None) -> "TapeData":
        """Carry a tape across: numpy planes (e.g. ``np.asarray(td.packed)``
        of an ``mpr_tpu`` TapeData) plus its static fields become this
        package's TapeData on ``device`` (resolved as in
        :func:`resolve_device`)."""
        dev = resolve_device(device)
        packed = np.array(packed, dtype=np.int32)
        imms = np.array(imms, dtype=np.float32)
        runs = np.array(runs, dtype=np.int32)
        if not (packed.ndim == 1 and packed.shape == imms.shape == runs.shape):
            raise ValueError("packed, imms and runs must be 1-D of one length")
        if int(length) > packed.shape[0]:
            raise ValueError(f"tape length {length} exceeds capacity "
                             f"{packed.shape[0]}")
        return cls(torch.from_numpy(packed).to(dev),
                   torch.from_numpy(imms).to(dev),
                   torch.from_numpy(runs).to(dev),
                   length=length, num_slots=num_slots,
                   axis_slots=axis_slots, result_slot=result_slot,
                   num_choices=num_choices, ops_present=ops_present,
                   num_runs=num_runs)

    def levels(self):
        """The tape's dependency schedule (ops/schedule.py::tape_levels) on
        the tape's device, built at the first call and kept, so that every
        launch of kernel A on this tape, in every frame, shares it."""
        if self._levels is None:
            from .schedule import tape_levels
            self._levels = tape_levels(self.packed, self.length,
                                       self.result_slot, self.axis_slots,
                                       device=self.device)
        return self._levels

    @property
    def capacity(self) -> int:
        return int(self.packed.shape[0])

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def meta(self) -> torch.Tensor:
        """int32[8] ``[length, num_slots, result_slot, sx, sy, sz, num_runs,
        0]`` on the tape's device — the runtime metadata every kernel
        reads, so a new tape needs no new build."""
        return torch.tensor([self.length, self.num_slots, self.result_slot,
                             *self.axis_slots, self.num_runs, 0],
                            dtype=torch.int32, device=self.device)
