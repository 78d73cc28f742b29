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
from ..utils.trace import upload


def _round_bucket(n: int, buckets=(256, 512, 1024, 2048, 4096, 8192, 16384)) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"tape too long: {n}")


def operand_sources(outs, lhss, rhss, axis_slots) -> np.ndarray:
    """Where each clause's operands come from: int64 (2, clauses), row 0
    the lhs and row 1 the rhs; the clause whose output the operand reads
    (the last earlier clause that wrote that slot), -1 / -2 / -3 for the
    x / y / z input, -4 for a slot never written (zero)."""
    last = np.full(256, -4, np.int64)
    for k, s in enumerate(axis_slots):
        if s:
            last[s] = -1 - k
    src = np.empty((2, len(outs)), np.int64)
    for t, (o, l, r) in enumerate(zip(np.asarray(outs).tolist(),
                                      np.asarray(lhss).tolist(),
                                      np.asarray(rhss).tolist())):
        src[0, t], src[1, t] = last[l], last[r]
        last[o] = t
    return src


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
        self._sources = None
        # the backward storage plan, shared with every replace_imms copy
        # (a fit step differentiates a copy), built at the first use
        self._plan = {}

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
        return cls(upload(packed, dev), upload(imms, dev), upload(runs, dev),
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

    def replace_imms(self, imms) -> "TapeData":
        """The same tape with another constant plane (a fit step, a
        slider): ``imms`` (the capacity's length, on the tape's device;
        it may require grad).  The new TapeData keeps this one's
        dependency schedule, the interval adjoint's operand table, the
        backward storage plan and K2f's walk, none of which holds an
        immediate (kernel A reads ``imms`` through the schedule's ``t``
        plane)."""
        imms = torch.as_tensor(imms, dtype=torch.float32, device=self.device)
        if imms.shape != self.imms.shape:
            raise ValueError(f"imms: shape {tuple(imms.shape)}, want "
                             f"{tuple(self.imms.shape)}")
        td = TapeData(self.packed, imms, self.runs, self.length,
                      self.num_slots, self.axis_slots, self.result_slot,
                      self.num_choices, self.ops_present, self.num_runs)
        td._levels = self._levels
        td._sources = self._sources
        td._plan = self._plan
        return td

    def sources(self):
        """:func:`operand_sources` of the tape as int32 on its device, for
        the interpreter's adjoint (``ops/eval_scan.py``); built at the
        first call and kept."""
        if self._sources is None:
            w = self.packed[:self.length].cpu().numpy().astype(
                np.int64) & 0xFFFFFFFF
            src = operand_sources((w >> 8) & 0xFF, (w >> 16) & 0xFF,
                                  w >> 24, self.axis_slots)
            self._sources = torch.from_numpy(src.astype(np.int32)).to(
                self.device)
        return self._sources

    def vjp_plan(self):
        """The tape's backward storage plan (``ops/vjp_plan.py``) and its
        device planes for kernels K2f and K2: ``(plan, spos, ab, rc)``,
        ``spos`` each clause's stored position (-1: none), ``ab`` / ``rc``
        the operand codes of K2's entries (int32 on the tape's device);
        built at the first call on this TapeData or any copy of it
        (``replace_imms``) and kept."""
        if "plan" not in self._plan:
            from .vjp_plan import vjp_plan
            w = self.packed[:self.length].cpu().numpy().astype(
                np.int64) & 0xFFFFFFFF
            plan = vjp_plan(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF,
                            w >> 24, self.axis_slots, self.result_slot)
            ab, rc = plan.entry_codes()
            self._plan["plan"] = (plan,) + tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (plan.vpos.astype(np.int32), ab, rc))
        return self._plan["plan"]

    def scan_plan(self):
        """Kernel K2f's re-slotted walk (``ops/scan_plan.py``) and its
        planes on the tape's device: ``(sp, (order, entries))``; built at
        the first call on this TapeData or any copy of it and kept."""
        if "scan" not in self._plan:
            from .scan_plan import scan_plan
            sp = scan_plan(self.vjp_plan()[0])
            self._plan["scan"] = (sp, sp.planes(self.device))
        return self._plan["scan"]

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
        return upload([self.length, self.num_slots, self.result_slot,
                       *self.axis_slots, self.num_runs, 0], self.device,
                      torch.int32)
