"""Frame timing for the command line's tables.

Counterpart of ``mpr_tpu.utils.timing.time_frames``, with the protocol of
the reference's benchmarks (warm-up, then the mean of timed runs,
benchmark/stats.cpp:19-47).  On a CUDA device the frames are enqueued back
to back between two CUDA events and the device time between the events is
divided by the frame count, so launch overhead that the device hides stays
hidden and host stalls that starve it are counted, as a user sees them.
On the CPU the host clock times the same loop.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def time_frames(frame: Callable, *args, n: int = 50, n0: int = 5) -> float:
    """Mean ms per ``frame(*args)`` over ``n`` runs after ``n0`` warm-up
    runs.  The device is that of the first tensor among ``args``; frames
    without a tensor argument are timed on the host clock."""
    dev = _device_of(args)
    for _ in range(n0):
        frame(*args)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            frame(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        frame(*args)
    return (time.perf_counter() - t0) / n * 1e3
