"""The general generators: each runs one kind of traffic, named by a
traffic file's ``driver`` and shaped by its parameters.  ``run(run)``
sets up the system under test from the seed, warms up the cell's shapes,
measures the window, frees the program's state and compares what the
timed path produced with the reference; it returns a ``core.Outcome``."""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (0: warm-up, 1: the
    window, 2: which results are checked)."""
    return np.random.default_rng([int(seed), stream])


def view(config: dict, n: int) -> np.ndarray:
    """The configuration's ``view``: an ``n`` x ``n`` float32 matrix (3 a
    2D view, 4 a 3D one)."""
    m = np.asarray(config["view"], dtype=np.float32)
    if m.shape != (n, n):
        raise ValueError(f"view: shape {m.shape}, want {(n, n)}")
    return m


def checked(seed: int, expected: int, k: int) -> set:
    """Indices of the ``k`` results the comparison keeps, spread evenly
    over the ``expected`` ones of a window at a seeded offset."""
    stride = max(1, int(expected) // max(1, k))
    first = int(rng(seed, 2).integers(stride))
    return {first + j * stride for j in range(k)}


def memory_peak(device) -> int:
    import torch
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Return the program's freed memory to the device before the
    reference runs."""
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_second(stamps, t0: float, window: float) -> list:
    """Results completed in each whole second of the window, from their
    host-clock completion times ``stamps``."""
    n = int(window) or 1
    out = [0] * n
    for t in stamps:
        k = int(t - t0)
        if 0 <= k < n:
            out[k] += 1
    return out


def warm_until(traffic, started: float, done: int) -> bool:
    """Whether warm-up goes on after ``done`` results: until both
    ``warmup_frames`` results and ``warmup_seconds`` have passed."""
    import time
    return (done < int(traffic["warmup_frames"])
            or time.perf_counter() - started
            < float(traffic.get("warmup_seconds", 0.0)))
