"""Typed runtime configuration.

The reference's knobs are compile-time ``#define``s
(NUM_TILES/NUM_THREADS/SUBTAPE_CHUNK_SIZE/NUM_SUBTAPES,
reference/inc/parameters.hpp:14-22) plus CMake options.  Here the
settings live in one dataclass, read at call time.  A copy of
``mpr_tpu.config`` holding the fields the port reads so far (the 2D
interpreter pipeline reads only ``widen_intervals``); later slices add the
others as they port the code that reads them.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager


@dataclasses.dataclass(frozen=True)
class Config:
    # True applies conservative outward widening (>= 1 ulp per interval
    # op, interval_math.widen) in kernel A.  Closes the documented
    # divergence from the reference's directed-rounding intrinsics
    # (reference/inc/gpu_interval.hpp:18-43 __fadd_rd/__fadd_ru):
    # round-to-nearest endpoints can under-cover by ~1 ulp/op; widened
    # endpoints cannot.  Cost: slightly looser boxes -> marginally more
    # ambiguous tiles.
    widen_intervals: bool = False


_active = Config()


def get() -> Config:
    return _active


def set_config(cfg: Config) -> None:
    global _active
    _active = cfg


@contextmanager
def override(**kwargs):
    """Temporarily override config fields:
    ``with config.override(widen_intervals=True): render2d(...)``."""
    global _active
    old = _active
    _active = dataclasses.replace(old, **kwargs)
    try:
        yield _active
    finally:
        _active = old
