"""Typed runtime configuration.

The reference's knobs are compile-time ``#define``s
(NUM_TILES/NUM_THREADS/SUBTAPE_CHUNK_SIZE/NUM_SUBTAPES,
reference/inc/parameters.hpp:14-22) plus CMake options.  Here the
settings live in one dataclass, read at call time.  A copy of
``mpr_tpu.config`` holding the fields the port reads so far (the 2D
pipeline reads ``widen_intervals``, the 3D pipeline also ``cap_div``,
the effects ``ssao_mode`` and ``ao_scale``, the oracle and the unrolled
evaluators ``tight_sincos``, the unrolled evaluators also
``fast_transcendentals``); later slices add the others as they port the
code that reads them.  ``compile_effort`` (XLA's optimisation effort for
the unrolled engine's per-shape compiles) has no nvcc counterpart and is
left out: the generated kernels always build at ``ops/unrolled_eval.py``'s
``PTXAS_O``.  The
3D stage capacities of ``mpr_tpu.config`` (``p0_scale``, ``c1_scale``) and
its batching factors (``cpi``, ``tpi``) have no counterpart: the port
sizes each 3D stage from counts read back from the device and its kernels
take one cell or tile per block.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager


@dataclasses.dataclass(frozen=True)
class Config:
    # 3D pipeline: per-cell (and per-column) shortened-tape capacity =
    # tape capacity // cap_div.  Blobby 3D models barely shorten, and a
    # cell whose tape overflows falls back to the full tape.
    cap_div: int = 2
    # True applies conservative outward widening (>= 1 ulp per interval
    # op, interval_math.widen) in kernel A.  Closes the documented
    # divergence from the reference's directed-rounding intrinsics
    # (reference/inc/gpu_interval.hpp:18-43 __fadd_rd/__fadd_ru):
    # round-to-nearest endpoints can under-cover by ~1 ulp/op; widened
    # endpoints cannot.  Cost: slightly looser boxes -> marginally more
    # ambiguous tiles.
    widen_intervals: bool = False
    # True gives the oracle's interval sin/cos their tight monotone-piece
    # bounds instead of the reference's always-[-1, 1] quirk.
    tight_sincos: bool = False
    # True routes asin/acos/atan in the unrolled evaluators
    # (ops/unrolled_eval.py) through the Cephes polynomial forms
    # (ops/transcendental.py, ~2 ulp f32) that the interpreter kernels
    # use, instead of the math library's.
    fast_transcendentals: bool = False
    # -- SSAO (render/effects.py) ---------------------------------------------
    # "static": gather-free sphere-sampling AO: per-sample screen offsets
    # are constants, so every depth lookup is a shifted-image read.
    # "gather": the reference's exact per-pixel TBN-rotated hemisphere
    # mechanism (reference/src/effects.cu:17-89), for mechanism parity.
    ssao_mode: str = "static"
    # Raw-AO downsample factor before the full-res edge-aware blur.
    # 0 = auto: 1 (full-res) for static mode and small images; 2 for
    # gather mode at >= 512^2.
    ao_scale: int = 0


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
