"""The gyroid lattice clipped to a sphere of ``examples/gyroid_demo.py``.

A frozen copy, written on ``portbench.expr``, of
``intersection(gyroid(period, thickness), sphere(radius))`` as the port's
``frontend/shapes.py`` builds it.
"""

from __future__ import annotations

import math

from ..expr import cos, intersection, sin, sqrt, square, x, y, z


def build(period: float = 0.4, thickness: float = 0.08,
          radius: float = 0.85):
    s = 2.0 * math.pi / period
    g = (sin(x() * s) * cos(y() * s) + sin(y() * s) * cos(z() * s)
         + sin(z() * s) * cos(x() * s))
    sphere = sqrt(square(x()) + square(y()) + square(z())) - radius
    return intersection(abs(g) - thickness, sphere)
