"""The long-tape 2D model the repository uses as prospero's stand-in.

A frozen copy, written on ``portbench.expr``, of the port's
``frontend/shapes.py::stress_2d`` and of the shapes it calls (circle,
rectangle, rotate_z, move): a pseudo-random field of circles, rotated
squares and sin-rippled circles, joined by a balanced union.  The same
``(n_blobs, seed)`` gives the same expression.
"""

from __future__ import annotations

import math
import random

from ..expr import intersection, minimum, sin, sqrt, square, x, y, z


def circle(r, cx, cy):
    return sqrt(square(x() - cx) + square(y() - cy)) - r


def rectangle(xmin, xmax, ymin, ymax):
    return intersection(xmin - x(), x() - xmax, ymin - y(), y() - ymax)


def rotate_z(shape, angle):
    c, s = math.cos(angle), math.sin(angle)
    return shape.remap(c * x() + s * y(), -s * x() + c * y(), z())


def move(shape, dx, dy):
    return shape.remap(x() - dx, y() - dy, z())


def build(n_blobs: int = 1500, seed: int = 2020):
    rng = random.Random(seed)
    blobs = []
    for _ in range(n_blobs):
        cx = rng.uniform(-0.95, 0.95)
        cy = rng.uniform(-0.95, 0.95)
        r = rng.uniform(0.004, 0.02)
        kind = rng.random()
        if kind < 0.6:
            blobs.append(circle(r, cx, cy))
        elif kind < 0.9:
            blobs.append(move(rotate_z(rectangle(-r, r, -r, r),
                                       rng.uniform(0, math.pi)), cx, cy))
        else:
            d = sqrt(square(x() - cx) + square(y() - cy))
            blobs.append(d - r + sin(x() * rng.uniform(20.0, 60.0)) * (r / 4))
    while len(blobs) > 1:
        blobs = [blobs[i] if i + 1 == len(blobs)
                 else minimum(blobs[i], blobs[i + 1])
                 for i in range(0, len(blobs), 2)]
    return blobs[0]
