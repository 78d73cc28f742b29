"""Shape standard library.

Replaces the libfive Scheme stdlib used by the reference GUI examples
(``reference/gui/examples/*.io``): CSG primitives, transforms, and the
paper's figure shapes.  Everything returns a plain :class:`Tree`, so users
compose shapes directly in Python instead of Guile Scheme
(``reference/gui/interpreter.cpp``).
"""

from __future__ import annotations

import math

from .tree import (Tree, x, y, z, const, minimum, maximum, sqrt, square,
                   sin, cos, atan)


# -- CSG ---------------------------------------------------------------------

def union(*shapes: Tree) -> Tree:
    out = shapes[0]
    for s in shapes[1:]:
        out = minimum(out, s)
    return out


def intersection(*shapes: Tree) -> Tree:
    out = shapes[0]
    for s in shapes[1:]:
        out = maximum(out, s)
    return out


def difference(a: Tree, b: Tree) -> Tree:
    return maximum(a, -b)


def inverse(a: Tree) -> Tree:
    return -a


def offset(a: Tree, o: float) -> Tree:
    return a - o


def blend(a: Tree, b: Tree, m: float) -> Tree:
    """Smooth union (libfive stdlib blend)."""
    return union(union(a, b), sqrt(abs(a)) + sqrt(abs(b)) - m)


# -- primitives ----------------------------------------------------------------

def circle(r: float, cx: float = 0.0, cy: float = 0.0) -> Tree:
    """The paper's running example (benchmark/circle.cpp:22-24 uses
    sqrt(x^2+y^2) - 1 scaled)."""
    return sqrt(square(x() - cx) + square(y() - cy)) - r


def sphere(r: float, cx: float = 0.0, cy: float = 0.0, cz: float = 0.0) -> Tree:
    return sqrt(square(x() - cx) + square(y() - cy) + square(z() - cz)) - r


def box(xmin: float, xmax: float, ymin: float, ymax: float,
        zmin: float = None, zmax: float = None) -> Tree:
    out = intersection(xmin - x(), x() - xmax, ymin - y(), y() - ymax)
    if zmin is not None:
        out = intersection(out, zmin - z(), z() - zmax)
    return out


def rectangle(xmin: float, xmax: float, ymin: float, ymax: float) -> Tree:
    return box(xmin, xmax, ymin, ymax)


def cylinder_z(r: float, zmin: float, zmax: float,
               cx: float = 0.0, cy: float = 0.0) -> Tree:
    return extrude_z(circle(r, cx, cy), zmin, zmax)


def torus_z(ro: float, ri: float) -> Tree:
    d = sqrt(square(x()) + square(y())) - ro
    return sqrt(square(d) + square(z())) - ri


def half_space_z(z0: float = 0.0) -> Tree:
    return z() - z0


def gyroid(period: float = 1.0, thickness: float = 0.1) -> Tree:
    s = 2.0 * math.pi / period
    g = (sin(x() * s) * cos(y() * s) + sin(y() * s) * cos(z() * s)
         + sin(z() * s) * cos(x() * s))
    return abs(g) - thickness


# -- transforms -----------------------------------------------------------------

def extrude_z(shape2d: Tree, zmin: float, zmax: float) -> Tree:
    return intersection(shape2d, zmin - z(), z() - zmax)


def move(shape: Tree, dx: float = 0.0, dy: float = 0.0, dz: float = 0.0) -> Tree:
    return shape.remap(x() - dx, y() - dy, z() - dz)


def scale(shape: Tree, sx: float, sy: float = None, sz: float = None) -> Tree:
    sy = sx if sy is None else sy
    sz = sx if sz is None else sz
    return shape.remap(x() / sx, y() / sy, z() / sz)


def _cos_sin(angle):
    """cos/sin of a float angle — or of a Tree angle (e.g. a named
    parameter, frontend var()), in which case the rotation itself
    becomes a differentiable function of the parameter."""
    if isinstance(angle, Tree):
        return cos(angle), sin(angle)
    return math.cos(angle), math.sin(angle)


def rotate_z(shape: Tree, angle: float) -> Tree:
    c, s = _cos_sin(angle)
    return shape.remap(c * x() + s * y(), -s * x() + c * y(), z())


def rotate_x(shape: Tree, angle: float) -> Tree:
    c, s = _cos_sin(angle)
    return shape.remap(x(), c * y() + s * z(), -s * y() + c * z())


def rotate_y(shape: Tree, angle: float) -> Tree:
    c, s = _cos_sin(angle)
    return shape.remap(c * x() - s * z(), y(), s * x() + c * z())


def reflect_x(shape: Tree) -> Tree:
    return shape.remap(-x(), y(), z())


# -- benchmark / demo shapes -------------------------------------------------

def two_spheres() -> Tree:
    """The baked-in shape of the reference's hand-compiled brute kernel
    (reference/benchmark/brute.cu:29-62): min of two spheres."""
    return union(sphere(0.8, -0.25, -0.25, -0.25),
                 sphere(0.7, 0.25, 0.25, 0.25))


def capped_sphere() -> Tree:
    """Sphere clipped by a half-space, as in render_effects' default shape
    (reference/benchmark/render_effects.cpp)."""
    return intersection(sphere(0.8), z() - 0.4)


def ring(ro: float = 0.9, ri: float = 0.5) -> Tree:
    """The print_tape_table shape (reference/benchmark/print_tape_table.cpp:44-51)."""
    d = sqrt(square(x()) + square(y()))
    return intersection(d - ro, ri - d)


def stress_2d(n_blobs: int = 1500, seed: int = 2020) -> Tree:
    """Long-tape 2D stress model (~7 clauses per blob): a deterministic
    pseudo-random field of circles and rotated squares, some warped by a
    sin ripple.  The analog of the reference's MISSING
    ``prospero_long.frep`` (reference/benchmark/tape_shortening.cpp:29
    references it; it was never shipped, leaving that benchmark broken) —
    a model well past prospero's tape length (n_blobs=1500 -> ~13.4k
    clauses vs prospero's 5.4k; scale n_blobs for more), for stressing
    the tape compiler, shortening statistics, and the engines'
    clause-count scaling.  Deterministic: same (n_blobs, seed) ->
    bit-identical tree."""
    import random
    rng = random.Random(seed)
    blobs = []
    for i in range(n_blobs):
        cx_ = rng.uniform(-0.95, 0.95)
        cy_ = rng.uniform(-0.95, 0.95)
        r = rng.uniform(0.004, 0.02)
        kind = rng.random()
        if kind < 0.6:
            blobs.append(circle(r, cx_, cy_))
        elif kind < 0.9:
            # rotate about the square's own center: rotate first, then
            # move (rotate_z(move(...)) would orbit it around the
            # origin, landing at R^-1(cx,cy) and pushing corner samples
            # outside the [-1,1] field)
            blobs.append(move(rotate_z(rectangle(-r, r, -r, r),
                                       rng.uniform(0, math.pi)), cx_, cy_))
        else:   # sin-rippled circle: exercises transcendentals
            d = sqrt(square(x() - cx_) + square(y() - cy_))
            blobs.append(d - r + sin(x() * rng.uniform(20.0, 60.0)) * (r / 4))
    # balanced union keeps the DAG shallow (liveness then needs O(log n)
    # slots, far under tape.SLOT_CAP)
    while len(blobs) > 1:
        blobs = [union(*blobs[i:i + 2]) for i in range(0, len(blobs), 2)]
    return blobs[0]


def menger(level: int = 2) -> Tree:
    """Menger-sponge-ish stress shape for 3D benchmarks."""
    shape = box(-1, 1, -1, 1, -1, 1)
    holes = []
    step = 2.0
    for lv in range(level):
        step /= 3.0
        n = int(round(1.0 / step))
        for i in range(-n, n + 1):
            for j in range(-n, n + 1):
                if (abs(i) % 3 == 1 and abs(j) % 3 == 1) or (i == 0 and j == 0):
                    cx_, cy_ = i * 3 * step, j * 3 * step
                    s = step
                    holes.append(box(cx_ - s, cx_ + s, cy_ - s, cy_ + s,
                                     -2, 2))
    out = shape
    for h in holes[:40]:
        out = difference(out, h)
    return out
