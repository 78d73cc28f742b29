"""Vector stroke font: native ``text`` shapes.

The reference's flagship scenes are text — ``prospero.io`` is a full page
of it and ``hello_world.io`` is extruded text intersected with a sphere
(``reference/gui/examples/``) — authored with the libfive Scheme
stdlib's vector font, which lives in the (not-checked-out) libfive
submodule.  This module is an original monoline stroke font with the same
role: ``text(s)`` returns a :class:`Tree` whose sign field draws the
string, so text scenes can be *authored* here (not just loaded from the
reference's pre-baked ``.frep`` archives), stay differentiable, and
compile to tapes like any other shape.

Glyphs are tables of stroke primitives on a unit em (baseline y=0, cap
height 1, x-height 0.62, descender -0.32):

* ``("s", x0, y0, x1, y1)`` — line stroke (capsule: exact distance to the
  segment minus the stroke radius);
* ``("a", cx, cy, r, a0, a1)`` — circular arc stroke from angle ``a0`` to
  ``a1`` (degrees, CCW; spans > 180 are split): the ring ``|d(c)-r|-w``
  clipped by the two end-cap half-planes through the center;
* ``("c", cx, cy, r)`` — full ring stroke;
* ``("d", cx, cy)`` — dot (filled circle, slightly fatter than the
  stroke).

Everything is emitted at absolute pen positions (no per-glyph remap), so
a page of text compiles to one flat min-tree of primitive strokes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from . import tree as _tree
from .tree import Tree

__all__ = ["text", "glyph", "have_glyph", "GLYPHS", "ADVANCE",
           "LINE_HEIGHT", "STROKE"]

STROKE = 0.05          # stroke radius (em)
DOT = 0.075            # dot radius
LINE_HEIGHT = 1.10     # baseline-to-baseline (libfive text steps ~1.1 em)
SPACE_ADV = 0.45
TRACKING = 0.10        # inter-glyph gap added to each glyph's ink width


def _seg(px, py, x0, y0, x1, y1, w):
    """Capsule: distance from (px,py) to the segment minus w."""
    ux, uy = x1 - x0, y1 - y0
    l2 = ux * ux + uy * uy
    if l2 < 1e-12:                      # degenerate: a dot
        return _tree.sqrt(_tree.square(px - x0) + _tree.square(py - y0)) - w
    vx, vy = px - x0, py - y0
    t = _tree.maximum(0.0, _tree.minimum(1.0, (vx * ux + vy * uy) / l2))
    dx, dy = vx - t * ux, vy - t * uy
    return _tree.sqrt(_tree.square(dx) + _tree.square(dy)) - w


def _ring(px, py, cx, cy, r, w):
    d = _tree.sqrt(_tree.square(px - cx) + _tree.square(py - cy))
    return abs(d - r) - w


def _arc(px, py, cx, cy, r, a0, a1, w):
    """Ring stroke clipped to the CCW angular range [a0, a1] (degrees).
    For spans <= 180 the range is the intersection of the two end-cap
    half-planes through the center (flat radial caps); larger spans
    split recursively."""
    span = a1 - a0
    if span >= 360.0 - 1e-9:
        return _ring(px, py, cx, cy, r, w)
    if span > 180.0:
        mid = a0 + span / 2.0
        return _tree.minimum(_arc(px, py, cx, cy, r, a0, mid, w),
                             _arc(px, py, cx, cy, r, mid, a1, w))
    ring = _ring(px, py, cx, cy, r, w)
    vx, vy = px - cx, py - cy
    r0, r1 = math.radians(a0), math.radians(a1)
    # cross(dir(a), v) = |v| sin(theta - a): >=0 for theta in [a0, a0+180]
    c0 = math.cos(r0) * vy - math.sin(r0) * vx
    c1 = math.cos(r1) * vy - math.sin(r1) * vx
    return _tree.maximum(ring, _tree.maximum(-c0, c1))


def _dot(px, py, cx, cy):
    return _tree.sqrt(_tree.square(px - cx) + _tree.square(py - cy)) - DOT


# ---------------------------------------------------------------------------
# glyph tables: name -> (width, [primitives])
# ---------------------------------------------------------------------------

GLYPHS: Dict[str, Tuple[float, List[tuple]]] = {
    # -- uppercase (cap height 1.0) ----------------------------------------
    "A": (0.60, [("s", 0, 0, 0.30, 1), ("s", 0.30, 1, 0.60, 0),
                 ("s", 0.11, 0.35, 0.49, 0.35)]),
    "B": (0.58, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.33, 1),
                 ("s", 0, 0.55, 0.33, 0.55), ("s", 0, 0, 0.33, 0),
                 ("a", 0.33, 0.775, 0.225, -90, 90),
                 ("a", 0.33, 0.275, 0.275, -90, 90)]),
    "C": (0.66, [("a", 0.35, 0.5, 0.35, 40, 320)]),
    "D": (0.70, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.22, 1),
                 ("s", 0, 0, 0.22, 0), ("a", 0.22, 0.5, 0.5, -90, 90)]),
    "E": (0.55, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.55, 1),
                 ("s", 0, 0.55, 0.45, 0.55), ("s", 0, 0, 0.55, 0)]),
    "F": (0.55, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.55, 1),
                 ("s", 0, 0.55, 0.45, 0.55)]),
    "G": (0.70, [("a", 0.35, 0.5, 0.35, 45, 315),
                 ("s", 0.597, 0.253, 0.597, 0.5),
                 ("s", 0.597, 0.5, 0.38, 0.5)]),
    "H": (0.60, [("s", 0, 0, 0, 1), ("s", 0.6, 0, 0.6, 1),
                 ("s", 0, 0.5, 0.6, 0.5)]),
    "I": (0.24, [("s", 0.12, 0, 0.12, 1), ("s", 0, 1, 0.24, 1),
                 ("s", 0, 0, 0.24, 0)]),
    "J": (0.50, [("s", 0.45, 1, 0.45, 0.25),
                 ("a", 0.25, 0.25, 0.20, 180, 360)]),
    "K": (0.58, [("s", 0, 0, 0, 1), ("s", 0, 0.45, 0.55, 1),
                 ("s", 0.18, 0.58, 0.55, 0)]),
    "L": (0.50, [("s", 0, 1, 0, 0), ("s", 0, 0, 0.5, 0)]),
    "M": (0.66, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.33, 0.35),
                 ("s", 0.33, 0.35, 0.66, 1), ("s", 0.66, 1, 0.66, 0)]),
    "N": (0.60, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.6, 0),
                 ("s", 0.6, 0, 0.6, 1)]),
    "O": (0.60, [("a", 0.30, 0.70, 0.30, 0, 180),
                 ("a", 0.30, 0.30, 0.30, 180, 360),
                 ("s", 0, 0.30, 0, 0.70), ("s", 0.6, 0.30, 0.6, 0.70)]),
    "P": (0.58, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.33, 1),
                 ("s", 0, 0.5, 0.33, 0.5),
                 ("a", 0.33, 0.75, 0.25, -90, 90)]),
    "Q": (0.60, [("a", 0.30, 0.70, 0.30, 0, 180),
                 ("a", 0.30, 0.30, 0.30, 180, 360),
                 ("s", 0, 0.30, 0, 0.70), ("s", 0.6, 0.30, 0.6, 0.70),
                 ("s", 0.38, 0.22, 0.62, -0.05)]),
    "R": (0.58, [("s", 0, 0, 0, 1), ("s", 0, 1, 0.33, 1),
                 ("s", 0, 0.5, 0.33, 0.5),
                 ("a", 0.33, 0.75, 0.25, -90, 90),
                 ("s", 0.20, 0.5, 0.55, 0)]),
    "S": (0.60, [("a", 0.30, 0.725, 0.275, 60, 270),
                 ("a", 0.30, 0.275, 0.275, -120, 90)]),
    "T": (0.60, [("s", 0.30, 0, 0.30, 1), ("s", 0, 1, 0.6, 1)]),
    "U": (0.60, [("s", 0, 1, 0, 0.28), ("s", 0.6, 1, 0.6, 0.28),
                 ("a", 0.30, 0.28, 0.30, 180, 360)]),
    "V": (0.60, [("s", 0, 1, 0.30, 0), ("s", 0.30, 0, 0.6, 1)]),
    "W": (0.68, [("s", 0, 1, 0.16, 0), ("s", 0.16, 0, 0.34, 0.70),
                 ("s", 0.34, 0.70, 0.52, 0), ("s", 0.52, 0, 0.68, 1)]),
    "X": (0.60, [("s", 0, 0, 0.6, 1), ("s", 0, 1, 0.6, 0)]),
    "Y": (0.60, [("s", 0, 1, 0.30, 0.45), ("s", 0.6, 1, 0.30, 0.45),
                 ("s", 0.30, 0.45, 0.30, 0)]),
    "Z": (0.60, [("s", 0, 1, 0.6, 1), ("s", 0.6, 1, 0, 0),
                 ("s", 0, 0, 0.6, 0)]),
    # -- lowercase (x-height 0.62) ------------------------------------------
    "a": (0.54, [("c", 0.26, 0.31, 0.26), ("s", 0.52, 0.62, 0.52, 0)]),
    "b": (0.54, [("s", 0, 0, 0, 1), ("c", 0.27, 0.29, 0.26)]),
    "c": (0.54, [("a", 0.28, 0.31, 0.28, 45, 315)]),
    "d": (0.54, [("s", 0.52, 0, 0.52, 1), ("c", 0.25, 0.29, 0.26)]),
    "e": (0.54, [("s", 0, 0.33, 0.54, 0.33),
                 ("a", 0.27, 0.31, 0.27, 4, 315)]),
    "f": (0.50, [("a", 0.48, 0.80, 0.18, 90, 180),
                 ("s", 0.30, 0.80, 0.30, 0),
                 ("s", 0.08, 0.62, 0.50, 0.62)]),
    "g": (0.54, [("c", 0.26, 0.31, 0.26), ("s", 0.52, 0.62, 0.52, -0.10),
                 ("a", 0.32, -0.10, 0.20, 180, 360)]),
    "h": (0.52, [("s", 0, 0, 0, 1), ("a", 0.26, 0.36, 0.26, 0, 180),
                 ("s", 0.52, 0.36, 0.52, 0)]),
    "i": (0.18, [("s", 0.09, 0, 0.09, 0.62), ("d", 0.09, 0.90)]),
    "j": (0.32, [("s", 0.22, 0.62, 0.22, -0.12),
                 ("a", 0.02, -0.12, 0.20, 270, 360), ("d", 0.22, 0.90)]),
    "k": (0.50, [("s", 0, 0, 0, 1), ("s", 0, 0.28, 0.44, 0.62),
                 ("s", 0.16, 0.40, 0.48, 0)]),
    "l": (0.18, [("s", 0.09, 0, 0.09, 1)]),
    "m": (0.74, [("s", 0, 0, 0, 0.62), ("a", 0.18, 0.44, 0.18, 0, 180),
                 ("s", 0.36, 0.44, 0.36, 0),
                 ("a", 0.55, 0.44, 0.18, 0, 180),
                 ("s", 0.73, 0.44, 0.73, 0)]),
    "n": (0.52, [("s", 0, 0, 0, 0.62), ("a", 0.26, 0.36, 0.26, 0, 180),
                 ("s", 0.52, 0.36, 0.52, 0)]),
    "o": (0.54, [("c", 0.27, 0.31, 0.27)]),
    "p": (0.54, [("s", 0, 0.62, 0, -0.32), ("c", 0.27, 0.29, 0.26)]),
    "q": (0.54, [("s", 0.52, 0.62, 0.52, -0.32),
                 ("c", 0.25, 0.29, 0.26)]),
    "r": (0.46, [("s", 0, 0, 0, 0.62), ("a", 0.24, 0.38, 0.24, 30, 180)]),
    "s": (0.48, [("a", 0.24, 0.465, 0.155, 60, 270),
                 ("a", 0.24, 0.155, 0.155, -120, 90)]),
    "t": (0.46, [("s", 0.22, 0.95, 0.22, 0.18),
                 ("a", 0.40, 0.18, 0.18, 180, 270),
                 ("s", 0, 0.62, 0.44, 0.62)]),
    "u": (0.52, [("s", 0, 0.62, 0, 0.26),
                 ("a", 0.26, 0.26, 0.26, 180, 360),
                 ("s", 0.52, 0.62, 0.52, 0)]),
    "v": (0.52, [("s", 0, 0.62, 0.26, 0), ("s", 0.26, 0, 0.52, 0.62)]),
    "w": (0.64, [("s", 0, 0.62, 0.15, 0), ("s", 0.15, 0, 0.32, 0.50),
                 ("s", 0.32, 0.50, 0.49, 0), ("s", 0.49, 0, 0.64, 0.62)]),
    "x": (0.52, [("s", 0, 0, 0.52, 0.62), ("s", 0, 0.62, 0.52, 0)]),
    "y": (0.52, [("s", 0, 0.62, 0.26, 0), ("s", 0.52, 0.62, 0.12, -0.32)]),
    "z": (0.52, [("s", 0, 0.62, 0.52, 0.62), ("s", 0.52, 0.62, 0, 0),
                 ("s", 0, 0, 0.52, 0)]),
    # -- digits (height 1.0) --------------------------------------------------
    "0": (0.55, [("a", 0.275, 0.70, 0.275, 0, 180),
                 ("a", 0.275, 0.30, 0.275, 180, 360),
                 ("s", 0, 0.30, 0, 0.70), ("s", 0.55, 0.30, 0.55, 0.70)]),
    "1": (0.50, [("s", 0.30, 0, 0.30, 1), ("s", 0.12, 0.80, 0.30, 1),
                 ("s", 0.10, 0, 0.50, 0)]),
    "2": (0.55, [("a", 0.275, 0.725, 0.275, 0, 180),
                 ("s", 0.55, 0.725, 0, 0), ("s", 0, 0, 0.55, 0)]),
    "3": (0.52, [("a", 0.26, 0.71, 0.21, -90, 135),
                 ("a", 0.26, 0.29, 0.21, -135, 90)]),
    "4": (0.55, [("s", 0.42, 1, 0, 0.30), ("s", 0, 0.30, 0.55, 0.30),
                 ("s", 0.42, 0.62, 0.42, 0)]),
    "5": (0.54, [("s", 0.50, 1, 0.08, 1), ("s", 0.08, 1, 0.06, 0.58),
                 ("a", 0.25, 0.31, 0.29, -120, 120)]),
    "6": (0.54, [("a", 0.62, 0.42, 0.58, 125, 175),
                 ("c", 0.26, 0.24, 0.24)]),
    "7": (0.55, [("s", 0, 1, 0.55, 1), ("s", 0.55, 1, 0.16, 0)]),
    "8": (0.54, [("c", 0.27, 0.76, 0.22), ("c", 0.27, 0.28, 0.28)]),
    "9": (0.55, [("c", 0.27, 0.74, 0.24), ("s", 0.51, 0.74, 0.51, 0.30),
                 ("a", 0.31, 0.30, 0.20, 270, 360)]),
    # -- punctuation -----------------------------------------------------------
    ".": (0.20, [("d", 0.10, 0.02)]),
    ",": (0.20, [("d", 0.10, 0.04), ("s", 0.10, 0.02, 0.00, -0.24)]),
    "'": (0.14, [("s", 0.09, 0.82, 0.05, 1.04)]),
    "’": (0.14, [("s", 0.09, 0.82, 0.05, 1.04)]),
    '"': (0.30, [("s", 0.07, 0.82, 0.03, 1.04),
                 ("s", 0.25, 0.82, 0.21, 1.04)]),
    "-": (0.40, [("s", 0, 0.40, 0.40, 0.40)]),
    "+": (0.44, [("s", 0.22, 0.18, 0.22, 0.62), ("s", 0, 0.40, 0.44, 0.40)]),
    "=": (0.44, [("s", 0, 0.28, 0.44, 0.28), ("s", 0, 0.52, 0.44, 0.52)]),
    "_": (0.50, [("s", 0, -0.18, 0.50, -0.18)]),
    ":": (0.20, [("d", 0.10, 0.02), ("d", 0.10, 0.52)]),
    ";": (0.20, [("d", 0.10, 0.52), ("d", 0.10, 0.04),
                 ("s", 0.10, 0.02, 0.00, -0.24)]),
    "!": (0.14, [("s", 0.07, 0.30, 0.07, 1.0), ("d", 0.07, 0.02)]),
    "?": (0.50, [("a", 0.25, 0.76, 0.22, -90, 180),
                 ("s", 0.25, 0.54, 0.25, 0.30), ("d", 0.25, 0.02)]),
    "(": (0.26, [("a", 0.50, 0.40, 0.62, 128, 232)]),
    ")": (0.26, [("a", -0.24, 0.40, 0.62, -52, 52)]),
    "[": (0.26, [("s", 0.06, -0.12, 0.06, 1.0), ("s", 0.06, 1.0, 0.26, 1.0),
                 ("s", 0.06, -0.12, 0.26, -0.12)]),
    "]": (0.26, [("s", 0.20, -0.12, 0.20, 1.0), ("s", 0.0, 1.0, 0.20, 1.0),
                 ("s", 0.0, -0.12, 0.20, -0.12)]),
    "/": (0.44, [("s", 0, -0.10, 0.44, 1.0)]),
    "\\": (0.44, [("s", 0, 1.0, 0.44, -0.10)]),
    "*": (0.40, [("s", 0.20, 0.40, 0.20, 0.80), ("s", 0.03, 0.50, 0.37, 0.70),
                 ("s", 0.03, 0.70, 0.37, 0.50)]),
    "<": (0.44, [("s", 0.44, 0.10, 0, 0.40), ("s", 0, 0.40, 0.44, 0.70)]),
    ">": (0.44, [("s", 0, 0.10, 0.44, 0.40), ("s", 0.44, 0.40, 0, 0.70)]),
    "|": (0.14, [("s", 0.07, -0.20, 0.07, 1.0)]),
    "%": (0.60, [("c", 0.12, 0.80, 0.12), ("c", 0.48, 0.20, 0.12),
                 ("s", 0.05, 0, 0.55, 1)]),
    "#": (0.55, [("s", 0.16, 0, 0.24, 1), ("s", 0.31, 0, 0.39, 1),
                 ("s", 0.02, 0.35, 0.53, 0.35),
                 ("s", 0.02, 0.65, 0.53, 0.65)]),
    "&": (0.60, [("c", 0.26, 0.74, 0.17),
                 ("a", 0.26, 0.28, 0.28, -60, 200),
                 ("s", 0.30, 0.52, 0.60, 0.05)]),
    "@": (0.72, [("a", 0.36, 0.45, 0.34, 10, 330),
                 ("c", 0.36, 0.45, 0.13),
                 ("s", 0.49, 0.45, 0.49, 0.34),
                 ("s", 0.49, 0.34, 0.66, 0.34)]),
    "$": (0.54, [("a", 0.27, 0.665, 0.235, 60, 270),
                 ("a", 0.27, 0.235, 0.235, -120, 90),
                 ("s", 0.27, -0.08, 0.27, 0.98)]),
    "^": (0.44, [("s", 0.02, 0.62, 0.22, 1.0), ("s", 0.22, 1.0, 0.42, 0.62)]),
    "~": (0.50, [("a", 0.13, 0.36, 0.12, 10, 170),
                 ("a", 0.37, 0.44, 0.12, 190, 350)]),
    "`": (0.14, [("s", 0.02, 1.04, 0.10, 0.82)]),
    "{": (0.30, [("a", 0.30, 0.82, 0.15, 90, 180),
                 ("s", 0.15, 0.82, 0.15, 0.55),
                 ("a", 0.0, 0.55, 0.15, 0, 90),
                 ("a", 0.0, 0.33, 0.15, 270, 360),
                 ("s", 0.15, 0.33, 0.15, 0.06),
                 ("a", 0.30, 0.06, 0.15, 180, 270)]),
    "}": (0.30, [("a", 0.0, 0.82, 0.15, 0, 90),
                 ("s", 0.15, 0.82, 0.15, 0.55),
                 ("a", 0.30, 0.55, 0.15, 90, 180),
                 ("a", 0.30, 0.33, 0.15, 180, 270),
                 ("s", 0.15, 0.33, 0.15, 0.06),
                 ("a", 0.0, 0.06, 0.15, 270, 360)]),
}


def have_glyph(ch: str) -> bool:
    return ch in GLYPHS or ch == " "


def glyph(ch: str, px, py, x0: float = 0.0, y0: float = 0.0) -> Tree:
    """One glyph's stroke field over coordinate trees ``(px, py)``, with
    its origin (left side of baseline) at ``(x0, y0)``."""
    width, prims = GLYPHS[ch]
    parts = []
    for p in prims:
        if p[0] == "s":
            _, ax, ay, bx, by = p
            parts.append(_seg(px, py, x0 + ax, y0 + ay, x0 + bx, y0 + by,
                              STROKE))
        elif p[0] == "a":
            _, cx, cy, r, a0, a1 = p
            parts.append(_arc(px, py, x0 + cx, y0 + cy, r, a0, a1, STROKE))
        elif p[0] == "c":
            _, cx, cy, r = p
            parts.append(_ring(px, py, x0 + cx, y0 + cy, r, STROKE))
        elif p[0] == "d":
            _, cx, cy = p
            parts.append(_dot(px, py, x0 + cx, y0 + cy))
        else:                               # pragma: no cover
            raise ValueError(f"unknown primitive {p[0]!r}")
    out = parts[0]
    for s in parts[1:]:
        out = _tree.minimum(out, s)
    return out


def text(s: str, x0: float = 0.0, y0: float = 0.0) -> Tree:
    """A text block as one implicit shape.  ``(x0, y0)`` is the left end
    of the first line's baseline; lines advance downward by
    ``LINE_HEIGHT`` em (the libfive-stdlib ``text`` contract the examples
    assume: glyphs are ~1 em tall and the block grows down and right).
    Unknown characters render as a small box so missing-glyph bugs are
    visible rather than silent."""
    pen_x, pen_y = x0, y0
    parts: List[Tree] = []
    for ch in s:
        if ch == "\n":
            pen_x = x0
            pen_y -= LINE_HEIGHT
            continue
        if ch == " ":
            pen_x += SPACE_ADV
            continue
        if ch == "\t":
            pen_x += 4 * SPACE_ADV
            continue
        entry = GLYPHS.get(ch)
        if entry is None:                   # visible missing-glyph box
            parts.append(_seg(_tree.x(), _tree.y(), pen_x + 0.08,
                              pen_y + 0.3, pen_x + 0.42, pen_y + 0.3,
                              0.22))
            pen_x += 0.50 + TRACKING
            continue
        parts.append(glyph(ch, _tree.x(), _tree.y(), pen_x, pen_y))
        pen_x += entry[0] + TRACKING
    if not parts:
        return _tree.const(1.0)             # empty text: nothing filled
    out = parts[0]
    for s_ in parts[1:]:
        out = _tree.minimum(out, s_)
    return out
