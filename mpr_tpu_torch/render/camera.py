"""Camera / transform helpers.

Conventions copied from the reference: render space is orthographic,
screen-aligned, +/-1 on each axis; a pixel (px, py) of an NxN image has
center ``((p + 0.5)/N - 0.5) * 2`` (reference/src/context.cu:734-736).
2D uses a homogeneous 3x3 matrix with projective divide
(reference/src/context.cu:796-799); 3D a 4x4
(reference/src/context.cu:739-747).  The benchmark tables use the
identity (2D, render_2d_table.cpp:54) and identity + T[3,2]=0.3 perspective
(3D, render_3d_table.cpp:48-49).
"""

from __future__ import annotations

import math

import numpy as np


def identity2() -> np.ndarray:
    return np.eye(3, dtype=np.float32)


def identity3() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def bench3d_view() -> np.ndarray:
    """The 3D benchmark's slightly-perspective view
    (reference/benchmark/render_3d_table.cpp:48-49)."""
    m = np.eye(4, dtype=np.float32)
    m[3, 2] = 0.3
    return m


def scale2(s: float) -> np.ndarray:
    m = np.eye(3, dtype=np.float32)
    m[0, 0] = m[1, 1] = s
    return m


def rot_z4(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rot_x4(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def gui3d_view(yaw: float = 0.7, pitch: float = -1.0,
               perspective: float = 0.3) -> np.ndarray:
    """A pleasant default 3D view akin to the reference GUI's orbit camera
    (reference/gui/main.cpp:117-137)."""
    m = rot_x4(pitch) @ rot_z4(yaw)
    m[3, 2] = perspective
    return m.astype(np.float32)


def pixel_centers(size: int) -> np.ndarray:
    """1-D array of pixel-center coordinates in [-1, 1]."""
    p = (np.arange(size, dtype=np.float32) + 0.5) / size
    return (p - 0.5) * 2.0


def transform2(mat: np.ndarray, fx, fy, xp=np):
    """Apply a homogeneous 3x3 to broadcastable fx/fy arrays."""
    w = mat[2, 0] * fx + mat[2, 1] * fy + mat[2, 2]
    x = (mat[0, 0] * fx + mat[0, 1] * fy + mat[0, 2]) / w
    y = (mat[1, 0] * fx + mat[1, 1] * fy + mat[1, 2]) / w
    return x, y


def transform3(mat: np.ndarray, fx, fy, fz, xp=np):
    """Apply a homogeneous 4x4 to broadcastable fx/fy/fz arrays."""
    w = mat[3, 0] * fx + mat[3, 1] * fy + mat[3, 2] * fz + mat[3, 3]
    x = (mat[0, 0] * fx + mat[0, 1] * fy + mat[0, 2] * fz + mat[0, 3]) / w
    y = (mat[1, 0] * fx + mat[1, 1] * fy + mat[1, 2] * fz + mat[1, 3]) / w
    z = (mat[2, 0] * fx + mat[2, 1] * fy + mat[2, 2] * fz + mat[2, 3]) / w
    return x, y, z
