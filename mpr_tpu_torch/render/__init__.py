"""Render pipelines: the staged 2D and 3D interpreter renders, the
unrolled engine (``unrolled``: the same ladders on kernels generated for
the tape, and its work maps in ``workmap``), the brute renderers they are
checked against, the work heatmaps, and the SSAO and shading effects."""

from .pipeline2d import render2d
from .pipeline3d import render3d
from .brute import render2d_brute, render3d_brute, build_unrolled_f
from .heatmap import render2d_heatmap, render3d_heatmap
from .effects import draw_ssao, draw_shaded
from . import camera, effects, unrolled, workmap

__all__ = ["render2d", "render3d", "render2d_brute", "render3d_brute",
           "render2d_heatmap", "render3d_heatmap", "draw_ssao",
           "draw_shaded", "build_unrolled_f", "camera", "effects",
           "unrolled", "workmap"]
