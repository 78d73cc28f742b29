"""Render pipelines: the staged 2D and 3D interpreter renders, the brute
renderers they are checked against, and the work heatmaps."""

from .pipeline2d import render2d
from .pipeline3d import render3d
from .brute import render2d_brute, render3d_brute
from .heatmap import render2d_heatmap, render3d_heatmap
from . import camera

__all__ = ["render2d", "render3d", "render2d_brute", "render3d_brute",
           "render2d_heatmap", "render3d_heatmap", "camera"]
