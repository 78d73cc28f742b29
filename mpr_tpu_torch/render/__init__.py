"""Render pipelines: the staged 2D interpreter render."""

from .pipeline2d import render2d
from . import camera

__all__ = ["render2d", "camera"]
