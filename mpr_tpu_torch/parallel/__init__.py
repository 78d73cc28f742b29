"""Sharded rendering and fitting over a ``torch.distributed`` process
group: meshes, the sharded renders, the sharded fit steps."""

from .sharded import make_fit_step, make_mesh, render2d_sharded

__all__ = ["make_mesh", "render2d_sharded", "make_fit_step"]
