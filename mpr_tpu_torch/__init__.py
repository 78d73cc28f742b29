"""mpr_tpu_torch: the mpr_tpu renderer ported to PyTorch and CUDA on an
NVIDIA H100 (Hopper).

A second package beside ``mpr_tpu`` (JAX on a TPU), which stays the
reference the port is tested against.  The port imports neither JAX nor
anything of ``mpr_tpu``: it keeps its own copies of the JAX-free layers.

Layers (bottom-up):

  frontend/  expression DSL (hash-consed trees), .frep archive I/O, shape
             lib, the Scheme (.io) and vector-font frontends
  tape/      tape compiler: Tree -> flat register program (struct-of-arrays),
             and the decompiler back to a Tree
  oracle.py  pure-NumPy reference interpreters (float / interval / deriv)
  ops/       device tape, CUDA kernels (csrc/) with their plain PyTorch
             versions, the plain tape interpreters, the evaluators
             generated per tape (and their backward kernels), the nvcc
             build
  render/    the staged 2D and 3D interpreter render pipelines, the
             unrolled engine, the brute renderers, the work heatmaps,
             SSAO and shading
  parallel/  sharded renders and fit steps over torch.distributed
  io/        PNG output, tape checkpoints, mesh export (STL / OBJ)
  utils/     frame timing
  cli.py     the command line (``python -m mpr_tpu_torch.cli``)

Entry points run on ``cuda`` unless the caller passes ``device=...``.
"""

from .frontend import tree
from .frontend.tree import Tree, x, y, z, const, minimum, maximum, sqrt, square
from .frontend import frep
from .tape.tape import Tape, compile_tree
from .tape.opcodes import Op
from .render import (render2d, render3d, render2d_brute, render3d_brute,
                     render2d_heatmap, render3d_heatmap, draw_ssao,
                     draw_shaded)

__version__ = "0.1.0"
