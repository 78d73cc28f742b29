"""The plain reference: the benchmark's own expression of a scene evaluated
densely in plain PyTorch, with no culling, no tape and nothing of the port
(``mpr_tpu_torch``), JAX or ``mpr_tpu``.

``evaluate`` walks the expression; ``render`` gives a 2D fill, a 3D depth
and its normals; ``fit`` gives a fit's losses and steps.  Every function
takes a ``dtype``: ``torch.float32``, as the port computes, or
``torch.bfloat16`` for the control, the next precision down.
"""

from .evaluate import evaluate, leaf_params  # noqa: F401
