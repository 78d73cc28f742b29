"""torch_ms.ahead: device ms a 2D frame spends in PyTorch's own kernels
(the render glue of render/pipeline2d.py: boxes, sorts, the prepass,
scatters), not in the port's kernels; moves mpix_per_s."""


def read(t):
    return t.torch_ms()
