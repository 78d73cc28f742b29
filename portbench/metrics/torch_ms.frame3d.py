"""torch_ms.frame3d: device ms a 3D frame spends in PyTorch's own kernels
(the glue of render/pipeline3d.py or render/unrolled.py), not in the
port's kernels; moves frame_ms."""


def read(t):
    return t.torch_ms()
