"""torch_ms.voxel: device ms an unrolled 3D frame of PyTorch's own
kernels in the voxel stage, the program's span ``mpr.u3d.voxel``
(render/unrolled.py::_voxel_stage: the voxels' indices and centres, the
depth's scatter); the generated kernels and copies are left out, as in
torch_ms.frame3d; moves frame_ms."""

from portbench import spans

WATCH = (spans.program,)


def read(t):
    return spans.device_ms(t, ("mpr.u3d.voxel",), spans.torch_kernel)
