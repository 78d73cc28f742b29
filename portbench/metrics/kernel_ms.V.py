"""kernel_ms.V: device ms a frame of kernel V (ops/csrc/voxel_eval.cu);
moves frame_ms."""


def read(t):
    return t.kernel_ms("voxel_eval_kernel")
