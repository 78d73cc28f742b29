"""kernel_ms.B: device ms a frame of kernel B (ops/csrc/pixel_eval.cu);
moves mpix_per_s."""


def read(t):
    return t.kernel_ms("pixel_eval_kernel")
