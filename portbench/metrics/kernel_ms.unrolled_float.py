"""kernel_ms.unrolled_float: device ms a frame of the unrolled engine's
generated float kernel (ops/unrolled_eval.py), the kernels launched under
its entry point; moves frame_ms."""

from portbench.counts import watch

WATCH = (watch.unrolled_float,)


def read(t):
    return t.kernel_ms("mpr_unrolled_kernel", "portbench.unrolled_float")
