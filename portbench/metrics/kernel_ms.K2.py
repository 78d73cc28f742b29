"""kernel_ms.K2: device ms a step of kernel K2 (ops/csrc/scan_adjoint.cu:
the reverse walk and its sum over blocks), the kernels launched under its
entry point; moves fit_step_ms."""

from portbench.counts import watch

WATCH = (watch.scan_adjoint,)
K2 = ("scan_adjoint_kernel", "reduce_partials_kernel")


def read(t):
    return t.kernel_ms(K2, "portbench.K2")
