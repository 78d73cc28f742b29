"""K2_roofline: kernel K2's share of its roofline: the least time of its
launches' work (a reverse step a clause that reaches the result, a lane;
the coordinates and upstream gradient in, the gradient out;
counts/watch.py) over their device time; moves fit_step_ms."""

from portbench.counts import watch

WATCH = (watch.scan_adjoint,)
K2 = ("scan_adjoint_kernel", "reduce_partials_kernel")


def read(t):
    return t.roofline_pct("K2", K2, "portbench.K2")
