"""unrolled_float_roofline: the generated float kernel's share of its
roofline: the least time of its launches' work (the whole tape a lane,
three coordinates in and a value out; counts/watch.py) over their device
time; moves frame_ms."""

from portbench.counts import watch

WATCH = (watch.unrolled_float,)


def read(t):
    return t.roofline_pct("unrolled_float", "mpr_unrolled_kernel",
                          "portbench.unrolled_float")
