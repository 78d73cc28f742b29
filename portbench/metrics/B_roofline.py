"""B_roofline: kernel B's share of its roofline: the least time of the
work of its launches (the operations of each ambiguous tile's shortened
tape a pixel, the bytes of its inputs and outputs; counts/watch.py) over
their device time; moves mpix_per_s."""

from portbench.counts import watch

WATCH = (watch.pixel_eval_runs,)


def read(t):
    return t.roofline_pct("B", "pixel_eval_kernel")
