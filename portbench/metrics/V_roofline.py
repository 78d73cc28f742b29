"""V_roofline: kernel V's share of its roofline: the least time of the
work of its launches (each ambiguous cell's shortened tape and its
coordinates a voxel, the bytes of its inputs and outputs;
counts/watch.py) over their device time; moves frame_ms."""

from portbench.counts import watch

WATCH = (watch.voxel_eval_3d,)


def read(t):
    return t.roofline_pct("V", "voxel_eval_kernel")
