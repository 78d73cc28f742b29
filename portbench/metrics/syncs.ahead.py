"""syncs.ahead: the program's reads back to the host and uploads a
2D frame (counters ``host_reads`` and ``uploads`` over the window);
moves mpix_per_s."""

from portbench import spans

WATCH = (spans.program,)
SYNCS = ("host_reads", "uploads")


def read(t):
    return spans.per_frame(t, spans.delta(SYNCS))
