"""syncs.fit: the program's reads back to the host and uploads a fit
step (counters ``host_reads`` and ``uploads`` over the window); moves
fit_step_ms."""

from portbench import spans

WATCH = (spans.program,)
SYNCS = ("host_reads", "uploads")


def read(t):
    return spans.per_frame(t, spans.delta(SYNCS))
