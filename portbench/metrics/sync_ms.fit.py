"""sync_ms.fit: host ms a fit step inside the program's reads back
to the host and uploads (spans ``mpr.read``, ``mpr.upload``: the step's
view and z); moves fit_step_ms."""

from portbench import spans

WATCH = (spans.program,)


def read(t):
    return spans.host_ms(t, ("mpr.read", "mpr.upload"))
