"""sync_ms.frame3d: host ms a 3D frame inside the program's reads
back to the host and uploads (spans ``mpr.read``, ``mpr.upload``: the
interpreter's counts, schedule and tape, the unrolled ladder's
compactions); moves frame_ms."""

from portbench import spans

WATCH = (spans.program,)


def read(t):
    return spans.host_ms(t, ("mpr.read", "mpr.upload"))
