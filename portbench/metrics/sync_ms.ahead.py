"""sync_ms.ahead: host ms a 2D frame inside the program's reads
back to the host and uploads (spans ``mpr.read``, ``mpr.upload``:
``TapeData.meta``, the branch remap table); moves mpix_per_s."""

from portbench import spans

WATCH = (spans.program,)


def read(t):
    return spans.host_ms(t, ("mpr.read", "mpr.upload"))
