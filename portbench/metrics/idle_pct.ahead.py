"""idle_pct.ahead: the share of the traced window in which no operation ran
on the device, in the 2D frames dispatched ahead; moves mpix_per_s."""


def read(t):
    return t.idle_pct()
