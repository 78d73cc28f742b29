"""idle_pct.fit: the share of the traced window in which no operation ran
on the device, in a fit's steps; moves fit_step_ms."""


def read(t):
    return t.idle_pct()
