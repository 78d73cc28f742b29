"""idle_pct.frame3d: the share of the traced window in which no operation ran
on the device, in a closed loop of 3D frames; moves frame_ms."""


def read(t):
    return t.idle_pct()
