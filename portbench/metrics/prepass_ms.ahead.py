"""prepass_ms.ahead: device ms a 2D frame in the prepass, the program's
span ``mpr.prepass`` (render/pipeline2d.py::_shorten_prepass: kernel C's
input planes from kernel A's codes, in plain PyTorch); moves
mpix_per_s."""

from portbench import spans

WATCH = (spans.program,)


def read(t):
    return spans.device_ms(t, ("mpr.prepass",))
