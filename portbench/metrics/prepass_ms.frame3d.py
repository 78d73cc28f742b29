"""prepass_ms.frame3d: device ms a 3D frame in the prepass, the
program's span ``mpr.prepass`` (render/pipeline2d.py::_shorten_prepass,
in chunks of rows for the voxel cells' and the normal columns' tapes of
render/pipeline3d.py); moves frame_ms."""

from portbench import spans

WATCH = (spans.program,)


def read(t):
    return spans.device_ms(t, ("mpr.prepass",))
