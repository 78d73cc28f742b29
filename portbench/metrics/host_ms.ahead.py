"""host_ms.ahead: host ms to issue a 2D frame, the host clock around the
call of render/pipeline2d.render_tile_block (under the profiler of the
traced run); moves mpix_per_s."""


def read(t):
    return t.span_ms("issue")
