"""The port's spans and counters: the one registry of both.

``span(name)`` marks a stage of a frame or a fit step for torch.profiler
(``record_function``), and only while a profiler is on.  A
``record_function`` costs about 14 us a call on a CPU core even with no
profiler running; the check in front of it costs a fraction of a
microsecond, so an untraced frame pays nothing measurable.  Every span
is named ``mpr.<path>.<stage>``, or ``mpr.prepass``, ``mpr.read`` and
``mpr.upload`` where several paths share the code; ``cli --profile DIR``
writes them into its Chrome trace.

``COUNTS`` counts always (an integer increment a call):

* ``host_reads``: a device value read back to the host (the host waits
  for the device's queue to drain), under the span ``mpr.read``;
* ``uploads``: host data copied to a device, under ``mpr.upload``;
* ``builds.schedule``: kernel A's dependency schedules built
  (``ops/schedule.py::tape_levels``);
* ``builds.compile`` / ``builds.load``: kernel libraries compiled by
  nvcc and loaded (``ops/build.py::lib``);
* ``voxel.kernels``: chunks of the unrolled voxel stage whose glue ran
  as the two kernels of ``ops/csrc/voxel_glue.cu``
  (``render/unrolled.py::_voxel_stage``; none on the CPU).

The hot paths read and upload only through :func:`read_int`,
:func:`read_ids`, :func:`read_array` and :func:`upload`.
"""

from __future__ import annotations

import collections
import contextlib

import torch

COUNTS = collections.Counter()
_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a profiler is on; otherwise
    one shared context that does nothing."""
    return torch.profiler.record_function(name) if _profiling() else _OFF


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n


def read_int(t) -> int:
    """``int(t)`` of a one-element tensor: one read back to the host."""
    with span("mpr.read"):
        v = int(t)
    COUNTS["host_reads"] += 1
    return v


def read_ids(mask) -> torch.Tensor:
    """The ids where ``mask`` (1-D), ascending: ``torch.nonzero``, whose
    count is read back to the host to size its output."""
    with span("mpr.read"):
        ids = torch.nonzero(mask).flatten()
    COUNTS["host_reads"] += 1
    return ids


def read_array(t):
    """A tensor's values as a numpy array on the host: one read."""
    with span("mpr.read"):
        a = t.detach().cpu().numpy()
    COUNTS["host_reads"] += 1
    return a


def upload(x, dev, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=dev)`` of host data (a
    Python value, a numpy array, a tensor in host memory): one upload.  A
    tensor already on a card is no upload and passes through uncounted."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return torch.as_tensor(x, dtype=dtype, device=dev)
    with span("mpr.upload"):
        t = torch.as_tensor(x, dtype=dtype, device=dev)
    COUNTS["uploads"] += 1
    return t
