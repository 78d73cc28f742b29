"""The program's own spans and counters (``mpr_tpu_torch/utils/trace.py``:
``mpr.*`` profiler ranges and ``COUNTS``), read from a traced window.

The watcher :func:`program` keeps the run's tracer and takes a copy of
the program's counters when it is installed, before the window, and again
when it is removed, right after the window.  The readers, called after
the window:

* :meth:`Window.device_s`: device seconds of the operations whose
  launching runtime call lies, on its own host thread, inside a span of
  the given names at any depth (the launch and the operation share a
  correlation id; ``trace._Ranges`` finds the span).  The harness's own
  work (``portbench.aux.*``) is left out;
* :meth:`Window.host_s`: host seconds inside spans of the given names, on
  any thread;
* :func:`delta`: the change of counters over the window.

A metric file reads them a frame (``Trace.frames``: a step in a fit)
through :func:`device_ms`, :func:`host_ms` and :func:`per_frame`.  A
program without the registry (an older checkout) has neither spans nor
counters, and every reader then gives None.  The watcher's state is this
module's: a run installs it once, for its one traced window.
"""

from __future__ import annotations

from . import trace

_STATE = {}


def program(run, tape):
    """Watcher: keep ``run.tracer`` and the program's counters at the
    window's start; the function it returns takes them at its end."""
    _STATE.clear()
    try:
        from mpr_tpu_torch.utils.trace import COUNTS
    except ImportError:
        return lambda: None
    _STATE.update(tracer=run.tracer, before=dict(COUNTS))

    def restore():
        _STATE["after"] = dict(COUNTS)
    return restore


class Window:
    """A window's events as rows: ``dev`` (start ns, end ns, name,
    correlation id, thread) of each device operation, ``cpu`` the same of
    each host event (runtime calls, ranges)."""

    def __init__(self, dev, cpu):
        launch = {c: (t, a) for a, _, n, c, t in cpu if n.startswith("cu")}
        harness = trace._Ranges(r for r in cpu
                                if r[2].startswith("portbench."))
        self.spans = [r for r in cpu if r[2].startswith("mpr.")]
        self.ops = []
        for a, b, name, corr, _ in dev:
            at = launch.get(corr)
            rng = None if at is None else harness.innermost(*at)
            if at is not None and not (rng or "").startswith(trace.AUX):
                self.ops.append((name, (b - a) / 1e9, at))

    @classmethod
    def of(cls, prof) -> "Window":
        """The rows of a finished ``torch.profiler.profile``, device
        operations kept as ``trace.Tracer.reduce`` keeps them."""
        from torch.autograd import DeviceType
        cuda = DeviceType.CUDA
        dev, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            row = (e.start_ns(), e.end_ns(), name, e.correlation_id(),
                   e.start_thread_id())
            if e.device_type() != cuda:
                cpu.append(row)
            elif not (name.startswith("portbench.")
                      or trace._user_annotation(e)):
                dev.append(row)
        return cls(dev, cpu)

    def device_s(self, names, keep=None):
        """Device seconds of the operations launched inside a span named
        in ``names`` for which ``keep(name)`` holds (default: all); None
        where the window ran no device operation."""
        if not self.ops:
            return None
        inside = trace._Ranges(r for r in self.spans if r[2] in names)
        return sum(s for n, s, at in self.ops
                   if (keep is None or keep(n))
                   and inside.innermost(*at) is not None)

    def host_s(self, names) -> float:
        """Host seconds inside the spans named in ``names``."""
        return sum(b - a for a, b, n, _, _ in self.spans if n in names) / 1e9


def window():
    """The traced window of the run, or None without the program's
    registry or a profile."""
    tr = _STATE.get("tracer")
    if tr is None or tr.prof is None:
        return None
    if "window" not in _STATE:
        _STATE["window"] = Window.of(tr.prof)
    return _STATE["window"]


def delta(names):
    """The change of the counters ``names`` (summed) over the window;
    None without the registry."""
    before, after = _STATE.get("before"), _STATE.get("after")
    if before is None or after is None:
        return None
    return sum(after.get(n, 0) - before.get(n, 0) for n in names)


def per_frame(t, value):
    return None if value is None or not t.frames else value / t.frames


def device_ms(t, names, keep=None):
    w = window()
    s = None if w is None else w.device_s(names, keep)
    return per_frame(t, None if s is None else 1e3 * s)


def host_ms(t, names):
    w = window()
    return per_frame(t, None if w is None else 1e3 * w.host_s(names))


def torch_kernel(name: str) -> bool:
    """PyTorch's own kernels, as ``Trace.torch_ms`` counts them: not the
    port's, not a copy."""
    return not trace.is_port_kernel(name) and not trace.is_copy(name)
