"""The traced run: torch.profiler over the measured window, and its
reduction to what the per-layer metrics read.

The harness marks its own calls into the port with ranges named
``portbench.<what>`` (``record_function``; spans from the benchmark's own
files, none inside the program).  A kernel counts to the innermost such
range around the runtime call that launched it.  Ranges named ``portbench.aux.*``
hold the harness's own device work in a traced window (the copies of
results, the roofline counts): it is busy time, but no layer's.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib.util
import re
from dataclasses import dataclass, field
from pathlib import Path

AUX = "portbench.aux"
TOP = 10
# a kernel's definition in the port's sources: a CUDA ``__global__``
# function (its launch bounds and the lines a macro continues skipped), or
# a Triton kernel
_CUDA_KERNEL = re.compile(
    r"__global__\s+(?:void\s+)?"
    r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")
_TRITON_KERNEL = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+([A-Za-z_]\w*)")
SOURCES = (".cu", ".cuh", ".cpp", ".h", ".py")


def kernel_names(root) -> frozenset:
    """The names of the kernels defined in the sources under ``root``:
    every hand-written CUDA kernel and the templates of the generated
    ones, and every Triton kernel."""
    names = set()
    for p in sorted(Path(root).rglob("*")):
        if p.suffix in SOURCES and p.is_file():
            text = p.read_text(errors="replace").replace("\\\n", " ")
            names.update(_CUDA_KERNEL.findall(text))
            names.update(_TRITON_KERNEL.findall(text))
    return frozenset(names)


@functools.lru_cache(maxsize=None)
def port_kernels() -> frozenset:
    """The kernels the port defines, read from its package's sources (not
    imported); every other kernel on the device is PyTorch's own."""
    spec = importlib.util.find_spec("mpr_tpu_torch")
    roots = list(spec.submodule_search_locations or ()) if spec else []
    return frozenset().union(*(kernel_names(r) for r in roots))


def is_port_kernel(name: str) -> bool:
    """Whether a device operation is one of the port's kernels: a word of
    its name (the profiler's demangled signature) is a kernel the port
    defines."""
    return not port_kernels().isdisjoint(re.findall(r"[A-Za-z_]\w*", name))


def _match(part, rng):
    """Kernels whose name holds ``part`` (a string, or a tuple of which
    any) under the range ``rng`` (None: any)."""
    parts = (part,) if isinstance(part, str) else tuple(part)
    return lambda n, r: (any(p in n for p in parts)
                         and (rng is None or r == rng))


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


@dataclass
class Trace:
    """What a traced window saw.  ``kernels``: (name, device seconds,
    harness range or None) of every device operation; ``counts``: per
    kernel, the (operations, bytes) of each of its launches; ``spans``:
    host seconds of harness spans by name; ``frames``: frames or steps
    completed in the window."""
    window_s: float
    busy_s: float
    frames: int
    kernels: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    compile_s: float = None
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def idle_pct(self):
        return 100.0 * (self.window_s - self.busy_s) / self.window_s

    def device_ms(self, keep) -> float:
        """Device ms a frame of the operations for which
        ``keep(name, range)`` holds; None where there is none."""
        got = [s for n, s, r in self.kernels if keep(n, r)]
        if not got or not self.frames:
            return None
        return 1e3 * sum(got) / self.frames

    def kernel_ms(self, part: str, rng: str = None):
        """Device ms a frame of the kernels whose name holds ``part``
        (launched under the harness range ``rng``, where given)."""
        return self.device_ms(_match(part, rng))

    def roofline_pct(self, kernel: str, part: str, rng: str = None):
        """The kernel's share of its roofline over the window's launches:
        the sum of their least times (``counts``) over the sum of their
        device times; None where either is missing."""
        from .counts import bound_s
        keep = _match(part, rng)
        got = [s for n, s, r in self.kernels if keep(n, r)]
        launches = self.counts.get(kernel)
        if not got or not launches:
            return None
        return 100.0 * sum(bound_s(o, b) for o, b in launches) / sum(got)

    def torch_ms(self):
        """Device ms a frame in PyTorch's own kernels (not the port's, not
        copies, not the harness's)."""
        return self.device_ms(lambda n, r: not is_port_kernel(n)
                              and not is_copy(n)
                              and not (r or "").startswith(AUX))

    def span_ms(self, name: str):
        got = self.spans.get(name)
        return 1e3 * sum(got) / len(got) if got else None


class Tracer:
    """Profiles the window when ``enabled``; ``range(name)`` marks a call."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.counts = {}
        self.reduce_s = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def count(self, kernel: str, ops, nbytes):
        """Keep a launch's (operations, bytes); tensors are read after the
        window."""
        self.counts.setdefault(kernel, []).append((ops, nbytes))

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self, window_s: float, frames: int, spans=None,
               compile_s=None) -> Trace:
        """The window's device operations, each with the harness range its
        launch lay in: a device operation and the runtime call that
        launched it share a correlation id, and the call lies, on its
        host thread, inside the harness's ranges.  Reads the profiler's
        raw events (no per-event Python objects of torch's own)."""
        import time
        from torch.autograd import DeviceType
        t_start = time.perf_counter()
        cuda = DeviceType.CUDA
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            row = (e.start_ns(), e.end_ns(), name, e.correlation_id(),
                   e.start_thread_id())
            if e.device_type() == cuda:
                # a range's own span on the device timeline is no operation
                if not (name.startswith("portbench.")
                        or _user_annotation(e)):
                    dev.append(row)
            else:
                cpu.append(row)
        launch = {c: (t, a) for a, _, n, c, t in cpu if n.startswith("cu")}
        ranges = _Ranges(r for r in cpu if r[2].startswith("portbench."))
        kern = []
        for a, b, name, corr, _ in dev:
            at = launch.get(corr)
            kern.append((name, (b - a) / 1e9,
                         ranges.innermost(*at) if at else None))
        busy, merged = _union([(a, b) for a, b, *_ in dev])
        by_name = {}
        for n, s, _ in kern:
            by_name[n] = by_name.get(n, 0.0) + s
        counts = {k: [(float(o), float(b)) for o, b in v]
                  for k, v in self.counts.items()}
        out = Trace(window_s=window_s, busy_s=busy, frames=frames,
                    kernels=kern, counts=counts, spans=spans or {},
                    compile_s=compile_s,
                    device_ops=sorted(([n, s] for n, s in by_name.items()),
                                      key=lambda t: -t[1])[:TOP],
                    idle_gaps=_gaps(merged, cpu))
        self.reduce_s = time.perf_counter() - t_start
        return out


def _user_annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


class _Ranges:
    """The harness's ranges by host thread, for the innermost one around
    an instant."""

    DEPTH = 64

    def __init__(self, rows):
        self.by_thread = {}
        for a, b, n, _, t in rows:
            self.by_thread.setdefault(t, []).append((a, b, n))
        for v in self.by_thread.values():
            v.sort()
        self.starts = {t: [a for a, _, _ in v]
                       for t, v in self.by_thread.items()}

    def innermost(self, thread, at):
        rows = self.by_thread.get(thread)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[thread], at)
        for a, b, n in reversed(rows[max(0, i - self.DEPTH):i]):
            if a <= at <= b:
                return n
        return None


def _union(iv):
    """Seconds in which some device operation ran, and the busy intervals
    (ns) in order."""
    merged = []
    for a, b in sorted(t for t in iv if t[1] > t[0]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e9, merged


def _gaps(merged, cpu):
    """Idle time between busy intervals, summed by what the host was doing
    at each gap's middle: the innermost host event there, within its
    outermost harness range.  The ten largest sums, in seconds."""
    if len(merged) < 2 or not cpu:
        return []
    threads = {}
    for r in cpu:
        threads[r[4]] = threads.get(r[4], 0) + 1
    main = max(threads, key=threads.get)
    evs = sorted(((a, -b, n) for a, b, n, _, t in cpu if t == main))
    gaps = sorted(((merged[i][1] + merged[i + 1][0]) / 2,
                   merged[i + 1][0] - merged[i][1])
                  for i in range(len(merged) - 1))
    stack, j, out = [], 0, {}
    for mid, length in gaps:
        while j < len(evs) and evs[j][0] <= mid:
            a, nb, n = evs[j]
            while stack and stack[-1][1] < a:
                stack.pop()
            stack.append((a, -nb, n))
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = stack[-1][2] if stack else "host outside any op"
        outer = next((n for _, _, n in stack if n.startswith("portbench.")),
                     "")
        label = f"{outer}/{inner}" if outer and outer != inner else inner
        out[label] = out.get(label, 0.0) + length / 1e9
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda t: -t[1])[:TOP]
