"""What every run shares: the cell's files found by name, the caches kept
inside the checkout, the import guard, and the result line.

A cell of ``BENCHMARK.json`` is names only.  Its configuration's ``file``
(``configs/<name>.json``) names the scene builder (``scenes/<scene>.py``)
and its arguments; its traffic (``traffic/<name>.json``) names the driver
(``drivers/<driver>.py``) that generates and runs it, with its
parameters; its limits (``limits/<cell>.json``) hold the limit of each
number the comparison reads; each per-layer metric is a reader of its own
(``metrics/<name>.py``), with the watchers it needs.  Adding a cell or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "mpr_tpu")
# where the run's caches live: fixed paths inside the checkout (the port
# builds its kernels under build/mpr_tpu_torch/ there by itself)
CACHE = ROOT / "build" / "portbench"


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def use_checkout_caches() -> None:
    """Point the build and kernel caches of PyTorch and Triton at fixed
    directories inside the checkout, before torch is imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell with everything its names lead to."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, bench: dict = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(ROOT / configs[w["config"]]["file"]))
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per)


def scene(config: dict):
    """The configuration's scene: ``scenes/<scene>.py``'s ``build``."""
    mod = importlib.import_module(f"portbench.scenes.{config['scene']}")
    return mod.build(**config.get("args", {}))


def driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def metric_reader(name: str):
    """``metrics/<name>.py`` as a module (its ``read(trace)`` gives the
    metric, or None where the trace holds nothing for it)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def watchers(per_layer) -> tuple:
    """The watchers the metrics ``per_layer`` name (``WATCH`` in each
    metric's file), each once, in a fixed order."""
    found = {}
    for m in per_layer:
        for w in getattr(metric_reader(m["name"]), "WATCH", ()):
            found.setdefault((w.__module__, w.__qualname__), w)
    return tuple(found[k] for k in sorted(found))


def forbidden_modules():
    """Loaded modules whose top-level name is one the run may not hold."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


@dataclass
class Run:
    """One run of one cell, as the driver sees it."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: object = None
    tracer: object = None
    watched: tuple = ()
    spans: dict = field(default_factory=dict)

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    def window_seconds(self) -> float:
        """The measured window: ``--seconds``, or in a traced run the
        traffic's ``trace_seconds`` where that is shorter."""
        if self.trace:
            return min(self.seconds, float(self.traffic["trace_seconds"]))
        return self.seconds

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def setup_done(self) -> float:
        return time.perf_counter() - self.t_start


@dataclass
class Outcome:
    """What a driver hands back: the counts of work, the end-to-end
    values by metric name, the numbers compared by name, the device's
    peak memory, the trace of a traced run, and what the run prints on
    standard error besides (``info``: the window, the comparison's
    seconds)."""
    attempted: int
    failed: int
    metrics: dict
    checks: dict
    memory_peak_bytes: int
    trace: object = None
    info: dict = field(default_factory=dict)


def judge(checks: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is not finite fails."""
    rows, ok = [], True
    for name, value in checks.items():
        limit = float(limits[name]["limit"])
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok and bool(rows), rows


def result_line(cell: Cell, out: Outcome, device: dict):
    """The JSON object of the last line of standard output."""
    correct, rows = judge(out.checks, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if out.trace is None:
        for m in cell.end_to_end:
            if m["name"] not in out.metrics:
                raise BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        device = dict(device, busy_s=out.trace.busy_s,
                      window_s=out.trace.window_s)
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace.device_ops,
                             "idle_gaps": out.trace.idle_gaps}
    line["checks"] = {n: {"value": (v if v is not None and math.isfinite(v)
                                    else None), "limit": lim}
                      for n, v, lim in rows}
    return line, rows
