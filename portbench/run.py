"""Run one cell of the benchmark of ``mpr_tpu_torch`` on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run builds or loads the port's kernels
(into ``build/`` inside the checkout), makes its inputs from the seed,
warms up the cell's own shapes, measures for ``--seconds`` (a traced run:
the traffic's ``trace_seconds`` where shorter, under torch.profiler),
checks what the timed path produced against the plain reference
(``reference/``), prints each number compared beside its limit as the last
lines of standard error, and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the port cannot be imported, or when a
module of JAX or of the JAX package ``mpr_tpu`` is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import core  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, cell, device, check_device=True):
    """Run the cell's driver; returns (result line, compared rows).
    ``check_device`` False skips the look for a card (the CPU tests)."""
    import torch
    from portbench.trace import Tracer
    if check_device:
        if not torch.cuda.is_available():
            raise core.BenchError("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise core.BenchError(f"{torch.cuda.device_count()} CUDA "
                                  f"devices, the cell asks for {cell.chips}")
    run = core.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=T_START,
                   device=torch.device(device),
                   tracer=Tracer(bool(args.trace)))
    if run.trace:
        run.watched = core.watchers(cell.per_layer)
    out = core.driver(cell.traffic).run(run)
    found = core.forbidden_modules()
    if found:
        raise core.BenchError("modules of JAX or the JAX package are "
                              f"loaded: {', '.join(found)}")
    is_cuda = run.device.type == "cuda"
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": (torch.cuda.get_device_name(run.device) if is_cuda
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    if is_cuda:
        print(f"card: {core.card_line()}", file=sys.stderr)
    if run.trace:
        out.info["trace_reduce_s"] = run.tracer.reduce_s
    print("info: " + ", ".join(f"{k} {v!r}" for k, v in out.info.items())
          + f", run_s {time.perf_counter() - T_START!r}", file=sys.stderr)
    return core.result_line(cell, out, dev)


def main(argv=None) -> int:
    args = parse(argv)
    core.use_checkout_caches()
    try:
        cell = core.find_cell(args.workload)
        line, rows = execute(args, cell, "cuda")
    except core.BenchError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
