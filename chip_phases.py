#!/usr/bin/env python3
"""Run the chip_smoke.py of the checkout in the working directory with each
phase's seconds printed, for a tree whose chip_smoke.py does not print
them (its own last line and exit code are kept):

    cd OTHER_CHECKOUT && python3 /path/to/chip_phases.py

Each ``run_*`` phase function prints ``phase run_NAME: S s (at T s)`` on
the host clock when it returns; the build phase is the time before the
first of them.  Compare two trees' phases only within one call to the
card, or say that the machines may differ.
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()
for name in [n for n in dir(cs) if n.startswith("run_")
             and n != "run_viewer_http"]:
    fn = getattr(cs, name)

    @functools.wraps(fn)
    def timed(*a, _fn=fn, _name=name, **k):
        t0 = time.perf_counter()
        try:
            return _fn(*a, **k)
        finally:
            print(f"phase {_name}: {time.perf_counter() - t0:.1f} s "
                  f"(at {time.perf_counter() - T0:.1f} s)", flush=True)
    setattr(cs, name, timed)
sys.exit(cs.main())
