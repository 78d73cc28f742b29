"""On the card: every cell of BENCHMARK.json run through the command as
the check runs it, with a short window, comes out correct and loads
nothing of JAX or of the JAX package.  Skips without a card.

    python -m pytest -q portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench_tiny import cells, core


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", cells())
def test_cell_runs_correct(card, name):
    out = subprocess.run(
        [sys.executable, str(core.HERE / "run.py"), "--workload", name,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=core.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == card
