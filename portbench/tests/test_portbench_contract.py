"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

from __future__ import annotations

import json
import re

import pytest

from portbench_tiny import core

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_with_every_cell():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
    assert c["file"].startswith("portbench/configs/")
    data = core.load_json(core.ROOT / c["file"])
    assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in c["reduced"])
    assert (core.HERE / "scenes" / f"{data['scene']}.py").exists()
    assert sum(o["file"] == c["file"] for o in BENCH["configs"]) == 1
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    cell = core.find_cell(w["name"])
    assert (core.HERE / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        mod = core.metric_reader(m["name"])
        assert callable(mod.read)
    assert set(cell.limits), "every cell compares some number"
    for lim in cell.limits.values():
        assert lim["limit"] >= 0


def test_names_and_metrics():
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(cells) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads", cells)
            assert cell in reports, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(len(v) == 1 for v in layers.values())
