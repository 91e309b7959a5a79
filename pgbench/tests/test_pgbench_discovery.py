"""The harness finds every cell, configuration, traffic mix, check and
metric by its name, and BENCHMARK.json keeps to the benchmark's
contract."""
import json
import os
import re

import pytest

from pgbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert spec.module("entries", c.traffic["entry"]).Entry
    assert c.config["reduced"] == [x for x in BENCH["configs"]
                                   if x["name"] == c.config_name][0]["reduced"]
    for check, body in c.workload["checks"].items():
        assert spec.module("checks", check).readings
        assert body["limits"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_by_name(metric):
    assert callable(spec.module("metrics", metric).read)


def test_names_units_and_keys():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_is_used_and_files_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["name"] in used
        assert c["file"].startswith("pgbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["source"]
