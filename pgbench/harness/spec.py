"""A cell as the benchmark defines it: its entry in BENCHMARK.json, its
configuration (configs/<config>.json and the scenes/<scene>.py it names), its traffic
(traffic/<traffic>.json), its own file (workloads/<cell>.json: the
checks of ``correct`` with their limits) and the metrics that apply to
it.  Everything is found by name, so a new cell, configuration, traffic
mix or metric is a new file and a new entry in BENCHMARK.json."""
import importlib
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name):
    bench = benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"unknown workload '{name}'")
    w = entries[0]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json("configs", w["config"] + ".json"),
                traffic=_json("traffic", w["traffic"] + ".json"),
                workload=_json("workloads", name + ".json"),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def module(kind, name):
    """pgbench/<kind>/<name>.py, imported by name."""
    return importlib.import_module(f"pgbench.{kind}.{name}")


def scene_description(cell, overrides=None):
    params = dict(cell.config.get("scene_params", {}))
    params.update(overrides or {})
    return module("scenes", cell.config["scene"]).describe(**params)
