"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root,
configs/<config>.json, traffic/<traffic>.json, limits/<cell>.json and
metrics/<metric>.py under this folder. Nothing here names a cell, so a new
cell, configuration, traffic mix or per-layer metric is a new file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json: number compared -> limit
    end_to_end: list      # BENCHMARK.json metrics this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; KeyError if the
    benchmark has no such cell."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    config["name"] = w["config"]
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    limits = load_json(here / "limits" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str, here: Path = HERE):
    """The module metrics/<name>.py, loaded by path (a metric's name may
    hold dots)."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "portbench.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
