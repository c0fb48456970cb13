"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root,
configs/<config>.json, traffic/<traffic>.json, limits/<cell>.json and
metrics/<metric>.py under this folder; a configuration's `model_type` as
families/<type>.py and reference/families/<type>.py, and a traffic mix's
`token_law` as tokens/<law>.py. Nothing here names a cell or a model type,
so a new cell, configuration, model type, traffic mix, token law or
per-layer metric is a new file."""

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
    benchmark has no such cell, FileNotFoundError naming the file if one
    it needs (its model type's or token law's too) is missing."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    config["name"] = w["config"]
    _found(family_path(config["model_type"], here))
    _found(reference_family_path(config["model_type"], here))
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    if "token_law" in traffic:
        _found(token_law_path(traffic["token_law"], here))
    limits = load_json(here / "limits" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _found(path: Path) -> Path:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return path


def _load(path: Path, mod_name: str):
    """The module at `path`, loaded by path (a name may hold dots);
    FileNotFoundError naming the path where there is no such file."""
    spec = importlib.util.spec_from_file_location(mod_name, _found(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mod_name(package: str, name: str) -> str:
    return f"portbench.{package}." + name.replace(".", "_")


def metric_reader(name: str, here: Path = HERE):
    """The module metrics/<name>.py."""
    return _load(here / "metrics" / f"{name}.py", _mod_name("metrics", name))


def family_path(model_type: str, here: Path = HERE) -> Path:
    return here / "families" / f"{model_type}.py"


def reference_family_path(model_type: str, here: Path = HERE) -> Path:
    return here / "reference" / "families" / f"{model_type}.py"


def token_law_path(name: str, here: Path = HERE) -> Path:
    return here / "tokens" / f"{name}.py"


def family(model_type: str, here: Path = HERE):
    """families/<model_type>.py: the type's port mapping, parameter shapes,
    FLOPs and attention calls (families/__init__.py)."""
    return _load(family_path(model_type, here), _mod_name("families", model_type))


def reference_family(model_type: str, here: Path = HERE):
    """reference/families/<model_type>.py: the type's layer, head and norm
    in the plain reference (reference/families/__init__.py)."""
    return _load(reference_family_path(model_type, here),
                 _mod_name("reference.families", model_type))


def token_law(name: str, here: Path = HERE):
    """tokens/<name>.py: a draw of token ids (tokens/__init__.py)."""
    return _load(token_law_path(name, here), _mod_name("tokens", name))
