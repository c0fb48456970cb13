"""A cell, a configuration, a traffic mix and a per-layer metric added as
files are found by name, with no edit to the harness; and every file that
BENCHMARK.json names is there and keeps the contract's forms."""

import json
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|proj|_dim$|_rank$|head_size|"
                   r"expansion|experts_per_tok|n_embd|n_inner)")


def test_throwaway_cell_found(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    (here / "configs" / "throwaway.json").write_text(json.dumps(
        {"model_type": "gpt2", "n_layer": 1, "n_embd": 64, "n_head": 4, "vocab_size": 128}))
    (here / "traffic" / "throwaway.mix.json").write_text(json.dumps({"mode": "diloco", "batch": 1}))
    (here / "limits" / "thrown.away.json").write_text(json.dumps({"loss_gap": 1.0}))
    (here / "metrics" / "throwaway.metric.py").write_text("def read(ctx):\n    return 1.5\n")
    bench["configs"].append({"name": "throwaway", "source": "https://example.org",
                             "file": "portbench/configs/throwaway.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "thrown.away", "config": "throwaway",
                               "traffic": "throwaway.mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway.metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "x",
                               "moves": "tokens_per_s", "workloads": ["thrown.away"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("thrown.away", root=tmp_path, here=here)
    assert cell.config["n_layer"] == 1 and cell.traffic["batch"] == 1
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["throwaway.metric"]
    assert spec.metric_reader("throwaway.metric", here=here).read({}) == 1.5


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")


def test_benchmark_files_and_names():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cell = spec.load_cell(w["name"])
        assert cell.traffic["peers"] // cell.traffic["peers_per_chip"] == w["chips"]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)
