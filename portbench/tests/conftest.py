"""Shared pieces of the benchmark's CPU tests: the model types found on
disk, and a tiny cell of each, run end to end on the CPU (master, two peer
processes, the reference), with the harness's look for a card skipped."""

from __future__ import annotations

import json

import pytest

from portbench import spec

# every model type with a family file; each has a tiny configuration in
# tests/tiny/<type>.json
FAMILIES = sorted(p.stem for p in (spec.HERE / "families").glob("*.py")
                  if not p.name.startswith("_"))


def tiny_config(model_type: str) -> dict:
    """A tiny configuration of the model type, for the CPU."""
    return spec.load_json(spec.HERE / "tests" / "tiny" / f"{model_type}.json")


def tiny_traffic(**over) -> dict:
    tr = {"mode": "diloco", "peers": 2, "peers_per_chip": 2, "batch": 2,
          "block": 32, "inner_steps": 2, "checked_steps": 3, "inner_lr": 4e-4,
          "outer_lr": 0.7, "outer_momentum": 0.9, "remat": False,
          "loss_chunk": None}
    tr.update(over)
    return tr


def tiny_cell(model_type: str = "gpt2", **traffic) -> spec.Cell:
    """A throwaway cell on the limits of gpt2m.diloco, with the exact
    limits of a cell of several peers besides."""
    bench = spec.benchmark()
    limits = json.loads((spec.HERE / "limits" / "gpt2m.diloco.json").read_text())
    limits.update(start_mismatch=0, final_mismatch=0)
    # the end-to-end metrics of a DiLoCo cell of the benchmark
    return spec.Cell("tiny", 1, tiny_config(model_type), tiny_traffic(**traffic), limits,
                     [m for m in bench["end_to_end"]
                      if "workloads" not in m or "gpt2m.diloco" in m["workloads"]], [])


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
