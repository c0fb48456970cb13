"""Shared pieces of the benchmark's CPU tests: a tiny cell of each model
type, run end to end on the CPU (master, two peer processes, the
reference), with the harness's look for a card skipped."""

from __future__ import annotations

import json

import pytest

from portbench import spec

TINY = {
    "gpt2": {"model_type": "gpt2", "n_layer": 2, "n_embd": 64, "n_head": 4,
             "vocab_size": 256, "layer_norm_epsilon": 1e-6,
             "assumed": {"rope_theta": 10000.0}},
    "mistral": {"model_type": "mistral", "num_hidden_layers": 2, "hidden_size": 64,
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                "intermediate_size": 128, "vocab_size": 256, "rope_theta": 1e6,
                "rms_norm_eps": 1e-6},
}


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
    return spec.Cell("tiny", 1, dict(TINY[model_type]), tiny_traffic(**traffic), limits,
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
