"""Whole runs on the CPU at a tiny size (a master, two peer processes, the
reference), past the harness's look for a card: a sound run comes out
correct, and each fault planted under the timed path, and the control,
come out not correct."""

import sys

import pytest

from portbench import check, faults, run
from portbench.guard import forbidden_modules
from portbench.tests.conftest import tiny_cell

SEED = 3_000_000_019      # more than 32 signed bits hold


def test_sound_run_is_correct():
    cell = tiny_cell()
    res = run.run_cell(cell, SEED, 2.0, 0, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"tokens_per_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"
    assert forbidden_modules(sys.modules) == []


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(fault):
    res = run.run_cell(tiny_cell("mistral"), SEED + 1, 2.0, 0, device="cpu", fault=fault)
    assert not res["correct"], res["checks"]


def test_control_is_caught():
    from portbench.checks import diloco

    cell = tiny_cell()
    numbers = diloco.control(cell, SEED, "cpu")
    assert not check.judge(numbers, cell.limits), numbers


def test_forbidden_names_compare_whole_top_level():
    names = ["pccl_tpu_torch.parallel.train", "pccl_tpu_torchx", "jax.numpy", "jaxlib",
             "flax.linen", "pccl_tpu", "pccl_tpu.comm", "numpy", "jaxtyping"]
    assert forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "pccl_tpu",
                                        "pccl_tpu.comm"]


def test_no_card_no_result():
    import subprocess

    from portbench import spec

    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "gpt2m.diloco",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=spec.ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
