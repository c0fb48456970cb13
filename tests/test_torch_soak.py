"""The fault-tolerance soak through the port's orchestrator
(`python -m pccl_tpu_torch.examples.stress.stress_orchestrator`) with CPU
tensors: the twins of tests/test_fault_tolerance.py's churn soak and
master-kill soak. Peers die at random and are relaunched; in the second
the master is also SIGKILLed every 15 s and restarted on the same port,
and the peers rejoin. The orchestrator's own gates decide (progress in
every stall window, the master churn exercised); each run has its own
timeout, as the JAX tests give theirs.

The shared-state lane (--sync-churn) is in test_torch_soak_sync.py, a
file of its own so that it runs on another worker.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pccl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
# master and base ports of each soak: below the kernel's ephemeral range
# (a restarted master must get its port back) and away from the ranges of
# the other test files; a peer listens at base + 16 i + {0, 4, 8}
PORTS = {"churn": (31720, 31730), "master_kill": (31780, 31790)}


def _soak(kind: str, args: list, timeout: float):
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    lib = _build.ensure_pcclt()
    master_port, base_port = PORTS[kind]
    return subprocess.run(
        [sys.executable, "-m", "pccl_tpu_torch.examples.stress.stress_orchestrator",
         "--device", "cpu", *args, "--master-port", str(master_port),
         "--base-port", str(base_port)],
        cwd=REPO, env={**os.environ, "PCCLT_LIB": str(lib), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=timeout)


def test_churn_soak_smoke():
    proc = _soak("churn", [
        "--duration", "30", "--peers", "3", "--die-prob", "0.01",
        # a relaunched peer's start-up can eat a short stall window on a
        # loaded machine: the zero-total-progress check still holds
        "--stall-seconds", "60"], timeout=180)
    assert proc.returncode == 0, \
        f"soak failed:\nstdout:{proc.stdout[-1500:]}\nstderr:{proc.stderr[-1500:]}"
    assert "SOAK PASSED" in proc.stdout
    assert "relaunching" in proc.stdout


def test_master_churn_soak_smoke():
    proc = _soak("master_kill", [
        "--duration", "45", "--peers", "3", "--die-prob", "0.003",
        "--master-kill-interval", "15", "--stall-seconds", "60"], timeout=240)
    assert proc.returncode == 0, \
        f"soak failed:\nstdout:{proc.stdout[-1500:]}\nstderr:{proc.stderr[-1500:]}"
    assert "SOAK PASSED" in proc.stdout
    assert "master restarts" in proc.stdout
    assert "master restarted" in proc.stdout    # at least one restart
