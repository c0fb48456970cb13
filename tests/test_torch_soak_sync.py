"""The soak's shared-state lane through the port's orchestrator with CPU
tensors: three peers sync a 1,048,576-float32 state (4 MiB, 16 chunks of
256 KiB) every step over the content-addressed chunk plane for 45 s,
through a joiner flood and a seeder kill, besides the random deaths. The
orchestrator's SYNC SUMMARY gates decide: zero wrong-content adoptions,
zero failed syncs (on live peers and over every peer life), and the churn
schedule fired. A file of its own, so that --dist loadfile puts it on
another worker than test_torch_soak.py.

The run has no seeder-edge degrade (--sync-degrade-mbit 0), so its
watchdog gate is not in play: a suspect needs a cold joiner to fetch from
peer 0 after the degrade began, with a healthy seeder left to re-source
to, and peer 0 to print a STATS line before the seeder kill, which only
random deaths arrange. With the degrade at 2 Mbit/s the gate tripped in
none of 18 runs of this setting on a CPU (and at 90 s in 1 of 3), and the
JAX orchestrator's in 3 of 5.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pccl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
# below the kernel's ephemeral range, away from the other files' ranges
MASTER_PORT, BASE_PORT = 31840, 31850


def test_sync_churn_soak():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    lib = _build.ensure_pcclt()
    proc = subprocess.run(
        [sys.executable, "-m", "pccl_tpu_torch.examples.stress.stress_orchestrator",
         "--device", "cpu", "--duration", "45", "--peers", "3",
         "--sync-churn", "1048576", "--sync-degrade-mbit", "0",
         "--stall-seconds", "60",
         "--master-port", str(MASTER_PORT), "--base-port", str(BASE_PORT)],
        cwd=REPO, env={**os.environ, "PCCLT_LIB": str(lib), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, \
        f"soak failed:\nstdout:{proc.stdout[-2500:]}\nstderr:{proc.stderr[-1500:]}"
    assert "SOAK PASSED" in proc.stdout
    summary = re.search(r"^SYNC SUMMARY: (.*)$", proc.stdout, re.M)
    assert summary, proc.stdout[-2500:]
    fields = dict(kv.split("=") for kv in summary.group(1).split())
    assert fields["wrong"] == "0" and fields["aborted"] == "0"
    assert fields["syncs_failed"] == "0"
    assert int(fields["floods"]) >= 1 and int(fields["seeder_kills"]) >= 1
    assert int(fields["chunks_fetched"]) > 0    # the chunk plane carried it
    # the CPU lane hashes on the host: no H1 field
    assert "h1_launches" not in fields
