"""The port's master CLI, its observability plane and the small modules the
port keeps its own copies of, against the JAX package's:

- `python -m pccl_tpu_torch.comm.master --metrics-port 0` prints the port
  the kernel assigned, `/health` answers JSON and `/metrics` passes the
  port's promlint;
- fleet ingest: observer sessions flooded by `pccltDigestFlood` through
  the port's `_native` all fold, with no queue drops, and never join the
  world (as tests/test_fleet_scale.py's ingest test, at a smaller N);
- `pccl_tpu_torch.comm.promlint.lint` gives the JAX copy's findings on the
  valid exposition and on each malformed case of tests/test_fleet_scale.py;
- the logger (`PCCLT_LOG_LEVEL`) filters and formats as the JAX one;
- `BUILD_INFO` equals the JAX package's apart from its name.

The master runs as a subprocess on the library `_build.ensure_pcclt()`
builds into pccl_tpu_torch/build/ (under a lock); the native tests skip
only without g++.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from pccl_tpu.comm import promlint as jax_promlint
from pccl_tpu_torch.comm import promlint
from pccl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
# ports of this file, below the kernel's ephemeral range and away from the
# ranges of the other test files
MASTER_PORTS = {"cli": 31700, "fleet": 31710}


def _lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _get(port: int, path: str, timeout: float = 30.0) -> str:
    """The body of GET path from the master's HTTP endpoint."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(f"GET {path} HTTP/1.0\r\nHost: x\r\n\r\n".encode())
        buf = b""
        while chunk := s.recv(1 << 16):
            buf += chunk
    return buf.split(b"\r\n\r\n", 1)[1].decode("utf-8", "replace")


def _prom(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(None, 1)[-1])
    raise AssertionError(f"{name} not in scrape")


class _Master:
    """`python -m pccl_tpu_torch.comm.master --metrics-port 0`; reads the
    metrics port from its listening line."""

    def __init__(self, port: int, env: dict | None = None):
        lib = _lib()
        e = {**os.environ, "PCCLT_LIB": str(lib),
             "PCCLT_METRICS_MAX_AGE_MS": "0", **(env or {})}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
             "127.0.0.1", "--port", str(port), "--metrics-port", "0"],
            cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        # the native core logs to the same stream: skip to the CLI's line
        seen = []
        for line in self.proc.stdout:
            seen.append(line)
            if line.startswith("master listening"):
                break
        self.line = seen[-1] if seen else ""
        # keep draining, so that the core's logging never fills the pipe
        threading.Thread(target=self.proc.stdout.read, daemon=True).start()
        m = re.search(r"metrics on :(\d+)\)", self.line)
        if m is None:
            self.kill()
            raise AssertionError(f"no metrics port in {seen!r}")
        self.mport = int(m.group(1))

    def scrape(self, path: str = "/metrics") -> str:
        text = _get(self.mport, path)
        if path.startswith("/metrics"):
            promlint.assert_valid(text, context=f"GET {path}")
        return text

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=10)


def test_master_cli_serves_metrics_and_health():
    port = MASTER_PORTS["cli"]
    m = _Master(port)
    try:
        assert m.line.startswith(f"master listening on 127.0.0.1:{port} (epoch ")
        assert m.mport not in (0, port)
        health = json.loads(m.scrape("/health"))
        assert health["world_size"] == 0 and "build" in health
        text = m.scrape("/metrics")
        assert promlint.lint(text) == [] and "pcclt_master_" in text
    finally:
        m.kill()


def test_fleet_ingest_through_the_ports_native():
    """40 observers x 4 edges flooded through the port's ctypes mirror:
    every digest folds, no queue drops, the world stays empty, and every
    scrape is promlint-clean."""
    _lib()
    from pccl_tpu_torch.comm import _native

    native = _native.load()
    port = MASTER_PORTS["fleet"]
    m = _Master(port)
    try:
        peers, edges = 40, 4
        sent, wall = ctypes.c_uint64(0), ctypes.c_double(0.0)
        rc = native.pccltDigestFlood(b"127.0.0.1", port, peers, edges, 6.0, 1.0,
                                     4, ctypes.byref(sent), ctypes.byref(wall))
        assert rc == 0, f"pccltDigestFlood rc={rc}"
        assert sent.value >= peers          # at least one full round landed
        deadline = time.time() + 30
        while time.time() < deadline:
            text = m.scrape()
            folded = _prom(text, "pcclt_master_telemetry_digests_total")
            if folded >= sent.value:
                break
            time.sleep(0.1)
        assert folded == sent.value, (folded, sent.value)
        assert _prom(text, "pcclt_master_digest_queue_dropped_total") == 0
        health = json.loads(m.scrape("/health"))
        assert health["world_size"] == 0
        assert health["telemetry_digests"] == sent.value
    finally:
        m.kill()


# the valid exposition and the malformed cases of tests/test_fleet_scale.py
PROM_TEXTS = {
    "valid": (
        "# HELP pcclt_up whether up\n"
        "# TYPE pcclt_up gauge\n"
        'pcclt_up{peer="a",group="0"} 1\n'
        'pcclt_up{peer="b\\"x\\\\y\\n",group="0"} 0\n'
        "# TYPE pcclt_lat_seconds histogram\n"
        'pcclt_lat_seconds_bucket{le="0.1"} 2\n'
        'pcclt_lat_seconds_bucket{le="+Inf"} 3\n'
        "pcclt_lat_seconds_sum 0.5\n"
        "pcclt_lat_seconds_count 3\n"),
    "reopened": 'pcclt_a 1\npcclt_b 2\npcclt_a{x="1"} 3\n',
    "duplicate series": 'pcclt_a{x="1"} 1\npcclt_a{x="1"} 2\n',
    "unterminated": 'pcclt_a{x="oops} 1\n',
    "bad value": "pcclt_a one\n",
    "non-monotone": (
        "# TYPE pcclt_h histogram\n"
        'pcclt_h_bucket{le="0.1"} 5\npcclt_h_bucket{le="1"} 3\n'
        'pcclt_h_bucket{le="+Inf"} 5\npcclt_h_sum 1\npcclt_h_count 5\n'),
    "!= _count": (
        "# TYPE pcclt_h histogram\n"
        'pcclt_h_bucket{le="+Inf"} 4\npcclt_h_sum 1\npcclt_h_count 5\n'),
    "missing +Inf": (
        "# TYPE pcclt_h histogram\n"
        'pcclt_h_bucket{le="1"} 4\npcclt_h_sum 1\npcclt_h_count 4\n'),
}


@pytest.mark.parametrize("case", sorted(PROM_TEXTS))
def test_promlint_agrees_with_the_jax_copy(case):
    text = PROM_TEXTS[case]
    found = promlint.lint(text)
    assert found == jax_promlint.lint(text)
    if case == "valid":
        assert found == []
        promlint.assert_valid(text)
    else:
        # the finding the JAX tests look for is there too
        assert any(case in e for e in found), (case, found)
        with pytest.raises(AssertionError):
            promlint.assert_valid(text)


LOG_CODE = """
import importlib, sys
mod = importlib.import_module(sys.argv[1])
mod.trace("t"); mod.debug("d"); mod.info("i"); mod.warn("w"); mod.error("e")
mod.set_level("error"); mod.warn("w2"); mod.error("e2")
mod.set_level("nonsense"); mod.info("i3"); mod.error("e3")
"""


@pytest.mark.parametrize("level", ["TRACE", "DEBUG", "INFO", "WARN", "ERROR",
                                   "FATAL", "bogus", None])
def test_logger_levels_match_the_jax_logger(level):
    """Each logger in a fresh process under one PCCLT_LOG_LEVEL: the same
    messages pass at the same levels, in the same format."""
    env = {k: v for k, v in os.environ.items() if k != "PCCLT_LOG_LEVEL"}
    if level is not None:
        env["PCCLT_LOG_LEVEL"] = level

    def lines(module):
        r = subprocess.run([sys.executable, "-c", LOG_CODE, module], cwd=REPO,
                           env=env, capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        # [HH:MM:SS][LEVEL][py:TID] message: drop the clock and thread
        return [re.sub(r"^\[[\d:]+\](\[ *\w+\])\[py:\d+\]", r"\1", ln)
                for ln in r.stderr.splitlines()]

    got = lines("pccl_tpu_torch.utils.logging")
    assert got == lines("pccl_tpu.utils.logging")
    assert all(re.match(r"^\[ *[A-Z]+\] \w+$", ln) for ln in got), got
    assert "[ERROR] e2" in got and "[ WARN] w2" not in got


def test_logger_fatal_exits():
    r = subprocess.run(
        [sys.executable, "-c",
         "from pccl_tpu_torch.utils import logging as L; L.fatal('x')"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 1 and "[FATAL]" in r.stderr


def test_build_info_matches_the_jax_package():
    import pccl_tpu.version as jax_version
    import pccl_tpu_torch

    info = dict(pccl_tpu_torch.BUILD_INFO)
    assert info.pop("name") == "pccl_tpu_torch"
    ref = dict(jax_version.BUILD_INFO)
    ref.pop("name")
    assert info == ref
    assert pccl_tpu_torch.__version__ == jax_version.__version__
