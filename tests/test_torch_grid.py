"""The port's 2D-grid example (pccl_tpu_torch.examples.grid_diloco) over a
real master, mirroring tests/test_grid_fsdp.py with torch cells on the CPU
(`--device cpu --attn dense`, the nano preset at the JAX test's size), and
one mixed grid whose column 0 is the JAX package's cells
(examples/grid_fsdp/grid_diloco.py, unmodified, on a 2-device virtual CPU
mesh) and column 1 torch cells, sharing one master and one grid file.

Cells are OS processes on loopback. Torch cells on the CPU run an outer
step in tens of milliseconds, far less than a process takes to start, so
the late-join and killed-column scenarios pause the incumbents (SIGSTOP)
while the joiners come up or the victims die, instead of sleeping and
hoping the run is still going.

The library is built once into pccl_tpu_torch/build/ (under a lock); the
tests skip only without g++.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pccl_tpu_torch.examples.grid_diloco import GridFile
from pccl_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
JAX_CELL = REPO / "examples" / "grid_fsdp" / "grid_diloco.py"
SIZE = ["--inner-steps", "4", "--batch", "4", "--block", "32"]
LINE = re.compile(
    r"^outer (\d+) loss (\S+) grid (\d+)x(\d+) global (\d+) shard (\d+) "
    r"\[(\d+):(\d+)\] tok_s \S+ outer_s \S+ launches \d+ \d+ \d+ "
    r"digest (\w+) tx (\d+) rx (\d+)$", re.M)

# ports of this file: below the kernel's ephemeral range, away from the
# ranges the other test files use; each test takes a fresh block of 128
_NEXT_PORT = [26000]


def _ports() -> int:
    p = _NEXT_PORT[0]
    _NEXT_PORT[0] += 128
    return p


def _lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


@pytest.fixture
def master():
    lib = _lib()
    from pccl_tpu_torch.comm import MasterNode

    base = _ports()
    m = MasterNode("127.0.0.1", base)
    m.run()
    m.lib = lib
    m.cell_base = base + 16
    yield m
    m.interrupt()
    m.destroy()


def _spawn(master, grid_file, shard, slot, *, jax=False, min_replicas=1,
           outer_steps=4):
    """One cell: a torch cell, or with jax=True the JAX package's."""
    env = dict(os.environ, PCCLT_LIB=str(master.lib), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    if jax:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        cmd = [sys.executable, str(JAX_CELL)]
    else:
        cmd = [sys.executable, "-m", "pccl_tpu_torch.examples.grid_diloco",
               "--device", "cpu", "--attn", "dense"]
    cmd += ["--master-port", str(master.port), "--num-shards", "2",
            "--peer-group", str(shard),
            "--base-port", str(master.cell_base + slot * 16),
            "--grid-file", grid_file, "--min-replicas", str(min_replicas),
            "--outer-steps", str(outer_steps), "--connect-timeout", "600",
            *SIZE]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def _finish(procs, timeout=300) -> list:
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        _kill(procs)


def _final(out: str) -> dict:
    m = re.search(r"^FINAL (.*)$", out, re.M)
    assert m, f"no FINAL line:\n{out[-3000:]}"
    return dict(kv.split("=") for kv in m.group(1).split())


def _descends(proc, out):
    assert proc.returncode == 0, f"grid cell failed:\n{out[-3000:]}"
    f = _final(out)
    assert float(f["last_loss"]) < float(f["first_loss"]), out[-3000:]


def _wait_seq(grid_file, step, procs, timeout=120.0) -> None:
    """Until every shard's sequence in the grid file is >= step."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            # [magic, G, count, seq0, seq1]
            hdr = np.fromfile(grid_file, dtype=np.int64, count=5)
            if len(hdr) == 5 and (hdr[3:] >= step).all():
                return
        except OSError:
            pass
        assert all(p.poll() is None for p in procs), "a cell ended early"
        time.sleep(0.005)
    raise TimeoutError(f"the grid never reached step {step}")


def _signal(procs, sig) -> None:
    for p in procs:
        p.send_signal(sig)


def test_grid_2x2_trains(master, tmp_path):
    """The full grid, 2 groups x 2 replicas: every cell sees it, trains,
    and the two cells of a group print equal shard digests at every outer
    step, with 0-byte syncs."""
    grid_file = str(tmp_path / "grid.bin")
    procs = [_spawn(master, grid_file, g, 2 * g + r, min_replicas=2)
             for g in (0, 1) for r in (0, 1)]
    outs = _finish(procs)
    rows = []
    for p, out in zip(procs, outs):
        _descends(p, out)
        assert "grid 2x2 global 4" in out
        rows.append(LINE.findall(out))
        assert len(rows[-1]) == 4
        assert all(r[9:11] == ("0", "0") for r in rows[-1][1:])
        assert _final(out)["last_sync_tx"] == "0"
    for g in (0, 1):
        a, b = rows[2 * g], rows[2 * g + 1]
        assert [r[8] for r in a] == [r[8] for r in b]
        assert all(r[5] == str(g) for r in a + b)
    assert not os.path.exists(grid_file)  # removed at the end of the run


def test_grid_late_column_join(master, tmp_path):
    """A second column joins mid-run: the gate holds the run until both
    its cells are admitted, the joiners adopt their group's shard and
    revision, and everyone ends at the same revision."""
    grid_file = str(tmp_path / "grid.bin")
    incumbents = [_spawn(master, grid_file, g, g, outer_steps=6)
                  for g in (0, 1)]
    procs = list(incumbents)
    try:
        _wait_seq(grid_file, 1, incumbents)   # progress as a 2x1 grid
        _signal(incumbents, signal.SIGSTOP)
        procs += [_spawn(master, grid_file, g, 2 + g, outer_steps=6)
                  for g in (0, 1)]
        deadline = time.time() + 120
        while master.health()["clients"] < 4:
            assert time.time() < deadline, "the joiners never registered"
            time.sleep(0.1)
        _signal(incumbents, signal.SIGCONT)
        outs = _finish(procs)
    finally:
        _signal(incumbents, signal.SIGCONT)
        _kill(procs)
    for p, out in zip(procs, outs):
        _descends(p, out)
        assert _final(out)["last_sync_tx"] == "0"
    assert any("grid 2x2 global 4" in out for out in outs)
    for out in outs[2:]:
        # a joiner adopted a revision past 0: its first line is later
        first = LINE.search(out)
        assert first and int(first.group(1)) > 1, out[-3000:]


def test_grid_survives_killed_column(master, tmp_path):
    """SIGKILL a whole replica column (the grid's failure unit) mid-run:
    once the master drops the dead cells the grid is rectangular at width
    1, each group's ring retries down to its survivor, and column 0
    finishes."""
    grid_file = str(tmp_path / "grid.bin")
    procs = [_spawn(master, grid_file, g, 2 * g + r, min_replicas=2,
                     outer_steps=6) for g in (0, 1) for r in (0, 1)]
    survivors, victims = [procs[0], procs[2]], [procs[1], procs[3]]
    try:
        _wait_seq(grid_file, 1, procs)        # the grid formed and stepped
        _signal(procs, signal.SIGSTOP)
        for v in victims:
            v.kill()
            v.wait(timeout=30)
        _signal(survivors, signal.SIGCONT)
        outs = _finish(survivors)
    finally:
        _kill(procs)
    for p, out in zip(survivors, outs):
        _descends(p, out)
        assert "grid 2x1 global 2" in out   # went on without column 1


def test_grid_file_lifecycle(tmp_path):
    """GridFile: atomic init with -1 sentinels, publish and wait order,
    attach to a compatible file, a loud refusal of an incompatible one."""
    path = str(tmp_path / "g.bin")
    g = GridFile(path, 2, 100)
    assert list(g.seq) == [-1, -1]
    data = np.arange(50, dtype=np.float32)
    g.publish(0, 3, data)
    assert g.seq[0] == 3 and g.seq[1] == -1
    h = GridFile(path, 2, 100)
    np.testing.assert_array_equal(h.read_full()[:50], data)
    h.publish(1, 3, np.zeros(50, np.float32))
    g.wait_all(3, timeout=5)
    with pytest.raises(TimeoutError, match="stuck below step 4"):
        g.wait_all(4, timeout=0.05)
    with pytest.raises(RuntimeError, match="grid file"):
        GridFile(path, 2, 200)
    # the same byte size (8*(3+4)+4*96 == 8*(3+2)+4*100), another layout:
    # the identity header catches what the size check cannot
    with pytest.raises(RuntimeError, match="identity mismatch"):
        GridFile(path, 4, 96)
    g.remove()
    g.remove()  # idempotent
    assert not (tmp_path / "g.bin").exists()


def test_mixed_jax_and_torch_grid(master, tmp_path):
    """Column 0 JAX cells, column 1 torch cells, one master and one grid
    file. After the first sync (the two frameworks draw other initial
    weights, so it settles each group on one), every sync of a torch cell
    moves 0 bytes: a JAX replica whose shard differed by one bit would
    make its sync send or receive. The torch cell's last digest is the
    BLAKE2b of its shard as the grid file holds it at the end."""
    import torch

    from pccl_tpu_torch.models import gpt
    from pccl_tpu_torch.parallel.codec import build_codec

    grid_file = str(tmp_path / "grid.bin")
    cfg = gpt.named_config("nano", block_size=32)
    count = build_codec(gpt.init_params(torch.Generator().manual_seed(0),
                                         cfg)).count
    # mapped before the cells run and kept: the cells unlink the file at
    # the end, and this mapping still reads what they left
    grid = GridFile(grid_file, 2, count)
    procs = [_spawn(master, grid_file, g, 2 * g + r, jax=r == 0,
                    min_replicas=2) for g in (0, 1) for r in (0, 1)]
    outs = _finish(procs, timeout=420)
    for p, out in zip(procs, outs):
        _descends(p, out)
        assert "grid 2x2 global 4" in out
    for g in (0, 1):
        out = outs[2 * g + 1]                 # the group's torch cell
        rows = LINE.findall(out)
        assert len(rows) == 4, out[-3000:]
        assert all(r[9:11] == ("0", "0") for r in rows[1:]), rows
        f = _final(out)
        assert (f["last_sync_tx"], f["last_sync_rx"]) == ("0", "0"), f
        lo, hi = grid.bounds[g], grid.bounds[g + 1]
        assert (int(rows[-1][6]), int(rows[-1][7])) == (lo, hi)
        shard = np.array(grid.vec[lo:hi])
        assert rows[-1][8] == hashlib.blake2b(shard.data,
                                              digest_size=16).hexdigest()
