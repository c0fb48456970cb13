"""The tensor-parallel DDP peer (`train_ddp --tp N`) over a real master on
the CPU: a peer of 2 ranks (the process and the rank it spawns) beside a
one-rank torch peer, and beside the JAX package's `--tp 2` peer
(examples/nanogpt_ddp/train_ddp.py on a 2-device virtual CPU mesh).

A one-rank and a two-rank torch peer start from the same seed and get the
same averaged gradient from the ring, whose vector is the full tensors in
codec order on both; AdamW is elementwise, so their states stay bitwise
equal: every sync moves 0 bytes and the final params_blake2b (over the
gathered parameters) agree.

The JAX and the torch tp peers start from different inits, so their first
sync makes one adopt the other's state; their optimizers round
differently, so later syncs move the differing entries again. Each sync
leaves both with one state (the receiver checks every entry against the
sender's H1 digest), and the torch peer draws the JAX peer's batches
(--data-shard). The JAX example prints no digest, so both save their
state after every step (the torch peer its blocks gathered to rank 0),
and each pair of checkpoints must agree entry by entry to one AdamW
update's rounding. A torch peer that never syncs, started from its own
seed on the same batches, is the control: it fails that bound.

The JAX example's process aborts at exit in some runs, after its FINAL
line ("terminate called ... FATAL: exception not rethrown", SIGABRT), with
a torch or a JAX peer beside it and at --tp 1 or 2: a fault of the
reference's teardown (ROADMAP.md §3), so that one exit is allowed there.

The library is built once into pccl_tpu_torch/build/ (under a lock); the
tests skip only without g++.
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
JAX_PEER = REPO / "examples" / "nanogpt_ddp" / "train_ddp.py"
# below the kernel's ephemeral range, away from the other files' ranges
MASTER_PORTS = {"torch": 24500, "mixed": 24510}
PEER_BASE = {"torch": 24600, "mixed": 24700}
LINE = re.compile(r"^step (\d+) loss (\S+) world (\d+) revision \d+ tok_s \S+ "
                  r"ring_s \S+ sync_s \S+(?: gather_s \S+ rank_launches \S+)? "
                  r"tx (\d+) rx (\d+) "
                  r"launches \d+ \d+ \d+ \d+ digest (\w+)$", re.M)
JAX_LINE = re.compile(r"^step (\d+) loss (\S+) world (\d+)$", re.M)


def _lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _run(run: str, peers: list, timeout: float = 300,
         abort_at_exit=()) -> list:
    """A master and the peers (argument lists after the interpreter, each
    with its extra env), on the ports of `run`; returns their outputs.
    Each must exit 0; a peer in abort_at_exit may instead die of SIGABRT
    after its FINAL line, at the reference's teardown."""
    lib = _lib()
    env = dict(os.environ, PCCLT_LIB=str(lib), OMP_NUM_THREADS="1",
               PCCLT_SS_HASH="simple-tpu", JAX_PLATFORMS="cpu",
               PYTHONUNBUFFERED="1")
    port = MASTER_PORTS[run]
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    procs = []
    try:
        for i, (cmd, extra) in enumerate(peers):
            procs.append(subprocess.Popen(
                [sys.executable, *cmd, "--master-port", str(port),
                 "--base-port", str(PEER_BASE[run] + 16 * i), "--min-world",
                 str(len(peers))],
                cwd=REPO, env={**env, **extra}, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs + [master]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        torn = i in abort_at_exit and p.returncode == -6 and re.search(
            r"^FINAL .*\n(?:.*\n)*?FATAL: exception not rethrown", out, re.M)
        assert p.returncode == 0 or torn, out[-3000:]
    return outs


TORCH = ["-m", "pccl_tpu_torch.examples.train_ddp", "--device", "cpu",
         "--model", "nano"]


def _final_blake2b(out: str) -> str:
    return re.search(r"params_blake2b=(\w+)", out).group(1)


def test_tp1_and_tp2_peers_stay_bit_identical():
    """The --tp 2 peer stages its gathered gradient through registered shm,
    the --tp 1 peer through a pinned buffer."""
    outs = _run("torch", [(TORCH + ["--steps", "6", "--tp", "1"], {}),
                          (TORCH + ["--steps", "6", "--tp", "2",
                                    "--shm-staging"], {})])
    rows = [{int(r[0]): r[1:] for r in LINE.findall(out)} for out in outs]
    assert sorted(rows[0]) == sorted(rows[1]) == list(range(6))
    assert "gather_s" in outs[1] and "gather_s" not in outs[0]
    for s in range(6):
        for r in rows:
            assert r[s][1] == "2", s                # world
            assert r[s][2:4] == ("0", "0"), s       # tx, rx: states equal
    assert _final_blake2b(outs[0]) == _final_blake2b(outs[1])


def _jax_checkpoints(directory: Path, steps) -> dict:
    """The JAX example's {params, opt_state} at each step, restored by the
    JAX package's Checkpointer into the example's own template (the nano
    GPT on a (dp, tp) = (1, 2) mesh of the test's virtual devices)."""
    import jax

    from pccl_tpu.models import gpt as jax_gpt
    from pccl_tpu.parallel import mesh as jax_mesh
    from pccl_tpu.parallel.train import make_train_state
    from pccl_tpu.utils.checkpoint import Checkpointer

    cfg = jax_gpt.named_config("nano", block_size=64)
    mesh = jax_mesh.make_mesh(jax.devices()[:2], ("dp", "tp"), (1, 2))
    params, _, opt_state = make_train_state(jax.random.PRNGKey(0), cfg, mesh,
                                            lr=1e-3)
    ck = Checkpointer(str(directory))
    try:
        return {s: ck.restore({"params": params, "opt_state": opt_state}, s)
                for s in steps}
    finally:
        ck.close()


def _worst(jax_tree, torch_tree) -> float:
    """The largest |torch - jax| over every entry of two {params,
    opt_state} checkpoints, in units of one AdamW update's rounding:
    rtol 1e-5 of the entry plus 1e-6 of its tensor's largest magnitude.
    1 or less: the same state."""
    import jax
    import numpy as np
    import torch

    got = torch.load(torch_tree, weights_only=True)
    assert sorted(got["params"]) == sorted(jax_tree["params"])
    pairs = [(jax_tree["params"][n], got["params"][n]) for n in sorted(got["params"])]
    leaves = jax.tree.leaves(jax_tree["opt_state"])
    assert len(leaves) == len(got["opt_state"])
    pairs += list(zip(leaves, got["opt_state"]))
    worst = 0.0
    for want, have in pairs:
        want = np.asarray(want, np.float64)
        have = have.numpy().astype(np.float64)
        assert want.shape == have.shape
        bound = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max() + 1e-30
        worst = max(worst, float((np.abs(have - want) / bound).max()))
    return worst


def test_jax_tp2_peer_and_torch_tp2_peer_share_a_group(tmp_path):
    jax_base = PEER_BASE["mixed"]          # the JAX peer is peer 0
    ck = ["--checkpoint-every", "1"]
    outs = _run("mixed", [
        ([str(JAX_PEER), "--steps", "3", "--tp", "2", "--checkpoint-dir",
          str(tmp_path / "jax"), *ck],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}),
        (TORCH + ["--steps", "3", "--tp", "2", "--data-shard", str(jax_base),
                  "--checkpoint-dir", str(tmp_path / "torch"), *ck], {}),
    ], timeout=400, abort_at_exit=(0,))
    jrows = {int(s): (float(loss), w) for s, loss, w in JAX_LINE.findall(outs[0])}
    rows = {int(r[0]): r[1:] for r in LINE.findall(outs[1])}
    assert sorted(jrows) == sorted(rows) == [0, 1, 2], outs[1][-3000:]
    for s in range(3):
        assert jrows[s][1] == rows[s][1] == "2", s
        assert abs(float(rows[s][0]) - jrows[s][0]) <= 2e-2, (s, rows[s], jrows[s])
        # the optimizers round differently: every sync moves bytes one way
        tx, rx = int(rows[s][2]), int(rows[s][3])
        assert (tx > 0) != (rx > 0), (s, rows[s])
    # the torch peer adopted the JAX state at least once (its scatter ran)
    assert any(int(rows[s][3]) > 0 for s in range(3)), rows
    assert re.search(r"FINAL first_loss=\S+ last_loss=", outs[0])

    # a torch peer that never syncs: its own init on the same batches
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    r = subprocess.run(
        [sys.executable, *TORCH, "--solo", "--steps", "1", "--tp", "2",
         "--data-shard", str(jax_base), "--no-descent-check", "--checkpoint-dir",
         str(tmp_path / "alone"), *ck],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]

    jax_trees = _jax_checkpoints(tmp_path / "jax", (1, 2, 3))
    for s in (1, 2, 3):
        worst = _worst(jax_trees[s], tmp_path / "torch" / str(s) / "tree.pt")
        assert worst <= 1.0, (s, worst)
    control = _worst(jax_trees[1], tmp_path / "alone" / "1" / "tree.pt")
    assert control > 1.0, control


def test_tp2_peer_resumes_from_a_gathered_checkpoint(tmp_path):
    """A solo --tp 2 peer with accumulation and eval saves at step 3 (its
    blocks gathered to rank 0), a restart resumes there (the checkpoint
    scattered back to both ranks), and ends bit-equal with a run that
    never stopped."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    args = TORCH + ["--solo", "--tp", "2", "--batch", "2", "--grad-accum", "2",
                    "--eval-every", "2", "--eval-batches", "1",
                    "--no-descent-check"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"]

    def run(extra):
        r = subprocess.run([sys.executable, *args, *extra], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
        return r.stdout

    first = run(["--steps", "3", *ck])
    assert re.search(r"^checkpoint step 3 bytes \d+ save_s \S+$", first, re.M), first
    resumed = run(["--steps", "6", *ck])
    assert re.search(r"^resumed from step 3 restore_s \S+$", resumed, re.M), resumed
    assert re.findall(r"^step (\d+) ", resumed, re.M) == ["3", "4", "5"]
    assert re.findall(r"^eval step (\d+) ", resumed, re.M) == ["3", "5"]
    whole = run(["--steps", "6"])
    assert _final_blake2b(resumed) == _final_blake2b(whole)
