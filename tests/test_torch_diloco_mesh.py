"""DiLoCo peers of several ranks (`--ranks N` of the port's sync_diloco,
async_diloco and grid_diloco) over a real master on the CPU, beside
one-rank torch peers and JAX peers on N virtual devices.

A peer of N ranks holds its outer state on rank 0 as the full fp32
vector in the codec order of the full tensors, which is what the JAX
Diloco flattens from its global arrays; so every peer of a ring puts
every element at the same index, and the peers, applying one averaged
pseudo-gradient to one outer state, print equal digests at every outer
step, bit for bit. The JAX peers run the JAX package's Diloco and
AsyncDiloco over a (dp, tp) mesh of N devices (this file run as a script,
`--jax-peer`, with XLA_FLAGS set to N devices: the test process's 8
would leak into it), from the torch init of the same seed, passed
through numpy, since the outer states must start equal; the JAX grid
cell is the JAX package's example itself, whose group's first sync
settles the two inits. The JAX examples print no digest. Two cases run
in gloo worlds of spawned ranks (tests/torch_ranks.py) instead of the
examples: a joiner's adoption (Diloco.sync_shared_state) on a peer of 2
ranks, its comm a stand-in that plays the election's winner, and a peer
of 8 ranks ((dp, tp) = (2, 4)) alone, against one rank alone, in fp32
(the examples compute in bf16).

Tolerances: digests exact; the 8-rank and the 1-rank peer end 2 outer
steps on the same batches with outer vectors within 1e-4 of each other
(max |difference|): their inner steps sum in other orders, in fp32. At
the examples' inner lr 1e-3 the largest difference is 6.7e-6, and 9 of
115,008 elements exceed 1e-6: AdamW divides by the root of a second
moment that is near zero there, which scales up the summation order (at
lr 3e-3, 2.0e-5). A peer whose dp row 1 misses the scatter's broadcast
reads 2.8e-3. The scenarios and the worlds run at once, each a process
group of its own, so that the file takes about as long as its slowest.

The library is built once into pccl_tpu_torch/build/ (under a lock); the
tests skip only without g++.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pccl_tpu_torch.models import gpt
from pccl_tpu_torch.parallel.codec import build_codec

REPO = Path(__file__).resolve().parent.parent
JAX_CELL = REPO / "examples" / "grid_fsdp" / "grid_diloco.py"
# below the kernel's ephemeral range, away from the other files' ranges;
# each scenario takes a block of 64
PORT_BASE = 29000
SIZE = ["--inner-steps", "3", "--batch", "4", "--block", "32"]
LINE = re.compile(r"^outer (\d+) loss (\S+) .*digest (\w+)", re.M)
TIMEOUT_S = 240


def _jax_common():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_common", REPO / "examples" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the JAX peer


def _jax_peer(argv) -> int:
    """A JAX DiLoCo peer over every local device, from the torch init of
    --seed; prints `mesh ...`, then `outer N loss L digest D` each outer
    step (and `FINAL digest D` after an async finish)."""
    common = _jax_common()
    ap = argparse.ArgumentParser()
    common.add_comm_args(ap)
    common.add_data_args(ap)
    common.add_model_args(ap)
    ap.add_argument("--kind", choices=["sync", "async"], default="sync")
    ap.add_argument("--outer-steps", type=int, default=3)
    ap.add_argument("--inner-steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    common.force_cpu_if_requested()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pccl_tpu.parallel import diloco, mesh as jmesh, train as jtrain
    from pccl_tpu_torch.examples import common as tcommon
    from pccl_tpu_torch.models import family

    mesh = jmesh.make_mesh(jax.devices(), ("dp", "tp"))
    cfg = common.model_config(args, char_level=False)
    tcfg = tcommon.model_config(args)
    init = family(tcfg).init_params(torch.Generator().manual_seed(args.seed), tcfg)
    _, tx, _ = jtrain.make_train_state(jax.random.PRNGKey(args.seed), cfg, mesh,
                                       lr=args.inner_lr)
    sh = jtrain.family(cfg)[1](mesh, cfg)
    params = {k: jax.device_put(jnp.asarray(v.numpy()), sh[k]) for k, v in init.items()}
    opt_state = tx.init(params)
    step_fn = jtrain.build_train_step(cfg, tx, mesh)
    data = jmesh.batch_sharding(mesh)
    comm = common.connect(args)
    print(f"mesh {dict(mesh.shape)}", flush=True)
    dcfg = diloco.DilocoConfig(inner_steps=args.inner_steps, outer_lr=args.outer_lr,
                               **({} if args.kind == "sync" else {"outer_momentum": 0.0}))
    dl = (diloco.Diloco if args.kind == "sync" else diloco.AsyncDiloco)(comm, params,
                                                                      dcfg)

    def digest():
        vec = np.asarray(jax.device_get(dl._outer_vec), dtype=np.float32)
        return hashlib.blake2b(vec.data, digest_size=16).hexdigest()

    next_batch = common.make_batch_fn(args, cfg.vocab_size)
    for outer in range(args.outer_steps):
        if comm.are_peers_pending():
            comm.update_topology()
        for _ in range(args.inner_steps):
            tok, tgt = (jax.device_put(jnp.asarray(a), data) for a in next_batch())
            params, opt_state, loss = step_fn(params, opt_state, tok, tgt)
        params = dl.outer_step(params) if args.kind == "sync" \
            else dl.outer_step_async(params)
        print(f"outer {outer} loss {float(loss):.4f} digest {digest()}", flush=True)
    if args.kind == "async":
        dl.finish()
        print(f"FINAL digest {digest()}", flush=True)
    comm.destroy()
    return 0


# ------------------------------------------------------------ scenarios


def _env(lib, jax_devices=None) -> dict:
    env = dict(os.environ, PCCLT_LIB=str(lib), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    if jax_devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={jax_devices}"
    return env


def _torch(example: str, *args) -> tuple:
    return (["-m", f"pccl_tpu_torch.examples.{example}", "--device", "cpu",
             "--attn", "dense", *args], None)


def _jax(kind: str, devices: int, *args) -> tuple:
    return ([str(Path(__file__).resolve()), "--jax-peer", "--kind", kind, *args],
            devices)


def _jax_cell(devices: int, *args) -> tuple:
    return ([str(JAX_CELL), *args], devices)


class Scenario:
    """A master (unless solo) and peers, each peer with --master-port and
    its own --base-port (or --solo), started at once; a thread waits for
    them, then runs the peers of `then`, if any, the same way.
    `outputs()` returns every peer's output in order, with their exit
    codes in `codes`."""

    def __init__(self, lib, index: int, peers: list, solo: bool = False,
                 then=None):
        self.lib, self.solo = lib, solo
        self.port = PORT_BASE + 64 * index
        self.master = None
        self.procs = []
        self._outs = self._err = None
        if not solo:
            self.master = subprocess.Popen(
                [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
                 "127.0.0.1", "--port", str(self.port)], cwd=REPO,
                env=_env(lib), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        self._start(peers)
        self._thread = threading.Thread(target=self._run, args=(then,), daemon=True)
        self._thread.start()

    def _start(self, peers) -> None:
        for i, (cmd, devices) in enumerate(peers):
            comm = ["--solo"] if self.solo else [
                "--master-port", str(self.port),
                "--base-port", str(self.port + 16 + 12 * i)]
            self.procs.append(subprocess.Popen(
                [sys.executable, *cmd, *comm], cwd=REPO, env=_env(self.lib, devices),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def _wait(self) -> tuple:
        deadline = time.monotonic() + TIMEOUT_S
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in self.procs]
        codes = [p.returncode for p in self.procs]
        self.procs = []
        return outs, codes

    def _run(self, then) -> None:
        try:
            outs, codes = self._wait()
            if then is not None:
                self._start(then)
                more, more_codes = self._wait()
                outs, codes = outs + more, codes + more_codes
            self._outs, self.codes = outs, codes
        except BaseException as e:  # noqa: BLE001 - raised again in outputs()
            self._err = e
        finally:
            self.stop()

    def outputs(self) -> list:
        self._thread.join(timeout=2 * TIMEOUT_S + 60)
        if self._err is not None:
            raise self._err
        assert self._outs is not None, "the scenario did not finish"
        return self._outs

    def stop(self) -> None:
        for p in self.procs + ([self.master] if self.master else []):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _lib():
    from pccl_tpu_torch.ops import _build

    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


@pytest.fixture(scope="module")
def runs():
    lib = _lib()
    tmp = Path(tempfile.mkdtemp(prefix="pcclt_mesh_test_"))
    two = ["--min-world", "2", "--outer-steps", "3", *SIZE]
    # the resumed run's one outer step cannot show a falling loss
    resume = [*SIZE, "--ranks", "2", "--checkpoint-every", "1",
              "--checkpoint-dir", str(tmp / "resume"), "--no-descent-check"]
    specs = {
        "sync_jax": dict(peers=[_torch("sync_diloco", "--ranks", "2", *two),
                                _jax("sync", 2, *two)]),
        "sync_1_2": dict(peers=[_torch("sync_diloco", "--ranks", "2", *two),
                                _torch("sync_diloco", "--ranks", "1", *two)]),
        "llama_jax": dict(peers=[
            _torch("sync_diloco", "--ranks", "4", "--family", "llama",
                   "--model", "tiny", *two),
            _jax("sync", 4, "--family", "llama", "--model", "tiny", *two)]),
        "async_jax": dict(peers=[_torch("async_diloco", "--ranks", "2", *two),
                                 _jax("async", 2, *two)]),
        "grid_jax": dict(peers=[
            _torch("grid_diloco", "--ranks", "2", "--num-shards", "1",
                   "--min-replicas", "2", "--outer-steps", "3",
                   "--grid-file", str(tmp / "grid.bin"), *SIZE),
            _jax_cell(2, "--num-shards", "1", "--min-replicas", "2",
                      "--outer-steps", "3", "--grid-file",
                      str(tmp / "grid.bin"), *SIZE)]),
        "resume": dict(solo=True, peers=[
            _torch("sync_diloco", "--outer-steps", "2", *resume)],
            then=[_torch("sync_diloco", "--outer-steps", "3", *resume)]),
    }
    got = {}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        for i, (name, spec) in enumerate(specs.items()):
            got[name] = Scenario(lib, i, **spec)
        # while the scenarios run: a peer of 8 ranks alone, in a gloo
        # world of 8 spawned ranks, and a joiner's adoption on a peer of
        # 2 ranks, in a world of 2
        got["dp_tp"] = pool.submit(_dp_tp_world)
        got["adoption"] = _adoption_world()
        yield got, tmp
    finally:
        pool.shutdown(wait=True)
        for s in got.values():
            if isinstance(s, Scenario):
                s.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _outputs(runs, name: str) -> list:
    scenario = runs[0][name]
    outs = scenario.outputs()
    for code, out in zip(scenario.codes, outs):
        assert code == 0, out[-4000:]
    return outs


def _digests(out: str) -> list:
    return [m[2] for m in LINE.findall(out)]


def _mesh(out: str, dp: int, tp: int) -> None:
    devices = " ".join(["cpu"] * (dp * tp))
    assert f"mesh dp {dp} tp {tp} devices {devices}" in out, out[-4000:]


def test_ranks2_peer_and_jax_peer_on_2_devices_agree(runs):
    """A torch sync peer at --ranks 2 ((dp, tp) = (1, 2)) and a JAX
    sync peer on 2 devices share one ring: equal digests at every
    outer step."""
    torch_out, jax_out = _outputs(runs, "sync_jax")
    _mesh(torch_out, 1, 2)
    assert "mesh {'dp': 1, 'tp': 2}" in jax_out, jax_out[-4000:]
    assert len(_digests(torch_out)) == 3
    assert _digests(torch_out) == _digests(jax_out), (torch_out, jax_out)
    assert re.search(r"gather_s \S+ scatter_s \S+ rank_launches "
                     r"0,0,0/0,0,0$", torch_out, re.M), torch_out[-4000:]


def test_ranks2_and_ranks1_peers_agree(runs):
    """A --ranks 2 and a --ranks 1 torch peer in one ring: equal
    digests at every outer step, and both peers' losses fall."""
    two, one = _outputs(runs, "sync_1_2")
    assert len(_digests(two)) == 3 and _digests(two) == _digests(one)
    for out in (two, one):
        m = re.search(r"FINAL first_loss=(\S+) last_loss=(\S+)", out)
        assert m and float(m.group(2)) < float(m.group(1)), out[-4000:]


def test_ranks4_llama_sharing_kv_heads_and_jax_peer_agree(runs):
    """The tiny Llama (2 kv heads) at --ranks 4: tp=4, so pairs of
    ranks share a kv head; beside a JAX peer on 4 devices, equal
    digests at every outer step."""
    torch_out, jax_out = _outputs(runs, "llama_jax")
    _mesh(torch_out, 1, 4)
    assert len(_digests(torch_out)) == 3
    assert _digests(torch_out) == _digests(jax_out), (torch_out, jax_out)


DP_TP = dict(inner_steps=3, lr=1e-3)


def _dp_tp_batches() -> list:
    """The 2 outer steps' batches of the dp x tp case: the examples'
    synthetic data of shard 0, at their CPU test size."""
    from pccl_tpu_torch.examples.common import synth_batch

    rng = np.random.RandomState(1000)
    vocab = gpt.named_config("nano").vocab_size
    return [synth_batch(rng, 4, 32, vocab) for _ in range(2 * DP_TP["inner_steps"])]


def _dp_tp_world() -> list:
    import torch_ranks

    return torch_ranks.run_world(torch_ranks.dp_tp_cases,
                                 dict(DP_TP, batches=_dp_tp_batches()),
                                 world=8, timeout=180)


def test_ranks8_dp2_tp4_solo_run_matches_ranks1(runs):
    """A peer of 8 ranks ((dp, tp) = (2, 4): Diloco(shards=MeshShards),
    build_train_step(mesh=)) alone, against one rank alone on the same
    batches, fp32: the outer vectors after 2 outer steps within 1e-4,
    and moved from the init by ten times that or more; every rank, dp
    row 1 too, holds its blocks of the lead's outer vector."""
    import torch_ranks

    got = runs[0]["dp_tp"].result(timeout=240)
    ranks = [torch_ranks.result(got, "diloco", r) for r in range(8)]
    outer8 = ranks[0][0]
    assert all(r[0] is None for r in ranks[1:])
    outer1, _ = torch_ranks.diloco_run(_dp_tp_batches(), **DP_TP)
    init = gpt.init_params(torch.Generator().manual_seed(0),
                           gpt.named_config("nano", block_size=32))
    err = float(np.abs(outer8 - outer1).max())
    moved = float(np.abs(outer1 - build_codec(init).flat(init).numpy()).max())
    assert err <= 1e-4, err
    assert moved > 10 * 1e-4, moved
    lead = hashlib.blake2b(outer8.data, digest_size=16).hexdigest()
    assert [r[1] for r in ranks] == [lead] * 8


def test_ranks2_async_peer_and_jax_async_peer_agree(runs):
    """A torch async peer at --ranks 2 beside a JAX async peer on 2
    devices: equal digests at every outer step and after finish()."""
    torch_out, jax_out = _outputs(runs, "async_jax")
    _mesh(torch_out, 1, 2)
    assert len(_digests(torch_out)) == 3
    assert _digests(torch_out) == _digests(jax_out), (torch_out, jax_out)
    t = re.search(r"FINAL .*revision=3 digest=(\w+)", torch_out)
    j = re.search(r"^FINAL digest (\w+)$", jax_out, re.M)
    assert t and j and t.group(1) == j.group(1), (torch_out, jax_out)


def test_grid_cell_of_2_ranks_and_jax_cell_share_a_group(runs):
    """A --ranks 2 grid cell and a JAX cell on a (1, 2) mesh, one group
    and one grid file: after the first sync (the inits differ) every
    sync of the torch cell moves 0 bytes, so the JAX cell's shard is
    the torch cell's bit for bit."""
    torch_out, jax_out = _outputs(runs, "grid_jax")
    _mesh(torch_out, 1, 2)
    rows = re.findall(r"^outer (\d+) .* digest (\w+) tx (\d+) rx (\d+)"
                      r" gather_s \S+ scatter_s \S+ rank_launches \S+$",
                      torch_out, re.M)
    assert len(rows) == 3, torch_out[-4000:]
    assert all(r[2:4] == ("0", "0") for r in rows[1:]), rows
    f = re.search(r"^FINAL .*last_sync_tx=(\d+) last_sync_rx=(\d+)", torch_out,
                  re.M)
    assert f and f.groups() == ("0", "0"), torch_out[-4000:]
    assert "FINAL" in jax_out, jax_out[-4000:]


def _adoption_world():
    """(the adopted outer vector, each rank's results of
    torch_ranks.mesh_cases), or the exception that ended the world."""
    import torch_ranks
    from pccl_tpu_torch.models import llama

    cfg = llama.tiny_config()
    init = llama.init_params(torch.Generator().manual_seed(0), cfg)
    count = build_codec(init).count
    adopted = np.random.default_rng(3).standard_normal(count).astype(np.float32)
    try:
        return adopted, torch_ranks.run_world(
            torch_ranks.mesh_cases, {"adopted": adopted}, world=2, timeout=120)
    except Exception as e:  # noqa: BLE001 - raised again in the test
        return e


def test_adoption_on_a_peer_of_2_ranks_reaches_every_rank(runs):
    """Diloco.sync_shared_state on a peer of 2 ranks (tiny Llama, tp=2):
    the lead adopts the elected outer state and step, and each rank's
    blocks are the adopted parameters' (gathered,
    bitwise equal to them)."""
    import torch_ranks

    world = runs[0]["adoption"]
    if isinstance(world, Exception):
        raise world
    adopted, got = world
    lead, other = (torch_ranks.result(got, "adoption", r) for r in range(2))
    assert lead["info"] == "info" and other["info"] is None
    assert lead["step"] == 7
    assert lead["digest"] == hashlib.blake2b(adopted.data,
                                             digest_size=16).hexdigest()
    assert other["digest"] is None
    assert lead["equal"] and other["equal"]


def test_ranks2_resume_prints_the_digest_before_the_stop(runs):
    """A solo --ranks 2 run saves every outer step and stops after 2;
    the restarted run resumes from outer step 2 with the digest outer
    step 1 printed, and runs step 2."""
    first, second = _outputs(runs, "resume")
    before = _digests(first)
    assert len(before) == 2, first[-4000:]
    m = re.search(r"^resumed from outer step 2 digest (\w+) restore_s", second,
                  re.M)
    assert m and m.group(1) == before[-1], (first, second)
    assert [int(r[0]) for r in LINE.findall(second)] == [2], second[-4000:]


if __name__ == "__main__":
    if sys.argv[1:2] != ["--jax-peer"]:
        sys.exit("usage: test_torch_diloco_mesh.py --jax-peer [peer arguments]")
    sys.exit(_jax_peer(sys.argv[2:]))
