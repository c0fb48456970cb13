"""pccl_tpu_torch.parallel.diloco's AsyncDiloco, outer-step routes and
profile against pccl_tpu.parallel.diloco, comm.shm_ndarray, and the async
example.

Without a ring (comm=None) both packages run on the CPU and the outer vector
must be bit-equal: the port's apply is the JAX package's arithmetic as XLA
compiles it there. The native tests build libpcclt.so into
pccl_tpu_torch/build/ once (under a lock) and skip only where g++ is
missing.
"""

import dataclasses
import gc
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pccl_tpu.comm import _native as jax_native
from pccl_tpu.parallel import diloco as jdiloco
from pccl_tpu_torch.comm import _native
from pccl_tpu_torch.ops import _build
from pccl_tpu_torch.parallel import diloco

REPO = Path(__file__).resolve().parent.parent
# ports of this file: below the kernel's ephemeral range, away from the
# ranges the other test files use
MASTER_PORTS = {"pipelined": 32000, "async": 32010, "mixed": 32020, "e2e": 32030}
PEER_BASE = {"pipelined": 32100, "async": 32200, "mixed": 32300, "e2e": 32400}
PROFILE_KEYS = {
    "pipelined": ["delta_compute", "d2h_stage_ring_pipelined", "h2d_apply",
                  "unflat_out"],
    "staged": ["delta_compute", "d2h", "stage_copy", "ring_reduce", "h2d_apply",
               "unflat_out"],
}
PROFILE_KEYS["unstaged"] = PROFILE_KEYS["staged"]


def _lib():
    """libpcclt.so, built once into pccl_tpu_torch/build/ by the first
    test that needs it (the others wait on its lock)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _tree(seed=0, scale=1.0):
    """Leaves inserted out of sorted order, of several ranks."""
    rng = np.random.RandomState(seed)
    return {"z": (rng.randn(3, 4) * scale).astype(np.float32),
            "a": (rng.randn(5) * scale).astype(np.float32),
            "m": (rng.randn(2, 2, 2) * scale).astype(np.float32),
            "b": np.array(rng.randn() * scale, dtype=np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_config_fields_match_jax():
    want = [(f.name, f.default) for f in dataclasses.fields(jdiloco.DilocoConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(diloco.DilocoConfig)]
    # the enums are each package's own, with the same values
    assert [(n, int(d) if hasattr(d, "value") else d) for n, d in got] == \
        [(n, int(d) if hasattr(d, "value") else d) for n, d in want]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_async_without_comm_matches_jax_bit_for_bit(momentum):
    """Four delayed outer steps, finish(), then a fifth step and finish()
    again (its baseline is the outer vector the inner phase started from,
    before finish() applied the fourth update): the outer vector, the
    momentum and the params to continue from are bit-equal with JAX's.

    The JAX AsyncDiloco's baseline is its outer vector array itself, which its
    apply donates, so after finish() its next outer_step_async reads a
    deleted buffer and raises. The test hands it a fresh array of the same
    values, which is what its immutable-array semantics mean."""
    cfg_kw = dict(outer_lr=0.7, outer_momentum=momentum)
    jdl = jdiloco.AsyncDiloco(None, _jax(_tree(0)), jdiloco.DilocoConfig(**cfg_kw))
    tdl = diloco.AsyncDiloco(None, _torch(_tree(0)), diloco.DilocoConfig(**cfg_kw))
    jp, tp = _jax(_tree(0)), _torch(_tree(0))

    def inner(step):
        # an inner phase: the params to continue from, moved by fixed noise
        noise = _tree(100 + step, scale=0.1)
        for k in tp:
            tp[k].add_(torch.from_numpy(noise[k]))
        return {k: jnp.asarray(np.asarray(jp[k]) + noise[k]) for k in jp}

    def same():
        np.testing.assert_array_equal(tdl.outer_vec.numpy(),
                                      np.asarray(jdl._outer_vec))
        np.testing.assert_array_equal(tdl._momentum_vec.numpy(),
                                      np.asarray(jdl._momentum_vec))
        for k in tp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)

    for step in range(4):
        jp = jdl.outer_step_async(inner(step))
        assert tdl.outer_step_async(tp) is tp
        same()
        assert tdl.step == jdl.step == step
    base = np.array(jdl._baseline)
    jp = jdl.finish()
    assert tdl.finish(tp) is tp
    same()
    jdl._baseline = jnp.asarray(base)
    assert not torch.equal(tdl._baseline, tdl.outer_vec)   # kept its values
    jp = jdl.outer_step_async(inner(4))
    tdl.outer_step_async(tp)
    same()
    jp = jdl.finish()
    fresh = tdl.finish()
    tp = {k: v.clone() for k, v in tp.items()}
    tdl.copy_outer_into(tp)
    same()
    assert tdl.step == jdl.step == 5
    for k in fresh:
        assert torch.equal(fresh[k], tp[k])


def test_async_sync_resets_baseline(monkeypatch):
    """sync_shared_state joins the in-flight reduce and drops the
    pseudo-gradient baseline: adopted params make the old one bogus."""
    params = {"w": torch.zeros(4)}
    dl = diloco.AsyncDiloco(None, params)
    dl.outer_step_async(params)          # sets the baseline; no-comm reduce
    assert dl._baseline is not None and dl._inflight is not None
    monkeypatch.setattr(diloco.Diloco, "sync_shared_state",
                        lambda self, strategy=None: "info")
    assert dl.sync_shared_state() == "info"
    assert dl._baseline is None
    assert dl._inflight is None and dl.step == 1


def test_async_reduce_error_surfaces_on_join():
    params = {"w": torch.zeros(4)}
    dl = diloco.AsyncDiloco(None, params)

    def boom(host, out):
        raise RuntimeError("ring failed")

    dl._reduce_host = boom
    dl.comm = object()                  # route the thread through the ring
    dl.outer_step_async(params)
    with pytest.raises(RuntimeError, match="ring failed"):
        dl.finish()
    assert dl._inflight is None and dl.step == 0


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sync_outer_step_matches_jax_bit_for_bit(momentum):
    """The sync Diloco's apply, profiled and not: bit-equal with JAX's
    Diloco over three steps, and profile only records."""
    cfg_kw = dict(outer_lr=0.7, outer_momentum=momentum)
    jdl = jdiloco.Diloco(None, _jax(_tree(0)), jdiloco.DilocoConfig(**cfg_kw))
    plain = diloco.Diloco(None, _torch(_tree(0)), diloco.DilocoConfig(**cfg_kw))
    prof = diloco.Diloco(None, _torch(_tree(0)),
                         diloco.DilocoConfig(profile=True, **cfg_kw))
    for step in range(3):
        jdl.outer_step(_jax(_tree(10 + step)))
        plain.outer_step(_torch(_tree(10 + step)))
        prof.outer_step(_torch(_tree(10 + step)))
        np.testing.assert_array_equal(plain.outer_vec.numpy(), np.asarray(jdl._outer_vec))
        assert torch.equal(plain.outer_vec, prof.outer_vec)
    assert plain.last_profile is None
    p = prof.last_profile
    want = PROFILE_KEYS["unstaged"]
    assert sorted(p) == sorted(want + [k + "_cpu" for k in want] + ["total"])
    assert all(v >= 0 for v in p.values())
    assert p["total"] == pytest.approx(sum(p[k] for k in want))


class _FakeEvent:
    """torch.cuda.Event on the host: fires when recorded, on a clock that
    advances 1 ms a record."""

    clock_ms = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        assert stream == "main"
        _FakeEvent.clock_ms += 1.0
        self.t = _FakeEvent.clock_ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_profiled_outer_step_never_synchronizes(monkeypatch):
    """The card's profile path, run on the CPU with host-side events:
    `profile=True` makes no torch.cuda.synchronize call in an outer step,
    records one event a phase boundary on the current stream, reads each
    phase from event to event when last_profile is read, keeps the key set,
    and leaves the outer vector bit-equal with the unprofiled step's."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(a))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "main")
    # the host buffers of a card, unpinned: this torch has no CUDA
    monkeypatch.setattr(diloco.Diloco, "_pinned",
                        lambda self: torch.empty(self.count, dtype=torch.float32))
    plain = diloco.Diloco(None, _torch(_tree(0)))
    prof = diloco.Diloco(None, _torch(_tree(0)), diloco.DilocoConfig(profile=True))
    prof.device = torch.device("cuda")
    want = PROFILE_KEYS["unstaged"]
    for step in range(2):
        _FakeEvent.clock_ms = 0.0
        plain.outer_step(_torch(_tree(10 + step)))
        prof.outer_step(_torch(_tree(10 + step)))
        assert _FakeEvent.clock_ms == 1 + len(want) and not syncs
        assert torch.equal(plain.outer_vec, prof.outer_vec)
        p = prof.last_profile
        assert sorted(p) == sorted(want + [k + "_cpu" for k in want] + ["total"])
        assert [p[k] for k in want] == [1e-3] * len(want)
        assert p["total"] == pytest.approx(len(want) * 1e-3)
        assert prof.last_profile is p
    assert not syncs


def test_diloco_never_calls_device_synchronize():
    """parallel/diloco.py calls torch.cuda.synchronize nowhere, so no
    profile path fences the device."""
    import ast

    tree = ast.parse(Path(diloco.__file__).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
             and n.attr == "synchronize" and ast.unparse(n.value) == "torch.cuda"]
    assert calls == []


def _wait_world(comm, n=2, timeout=30.0):
    deadline = time.time() + timeout
    while comm.world_size < n:
        if time.time() > deadline:
            raise TimeoutError(f"world never reached {n}")
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.01)


def _run_peers(name, peer, comm_cls=None, n=2, timeout=180):
    """A master and n peer threads running peer(rank, comm), each with a
    connected communicator of comm_cls(rank) (the port's by default);
    raises on any peer's failure."""
    from pccl_tpu_torch.comm import Communicator, MasterNode

    master = MasterNode("127.0.0.1", MASTER_PORTS[name])
    master.run()
    errors = []

    def wrap(rank):
        base = PEER_BASE[name] + rank * 16
        cls = Communicator if comm_cls is None else comm_cls(rank)
        comm = cls("127.0.0.1", master.port, p2p_port=base, ss_port=base + 4,
                   bench_port=base + 8)
        try:
            comm.connect()
            _wait_world(comm, n)
            peer(rank, comm)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((rank, repr(e)))
        finally:
            comm.destroy()

    ts = [threading.Thread(target=wrap, args=(r,)) for r in range(n)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=timeout)
    finally:
        master.interrupt()
        master.destroy()
    assert not any(t.is_alive() for t in ts), "peer thread hung"
    assert not errors, f"peer failures: {errors}"


@pytest.mark.parametrize("route", ["pipelined", "staged", "unstaged"])
def test_outer_step_routes_average_exactly(route):
    """Each route of the outer step: the pipelined windowed reduce (two
    windows and a ragged tail, as in the JAX package's test), the staged
    and the unstaged ring. The averaged pseudo-gradient 1.5 lands exactly
    and bit-identically on both peers, and the profile has the route's
    phases."""
    _lib()
    n = (2 << 20) + 321
    cfg = diloco.DilocoConfig(outer_lr=1.0, outer_momentum=0.0, nesterov=False,
                              shm_staging=route != "unstaged",
                              comm_windows=2 if route == "pipelined" else 1,
                              profile=True)
    results = {}

    def peer(rank, comm):
        params = {"w": torch.zeros(n)}
        dl = diloco.Diloco(comm, params, cfg)
        # pseudo-gradient = outer - inner = rank + 1 everywhere
        inner = {"w": params["w"] - float(rank + 1)}
        out = dl.outer_step(inner)
        results[rank] = (out["w"], dl.last_profile)

    _run_peers("pipelined", peer)
    (w0, p0), (w1, p1) = results[0], results[1]
    assert torch.equal(w0, w1), "bit parity across peers"
    assert bool((w0 == -1.5).all())
    for p in (p0, p1):
        assert [k for k in p if not k.endswith("_cpu") and k != "total"] == \
            PROFILE_KEYS[route]


def _toy(seed):
    """Linear regression shard: y = X @ arange(8)."""
    rng = np.random.RandomState(seed)
    X = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    return X, X @ torch.arange(8, dtype=torch.float32)


def _inner_sgd(params, X, y, steps, lr=0.05):
    for _ in range(steps):
        w = params["w"].detach().requires_grad_(True)
        b = params["b"].detach().requires_grad_(True)
        loss = ((X @ w + b - y) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            params["w"].sub_(lr * gw)
            params["b"].sub_(lr * gb)


def test_two_async_torch_peers_agree_bit_for_bit():
    """Two async peers on different data shards, momentum off as in the
    JAX package's async test: the outer state is bit-identical on both
    after every step and after finish(), and converges."""
    _lib()
    results = {}

    def peer(rank, comm):
        X, y = _toy(100 + rank)
        params = {"w": torch.zeros(8), "b": torch.zeros(())}
        dl = diloco.AsyncDiloco(comm, params, diloco.DilocoConfig(
            inner_steps=10, outer_lr=0.7, outer_momentum=0.0))
        digests = []
        for _ in range(16):
            _inner_sgd(params, X, y, 10)
            dl.outer_step_async(params)
            digests.append(dl.digest())
        dl.finish(params)
        digests.append(dl.digest())
        results[rank] = (params["w"].clone(), digests, dl.step)

    _run_peers("async", peer)
    (w0, d0, s0), (w1, d1, s1) = results[0], results[1]
    assert d0 == d1 and s0 == s1 == 16
    assert torch.equal(w0, w1)
    np.testing.assert_allclose(w0.numpy(), np.arange(8, dtype=np.float32), atol=0.5)


def test_torch_async_peer_and_jax_async_peer_share_a_ring(monkeypatch):
    """One torch and one JAX async peer in one group, each moving its params
    by its own fixed offsets: the two apply the same averaged deltas with
    the same arithmetic, so their outer vectors are bit-equal at every step
    and after finish()."""
    lib = _lib()
    # the JAX peer loads the built library through PCCLT_LIB; its loader's
    # cache is reset before and after, so no JAX test later in this
    # process finds a library it did not find itself
    monkeypatch.setenv("PCCLT_LIB", str(lib))
    monkeypatch.setattr(jax_native, "_LIB", None)
    from pccl_tpu.comm import Communicator as JComm
    from pccl_tpu_torch.comm import Communicator

    results = {}

    def peer(rank, comm):
        cfg_kw = dict(outer_lr=0.7, outer_momentum=0.0)
        vecs = []
        if rank == 0:
            params = _torch(_tree(0))
            dl = diloco.AsyncDiloco(comm, params, diloco.DilocoConfig(**cfg_kw))
            for step in range(4):
                for k, v in _tree(200 + step, scale=0.1).items():
                    params[k].add_(torch.from_numpy(v))
                dl.outer_step_async(params)
                vecs.append(dl.outer_vec.numpy().copy())
            dl.finish(params)
            vecs.append(dl.outer_vec.numpy().copy())
        else:
            params = _jax(_tree(0))
            dl = jdiloco.AsyncDiloco(comm, params, jdiloco.DilocoConfig(**cfg_kw))
            for step in range(4):
                off = _tree(300 + step, scale=0.1)
                params = dl.outer_step_async(
                    {k: jnp.asarray(np.asarray(params[k]) + off[k]) for k in params})
                vecs.append(np.array(dl._outer_vec))
            dl.finish()
            vecs.append(np.array(dl._outer_vec))
        results[rank] = vecs

    _run_peers("mixed", peer, lambda rank: Communicator if rank == 0 else JComm)
    assert len(results[0]) == len(results[1]) == 5
    for a, b in zip(results[0], results[1]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(results[0][0], results[0][-1])


def test_shm_ndarray_alloc_rw_free():
    _lib()
    import ctypes

    from pccl_tpu_torch.comm import shm_ndarray

    lib = _native.load()
    a = shm_ndarray((256, 33), np.float64)
    assert a.shape == (256, 33) and a.dtype == np.float64
    a[:] = 7.5
    assert float(a.sum()) == 7.5 * 256 * 33
    b = shm_ndarray(100)                 # int shape, float32 by default
    assert b.shape == (100,) and b.dtype == np.float32
    b[:] = np.arange(100)
    view = b[10:20]
    del b
    gc.collect()
    assert view.tolist() == list(range(10, 20))   # a view keeps the region
    del a, view
    gc.collect()
    # a free of what was never allocated is refused, not a crash
    assert lib.pccltShmFree(ctypes.c_void_p(0)) != 0


def test_two_peer_async_example_agrees():
    """`python -m pccl_tpu_torch.examples.async_diloco --family llama` on
    the CPU: two peers and a master as separate processes; equal outer
    digests at every outer step and after finish(), world 2 throughout."""
    lib = _lib()
    env = dict(os.environ, PCCLT_LIB=str(lib), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    port = MASTER_PORTS["e2e"]
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    peers = []
    try:
        for rank in range(2):
            peers.append(subprocess.Popen(
                [sys.executable, "-m", "pccl_tpu_torch.examples.async_diloco",
                 "--master-port", str(port),
                 "--base-port", str(PEER_BASE["e2e"] + rank * 16),
                 "--data-shard", str(rank), "--min-world", "2",
                 "--device", "cpu", "--family", "llama", "--model", "nano",
                 "--outer-steps", "3", "--inner-steps", "5"],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=180)[0] for p in peers]
    finally:
        for p in peers + [master]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    digests = []
    for p, out in zip(peers, outs):
        assert p.returncode == 0, out
        assert re.findall(r"world (\d+) revision (\d+)", out) == \
            [("2", "0"), ("2", "1"), ("2", "2")], out
        assert re.search(r"join_s \d+\.\d+ launches 0 0 0 digest", out), out
        final = re.search(r"FINAL first_loss=\S+ last_loss=\S+ revision=3 "
                          r"digest=(\w+)", out)
        assert final, out
        digests.append(re.findall(r"digest (\w+)", out) + [final.group(1)])
    assert len(digests[0]) == 4 and digests[0] == digests[1]


def test_async_example_runs_solo_on_the_cpu(capsys):
    """The example without a ring (--solo): a Llama nano peer on the CPU
    applies its own delayed pseudo-gradients and learns."""
    from pccl_tpu_torch.examples import async_diloco

    code = async_diloco.main(["--solo", "--device", "cpu", "--family", "llama",
                              "--model", "nano", "--outer-steps", "3",
                              "--inner-steps", "5"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert re.findall(r"revision (\d+) tok_s", out) == ["0", "1", "2"]
    assert "FINAL" in out and "revision=3" in out
