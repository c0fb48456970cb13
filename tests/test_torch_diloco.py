"""pccl_tpu_torch.parallel (codec, sync DiLoCo) against pccl_tpu.parallel,
and the port's peers over the native ring.

The native tests build libpcclt.so into pccl_tpu_torch/build/ once (under
a lock) and skip only where g++ is missing.
"""

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

import jax
import jax.numpy as jnp

from pccl_tpu.parallel import codec as jcodec
from pccl_tpu.parallel import diloco as jdiloco
from pccl_tpu.comm import _native as jax_native
from pccl_tpu_torch.ops import _build
from pccl_tpu_torch.parallel import codec, diloco

REPO = Path(__file__).resolve().parent.parent
# ports of this file: below the kernel's ephemeral range, away from the
# ranges the other test files use
MASTER_PORTS = {"threads": 30500, "mixed": 30510, "e2e": 30520}
PEER_BASE = {"threads": 30600, "mixed": 30700, "e2e": 30800}


def _lib():
    """libpcclt.so, built once into pccl_tpu_torch/build/ by the first
    test that needs it (the others wait on its lock)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _tree(seed=0):
    """Leaves inserted out of sorted order, of several ranks."""
    rng = np.random.RandomState(seed)
    return {"z": rng.randn(3, 4).astype(np.float32),
            "a": rng.randn(5).astype(np.float32),
            "m": rng.randn(2, 2, 2).astype(np.float32),
            "b": np.array(rng.randn(), dtype=np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_codec_flat_matches_jax_leaf_order():
    tree = _tree()
    want = np.asarray(jcodec.build_codec(
        {k: jnp.asarray(v) for k, v in tree.items()}).flat(tree))
    c = codec.build_codec(_torch(tree))
    np.testing.assert_array_equal(c.flat(_torch(tree)).numpy(), want)
    assert c.names == sorted(tree) and c.count == want.size


def test_codec_flat_matches_jax_on_gpt_params():
    from pccl_tpu.models import gpt as jgpt

    jparams = jgpt.init_params(jax.random.PRNGKey(0), jgpt.tiny_config())
    want = np.asarray(jcodec.build_codec(jparams).flat(jparams))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    np.testing.assert_array_equal(codec.build_codec(tparams).flat(tparams).numpy(),
                                  want)


def test_codec_unflat_restores_dtypes_and_delta():
    # values for which (x + 1) - x == 1 exactly in fp32
    params = {"w": (torch.arange(12.0).reshape(4, 3) / 4 - 1).to(torch.bfloat16),
              "b": torch.tensor([0.5, -1.25])}
    c = codec.build_codec(params)
    back = c.unflat(c.flat(params))
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], params["w"])
    assert torch.equal(back["b"], params["b"])
    outer = c.flat(params) + 1.0
    assert torch.equal(c.flat_delta_vec(outer, params), torch.ones(c.count))
    target = {k: torch.zeros_like(v) for k, v in params.items()}
    c.unflat_into(c.flat(params), target)
    assert all(torch.equal(target[k], params[k]) for k in params)


def test_outer_step_without_comm_matches_jax():
    """Two Nesterov outer steps with comm=None, against the JAX driver."""
    outer, inner1, inner2 = _tree(0), _tree(1), _tree(2)
    cfg_kw = dict(outer_lr=0.7, outer_momentum=0.9)
    jdl = jdiloco.Diloco(None, {k: jnp.asarray(v) for k, v in outer.items()},
                         jdiloco.DilocoConfig(**cfg_kw))
    tdl = diloco.Diloco(None, _torch(outer), diloco.DilocoConfig(**cfg_kw))
    for inner in (inner1, inner2):
        want = jdl.outer_step({k: jnp.asarray(v) for k, v in inner.items()})
        got = tdl.outer_step(_torch(inner))
        for k in outer:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert tdl.step == jdl.step == 2
    np.testing.assert_allclose(tdl.outer_vec.numpy(), np.asarray(jdl._outer_vec),
                               rtol=1e-6, atol=1e-7)


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


def _wait_world(comm, n=2, timeout=30.0):
    deadline = time.time() + timeout
    while comm.world_size < n:
        if time.time() > deadline:
            raise TimeoutError(f"world never reached {n}")
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.01)


def _run_threads(target, n=2, timeout=120):
    errors = []

    def wrap(rank):
        try:
            target(rank)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((rank, repr(e)))

    ts = [threading.Thread(target=wrap, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "peer thread hung"
    assert not errors, f"peer failures: {errors}"


def test_two_torch_peers_average_exactly():
    """Two peers with different data shards: the outer parameters are
    bit-identical on both after every outer step, and converge."""
    _lib()
    from pccl_tpu_torch.comm import Communicator, MasterNode

    master = MasterNode("127.0.0.1", MASTER_PORTS["threads"])
    master.run()
    results = {}

    def peer(rank):
        base = PEER_BASE["threads"] + rank * 16
        comm = Communicator("127.0.0.1", master.port, p2p_port=base,
                            ss_port=base + 4, bench_port=base + 8)
        try:
            comm.connect()
            _wait_world(comm)
            X, y = _toy(100 + rank)
            params = {"w": torch.zeros(8), "b": torch.zeros(())}
            dl = diloco.Diloco(comm, params, diloco.DilocoConfig(outer_lr=0.7))
            digests = []
            for _ in range(8):
                _inner_sgd(params, X, y, 10)
                dl.outer_step(params)
                digests.append(dl.digest())
            results[rank] = (params["w"].clone(), digests, dl._host_out.numpy().copy())
        finally:
            comm.destroy()

    try:
        _run_threads(peer)
    finally:
        master.interrupt()
        master.destroy()
    (w0, d0, avg0), (w1, d1, avg1) = results[0], results[1]
    assert d0 == d1
    assert torch.equal(w0, w1)
    np.testing.assert_array_equal(avg0, avg1)
    np.testing.assert_allclose(w0.numpy(), np.arange(8, dtype=np.float32), atol=0.5)


def test_torch_peer_and_jax_peer_share_a_ring(monkeypatch):
    """One torch peer and one JAX peer in one group: the ring's averaged
    pseudo-gradient is the same bytes on both, and one outer step leaves
    the same outer parameters to fp32 rounding."""
    lib = _lib()
    # the JAX peer loads the built library through PCCLT_LIB; its loader's
    # cache is reset before and after, so no JAX test later in this
    # process finds a library it did not find itself
    monkeypatch.setenv("PCCLT_LIB", str(lib))
    monkeypatch.setattr(jax_native, "_LIB", None)
    from pccl_tpu.comm import Communicator as JComm
    from pccl_tpu_torch.comm import Communicator, MasterNode

    master = MasterNode("127.0.0.1", MASTER_PORTS["mixed"])
    master.run()
    outer = _tree(0)
    inner = {0: _tree(1), 1: _tree(2)}
    results = {}

    def peer(rank):
        base = PEER_BASE["mixed"] + rank * 16
        cls = Communicator if rank == 0 else JComm
        comm = cls("127.0.0.1", master.port, p2p_port=base, ss_port=base + 4,
                   bench_port=base + 8)
        try:
            comm.connect()
            _wait_world(comm)
            if rank == 0:
                dl = diloco.Diloco(comm, _torch(outer))
                out = dl.outer_step(_torch(inner[0]))
                results[0] = ({k: v.numpy() for k, v in out.items()},
                              dl._host_out.numpy().copy())
            else:
                dl = jdiloco.Diloco(comm, {k: jnp.asarray(v) for k, v in outer.items()})
                out = dl.outer_step({k: jnp.asarray(v) for k, v in inner[1].items()})
                results[1] = ({k: np.asarray(v) for k, v in out.items()},
                              np.array(dl._host_out))
        finally:
            comm.destroy()

    try:
        _run_threads(peer)
    finally:
        master.interrupt()
        master.destroy()
    (p0, avg0), (p1, avg1) = results[0], results[1]
    np.testing.assert_array_equal(avg0, avg1)
    for k in outer:
        np.testing.assert_allclose(p0[k], p1[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_two_peer_example_run_learns():
    """`python -m pccl_tpu_torch.examples.sync_diloco` on the CPU: two peers
    and a master as separate processes; FINAL with a falling loss, and equal
    outer digests on both peers at every outer step."""
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
                [sys.executable, "-m", "pccl_tpu_torch.examples.sync_diloco",
                 "--master-port", str(port),
                 "--base-port", str(PEER_BASE["e2e"] + rank * 16),
                 "--min-world", "2", "--device", "cpu", "--model", "nano",
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
        m = re.search(r"FINAL first_loss=(\S+) last_loss=(\S+)", out)
        assert m and float(m.group(2)) < float(m.group(1)), out
        assert re.findall(r"world (\d+) revision", out) == ["2", "2", "2"], out
        digests.append(re.findall(r"digest (\w+)", out))
    assert len(digests[0]) == 3 and digests[0] == digests[1]
