"""The port's DDP path against the JAX package on the CPU: the split train
step and AdamW's state leaves, the gradient all-reduce, the prefetcher, the
choice of shared-state entries, a torch peer adopting a JAX peer's
device-hashed shared state, and the `train_ddp` example with a late joiner.

fp32 compute on both sides. One step is held as tests/test_torch_train.py
holds three: 1e-5 on the loss, gradients to 1e-4 of their scale, and the
parameters to 2e-5 for all but one in 10^4 of them (Adam moves a weight by
about lr whatever its gradient, so one whose gradient is as small as the
frameworks' rounding may step differently, by at most 2 lr).

The native tests build libpcclt.so into pccl_tpu_torch/build/ once (under
a lock) and skip only where g++ is missing.
"""

import functools
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
import optax

from pccl_tpu.comm import _native as jax_native
from pccl_tpu.models import gpt as jgpt
from pccl_tpu.parallel import mesh as mesh_lib
from pccl_tpu.parallel import train as jtrain
from pccl_tpu_torch.examples import train_ddp
from pccl_tpu_torch.models import convert, gpt
from pccl_tpu_torch.ops import _build
from pccl_tpu_torch.parallel import train
from pccl_tpu_torch.parallel.hierarchical import HierarchicalAllReduce
from pccl_tpu_torch.utils import data

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
# ports of this file: below the kernel's ephemeral range, away from the
# ranges the other test files use
MASTER_PORTS = {"mixed": 31400, "e2e": 31410}
PEER_BASE = 31500


def _lib():
    """libpcclt.so, built once into pccl_tpu_torch/build/ by the first
    test that needs it (the others wait on its lock)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _mesh():
    return mesh_lib.make_mesh(jax.devices()[:1], ("dp", "tp"), shape=(1, 1))


def _batch(cfg, B=2, T=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32),
            rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32))


def _jax_and_torch_states(schedule: bool):
    jcfg = jgpt.tiny_config(compute_dtype=jnp.float32)
    tcfg = gpt.tiny_config(compute_dtype=torch.float32)
    jsched = jtrain.cosine_warmup_schedule(LR, 4, 1) if schedule else None
    tsched = train.cosine_warmup_schedule(LR, 4, 1) if schedule else None
    jparams, tx, opt_state = jtrain.make_train_state(
        jax.random.PRNGKey(0), jcfg, _mesh(), lr=LR, schedule=jsched)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    state = train.make_train_state(
        0, tcfg, "cpu", lr=LR, schedule=tsched,
        params=convert.params_from_numpy(np_params, tcfg, device="cpu"))
    return jcfg, tcfg, jparams, tx, opt_state, state


@pytest.mark.parametrize("schedule", [False, True])
def test_split_ddp_step_matches_an_optax_step(schedule):
    jcfg, tcfg, jparams, tx, opt_state, state = _jax_and_torch_states(schedule)
    tok, tgt = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(functools.partial(jgpt.loss_fn, cfg=jcfg))(
        jparams, jnp.asarray(tok), jnp.asarray(tgt))
    updates, opt_state = tx.update(jgrads, opt_state, jparams)
    jparams = optax.apply_updates(jparams, updates)

    loss = train.build_loss_and_grad(tcfg)(state, torch.from_numpy(tok),
                                           torch.from_numpy(tgt))
    grads = {n: p.grad for n, p in state.params.items()}
    ring = HierarchicalAllReduce(None, state.params)
    assert ring.all_reduce(grads) is grads
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    train.apply(state)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    got = convert.params_to_numpy(state.params)
    for name, want in jparams.items():
        diff = np.abs(got[name] - np.asarray(want))
        assert np.mean(diff > 2e-5) <= 1e-4, name
        assert diff.max() <= 2 * LR, name

    # the leaves line up with optax's: count, mu, nu (and the schedule's
    # count), same shapes and dtypes, the moments to the gradients' rounding
    jleaves = jax.tree.flatten(opt_state)[0]
    leaves = train.opt_state_leaves(state)
    assert len(leaves) == len(jleaves) == 17 + schedule
    for i, (x, y) in enumerate(zip(leaves, jleaves)):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape and x.numpy().dtype == y.dtype, i
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1e-30),
                                   err_msg=f"leaf {i}")
    assert leaves[0].item() == 1


@pytest.mark.parametrize("schedule", [False, True])
def test_opt_state_leaves_round_trip(schedule):
    """A fresh state that loads another's parameters and leaves steps to
    the same parameters bit for bit: the count reaches every parameter's
    bias correction and the schedule."""
    _, tcfg, _, _, _, a = _jax_and_torch_states(schedule)
    tsched = train.cosine_warmup_schedule(LR, 4, 1) if schedule else None
    step = train.build_train_step(tcfg)
    for seed in (1, 2):
        tok, tgt = (torch.from_numpy(x) for x in _batch(tcfg, seed=seed))
        step(a, tok, tgt)
    b = train.make_train_state(5, tcfg, "cpu", lr=LR, schedule=tsched)
    with torch.no_grad():
        for n, p in b.params.items():
            p.copy_(a.params[n])
    train.load_opt_state_leaves(b, [x.clone() for x in train.opt_state_leaves(a)])
    for x, y in zip(train.opt_state_leaves(a), train.opt_state_leaves(b)):
        assert torch.equal(x, y)
    tok, tgt = (torch.from_numpy(x) for x in _batch(tcfg, seed=3))
    step(a, tok, tgt)
    step(b, tok, tgt)
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    with pytest.raises(ValueError, match="optimizer leaves"):
        train.load_opt_state_leaves(b, train.opt_state_leaves(a)[:-1])


def test_prefetch_to_device_keeps_order_and_ends():
    items = [(np.full((2, 3), i, np.int32), np.full((2, 3), -i, np.int32))
             for i in range(5)]
    got = list(data.prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.int32
        assert torch.equal(x, torch.full((2, 3), i, dtype=torch.int32))
        assert torch.equal(y, -x)


def test_prefetch_to_device_raises_the_feeders_error():
    def bad():
        yield np.zeros(2)
        raise KeyError("boom")

    it = data.prefetch_to_device(bad(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_all_reduce_crosses_the_ring_as_one_flat_vector(monkeypatch):
    """With a communicator, the gradients go out flat in the codec's order
    and what the ring leaves in the vector lands back in each gradient."""
    from pccl_tpu_torch.parallel import hierarchical
    from pccl_tpu_torch.parallel.codec import build_codec

    cfg = gpt.tiny_config(compute_dtype=torch.float32)
    state = train.make_train_state(0, cfg, "cpu", lr=LR)
    grads = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, (n, p) in enumerate(sorted(state.params.items()))}
    codec = build_codec(grads)
    want = {n: g * 2 + 1 for n, g in grads.items()}
    calls = []

    def fake_ring(comm, buf, *, windows, quantization, quantized_dtype,
                  max_retries):
        calls.append((comm, windows, quantization, quantized_dtype,
                      max_retries))
        np.testing.assert_array_equal(buf, codec.flat(grads).numpy())
        buf *= 2
        buf += 1
        return 0

    monkeypatch.setattr(hierarchical, "avg_all_reduce_windowed", fake_ring)
    comm = object()
    ring = HierarchicalAllReduce(comm, state.params)
    assert ring.count == sum(p.numel() for p in state.params.values())
    assert ring.all_reduce(grads) is grads
    assert calls == [(comm, 1, hierarchical.QuantizationAlgorithm.NONE,
                      hierarchical.DataType.UINT8, 16)]
    for n, g in grads.items():
        torch.testing.assert_close(g, want[n], rtol=0, atol=0)


@pytest.mark.parametrize("device,ss_hash,want", [
    ("cpu", None, "from_torch"), ("cpu", "simple-tpu", "from_torch_device"),
    ("cuda", "simple-tpu", "from_torch_device"), ("cuda", None, ValueError)])
def test_train_ddp_never_stages_a_cards_state(device, ss_hash, want, monkeypatch):
    """A peer hashes its state where it lies with simple-tpu; without it only
    a CPU peer runs (its entries share the tensors' storage), and a CUDA
    peer refuses to start rather than stage its state at every step."""
    from pccl_tpu_torch.comm import TensorInfo

    if ss_hash is None:
        monkeypatch.delenv("PCCLT_SS_HASH", raising=False)
    else:
        monkeypatch.setenv("PCCLT_SS_HASH", ss_hash)
    dev = torch.device(device)
    if want is ValueError:
        with pytest.raises(ValueError, match="PCCLT_SS_HASH=simple-tpu"):
            train_ddp.entry_factory(dev)
    else:
        assert train_ddp.entry_factory(dev) == getattr(TensorInfo, want)


# ------------------------------------------------------------ over the core

def _wait_world(comm, n, timeout=30.0):
    deadline = time.time() + timeout
    while comm.world_size < n:
        assert time.time() < deadline, f"world never reached {n}"
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.01)


def test_torch_peer_adopts_a_jax_peers_device_hashed_state(monkeypatch):
    """A JAX peer offers its nano parameters and optax state through
    from_jax_device at revision 5; a fresh torch peer offers the port's
    DDP entries through from_torch_device at revision 0, and adopts: it
    receives exactly the entries' bytes, its receipt checks H1's digests
    against the C++ hash, and the adopted tensors equal JAX's bit for bit."""
    lib = _lib()
    # the JAX peer loads the built library through PCCLT_LIB; its loader's
    # cache is reset before and after, so no JAX test later in this
    # process finds a library it did not find itself
    monkeypatch.setenv("PCCLT_LIB", str(lib))
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setenv("PCCLT_SS_HASH", "simple-tpu")
    from pccl_tpu.comm import Communicator as JComm
    from pccl_tpu.comm import SharedState as JState
    from pccl_tpu.comm import TensorInfo as JInfo
    from pccl_tpu_torch.comm import Communicator, MasterNode, SharedState, TensorInfo

    jcfg = jgpt.named_config("nano", compute_dtype=jnp.float32)
    tcfg = gpt.named_config("nano", compute_dtype=torch.float32)
    jparams, tx, opt_state = jtrain.make_train_state(
        jax.random.PRNGKey(3), jcfg, _mesh(), lr=LR)
    tok, tgt = _batch(jcfg, T=16)
    grads = jax.grad(functools.partial(jgpt.loss_fn, cfg=jcfg))(
        jparams, jnp.asarray(tok), jnp.asarray(tgt))
    updates, opt_state = tx.update(grads, opt_state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    jp_leaves = jax.tree.flatten(jparams)[0]
    jo_leaves = jax.tree.flatten(opt_state)[0]
    state = train.make_train_state(0, tcfg, "cpu", lr=LR)
    nbytes = sum(np.asarray(x).nbytes for x in jp_leaves + jo_leaves) + 8

    master = MasterNode("127.0.0.1", MASTER_PORTS["mixed"])
    master.run()
    results, errors = {}, {}

    def peer(rank):
        cls = Communicator if rank == 0 else JComm
        comm = cls("127.0.0.1", master.port)
        try:
            comm.connect()
            _wait_world(comm, 2)
            if rank == 0:
                step_arr = np.array([0], np.uint64)
                entries = train_ddp.state_entries(state, step_arr,
                                                  TensorInfo.from_torch_device)
                info = comm.sync_shared_state(SharedState(entries, revision=0))
                train_ddp.adopt(state, entries)
                results[0] = (info.tx_bytes, info.rx_bytes, int(step_arr[0]))
            else:
                entries = ([JInfo.from_jax_device(f"ddp.p{i}", x)
                            for i, x in enumerate(jp_leaves)]
                           + [JInfo.from_jax_device(f"ddp.o{i}", x)
                              for i, x in enumerate(jo_leaves)]
                           + [JInfo.from_numpy("ddp.step", np.array([5], np.uint64))])
                info = comm.sync_shared_state(JState(entries, revision=5))
                results[1] = (info.tx_bytes, info.rx_bytes)
        except Exception as e:  # noqa: BLE001 - reported below
            errors[rank] = repr(e)
        finally:
            comm.destroy()

    ts = [threading.Thread(target=peer, args=(r,)) for r in range(2)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        master.interrupt()
        master.destroy()
    assert not any(t.is_alive() for t in ts), "peer thread hung"
    assert not errors, errors
    assert results[0] == (0, nbytes, 5)
    assert results[1] == (nbytes, 0)
    for name, want in zip(sorted(state.params), jp_leaves):
        np.testing.assert_array_equal(state.params[name].detach().numpy(),
                                      np.asarray(want), err_msg=name)
    for i, (x, y) in enumerate(zip(train.opt_state_leaves(state), jo_leaves)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f"leaf {i}")


STEP = re.compile(r"^step (\d+) loss \S+ world (\d+) revision \d+ tok_s \S+ "
                  r"ring_s \S+ sync_s \S+ tx (\d+) rx (\d+) launches \d+ \d+ "
                  r"\d+ \d+ digest (\w+)$", re.M)


def test_two_peers_and_a_late_joiner_end_bit_identical():
    """`python -m pccl_tpu_torch.examples.train_ddp` on the CPU, with the
    device-hash entries (their plain version here) and a cosine schedule
    (its count is an 18th optimizer leaf): two peers train, a third joins
    once the first has logged step 2 and adopts their state at a step > 0,
    receiving every entry's bytes; afterwards no sync moves a
    byte, the three print one digest at every common step, and their final
    parameters are equal."""
    lib = _lib()
    env = dict(os.environ, PCCLT_LIB=str(lib), OMP_NUM_THREADS="1",
               PCCLT_SS_HASH="simple-tpu", PYTHONUNBUFFERED="1")
    port = MASTER_PORTS["e2e"]
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def spawn(rank, min_world):
        return subprocess.Popen(
            [sys.executable, "-m", "pccl_tpu_torch.examples.train_ddp",
             "--master-port", str(port), "--base-port", str(PEER_BASE + 16 * rank),
             "--min-world", str(min_world), "--device", "cpu", "--model", "nano",
             "--batch", "4", "--steps", "60", "--lr-schedule", "cosine",
             "--warmup-steps", "2"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    peers = [spawn(0, 2), spawn(1, 2)]
    a_lines = []
    pump = threading.Thread(target=lambda: a_lines.extend(
        iter(peers[0].stdout.readline, "")), daemon=True)
    pump.start()
    try:
        deadline = time.time() + 120
        while not any(ln.startswith("step 2 ") for ln in a_lines):
            assert time.time() < deadline and peers[0].poll() is None, \
                "A never reached step 2:\n" + "".join(a_lines)[-3000:]
            time.sleep(0.1)
        peers.append(spawn(2, 3))
        outs = [None] + [p.communicate(timeout=300)[0] for p in peers[1:]]
        peers[0].wait(timeout=300)
        pump.join(timeout=10)
        outs[0] = "".join(a_lines)
    finally:
        for p in peers + [master]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(peers, outs):
        assert p.returncode == 0, out[-3000:]
    m = re.search(r"adopted shared state at step (\d+)", outs[2])
    assert m and int(m.group(1)) > 0, outs[2][-3000:]
    k = int(m.group(1))
    rows = [{int(r[0]): r[1:] for r in STEP.findall(out)} for out in outs]
    # params, mu and nu, AdamW's count, the schedule's count, the step
    entry_bytes = 3 * sum(int(np.prod(s)) * 4 for s in gpt.param_shapes(
        gpt.named_config("nano")).values()) + 4 + 4 + 8
    assert rows[2][k][2] == str(entry_bytes)          # C's rx at adoption
    assert int(rows[0][k][1]) + int(rows[1][k][1]) == entry_bytes
    assert min(rows[2]) == k and len(rows[2]) >= 10
    for r in rows[:2]:
        assert all(r[s][1:3] == ("0", "0") for s in r if s < k)
    for s in rows[2]:
        if s > k:
            assert all(r[s][1:3] == ("0", "0") for r in rows), s
        assert rows[0][s][0] == "3"
        assert rows[0][s][3] == rows[1][s][3] == rows[2][s][3], s
    finals = {re.search(r"params_blake2b=(\w+)", out).group(1) for out in outs}
    assert len(finals) == 1
