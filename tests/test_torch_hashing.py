"""pccl_tpu_torch.ops.hashing and the device-hashed shared-state entries
against the JAX package, on the CPU.

The `simple-tpu` digest is exact integer arithmetic, so every comparison is
bit for bit: the plain version of H1 (planes_plain, which a CPU tensor
takes) + the host finalize, the port's numpy twin, and the JAX package's
jax_simplehash_device on the JAX CPU backend (its numpy twin for uint64,
which JAX hashes on the host).

The sync tests build libpcclt.so into pccl_tpu_torch/build/ once (under a
lock) and skip only where g++ is missing.
"""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pccl_tpu.ops import hashing as jhashing
from pccl_tpu_torch.ops import _build, hashing

# master ports of this file: below the kernel's ephemeral range, away from
# the ranges the other test files use; peers take ephemeral ports
MASTER_PORTS = {"clean": 31000, "divergent": 31010}

_KEY = jax.random.PRNGKey(0)
# tests/test_hashing.py's device-parity cases, then uint64 and 3 rows
CASES = {
    "f32_1000": lambda: jax.random.normal(_KEY, (1000,), jnp.float32),
    "bf16_64x129": lambda: jax.random.normal(_KEY, (64, 129), jnp.bfloat16),
    "f16_33": lambda: jax.random.normal(_KEY, (33,), jnp.float16),
    "i32_70000": lambda: jnp.arange(70000, dtype=jnp.int32),
    "u8_255": lambda: jnp.arange(255, dtype=jnp.uint8),
    "i8_131075": lambda: jax.random.randint(_KEY, (131072 + 3,), 0, 127, jnp.int8),
    "f32_empty": lambda: jnp.zeros((0,), jnp.float32),
    "u64_1001": lambda: np.random.default_rng(0).integers(
        0, 2 ** 64 - 1, 1001, dtype=np.uint64),
    "f32_3rows": lambda: jax.random.normal(_KEY, (2 * 65536 + 5,), jnp.float32),
}


def _to_torch(host: np.ndarray) -> torch.Tensor:
    """The same bytes as a torch tensor (bf16 through a uint16 view)."""
    if host.dtype.name == "bfloat16":
        return torch.from_numpy(host.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(host))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_planes_match_twins_and_jax_device_hash(case):
    arr = CASES[case]()
    host = np.asarray(arr)
    t = _to_torch(host)
    got = hashing.torch_simplehash_device(t)
    assert got == hashing.simplehash_tpu(host) == jhashing.simplehash_tpu(host)
    if isinstance(arr, np.ndarray):   # uint64: JAX hashes it on the host
        return
    assert got == jhashing.jax_simplehash_device(arr)
    if host.size:
        a, b = hashing.planes_plain(t).tolist()
        assert got == hashing._tpu_finalize(np.uint32(a), np.uint32(b), host.nbytes)


@pytest.mark.parametrize("nbytes", [0, 1, 7, 1024, 256 * 4 + 3, 65536 * 4 + 1])
def test_numpy_twins_are_the_jax_packages(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    assert hashing.simplehash(data) == jhashing.simplehash(data)
    assert hashing.simplehash_tpu(data) == jhashing.simplehash_tpu(data)
    assert hashing.simplehash_tpu(data.tobytes()) == jhashing.simplehash_tpu(data)


@pytest.mark.parametrize("word", [0, 65535, 65536, 99999])
def test_one_bit_flip_changes_the_digest(word):
    """The reference's own control (tests/test_hashing.py): a flip at the
    first and last lane of row 0, the first of row 1, and the last word."""
    base = torch.zeros(100000, dtype=torch.int32)
    flip = base.clone()
    flip[word] = 1
    assert hashing.torch_simplehash_device(flip) != \
        hashing.torch_simplehash_device(base)


def test_uniform_content_distinguishes():
    digests = {hashing.torch_simplehash_device(torch.full((32768,), v))
               for v in (0.0, 1.0, 3.0, 42.0)}
    assert len(digests) == 4


def test_strided_tensor_hashes_its_logical_bytes():
    x = torch.arange(300, dtype=torch.float32).reshape(20, 15)
    assert hashing.torch_simplehash_device(x.t()) == \
        hashing.simplehash_tpu(x.t().contiguous().numpy())


def test_plain_planes_refuse_zero_bytes():
    with pytest.raises(ValueError, match="0-byte"):
        hashing.device_planes(torch.empty(0))


def test_from_torch_device_needs_the_simple_tpu_hash(monkeypatch):
    from pccl_tpu_torch.comm import TensorInfo

    monkeypatch.delenv("PCCLT_SS_HASH", raising=False)
    with pytest.raises(RuntimeError, match="PCCLT_SS_HASH=simple-tpu"):
        TensorInfo.from_torch_device("w", torch.zeros(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_from_torch_device_entry(monkeypatch, dtype):
    """The entry carries H1's digest, leaves its host buffer alone until the
    materialize callback runs, and the callback stages the tensor's bytes."""
    from pccl_tpu_torch.comm import DataType, DeviceType, TensorInfo

    monkeypatch.setenv("PCCLT_SS_HASH", "simple-tpu")
    src = (torch.arange(70001) % 251).to(dtype)
    ti = TensorInfo.from_torch_device("w", src)
    assert ti._precomputed_hash == jhashing.simplehash_tpu(
        src.view(torch.int16).numpy() if dtype == torch.bfloat16 else src.numpy())
    assert ti.dtype == {torch.float32: DataType.FLOAT32,
                        torch.bfloat16: DataType.BFLOAT16,
                        torch.int32: DataType.INT32}[dtype]
    assert ti.device == DeviceType.TPU and ti.data.size == src.numel()
    ti._host.fill_(0)
    assert ti.torch_value() is src            # nothing received
    ti._materialize_cb(None)
    assert torch.equal(ti._host, src)
    ti.updated = True
    assert torch.equal(ti.torch_value(), src)


def test_from_torch_shares_a_cpu_tensors_storage():
    """The entry of a CPU tensor is the tensor's own storage (a sync writes
    into it), labelled with the tensor's dtype, bf16 included; a tensor on
    any other device is refused."""
    from pccl_tpu_torch.comm import DataType, DeviceType, TensorInfo

    src = torch.arange(6, dtype=torch.float32).bfloat16()
    ti = TensorInfo.from_torch("w", src)
    assert ti.dtype == DataType.BFLOAT16 and ti.device == DeviceType.HOST
    ti.data[:] = torch.full((6,), 7.0).bfloat16().view(torch.int16).numpy()
    ti.updated = True
    assert torch.equal(ti.torch_value(), torch.full((6,), 7.0).bfloat16())
    assert torch.equal(src, torch.full((6,), 7.0).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        TensorInfo.from_torch("t", torch.zeros(4, 3).t())
    with pytest.raises(ValueError, match="from_torch_device"):
        TensorInfo.from_torch("t", torch.zeros(4, device="meta"))


# ------------------------------------------------------------ over the core

def _lib():
    """libpcclt.so, built once into pccl_tpu_torch/build/ by the first
    test that needs it (the others wait on its lock)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


def _run_peers(master_port, world, worker, timeout=120):
    """`world` port communicators in threads; worker(comm, rank) -> result."""
    from pccl_tpu_torch.comm import Communicator

    results, errors = {}, {}

    def peer(rank):
        comm = Communicator("127.0.0.1", master_port)
        try:
            comm.connect()
            deadline = time.time() + 30
            while comm.world_size < world:
                assert time.time() < deadline, "world never formed"
                if comm.are_peers_pending():
                    comm.update_topology()
                time.sleep(0.01)
            results[rank] = worker(comm, rank)
        except Exception as e:  # noqa: BLE001 - reported below
            errors[rank] = repr(e)
        finally:
            comm.destroy()

    ts = [threading.Thread(target=peer, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "peer thread hung"
    return results, errors


@pytest.fixture
def master(request):
    _lib()
    from pccl_tpu_torch.comm import MasterNode

    m = MasterNode("127.0.0.1", MASTER_PORTS[request.param])
    m.run()
    yield m
    m.interrupt()
    m.destroy()


@pytest.mark.parametrize("master", ["clean"], indirect=True)
def test_device_hash_clean_sync_never_stages(master, monkeypatch):
    """from_torch_device entries with equal content everywhere: the sync
    moves no payload and never stages (the NaN sentinel in the host buffer
    survives), as tests/test_shared_state.py holds the JAX entries."""
    monkeypatch.setenv("PCCLT_SS_HASH", "simple-tpu")
    from pccl_tpu_torch.comm import SharedState, TensorInfo

    def worker(comm, rank):
        src = torch.arange(65536 + 7, dtype=torch.float32) * 0.5
        stats = []
        for rev in (1, 2):
            ti = TensorInfo.from_torch_device("w", src)
            ti.data.fill(np.nan)
            info = comm.sync_shared_state(SharedState([ti], revision=rev))
            stats.append((info.tx_bytes, info.rx_bytes, ti.updated,
                          bool(np.isnan(ti.data).all()),
                          ti.torch_value()[3].item()))
        return stats

    results, errors = _run_peers(master.port, 2, worker)
    assert not errors, errors
    for rank in (0, 1):
        for tx, rx, updated, sentinel, v3 in results[rank]:
            assert (tx, rx) == (0, 0)
            assert not updated
            assert sentinel, "materialize ran on a clean sync"
            assert v3 == 1.5


@pytest.mark.parametrize("master", ["divergent"], indirect=True)
def test_device_hash_divergent_peer_adopts_popular(master, monkeypatch):
    """One diverging peer of three: it receives the popular content, and
    exactly one incumbent serves it (its materialize staged the bytes)."""
    monkeypatch.setenv("PCCLT_SS_HASH", "simple-tpu")
    from pccl_tpu_torch.comm import SharedState, TensorInfo
    n = 32768

    def worker(comm, rank):
        src = torch.full((n,), 3.0 if rank == 2 else 42.0)
        ti = TensorInfo.from_torch_device("w", src)
        if rank == 2:
            ti.data.fill(np.nan)
        info = comm.sync_shared_state(SharedState([ti], revision=1))
        return info.tx_bytes, info.rx_bytes, ti.updated, ti.torch_value()[0].item()

    results, errors = _run_peers(master.port, 3, worker)
    assert not errors, errors
    assert all(r[3] == 42.0 for r in results.values())
    assert results[2][2] and results[2][1] == n * 4
    servers = [r for r in (0, 1) if results[r][0] == n * 4]
    assert len(servers) == 1, results
    assert not results[0][2] and not results[1][2]
