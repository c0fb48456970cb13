"""The rest of the port's comm surface (pccl_tpu_torch.comm) over the native
ring, mirroring the JAX package's tests of the same calls
(test_schedule.py, test_comm_native.py, test_topology.py,
test_observability.py): broadcast, reduce_scatter, all_to_all and
all_gather, their solo paths, the wire-dtype override, optimize_topology,
the counters and the flight recorder, MasterNode.health() and the
peer-group attributes; then one group of a torch peer and a JAX peer, and
HierarchicalAllReduce's shm staging and windows.

Payloads are integer-valued fp32, so a group sum is exact whatever order
the ring folds it in: a bit-exact comparison with numpy's sum is fair.
Peers are threads of this process on loopback, each with its own
Communicator; a real master, never a mock. The library is built once into
pccl_tpu_torch/build/ (under a lock); the tests skip only without g++.
"""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pccl_tpu.comm import _native as jax_native
from pccl_tpu_torch.ops import _build

# ports of this file: below the kernel's ephemeral range, away from the
# ranges the other test files use; each test takes a fresh block of 64
_NEXT_PORT = [28000]


def _ports() -> int:
    p = _NEXT_PORT[0]
    _NEXT_PORT[0] += 64
    return p


def _lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: libpcclt.so cannot be built")
    return _build.ensure_pcclt()


@pytest.fixture
def master():
    _lib()
    from pccl_tpu_torch.comm import MasterNode

    base = _ports()
    m = MasterNode("127.0.0.1", base)
    m.run()
    m.peer_base = base + 16
    yield m
    m.interrupt()
    m.destroy()


def _wait_world(comm, world: int, timeout: float = 30.0) -> None:
    deadline = time.time() + timeout
    while comm.world_size < world:
        if time.time() > deadline:
            raise TimeoutError(f"world never reached {world}")
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.01)


def _run_peers(master, world, worker, classes=None, groups=None):
    """`world` peer threads, each running worker(comm, rank) once its
    group has formed. classes[rank]: the Communicator class of that peer
    (default the port's); groups[rank]: its peer group (default 0)."""
    from pccl_tpu_torch.comm import Communicator

    classes = classes or [Communicator] * world
    groups = groups or [0] * world
    sizes = {g: groups.count(g) for g in groups}
    errors = []

    def peer(rank):
        base = master.peer_base + rank * 16
        comm = classes[rank]("127.0.0.1", master.port, peer_group=groups[rank],
                             p2p_port=base, ss_port=base + 4,
                             bench_port=base + 8)
        try:
            comm.connect()
            _wait_world(comm, sizes[groups[rank]])
            worker(comm, rank)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((rank, repr(e)))
        finally:
            comm.destroy()

    threads = [threading.Thread(target=peer, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a peer thread hung"
    assert not errors, f"peer failures: {errors}"


def _slot_data(slot: int, count: int, seed: int = 0) -> np.ndarray:
    """Integer-valued fp32 payload of one slot: group sums are exact."""
    rng = np.random.default_rng(1000 * seed + slot)
    return rng.integers(0, 512, count).astype(np.float32)


# ---------------------------------------------------------------- broadcast

@pytest.mark.parametrize("world,root", [(2, 0), (3, 2)])
def test_broadcast_bit_exact(master, world, root):
    """Every peer ends with the root slot's bytes; the others start from
    poison; the count is not divisible by the world."""
    count = 4099
    barrier = threading.Barrier(world)

    def worker(comm, rank):
        slot = comm.gather_slot
        buf = (_slot_data(root, count) if slot == root
               else np.full(count, -7.0, dtype=np.float32))
        info = comm.broadcast(buf, root=root, tag=5)
        assert info.world_size == world
        assert np.array_equal(buf, _slot_data(root, count))
        barrier.wait(timeout=60)

    _run_peers(master, world, worker)


# ----------------------------------------------------------- reduce-scatter

@pytest.mark.parametrize("world", [2, 3])
def test_reduce_scatter_bit_exact(master, world):
    """Each peer's chunk is numpy's group sum over [offset, offset + n);
    the chunks tile the vector exactly once; bytes sent == bytes
    received, group-wide."""
    count = 2053
    total = np.sum([_slot_data(s, count, seed=2) for s in range(world)],
                   axis=0, dtype=np.float32)
    spans, infos = {}, {}

    def worker(comm, rank):
        chunk, off, info = comm.reduce_scatter(
            _slot_data(comm.gather_slot, count, seed=2), tag=6)
        assert info.world_size == world
        assert np.array_equal(chunk, total[off:off + chunk.size])
        spans[rank] = (off, chunk.size)
        infos[rank] = info

    _run_peers(master, world, worker)
    spans = sorted(spans.values())
    assert spans[0][0] == 0 and sum(n for _, n in spans) == count
    for (o1, n1), (o2, _) in zip(spans, spans[1:]):
        assert o1 + n1 == o2, spans
    assert sum(i.tx_bytes for i in infos.values()) == \
        sum(i.rx_bytes for i in infos.values())


def test_reduce_scatter_quantized(master):
    """The min-max quantized wire format: within its tolerance."""
    from pccl_tpu_torch.comm import QuantizationAlgorithm

    world, count = 3, 1024
    total = np.sum([_slot_data(s, count, seed=3) for s in range(world)],
                   axis=0, dtype=np.float32)

    def worker(comm, rank):
        chunk, off, info = comm.reduce_scatter(
            _slot_data(comm.gather_slot, count, seed=3), tag=7,
            quantization=QuantizationAlgorithm.MIN_MAX)
        assert info.world_size == world
        np.testing.assert_allclose(chunk, total[off:off + chunk.size],
                                   atol=1.5 * world * 2.0)

    _run_peers(master, world, worker)


# --------------------------------------------------------------- all-to-all

@pytest.mark.parametrize("world", [2, 3])
def test_all_to_all_bit_exact(master, world):
    """recv block i is exactly the block the peer of slot i addressed to
    this peer's slot."""
    per = 193
    infos = {}

    def worker(comm, rank):
        slot = comm.gather_slot
        send = np.concatenate([_slot_data(slot * world + j, per, seed=4)
                               for j in range(world)])
        recv, info = comm.all_to_all(send, tag=8)
        assert info.world_size == world
        for i in range(world):
            assert np.array_equal(recv[i * per:(i + 1) * per],
                                  _slot_data(i * world + slot, per, seed=4))
        infos[rank] = info

    _run_peers(master, world, worker)
    assert sum(i.tx_bytes for i in infos.values()) == \
        sum(i.rx_bytes for i in infos.values())


# --------------------------------------------------------------- all-gather

def test_all_gather_three_peers(master):
    """Every peer ends with the three segments in the same (sorted-uuid)
    order, its own at gather_slot; a segment above the core's CMA
    threshold takes the descriptor path."""
    count = (1 << 20) + 77
    results = {}

    def worker(comm, rank):
        out, info = comm.all_gather(np.full(count, float(rank + 1),
                                            dtype=np.float32))
        assert info.world_size == 3
        assert float(out[comm.gather_slot][0]) == float(rank + 1)
        results[rank] = np.array(out)

    _run_peers(master, 3, worker)
    assert results[0].shape == (3, count)
    for r in (1, 2):
        assert np.array_equal(results[0], results[r]), f"rank {r} differs"
    assert sorted(float(results[0][i][0]) for i in range(3)) == [1.0, 2.0, 3.0]


# --------------------------------------------------------------- solo paths

def _solo_broadcast(comm):
    buf = np.arange(5, dtype=np.float32)
    info = comm.broadcast(buf, root=0)
    assert info.world_size == 1
    assert np.array_equal(buf, np.arange(5, dtype=np.float32))


def _solo_reduce_scatter(comm):
    x = np.arange(11, dtype=np.float32)
    chunk, off, info = comm.reduce_scatter(x)
    assert (off, info.world_size, info.tx_bytes) == (0, 1, 0)
    assert np.array_equal(chunk, x)
    with pytest.raises(ValueError, match="capacity"):
        comm.reduce_scatter(x, np.empty(10, dtype=np.float32))


def _solo_all_to_all(comm):
    x = np.arange(6, dtype=np.float32)
    recv, info = comm.all_to_all(x)
    assert info.world_size == 1 and np.array_equal(recv, x)
    with pytest.raises(ValueError, match="dtype"):
        comm.all_to_all(x, np.empty(6, dtype=np.float64))


def _solo_all_gather(comm):
    x = np.arange(17, dtype=np.float32)
    out, info = comm.all_gather(x)
    assert info.world_size == 1 and info.tx_bytes == 0
    assert out.shape == (1, 17)
    np.testing.assert_array_equal(out[0], x)


SOLO = {"broadcast": _solo_broadcast, "reduce_scatter": _solo_reduce_scatter,
        "all_to_all": _solo_all_to_all, "all_gather": _solo_all_gather}


@pytest.mark.parametrize("op", sorted(SOLO))
def test_solo_paths(master, op):
    """Alone in its group, each collective returns its own data with no
    traffic (the core itself would refuse a world of 1), and a recv
    buffer that cannot hold the result is refused."""
    _run_peers(master, 1, lambda comm, rank: SOLO[op](comm))


# ------------------------------------------------------ wire-dtype override

def test_wire_dtype_override_validation(master):
    """An override whose element size is not the arrays' raises; bf16 is
    reduced from the int16 view the port keeps of a bf16 tensor, and from
    uint16 bit patterns."""
    from pccl_tpu_torch.comm import DataType
    from pccl_tpu_torch.comm.api import _host_view

    def worker(comm, rank):
        with pytest.raises(ValueError, match="bytes/elem"):
            comm.all_reduce(np.zeros(64, dtype=np.float32),
                            dtype=DataType.BFLOAT16)
        t = torch.full((64,), 1.5, dtype=torch.bfloat16)
        comm.all_reduce(_host_view(t), dtype=DataType.BFLOAT16, tag=1)
        assert torch.equal(t, torch.full((64,), 3.0, dtype=torch.bfloat16))
        y = np.full(64, 0x3F80, dtype=np.uint16)          # bf16 1.0
        comm.all_reduce(y, dtype=DataType.BFLOAT16, tag=2)
        assert int(y[0]) == 0x4000 and int(y[-1]) == 0x4000   # 2.0

    _run_peers(master, 2, worker)


# --------------------------------------------------------------- topology

def test_optimize_topology_three_peers(master, monkeypatch):
    """Bandwidth probes, the solved ring, and a later call that may adopt
    the improved (moonshot) ring: collectives stay exact after each."""
    monkeypatch.setenv("PCCLT_BENCH_SECONDS", "0.2")
    monkeypatch.setenv("PCCLT_MOONSHOT_MS", "300")
    from pccl_tpu_torch.comm import ReduceOp

    results = {}

    def worker(comm, rank):
        x = _slot_data(rank, 1024, seed=6)
        comm.optimize_topology()
        y = np.empty_like(x)
        assert comm.all_reduce(x, y, op=ReduceOp.SUM).world_size == 3
        time.sleep(0.6)
        comm.optimize_topology()
        z = np.empty_like(x)
        assert comm.all_reduce(x, z, op=ReduceOp.SUM, tag=1).world_size == 3
        assert comm.stats()["counters"]["topology_optimizes"] >= 2
        results[rank] = (y, z)

    _run_peers(master, 3, worker)
    want = np.sum([_slot_data(r, 1024, seed=6) for r in range(3)], axis=0,
                  dtype=np.float32)
    for y, z in results.values():
        assert np.array_equal(y, want) and np.array_equal(z, want)


def test_peer_group_attributes(master):
    """Two peers in group 0 and one in group 1: the grid's fullness inputs
    (global world, groups, largest group) and the session attributes."""
    seen = {}
    barrier = threading.Barrier(3)

    def worker(comm, rank):
        deadline = time.time() + 30
        while comm.global_world_size < 3:
            assert time.time() < deadline, "global world never reached 3"
            if comm.are_peers_pending():
                comm.update_topology()
            time.sleep(0.01)
        seen[rank] = (comm.world_size, comm.global_world_size,
                      comm.num_peer_groups, comm.largest_peer_group,
                      comm.master_epoch, comm.reconnect_count,
                      comm.shared_state_revision)
        barrier.wait(timeout=60)

    _run_peers(master, 3, worker, groups=[0, 0, 1])
    assert seen[0] == seen[1] == (2, 3, 2, 2, 1, 0, 0)
    assert seen[2] == (1, 3, 2, 2, 1, 0, 0)


# ------------------------------------------------------------ observability

def test_stats_counters_and_trace(master):
    """stats(): the counters and one edge a remote peer, whose tx_bytes
    cover what the reduce sent (on the descriptor path too); the flight
    recorder, switched on, holds the reduce's ring events and its
    header."""
    from pccl_tpu_torch.comm import trace_clear, trace_enable, trace_events

    count = 1 << 22       # 16 MiB: above the core's CMA threshold
    trace_enable(True)
    stats = {}
    try:
        def worker(comm, rank):
            s = comm.stats()["counters"]
            assert s["trace_ring_capacity"] == 1 << 16
            assert s["telemetry_digests"] == 0 and s["trace_ring_dropped"] == 0
            x = np.ones(count, dtype=np.float32)
            info = comm.all_reduce(x)
            assert float(x[0]) == 2.0
            stats[rank] = (comm.stats(), info)

        _run_peers(master, 2, worker)
        events = trace_events()
    finally:
        trace_enable(False)
        trace_clear()
    for st, info in stats.values():
        assert st["counters"]["collectives_ok"] >= 1
        assert len(st["edges"]) == 1
        edge, = st["edges"].values()
        assert edge["tx_bytes"] >= info.tx_bytes > 0
        assert edge["connects"] >= 1
    meta = [e for e in events if e.get("name") == "pcclt_trace_meta"]
    assert meta and {"captured", "pushed", "dropped", "ring_cap",
                     "epoch"} <= set(meta[0]["args"])
    names = {e.get("name") for e in events}
    assert {"reduce_scatter", "all_gather"} <= names, sorted(names)


def test_master_health_build_info_and_netem(master):
    """health() is served through the C API with the HTTP endpoint off
    (metrics_port 0); the build string names the core; netem_inject arms
    and disarms an edge and refuses a spec it cannot parse."""
    from pccl_tpu_torch.comm import PcclError, build_info, netem_inject

    h = master.health()
    assert h["epoch"] == 1 and h["clients"] == 0
    assert master.metrics_port == 0
    assert build_info().startswith("pcclt ")
    edge = f"127.0.0.1:{master.peer_base}"
    netem_inject(edge, "degrade@t=0s:40mbit/1s")
    netem_inject(edge, "")
    with pytest.raises(PcclError, match="INVALID_ARGUMENT"):
        netem_inject(edge, "no-such-fault")


# ----------------------------------------------------- torch and JAX peers

def test_torch_and_jax_peers_agree(master, monkeypatch):
    """One torch peer and one JAX peer in one group get identical bytes
    from broadcast, all_gather, reduce_scatter and all_to_all."""
    lib = _lib()
    # the JAX peer loads the built library through PCCLT_LIB; its loader's
    # cache is reset before and after, so no JAX test later in this
    # process finds a library it did not find itself
    monkeypatch.setenv("PCCLT_LIB", str(lib))
    monkeypatch.setattr(jax_native, "_LIB", None)
    from pccl_tpu.comm import Communicator as JComm
    from pccl_tpu_torch.comm import Communicator

    count = 3001
    results = {}

    def worker(comm, rank):
        slot = comm.gather_slot
        out = {}
        buf = _slot_data(slot, count, seed=7) if slot == 1 else \
            np.zeros(count, dtype=np.float32)
        comm.broadcast(buf, root=1, tag=11)
        out["broadcast"] = buf
        gathered, _ = comm.all_gather(_slot_data(slot, count, seed=8), tag=12)
        out["all_gather"] = np.array(gathered)
        chunk, off, _ = comm.reduce_scatter(_slot_data(slot, count, seed=9),
                                            tag=13)
        out["reduce_scatter"] = (off, np.array(chunk))
        send = np.concatenate([_slot_data(slot * 2 + j, 100, seed=10)
                               for j in range(2)])
        out["all_to_all"] = comm.all_to_all(send, tag=14)[0]
        results[slot] = out

    _run_peers(master, 2, worker, classes=[Communicator, JComm])
    a, b = results[0], results[1]
    assert np.array_equal(a["broadcast"], _slot_data(1, count, seed=7))
    assert np.array_equal(a["broadcast"], b["broadcast"])
    assert np.array_equal(a["all_gather"], b["all_gather"])
    assert np.array_equal(a["all_gather"][0], _slot_data(0, count, seed=8))
    total = _slot_data(0, count, seed=9) + _slot_data(1, count, seed=9)
    pieces = sorted([a["reduce_scatter"], b["reduce_scatter"]],
                    key=lambda p: p[0])
    assert np.array_equal(np.concatenate([c for _, c in pieces]), total)
    for slot, out in results.items():
        for i in range(2):
            assert np.array_equal(out["all_to_all"][i * 100:(i + 1) * 100],
                                  _slot_data(i * 2 + slot, 100, seed=10))


# ---------------------------------------- HierarchicalAllReduce's staging

def test_hierarchical_shm_staging_and_windows(master):
    """shm_staging=True with windows=2 (2.1M elements, so both windows are
    above the ring's minimum and the reduce is split) gives the same bits
    as the unstaged single reduce, on both peers."""
    from pccl_tpu_torch.comm import DataType, QuantizationAlgorithm
    from pccl_tpu_torch.parallel.hierarchical import HierarchicalAllReduce

    shapes = {"w": (1024, 1500), "b": (600_000,)}
    results = {}

    def worker(comm, rank):
        gen = torch.Generator().manual_seed(rank)
        grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        template = {k: torch.empty(s) for k, s in shapes.items()}
        staged = HierarchicalAllReduce(comm, template, shm_staging=True,
                                       windows=2, max_retries=4)
        plain = HierarchicalAllReduce(comm, template)
        assert staged.shm_staging and staged.count == 2_136_000
        # a quantized ring sends from its own scratch: no stage
        assert not HierarchicalAllReduce(
            None, template, shm_staging=True,
            quantization=QuantizationAlgorithm.MIN_MAX,
            quantized_dtype=DataType.UINT8).shm_staging
        a = staged.all_reduce({k: v.clone() for k, v in grads.items()})
        b = plain.all_reduce({k: v.clone() for k, v in grads.items()})
        results[rank] = (a, b)

    _run_peers(master, 2, worker)
    for a, b in results.values():
        for k in shapes:
            assert torch.equal(a[k], b[k]), k
    for k in shapes:
        assert torch.equal(results[0][0][k], results[1][0][k]), k
