"""Native-stack loopback benchmarks: the port's copy of
pccl_tpu/comm/native_bench.py.

The numpy legs drive the same C++ core (`libpcclt.so`) through the port's
own bindings (pccl_tpu_torch.comm), so they measure what the JAX package's
copy measures. The DiLoCo and hierarchical legs hold their outer state or
gradients in torch tensors on `device` (the card unless "cpu" is asked
for): every rank of a world shares the one card, which, unlike the TPU,
no process holds alone. Every DiLoCo peer returns a BLAKE2b digest of its
final outer vector, and the runners assert that the ranks agree.

Covers the BASELINE.md target configs over the real native stack (master +
communicator processes, PCCP wire protocol):

1. ``run_allreduce_bench``            — fp32 ring all-reduce, 2 loopback
   peers; busbw = 2*(N-1)/N * bytes/t; N=2 -> bytes/t. Mirrors the
   reference's tests/basic_reduce_test/main.cpp.
2. ``run_quantized_concurrent_bench`` — int8 zero-point/scale quantized
   concurrent reduces, 4 loopback peers. Mirrors the reference's
   tests/concurrent_reduce_test/main.cpp:48-50 (the
   pcclAllReduceMultipleWithRetry workload).
3. ``run_shared_state_bench``         — per-step SyncSharedState + one
   all-reduce, 4 peers. Mirrors the python examples' training-step shape.
4. ``run_diloco_outer_bench``         — DiLoCo outer-step wall-clock at
   ``params_n`` parameters, 2 peers (device staging + AVG ring + outer SGD).

Every runner takes its master port and port base as arguments (the
defaults are the JAX copy's bands); `PCCLT_BENCH_MASTER_PORT*` variables
still override the master ports, as they do there.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Tuple

import numpy as np


@contextmanager
def _wire_env(name: str, value: float):
    """Set a wire-emulation env var for every peer spawned inside the
    block (children inherit the env), restored on exit."""
    old = os.environ.get(name)
    os.environ[name] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _paced_wire(mbps: float):
    """PCCLT_WIRE_MBPS egress pacing (bandwidth emulation)."""
    return _wire_env("PCCLT_WIRE_MBPS", mbps)


def _rtt_wire(rtt_ms: float):
    """PCCLT_WIRE_RTT_MS round-trip-time emulation (delivery delay line in
    sockets.cpp)."""
    return _wire_env("PCCLT_WIRE_RTT_MS", rtt_ms)


def _edge_value(spec, i: int, j: int):
    """Resolve edge (i -> j) from a scalar, a world x world matrix, or a
    {(i, j): value} dict; None entries mean 'unconstrained'."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        return spec.get((i, j))
    if isinstance(spec, (list, tuple)):
        return spec[i][j]
    return spec  # scalar: every edge


def _endpoint_ports(port_base: int, rank: int):
    """The ports a peer at `rank` is REACHED on (_rank_ports layout): p2p
    (data plane + edge key canonicalized by the P2P hello) and bench (the
    topology optimizer's probe target)."""
    p2p, _ss, bench = _rank_ports(port_base, rank)
    return (p2p, bench)


@contextmanager
def wire_topology(world: int, port_base: int, mbps=None, rtt_ms=None,
                  jitter_ms=None, drop=None, host: str = "127.0.0.1"):
    """Build per-rank PCCLT_WIRE_*_MAP env dicts describing a heterogeneous
    emulated mesh over a loopback world (netem.hpp). Yields a list of env
    dicts, one per rank; each spawned peer applies its own via
    ``os.environ.update(envs[rank])`` BEFORE constructing its Communicator
    (the native layer re-reads the env at every connection establishment).

    Edge (i -> j) constraints live in rank i's env, keyed by rank j's
    endpoints — both the p2p port (data plane; the P2P hello canonicalizes
    accepted conns to it) and the bench port (so ``optimize_topology``'s
    bandwidth probes measure the same emulated edge the ring will ride).

    ``mbps`` / ``rtt_ms`` / ``jitter_ms`` / ``drop`` each accept a scalar
    (uniform), a world x world matrix, or a {(i, j): value} dict; None
    entries leave that edge/dimension unconstrained. The process-global
    PCCLT_WIRE_MBPS / PCCLT_WIRE_RTT_MS vars keep acting as defaults for
    unmapped edges. Nothing in THIS process's environment is touched —
    the context-manager shape only scopes the description; the maps take
    effect in whichever peer applies its env dict."""
    var_specs = (("PCCLT_WIRE_MBPS_MAP", mbps),
                 ("PCCLT_WIRE_RTT_MS_MAP", rtt_ms),
                 ("PCCLT_WIRE_JITTER_MS_MAP", jitter_ms),
                 ("PCCLT_WIRE_DROP_MAP", drop))
    # the native layer's canonical v6 endpoint form is bracketed
    # ("[::1]:5000" — Addr::str()); a bare "::1:5000" key would never match
    key_host = f"[{host}]" if ":" in host and not host.startswith("[") else host
    envs = []
    for i in range(world):
        env: Dict[str, str] = {}
        for var, spec in var_specs:
            entries = []
            for j in range(world):
                if j == i:
                    continue
                v = _edge_value(spec, i, j)
                if v is None:
                    continue
                for port in _endpoint_ports(port_base, j):
                    entries.append(f"{key_host}:{port}={v}")
            if entries:
                env[var] = ",".join(entries)
        envs.append(env)
    yield envs


def _port(env: str, dflt: int) -> int:
    return int(os.environ.get(env, str(dflt)))


def _rank_ports(port_base: int, rank: int) -> Tuple[int, int, int]:
    """The bench harness's port layout for a peer at `rank`: (p2p, ss,
    bench). Single source of truth for _connect, the topology peers, and
    wire_topology's map keys — a stride change that misses one of them
    would silently mis-key the per-edge emulation."""
    return (port_base + rank * 4,
            port_base + 1000 + rank * 4,
            port_base + 2000 + rank * 4)


def _spawn_world(world: int, peer_main: Callable, master_port: int,
                 args: tuple = (), inline_rank0: bool = True,
                 timeout_s: int = 300) -> List[Dict[str, Any]]:
    """Run `peer_main(rank, master_port, q, *args)` in `world` processes
    (rank 0 inline unless `inline_rank0` is False — peers that mutate global
    process state, e.g. the wire-emulation env or a CUDA context, must not
    run in the caller) and return each peer's result dict."""
    from pccl_tpu_torch.comm.api import MasterNode

    master = MasterNode("0.0.0.0", master_port)
    master.run()
    try:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = []
        for r in range(0 if not inline_rank0 else 1, world):
            p = ctx.Process(target=peer_main, args=(r, master.port, q) + args)
            p.start()
            procs.append(p)
        try:
            if inline_rank0:
                peer_main(0, master.port, q, *args)
            results = [q.get(timeout=timeout_s) for _ in range(world)]
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
        return results
    finally:
        master.interrupt()
        master.destroy()


def _connect(rank: int, master_port: int, world: int, port_base: int):
    """Join and wait until the group reaches `world` peers."""
    from pccl_tpu_torch.comm.api import Communicator

    p2p, ss, bench = _rank_ports(port_base, rank)
    comm = Communicator("127.0.0.1", master_port,
                        p2p_port=p2p, ss_port=ss, bench_port=bench)
    comm.connect()
    while comm.world_size < world:
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.02)
    return comm


# ---------------------------------------------------------------- config 1

def _phase_breakdown(events, iters: int) -> Dict[str, float]:
    """Aggregate the flight recorder's per-op events into a mean per-op
    phase breakdown (seconds): reduce-scatter / all-gather span time plus
    the wire-stall and quantize accumulators (telemetry.hpp)."""
    sums: Dict[str, float] = {}
    for e in events:
        name, args = e.get("name"), e.get("args", {})
        if name in ("reduce_scatter", "all_gather", "allreduce", "allgather") \
                and e.get("ph") == "X":
            sums[name] = sums.get(name, 0.0) + e.get("dur", 0.0) / 1e6
        elif name in ("wire_stall", "quantize") and "ns" in args:
            sums[name] = sums.get(name, 0.0) + args["ns"] / 1e9
    return {f"{k}_s": round(v / max(1, iters), 6) for k, v in sums.items()}


def _peer_allreduce(rank, master_port, q, nbytes, iters, dtype_name, port_base):
    from pccl_tpu_torch.comm.api import (DataType, ReduceOp, shm_ndarray,
                                   trace_clear, trace_enable, trace_events)

    bf16 = dtype_name == "bfloat16"
    dtype = np.uint16 if bf16 else np.dtype(dtype_name)
    comm = _connect(rank, master_port, 2, port_base)
    count = nbytes // np.dtype(dtype).itemsize
    # registered shm buffers: same-host peers map them and reduce zero-copy.
    # bf16 rides as uint16 bit patterns (numpy has no bfloat16): 1.0 is
    # 0x3F80, and 1.0 + 1.0 = 2.0 is 0x4000 — exact, so the check is exact.
    x = shm_ndarray(count, dtype)
    x[:] = 0x3F80 if bf16 else float(rank + 1)
    y = shm_ndarray(count, dtype)
    wire = DataType.BFLOAT16 if bf16 else None
    comm.all_reduce(x, y, op=ReduceOp.SUM, dtype=wire)  # warmup
    # rank 0 runs inline in the bench process: enable the flight recorder
    # for the timed window and pick its events out by timestamp (perf_counter
    # shares the recorder's CLOCK_MONOTONIC timebase), so a user-requested
    # PCCLT_TRACE always-on capture is neither cleared nor disabled
    env_capture = bool(os.environ.get("PCCLT_TRACE"))
    if rank == 0:
        t_mark_us = time.perf_counter() * 1e6
        trace_enable(True)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        comm.all_reduce(x, y, op=ReduceOp.SUM, dtype=wire)
        times.append(time.perf_counter() - t0)
    expect = 0x4000 if bf16 else 3.0
    assert float(y[0]) == expect, f"allreduce wrong: {y[0]} != {expect}"
    res = {"rank": rank, "times": times}
    if rank == 0:
        evs = [e for e in trace_events() if e.get("ts", 0) >= t_mark_us]
        res["phases"] = _phase_breakdown(evs, iters)
        if not env_capture:
            trace_enable(False)
            trace_clear()  # later legs in this process start clean
    q.put(res)
    comm.destroy()


def run_allreduce_bench(nbytes: int = 64 << 20, iters: int = 10,
                        dtype_name: str = "float32", port_env: str =
                        "PCCLT_BENCH_MASTER_PORT", master_port: int = 48651,
                        port_base: int = 48700,
                        return_stats: bool = False):
    """Returns busbw in GB/s (median over iters), or with
    ``return_stats=True`` a {min, med, max} dict — the dispersion that
    makes a headline move attributable (a median alone can't distinguish
    run-to-run noise from a regression)."""
    res = _spawn_world(2, _peer_allreduce, _port(port_env, master_port),
                       (nbytes, iters, dtype_name, port_base))
    r0 = next(r for r in res if r["rank"] == 0)
    gbps = sorted((nbytes / t) / 1e9 for t in r0["times"])
    # (len-1)//2 keeps the same sample the old sorted-times median picked
    # for even iters, so the headline stays comparable across rounds
    stats = {"min": gbps[0], "med": gbps[(len(gbps) - 1) // 2],
             "max": gbps[-1]}
    # flight-recorder phase breakdown (mean per op): reduce_scatter_s /
    # all_gather_s span time + wire_stall_s (+ quantize_s when quantized)
    if "phases" in r0:
        stats["phases"] = r0["phases"]
    return stats if return_stats else stats["med"]


def run_allreduce_bench_bf16(nbytes: int = 64 << 20, iters: int = 10,
                             master_port: int = 48659,
                             port_base: int = 48770) -> float:
    """bf16 (the models' compute dtype) busbw GB/s, 2 loopback peers."""
    return run_allreduce_bench(nbytes, iters, dtype_name="bfloat16",
                               port_env="PCCLT_BENCH_MASTER_PORT5",
                               master_port=master_port, port_base=port_base)


# ---------------------------------------------------------------- config 2

def _peer_quant(rank, master_port, q, world, n_tensors, elems, iters,
                quantize=True, port_base=48790):
    from pccl_tpu_torch.comm.api import DataType, QuantizationAlgorithm, ReduceOp

    comm = _connect(rank, master_port, world, port_base)
    rng = np.random.default_rng(1234 + rank)
    tensors = [rng.standard_normal(elems).astype(np.float32)
               for _ in range(n_tensors)]
    kw = {}
    if quantize:
        kw = dict(quantization=QuantizationAlgorithm.ZERO_POINT_SCALE,
                  quantized_dtype=DataType.INT8)
    times = []
    for it in range(iters + 1):  # first iter is warmup
        t0 = time.perf_counter()
        comm.all_reduce_multiple_with_retry(tensors, op=ReduceOp.AVG, **kw)
        if it > 0:
            times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "times": times})
    comm.destroy()


def run_quantized_concurrent_bench(world: int = 4, n_tensors: int = 4,
                                   elems: int = 2 << 20, iters: int = 5,
                                   quantize: bool = True,
                                   master_port: int = 48653,
                                   base: int = 48790) -> float:
    """int8-ZPS quantized concurrent reduces (or the fp32 twin with
    ``quantize=False`` — recorded as concurrent4_fp32_busbw_gbps so BENCH
    is self-describing about the loopback inversion: on a free local wire
    the u8 codec work dominates and fp32 wins; see docs/08_performance.md).
    Returns payload busbw GB/s: 2*(N-1)/N * fp32_bytes / median step."""
    res = _spawn_world(world, _peer_quant,
                       _port("PCCLT_BENCH_MASTER_PORT2", master_port),
                       (world, n_tensors, elems, iters, quantize, base))
    times = next(r["times"] for r in res if r["rank"] == 0)
    med = sorted(times)[len(times) // 2]
    payload = n_tensors * elems * 4
    return (2 * (world - 1) / world) * payload / med / 1e9


# ---------------------------------------------------------------- config 3

def _peer_shared_state(rank, master_port, q, world, elems, iters,
                       port_base=48880):
    from pccl_tpu_torch.comm.api import ReduceOp, SharedState, TensorInfo

    comm = _connect(rank, master_port, world, port_base)
    params = np.zeros(elems, dtype=np.float32)
    grad = np.full(elems, float(rank + 1), dtype=np.float32)
    out = np.empty_like(grad)
    times = []
    for it in range(iters + 1):
        t0 = time.perf_counter()
        state = SharedState(
            infos=[TensorInfo.from_numpy("params", params)], revision=it)
        comm.sync_shared_state(state)
        comm.all_reduce(grad, out, op=ReduceOp.AVG)
        params += 0.01 * out  # all peers apply the same update -> stays in sync
        if it > 0:
            times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "times": times})
    comm.destroy()


def run_shared_state_bench(world: int = 4, elems: int = 4 << 20,
                           iters: int = 5, master_port: int = 48655,
                           base: int = 48880) -> float:
    """SharedState sync + AVG all-reduce per step; returns median step
    seconds."""
    res = _spawn_world(world, _peer_shared_state,
                       _port("PCCLT_BENCH_MASTER_PORT3", master_port),
                       (world, elems, iters, base))
    times = next(r["times"] for r in res if r["rank"] == 0)
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------- config 4

def _outer_tensors(params_n: int, device) -> tuple:
    """(torch.device, {"w": zeros(params_n) fp32 on it}): a bench peer's
    outer parameters."""
    import torch

    from pccl_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev, {"w": torch.zeros(params_n, dtype=torch.float32, device=dev)}


def _fence(dev) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _inner_step(params, rank: int) -> None:
    """The synthetic inner step, in place on the parameters' buffers (the
    JAX twin's `p - 0.01 * (rank + 1)` into a donated buffer)."""
    for p in params.values():
        p.sub_(0.01 * (rank + 1))


def _outer_result(diloco, params, rank: int, dev) -> Dict[str, Any]:
    """What every DiLoCo bench peer reports besides its times: the outer
    vector's BLAKE2b digest, its first element and its extremes (every
    element follows the same arithmetic, so min == max), the steps taken,
    the platform and this process's peak host RSS."""
    from pccl_tpu_torch.utils.rss import peak_rss_mib

    w = params["w"]
    return {"rank": rank, "digest": diloco.digest(), "first": float(w[0]),
            "w_min": float(w.min()), "w_max": float(w.max()),
            "steps": diloco.step, "platform": dev.type,
            "peak_rss_mib": peak_rss_mib()}


def diloco_closed_form(world: int, steps: int, outer_lr: float = 0.7,
                       momentum: float = 0.9) -> float:
    """Every element of the bench peers' outer vector after `steps` outer
    steps of the synthetic inner step (rank r subtracts 0.01 (r + 1), so
    the averaged pseudo-gradient is 0.01 (world + 1) / 2), from 0 under
    Nesterov SGD; in exact arithmetic, against which the fp32 run differs
    by rounding only."""
    d = 0.01 * (world + 1) / 2
    outer = mom = 0.0
    for _ in range(steps):
        mom = momentum * mom + d
        outer -= outer_lr * (d + momentum * mom)
    return outer


def _check_digests(what: str, res: List[Dict[str, Any]]) -> None:
    digests = {r["rank"]: r["digest"] for r in res}
    if len(set(digests.values())) != 1:
        raise RuntimeError(f"{what}: outer-state digests differ across ranks: "
                           f"{digests}")


def _peer_diloco(rank, master_port, q, world, params_n, outer_steps, windows=1,
                 port_base=48960, device="cuda"):
    import dataclasses

    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    dev, params = _outer_tensors(params_n, device)
    comm = _connect(rank, master_port, world, port_base)
    # shm_staging: bench peers share this host, so the ring is zero-copy.
    # windows=1 by default: concurrent tagged ops pay their per-op
    # overhead on loopback (see docs/08_performance.md) — windowing pays on
    # real WAN pipes
    shm = os.environ.get("PCCLT_BENCH_DILOCO_SHM", "1") != "0"
    diloco = Diloco(comm, params, DilocoConfig(shm_staging=shm,
                                               comm_windows=windows))
    # 2 warmup steps: the first outer steps allocate and first-touch the
    # host buffers
    times = []
    for it in range(outer_steps + 2):
        _inner_step(params, rank)
        _fence(dev)  # keep inner compute out of the timing
        t0 = time.perf_counter()
        diloco.outer_step(params)
        _fence(dev)
        if it >= 2:
            times.append(time.perf_counter() - t0)
    # one more step with rank 0 profiled for the phase breakdown (timing
    # events on its stream, no fences). Only ONE rank profiles, so the
    # breakdown describes a step beside an unprofiled peer, as in
    # production. Rank 1 runs the step unprofiled alongside.
    if rank == 0:
        diloco.cfg = dataclasses.replace(diloco.cfg, profile=True)
    _inner_step(params, rank)
    _fence(dev)  # same step shape as the timed loop
    diloco.outer_step(params)
    _fence(dev)
    q.put({**_outer_result(diloco, params, rank, dev), "times": times,
           "phases": diloco.last_profile})
    comm.destroy()


def _peer_wan(rank, master_port, q, world, nbytes, iters, quantize, port_base,
              bf16=False):
    from pccl_tpu_torch.comm.api import DataType, QuantizationAlgorithm, ReduceOp

    comm = _connect(rank, master_port, world, port_base)
    rng = np.random.default_rng(7 + rank)
    kw = {}
    if bf16:
        # bf16 bit patterns ride in uint16 arrays (numpy has no bfloat16);
        # truncating f32 -> bf16 is fine for a throughput bench
        f = rng.standard_normal(nbytes // 2).astype(np.float32)
        x = (f.view(np.uint32) >> 16).astype(np.uint16)
        kw["dtype"] = DataType.BFLOAT16
    else:
        x = rng.standard_normal(nbytes // 4).astype(np.float32)
    y = np.empty_like(x)
    if quantize:
        kw.update(quantization=QuantizationAlgorithm.ZERO_POINT_SCALE,
                  quantized_dtype=DataType.UINT8)
    comm.all_reduce(x, y, op=ReduceOp.AVG, **kw)  # warmup
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        comm.all_reduce(x, y, op=ReduceOp.AVG, **kw)
        times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "times": times})
    comm.destroy()


def run_wan_bench(world: int = 4, nbytes: int = 32 << 20, iters: int = 3,
                  mbps: float = 100.0) -> Dict[str, float]:
    """The constrained-wire A/B that justifies quantization's existence
    (reference WAN pitch: docs/md/01_Introduction.md:8). Runs the same
    ``world``-peer AVG ring twice over an emulated ``mbps``-megabit wire
    (PCCLT_WIRE_MBPS egress pacing; CMA/shm force-disabled): once fp32,
    once u8 zero-point/scale. Returns fp32-equivalent busbw GB/s for both
    — 2*(N-1)/N * fp32_bytes / t, i.e. "how fast the logical gradient
    moved" — plus the speedup ratio."""
    out: Dict[str, float] = {}
    with _paced_wire(mbps):
        # bases sit in 45xxx: every derived port (p2p, ss=+1000, bench=+2000)
        # stays below the 48500+ bench masters and the 50000+ fixed test
        # ports, so a bench can run concurrently with the pytest suite
        for name, quant, mport, base in (
                ("wan_fp32_busbw_gbps", False, 48671, 45000),
                ("wan_u8zps_busbw_gbps", True, 48673, 45400)):
            res = _spawn_world(world, _peer_wan,
                               _port("PCCLT_BENCH_MASTER_PORT_WAN", mport),
                               (world, nbytes, iters, quant, base),
                               inline_rank0=False)
            times = next(r["times"] for r in res if r["rank"] == 0)
            med = sorted(times)[len(times) // 2]
            out[name] = (2 * (world - 1) / world) * nbytes / med / 1e9
    out["wan_quant_speedup"] = out["wan_u8zps_busbw_gbps"] / out["wan_fp32_busbw_gbps"]
    return out


def _peer_wan_rtt(rank, master_port, q, world, nbytes, iters, windows,
                  port_base, env=None):
    from pccl_tpu_torch.parallel.ring import avg_all_reduce_windowed

    if env:
        os.environ.update(env)  # data-plane knobs, applied pre-native-load
    comm = _connect(rank, master_port, world, port_base)
    rng = np.random.default_rng(11 + rank)
    x = rng.standard_normal(nbytes // 4).astype(np.float32)
    avg_all_reduce_windowed(comm, x, windows=windows)    # warmup
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        avg_all_reduce_windowed(comm, x, windows=windows)
        times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "times": times})
    comm.destroy()


def run_wan_rtt_windowed_bench(world: int = 4, nbytes: int = 16 << 20,
                               iters: int = 3, mbps: float = 1000.0,
                               rtt_ms: float = 50.0,
                               mports: Tuple[int, int] = (48679, 48681),
                               bases: Tuple[int, int] = (46600, 47000),
                               ) -> Dict[str, float]:
    """The fat-pipe A/B: reduce windowing's reason to exist (reference
    pitch: concurrent reduces saturating the WAN, the reference's
    docs/md/01_Introduction.md:8). Same ``world``-peer AVG
    ring over an emulated high-bandwidth-delay pipe — ``mbps`` egress
    pacing (PCCLT_WIRE_MBPS) x ``rtt_ms`` round-trip latency
    (PCCLT_WIRE_RTT_MS delivery delay line) — once as a single flow
    (windows=1), once split into 4 concurrent tagged collectives over the
    connection pool (avg_all_reduce_windowed; 4 is the most the default
    16 MB payload admits under the 1M-element window floor). A single
    flow pays every
    stage-boundary latency stall serially (each ring hop's chunk chain
    fills owd late, and the per-op consensus round trips are exposed);
    concurrent windows overlap one window's stalls with another's drain.
    Returns busbw for both plus wan_rtt_windowed_speedup (>1 = windowing
    pays on fat pipes). The win grows as the payload shrinks toward the
    bandwidth-delay product — the latency-dominated regime real
    outer-step shards live in.

    Both legs run with the windowed data-plane pipeline + io_uring backend
    (docs/08) forced OFF: these keys are the classic store-and-forward
    BASELINE, comparable across runs, and the
    windowing A/B only means something on the plane windowing was invented
    for. The new plane's number is run_wan_pipelined_bench — a single
    pipelined flow now matches/beats the 4-window figure, which is exactly
    why the baseline must stay pinned."""
    out: Dict[str, float] = {}
    env = {"PCCLT_PIPELINE": "0", "PCCLT_URING": "0"}
    with _paced_wire(mbps), _rtt_wire(rtt_ms):
        for name, windows, mport, base in (
                ("wan_rtt_single_busbw_gbps", 1, mports[0], bases[0]),
                ("wan_rtt_windowed_busbw_gbps", 4, mports[1], bases[1])):
            res = _spawn_world(world, _peer_wan_rtt,
                               _port("PCCLT_BENCH_MASTER_PORT_RTT", mport),
                               (world, nbytes, iters, windows, base, env),
                               inline_rank0=False)
            times = next(r["times"] for r in res if r["rank"] == 0)
            med = sorted(times)[len(times) // 2]
            out[name] = (2 * (world - 1) / world) * nbytes / med / 1e9
    out["wan_rtt_windowed_speedup"] = (out["wan_rtt_windowed_busbw_gbps"] /
                                       out["wan_rtt_single_busbw_gbps"])
    return out


def run_wan_pipelined_bench(world: int = 4, nbytes: int = 16 << 20,
                            iters: int = 3, mbps: float = 1000.0,
                            rtt_ms: float = 50.0, baselines=None,
                            master_port: int = 48705, base: int = 46600,
                            ) -> Dict[str, float]:
    """The zero-copy pipelined data plane on the exact fat-long-pipe map of
    run_wan_rtt_windowed_bench (same mbps × rtt × payload): ONE flow with
    the windowed quantize→send→recv→dequant pipeline + io_uring batched
    submission forced on (docs/08 "data-plane pipeline"). A single
    pipelined collective pays the per-stage one-way delay once per window
    chain instead of once per stage, recovering more than 4-way op
    windowing does (the pipelined flow should beat both keys of
    run_wan_rtt_windowed_bench) without splitting the collective or
    paying 4 consensus rounds.

    ``baselines`` (optional): a dict holding this run's
    wan_rtt_single_busbw_gbps / wan_rtt_windowed_busbw_gbps, used for the
    speedup keys; bench.py passes the values it just measured so the
    comparison is same-host, same-load."""
    out: Dict[str, float] = {}
    env = {"PCCLT_PIPELINE": "1"}  # io_uring rides its default auto-gate
    with _paced_wire(mbps), _rtt_wire(rtt_ms):
        res = _spawn_world(world, _peer_wan_rtt,
                           _port("PCCLT_BENCH_MASTER_PORT_PIPE", master_port),
                           (world, nbytes, iters, 1, base, env),
                           inline_rank0=False)
        times = next(r["times"] for r in res if r["rank"] == 0)
        med = sorted(times)[len(times) // 2]
        out["wan_pipelined_busbw_gbps"] = \
            (2 * (world - 1) / world) * nbytes / med / 1e9
    for key, name in (("wan_rtt_single_busbw_gbps", "wan_pipelined_speedup"),
                      ("wan_rtt_windowed_busbw_gbps",
                       "wan_pipelined_vs_windowed")):
        ref = (baselines or {}).get(key)
        if ref:
            out[name] = out["wan_pipelined_busbw_gbps"] / ref
    return out


def run_wan_striped_bench(world: int = 4, nbytes: int = 16 << 20,
                          iters: int = 3, mbps: float = 1000.0,
                          rtt_ms: float = 50.0, stripes: int = 4,
                          cwnd_bytes: int = 3 << 19,
                          mports: Tuple[int, int] = (48709, 48711),
                          bases: Tuple[int, int] = (47400, 47800),
                          ) -> Dict[str, float]:
    """Multipath striping A/B on the exact fat-long-pipe map of
    run_wan_pipelined_bench (same mbps × rtt × payload). BOTH legs run the
    full pipelined data plane; the baseline pins every op's window chain
    to ONE pool conn (PCCLT_STRIPE_CONNS=1), the striped leg round-robins
    the windows across
    ``stripes`` pool conns that share the one emulated edge bucket (the
    striped per-lane token bucket, docs/08 "multipath striping").

    Why striping wins when the bucket is honest about total bandwidth: a
    single flow is one TX thread serially pacing+writing 256 KiB frames —
    every scheduler oversleep between frames is modeled wire time nothing
    else can reclaim. K stripes keep K reservations queued in the bucket,
    so the wire stays busy across any one sender's scheduling jitter —
    the same reason real WANs run parallel TCP flows on fat-long pipes
    (one cwnd/seriality-limited flow cannot fill the pipe).

    The plain pair keeps the unwindowed physics (no per-flow window:
    the emulated single flow is only seriality-limited, so the striping
    win there is the scheduler-jitter absorption of the striped bucket).
    The ``_cwnd_`` pair additionally models TCP's per-flow congestion
    window (PCCLT_WIRE_CWND_BYTES = 1.5 MiB over the 50 ms RTT ≈ 30 MB/s
    per flow — the cwnd-limited single flow the ROADMAP describes); BOTH
    its legs run under the same cap, and striping multiplies flows exactly
    the way parallel TCP does on a real fat-long pipe.

    Keys: wan_striped_single_busbw_gbps (same-run pinned baseline),
    wan_striped_busbw_gbps, wan_striped_speedup (striped / single), and
    the wan_striped_cwnd_* triple."""
    out: Dict[str, float] = {}
    legs = [
        ("wan_striped_single_busbw_gbps", 1, mports[0], bases[0], None),
        ("wan_striped_busbw_gbps", stripes, mports[1], bases[1], None),
        ("wan_striped_cwnd_single_busbw_gbps", 1, mports[0] + 4, bases[0],
         str(cwnd_bytes)),
        ("wan_striped_cwnd_busbw_gbps", stripes, mports[1] + 4, bases[1],
         str(cwnd_bytes)),
    ]
    with _paced_wire(mbps), _rtt_wire(rtt_ms):
        for name, sc, mport, base, cwnd in legs:
            env = {"PCCLT_PIPELINE": "1", "PCCLT_STRIPE_CONNS": str(sc),
                   "PCCLT_PIPELINE_WINDOW": "8"}
            if cwnd is not None:
                env["PCCLT_WIRE_CWND_BYTES"] = cwnd
            res = _spawn_world(world, _peer_wan_rtt,
                               _port("PCCLT_BENCH_MASTER_PORT_STRIPE", mport),
                               (world, nbytes, iters, 1, base, env),
                               inline_rank0=False)
            times = next(r["times"] for r in res if r["rank"] == 0)
            med = sorted(times)[len(times) // 2]
            out[name] = (2 * (world - 1) / world) * nbytes / med / 1e9
    out["wan_striped_speedup"] = (out["wan_striped_busbw_gbps"] /
                                  out["wan_striped_single_busbw_gbps"])
    out["wan_striped_cwnd_speedup"] = (
        out["wan_striped_cwnd_busbw_gbps"] /
        out["wan_striped_cwnd_single_busbw_gbps"])
    return out


def _peer_topo(rank, master_port, q, world, nbytes, iters, port_base, envs,
               gate_dir):
    """Peer for the topology-optimizer proof: joins in RANK ORDER (file
    gate) so the naive ring is deterministically [0, 1, ..., world-1] and
    the emulated mesh's pessimal edge provably sits on it."""
    from pccl_tpu_torch.comm.api import Communicator, ReduceOp

    os.environ.update(envs[rank])  # this rank's per-edge wire model
    # ordered join: the master appends newcomers to the ring in join order,
    # so gating each connect on the previous rank's admission pins the
    # naive ring to rank order
    if rank > 0:
        deadline = time.time() + 120
        while not os.path.exists(os.path.join(gate_dir, str(rank - 1))):
            if time.time() > deadline:
                raise TimeoutError(f"rank {rank}: rank {rank-1} never joined")
            time.sleep(0.02)
    p2p, ss, bench = _rank_ports(port_base, rank)
    comm = Communicator("127.0.0.1", master_port,
                        p2p_port=p2p, ss_port=ss, bench_port=bench)
    comm.connect()
    with open(os.path.join(gate_dir, str(rank)), "w"):
        pass
    while comm.world_size < world:
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.02)

    rng = np.random.default_rng(5 + rank)
    x = rng.standard_normal(nbytes // 4).astype(np.float32)
    y = np.empty_like(x)

    def timed():
        comm.all_reduce(x, y, op=ReduceOp.AVG)  # warmup (and ring re-route)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            comm.all_reduce(x, y, op=ReduceOp.AVG)
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    t_naive = timed()
    # every peer votes; blocks until the master's ATSP round adopts a ring
    comm.optimize_topology()
    t_opt = timed()
    # second round: all edges already measured, so this adopts the finished
    # moonshot tour when it beats the quick solve — must improve or hold
    comm.optimize_topology()
    t_opt2 = timed()
    q.put({"rank": rank, "naive": t_naive, "opt": t_opt, "opt2": t_opt2})
    comm.destroy()


def run_topology_opt_bench(world: int = 4, nbytes: int = 4 << 20,
                           iters: int = 3, fast_mbps: float = 200.0,
                           slow_mbps: float = 25.0,
                           master_port: int = 48715,
                           port_base: int = 5000) -> Dict[str, float]:
    """The end-to-end proof that the ATSP topology optimizer wins — the
    reference's headline capability (bandwidth-aware ring optimization,
    PAPER.md), exercised on a deliberately heterogeneous emulated mesh
    (per-edge netem models, PCCLT_WIRE_*_MAP): every directed edge runs at
    ``fast_mbps`` except the pessimal pair 0<->1 at ``slow_mbps`` (+ high
    RTT), and peers join in rank order so the naive ring [0,1,...,n-1]
    provably crosses it. One slow edge gates the whole lockstep ring
    (arxiv 2606.01680's premise), so after ``optimize_topology()`` — whose
    bandwidth probes ride the same emulated edges — the adopted ring
    routes around the degraded link and the step time must drop. A second
    optimize adopts the background moonshot tour and must improve or hold.

    Returns naive/optimized/second-optimized median step seconds plus
    ``topology_opt_speedup`` (naive / optimized)."""
    import tempfile

    mbps = [[None if i == j else fast_mbps for j in range(world)]
            for i in range(world)]
    rtt = [[None if i == j else 8.0 for j in range(world)]
           for i in range(world)]
    mbps[0][1] = mbps[1][0] = slow_mbps   # the degraded link
    rtt[0][1] = rtt[1][0] = 60.0
    old_env = {k: os.environ.get(k) for k in
               ("PCCLT_BENCH_SECONDS", "PCCLT_BENCH_CONNECTIONS",
                "PCCLT_MOONSHOT_MS")}
    # short probe window + small flood pool: the optimize round serializes
    # probes per target, and per-edge pacing makes each one deterministic
    # anyway; moonshot small enough to finish before the second optimize
    os.environ["PCCLT_BENCH_SECONDS"] = "0.4"
    os.environ["PCCLT_BENCH_CONNECTIONS"] = "2"
    os.environ["PCCLT_MOONSHOT_MS"] = "400"
    try:
        with wire_topology(world, port_base, mbps=mbps, rtt_ms=rtt) as envs, \
                tempfile.TemporaryDirectory() as gate_dir:
            res = _spawn_world(world, _peer_topo,
                               _port("PCCLT_BENCH_MASTER_PORT_TOPO",
                                     master_port),
                               (world, nbytes, iters, port_base, envs,
                                gate_dir),
                               inline_rank0=False, timeout_s=600)
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    r0 = next(r for r in res if r["rank"] == 0)
    out = {"topology_naive_step_s": r0["naive"],
           "topology_opt_step_s": r0["opt"],
           "topology_opt2_step_s": r0["opt2"],
           "topology_opt_speedup": r0["naive"] / r0["opt"]}
    return out


def run_wan_bf16_bench(world: int = 4, nbytes: int = 16 << 20, iters: int = 3,
                       mbps: float = 100.0) -> Dict[str, float]:
    """bf16 twin of run_wan_bench: same paced wire, bf16 gradients plain
    (2 B/elem) vs u8-ZPS quantized from bf16 sources (1 B/elem; the typed
    widen-to-f32 SIMD kernels in quantize.cpp). Returns bf16-payload-basis
    busbw for both plus the speedup — the bytes-adjusted proof that
    quantizing the bf16 gradient dtype pays on a constrained wire."""
    out: Dict[str, float] = {}
    with _paced_wire(mbps):
        for name, quant, mport, base in (
                # same 45xxx reasoning as run_wan_bench
                ("wan_bf16_busbw_gbps", False, 48675, 45800),
                ("wan_bf16_u8zps_busbw_gbps", True, 48677, 46200)):
            res = _spawn_world(world, _peer_wan,
                               _port("PCCLT_BENCH_MASTER_PORT_WANB", mport),
                               (world, nbytes, iters, quant, base, True),
                               inline_rank0=False)
            times = next(r["times"] for r in res if r["rank"] == 0)
            med = sorted(times)[len(times) // 2]
            out[name] = (2 * (world - 1) / world) * nbytes / med / 1e9
    out["wan_bf16_quant_speedup"] = (out["wan_bf16_u8zps_busbw_gbps"] /
                                     out["wan_bf16_busbw_gbps"])
    return out


def _peer_diloco_churn(rank, master_port, q, world, params_n, n_steps, port_base,
                       device="cuda"):
    """DiLoCo peer for the churn bench: runs a FIXED number of outer steps
    (the tag-0 collective keeps live peers in lockstep, so everyone exits
    together — a wall-clock deadline would strand the last peer mid-op in
    slow retries), admitting pending joiners between steps and riding out
    churn via the ring's retry contract. rank 0 streams per-step progress
    so the orchestrator can time the SIGKILL against real steps."""
    from pccl_tpu_torch.comm.api import (Communicator, MasterUnreachableError,
                                         TooFewPeersError)
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    dev, params = _outer_tensors(params_n, device)
    # connect with retries: on a saturated host the master thread can miss
    # an accept window while peer processes churn through their imports
    for attempt in range(10):
        comm = Communicator("127.0.0.1", master_port,
                            p2p_port=port_base + rank * 8,
                            ss_port=port_base + 1000 + rank * 8,
                            bench_port=port_base + 2000 + rank * 8)
        try:
            comm.connect()
            break
        except MasterUnreachableError:
            comm.destroy()
            if attempt == 9:
                raise
            time.sleep(1.0)
    # incumbents wait for the initial world; the rejoiner (rank >= world)
    # joins whoever is alive
    deadline = time.time() + 120
    while rank < world and comm.world_size < world and time.time() < deadline:
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.02)
    diloco = Diloco(comm, params, DilocoConfig(shm_staging=True))
    steps = []
    solo = False
    for it in range(n_steps):
        if comm.are_peers_pending():
            comm.update_topology()
        _inner_step(params, rank)
        _fence(dev)
        t0 = time.perf_counter()
        try:
            diloco.outer_step(params)
            _fence(dev)
        except TooFewPeersError:
            solo = True  # everyone else finished/died; remaining steps are moot
            break
        steps.append((time.perf_counter() - t0, comm.world_size))
        if rank == 0:
            q.put({"progress": it + 1})
    q.put({**_outer_result(diloco, params, rank, dev), "steps": steps,
           "solo": solo})
    comm.destroy()


def run_diloco_churn_bench(world: int = 4, params_n: int = 12_500_000,
                           n_steps: int = 8, kill_after: int = 3,
                           master_port: int = 48679,
                           base: int = 41000,
                           device="cuda") -> Dict[str, Any]:
    """BASELINE config 5's churn clause: DiLoCo outer steps at `world`
    peers with one SIGKILL mid-run and a fresh peer rejoining (the
    reference stress recipe, stresstest_orchestrator.py:9-41). The kill
    fires once rank 0 has completed `kill_after` steady steps. Returns
    steady-state median step seconds (full world), the worst churn-window
    step (absorbs abort + retry + re-establish), and the worlds rank 0
    saw. The incumbents that finish must hold equal outer states (the
    rejoiner starts from zeros and adopts no state, so it is not held)."""
    import queue as queue_mod
    import signal

    from pccl_tpu_torch.comm.api import MasterNode

    # default base 41000: derived bands span 41000-43064, clear of the hier
    # bench (38xxx-40xxx) and the wan legs (45xxx-48xxx). Callers that may
    # run concurrently with bench.py (the pytest wedge regression) pass
    # their own master_port and base.
    master = MasterNode("0.0.0.0",
                        _port("PCCLT_BENCH_MASTER_PORT_CHURN", master_port))
    master.run()
    try:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_peer_diloco_churn,
                             args=(r, master.port, q, world, params_n, n_steps,
                                   base, device))
                 for r in range(world)]
        for p in procs:
            p.start()
        # collect rank 0's progress stream; once the ring has done
        # `kill_after` steady steps, SIGKILL the last rank mid-step and
        # bring a fresh peer into the group
        results = []
        killed = False
        rejoiner = None
        deadline = time.time() + 600
        while len(results) < world and time.time() < deadline:
            try:
                msg = q.get(timeout=10)
            except queue_mod.Empty:
                continue
            if "progress" in msg:
                if not killed and msg["progress"] >= kill_after:
                    os.kill(procs[-1].pid, signal.SIGKILL)
                    killed = True
                    rejoiner = ctx.Process(
                        target=_peer_diloco_churn,
                        args=(world, master.port, q, world, params_n, n_steps,
                              base, device))
                    rejoiner.start()
            else:
                results.append(msg)
        for p in procs + ([rejoiner] if rejoiner else []):
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    finally:
        master.interrupt()
        master.destroy()
    r0 = next((r for r in results if r["rank"] == 0), None)
    if r0 is None:
        raise RuntimeError(
            f"churn bench: rank 0 never reported (wedged?); got results from "
            f"ranks {sorted(r['rank'] for r in results)}")
    if not r0["steps"]:
        raise RuntimeError(f"churn bench: rank 0 completed no steps: {r0}")
    _check_digests("churn bench incumbents",
                   [r for r in results if r["rank"] < world])
    times = [t for t, w in r0["steps"]]
    worlds = [w for t, w in r0["steps"]]
    # steady = steps at full world; churn window = the slowest step (the one
    # that ate the abort + retry + rejoin establish)
    steady = sorted(t for t, w in r0["steps"] if w >= world) or sorted(times)
    return {
        "diloco_steady_step_s": steady[len(steady) // 2],
        "diloco_churn_step_s": max(times),
        "worlds_seen": sorted(set(worlds)),
        "steps_completed": len(times),
        "rejoiner_joined": any(r["rank"] == world for r in results),
    }


def _peer_master_recovery(rank, master_port, q, world, n_steps, port_base):
    """Peer for the master-recovery bench: small lockstep reduces, streaming
    per-step wall-clock end times + the comm's resume counter so the parent
    can time SIGKILL -> first post-restart collective."""
    from pccl_tpu_torch.comm.api import (ConnectionLostError, Communicator,
                                   OperationAbortedError)

    p2p, ss, bench = _rank_ports(port_base, rank)
    comm = Communicator("127.0.0.1", master_port, p2p_port=p2p, ss_port=ss,
                        bench_port=bench, reconnect_attempts=20,
                        reconnect_backoff_ms=50, reconnect_backoff_cap_ms=250)
    comm.connect()
    while comm.world_size < world:
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.02)
    x = np.ones(1 << 14, np.float32)
    y = np.empty_like(x)
    steps = []
    step = 0
    while step < n_steps:
        try:
            comm.all_reduce(x, y)
        except (ConnectionLostError, OperationAbortedError):
            try:
                comm.update_topology()
            except Exception:  # noqa: BLE001 — resumed next loop
                time.sleep(0.02)
            continue
        steps.append((time.time(), comm.reconnect_count))
        if rank == 0:
            q.put({"progress": step + 1, "t": time.time(),
                   "resumes": comm.reconnect_count})
        step += 1
        time.sleep(0.05)
    q.put({"rank": rank, "steps": steps})
    comm.destroy()


def run_master_recovery_bench(world: int = 3, n_steps: int = 60,
                              master_port: int = 48694,
                              base: int = 43500) -> Dict[str, Any]:
    """Master HA recovery number (docs/10): SIGKILL the journaled master
    mid-run, restart it on the same port, and measure SIGKILL -> first
    post-restart collective completing (``master_recovery_s``). Peers ride
    the native session resume — the run must finish with zero rejoins."""
    import signal
    import subprocess
    import sys
    import tempfile

    import queue as queue_mod

    port = _port("PCCLT_BENCH_MASTER_PORT_HA", master_port)
    journal = os.path.join(tempfile.mkdtemp(prefix="pcclt_ha_"),
                           "master.journal")

    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))

    def spawn_master():
        p = subprocess.Popen([sys.executable, "-m", "pccl_tpu_torch.comm.master",
                              "--port", str(port), "--journal", journal],
                             cwd=repo_root, stdout=subprocess.DEVNULL,
                             stderr=subprocess.STDOUT)
        import socket as socket_mod

        deadline = time.time() + 20
        while time.time() < deadline:
            try:
                with socket_mod.create_connection(("127.0.0.1", port),
                                                  timeout=1):
                    return p
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("bench master never started")

    master = spawn_master()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_peer_master_recovery,
                         args=(r, port, q, world, n_steps, base))
             for r in range(world)]
    t_kill = None
    t_first_resumed = None
    try:
        for p in procs:
            p.start()
        results = []
        deadline = time.time() + 300
        while len(results) < world and time.time() < deadline:
            try:
                msg = q.get(timeout=10)
            except queue_mod.Empty:
                continue
            if "progress" in msg:
                if t_kill is None and msg["progress"] >= 5:
                    master.send_signal(signal.SIGKILL)
                    master.wait(timeout=10)
                    t_kill = time.time()
                    time.sleep(0.5)  # outage window
                    master = spawn_master()
                elif (t_kill is not None and t_first_resumed is None
                      and msg["resumes"] >= 1):
                    t_first_resumed = msg["t"]
            else:
                results.append(msg)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        if master.poll() is None:
            master.kill()
        master.wait(timeout=10)
    if t_kill is None or t_first_resumed is None:
        raise RuntimeError("master recovery bench: outage never exercised "
                           f"(kill={t_kill}, resumed={t_first_resumed})")
    resumed_ranks = sum(1 for r in results
                        if any(res >= 1 for _, res in r.get("steps", [])))
    return {
        "master_recovery_s": t_first_resumed - t_kill,
        "master_recovery_resumed_peers": resumed_ranks,
    }


def _peer_tele_overhead(rank, master_port, q, nbytes, iters, port_base):
    """One loopback peer of the telemetry-overhead A/B: the observability
    plane's state (digest push cadence + trace capture) is inherited via
    env from the orchestrating leg."""
    from pccl_tpu_torch.comm.api import ReduceOp, trace_clear, trace_enable

    plane_on = os.environ.get("PCCLT_TELEMETRY_PUSH_MS", "0") != "0"
    env_capture = bool(os.environ.get("PCCLT_TRACE"))
    if plane_on:
        trace_enable(True)
    comm = _connect(rank, master_port, 2, port_base)
    count = nbytes // 4
    x = np.full(count, float(rank + 1), dtype=np.float32)
    y = np.empty_like(x)
    comm.all_reduce(x, y, op=ReduceOp.SUM)  # warmup
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        comm.all_reduce(x, y, op=ReduceOp.SUM)
        times.append(time.perf_counter() - t0)
    assert float(y[0]) == 3.0
    q.put({"rank": rank, "times": times})
    comm.destroy()
    if plane_on and not env_capture:
        trace_enable(False)
        trace_clear()  # rank 0 runs inline: later legs start clean


def run_telemetry_overhead_bench(nbytes: int = 8 << 20,
                                 iters: int = 12) -> Dict[str, float]:
    """The observability plane's cost, pinned (docs/09): median loopback
    2-peer all-reduce step time with the full plane ON (100 ms digest
    cadence + flight-recorder capture) vs OFF. Returns the step medians
    and ``telemetry_overhead_pct`` — the acceptance bound is <= 1%, noise
    floor included (counters are always on in BOTH legs; the A/B isolates
    the digest thread + event capture)."""
    def leg(plane_on: bool) -> float:
        # pin the cadence explicitly for BOTH legs (and restore whatever
        # the caller had): an inherited PCCLT_TELEMETRY_PUSH_MS would
        # silently turn the OFF leg on and zero the A/B
        prior = os.environ.get("PCCLT_TELEMETRY_PUSH_MS")
        os.environ["PCCLT_TELEMETRY_PUSH_MS"] = "100" if plane_on else "0"
        try:
            res = _spawn_world(
                2, _peer_tele_overhead,
                _port("PCCLT_BENCH_MASTER_PORT_OBS", 48721),
                (nbytes, iters, 43900))
        finally:
            if prior is None:
                os.environ.pop("PCCLT_TELEMETRY_PUSH_MS", None)
            else:
                os.environ["PCCLT_TELEMETRY_PUSH_MS"] = prior
        r0 = next(r for r in res if r["rank"] == 0)
        ts = sorted(r0["times"])
        return ts[(len(ts) - 1) // 2]
    t_off = leg(False)
    t_on = leg(True)
    return {
        "telemetry_off_step_s": t_off,
        "telemetry_on_step_s": t_on,
        "telemetry_overhead_pct": 100.0 * (t_on - t_off) / t_off,
    }


def _peer_attribution(rank, master_port, q, nbytes, iters, port_base,
                      out_dir):
    """One peer of the attribution bench: flight recorder on, a few paced
    fp32 ring steps, then dump this peer's trace for trace_critic."""
    from pccl_tpu_torch.comm.api import (ReduceOp, trace_clear, trace_dump,
                                   trace_enable, trace_events)

    env_capture = bool(os.environ.get("PCCLT_TRACE"))
    # rank 0 runs inline in the bench process, so the shared ring may hold
    # earlier legs' collectives — and their (epoch, seq) keys collide with
    # this run's, silently merging foreign timelines into the attribution.
    # Pick this leg's events out by timestamp instead (perf_counter shares
    # the recorder's CLOCK_MONOTONIC timebase, same idiom as
    # _peer_allreduce), so a user-requested PCCLT_TRACE capture is neither
    # cleared nor disabled.
    t_mark_us = time.perf_counter() * 1e6
    trace_enable(True)
    comm = _connect(rank, master_port, 2, port_base)
    count = nbytes // 4
    x = np.full(count, float(rank + 1), dtype=np.float32)
    y = np.empty_like(x)
    for _ in range(iters):
        comm.all_reduce(x, y, op=ReduceOp.SUM)
    assert float(y[0]) == 3.0
    path = os.path.join(out_dir, f"attr-peer{rank}.json")
    if rank == 0:
        evs = [e for e in trace_events() if e.get("ts", 0) >= t_mark_us]
        with open(path, "w") as f:
            json.dump({"traceEvents": evs}, f)
    else:
        trace_dump(path)  # fresh subprocess: the whole ring is this leg's
    q.put({"rank": rank, "trace": path})
    comm.destroy()
    if rank == 0 and not env_capture:
        trace_enable(False)
        trace_clear()  # rank 0 runs inline: later legs start clean


def run_attribution_bench(nbytes: int = 4 << 20, iters: int = 4,
                          base: int = 44200,
                          master_port: int = 48731) -> Dict[str, Any]:
    """Critical-path attribution keys (docs/09): a netem-paced 2-peer
    world runs with the flight recorder on, each peer dumps its trace, and
    the port's copy of trace_critic (utils/trace_critic.py) decomposes
    every collective into (peer, stage,
    edge, phase) segments — so every BENCH run carries WHERE its step time
    went (stall/codec/setup fractions + the dominant verdict), not just
    how long it took."""
    import tempfile

    from pccl_tpu_torch.utils.trace_critic import analyze_files

    wire_map = ",".join(f"127.0.0.1:{_rank_ports(base, r)[0]}=800"
                        for r in range(2))
    prior = os.environ.get("PCCLT_WIRE_MBPS_MAP")
    os.environ["PCCLT_WIRE_MBPS_MAP"] = wire_map
    # TemporaryDirectory (not mkdtemp): the multi-MB per-peer trace dumps
    # are consumed by analyze_files below and must not pile up in /tmp
    # across bench runs
    with tempfile.TemporaryDirectory(prefix="pcclt-attr-") as tmp:
        try:
            res = _spawn_world(2, _peer_attribution,
                               _port("PCCLT_BENCH_MASTER_PORT_ATTR", master_port),
                               (nbytes, iters, base, tmp))
        finally:
            if prior is None:
                os.environ.pop("PCCLT_WIRE_MBPS_MAP", None)
            else:
                os.environ["PCCLT_WIRE_MBPS_MAP"] = prior
        report = analyze_files(
            [r["trace"] for r in sorted(res, key=lambda r: r["rank"])],
            labels=[f"rank{r['rank']}" for r in
                    sorted(res, key=lambda r: r["rank"])])
    agg = report["aggregate"]
    pt = agg["phase_totals_us"]
    # the denominator is the DISJOINT wall decomposition (cw + setup +
    # stage + stall + drain); codec time runs inside the stage windows, so
    # including it would double-count and bias every fraction low
    tot = sum(v for k, v in pt.items() if k != "codec") or 1.0
    verdicts = agg["verdicts"]
    top = max(verdicts.items(), key=lambda kv: kv[1])[0] if verdicts else ""
    return {
        "attribution_ops": float(agg["ops"]),
        "attribution_coverage": agg["mean_coverage"],
        "attribution_stall_frac": (pt.get("stall", 0.0) +
                                   pt.get("drain", 0.0)) / tot,
        "attribution_codec_frac": pt.get("codec", 0.0) / tot,
        "attribution_setup_frac": (pt.get("commence_wait", 0.0) +
                                   pt.get("op_setup", 0.0)) / tot,
        "attribution_verdict": top,
    }


def _peer_degraded(rank, master_port, q, world, count, steps, fault_at,
                   fault, port_base, mbps_map, watchdog):
    """One peer of the degraded-recovery bench: deterministic fp32 ring
    steps on a uniform emulated mesh; rank 0 injects the chaos fault on its
    outbound ring edge (discovered from stats — no ring-order knowledge
    needed) before step `fault_at`."""
    os.environ["PCCLT_WIRE_MBPS_MAP"] = mbps_map
    os.environ["PCCLT_WATCHDOG"] = watchdog
    import numpy as np

    from pccl_tpu_torch.comm.api import ReduceOp, netem_inject

    comm = _connect(rank, master_port, world, port_base)
    x = np.ones(count, np.float32)
    y = np.empty_like(x)
    times = []
    for step in range(steps):
        if rank == 0 and fault and step == fault_at:
            edges = comm.stats()["edges"]
            ep = max(edges.items(), key=lambda kv: kv[1]["tx_bytes"])[0]
            netem_inject(ep, fault)
        t0 = time.perf_counter()
        comm.all_reduce(x, y, op=ReduceOp.SUM)
        times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "times": times})
    comm.destroy()


def run_degraded_recovery_bench(world: int = 4, count: int = 1 << 20,
                                steps: int = 10, fault_at: int = 4,
                                mbps: float = 300.0,
                                degrade_mbit: float = 10.0,
                                base: int = 33000) -> Dict[str, float]:
    """Straggler-immune data plane, pinned in history (docs/05):

    * ``degraded_recovery_s`` — one ring edge degrades mbps→degrade_mbit
      MID-RUN (pccltNetemInject); measured wall-clock from the fault-step's
      start until the first step back under 2x the healthy baseline. The
      watchdog→failover/relay ladder should land this within seconds — the
      un-protected world stays degraded for the fault's whole duration.
    * ``relay_overhead_pct`` — the chaos/watchdog plane compiled in and
      ARMED but idle (no fault): median step vs the watchdog disabled,
      same map. Acceptance bound <= 1%.
    """
    endpoints = ",".join(
        f"127.0.0.1:{_rank_ports(base, r)[0]}={mbps}" for r in range(world))
    out: Dict[str, float] = {}

    fault = f"degrade@t=0s:{degrade_mbit}mbit/600s"
    res = _spawn_world(world, _peer_degraded,
                       _port("PCCLT_BENCH_MASTER_PORT_CHAOS", 48689),
                       (world, count, steps, fault_at, fault, base,
                        endpoints, "1"), inline_rank0=False)
    times = next(r["times"] for r in res if r["rank"] == 0)
    baseline = sorted(times[1:fault_at])[(fault_at - 2) // 2]
    recovery = 0.0
    for t in times[fault_at:]:
        recovery += t
        if t < 2 * baseline:
            break
    out["degraded_step_baseline_s"] = baseline
    out["degraded_recovery_s"] = recovery
    out["degraded_recovered_step_s"] = times[-1]

    # idle-plane overhead: watchdog ON (armed, never tripping) vs OFF
    def leg(watchdog: str, port_env_dflt: int, leg_base: int) -> float:
        r = _spawn_world(world, _peer_degraded, port_env_dflt,
                         (world, count, steps, -1, "", leg_base,
                          ",".join(f"127.0.0.1:{_rank_ports(leg_base, i)[0]}"
                                   f"={mbps}" for i in range(world)),
                          watchdog), inline_rank0=False)
        ts = sorted(next(x["times"] for x in r if x["rank"] == 0)[1:])
        return ts[(len(ts) - 1) // 2]
    t_on = leg("1", _port("PCCLT_BENCH_MASTER_PORT_CHAOS2", 48691), 33400)
    t_off = leg("0", _port("PCCLT_BENCH_MASTER_PORT_CHAOS3", 48693), 33800)
    out["relay_overhead_pct"] = 100.0 * (t_on - t_off) / t_off
    return out


def _peer_hier(rank, master_port, q, elems, iters, quantize, port_base,
               device="cuda"):
    """One peer of the hierarchical all-reduce: its gradient on the card
    (the JAX twin emulated a TPU slice of 4 virtual CPU devices; the
    port's in-peer mesh is measured elsewhere), staged to the host through
    registered shm (or, quantized, a pinned buffer), the native ring
    across peers, optional u8-ZPS on that hop (BASELINE config 4 shape)."""
    import torch

    from pccl_tpu_torch.comm.api import DataType, QuantizationAlgorithm
    from pccl_tpu_torch.parallel.hierarchical import HierarchicalAllReduce

    dev, _ = _outer_tensors(0, device)
    comm = _connect(rank, master_port, 2, port_base)
    tree = {"g": torch.full((elems,), float(rank + 1), dtype=torch.float32,
                            device=dev)}
    kw = {}
    if quantize:
        kw = dict(quantization=QuantizationAlgorithm.ZERO_POINT_SCALE,
                  quantized_dtype=DataType.UINT8)
    h = HierarchicalAllReduce(comm, tree, shm_staging=not quantize, **kw)
    times = []
    for it in range(iters + 1):  # first is warmup (buffers' first touch)
        t0 = time.perf_counter()
        h.all_reduce(tree)       # in place: the mean lands in tree["g"]
        _fence(dev)
        if it > 0:
            times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "times": times, "platform": dev.type})
    comm.destroy()


def run_hierarchical_bench(elems: int = 8 << 20, iters: int = 3,
                           mports=(48681, 48683), bases=(38000, 38400),
                           device="cuda") -> Dict[str, float]:
    """BASELINE config 4 shape: 2 peers, global mean of an `elems` fp32
    tensor on `device` — plain DCN hop vs u8-ZPS quantized. Returns median
    step seconds for both."""
    out = {}
    # base 38000: derived bands (p2p/ss +1000/bench +2000) span 38000-40032,
    # clear of the churn bench (41xxx-43xxx), the wan legs (45xxx-48xxx),
    # the 48500+ masters and the 50000+ test ports
    for name, quant, mport, base in (("hier2_step_s", False, mports[0], bases[0]),
                                     ("hier2_q8_step_s", True, mports[1], bases[1])):
        res = _spawn_world(2, _peer_hier,
                           _port("PCCLT_BENCH_MASTER_PORT_HIER", mport),
                           (elems, iters, quant, base, device), inline_rank0=False)
        times = next(r["times"] for r in res if r["rank"] == 0)
        out[name] = sorted(times)[len(times) // 2]
    return out


def _peer_soak(rank, master_port, q, world, n_tensors, elems, port_base):
    from pccl_tpu_torch.comm.api import ReduceOp

    comm = _connect(rank, master_port, world, port_base)
    xs = [np.full(elems, float(rank + 1 + i), np.float32)
          for i in range(n_tensors)]
    warm = np.ones(1024, np.float32)
    comm.all_reduce(warm, op=ReduceOp.SUM)  # pay p2p establishment once
    t0 = time.perf_counter()
    comm.all_reduce_multiple_with_retry(xs, op=ReduceOp.SUM)
    dt = time.perf_counter() - t0
    base = world * (world + 1) / 2
    for i, x in enumerate(xs):
        assert float(x[0]) == base + world * i, f"soak value wrong: {x[0]}"
    q.put({"rank": rank, "dt": dt})
    comm.destroy()


def run_soak_bench(world: int = 8, n_tensors: int = 12,
                   elems: int = 8 << 20, master_port: int = 48703,
                   base: int = 20000) -> float:
    """The reference's concurrent_reduce_test workload at scale
    (the reference's tests/concurrent_reduce_test/main.cpp:48-50 runs 12
    concurrent 8M-element reduces): one burst of ``n_tensors`` tagged
    collectives at ``world`` peers. Returns rank 0's burst wall-clock —
    surfaced as soak8_step_s in BENCH so large-world scaling regressions
    (RX wakeup herding, master consensus cost) are visible across rounds.
    The nightly guard twin with a per-byte floor lives at
    tests/test_comm_native.py:test_large_world_concurrent_soak."""
    # base 20000: derived bands span 20000-22028 (world 8), clear of every
    # other band (nothing below the guard test's 25xxx)
    res = _spawn_world(world, _peer_soak,
                       _port("PCCLT_BENCH_MASTER_PORT_SOAK", master_port),
                       (world, n_tensors, elems, base),
                       inline_rank0=False, timeout_s=600)
    return next(r["dt"] for r in res if r["rank"] == 0)


def run_hierarchical_wan_bench(elems: int = 4 << 20, iters: int = 3,
                               mbps: float = 100.0,
                               mports=(48693, 48695),
                               bases=(31000, 31400),
                               device="cuda") -> Dict[str, float]:
    """BASELINE config 4 under its actual wire: the same 2-slice global mean
    as run_hierarchical_bench, but with the cross-slice DCN hop paced to
    ``mbps`` megabit/s (PCCLT_WIRE_MBPS; the pacer also force-disables the
    zero-copy same-host transports, so the emulation can't be bypassed).
    This is where the quantized hop earns its keep — on unpaced loopback the
    u8 codec work dominates and the quantized leg *loses* (hier2_q8_step_s >
    hier2_step_s); on a constrained inter-slice wire the 4× byte reduction
    wins. Reference intent: the piquant WAN path (the reference's
    ccoip/src/cpp/quantize.cpp:22-57). Returns median step
    seconds for both plus the speedup ratio."""
    out: Dict[str, float] = {}
    with _paced_wire(mbps):
        # bases 31000/31400: derived bands span 31000-33408, clear of the
        # unpaced hier bench (38xxx-40xxx), the diloco-wan bands (28xxx-
        # 30xxx), and the wedge-regression test's 35xxx-37xxx + 48685
        for name, quant, mport, base in (
                ("hier2_wan_step_s", False, mports[0], bases[0]),
                ("hier2_wan_q8_step_s", True, mports[1], bases[1])):
            res = _spawn_world(2, _peer_hier,
                               _port("PCCLT_BENCH_MASTER_PORT_HIERWAN", mport),
                               (elems, iters, quant, base, device),
                               inline_rank0=False)
            times = next(r["times"] for r in res if r["rank"] == 0)
            out[name] = sorted(times)[len(times) // 2]
    out["hier2_wan_quant_speedup"] = (out["hier2_wan_step_s"] /
                                      out["hier2_wan_q8_step_s"])
    return out


def _peer_diloco_wan(rank, master_port, q, world, params_n, iters, quantize,
                     port_base, device="cuda"):
    from pccl_tpu_torch.comm.api import DataType, QuantizationAlgorithm
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    dev, params = _outer_tensors(params_n, device)
    comm = _connect(rank, master_port, world, port_base)
    cfg = DilocoConfig(shm_staging=False)  # pacer disables zero-copy anyway
    if quantize:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, quantization=QuantizationAlgorithm.ZERO_POINT_SCALE,
            quantized_dtype=DataType.UINT8)
    diloco = Diloco(comm, params, cfg)
    times = _diloco_timed_steps(diloco, params, rank, iters, dev)
    q.put({**_outer_result(diloco, params, rank, dev), "times": times})
    comm.destroy()


def run_diloco_wan_bench(world: int = 2, params_n: int = 5_000_000,
                         iters: int = 2, mbps: float = 100.0,
                         mports=(48689, 48691), bases=(28000, 28400),
                         device="cuda") -> Dict[str, float]:
    """One DiLoCo outer step on a paced wire: fp32 pseudo-gradient ring vs
    u8-ZPS quantized ring at ``params_n`` parameters over an emulated
    ``mbps``-megabit egress. The production DiLoCo shape (BASELINE config 5
    runs over WAN; the reference's recipe
    python/examples/nanogpt_diloco/sync_diloco.py) — the
    quantized ring must win here or the feature is pointless. Returns median
    outer-step seconds for both plus the speedup."""
    out: Dict[str, float] = {}
    with _paced_wire(mbps):
        # bases 28000/28400: derived bands span 28000-30408, clear of the
        # hier-wan bands (31xxx-33xxx) and everything above
        for name, quant, mport, base in (
                ("diloco_wan_step_s", False, mports[0], bases[0]),
                ("diloco_wan_q8_step_s", True, mports[1], bases[1])):
            res = _spawn_world(world, _peer_diloco_wan,
                               _port("PCCLT_BENCH_MASTER_PORT_DILWAN", mport),
                               (world, params_n, iters, quant, base, device),
                               inline_rank0=False, timeout_s=600)
            _check_digests(name, res)
            times = next(r["times"] for r in res if r["rank"] == 0)
            out[name] = sorted(times)[len(times) // 2]
    out["diloco_wan_quant_speedup"] = (out["diloco_wan_step_s"] /
                                       out["diloco_wan_q8_step_s"])
    return out


def _diloco_timed_steps(diloco, params, rank, iters, dev):
    """Shared warmup+timed outer-step loop for the diloco bench peers: the
    synthetic inner step in place on the parameters' buffers (a fresh
    multi-GB output a step would time the allocator), the first iteration
    pays the host buffers' first touch, the rest are timed. Returns the
    times."""
    times = []
    for it in range(iters + 1):
        _inner_step(params, rank)
        _fence(dev)
        t0 = time.perf_counter()
        diloco.outer_step(params)
        _fence(dev)
        if it >= 1:
            times.append(time.perf_counter() - t0)
    return times


def run_diloco_1b_bench(world: int = 2, params_n: int = 1_000_000_000,
                        iters: int = 3, master_port: int = 48709,
                        base: int = 13000, device="cuda") -> Dict[str, Any]:
    """The BASELINE metric: DiLoCo outer-step wall-clock
    at 1B parameters (BASELINE.md: "DiLoCo outer-step 1B params, 4
    slices"; the reference publishes no value for it). Runs ``world``
    peers each holding a 4 GB fp32 outer vector (with momentum and the
    delta scratch, 16 GB) on `device` — shm-staged zero-copy ring — and
    returns rank 0's outer-step seconds as {median, [min, max]}, with each
    peer's peak host RSS (which counts the other peer's shm stages too,
    mapped for the zero-copy ring). Callers gate on available memory
    (`diloco_1b_host_bytes`)."""
    res = _spawn_world(world, _peer_diloco_big,
                       _port("PCCLT_BENCH_MASTER_PORT_1B", master_port),
                       (world, params_n, iters, base, device),
                       inline_rank0=False, timeout_s=1800)
    _check_digests("diloco 1b", res)
    times = sorted(next(r["times"] for r in res if r["rank"] == 0))
    return {"diloco_1b_step_s": times[len(times) // 2],
            "diloco_1b_step_s_minmax": [times[0], times[-1]],
            "diloco_1b_peak_rss_mib": [r["peak_rss_mib"] for r in
                                       sorted(res, key=lambda r: r["rank"])]}


def diloco_1b_host_bytes(world: int = 2, params_n: int = 1_000_000_000) -> int:
    """Host memory run_diloco_1b_bench needs: per peer the pinned D2H
    buffer (torch's allocator rounds it up to a power of two), two shm
    stages and the digest's host copy of the vector, and 2 GiB for the
    process and its CUDA context."""
    vec = 4 * params_n
    return world * ((1 << (vec - 1).bit_length()) + 3 * vec + (2 << 30))


def _peer_diloco_big(rank, master_port, q, world, params_n, iters, port_base,
                     device="cuda"):
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    dev, params = _outer_tensors(params_n, device)
    comm = _connect(rank, master_port, world, port_base)
    diloco = Diloco(comm, params, DilocoConfig(shm_staging=True))
    times = _diloco_timed_steps(diloco, params, rank, iters, dev)
    q.put({**_outer_result(diloco, params, rank, dev), "times": times})
    comm.destroy()


def _require_cuda(what: str, device) -> None:
    from pccl_tpu_torch._device import resolve_device

    if resolve_device(device).type != "cuda":
        raise RuntimeError(f"{what} measures the card; it needs a CUDA "
                           f"device, not {device!r}")


def _peer_diloco_cuda(rank, master_port, q, world, params_n, iters, windows,
                      port_base, device="cuda"):
    """DiLoCo peer with its outer state on the card (every rank shares the
    one card). Rank 0's phase profile is the on-card breakdown."""
    import dataclasses

    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    dev, params = _outer_tensors(params_n, device)
    comm = _connect(rank, master_port, world, port_base)
    diloco = Diloco(comm, params, DilocoConfig(shm_staging=True,
                                               comm_windows=windows))
    times = _diloco_timed_steps(diloco, params, rank, iters, dev)
    # one more step, rank 0 profiled — EVERY rank must run it (the ring is
    # a collective; a profiled step without a matching peer step stalls
    # into the abort path and the breakdown records the timeout)
    if rank == 0:
        diloco.cfg = dataclasses.replace(diloco.cfg, profile=True)
    _inner_step(params, rank)
    _fence(dev)
    diloco.outer_step(params)
    _fence(dev)
    q.put({**_outer_result(diloco, params, rank, dev), "times": times,
           "phases": diloco.last_profile})
    comm.destroy()


def run_diloco_cuda_bench(world: int = 2, params_n: int = 5_000_000,
                          iters: int = 2, mbps: float = 100.0,
                          mports=(48705, 48707), bases=(15000, 15400),
                          device="cuda") -> Dict[str, Any]:
    """The DiLoCo outer step with the outer state and the delta compute on
    the card, the pseudo-gradient crossing a ``mbps``-paced wire — the
    production WAN shape, where the wire, not the device staging, should
    dominate. The twin of the JAX package's run_diloco_tpu_bench. Two legs:

    * windows=1 — phases separable: delta on the card, D2H, ring, H2D+apply.
    * windows=4 — `_reduce_pipelined`: the D2H of window k+1 overlaps the
      ring of window k, so staging hides under the paced wire.

    Returns medians + rank-0 phase breakdowns for both legs. Raises unless
    `device` is a CUDA card and rank 0 ran there."""
    _require_cuda("run_diloco_cuda_bench", device)
    out: Dict[str, Any] = {}
    with _paced_wire(mbps):
        # bases 15000/15400 -> derived bands 15000-17408, clear of the soak
        # band (whose p2p ports start at 20000) and everything above
        for name, windows, mport, base in (
                ("diloco_cuda", 1, mports[0], bases[0]),
                ("diloco_cuda_pipelined", 4, mports[1], bases[1])):
            res = _spawn_world(world, _peer_diloco_cuda,
                               _port("PCCLT_BENCH_MASTER_PORT_DILTPU", mport),
                               (world, params_n, iters, windows, base, device),
                               inline_rank0=False, timeout_s=600)
            r0 = next(r for r in res if r["rank"] == 0)
            if r0.get("platform") != "cuda":
                raise RuntimeError(
                    f"rank 0 ran on {r0.get('platform')}, not cuda")
            _check_digests(name, res)
            out[f"{name}_step_s"] = sorted(r0["times"])[len(r0["times"]) // 2]
            out[f"{name}_phases_s"] = {k: round(v, 3)
                                       for k, v in (r0["phases"] or {}).items()}
    return out


def _matmul_burn(dev):
    """burn(n): a chain of n bf16 1024x1024 products on `dev`, fenced by
    the host readback of one element (a plain matrix product outside any
    kernel of the port, so cuBLAS serves it). The trip count is a plain
    argument: nothing is compiled for a new n."""
    import torch

    m = torch.full((1024, 1024), 1.0 / 1024.0, dtype=torch.bfloat16, device=dev)
    bufs = [torch.empty_like(m), torch.empty_like(m)]

    def burn(n: int) -> float:
        y = m
        for i in range(n):
            y = torch.matmul(y, m, out=bufs[i % 2])
        return float(y[0, 0].item())

    return burn


def _peer_diloco_async_cuda(rank, master_port, q, world, params_n, iters,
                            inner_s, sync, port_base, device="cuda"):
    """Async-vs-sync DiLoCo peer with its outer state on the card. The
    inner phase is a calibrated matmul burn of ~``inner_s`` wall seconds
    on the card (each rank calibrates itself, so the ring isn't
    skew-limited), making 'does the paced ring hide behind inner compute'
    directly readable off the step time."""
    from pccl_tpu_torch.parallel.diloco import AsyncDiloco, Diloco, DilocoConfig

    dev, params = _outer_tensors(params_n, device)
    comm = _connect(rank, master_port, world, port_base)
    dl = (Diloco if sync else AsyncDiloco)(
        comm, params, DilocoConfig(shm_staging=True))

    burn = _matmul_burn(dev)
    burn(8)  # first use: cuBLAS handle and workspace
    # calibrate on a sample long enough (>= 1 s) that one noisy readback is
    # ~10 % noise — a small-difference scheme (t64 - t8) can go negative
    # under one noisy readback and blow n_burn up by orders of magnitude; a
    # fat single sample cannot. Residual per-leg calibration skew is
    # cancelled out of hidden_s by reporting each leg's measured burn and
    # differencing per-leg overheads.
    n = 64
    while True:
        t0 = time.perf_counter()
        burn(n)
        dt = time.perf_counter() - t0
        if dt >= 1.0 or n >= 1 << 22:
            break
        n = min(max(n * 2, int(n * 1.2 / max(dt, 1e-4))), 1 << 22)
    per = dt / n
    n_burn = min(max(8, int(inner_s / per)), 1 << 24)
    t0 = time.perf_counter()
    burn(n_burn)  # the burn the timed laps actually run, measured
    measured_inner = time.perf_counter() - t0

    step_fn = dl.outer_step if sync else dl.outer_step_async
    times = []
    for it in range(iters + 1):
        t0 = time.perf_counter()
        burn(n_burn)  # the inner phase (the ring should hide under it)
        _inner_step(params, rank)
        _fence(dev)
        step_fn(params)
        _fence(dev)
        if it >= 1:  # first lap pays the buffers' first touch + pipeline fill
            times.append(time.perf_counter() - t0)
    if not sync:
        dl.finish(params)
    q.put({**_outer_result(dl, params, rank, dev), "times": times,
           "inner_s": measured_inner})
    comm.destroy()


def run_async_diloco_cuda_bench(world: int = 2, params_n: int = 5_000_000,
                                iters: int = 3, mbps: float = 100.0,
                                inner_s: float = 2.5,
                                mports=(48711, 48713), bases=(9000, 9400),
                                device="cuda") -> Dict[str, Any]:
    """Async DiLoCo's overlap claim, measured on the card: the
    one-step-delayed reduce (the reference's async_diloco.py,
    docs/md/07-.../03-AsyncDiloco.md) should make the steady-state step
    ≈ the inner-compute time, with the paced ring hidden behind it — vs
    the sync twin's compute + wire sum. Identical peers, identical
    calibrated ~``inner_s`` inner burn, same paced wire; only the DiLoCo
    class differs. Returns medians for both legs, the measured inner burn,
    and the wall-clock the overlap hides per step (sync − async). The twin
    of the JAX package's run_async_diloco_tpu_bench; raises unless `device`
    is a CUDA card and rank 0 ran there."""
    _require_cuda("run_async_diloco_cuda_bench", device)
    out: Dict[str, Any] = {}
    with _paced_wire(mbps):
        # bases 9000/9400: derived bands 9000-11408, below the 1B band
        # (13000+); the two legs here run sequentially so their own overlap
        # is moot
        for name, sync, mport, base in (
                ("async_diloco_cuda", False, mports[0], bases[0]),
                ("async_diloco_cuda_sync_twin", True, mports[1], bases[1])):
            res = _spawn_world(world, _peer_diloco_async_cuda,
                               _port("PCCLT_BENCH_MASTER_PORT_ADILTPU", mport),
                               (world, params_n, iters, inner_s, sync, base,
                                device),
                               inline_rank0=False, timeout_s=600)
            r0 = next(r for r in res if r["rank"] == 0)
            if r0.get("platform") != "cuda":
                raise RuntimeError(
                    f"rank 0 ran on {r0.get('platform')}, not cuda")
            _check_digests(name, res)
            out[f"{name}_step_s"] = sorted(r0["times"])[len(r0["times"]) // 2]
            # both legs' measured burns land in the artifact so a reader
            # can see the calibrations agreed
            out[f"{name}_inner_s"] = r0["inner_s"]
    # hidden wall per step = sync overhead (step − its own burn) minus
    # async overhead (ditto): the per-leg burn subtraction cancels the
    # small independent-calibration skew, leaving ≈ the paced ring time
    # that the async pipeline removed from the critical path
    out["async_diloco_cuda_hidden_s"] = (
        (out["async_diloco_cuda_sync_twin_step_s"]
         - out["async_diloco_cuda_sync_twin_inner_s"])
        - (out["async_diloco_cuda_step_s"]
           - out["async_diloco_cuda_inner_s"]))
    return out


def run_diloco_outer_bench(world: int = 2, params_n: int = 100_000_000,
                           outer_steps: int = 5, windows: int = 1,
                           master_port: int = 48657, base: int = 48960,
                           device="cuda", details: bool = False):
    """DiLoCo outer-step wall-clock (device staging + AVG ring + outer SGD)
    at `params_n` parameters on `device`; returns (median outer-step
    seconds, per-phase breakdown of one profiled step — delta compute, D2H,
    stage copy, ring, H2D+apply, unflatten), and with ``details`` a third
    item, every rank's result (sorted by rank: digest, first element,
    min/max, steps, peak RSS). Raises unless every rank holds the same
    outer state."""
    res = _spawn_world(world, _peer_diloco,
                       _port("PCCLT_BENCH_MASTER_PORT4", master_port),
                       (world, params_n, outer_steps, windows, base, device),
                       inline_rank0=False, timeout_s=600)
    _check_digests("diloco outer", res)
    r0 = next(r for r in res if r["rank"] == 0)
    med = sorted(r0["times"])[len(r0["times"]) // 2]
    phases = {k: round(v, 3) for k, v in (r0.get("phases") or {}).items()}
    if details:
        return med, phases, sorted(res, key=lambda r: r["rank"])
    return med, phases


# ------------------------------------------------- shared-state chunk plane

def _peer_sync_swarm(rank, master_port, q, world, seeders, keys, elems,
                     chunk_bytes, mbps, port_base):
    # env BEFORE any native object exists: the chunk size is read per sync,
    # the wildcard pacing map per connection construction. The wildcard ip
    # edge gives each PROCESS one egress bucket (a per-NIC stand-in), so a
    # single distributor is a genuine bottleneck and N seeders genuinely
    # multiply bandwidth — what the chunk plane exists to exploit.
    os.environ["PCCLT_SS_CHUNK_BYTES"] = str(chunk_bytes)
    os.environ["PCCLT_WIRE_MBPS_MAP"] = f"127.0.0.1={mbps}"
    comm = _connect(rank, master_port, world, port_base)
    rng = np.random.default_rng(424242)
    role_seeder = rank < seeders
    if role_seeder:
        arrays = {f"k{i}": rng.standard_normal(elems).astype(np.float32)
                  for i in range(keys)}
        rev = 1
    else:
        arrays = {f"k{i}": np.zeros(elems, dtype=np.float32)
                  for i in range(keys)}
        rev = 0
    from pccl_tpu_torch.comm.api import SharedState, TensorInfo
    st = SharedState([TensorInfo.from_numpy(k, v) for k, v in arrays.items()],
                     revision=rev)
    t0 = time.perf_counter()
    info = comm.sync_shared_state(st)
    wall = time.perf_counter() - t0
    digest = float(sum(v.sum() for v in arrays.values()))
    q.put({"rank": rank, "wall": wall, "rx": info.rx_bytes,
           "digest": digest, "counters": comm.stats()["counters"]})
    comm.destroy()


def run_sync_swarm_bench(world: int = 8, seeders: int = 4, keys: int = 8,
                         elems: int = 262144, chunk_bytes: int = 262144,
                         mbps: float = 250.0,
                         base: int = 34200) -> Dict[str, float]:
    """Shared-state swarm scaling (docs/04):
    ``world - seeders`` simultaneous cold joiners adopt an
    ``keys * elems * 4``-byte state, once over the content-addressed chunk
    plane (multi-source fetch + mid-round seeder promotion) and once on
    the forced single-seeder baseline (PCCLT_SS_CHUNK_BYTES=0). Keys:

    * ``sync_swarm_chunked_s`` / ``sync_swarm_legacy_s`` — slowest
      joiner's sync wall per leg;
    * ``sync_swarm_speedup`` — legacy / chunked (gate: >= 2x);
    * ``sync_swarm_resourced_chunks`` / ``_dup_chunks`` — failover noise.

    Per-chunk conservation is asserted byte-exact on every joiner:
    fetched + re-sourced - dup == unique state bytes.
    """
    nbytes = keys * elems * 4
    out: Dict[str, float] = {}

    def leg(chunk: int, port_env: str, dflt: int, leg_base: int):
        res = _spawn_world(world, _peer_sync_swarm, _port(port_env, dflt),
                           (world, seeders, keys, elems, chunk, mbps,
                            leg_base),
                           inline_rank0=False, timeout_s=420)
        joiners = [r for r in res if r["rank"] >= seeders]
        ref = next(r for r in res if r["rank"] == 0)["digest"]
        for r in joiners:
            assert r["digest"] == ref, "joiner diverged from popular content"
            assert r["rx"] == nbytes, (r["rx"], nbytes)
            c = r["counters"]
            if chunk:
                got = (c["ss_chunk_bytes_fetched"]
                       + c["ss_chunk_bytes_resourced"]
                       - c["ss_chunk_bytes_dup"])
                assert got == nbytes, f"conservation broken: {got} != {nbytes}"
        return (max(r["wall"] for r in joiners),
                sum(r["counters"]["ss_chunks_resourced"] for r in joiners),
                sum(r["counters"]["ss_chunks_dup"] for r in joiners))

    chunked, resourced, dup = leg(chunk_bytes, "PCCLT_BENCH_MASTER_PORT_SS",
                                  48691, base)
    legacy, _, _ = leg(0, "PCCLT_BENCH_MASTER_PORT_SS2", 48693, base + 600)
    out["sync_swarm_chunked_s"] = chunked
    out["sync_swarm_legacy_s"] = legacy
    out["sync_swarm_speedup"] = legacy / chunked if chunked > 0 else 0.0
    out["sync_swarm_resourced_chunks"] = float(resourced)
    out["sync_swarm_dup_chunks"] = float(dup)
    return out


# ------------------------------------------------- fleet-scale master plane

def _scrape_http(port: int, path: str = "/metrics",
                 timeout: float = 30.0) -> str:
    import socket as socket_mod
    with socket_mod.create_connection(("127.0.0.1", port),
                                      timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(f"GET {path} HTTP/1.0\r\nHost: x\r\n\r\n".encode())
        buf = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return buf.split(b"\r\n\r\n", 1)[1].decode("utf-8", "replace")


def _prom_value(text: str, name: str):
    """First sample value of an unlabelled series, or None."""
    for line in text.split("\n"):
        if line.startswith(name + " "):
            return float(line.rsplit(None, 1)[-1])
    return None


def run_master_scale_bench(peers: int = 1000, edges: int = 8,
                           hz: float = 12.0, seconds: float = 4.0,
                           threads: int = 8,
                           master_port: int = 48715) -> Dict[str, Any]:
    """The N=1000 observability gate (docs/09): one master, ``peers``
    observer sessions (the PCCP/2 hello tail byte — they push digests but
    never join the world) each pushing an ``edges``-edge digest at ``hz``,
    all from ``pccltDigestFlood`` (native threads; ctypes releases the
    GIL). Measures the whole fleet-scale surface in one run:

    * ``master_scale_ingest_rate`` — digests/s actually accepted (the
      flood is paced, so this ~= peers*hz when the master keeps up) with
      ``master_scale_digest_drops`` the bounded-queue drop count;
    * ``master_scale_fold_p99_s`` — off-dispatcher fold latency p99, from
      the master's own ``pcclt_master_digest_fold_seconds`` histogram;
    * ``master_scale_scrape_s`` / ``_bytes`` / ``_series`` — one timed
      /metrics render at the default edge top-K, promlint-validated
      (``master_scale_promlint_violations`` must be 0);
    * ``master_scale_admission_quiet_s`` vs ``_flood_s`` — the paired A/B
      on DISPATCHER round latency (observer hello -> welcome round trips
      via ``pccltAdmissionProbe``) with the digest flood off vs on: the
      enqueue-only ingest path must leave admission latency unchanged;
    * ``master_scale_health_quiet_s`` vs ``_flood_s`` — /health cost with
      the plane idle vs mid-flood (the dispatcher must stay responsive);
    * ``master_scale_replay_s`` — journal replay wall for ``peers``
      client records (cold-restart cost at fleet scale).

    CI gates (ci.yml fleet-scale lane): ingest >= 10k/s, scrape < 1 s,
    drops == 0, promlint clean."""
    import ctypes as c
    import subprocess
    import sys
    import tempfile

    from pccl_tpu_torch.comm import _native, promlint

    lib = _native.load()
    if not hasattr(lib, "pccltDigestFlood"):
        raise RuntimeError("libpcclt.so too old: no pccltDigestFlood")

    port = _port("PCCLT_BENCH_MASTER_PORT_SCALE", master_port)
    mport = port + 1
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    # fresh renders: the render cache would make the timed scrape measure
    # a memcpy; the gate is about the real top-K render at N=1000
    env["PCCLT_METRICS_MAX_AGE_MS"] = "0"
    env.pop("PCCLT_METRICS_EDGE_TOPK", None)   # default top-K = the gate
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--port", str(port),
         "--metrics-port", str(mport)],
        cwd=repo_root, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)
    out: Dict[str, Any] = {"master_scale_peers": float(peers),
                           "master_scale_edges_per_peer": float(edges)}
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                _scrape_http(mport, "/health", timeout=2)
                break
            except OSError:
                time.sleep(0.05)
        else:
            raise RuntimeError("scale-bench master never served /health")

        t0 = time.perf_counter()
        _scrape_http(mport, "/health")
        out["master_scale_health_quiet_s"] = time.perf_counter() - t0

        def admission(rounds: int = 50):
            mean = c.c_double(0.0)
            p99 = c.c_double(0.0)
            rc = lib.pccltAdmissionProbe(b"127.0.0.1", port, rounds,
                                         c.byref(mean), c.byref(p99))
            if rc != 0:
                raise RuntimeError(f"pccltAdmissionProbe rc={rc}")
            return mean.value, p99.value

        (out["master_scale_admission_quiet_s"],
         out["master_scale_admission_quiet_p99_s"]) = admission()

        sent = c.c_uint64(0)
        wall = c.c_double(0.0)
        flood_err: List[int] = []

        def flood():
            flood_err.append(lib.pccltDigestFlood(
                b"127.0.0.1", port, peers, edges, hz, seconds, threads,
                c.byref(sent), c.byref(wall)))

        import threading
        th = threading.Thread(target=flood)
        th.start()
        # mid-flood control-plane responsiveness: /health while ~peers*hz
        # digests/s are landing
        time.sleep(max(0.5, seconds * 0.4))
        t0 = time.perf_counter()
        _scrape_http(mport, "/health")
        out["master_scale_health_flood_s"] = time.perf_counter() - t0
        # the A/B's flood leg: admission round trips WHILE ~peers*hz
        # digests/s are hitting the same dispatcher
        (out["master_scale_admission_flood_s"],
         out["master_scale_admission_flood_p99_s"]) = admission()
        th.join(timeout=seconds * 20 + 120)
        if th.is_alive():
            raise RuntimeError("digest flood wedged")
        if flood_err and flood_err[0] != 0:
            raise RuntimeError(f"pccltDigestFlood rc={flood_err[0]}")
        out["master_scale_digests_sent"] = float(sent.value)
        out["master_scale_flood_wall_s"] = wall.value
        out["master_scale_ingest_rate"] = (
            sent.value / wall.value if wall.value > 0 else 0.0)

        # fold drain: every accepted digest must land in health state
        deadline = time.time() + 60
        folded = drops = 0.0
        while time.time() < deadline:
            text = _scrape_http(mport)
            folded = _prom_value(
                text, "pcclt_master_telemetry_digests_total") or 0.0
            drops = _prom_value(
                text, "pcclt_master_digest_queue_dropped_total") or 0.0
            if folded + drops >= sent.value:
                break
            time.sleep(0.2)
        out["master_scale_digests_folded"] = folded
        out["master_scale_digest_drops"] = drops
        out["master_scale_fold_p99_s"] = _prom_value(
            text, "pcclt_master_digest_fold_p99_seconds") or 0.0

        # THE scrape gate: one timed render of the steady-state surface
        t0 = time.perf_counter()
        text = _scrape_http(mport)
        out["master_scale_scrape_s"] = time.perf_counter() - t0
        out["master_scale_scrape_bytes"] = float(len(text))
        out["master_scale_scrape_series"] = float(sum(
            1 for ln in text.split("\n") if ln and not ln.startswith("#")))
        out["master_scale_promlint_violations"] = float(
            len(promlint.lint(text)))

        t0 = time.perf_counter()
        _scrape_http(mport, "/health?history=1")
        out["master_scale_health_history_s"] = time.perf_counter() - t0
    finally:
        if master.poll() is None:
            master.kill()
        master.wait(timeout=10)

    # cold-restart cost: journal write + replay of `peers` client records,
    # entirely native (pccltMasterReplayBench)
    if hasattr(lib, "pccltMasterReplayBench"):
        jpath = os.path.join(tempfile.mkdtemp(prefix="pcclt_scale_"),
                             "replay.journal")
        w_s = c.c_double(0.0)
        r_s = c.c_double(0.0)
        rc = lib.pccltMasterReplayBench(jpath.encode(), peers,
                                        c.byref(w_s), c.byref(r_s))
        if rc != 0:
            raise RuntimeError(f"pccltMasterReplayBench rc={rc}")
        out["master_scale_replay_write_s"] = w_s.value
        out["master_scale_replay_s"] = r_s.value
    return out


# ------------------------------------------------- schedule synthesizer

def _peer_sched_bcast(rank, master_port, q, world, nbytes, iters, port_base,
                      envs, gate_dir):
    """Broadcast peer for the schedule bench: rank 0 publishes its
    sorted-uuid gather slot through a file gate so every peer names the
    SAME root (slot order is join-order-racy; a root mismatch is a
    parameter disagreement and gets the minority kicked)."""
    os.environ.update(envs[rank])  # this rank's per-edge wire model
    comm = _connect(rank, master_port, world, port_base)
    # measure the emulated edges so the synthesizer's tree hangs off the
    # hub (the forced algo fixes the KIND; the shape comes from the matrix)
    comm.optimize_topology()
    root_path = os.path.join(gate_dir, "root_slot")
    if rank == 0:
        with open(root_path + ".tmp", "w") as f:
            f.write(str(comm.gather_slot))
        os.replace(root_path + ".tmp", root_path)
    deadline = time.time() + 120
    while not os.path.exists(root_path):
        if time.time() > deadline:
            raise TimeoutError(f"rank {rank}: root slot never published")
        time.sleep(0.02)
    with open(root_path) as f:
        root = int(f.read())

    count = nbytes // 4
    ref = (np.arange(count, dtype=np.float32) % 509.0) + 1.0
    buf = ref.copy() if comm.gather_slot == root \
        else np.full(count, -7.0, dtype=np.float32)
    comm.broadcast(buf, root=root, tag=31)  # warmup (+ correctness)
    if not np.array_equal(buf, ref):
        raise AssertionError(f"rank {rank}: broadcast payload mismatch")
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        comm.broadcast(buf, root=root, tag=31)
        times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "t": sorted(times)[len(times) // 2]})
    comm.destroy()


def _peer_sched_a2a(rank, master_port, q, world, nbytes, iters, port_base,
                    envs):
    """All-to-all peer for the schedule bench: slot-seeded blocks so one
    verification pass proves delivery, then a timed loop."""
    os.environ.update(envs[rank])
    comm = _connect(rank, master_port, world, port_base)
    comm.optimize_topology()  # measured matrix -> site-aware schedules
    slot = comm.gather_slot
    per = nbytes // 4 // world
    send = np.concatenate(
        [np.full(per, slot * 100.0 + j + 0.25, dtype=np.float32)
         for j in range(world)])
    recv, _ = comm.all_to_all(send, tag=32)  # warmup (+ correctness)
    for i in range(world):
        if not np.array_equal(recv[i * per:(i + 1) * per],
                              np.full(per, i * 100.0 + slot + 0.25,
                                      dtype=np.float32)):
            raise AssertionError(f"rank {rank}: a2a block {i} mismatch")
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        comm.all_to_all(send, recv, tag=32)
        times.append(time.perf_counter() - t0)
    q.put({"rank": rank, "t": sorted(times)[len(times) // 2]})
    comm.destroy()


def run_schedule_bench(world: int = 4, nbytes: int = 4 << 20, iters: int = 3,
                       hub_mbps: float = 200.0, spoke_mbps: float = 20.0,
                       intra_mbps: float = 400.0,
                       inter_mbps: float = 40.0) -> Dict[str, float]:
    """End-to-end proof that the collective schedule synthesizer (docs/12)
    beats the one-ring-for-everything baseline on the two wire shapes it
    was built for, with same-run ring baselines:

    - hub-and-spoke: every spoke<->spoke edge at ``spoke_mbps``, hub edges
      at ``hub_mbps``. Any Hamiltonian ring crosses slow spoke edges, so a
      ring broadcast is gated at ``spoke_mbps``; the bandwidth-weighted
      tree fans out from the hub root on fast edges
      (``sched_hub_speedup`` = ring / tree median step time).
    - two-datacenter: ranks split into two sites, ``intra_mbps`` inside,
      ``inter_mbps`` across. The ring all-to-all's rotation makes the
      block at distance r ride r sequential hops (multiply crossing the
      cut); the mesh sends every block once, directly
      (``sched_2dc_speedup`` = ring / mesh, plus the mesh's algorithmic
      ``alltoall_busbw_gbps`` = (N-1)/N * bytes / t).

    PCCLT_SCHEDULE_FORCE pins each leg's algorithm (master-side; the
    master lives in this process), so the deltas isolate the schedule —
    same wire, same peers, same payload."""
    import tempfile

    hub = [[None if i == j else (hub_mbps if 0 in (i, j) else spoke_mbps)
            for j in range(world)] for i in range(world)]
    half = world // 2
    twodc = [[None if i == j else
              (intra_mbps if (i < half) == (j < half) else inter_mbps)
              for j in range(world)] for i in range(world)]

    old_env = {k: os.environ.get(k) for k in
               ("PCCLT_SCHEDULE", "PCCLT_SCHEDULE_FORCE",
                "PCCLT_BENCH_SECONDS", "PCCLT_BENCH_CONNECTIONS")}
    os.environ["PCCLT_SCHEDULE"] = "1"
    os.environ["PCCLT_BENCH_SECONDS"] = "0.4"
    os.environ["PCCLT_BENCH_CONNECTIONS"] = "2"

    def bcast_leg(force, mport_env, mport, base):
        os.environ["PCCLT_SCHEDULE_FORCE"] = force
        with wire_topology(world, base, mbps=hub) as envs, \
                tempfile.TemporaryDirectory() as gate_dir:
            res = _spawn_world(world, _peer_sched_bcast,
                               _port(mport_env, mport),
                               (world, nbytes, iters, base, envs, gate_dir),
                               inline_rank0=False, timeout_s=600)
        return max(r["t"] for r in res)  # collective ends with slowest rank

    def a2a_leg(force, mport_env, mport, base):
        os.environ["PCCLT_SCHEDULE_FORCE"] = force
        with wire_topology(world, base, mbps=twodc) as envs:
            res = _spawn_world(world, _peer_sched_a2a,
                               _port(mport_env, mport),
                               (world, nbytes, iters, base, envs),
                               inline_rank0=False, timeout_s=600)
        return max(r["t"] for r in res)

    try:
        t_tree = bcast_leg("tree", "PCCLT_BENCH_MASTER_PORT_SCHED", 48741,
                           34200)
        t_bring = bcast_leg("ring", "PCCLT_BENCH_MASTER_PORT_SCHED2", 48743,
                            34600)
        t_mesh = a2a_leg("mesh", "PCCLT_BENCH_MASTER_PORT_SCHED3", 48745,
                         35000)
        t_aring = a2a_leg("ring", "PCCLT_BENCH_MASTER_PORT_SCHED4", 48747,
                          35400)
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"sched_hub_tree_step_s": t_tree,
            "sched_hub_ring_step_s": t_bring,
            "sched_hub_speedup": t_bring / t_tree,
            "sched_2dc_mesh_step_s": t_mesh,
            "sched_2dc_ring_step_s": t_aring,
            "sched_2dc_speedup": t_aring / t_mesh,
            "alltoall_busbw_gbps":
                (world - 1) / world * nbytes / t_mesh / 1e9}
