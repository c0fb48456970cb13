"""The ranks of one peer: the JAX examples' local mesh read as processes.

A JAX peer is one program over every local device
(`make_mesh(jax.devices(), ("dp", "tp"))`); here one process drives one
card, so a peer of N ranks is N processes. Rank 0 is the process the
user started. `peer_mesh` spawns ranks 1..N-1 (multiprocessing's spawn)
running the example's own entry point with the same arguments,
`entry(argv, rank=r, store=S)`, joins all N in one gloo world through a
FileStore in a temp dir, and hands each its place in the mesh: `shape`
over `axes`, by default `factor_mesh(N)` over ("dp", "tp"), as JAX
meshes N devices (2 -> (1, 2), 4 -> (1, 4), 8 -> (2, 4)). Rank r of a
DiLoCo peer runs on card r % device_count (`rank_device`), and on the
CPU only when the CPU was asked for; `train_ddp --tp` keeps every rank
on the device asked for.

Rank 0 holds the peer's communicator and decides; what it decides
reaches the other ranks through `parallel.mesh.share` before any rank
branches on it. Rank 0 ends the peer if another rank dies, and a rank
whose parent died exits.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import sys
import tempfile
import threading
import time


def rank_device(device: str, rank: int) -> str:
    """The device of rank `rank` of a peer asked to run on `device`: the
    CPU stays the CPU; a card is the card `rank` places after the one
    asked for, modulo the cards there are."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return device
    return f"cuda:{((dev.index or 0) + rank) % torch.cuda.device_count()}"


def _rank_main(entry, argv, rank: int, store: str) -> None:
    """Ranks 1..N-1: the peer's entry point, without a comm; ends when the
    parent does."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()
    code = entry(argv, rank=rank, store=store)
    sys.stdout.flush()
    os._exit(code)


def _start_ranks(entry, argv, n: int):
    """Ranks 1..n-1 as spawned processes, and the FileStore path (in a
    temp dir) they and rank 0 join through."""
    import multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="pcclt_ranks_")
    store = os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(entry, argv, r, store), daemon=True)
             for r in range(1, n)]
    for p in procs:
        p.start()
    return procs, store, tmp


def _exit_if_a_rank_dies(procs) -> None:
    """Rank 0 ends the peer if another rank dies, rather than wait in a
    collective for it."""

    def watch():
        while True:
            for p in procs:
                if p.exitcode not in (None, 0):
                    print(f"rank process {p.name} exited {p.exitcode}",
                          file=sys.stderr, flush=True)
                    os._exit(1)
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()


@contextlib.contextmanager
def peer_mesh(entry, argv, n: int, rank: int = 0, store=None,
              axes=("dp", "tp"), shape=None):
    """The mesh of this rank of an n-rank peer (None for n = 1); rank 0
    (store None) starts the others, each with `entry(argv, rank=r,
    store=...)`. On exit: the gloo world is destroyed, and rank 0 waits
    for the other ranks and removes the temp dir."""
    if n <= 1:
        yield None
        return
    import torch.distributed as dist

    from pccl_tpu_torch.parallel import mesh as mesh_lib

    procs, tmp = [], None
    if rank == 0:
        procs, store, tmp = _start_ranks(
            entry, sys.argv[1:] if argv is None else list(argv), n)
        _exit_if_a_rank_dies(procs)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=n, timeout=datetime.timedelta(hours=1))
        try:
            yield mesh_lib.make_mesh(tuple(axes), shape, backend="gloo")
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def check_mesh(ap, cfg, n: int, batch: int) -> None:
    """ap.error where factor_mesh(n) cannot run the config's model on a
    batch of `batch` sequences: its tp degree splits no whole heads, FFN
    or vocab (models/convert.tp_layout), or its dp degree does not divide
    the batch."""
    from pccl_tpu_torch.models.convert import tp_layout
    from pccl_tpu_torch.parallel.mesh import factor_mesh

    if n < 1:
        ap.error("--ranks must be at least 1")
    dp, tp = factor_mesh(n)
    try:
        tp_layout(cfg, tp)
    except ValueError as e:
        ap.error(f"--ranks {n} (dp, tp) = ({dp}, {tp}): {e}")
    if batch % dp:
        ap.error(f"--ranks {n} (dp, tp) = ({dp}, {tp}): dp does not divide "
                 f"--batch {batch}")


def add_ranks_arg(ap) -> None:
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes of this peer, one a card: the mesh is "
                         "factor_mesh(N) over (dp, tp), as the JAX example "
                         "meshes N devices; rank 0 holds the comm")


def launch_counts(group, counts) -> list:
    """Each rank's K1, K2 and K3 launches, in rank order, on the group's
    rank 0 (None on the others); [counts] without a group."""
    if group is None:
        return [list(counts)]
    import torch

    from pccl_tpu_torch.parallel.mesh import gather_to

    got = gather_to(torch.tensor(list(counts), dtype=torch.int64), group, 0)
    return None if got is None else [g.tolist() for g in got]


def mesh_fields(counts, shards) -> str:
    """What an outer line of a peer of several ranks adds: the seconds of
    the outer step's gather and scatter on rank 0 (the MeshShards') and
    every rank's K1-K3 launches (launch_counts' list); empty for one rank
    (shards None)."""
    if shards is None:
        return ""
    return (f" gather_s {shards.gather_s:.4f} scatter_s {shards.scatter_s:.4f} "
            f"rank_launches {'/'.join(','.join(map(str, c)) for c in counts)}")


def print_mesh(mesh, dev) -> None:
    """Rank 0 of a peer of several ranks prints
        mesh dp D tp T devices d0 d1 ...
    with every rank's device, in rank order; nothing for one rank."""
    if mesh is None:
        return
    import torch

    from pccl_tpu_torch.parallel.mesh import gather_to

    index = -1 if dev.type == "cpu" else (
        torch.cuda.current_device() if dev.index is None else dev.index)
    got = gather_to(torch.tensor([index]), mesh.group(*mesh.axis_names), 0)
    if got is not None:
        devs = ["cpu" if int(g) < 0 else f"cuda:{int(g)}" for g in got]
        axes = " ".join(f"{a} {mesh.size(a)}" for a in mesh.axis_names)
        print(f"mesh {axes} devices {' '.join(devs)}", flush=True)
