"""2D-grid DiLoCo: the outer state split into shards, one ring per shard.

The port of examples/grid_fsdp/grid_diloco.py. Each process is one cell
(shard g, replica r) on its own card:

                     ring (comm, peer group = g)
                 +---------------+---------------+
    shard 0      | cell (0, 0)   | cell (0, 1)   |  <- group 0 averages
                 +---------------+---------------+     pseudo-grad shard 0
    shard 1      | cell (1, 0)   | cell (1, 1)   |  <- group 1 averages
                 +---------------+---------------+     pseudo-grad shard 1
                    replica 0       replica 1
                 column = one host; its cells exchange shards via a grid file

- In a cell: H inner AdamW steps of the whole model on the cell's card
  (parallel/train.build_train_step, with the flash kernels on a card). The
  JAX cell shards its model over a local tensor-parallel mesh of every
  local device; --ranks N gives the cell that mesh, factor_mesh(N) over
  (dp, tp), as N processes (examples/ranks.py): rank 0 holds the comm,
  the grid file and the cell's whole outer shard, gathers the ranks'
  inner parameters for the outer step and scatters the assembled outer
  parameters before each inner phase. Its outer lines then add
  `gather_s G scatter_s S rank_launches a,b,c/a,b,c/...`, and `launches`
  sums the ranks'.
- Across replicas: the flat fp32 outer state (parallel/codec.py, the JAX
  leaf order) is split into --num-shards contiguous shards. A cell's shared
  state and its ring traffic are only its own shard.
- Across shards: each group publishes its updated shard into a mapped grid
  file (one a host); a cell assembles the full outer vector from it before
  each inner phase.

The outer update is host numpy in float32, in the JAX cell's order:
delta = outer[lo:hi] - inner[lo:hi], the ring AVG of delta, momentum =
mu*momentum + delta, shard = outer[lo:hi] - lr*(delta + mu*momentum). So a
group's shard stays bit-identical on every member, whichever framework
each runs, and the shared-state sync at each outer step moves 0 bytes. The
grid file is byte-compatible with the JAX cell's: JAX and torch cells can
share one file and one peer group.

Grid-fullness gate: no cell starts an outer step until global world ==
num_shards x largest group, since a partly joined column would wedge its
groups' rings. The column is the failure unit: when one cell dies, the
others hold at the gate until its column-mates are gone too (or a
replacement joins); then each ring retries down to its survivors.

Run (2 shards x 2 replicas, four cards of one host, or one card shared):
    python -m pccl_tpu_torch.comm.master --port 48500 &
    for g in 0 1; do for r in 0 1; do
        python -m pccl_tpu_torch.examples.grid_diloco --master-port 48500 \\
            --num-shards 2 --peer-group $g --base-port $((56000+g*200+r*100)) \\
            --min-replicas 2 --model gpt2 --block 1024 &
    done; done
On the CPU add `--device cpu --attn dense --model nano` (and
OMP_NUM_THREADS=1 when several cells share the host).

Each outer step prints one line:
    outer N loss L grid GxR global W shard g [lo:hi] tok_s X outer_s Y
    launches a b c digest D tx A rx B
tok_s: the inner steps' tokens per second; outer_s: the outer step (D2H
of the flat vector, ring AVG of the shard and its update, host clock);
launches: K1, K2 and K3 in the inner steps; digest: BLAKE2b of the cell's
shard after the update, equal across its group; tx, rx: the bytes of the
shared-state sync that opened the step. FINAL adds the bytes of the sync
that closed the run (last_sync_tx, last_sync_rx: 0 when the last update
was bit-identical across the group), on a card the peak of the device
memory torch allocated (peak_alloc_mib), and the process's peak resident
host memory (peak_rss_mib).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np


class GridFile:
    """Per-host mapped exchange of outer-state shards.

    Layout: int64 [magic, num_shards, count] identity header, int64[G]
    sequence header (the outer step of each shard's content, -1 = never
    written), then the float32[count] full outer vector. Writers publish
    data, then the sequence; readers wait for every sequence >= their step.
    Same-host mmap coherence makes that order sufficient (the file never
    crosses hosts: each column has its own).

    The file is scoped to one run: every cell unlinks it on a clean exit
    (`remove`, idempotent), and an incompatible file already there (another
    shape or magic, e.g. a crashed run of another model) is an error, never
    attached. A crashed run of the same shape must be cleaned up by the
    launcher: its sequence numbers cannot be told from a live cohort's."""

    MAGIC = 0x70636C74_67726964  # "pclt" "grid"
    MAGIC_FILL = -1
    _HDR = 3  # identity int64s before the per-shard sequence header

    def __init__(self, path: str, num_shards: int, count: int):
        self.path = path
        self.g = num_shards
        self.count = count
        nbytes = 8 * (self._HDR + num_shards) + 4 * count
        if not os.path.exists(path):
            # initialised privately, then hard-linked into place: the file
            # appears with its identity and -1 sequences set, so a racing
            # attacher never reads a zero header (sequence 0 would claim
            # step-0 content that was never published)
            tmp = f"{path}.init.{os.getpid()}"
            mm = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=(nbytes,))
            hdr = mm[:8 * self._HDR].view(np.int64)
            hdr[0], hdr[1], hdr[2] = self.MAGIC, num_shards, count
            mm[8 * self._HDR:8 * (self._HDR + num_shards)].view(
                np.int64)[:] = self.MAGIC_FILL
            mm.flush()
            del mm
            try:
                os.link(tmp, path)
            except FileExistsError:
                pass  # another cell won the race: validate and attach below
            finally:
                os.unlink(tmp)
        if os.path.getsize(path) != nbytes:
            raise RuntimeError(
                f"stale/incompatible grid file {path} "
                f"({os.path.getsize(path)} bytes, want {nbytes}): remove "
                "it; grid files are scoped to one run")
        self._mm = np.memmap(path, dtype=np.uint8, mode="r+", shape=(nbytes,))
        hdr = self._mm[:8 * self._HDR].view(np.int64)
        if not (hdr[0] == self.MAGIC and hdr[1] == num_shards
                and hdr[2] == count):
            raise RuntimeError(
                f"grid file {path} identity mismatch "
                f"(magic/shards/count = {list(hdr)}, want "
                f"[{self.MAGIC}, {num_shards}, {count}]): remove it")
        self.seq = self._mm[8 * self._HDR:
                            8 * (self._HDR + num_shards)].view(np.int64)
        self.vec = self._mm[8 * (self._HDR + num_shards):].view(np.float32)
        self.bounds = [count * i // num_shards for i in range(num_shards + 1)]

    def remove(self) -> None:
        """Best-effort unlink at the end of a run (idempotent across cells;
        a laggard's mapping stays valid on the unlinked inode)."""
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def publish(self, shard: int, step: int, data: np.ndarray) -> None:
        lo, hi = self.bounds[shard], self.bounds[shard + 1]
        self.vec[lo:hi] = data
        self._mm.flush()  # the data lands before the sequence tick
        self.seq[shard] = step

    def wait_all(self, step: int, timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        while bool(np.any(self.seq < step)):
            if time.time() > deadline:
                raise TimeoutError(
                    f"grid shards stuck below step {step}: {list(self.seq)}")
            time.sleep(0.002)

    def read_full(self) -> np.ndarray:
        return np.array(self.vec, dtype=np.float32)


def wait_grid_full(comm, num_shards: int, ever_full: bool = False,
                   grid: "GridFile" = None, step: int = 0,
                   timeout: float = 300.0) -> None:
    """Admit pending peers until the grid is rectangular: global world ==
    num_shards x the largest group.

    `ever_full`: once a cell has seen the full grid, a whole shard group
    that vanished no longer holds the gate, but only when that group's
    grid-file sequence already covers this cell's `step` (groups may end
    their last outer step one iteration apart, and a group that finished
    and left must not strand the one behind it; its last shard is
    published). A group that crashed mid-run has stale sequences, so the
    gate keeps holding for a replacement column. Before the grid was ever
    full, the strict condition stands."""
    deadline = time.time() + timeout
    while True:
        if comm.are_peers_pending():
            comm.update_topology()
        if comm.global_world_size == num_shards * comm.largest_peer_group:
            return
        if ever_full and comm.num_peer_groups < num_shards and (
                grid is None or bool(np.all(grid.seq >= step))):
            return  # a group finished its run and left: do not wait for it
        if time.time() > deadline:
            raise TimeoutError("grid never filled (a column is incomplete)")
        time.sleep(0.05)


def sync_with_retry(comm, state):
    """sync_shared_state, retried across churn until the survivors elect;
    returns the successful sync's SharedStateSyncInfo."""
    from pccl_tpu_torch.comm import PcclError

    while True:
        try:
            return comm.sync_shared_state(state)
        except PcclError:
            time.sleep(0.1)
            if comm.are_peers_pending():
                comm.update_topology()


def ring_average_shard(comm, shard: np.ndarray) -> None:
    """In-place AVG of `shard` across the cell's peer group, retrying over
    the survivors on churn (all_reduce_multiple_with_retry). Alone in the
    group, the shard is its own average."""
    from pccl_tpu_torch.comm import PcclError, ReduceOp, TooFewPeersError

    try:
        comm.all_reduce(shard, op=ReduceOp.AVG)
        return
    except TooFewPeersError:
        return
    except PcclError:
        pass
    while True:
        try:
            comm.update_topology()
            comm.all_reduce_multiple_with_retry([shard], op=ReduceOp.AVG)
            return
        except TooFewPeersError:
            return
        except PcclError:
            time.sleep(0.1)


def main(argv=None, rank: int = 0, store=None) -> int:
    ap = argparse.ArgumentParser()
    from pccl_tpu_torch.examples import common, ranks

    common.add_comm_args(ap)
    ranks.add_ranks_arg(ap)
    ap.add_argument("--num-shards", type=int, default=2,
                    help="outer-state shards = peer groups = grid rows; "
                         "--peer-group selects this cell's shard")
    ap.add_argument("--min-replicas", type=int, default=1,
                    help="wait until this cell's group has this many peers")
    ap.add_argument("--grid-file", default=None,
                    help="per-host mapped shard-exchange file "
                         "(default /dev/shm keyed by master port)")
    ap.add_argument("--outer-steps", type=int, default=8,
                    help="terminal shared-state revision (joiners resume "
                         "from the synced revision and run the remainder)")
    ap.add_argument("--inner-steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
    common.add_data_args(ap)
    common.add_model_args(ap)
    args = ap.parse_args(argv)
    if args.solo:
        ap.error("the grid example needs a comm (no --solo)")
    if args.quantize != "none":
        ap.error("the grid's rings are not quantized (a quantized average "
                 "would differ from the JAX cells')")
    g = args.peer_group
    if not 0 <= g < args.num_shards:
        ap.error("--peer-group must be < --num-shards")

    import torch

    from pccl_tpu_torch.utils.rss import peak_rss_mib

    args.device = ranks.rank_device(args.device, rank)
    dev, attn_fn = common.device_and_attention(ap, args)
    cfg = common.model_config(args, char_level=args.data == "text")
    ranks.check_mesh(ap, cfg, args.ranks, args.batch)
    with ranks.peer_mesh(main, argv, args.ranks, rank, store) as mesh:
        first_loss, last_loss, comm, info, grid = _run(args, dev, attn_fn, cfg, mesh)
    if rank:
        return 0
    extra = "" if info is None else \
        f" last_sync_tx={info.tx_bytes} last_sync_rx={info.rx_bytes}"
    if dev.type == "cuda":
        extra += f" peak_alloc_mib={torch.cuda.max_memory_allocated(dev) >> 20}"
    extra += f" peak_rss_mib={peak_rss_mib()}"
    code = common.report_final(first_loss, last_loss, comm,
                               require_descent=not args.no_descent_check,
                               extra=extra)
    grid.remove()  # the file is scoped to this run
    return code


def _run(args, dev, attn_fn, cfg, mesh):
    """The loop of one rank; (first loss, last loss, comm, the last sync's
    info, the grid file) on rank 0."""
    import torch

    from pccl_tpu_torch.comm import SharedState, TensorInfo
    from pccl_tpu_torch.examples import common, ranks
    from pccl_tpu_torch.models.convert import MeshShards
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.codec import build_codec
    from pccl_tpu_torch.parallel.mesh import share

    g = args.peer_group
    shards = None if mesh is None else MeshShards(cfg, mesh)
    group = None if shards is None else shards.group
    lead = shards is None or shards.lead
    # the model is built before connect(): once admitted, this cell owes
    # topology votes to its group
    state = train_lib.make_train_state(args.seed, cfg, dev, lr=args.inner_lr,
                                       mesh=mesh)
    step_fn = train_lib.build_train_step(cfg, attn_fn=attn_fn, mesh=mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def gathered():
        """The full inner parameters on rank 0 (None on the others)."""
        return state.params if shards is None else shards.gather(state.params)

    full = gathered()
    ranks.print_mesh(mesh, dev)
    codec = vec = host = None
    if lead:
        codec = build_codec(full)
        # the flat vector on the card and its host copy (pinned on a
        # card), each allocated once
        vec = torch.empty(codec.count, dtype=torch.float32, device=dev)
        host = torch.empty(codec.count, dtype=torch.float32,
                           pin_memory=dev.type == "cuda")

    def flat(full) -> np.ndarray:
        codec.flat_into(full, vec)
        host.copy_(vec)                  # D2H; waits for the device
        return host.numpy()

    def scatter_outer() -> None:
        """The outer parameters in `vec` (on rank 0) into every rank's
        parameters."""
        if shards is None:
            codec.unflat_into(vec, state.params)
        else:
            shards.scatter(codec.unflat(vec) if lead else None, state.params)

    comm = grid = None
    if lead:
        # min-world gates the cell's own group; the grid gate below
        # handles the column's completeness
        args.min_world = max(args.min_world, args.min_replicas)
        comm = common.connect(args)
        path = args.grid_file or f"/dev/shm/pcclt_grid_{args.master_port}.bin"
        grid = GridFile(path, args.num_shards, codec.count)
        lo, hi = grid.bounds[g], grid.bounds[g + 1]
        # this cell's slice of the outer state: its shard of the flat
        # parameters (equal across cells of one seed and framework; a
        # group's first sync settles it otherwise) and the shard's
        # momentum
        outer_full = np.array(flat(full))
        own_shard = np.array(outer_full[lo:hi])
        momentum = np.zeros(hi - lo, dtype=np.float32)
        step_arr = np.zeros(1, dtype=np.uint64)
    del full
    lr, mu = args.outer_lr, args.outer_momentum

    prof = common.make_profiler(args)
    next_batch = common.make_batch_fn(args, cfg.vocab_size)
    first_loss = last_loss = None
    step = 0
    ever_full = False
    info = None
    while True:
        stop = 0
        if lead:
            wait_grid_full(comm, args.num_shards, ever_full, grid=grid, step=step)
            ever_full = True
            # the shard's shared state: joiners adopt the group's shard,
            # momentum and revision
            step_arr[0] = step
            st = SharedState([
                TensorInfo.from_numpy("grid.outer_shard", own_shard),
                TensorInfo.from_numpy("grid.outer_momentum", momentum),
                TensorInfo.from_numpy("grid.step", step_arr),
            ], revision=step)
            with prof.section("sync_state"):
                info = sync_with_retry(comm, st)
            step = int(step_arr[0])
            if step >= args.outer_steps:
                grid.publish(g, step, own_shard)  # column-mates may still wait
                stop = 1
        # rank 0 decides the step and the end of the run
        stop, step = share(group, stop, step)
        if stop:
            break

        # column exchange: publish shard g, assemble the full outer vector
        if lead:
            grid.publish(g, step, own_shard)
            grid.wait_all(step)
            outer_full = grid.read_full()
            vec.copy_(torch.from_numpy(outer_full))
        scatter_outer()

        batches = [next_batch() for _ in range(args.inner_steps)]
        fa.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        with prof.section("inner"):
            for tok, tgt in batches:
                tok = torch.from_numpy(tok).to(dev, non_blocking=True)
                tgt = torch.from_numpy(tgt).to(dev, non_blocking=True)
                loss = step_fn(state, tok, tgt)
            loss = float(loss)               # waits for the last inner step
        t_inner = time.perf_counter() - t0
        counts = ranks.launch_counts(group, [fa.launches[k] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")])

        # outer step, shard g only: ring-average the pseudo-gradient across
        # the group, then Nesterov SGD on the shard, in the JAX cell's
        # float32 order
        t0 = time.perf_counter()
        with prof.section("outer/ring+sgd"):
            full = gathered()
            if lead:
                inner_flat = flat(full)
                delta = outer_full[lo:hi] - inner_flat[lo:hi]
                ring_average_shard(comm, delta)
                momentum = mu * momentum + delta
                own_shard = outer_full[lo:hi] - lr * (delta + mu * momentum)
            del full
        t_outer = time.perf_counter() - t0
        step += 1
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        if not lead:
            continue
        grid.publish(g, step, own_shard)
        tok_s = args.inner_steps * args.batch * args.block / t_inner
        digest = hashlib.blake2b(own_shard.data, digest_size=16).hexdigest()
        total = [sum(c) for c in zip(*counts)]
        print(f"outer {step} loss {loss:.4f} "
              f"grid {args.num_shards}x{comm.largest_peer_group} "
              f"global {comm.global_world_size} shard {g} [{lo}:{hi}] "
              f"tok_s {tok_s:.1f} outer_s {t_outer:.3f} launches "
              f"{total[0]} {total[1]} {total[2]} digest {digest} "
              f"tx {info.tx_bytes} rx {info.rx_bytes}"
              f"{ranks.mesh_fields(counts, shards)}",
              flush=True)

    if lead:
        common.finish_profile(args, prof)
    return first_loss, last_loss, comm, info, grid


if __name__ == "__main__":
    sys.exit(main())
