"""nanoGPT DDP over the native ring: every step's gradients are averaged
across the peers, and the parameters and AdamW state are kept identical by
a shared-state sync at every step, so a peer may join at any step and
adopt the cohort's state.

The port of examples/nanogpt_ddp/train_ddp.py. One peer is one card; its
gradients cross the ring as one flat fp32 vector
(parallel/hierarchical.py). The shared state holds, in the JAX loop's
names and order, `ddp.p{i}` (the parameters, sorted by name), `ddp.o{i}`
(AdamW's state in optax's leaf order, parallel/train.opt_state_leaves) and
`ddp.step` (a host u64). With PCCLT_SS_HASH=simple-tpu, set on every peer
of the group, the entries are hashed on the card by H1
(TensorInfo.from_torch_device): a sync in which nothing changed moves 8
bytes per entry to the host and none over the wire. Without it, which only
a CPU peer may do, the entries share the tensors' storage and the core
hashes them (TensorInfo.from_torch); a CUDA peer refuses to start rather
than stage its whole state to the host at every step.

Run (2 peers on one card):
    export PCCLT_SS_HASH=simple-tpu
    python -m pccl_tpu_torch.comm.master --port 48500 &
    python -m pccl_tpu_torch.examples.train_ddp --master-port 48500 \\
        --base-port 56000 --min-world 2 --model gpt2 --block 1024 &
    python -m pccl_tpu_torch.examples.train_ddp --master-port 48500 \\
        --base-port 56100 --min-world 2 --model gpt2 --block 1024
On the CPU add `--device cpu --model nano` (and OMP_NUM_THREADS=1 when
several peers share the host).

Each step prints one line:
    step N loss L world W revision R tok_s X ring_s Y sync_s Z tx A rx B
    launches a b c h digest D
tok_s: the step's tokens (A·B·T with --grad-accum A) over its seconds
(host clock from the step's start, sync included, to the end of the update
on the device); ring_s: the gradient all-reduce (device to host, ring,
host to device); sync_s: the shared-state sync; tx, rx: the sync's bytes;
launches: the flash kernels K1, K2, K3 and H1 in this step; digest: H1 over
the parameters after the update, equal on every peer. The FINAL line adds
params_blake2b, BLAKE2b of the flat fp32 parameters at the end, taken
independently of H1, on a card the peak of the device memory torch
allocated (peak_alloc_mib), and the process's peak resident host memory
(peak_rss_mib).

--shm-staging: the gradient vector crosses to the host into a registered
shm buffer instead of a pinned one, so that peers on one host reduce
zero-copy (parallel/hierarchical.py).
--grad-accum A: each step takes A microbatches of B sequences, one
microbatch's activations live at a time (parallel/train.py
accum_value_and_grad), and the ring still moves one averaged gradient.
--eval-every N: every N steps, the mean loss without gradients over
--eval-batches batches of the held-out split, printed as
    eval step N loss L launches a
(a: K1's launches). --checkpoint-dir: every --checkpoint-every steps the
parameters and AdamW's state (in optax's leaf order) are saved
(utils/checkpoint.Checkpointer), logged as
    checkpoint step N bytes B save_s S
and a restarted peer resumes from the newest, drains its data stream past
the batches already used and prints
    resumed from step N restore_s S
Its first sync is a probe at revision 0 when the world has other peers
(see sync_state).

--tp N (N > 1): the peer is a tensor-parallel group of N ranks, the JAX
example's in-slice mesh (dp, tp) = (1, N) read as processes. This process
is rank 0 and the peer's only Communicator; it starts ranks 1..N-1 itself
(multiprocessing's spawn, with the same arguments), joined over gloo
through a FileStore in a temp dir, all on the same device. Each rank holds
its blocks of the parameters and AdamW's state (models/convert.py) and
runs the model tensor-parallel on the same batch. Each step rank 0 gathers
the full parameters and moments (gather_s) and offers them, hashed by H1
on the card, in the JAX package's names and order; on rx it scatters the
adopted state. The gradient ring gathers the gradient blocks to rank 0,
runs the AVG there over the full tensors in codec order (the JAX peer's
vector), and scatters them back (parallel/hierarchical.py). Every decision
rank 0 takes from the comm (adopted, the step, kicked, stop) reaches the
other ranks by one small broadcast before any rank branches on it. The
step line then also shows gather_s and, after it, `rank_launches
a,b,c/a,b,c`, each rank's K1, K2 and K3 launches in the step, in rank
order; its digest folds the ranks' H1 digests of their blocks (equal
across peers of one tp degree); FINAL's
params_blake2b is over the gathered full parameters, comparable across
degrees. Checkpoints are gathered to rank 0 to save and scattered on
resume. --tp 0 (auto) and --tp 1 are a one-rank peer.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import struct
import sys
import time


def state_entries(state, step_arr, make, full=None):
    """The DDP shared state: parameters, optimizer leaves and the step,
    each tensor entry made by `make` (a TensorInfo factory). full:
    (parameters by name, leaves) to offer instead of the state's own (a tp
    peer's gathered tensors)."""
    from pccl_tpu_torch.comm import TensorInfo
    from pccl_tpu_torch.parallel import train as train_lib

    params, leaves = full or (state.params, train_lib.opt_state_leaves(state))
    params = [params[n] for n in sorted(params)]
    return ([make(f"ddp.p{i}", p) for i, p in enumerate(params)]
            + [make(f"ddp.o{i}", x) for i, x in enumerate(leaves)]
            + [TensorInfo.from_numpy("ddp.step", step_arr)])


def entry_factory(dev):
    """The shared state's TensorInfo factory for tensors on `dev`: hashed
    where they lie with PCCLT_SS_HASH=simple-tpu; otherwise, on the CPU
    only, the tensors' own storage, hashed by the core. Raises ValueError
    for a card without simple-tpu."""
    from pccl_tpu_torch.comm import TensorInfo

    if os.environ.get("PCCLT_SS_HASH") == "simple-tpu":
        return TensorInfo.from_torch_device
    if dev.type != "cpu":
        raise ValueError(
            f"on a {dev.type} device the shared state is hashed on the card: "
            "set PCCLT_SS_HASH=simple-tpu on every peer of the group")
    return TensorInfo.from_torch


def adopt(state, entries, tp=None) -> None:
    """Write what a sync received into the parameters and the optimizer.
    With a tp group (convert.TpShards) every rank calls it: rank 0 with
    the entries of the gathered tensors, the others with None, and each
    gets its blocks."""
    import torch

    from pccl_tpu_torch.parallel import train as train_lib

    names = sorted(state.params)
    n = len(names)
    if tp is not None:
        params = leaves = None
        if entries is not None:
            params = {name: e.torch_value() for name, e in zip(names, entries[:n])}
            leaves = [e.torch_value() for e in entries[n:-1]]
        train_lib.load_gathered_state(state, tp, params, leaves)
        return
    with torch.no_grad():
        for name, e in zip(names, entries[:n]):
            if e.updated:
                state.params[name].copy_(e.torch_value())
    train_lib.load_opt_state_leaves(
        state, [e.torch_value() for e in entries[n:-1]])


def checkpoint_tree(state, full=None) -> dict:
    """What a checkpoint holds: the parameters by name and AdamW's state in
    optax's leaf order (parallel/train.opt_state_leaves), the JAX
    example's {params, opt_state}; full: a tp peer's gathered (parameters,
    leaves) instead of the state's own."""
    from pccl_tpu_torch.parallel import train as train_lib

    params, leaves = full or (dict(state.params), train_lib.opt_state_leaves(state))
    return {"params": dict(params), "opt_state": list(leaves)}


def params_digest(params) -> str:
    """H1 over each parameter, sorted by name, folded into 16 hex digits."""
    return fold_digests(tensor_digests(params))


def tensor_digests(params) -> list:
    """H1 of each tensor, sorted by name."""
    from pccl_tpu_torch.ops.hashing import torch_simplehash_device

    return [torch_simplehash_device(params[n]) for n in sorted(params)]


def fold_digests(ds) -> str:
    return hashlib.blake2b(struct.pack(f"<{len(ds)}Q", *ds),
                           digest_size=8).hexdigest()


def params_blake2b(params) -> str:
    from pccl_tpu_torch.parallel.codec import build_codec

    flat = build_codec(params).flat(params).cpu()
    return hashlib.blake2b(flat.numpy().tobytes(), digest_size=16).hexdigest()


def main(argv=None, rank: int = 0, store: "str | None" = None) -> int:
    ap = argparse.ArgumentParser()
    from pccl_tpu_torch.examples import common, ranks

    common.add_comm_args(ap)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tp", type=int, default=0,
                    help="ranks of this peer's tensor-parallel group; 0 (auto) "
                         "and 1 are one rank")
    ap.add_argument("--shm-staging", action="store_true",
                    help="stage the gradient vector in a registered shm buffer "
                         "(zero-copy ring when peers share this host)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches a step; the ring still moves one "
                         "averaged gradient a step")
    common.add_lr_schedule_args(ap)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="every N steps, the mean held-out loss over "
                         "--eval-batches batches")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the parameters and AdamW's state here every "
                         "--checkpoint-every steps and resume from the "
                         "newest snapshot")
    ap.add_argument("--checkpoint-every", default=20,
                    type=lambda v: max(1, int(v)))
    common.add_data_args(ap)
    common.add_model_args(ap)
    args = ap.parse_args(argv)
    if args.grad_accum < 1:
        ap.error("--grad-accum must be at least 1")
    if args.tp < 0:
        ap.error("--tp must be 0 (auto) or more")
    n_tp = max(1, args.tp)

    dev, attn_fn = common.device_and_attention(ap, args)
    try:
        make = entry_factory(dev)
    except ValueError as e:
        ap.error(str(e))

    cfg = common.model_config(args, char_level=args.data == "text")
    if n_tp > 1:
        from pccl_tpu_torch.models.convert import tp_layout

        try:
            tp_layout(cfg, n_tp)
        except ValueError as e:
            ap.error(str(e))
    with ranks.peer_mesh(main, argv, n_tp, rank, store, axes=("tp",),
                         shape=(n_tp,)) as mesh:
        return _run(args, dev, attn_fn, make, cfg, mesh)


def _run(args, dev, attn_fn, make, cfg, mesh) -> int:
    import numpy as np
    import torch

    from pccl_tpu_torch.comm import (KickedError, PcclError, SharedState,
                                     SharedStateSyncStrategy)
    from pccl_tpu_torch.examples import common
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops import hashing
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.hierarchical import HierarchicalAllReduce
    from pccl_tpu_torch.parallel.mesh import share
    from pccl_tpu_torch.utils.data import prefetch_to_device
    from pccl_tpu_torch.utils.rss import peak_rss_mib

    tp = train_lib.tp_shards(cfg, mesh)
    tp_group = None if tp is None else tp.group
    lead = tp is None or tp.rank == 0
    comm = common.connect(args) if lead else None
    in_group, = share(tp_group, int(comm is not None))
    state = train_lib.make_train_state(
        args.seed, cfg, dev, lr=args.lr,
        schedule=common.make_schedule(args, args.lr, args.steps), mesh=mesh)
    accum = args.grad_accum
    loss_and_grad = train_lib.build_loss_and_grad(cfg, attn_fn=attn_fn,
                                                  accum_steps=accum, mesh=mesh)

    def make_ring(comm):
        # a solo tp peer has nothing to gather: its ring is the identity
        return HierarchicalAllReduce(
            comm, state.params, quantization=common.quant_from_arg(args.quantize),
            shm_staging=args.shm_staging, tp=tp if in_group else None)

    ring = make_ring(comm)
    prof = common.make_profiler(args)
    next_batch = common.make_batch_fn(args, cfg.vocab_size)

    def sync_device():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def full_state():
        """(parameters, leaves) in full on rank 0, (None, None) on the
        other ranks of a tp peer; None for a one-rank peer (its own)."""
        return None if tp is None else train_lib.gathered_state(state, tp)

    ckpt, start = None, 0
    if args.checkpoint_dir:
        from pccl_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(args.checkpoint_dir) if lead else None
        latest, = share(tp_group, -1 if ckpt is None or ckpt.latest_step() is None
                        else ckpt.latest_step())
        if latest >= 0:
            t0 = time.perf_counter()
            # loaded to the host and copied into the live tensors, so the
            # card never holds a second copy of the state
            tree = ckpt.load(_full_template(state, tp), latest) if lead \
                else {"params": None, "opt_state": None}
            train_lib.load_gathered_state(state, tp, tree["params"],
                                          tree["opt_state"])
            sync_device()
            start = latest
            # past the batches steps [0, start) used, before the prefetcher
            # starts drawing, so that a resumed run does not train on them
            # again
            for _ in range(start * accum):
                next_batch()
            if lead:
                print(f"resumed from step {latest} restore_s "
                      f"{time.perf_counter() - t0:.3f}", flush=True)

    def batches():
        while True:
            if accum > 1:
                ms = [next_batch() for _ in range(accum)]
                yield np.stack([m[0] for m in ms]), np.stack([m[1] for m in ms])
            else:
                yield next_batch()

    feed = prefetch_to_device(batches(), size=2, device=dev)

    model = train_lib.family(cfg)
    eval_batch = common.make_batch_fn(args, cfg.vocab_size, split="val") \
        if args.eval_every > 0 else None

    def evaluate(step):
        fa.reset_launch_counts()
        vals = []
        with torch.no_grad(), prof.section("eval"):
            for _ in range(args.eval_batches):
                et, ey = (torch.from_numpy(x).to(dev) for x in eval_batch())
                vals.append(float(model.loss_fn(state.params, et, ey, cfg,
                                                attn_fn, tp=tp_group)))
        if lead:
            print(f"eval step {step} loss {np.mean(vals):.4f} launches "
                  f"{fa.launches['flash_fwd']}", flush=True)

    # --- per-step shared-state sync ---
    # The DDP invariant is identical parameters and optimizer state on every
    # peer; a late joiner starts from seed parameters and a resumed peer
    # from its checkpoint, so either may have to adopt the cohort's. The
    # revision offered is the master's one-increment counter, not the step:
    # after the first sync every peer offers the agreed revision + 1, and
    # the step rides in `ddp.step`. The first offer depends on how the peer
    # came up:
    # - fresh: the step, 0. A late joiner's 0 never trips the master's
    #   `revision > last+1` kick; against a cohort that is ahead, 0 marks it
    #   outdated and it adopts parameters, optimizer state and step;
    # - resumed, with other peers in the world: a probe at revision 0.
    #   Offering the checkpoint's step to an initialised cohort would be
    #   revision last+2 or more, and the master kicks for that. Revision 0
    #   cannot be kicked and never wins an election against incumbents at
    #   their revision, so against a live cohort the peer adopts its state;
    #   in a restart of the whole cohort, every peer probing at 0, the
    #   election settles them on one checkpoint's content. It is declared
    #   enforce-popular, since the master kicks a receive-only request
    #   mixed with enforce-popular incumbents;
    # - resumed alone (world 1): the checkpoint's step; a fresh master
    #   takes any first revision.
    next_revision = None
    probe = start > 0

    def sync_state(comm, step, full):
        nonlocal next_revision, probe
        step_arr = np.array([step], dtype=np.uint64)
        entries = state_entries(state, step_arr, make, full)
        if probe and comm.world_size >= 2:
            revision = 0
        else:
            revision = step if next_revision is None else next_revision
        st = SharedState(entries, revision=revision)
        # churn mid-election: retry at the same revision until the
        # survivors elect; training through a failed sync would raise the
        # offer by more than one. A kick is terminal for the communicator.
        while True:
            try:
                info = comm.sync_shared_state(
                    st, SharedStateSyncStrategy.ENFORCE_POPULAR)
                break
            except KickedError:
                raise
            except PcclError:
                time.sleep(0.1)
                try:
                    if comm.are_peers_pending():
                        comm.update_topology()
                except KickedError:
                    raise
                except PcclError:
                    pass
        next_revision = info.revision + 1
        probe = False
        return entries, int(step_arr[0]), info

    first_loss = last_loss = None
    step = start
    while step < args.steps:
        fa.reset_launch_counts()
        hashing.reset_launch_counts()
        t_start = time.perf_counter()
        if lead:
            common.admit_pending(comm)
        tx = rx = revision = 0
        sync_s = gather_s = 0.0
        if in_group:
            full = full_state()
            gather_s = time.perf_counter() - t_start
            entries, kicked, info = None, 0, None
            if lead:
                try:
                    with prof.section("sync_state"):
                        entries, step, info = sync_state(comm, step, full)
                except KickedError:
                    # a kick ends the communicator: reconnect and offer
                    # revision 0, which cannot be kicked, so the election
                    # converges this peer onto the cohort's state
                    print("kicked during sync; reconnecting with a revision-0 "
                          "enforce-popular offer", flush=True)
                    try:
                        comm.destroy()
                    except PcclError:
                        pass
                    comm = common.connect(args)
                    ring = make_ring(comm)
                    next_revision, probe = 0, False
                    kicked = 1
            adopted, step, kicked = share(
                tp_group, int(info is not None and info.rx_bytes > 0), step, kicked)
            if kicked:
                continue
            if adopted:  # outdated: adopt the cohort's state
                adopt(state, entries, tp)
                if lead:
                    print(f"adopted shared state at step {step}", flush=True)
            sync_s = time.perf_counter() - t_start
            if info is not None:
                tx, rx, revision = info.tx_bytes, info.rx_bytes, info.revision
            del full, entries
            if step >= args.steps:
                break
        tok, tgt = next(feed)
        with prof.section("fwd+bwd"):
            loss = loss_and_grad(state, tok, tgt)
            sync_device()
        t0 = time.perf_counter()
        with prof.section("ring/all_reduce"):
            ring.all_reduce({n: p.grad for n, p in state.params.items()})
            sync_device()
        ring_s = time.perf_counter() - t0
        with prof.section("apply"):
            train_lib.apply(state)
            loss = float(loss)
            sync_device()
        tok_s = accum * args.batch * args.block / (time.perf_counter() - t_start)
        flash = [fa.launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
        rank_launches = ""
        if tp is None:
            digest = params_digest(state.params)
        else:
            # H1 of each rank's blocks and its K1-K3 launches, gathered in
            # rank order; the digests folded
            from pccl_tpu_torch.parallel.mesh import gather_to

            ds = np.array(tensor_digests(state.params), np.uint64).view(np.int64)
            got = gather_to(torch.from_numpy(np.concatenate([ds, flash])), tp.group, 0)
            digest = None if got is None else fold_digests(
                [int(d) for g in got for d in g[:-3].numpy().view(np.uint64)])
            if got is not None:
                rank_launches = " rank_launches " + "/".join(
                    ",".join(str(int(n)) for n in g[-3:]) for g in got)
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        world = comm.world_size if comm is not None else 1
        if lead:
            gather = f" gather_s {gather_s:.4f}" if tp is not None else ""
            print(f"step {step} loss {loss:.4f} world {world} revision {revision} "
                  f"tok_s {tok_s:.1f} ring_s {ring_s:.4f} sync_s {sync_s:.4f}"
                  f"{gather}{rank_launches} tx {tx} rx {rx} launches "
                  f"{' '.join(map(str, flash))} {hashing.launches['simplehash_tpu']} "
                  f"digest {digest}", flush=True)
        if eval_batch is not None and (step + 1) % args.eval_every == 0:
            evaluate(step)
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            t0 = time.perf_counter()
            full = full_state()
            if lead:
                path = ckpt.save(step + 1, checkpoint_tree(state, full))
                print(f"checkpoint step {step + 1} bytes {path.stat().st_size} "
                      f"save_s {time.perf_counter() - t0:.3f}", flush=True)
        step += 1

    feed.close()
    final = full_state()
    params = state.params if final is None else final[0]
    if not lead:
        return 0
    common.finish_profile(args, prof)
    extra = f" params_blake2b={params_blake2b(params)}"
    if dev.type == "cuda":
        extra += f" peak_alloc_mib={torch.cuda.max_memory_allocated(dev) >> 20}"
    extra += f" peak_rss_mib={peak_rss_mib()}"
    return common.report_final(
        first_loss, last_loss, comm, require_descent=not args.no_descent_check,
        extra=extra)


def _full_template(state, tp) -> dict:
    """checkpoint_tree's structure with the full shapes of a tp peer's
    blocks (meta tensors: the checkpoint's load only checks them); a
    one-rank peer's own tree."""
    import torch

    from pccl_tpu_torch.parallel import train as train_lib

    if tp is None:
        return checkpoint_tree(state)

    def full(name, t):
        return torch.empty(tp.full_shape(name, t.shape), dtype=t.dtype,
                           device="meta")

    names = sorted(state.params)
    n = len(names)
    leaves = train_lib.opt_state_leaves(state)
    return {"params": {k: full(k, v) for k, v in state.params.items()},
            "opt_state": [leaves[0]]
            + [full(k, x) for k, x in zip(names, leaves[1:1 + n])]
            + [full(k, x) for k, x in zip(names, leaves[1 + n:1 + 2 * n])]
            + leaves[1 + 2 * n:]}


if __name__ == "__main__":
    sys.exit(main())
