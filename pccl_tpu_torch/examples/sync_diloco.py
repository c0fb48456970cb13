"""Sync DiLoCo on GPT or Llama (--family): H inner AdamW steps, then one
outer reduce over the native ring.

Run (2 peers on one card):
    python -m pccl_tpu_torch.comm.master --port 48500 &
    python -m pccl_tpu_torch.examples.sync_diloco --master-port 48500 \\
        --base-port 56000 --min-world 2 --model gpt2 --block 1024 &
    python -m pccl_tpu_torch.examples.sync_diloco --master-port 48500 \\
        --base-port 56100 --min-world 2 --model gpt2 --block 1024

Each outer step prints one line:
    outer N loss L world W revision R tok_s X outer_s Y launches A B C digest D
with the inner steps' tokens per second, the outer step's seconds, the
launches of the three flash kernels during the outer step's inner steps,
and a digest of the outer fp32 vector (equal on every peer).

With --checkpoint-dir the outer state (utils/checkpoint.DilocoCheckpoint)
is saved every --checkpoint-every outer steps, each save logged as
    checkpoint outer step N bytes B save_s S
and a restarted peer resumes from the newest snapshot, as the JAX example
does: the inner steps continue from the restored outer parameters, the
inner AdamW starts afresh with its schedule shifted by the steps already
run, and the data stream is drained past the batches they used. It prints
    resumed from outer step N digest D restore_s S
where D is the restored outer vector's digest, equal to the one outer step
N - 1 printed. The FINAL line adds, on a card, the peak of the device
memory torch allocated (peak_alloc_mib), and the process's peak resident
host memory (peak_rss_mib).

--ranks N (N > 1): the peer is N processes, one a card, on the mesh
factor_mesh(N) over (dp, tp), where the JAX example meshes N devices
(examples/ranks.py: this process is rank 0 and starts the others). The
inner steps run train.build_train_step(mesh=) on each rank's blocks
(tensor-parallel over "tp", the batch split over "dp"); rank 0 holds the
comm and the whole outer state and runs the outer step on the gathered
full parameters (parallel/diloco.py), so its digest is the one a
one-rank or a JAX peer prints. Each outer line then adds
    gather_s G scatter_s S rank_launches a,b,c/a,b,c/...
(the outer step's gather to rank 0 and scatter back, and each rank's
K1-K3 launches), and `launches` is their sum over the ranks. Rank 0
prints, before the first step,
    mesh dp D tp T devices d0 d1 ...
Checkpoints are saved by rank 0 and scattered on resume.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, rank: int = 0, store=None) -> int:
    ap = argparse.ArgumentParser()
    from pccl_tpu_torch.examples import common, ranks

    common.add_comm_args(ap)
    ranks.add_ranks_arg(ap)
    ap.add_argument("--outer-steps", type=int, default=8)
    ap.add_argument("--inner-steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    common.add_lr_schedule_args(ap)
    common.add_data_args(ap)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--shm-staging", action="store_true",
                    help="stage pseudo-gradients in a registered shm buffer "
                         "(zero-copy ring when peers share this host)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the outer state here every --checkpoint-every "
                         "outer steps and resume from the newest snapshot")
    ap.add_argument("--checkpoint-every", default=10,
                    type=lambda v: max(1, int(v)))
    common.add_model_args(ap)
    args = ap.parse_args(argv)

    import torch

    from pccl_tpu_torch.utils.rss import peak_rss_mib

    args.device = ranks.rank_device(args.device, rank)
    dev, attn_fn = common.device_and_attention(ap, args)
    cfg = common.model_config(args, char_level=args.data == "text")
    ranks.check_mesh(ap, cfg, args.ranks, args.batch)
    with ranks.peer_mesh(main, argv, args.ranks, rank, store) as mesh:
        first_loss, last_loss, comm = _run(args, dev, attn_fn, cfg, mesh)
    if rank:
        return 0
    extra = ""
    if dev.type == "cuda":
        extra += f" peak_alloc_mib={torch.cuda.max_memory_allocated(dev) >> 20}"
    extra += f" peak_rss_mib={peak_rss_mib()}"
    return common.report_final(first_loss, last_loss, comm,
                               require_descent=not args.no_descent_check,
                               extra=extra)


def _run(args, dev, attn_fn, cfg, mesh):
    """The loop of one rank; (first loss, last loss, comm) on rank 0."""
    import torch

    from pccl_tpu_torch.examples import common, ranks
    from pccl_tpu_torch.models.convert import MeshShards
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig
    from pccl_tpu_torch.parallel.mesh import share

    shards = None if mesh is None else MeshShards(cfg, mesh)
    group = None if shards is None else shards.group
    lead = shards is None or shards.lead
    comm = common.connect(args) if lead else None
    total_steps = args.outer_steps * args.inner_steps
    state = train_lib.make_train_state(
        args.seed, cfg, dev, lr=args.inner_lr,
        schedule=common.make_schedule(args, args.inner_lr, total_steps), mesh=mesh)
    step_fn = train_lib.build_train_step(cfg, attn_fn=attn_fn, mesh=mesh)
    dl = Diloco(comm, state.params,
                DilocoConfig(inner_steps=args.inner_steps, outer_lr=args.outer_lr,
                             quantization=common.quant_from_arg(args.quantize),
                             shm_staging=args.shm_staging), shards=shards)
    ranks.print_mesh(mesh, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ckpt, start = None, 0
    if args.checkpoint_dir:
        from pccl_tpu_torch.utils.checkpoint import DilocoCheckpoint

        ckpt = DilocoCheckpoint(args.checkpoint_dir)
        t0 = time.perf_counter()
        start = ckpt.maybe_restore(dl)
        sync()
        restore_s = time.perf_counter() - t0
        if start:
            # the inner steps continue from the restored outer parameters:
            # from the seed's, the first pseudo-gradient would be a jump
            # from the snapshot back toward the seed
            dl.copy_outer_into(state.params)
            # DiLoCo shares only the outer state, so the inner AdamW starts
            # afresh; its schedule is shifted so that the decay goes on
            # where the run left off instead of warming up again
            state = train_lib.make_train_state(
                args.seed, cfg, dev, lr=args.inner_lr, params=state.params,
                schedule=common.make_schedule(args, args.inner_lr, total_steps,
                                              offset=start * args.inner_steps))
            if lead:
                print(f"resumed from outer step {start} digest {dl.digest()} "
                      f"restore_s {restore_s:.3f}", flush=True)

    prof = common.make_profiler(args)
    next_batch = common.make_batch_fn(args, cfg.vocab_size)
    # past the batches outer steps [0, start) used, so that a resumed run
    # does not train on them again
    for _ in range(start * args.inner_steps):
        next_batch()
    first_loss = last_loss = None
    outer = start
    while True:
        # rank 0 decides whether the run goes on; every rank follows it
        go, = share(group, int(outer < args.outer_steps))
        if not go:
            break
        if lead:
            common.admit_pending(comm)
        batches = [next_batch() for _ in range(args.inner_steps)]
        fa.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        with prof.section("inner"):
            for tok, tgt in batches:
                tok = torch.from_numpy(tok).to(dev, non_blocking=True)
                tgt = torch.from_numpy(tgt).to(dev, non_blocking=True)
                loss = step_fn(state, tok, tgt)
            loss = float(loss)             # waits for the last inner step
        t_inner = time.perf_counter() - t0
        counts = ranks.launch_counts(group, [fa.launches[k] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")])
        t0 = time.perf_counter()
        with prof.section("outer/ring+sgd"):
            dl.outer_step(state.params)
            sync()
        t_outer = time.perf_counter() - t0
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        if lead:
            world = comm.world_size if comm is not None else 1
            tok_s = args.inner_steps * args.batch * args.block / t_inner
            total = [sum(c) for c in zip(*counts)]
            print(f"outer {outer} loss {loss:.4f} world {world} revision {dl.step} "
                  f"tok_s {tok_s:.1f} outer_s {t_outer:.3f} launches "
                  f"{total[0]} {total[1]} {total[2]} digest {dl.digest()}"
                  f"{ranks.mesh_fields(counts, shards)}", flush=True)
        if ckpt is not None and (outer + 1) % args.checkpoint_every == 0:
            t0 = time.perf_counter()
            path = ckpt.save(dl)
            if path is not None:
                print(f"checkpoint outer step {dl.step} bytes "
                      f"{path.stat().st_size} save_s {time.perf_counter() - t0:.3f}",
                      flush=True)
        outer += 1
    if lead:
        common.finish_profile(args, prof)
    return first_loss, last_loss, comm


if __name__ == "__main__":
    sys.exit(main())
