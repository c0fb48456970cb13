"""Async DiLoCo on GPT or Llama (--family): the outer reduce of step t runs
on a background thread while the inner steps of t+1 compute, and the
delayed update lands at the next outer boundary.

The port of examples/nanogpt_diloco/async_diloco.py. Run (2 Llama-700m
peers on one card):
    python -m pccl_tpu_torch.comm.master --port 48500 &
    python -m pccl_tpu_torch.examples.async_diloco --master-port 48500 \\
        --base-port 56000 --min-world 2 --family llama --model 700m \\
        --block 2048 --batch 2 &
    python -m pccl_tpu_torch.examples.async_diloco --master-port 48500 \\
        --base-port 56100 --min-world 2 --family llama --model 700m \\
        --block 2048 --batch 2
On the CPU add `--device cpu --model nano` (and OMP_NUM_THREADS=1 when
several peers share the host).

Each outer step prints one line:
    outer N loss L world W revision R tok_s X outer_s Y join_s Z
    launches A B C digest D
tok_s: the inner steps' tokens per second; outer_s: the seconds of
outer_step_async (host clock, ending in a device sync); join_s: the part of
them spent waiting for the previous step's reduce; revision: the outer
updates applied so far; launches: K1, K2 and K3 during the inner steps;
digest: BLAKE2b of the outer fp32 vector after the call, equal on every
peer. The FINAL line adds the digest once finish() has landed the last
reduce, on a card the peak of the device memory torch allocated
(peak_alloc_mib), and the process's peak resident host memory
(peak_rss_mib). --profile prints the host and device time of the
sections `inner`, `outer/async`, `outer/finish` and the train step's
`train.forward`, `train.backward` and `train.optimizer`; --trace-out
writes them as a Chrome trace.

--ranks N: the peer is N processes on the mesh factor_mesh(N) over
(dp, tp), as in sync_diloco (examples/ranks.py). Rank 0 holds the comm
and the whole outer state and runs the background reduce; each
outer_step_async gathers the ranks' inner parameters to it and scatters
the parameters to continue from, and finish() scatters the last ones.
Each outer line adds `gather_s G scatter_s S rank_launches ...`, and
`launches` sums the ranks'.
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
    ap.add_argument("--outer-steps", type=int, default=10)
    ap.add_argument("--inner-steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    common.add_lr_schedule_args(ap)
    common.add_data_args(ap)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    common.add_model_args(ap)
    args = ap.parse_args(argv)

    import torch

    from pccl_tpu_torch.utils.rss import peak_rss_mib

    args.device = ranks.rank_device(args.device, rank)
    dev, attn_fn = common.device_and_attention(ap, args)
    cfg = common.model_config(args, char_level=args.data == "text")
    ranks.check_mesh(ap, cfg, args.ranks, args.batch)
    with ranks.peer_mesh(main, argv, args.ranks, rank, store) as mesh:
        first_loss, last_loss, comm, dl = _run(args, dev, attn_fn, cfg, mesh)
    if rank:
        return 0
    extra = f" revision={dl.step} digest={dl.digest()}"
    if dev.type == "cuda":
        extra += f" peak_alloc_mib={torch.cuda.max_memory_allocated(dev) >> 20}"
    extra += f" peak_rss_mib={peak_rss_mib()}"
    return common.report_final(first_loss, last_loss, comm,
                               require_descent=not args.no_descent_check,
                               extra=extra)


def _run(args, dev, attn_fn, cfg, mesh):
    """The loop of one rank; (first loss, last loss, comm, the AsyncDiloco)."""
    import torch

    from pccl_tpu_torch.examples import common, ranks
    from pccl_tpu_torch.models.convert import MeshShards
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.diloco import AsyncDiloco, DilocoConfig
    from pccl_tpu_torch.parallel.mesh import share

    shards = None if mesh is None else MeshShards(cfg, mesh)
    group = None if shards is None else shards.group
    lead = shards is None or shards.lead
    comm = common.connect(args) if lead else None
    state = train_lib.make_train_state(
        args.seed, cfg, dev, lr=args.inner_lr,
        schedule=common.make_schedule(args, args.inner_lr,
                                      args.outer_steps * args.inner_steps),
        mesh=mesh)
    prof = common.make_profiler(args, dev)
    step_fn = train_lib.build_train_step(cfg, attn_fn=attn_fn, mesh=mesh,
                                         profiler=prof)
    # delayed pseudo-gradients oscillate under heavy momentum: async runs
    # train with the outer momentum off, as the JAX example does
    dl = AsyncDiloco(comm, state.params,
                     DilocoConfig(inner_steps=args.inner_steps,
                                  outer_lr=args.outer_lr, outer_momentum=0.0,
                                  quantization=common.quant_from_arg(args.quantize)),
                     shards=shards)
    ranks.print_mesh(mesh, dev)
    next_batch = common.make_batch_fn(args, cfg.vocab_size)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    first_loss = last_loss = None
    outer = 0
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
        # joins the previous reduce, launches this one on a background
        # thread, and writes the params to continue from into state.params
        with prof.section("outer/async"):
            dl.outer_step_async(state.params)
            sync()
        t_outer = time.perf_counter() - t0
        prof.resolve()                     # the card is idle: no wait
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        if lead:
            world = comm.world_size if comm is not None else 1
            tok_s = args.inner_steps * args.batch * args.block / t_inner
            total = [sum(c) for c in zip(*counts)]
            print(f"outer {outer} loss {loss:.4f} world {world} revision {dl.step} "
                  f"tok_s {tok_s:.1f} outer_s {t_outer:.3f} join_s {dl.join_s:.3f} "
                  f"launches {total[0]} {total[1]} {total[2]} digest {dl.digest()}"
                  f"{ranks.mesh_fields(counts, shards)}", flush=True)
        outer += 1
    with prof.section("outer/finish"):
        dl.finish(state.params)            # land the last in-flight reduce
        sync()
    if lead:
        common.finish_profile(args, prof)
    return first_loss, last_loss, comm, dl


if __name__ == "__main__":
    sys.exit(main())
