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
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    from pccl_tpu_torch.examples import common

    common.add_comm_args(ap)
    ap.add_argument("--outer-steps", type=int, default=8)
    ap.add_argument("--inner-steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--shm-staging", action="store_true",
                    help="stage pseudo-gradients in a registered shm buffer "
                         "(zero-copy ring when peers share this host)")
    common.add_model_args(ap)
    args = ap.parse_args(argv)

    import torch

    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    dev, attn_fn = common.device_and_attention(ap, args)

    cfg = common.model_config(args)
    comm = common.connect(args)
    state = train_lib.make_train_state(args.seed, cfg, dev, lr=args.inner_lr)
    step_fn = train_lib.build_train_step(cfg, attn_fn=attn_fn)
    dl = Diloco(comm, state.params,
                DilocoConfig(inner_steps=args.inner_steps, outer_lr=args.outer_lr,
                             quantization=common.quant_from_arg(args.quantize),
                             shm_staging=args.shm_staging))
    rng = common.data_rng(args)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    first_loss = last_loss = None
    for outer in range(args.outer_steps):
        common.admit_pending(comm)
        batches = [common.synth_batch(rng, args.batch, args.block, cfg.vocab_size)
                   for _ in range(args.inner_steps)]
        fa.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        for tok, tgt in batches:
            tok = torch.from_numpy(tok).to(dev, non_blocking=True)
            tgt = torch.from_numpy(tgt).to(dev, non_blocking=True)
            loss = step_fn(state, tok, tgt)
        loss = float(loss)                 # waits for the last inner step
        t_inner = time.perf_counter() - t0
        counts = dict(fa.launches)
        t0 = time.perf_counter()
        dl.outer_step(state.params)
        sync()
        t_outer = time.perf_counter() - t0
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        world = comm.world_size if comm is not None else 1
        tok_s = args.inner_steps * args.batch * args.block / t_inner
        print(f"outer {outer} loss {loss:.4f} world {world} revision {dl.step} "
              f"tok_s {tok_s:.1f} outer_s {t_outer:.3f} launches "
              f"{counts['flash_fwd']} {counts['flash_bwd_dq']} "
              f"{counts['flash_bwd_dkv']} digest {dl.digest()}", flush=True)

    return common.report_final(first_loss, last_loss, comm,
                               require_descent=not args.no_descent_check)


if __name__ == "__main__":
    sys.exit(main())
