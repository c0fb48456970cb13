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
tok_s: the step's tokens over its seconds (host clock from the step's
start, sync included, to the end of the update on the device); ring_s: the
gradient all-reduce (device to host, ring, host to device); sync_s: the
shared-state sync; tx, rx: the sync's bytes; launches: the flash kernels
K1, K2, K3 and H1 in this step; digest: H1 over the parameters after the
update, equal on every peer. The FINAL line adds params_blake2b, BLAKE2b of
the flat fp32 parameters at the end, taken independently of H1, on a card
the peak of the device memory torch allocated (peak_alloc_mib), and the
process's peak resident host memory (peak_rss_mib).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import resource
import struct
import sys
import time


def state_entries(state, step_arr, make):
    """The DDP shared state: parameters, optimizer leaves and the step,
    each tensor entry made by `make` (a TensorInfo factory)."""
    from pccl_tpu_torch.comm import TensorInfo
    from pccl_tpu_torch.parallel import train as train_lib

    params = [state.params[n] for n in sorted(state.params)]
    leaves = train_lib.opt_state_leaves(state)
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


def adopt(state, entries) -> None:
    """Write what a sync received into the parameters and the optimizer."""
    import torch

    from pccl_tpu_torch.parallel import train as train_lib

    names = sorted(state.params)
    n = len(names)
    with torch.no_grad():
        for name, e in zip(names, entries[:n]):
            if e.updated:
                state.params[name].copy_(e.torch_value())
    train_lib.load_opt_state_leaves(
        state, [e.torch_value() for e in entries[n:-1]])


def params_digest(params) -> str:
    """H1 over each parameter, sorted by name, folded into 16 hex digits."""
    from pccl_tpu_torch.ops.hashing import torch_simplehash_device

    ds = [torch_simplehash_device(params[n]) for n in sorted(params)]
    return hashlib.blake2b(struct.pack(f"<{len(ds)}Q", *ds),
                           digest_size=8).hexdigest()


def params_blake2b(params) -> str:
    from pccl_tpu_torch.parallel.codec import build_codec

    flat = build_codec(params).flat(params).cpu()
    return hashlib.blake2b(flat.numpy().tobytes(), digest_size=16).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    from pccl_tpu_torch.examples import common

    common.add_comm_args(ap)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    common.add_lr_schedule_args(ap)
    common.add_model_args(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pccl_tpu_torch.comm import (KickedError, PcclError, SharedState,
                                     SharedStateSyncStrategy)
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops import hashing
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.hierarchical import HierarchicalAllReduce
    from pccl_tpu_torch.utils.data import prefetch_to_device

    dev, attn_fn = common.device_and_attention(ap, args)
    try:
        make = entry_factory(dev)
    except ValueError as e:
        ap.error(str(e))

    cfg = common.model_config(args)
    comm = common.connect(args)
    state = train_lib.make_train_state(
        args.seed, cfg, dev, lr=args.lr,
        schedule=common.make_schedule(args, args.lr, args.steps))
    loss_and_grad = train_lib.build_loss_and_grad(cfg, attn_fn=attn_fn)

    def make_ring(comm):
        return HierarchicalAllReduce(
            comm, state.params, quantization=common.quant_from_arg(args.quantize))

    ring = make_ring(comm)
    rng = common.data_rng(args)

    def batches():
        while True:
            yield common.synth_batch(rng, args.batch, args.block, cfg.vocab_size)

    feed = prefetch_to_device(batches(), size=2, device=dev)

    def sync_device():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- per-step shared-state sync ---
    # The DDP invariant is identical parameters and optimizer state on every
    # peer; a late joiner starts from seed parameters, so it must adopt the
    # cohort's. The revision offered is the master's one-increment counter,
    # not the step: after the first sync every peer offers the agreed
    # revision + 1, and the step rides in `ddp.step`. A fresh peer offers
    # revision 0 first, which never trips the master's `revision > last+1`
    # kick; against a cohort that is ahead, 0 marks it outdated and it
    # adopts parameters, optimizer state and step.
    next_revision = None

    def sync_state(comm, step):
        nonlocal next_revision
        step_arr = np.array([step], dtype=np.uint64)
        entries = state_entries(state, step_arr, make)
        st = SharedState(entries, revision=step if next_revision is None
                         else next_revision)
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
        if info.rx_bytes:  # outdated: adopt the cohort's state
            adopt(state, entries)
            step = int(step_arr[0])
            print(f"adopted shared state at step {step}", flush=True)
        return step, info

    first_loss = last_loss = None
    step = 0
    while step < args.steps:
        fa.reset_launch_counts()
        hashing.reset_launch_counts()
        t_start = time.perf_counter()
        common.admit_pending(comm)
        tx = rx = revision = 0
        sync_s = 0.0
        if comm is not None:
            try:
                step, info = sync_state(comm, step)
            except KickedError:
                # a kick ends the communicator: reconnect and offer revision
                # 0, which cannot be kicked, so the election converges this
                # peer onto the cohort's state
                print("kicked during sync; reconnecting with a revision-0 "
                      "enforce-popular offer", flush=True)
                try:
                    comm.destroy()
                except PcclError:
                    pass
                comm = common.connect(args)
                ring = make_ring(comm)
                next_revision = 0
                continue
            sync_s = time.perf_counter() - t_start
            tx, rx, revision = info.tx_bytes, info.rx_bytes, info.revision
            if step >= args.steps:
                break
        tok, tgt = next(feed)
        loss = loss_and_grad(state, tok, tgt)
        sync_device()
        t0 = time.perf_counter()
        ring.all_reduce({n: p.grad for n, p in state.params.items()})
        sync_device()
        ring_s = time.perf_counter() - t0
        train_lib.apply(state)
        loss = float(loss)
        sync_device()
        tok_s = args.batch * args.block / (time.perf_counter() - t_start)
        digest = params_digest(state.params)
        first_loss = loss if first_loss is None else first_loss
        last_loss = loss
        world = comm.world_size if comm is not None else 1
        print(f"step {step} loss {loss:.4f} world {world} revision {revision} "
              f"tok_s {tok_s:.1f} ring_s {ring_s:.4f} sync_s {sync_s:.4f} "
              f"tx {tx} rx {rx} launches {fa.launches['flash_fwd']} "
              f"{fa.launches['flash_bwd_dq']} {fa.launches['flash_bwd_dkv']} "
              f"{hashing.launches['simplehash_tpu']} digest {digest}", flush=True)
        step += 1

    feed.close()
    extra = f" params_blake2b={params_blake2b(state.params)}"
    if dev.type == "cuda":
        extra += f" peak_alloc_mib={torch.cuda.max_memory_allocated(dev) >> 20}"
    extra += f" peak_rss_mib={resource.getrusage(resource.RUSAGE_SELF).ru_maxrss >> 10}"
    return common.report_final(
        first_loss, last_loss, comm, require_descent=not args.no_descent_check,
        extra=extra)


if __name__ == "__main__":
    sys.exit(main())
