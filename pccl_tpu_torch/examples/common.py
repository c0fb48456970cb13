"""Shared plumbing for the example training loops: connect to the master
and wait for the world, admit joiners between steps, the data, the
learning-rate schedule, the section profiler's output and the FINAL line.

Two kinds of data (--data), drawn exactly as the JAX examples draw them,
so both packages train on the same tokens:
- synthetic: token t+1 is an affine function of token t plus 5% uniform
  noise, so next-token loss falls fast; numpy's RandomState, seeded per
  peer from its data shard;
- text: bytes of Python's own standard-library sources (vocab 256), so
  nothing is downloaded; random crops through utils/data.TokenDataset,
  whose stream is keyed by the peer's data shard. The last 10% of the
  corpus is held out as the val split.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def add_comm_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--master-ip", default="127.0.0.1")
    ap.add_argument("--master-port", type=int, default=48500)
    ap.add_argument("--base-port", type=int, default=56000,
                    help="p2p/shared-state/bench listen ports (bump-allocated)")
    ap.add_argument("--min-world", type=int, default=1,
                    help="wait until this many peers joined before training")
    ap.add_argument("--peer-group", type=int, default=0)
    ap.add_argument("--connect-timeout", type=float, default=120.0,
                    help="seconds to wait for --min-world peers")
    ap.add_argument("--solo", action="store_true",
                    help="run without a comm (single peer, no master)")
    ap.add_argument("--data-shard", type=int, default=None,
                    help="seed of this peer's synthetic data (default: the "
                         "base port, as the JAX examples seed it), so that "
                         "runs on OS-chosen ports draw the same tokens")


def add_data_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--data", choices=["synthetic", "text"],
                    default="synthetic",
                    help="synthetic affine tokens, or char-level text (the "
                         "Python standard library's sources, vocab 256)")


def add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--quantize", choices=["none", "minmax", "zps"], default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="nano",
                    help="preset: nano | tiny | gpt2 | gpt2-medium | gpt2-large "
                         "| gpt2-xl (pccl_tpu_torch.models.gpt.PRESETS); with "
                         "--family llama: nano | tiny | 700m | 1b | 7b | 8b")
    ap.add_argument("--family", choices=["gpt", "llama"], default="gpt",
                    help="model family (pccl_tpu_torch.models)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn", choices=["flash", "dense"], default="flash",
                    help="flash: the CUDA kernels (plain versions on the CPU); "
                         "dense: plain attention, CPU only")
    ap.add_argument("--profile", action="store_true",
                    help="print a table of each section's host time at the "
                         "end (utils/profiler.py)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the sections")
    ap.add_argument("--no-descent-check", action="store_true",
                    help="exit 0 even if the last loss is not below the first "
                         "(for runs too short to learn, e.g. a few steps at "
                         "GPT-2 width)")


def model_config(args, char_level: bool = False):
    """The --family preset named by --model, with --block as the sequence
    length; char-level text caps the vocab at 256 bytes."""
    from pccl_tpu_torch.models import gpt, llama

    family = llama if args.family == "llama" else gpt
    overrides = {"block_size": args.block}
    if char_level:
        overrides["vocab_size"] = 256
    return family.named_config(args.model, **overrides)


def device_and_attention(ap: argparse.ArgumentParser, args):
    """(torch.device, attn_fn) from --device and --attn."""
    from pccl_tpu_torch._device import resolve_device
    from pccl_tpu_torch.ops import flash_attention as fa

    dev = resolve_device(args.device)
    if args.attn == "dense" and dev.type != "cpu":
        ap.error("--attn dense runs only with --device cpu")
    if dev.type == "cuda" and dev.index is not None:
        import torch

        torch.cuda.set_device(dev)
    return dev, fa.flash_attention if args.attn == "flash" else None


def connect(args):
    """Create + connect a Communicator and wait for --min-world peers.
    Returns None under --solo."""
    if args.solo:
        return None
    from pccl_tpu_torch.comm import Communicator

    comm = Communicator(args.master_ip, args.master_port,
                        peer_group=args.peer_group,
                        p2p_port=args.base_port, ss_port=args.base_port + 4,
                        bench_port=args.base_port + 8)
    comm.connect()
    deadline = time.time() + args.connect_timeout
    while comm.world_size < args.min_world:
        if time.time() > deadline:
            raise TimeoutError(f"world never reached {args.min_world}")
        if comm.are_peers_pending():
            comm.update_topology()
        time.sleep(0.02)
    return comm


def admit_pending(comm) -> None:
    """Between-steps topology vote."""
    if comm is not None and comm.are_peers_pending():
        comm.update_topology()


def synth_batch(rng: np.random.RandomState, batch: int, block: int,
                vocab: int):
    """Learnable synthetic LM data: x[t+1] = (5*x[t] + 7) % vocab, with 5%
    uniform noise. Returns (tokens, targets) int32 [B, T]."""
    x = np.empty((batch, block + 1), dtype=np.int64)
    x[:, 0] = rng.randint(0, vocab, size=batch)
    for t in range(block):
        x[:, t + 1] = (5 * x[:, t] + 7) % vocab
    noise = rng.rand(batch, block + 1) < 0.05
    x[noise] = rng.randint(0, vocab, size=int(noise.sum()))
    return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)


def data_shard(args) -> int:
    """This peer's data shard: --data-shard, or else its unique base port."""
    return args.base_port if args.data_shard is None else args.data_shard


def data_rng(args) -> np.random.RandomState:
    """The synthetic training stream of this peer's data shard."""
    return np.random.RandomState(1000 + (data_shard(args) % 997))


_CORPUS = None


def text_corpus(max_bytes: int = 2 << 20) -> np.ndarray:
    """A char-level corpus that needs no download: the standard library's
    top-level sources (English docstrings and code) of the running Python,
    concatenated in sorted file order and cut at max_bytes; uint8, vocab
    256."""
    global _CORPUS
    if _CORPUS is not None:
        return _CORPUS
    import sysconfig
    from pathlib import Path

    stdlib = Path(sysconfig.get_paths()["stdlib"])
    buf = bytearray()
    for f in sorted(stdlib.glob("*.py")):
        try:
            buf += f.read_bytes()
        except OSError:
            continue
        if len(buf) >= max_bytes:
            break
    if len(buf) <= 64 * 1024:
        raise RuntimeError(f"the standard library under {stdlib} gave only "
                           f"{len(buf)} bytes of text")
    _CORPUS = np.frombuffer(bytes(buf[:max_bytes]), dtype=np.uint8)
    return _CORPUS


def text_batch(corpus: np.ndarray, rng: np.random.RandomState, batch: int,
               block: int):
    """Random contiguous windows of the corpus -> (tokens, targets) int32
    [B, T]. (A direct sampler; make_batch_fn samples through
    TokenDataset.)"""
    idx = rng.randint(0, len(corpus) - block - 1, size=batch)
    x = np.stack([corpus[i:i + block + 1] for i in idx])
    return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)


def make_batch_fn(args, vocab: int, split: str = "train"):
    """This peer's batch sampler, () -> (tokens, targets) int32 [B, T], of
    --data, keyed off its data shard. split="val" is held out: for text the
    last 10% of the corpus (a disjoint slice, since another stream over
    the same text would still sample training bytes), for synthetic data a
    stream of its own (the rule itself is the distribution)."""
    shard = data_shard(args)
    if getattr(args, "data", "synthetic") == "text":
        from pccl_tpu_torch.utils.data import TokenDataset

        corpus = text_corpus()
        cut = int(len(corpus) * 0.9)
        corpus = corpus[cut:] if split == "val" else corpus[:cut]
        ds = TokenDataset(corpus, args.block, args.batch,
                          seed=1000 if split == "train" else 7919,
                          worker_index=shard % 997)
        return ds.sample
    rng = data_rng(args) if split == "train" else \
        np.random.RandomState(7919 + (shard % 997))
    return lambda: synth_batch(rng, args.batch, args.block, vocab)


def make_profiler(args):
    """The section profiler, on under --profile or --trace-out."""
    from pccl_tpu_torch.utils.profiler import Profiler

    return Profiler(enabled=args.profile or bool(args.trace_out))


def finish_profile(args, prof) -> None:
    """Write --trace-out and print the --profile table."""
    if args.trace_out:
        prof.export_chrome_trace(args.trace_out)
        print(f"trace written to {args.trace_out}", flush=True)
    if args.profile:
        print(prof.summary(), flush=True)


def quant_from_arg(name: str):
    """Map the --quantize CLI choice to a QuantizationAlgorithm."""
    from pccl_tpu_torch.comm import QuantizationAlgorithm

    return {"none": QuantizationAlgorithm.NONE,
            "minmax": QuantizationAlgorithm.MIN_MAX,
            "zps": QuantizationAlgorithm.ZERO_POINT_SCALE}[name]


def add_lr_schedule_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--lr-schedule", choices=["const", "cosine"],
                    default="const",
                    help="cosine = linear warmup then cosine decay to "
                         "--min-lr over the run")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--min-lr", type=float, default=0.0)


def make_schedule(args, peak_lr: float, total_steps: int, offset: int = 0):
    """The --lr-schedule flags -> a schedule (step -> lr) for
    parallel/train.make_train_state, or None for a constant lr. offset
    shifts the schedule's count: a resumed run whose optimizer starts
    afresh continues the decay where it left off instead of warming up
    again."""
    if args.lr_schedule != "cosine":
        return None
    from pccl_tpu_torch.parallel.train import cosine_warmup_schedule

    base = cosine_warmup_schedule(peak_lr, total_steps, args.warmup_steps,
                                  args.min_lr)
    if not offset:
        return base
    return lambda count: base(count + offset)


def report_final(first_loss, last_loss, comm, require_descent: bool = True,
                 extra: str = "") -> int:
    """Print the FINAL line (with `extra` appended) and return the exit
    code (0 = loss fell, or require_descent is off; None losses mean no
    step ran). FINAL goes out before destroy, so a wedged teardown cannot
    hide it."""
    if first_loss is None or last_loss is None:
        print(f"FINAL no steps ran{extra}", flush=True)
        code = 0
    else:
        print(f"FINAL first_loss={first_loss:.4f} last_loss={last_loss:.4f}"
              f"{extra}", flush=True)
        code = 0 if last_loss < first_loss or not require_descent else 4
    if comm is not None:
        comm.destroy()
    return code
