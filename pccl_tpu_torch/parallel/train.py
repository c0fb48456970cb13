"""The inner train step: AdamW over the GPT parameter dict.

Matches pccl_tpu/parallel/train.py on one device: `optax.adamw(lr, b1=0.9,
b2=0.95, weight_decay=0.1)` (eps 1e-8, no mask, so the gains and the
embedding decay too) becomes `torch.optim.AdamW` with the same settings,
and the optional warmup + cosine schedule becomes a `LambdaLR`. The step
updates the parameter tensors in place; a sync-DiLoCo outer step writes the
new outer parameters into the same tensors, so the optimizer keeps its
moments across outer steps as the JAX loop does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from .._device import resolve_device
from ..models import gpt


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None


def cosine_warmup_schedule(lr: float, total_steps: int, warmup_steps: int = 0,
                           min_lr: float = 0.0) -> Callable[[int], float]:
    """step -> learning rate: linear warmup from 0 to lr over warmup_steps,
    then cosine decay to min_lr at total_steps (optax's
    warmup_cosine_decay_schedule with the JAX package's arguments)."""
    warmup = max(0, warmup_steps)
    decay_steps = max(warmup + 1, total_steps) - warmup
    init = 0.0 if warmup else lr
    alpha = 0.0 if lr == 0.0 else min_lr / lr

    def schedule(count: int) -> float:
        if count < warmup:
            return init + (lr - init) * count / warmup
        t = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_train_state(seed: int, cfg: gpt.GPTConfig, device="cuda",
                     lr: float = 3e-4, schedule=None,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """Parameters (from `seed`, made on the CPU so every device gets the
    same numbers, or the given `params`) on `device`, with AdamW and the
    optional schedule (step -> lr, used instead of the constant lr)."""
    dev = resolve_device(device)
    if params is None:
        params = gpt.init_params(torch.Generator().manual_seed(seed), cfg)
    params = {k: v.detach().to(dev, torch.float32).requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.1)
    sched = None
    if schedule is not None:
        if lr <= 0:
            raise ValueError("a schedule needs lr > 0 (it scales the base lr)")
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: schedule(count) / lr)
    return TrainState(params, opt, sched)


def build_train_step(cfg: gpt.GPTConfig, attn_fn=None, remat=False,
                     loss_chunk: "int | None" = None):
    """Returns step(state, tokens, targets) -> loss (a detached 0-d tensor,
    not synchronised). attn_fn: the attention op (e.g.
    ops.flash_attention); remat: per-block checkpointing; loss_chunk: the
    head and loss in checkpointed sequence chunks."""

    def step(state: TrainState, tokens, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = gpt.loss_fn(state.params, tokens, targets, cfg, attn_fn, remat,
                           loss_chunk)
        loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        return loss.detach()

    return step
