"""The inner train step: AdamW over a model's parameter dict (GPT or
Llama, dispatched on the config's family by `family`).

Matches pccl_tpu/parallel/train.py on one device: `optax.adamw(lr, b1=0.9,
b2=0.95, weight_decay=0.1)` (eps 1e-8, no mask, so the gains and the
embedding decay too) becomes `torch.optim.AdamW` with the same settings,
and the optional warmup + cosine schedule becomes a `LambdaLR`. The step
updates the parameter tensors in place; a sync-DiLoCo outer step writes the
new outer parameters into the same tensors, so the optimizer keeps its
moments across outer steps as the JAX loop does.

DDP averages the gradients between the backward and the update, so the
step is also offered as its two halves, `build_loss_and_grad` and `apply`.
`opt_state_leaves` puts AdamW's state in optax's leaf order, the shared
state a DDP peer offers and a late joiner adopts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from .._device import resolve_device
from ..models import gpt, llama


def family(cfg):
    """The model module of a config's family: models.llama for a
    LlamaConfig, else models.gpt (the JAX package's train.family, without
    the sharding rules)."""
    return llama if isinstance(cfg, llama.LlamaConfig) else gpt


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


def make_train_state(seed: int, cfg, device="cuda",
                     lr: float = 3e-4, schedule=None,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """Parameters (from `seed`, made on the CPU so every device gets the
    same numbers, or the given `params`) on `device`, with AdamW and the
    optional schedule (step -> lr, used instead of the constant lr)."""
    dev = resolve_device(device)
    if params is None:
        params = family(cfg).init_params(torch.Generator().manual_seed(seed), cfg)
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


def build_loss_and_grad(cfg, attn_fn=None, remat=False,
                        loss_chunk: "int | None" = None):
    """Returns loss_and_grad(state, tokens, targets) -> loss (a detached
    0-d tensor, not synchronised), leaving the gradients in each
    parameter's `.grad`. attn_fn, remat and loss_chunk as in
    build_train_step."""
    model = family(cfg)

    def loss_and_grad(state: TrainState, tokens, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = model.loss_fn(state.params, tokens, targets, cfg, attn_fn, remat,
                             loss_chunk)
        loss.backward()
        return loss.detach()

    return loss_and_grad


def apply(state: TrainState) -> None:
    """One AdamW update from the parameters' `.grad`, in place, and one
    step of the schedule."""
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()


def build_train_step(cfg, attn_fn=None, remat=False,
                     loss_chunk: "int | None" = None):
    """Returns step(state, tokens, targets) -> loss (a detached 0-d tensor,
    not synchronised): build_loss_and_grad, then apply. attn_fn: the
    attention op (e.g. ops.flash_attention); remat: per-block
    checkpointing; loss_chunk: the head and loss in checkpointed sequence
    chunks."""
    loss_and_grad = build_loss_and_grad(cfg, attn_fn, remat, loss_chunk)

    def step(state: TrainState, tokens, targets):
        loss = loss_and_grad(state, tokens, targets)
        apply(state)
        return loss

    return step


# ------------------------------------------------------------ AdamW state

def _adam_state(state: TrainState, name: str) -> dict:
    """AdamW's state of one parameter, created as torch.optim.AdamW creates
    it at its first step when the optimizer has not stepped yet."""
    p = state.params[name]
    st = state.optimizer.state[p]
    if not st:
        group = state.optimizer.param_groups[0]
        on_device = group.get("capturable") or group.get("fused")
        scalar = torch.float64 if torch.get_default_dtype() == torch.float64 \
            else torch.float32
        st["step"] = torch.zeros((), dtype=scalar,
                                 device=p.device if on_device else "cpu")
        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return st


def opt_state_leaves(state: TrainState) -> List[torch.Tensor]:
    """AdamW's state in the leaf order of `jax.tree.flatten` of the JAX
    package's optax.adamw state: [count int32[], mu of each parameter in
    sorted-name order, nu likewise], and with a schedule one more count
    (optax's scale_by_schedule). 17 leaves for GPT's 8 parameters, 23 for
    Llama's 11. mu and nu are the optimizer's own tensors; count is a new
    int32 tensor on the parameters' device."""
    names = sorted(state.params)
    sts = [_adam_state(state, n) for n in names]
    count = int(sts[0]["step"].item())
    dev = state.params[names[0]].device

    def count_leaf():
        return torch.tensor(count, dtype=torch.int32, device=dev)

    leaves = [count_leaf()] + [s["exp_avg"] for s in sts] \
        + [s["exp_avg_sq"] for s in sts]
    if state.scheduler is not None:
        leaves.append(count_leaf())
    return leaves


@torch.no_grad()
def load_opt_state_leaves(state: TrainState, leaves) -> None:
    """Write leaves in opt_state_leaves' order into the optimizer: mu and
    nu into its tensors, and count into every parameter's step (the bias
    correction reads it: a joiner that adopted the moments but kept its own
    step would drift from the cohort at its next update) and the
    schedule's."""
    names = sorted(state.params)
    n = len(names)
    want = 1 + 2 * n + (state.scheduler is not None)
    if len(leaves) != want:
        raise ValueError(f"expected {want} optimizer leaves, got {len(leaves)}")
    count = int(leaves[0].item())
    for i, name in enumerate(names):
        st = _adam_state(state, name)
        for key, leaf in (("exp_avg", leaves[1 + i]), ("exp_avg_sq", leaves[1 + n + i])):
            if leaf is not st[key]:
                st[key].copy_(leaf)
        st["step"].fill_(count)
    if state.scheduler is not None:
        sched = state.scheduler
        sched.last_epoch = count
        for group, base, fn in zip(state.optimizer.param_groups,
                                   sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(count)
