"""The inner train step: AdamW over a model's parameter dict (GPT, Llama
or LFM2, dispatched on the config's family by models.family, which this
module offers as `family` too).

Matches pccl_tpu/parallel/train.py on one device: `optax.adamw(lr, b1=0.9,
b2=0.95, weight_decay=0.1)` (eps 1e-8, no mask, so the gains and the
embedding decay too) becomes `torch.optim.AdamW` with the same settings,
and the optional warmup + cosine schedule becomes a `LambdaLR`. The step
updates the parameter tensors in place; a sync-DiLoCo outer step writes the
new outer parameters into the same tensors, so the optimizer keeps its
moments across outer steps as the JAX loop does.

DDP averages the gradients between the backward and the update, so the
step is also offered as its two halves, `build_loss_and_grad` and `apply`.
With a mesh of ranks (parallel/mesh.py) the step is the JAX package's
sharded one read per rank: each rank takes its block of the global batch
(B over "dp", T over `seq_axis`, whose attention is then ring attention),
and the gradients are averaged over those ranks before the update.
`opt_state_leaves` puts AdamW's state in optax's leaf order, the shared
state a DDP peer offers and a late joiner adopts.

A mesh with a "tp" axis of more than one rank adds tensor parallelism:
each rank keeps its block of every parameter (models/convert.py's
per-head layout) and runs the model on it with the axis's group; AdamW is
elementwise, so its update of the blocks is the full update cut in
blocks. Gradients are averaged over "dp" (and `seq_axis`) only: the tp
collectives inside the model already give each rank its blocks' whole
gradient, and the replicated gains get the same bytes on every tp rank.
`gathered_state` and `load_gathered_state` give and take the full
tensors (parameters by name, AdamW's state in optax's leaf order) on one
rank of the tp group, for a DDP peer made of several ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from .._device import resolve_device
from ..models import family
from ..models.convert import TpShards
from .codec import build_codec
from .hierarchical import local_mean
from .mesh import local_batch


@dataclasses.dataclass
class TrainState:
    """buffers: tensors the model reads that no optimizer trains and no
    outer step carries (LFM2's expert bias), passed to its loss_fn by
    name."""
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    buffers: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


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


def tp_shards(cfg, mesh, axis: str = "tp"):
    """models/convert.TpShards over the mesh's tp axis, or None where the
    mesh has none or it holds one rank."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None
    return TpShards(cfg, mesh, axis)


def make_train_state(seed: int, cfg, device="cuda",
                     lr: float = 3e-4, schedule=None,
                     params: Optional[Dict[str, torch.Tensor]] = None,
                     mesh=None) -> TrainState:
    """Parameters (from `seed`, made on the CPU so every device gets the
    same numbers, or the given full `params`) on `device`, with AdamW and
    the optional schedule (step -> lr, used instead of the constant lr).
    With a mesh whose "tp" axis has several ranks, this rank keeps only its
    blocks of the full parameters."""
    dev = resolve_device(device)
    if params is None:
        params = family(cfg).init_params(torch.Generator().manual_seed(seed), cfg)
    tp = tp_shards(cfg, mesh)
    if tp is not None:
        params = tp.shard(params)
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
    init_buffers = getattr(family(cfg), "init_buffers", None)
    buffers = {} if init_buffers is None else init_buffers(cfg, dev)
    return TrainState(params, opt, sched, buffers)


def accum_value_and_grad(base_lg, accum_steps: int):
    """Wrap base_lg(state, tokens, targets) -> loss, which adds the
    gradients of one batch into the parameters' `.grad`, with microbatch
    accumulation (pccl_tpu/parallel/train.py:accum_value_and_grad): the
    wrapped function takes tokens and targets [A, B, T] and runs one
    microbatch at a time, so one microbatch's activations are live at a
    time. Each backward adds its gradients unscaled into the fp32 `.grad`;
    at the end they are divided by A once, and the loss is the sum of the
    microbatch losses in fp32 over A: JAX's order (sum in fp32, then
    divide). A leading axis other than A raises."""

    def fn(state: TrainState, tokens, targets):
        a = tokens.shape[0] if tokens.dim() == 3 else None
        if a != accum_steps or tuple(targets.shape) != tuple(tokens.shape):
            raise ValueError(f"got {a} microbatches, step was built for "
                             f"accum_steps={accum_steps} (tokens and targets "
                             f"[A, B, T]; got {tuple(tokens.shape)} and "
                             f"{tuple(targets.shape)})")
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        for i in range(a):
            loss = base_lg(state, tokens[i], targets[i])
            loss_sum = loss if loss_sum is None else loss_sum + loss
        with torch.no_grad():
            for p in state.params.values():
                if p.grad is not None:
                    p.grad.div_(a)
        return loss_sum / a

    return fn


def _data_axes(mesh, seq_axis, attn_fn) -> tuple:
    """The mesh axes of more than one rank the batch is split over; raises
    where the step would compute another function than the unsplit step."""
    if seq_axis is not None:
        if seq_axis not in mesh.shape:
            raise ValueError(f"seq_axis {seq_axis!r} is not an axis of the "
                             f"mesh {mesh.shape}")
        if mesh.size(seq_axis) > 1 and \
                getattr(attn_fn, "ring_axis", None) != seq_axis:
            raise ValueError(f"a sequence split over {seq_axis!r} needs "
                             f"attn_fn=make_ring_attn_fn(mesh, {seq_axis!r})")
    return tuple(a for a in mesh.axis_names
                 if a in ("dp", seq_axis) and mesh.size(a) > 1)


def _mean_over(state: TrainState, loss, mesh, axes) -> torch.Tensor:
    """Replace each gradient by its mean over the ranks of `axes`, and
    return the mean loss: one local_mean of the gradients, flattened in
    the codec's leaf order with the loss at the end. Every rank gets the
    same bytes, so replicated parameters stay bitwise equal."""
    if not axes:
        return loss
    grads = {name: p.grad for name, p in state.params.items()}
    codec = build_codec(grads)
    vec = torch.empty(codec.count + 1, dtype=torch.float32, device=loss.device)
    codec.flat_into(grads, vec[:-1])
    vec[-1] = loss
    vec = local_mean(vec, mesh, axes)
    codec.unflat_into(vec[:-1], grads)
    return vec[-1].clone()


def _sections(profiler):
    """profiler.section, or a section that records nothing without one."""
    if profiler is None:
        return lambda name: contextlib.nullcontext()
    return profiler.section


def build_loss_and_grad(cfg, attn_fn=None, remat=False,
                        loss_chunk: "int | None" = None, accum_steps: int = 1,
                        mesh=None, seq_axis: "str | None" = None, profiler=None):
    """Returns loss_and_grad(state, tokens, targets) -> loss (a detached
    0-d tensor, not synchronised), leaving the gradients in each
    parameter's `.grad`. attn_fn, remat, loss_chunk, accum_steps, mesh,
    seq_axis and profiler as in build_train_step."""
    model = family(cfg)
    if model.ONE_RANK and mesh is not None and (
            mesh.shape.get("tp", 1) > 1 or seq_axis is not None):
        raise ValueError(f"{model.__name__} runs on one rank: no tensor or "
                         "sequence parallelism")
    shards = tp_shards(cfg, mesh)
    tp = None if shards is None else shards.group
    section = _sections(profiler)

    def run(state: TrainState, tokens, targets, pos_offset: int = 0):
        def micro(state: TrainState, tokens, targets):
            with section("train.forward"):
                loss = model.loss_fn(state.params, tokens, targets, cfg, attn_fn,
                                     remat, loss_chunk, pos_offset, tp=tp,
                                     profiler=profiler, **state.buffers)
            with section("train.backward"):
                loss.backward()
            return loss.detach()

        if accum_steps > 1:
            return accum_value_and_grad(micro, accum_steps)(state, tokens, targets)
        state.optimizer.zero_grad(set_to_none=True)
        return micro(state, tokens, targets)

    if mesh is None:
        if seq_axis is not None:
            raise ValueError("seq_axis needs a mesh")
        return run
    axes = _data_axes(mesh, seq_axis, attn_fn)

    def loss_and_grad(state: TrainState, tokens, targets):
        tokens, pos_offset = local_batch(tokens, mesh, seq_axis)
        targets, _ = local_batch(targets, mesh, seq_axis)
        return _mean_over(state, run(state, tokens, targets, pos_offset),
                          mesh, axes)

    return loss_and_grad


def apply(state: TrainState) -> None:
    """One AdamW update from the parameters' `.grad`, in place, and one
    step of the schedule."""
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()


def build_train_step(cfg, attn_fn=None, remat=False,
                     loss_chunk: "int | None" = None, accum_steps: int = 1,
                     mesh=None, seq_axis: "str | None" = None, profiler=None):
    """Returns step(state, tokens, targets) -> loss (a detached 0-d tensor,
    not synchronised): build_loss_and_grad, then apply. attn_fn: the
    attention op (e.g. ops.flash_attention); remat: checkpointing, False,
    True, "dots" or "sqrt" (models/_common.py:run_blocks); loss_chunk: the
    head and loss in checkpointed sequence chunks; accum_steps: with A > 1
    the step takes tokens and targets [A, B, T] and accumulates the
    gradients of the A microbatches (accum_value_and_grad) before one
    update.

    mesh (parallel/mesh.Mesh), on every rank of it: the step takes the
    global batch, runs this rank's block of it (local_batch: B over "dp",
    T over seq_axis at its global positions; attn_fn must then be
    ops.ring_attention.make_ring_attn_fn(mesh, seq_axis)), averages the
    gradients over the ranks of those axes and returns their mean loss
    (pccl_tpu/parallel/train.py:build_train_step with seq_axis). Every
    rank starts from the same parameters and keeps them bitwise equal.
    Under remat the backward replays a block's ring hops, in the same order
    on every rank. A "tp" axis runs the model tensor-parallel over its
    group on the state's blocks (make_train_state(mesh=)); the tp ranks
    take the same batch rows, and remat replays the tp collectives in one
    order on every rank.

    profiler (utils/profiler.Profiler): the step records the sections
    `train.forward` and `train.backward` (each microbatch's under
    accumulation) and `train.optimizer`; None records nothing."""
    section = _sections(profiler)
    loss_and_grad = build_loss_and_grad(cfg, attn_fn, remat, loss_chunk,
                                        accum_steps, mesh, seq_axis, profiler)

    def step(state: TrainState, tokens, targets):
        loss = loss_and_grad(state, tokens, targets)
        with section("train.optimizer"):
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


# ------------------------------------------------------------ gathered state

def gathered_state(state: TrainState, tp, dst: int = 0):
    """(full parameters by name, AdamW's leaves in optax's order with full
    mu and nu) on rank dst of the tp group (convert.TpShards), (None, None)
    on its other ranks; every rank of the group must call it. Without tp
    (None) the state's own tensors."""
    leaves = opt_state_leaves(state)
    if tp is None:
        return dict(state.params), leaves
    names = sorted(state.params)
    n = len(names)
    params = tp.gather(state.params, dst)
    mu = tp.gather(dict(zip(names, leaves[1:1 + n])), dst)
    nu = tp.gather(dict(zip(names, leaves[1 + n:1 + 2 * n])), dst)
    if params is None:
        return None, None
    return params, ([leaves[0]] + [mu[k] for k in names]
                    + [nu[k] for k in names] + leaves[1 + 2 * n:])


@torch.no_grad()
def load_gathered_state(state: TrainState, tp, params, leaves,
                        src: int = 0) -> None:
    """Write full parameters and leaves (gathered_state's form, given on
    rank src of the tp group, None elsewhere) into every rank's blocks:
    each rank's blocks scattered, the count broadcast. Every rank of the
    group must call it. Without tp: copied in place."""
    if tp is None:
        for name, p in state.params.items():
            if p is not params[name]:
                p.copy_(params[name])
        load_opt_state_leaves(state, leaves)
        return
    names = sorted(state.params)
    n = len(names)
    own = opt_state_leaves(state)
    full = tp.rank == src
    tp.scatter(params if full else None, state.params, src)
    tp.scatter(dict(zip(names, leaves[1:1 + n])) if full else None,
               dict(zip(names, own[1:1 + n])), src)
    tp.scatter(dict(zip(names, leaves[1 + n:1 + 2 * n])) if full else None,
               dict(zip(names, own[1 + n:1 + 2 * n])), src)
    count = (leaves[0] if full else own[0]).to("cpu", torch.int64).reshape(1)
    torch.distributed.broadcast(
        count, torch.distributed.get_global_rank(tp.group, src), group=tp.group)
    own[0] = count.to(torch.int32).reshape(())
    if state.scheduler is not None:
        own[-1] = own[0]
    load_opt_state_leaves(state, own)
