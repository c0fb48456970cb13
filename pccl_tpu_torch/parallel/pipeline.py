"""Pipeline parallelism: GPipe microbatches over a mesh axis
(pccl_tpu/parallel/pipeline.py).

The layer-stacked GPT ([n_layer, ...] tensors) splits its layer dim over a
`pp` axis: stage s holds layers [s·L/S, (s+1)·L/S). With S stages and M
microbatches the loop runs M + S - 1 ticks. At each tick every stage first
passes the activation it holds one stage on (`P2PRing.shift` by +1 inside
an autograd Function whose backward shifts by -1), then runs its layers;
stage 0 takes microbatch t instead of what it received, stage S-1 finishes
microbatch t - (S-1). The bubble share is (S-1)/(M+S-1).

As in JAX, every tick runs on every stage, bubbles included, and stage 0's
choice is `torch.where` on a tensor, not a Python `if`: each rank must post
every backward hop, and autograd runs a hop's backward only where the
hop's output reaches that rank's loss. The replicated input gets copy_to
over the axis (only stage 0's cotangent is non-zero), and the output is
replicated by reduce_from of stage S-1's result (zeros elsewhere).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import family, gpt
from ..models._common import layer_views, rmsnorm
from .mesh import copy_to, reduce_from


def shard_layer_params(layers: Dict[str, torch.Tensor], mesh,
                       axis: str = "pp") -> Dict[str, torch.Tensor]:
    """This stage's [L/S, ...] block of each stacked layer tensor."""
    S, s = mesh.size(axis), mesh.rank(axis)
    out = {}
    for name, x in layers.items():
        if x.shape[0] % S:
            raise ValueError(f"{name}: {x.shape[0]} layers do not split over "
                             f"{S} stages")
        n = x.shape[0] // S
        out[name] = x[s * n:(s + 1) * n].contiguous()
    return out


class _Shift(torch.autograd.Function):
    """An activation one stage on (from stage s-1 to s); the backward sends
    its cotangent one stage back."""

    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return ring.shift([x], 1)[0]

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ring.shift([g], -1)[0]


def _run_local_stack(layers_local, x, cfg: gpt.GPTConfig, attn_fn):
    """One stage's layers, in order, on views made anew at each call (the
    pipeline calls it once per tick)."""
    for layer in layer_views(layers_local, gpt.LAYER_KEYS):
        x = gpt.block(x, layer, cfg, attn_fn)
    return x


def pipeline_blocks(x: torch.Tensor, layers_local: Dict[str, torch.Tensor],
                    cfg: gpt.GPTConfig, mesh, *, axis: str = "pp",
                    microbatches: int = 0, attn_fn=None) -> torch.Tensor:
    """The block stack pipelined over mesh axis `axis`: x [B, T, d], the
    same on every stage; layers_local this stage's block of the stacked
    layers (shard_layer_params). Returns [B, T, d] on every stage. Every
    rank of the axis must call it. microbatches=0 takes S."""
    group = mesh.group(axis)
    S, stage = mesh.size(axis), mesh.rank(axis)
    ring = mesh.ring(axis)
    B = x.shape[0]
    M = microbatches or S
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    if cfg.n_layer % S:
        raise ValueError(f"{cfg.n_layer} layers do not split over {S} stages")
    mb = B // M
    xs = copy_to(x, group).reshape(M, mb, *x.shape[1:])
    first = torch.tensor(stage == 0, device=x.device)
    cur = torch.zeros((mb, *x.shape[1:]), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(M + S - 1):
        prev = _Shift.apply(ring, cur) if S > 1 else cur
        # bubble ticks feed zeros, as JAX's padded microbatches
        fed = xs[t] if t < M else torch.zeros_like(cur)
        cur = _run_local_stack(layers_local, torch.where(first, fed, prev),
                               cfg, attn_fn)
        ys.append(cur)
    # microbatch m leaves the last stage at tick m + S - 1
    done = torch.stack(ys[S - 1:S - 1 + M])
    last = torch.tensor(stage == S - 1, device=x.device)
    done = torch.where(last, done, torch.zeros_like(done))
    return reduce_from(done, group).reshape(B, *x.shape[1:])


def build_pipelined_forward(cfg: gpt.GPTConfig, mesh, *, axis: str = "pp",
                            microbatches: int = 0, attn_fn=None) -> Callable:
    """(params, tokens) -> logits fp32 [B, T, vocab] with the block stack
    pipelined over `axis`. params holds the whole embedding and final gain
    and this stage's layers (shard_layer_params). The head is the tied one
    in fp32, x.float() @ tok_emb.T.float(), the JAX pipeline's own (not
    gpt.forward's compute-dtype operands); untie_head is ignored, as in
    JAX."""
    if family(cfg) is not gpt:
        raise TypeError(f"the pipeline runs GPT blocks; {type(cfg).__name__} is "
                        "not a GPTConfig")

    def forward(params, tokens):
        x = params["tok_emb"][tokens.long()].to(cfg.compute_dtype)
        layers = {k: params[k] for k in gpt.LAYER_KEYS}
        x = pipeline_blocks(x, layers, cfg, mesh, axis=axis,
                            microbatches=microbatches, attn_fn=attn_fn)
        x = rmsnorm(x, params["lnf_g"])
        return x.float() @ params["tok_emb"].t().float()

    return forward
