"""Pieces shared by the model families: the layer loop with checkpointing,
the fp32-output head product and the cross-entropy losses."""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of products without a batch
    dimension (aten.mm: every `[..., d] @ W`, flattened to 2-D, and
    _MatmulF32Out's fp32-output mm) and recompute the rest, the batched
    attention products and the flash kernel included. JAX's
    checkpoint_dots_with_no_batch_dims."""
    return CheckpointPolicy.MUST_SAVE \
        if getattr(op, "overloadpacket", None) is torch.ops.aten.mm \
        else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _save_weight_products)


def _sqrt_divisor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n) (1 for primes)."""
    g = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            g = d
        d += 1
    return g


def run_blocks(block_fn, x: torch.Tensor, n_layer: int, remat) -> torch.Tensor:
    """x -> block_fn(..., l) for l in range(n_layer): the JAX package's
    lax.scan over stacked layer tensors, as a Python loop over the layer
    index, with its checkpointing (pccl_tpu/models/_common.py:scan_blocks).

    remat: False keeps every activation; True checkpoints each block (the
    backward recomputes its forward); "dots" checkpoints each block but
    keeps its weight products (_save_weight_products); "sqrt" checkpoints
    groups of G blocks, G the largest divisor of n_layer <= sqrt(n_layer),
    and each block inside a group as well, so the backward holds
    n_layer/G group inputs and, while one group is recomputed, G block
    inputs. A prime n_layer (G = 1) falls back to True."""
    if remat not in (False, True, None, "dots", "sqrt"):
        raise ValueError(f"unknown remat mode {remat!r}; use False, True, "
                         "'dots', or 'sqrt'")
    if not remat:
        for layer in range(n_layer):
            x = block_fn(x, layer)
        return x
    if remat == "sqrt":
        G = _sqrt_divisor(n_layer)
        if G == 1:
            return run_blocks(block_fn, x, n_layer, True)

        def group(h, first):
            for layer in range(first, first + G):
                h = checkpoint(block_fn, h, layer, use_reentrant=False)
            return h

        for first in range(0, n_layer, G):
            x = checkpoint(group, x, first, use_reentrant=False)
        return x
    kw = {"context_fn": _DOTS_CONTEXT} if remat == "dots" else {}
    for layer in range(n_layer):
        x = checkpoint(block_fn, x, layer, use_reentrant=False, **kw)
    return x


class _MatmulF32Out(torch.autograd.Function):
    """x @ w with operands in x's dtype, fp32 accumulation and an fp32
    result (JAX's preferred_element_type=float32). The backward takes the
    cotangent in the operands' dtype, so both gradient products run on the
    tensor cores too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            # products of two bf16 values are exact in fp32: this is the
            # same function, summed in fp32
            out = x2.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w.t()).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d] @ [d, n] in x's dtype with an fp32 result."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    return _MatmulF32Out.apply(x, w)


def gather_ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy as logsumexp(logits) - logits[target]."""
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).mean()


def chunked_ce_loss(x: torch.Tensor, head_mat: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean next-token CE without the full [B, T, vocab] logits: each
    sequence chunk's logits are computed under a checkpoint, so the backward
    recomputes them and peak logits memory is [B, chunk, vocab].

    x: [B, T, d] final hidden states; head_mat: [d, vocab]; targets [B, T].
    ``chunk`` must divide T."""
    B, T, _ = x.shape
    if T % chunk:
        raise ValueError(f"loss chunk {chunk} must divide T={T}")

    def chunk_nll(xc, tc):
        logits = matmul_f32(xc, head_mat)
        tgt = logits.gather(-1, tc[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - tgt).sum()

    tot = x.new_zeros((), dtype=torch.float32)
    for i in range(0, T, chunk):
        tot = tot + checkpoint(chunk_nll, x[:, i:i + chunk],
                               targets[:, i:i + chunk], use_reentrant=False)
    return tot / (B * T)
