"""Pieces shared by the model families: the layer loop with checkpointing,
the fp32-output head product and the cross-entropy losses."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def run_blocks(block_fn, x: torch.Tensor, n_layer: int, remat) -> torch.Tensor:
    """x -> block_fn(..., l) for l in range(n_layer): the JAX package's
    lax.scan over stacked layer tensors, as a Python loop over the layer
    index. remat=True checkpoints each block (the backward recomputes its
    forward); "dots" and "sqrt" are not ported yet."""
    if remat in ("dots", "sqrt"):
        raise NotImplementedError(f"remat={remat!r} is not ported yet; use "
                                  "False or True")
    if remat not in (False, True, None):
        raise ValueError(f"unknown remat mode {remat!r}; use False or True")
    for layer in range(n_layer):
        if remat:
            x = checkpoint(block_fn, x, layer, use_reentrant=False)
        else:
            x = block_fn(x, layer)
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
