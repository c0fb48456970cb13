"""Ring attention: sequence parallelism over a mesh axis
(pccl_tpu/ops/ring_attention.py).

Q, K and V are split along the sequence over the ranks of the axis `sp`;
rank r holds tokens [r·Tl, (r+1)·Tl). At each of the n steps every rank
runs one attention of its own Q block against the K/V block it holds (on
a card the flash kernels: K1 forward, K2 and K3 backward, with the lse
cotangent folded into delta; on the CPU the dense twin), folds the
(out, log-sum-exp) pair into an fp32 accumulator, and passes K/V one hop
on: sent to rank r+1, received from rank r-1. After n steps every Q block
has met every K/V block. K/V travel Hkv-shaped (GQA), as the model hands
them over.

Causality is on global positions: at step s rank r holds the block of rank
(r - s) mod n, so a block is wholly visible or wholly not. Step 0 is the
diagonal (a causal call); a block at s > 0 is visible iff r >= s. Every
step calls the kernel, and an invisible one is masked by `torch.where`
(lse_s = -inf, weight exactly 0): each rank must take part in every hop of
the backward too, and autograd runs a hop's backward only where its output
reaches the loss on that rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import dense_attention_with_lse, flash_attention_with_lse


def _shard_attn_with_lse(q, k, v, causal: bool):
    """(out, lse [B, H, Tl]) of one block pair: the flash kernels on a
    card, the dense twin on the CPU."""
    if q.is_cuda:
        return flash_attention_with_lse(q, k, v, causal)
    return dense_attention_with_lse(q, k, v, causal)


class _Rotate(torch.autograd.Function):
    """K and V one hop along the ring (from rank r-1 to r); the backward
    sends their cotangents the other way (the transpose of ppermute)."""

    @staticmethod
    def forward(ctx, ring, k, v):
        ctx.ring = ring
        return tuple(ring.shift([k, v], 1))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *ctx.ring.shift([dk, dv], -1))


def _ring_attn_local(q, k, v, *, ring, causal: bool):
    """One rank's part: q [B, Tl, H, Dh], k/v [B, Tl, Hkv, Dh] local. The
    loop is unrolled over the n steps, as in the JAX package:

        lse' = logaddexp(lse, lse_s)
        o'   = o·exp(lse - lse') + o_s·exp(lse_s - lse')

    Step 0 is always visible, so lse is finite from the first fold and no
    -inf - -inf NaN arises."""
    B, Tl, H, Dh = q.shape
    n, r = ring.size, ring.rank
    o = torch.zeros((B, Tl, H, Dh), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Tl), -torch.inf, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for s in range(n):
        o_s, lse_s = _shard_attn_with_lse(q, kb, vb, causal and s == 0)
        if causal and s > 0:
            visible = torch.tensor(r >= s, device=q.device)
            lse_s = torch.where(visible, lse_s, -torch.inf)
        lse_new = torch.logaddexp(lse, lse_s)
        w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
        w_new = torch.exp(lse_s - lse_new).transpose(1, 2)[..., None]
        o = o * w_old + o_s.float() * w_new
        lse = lse_new
        if s != n - 1:
            kb, vb = _Rotate.apply(ring, kb, vb)
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   *, axis: str = "sp", batch_axis: Optional[str] = "dp",
                   causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention of this rank's blocks: q [B, Tl, H, Dh],
    k/v [B, Tl, Hkv, Dh], this rank's tokens of the sequence split over
    mesh axis `axis` (parallel/mesh.local_batch); returns its [B, Tl, H,
    Dh]. Every rank of the axis must call it. batch_axis names the axis B
    is split over, as in the JAX signature: each rank holds its own batch
    rows already, so it changes nothing here."""
    del batch_axis
    return _ring_attn_local(q, k, v, ring=mesh.ring(axis), causal=causal)


def make_ring_attn_fn(mesh, axis: str = "sp", batch_axis: Optional[str] = "dp"):
    """An attn_fn (q, k, v) -> out for the models: causal ring attention
    over `axis`. It carries `ring_axis`, which train.build_train_step
    checks against its seq_axis."""
    def attn(q, k, v):
        return ring_attention(q, k, v, mesh, axis=axis, batch_axis=batch_axis,
                              causal=True)
    attn.ring_axis = axis
    return attn
