"""Forward and loss, plain fp32: the token embedding, the layers, a final
RMSNorm and the head, with the pieces the model types share (RMSNorm,
rotary embeddings, blockwise attention, the chunked cross-entropy). A
model type's layer, head and norm eps are in reference/families/<type>.py,
found by the configuration's `model_type`.

Memory: each layer runs under a checkpoint (its input is kept, the rest
recomputed in the backward); attention runs a block of query rows at a
time, each block under a checkpoint, so the [T, T] scores of one block
live at a time; the head and the loss likewise run in chunks of rows.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench import spec

SCORE_BYTES = 2 << 30     # fp32 scores of one attention block, at most


def rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def rope(x, theta):
    """x [B, T, H, Dh]: pairs (i, i + Dh/2) rotate by pos * theta^(-2i/Dh)."""
    T, Dh = x.shape[1], x.shape[3]
    half = Dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attn_block(qb, k, v, start, first, window):
    """Rows [start, start + qb.shape[1]) of causal attention: qb [B, n, Hkv,
    G, Dh] against the keys k, v [B, m, Hkv, Dh] at positions [first, first
    + m) they may see; with a window, a row sees itself and the window - 1
    keys before it."""
    n, Dh = qb.shape[1], qb.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, k) / math.sqrt(Dh)
    qi = torch.arange(start, start + n, device=qb.device)[:, None]
    ki = torch.arange(first, first + k.shape[1], device=qb.device)[None, :]
    masked = ki > qi
    if window is not None:
        masked = masked | (ki <= qi - window)
    s = s.masked_fill(masked, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def attention(q, k, v, window=None):
    """Causal attention, q [B, T, H, Dh], k and v [B, T, Hkv, Dh]; with a
    window (an int), sliding-window attention: each query sees itself and
    the window - 1 keys before it."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, T, Hkv, H // Hkv, Dh)
    rows = max(1, min(T, SCORE_BYTES // (4 * B * H * T)))
    outs = []
    for a in range(0, T, rows):
        b = min(T, a + rows)
        first = 0 if window is None else max(0, a - window + 1)
        outs.append(checkpoint(_attn_block, q[:, a:b], k[:, first:b], v[:, first:b], a,
                               first, window, use_reentrant=False))
    return torch.cat(outs, dim=1).reshape(B, T, H * Dh)


def _nll_sum(x, head, tgt):
    logits = x @ head
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, tgt[..., None])[..., 0]).sum()


def ce_loss(x, head, targets):
    B, T, _ = x.shape
    rows = max(1, min(T, SCORE_BYTES // (4 * B * head.shape[1])))
    tot = x.new_zeros(())
    for a in range(0, T, rows):
        tot = tot + checkpoint(_nll_sum, x[:, a:a + rows], head,
                               targets[:, a:a + rows], use_reentrant=False)
    return tot / (B * T)


def loss(params: dict, tokens, targets, cfg: dict, here=spec.HERE):
    """Mean next-token cross-entropy of fp32 parameters on tokens [B, T]."""
    fam = spec.reference_family(cfg["model_type"], here)
    x = params["tok_emb"][tokens]
    for l in range(fam.n_layer(cfg)):
        x = checkpoint(fam.layer, x, params, l, cfg, use_reentrant=False)
    return ce_loss(rmsnorm(x, params["lnf_g"], fam.norm_eps(cfg)), fam.head(params, cfg),
                   targets)
