"""Forward and loss of the two model types, plain fp32.

gpt2 (configs/gpt2-medium.json with its `assumed` departures): token
embedding; per layer RMSNorm (eps from the file), one qkv product, rotary
embeddings on the two halves of each head, causal softmax attention, the
out product, RMSNorm, x W_in, GELU (tanh form, "gelu_new"), x W_out, each
added to the residual; a final RMSNorm and the tied head (the embedding's
transpose). No biases.

mistral (configs/mistral-7b-v0.3.json): the same skeleton with grouped-query
attention (kv head h // G serves q head h), a SwiGLU MLP
(silu(x W_gate) * (x W_up)) W_down, and an untied head.

Memory: each layer runs under a checkpoint (its input is kept, the rest
recomputed in the backward); attention runs a block of query rows at a
time, each block under a checkpoint, so the [T, T] scores of one block
live at a time; the head and the loss likewise run in chunks of rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _attn_block(qb, k, v, start):
    """Rows [start, start + qb.shape[1]) of causal attention: qb [B, n, Hkv,
    G, Dh] against the keys k, v [B, start + n, Hkv, Dh] they may see."""
    n, Dh = qb.shape[1], qb.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, k) / math.sqrt(Dh)
    qi = torch.arange(start, start + n, device=qb.device)[:, None]
    ki = torch.arange(k.shape[1], device=qb.device)[None, :]
    s = s.masked_fill(ki > qi, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def attention(q, k, v):
    """Causal attention, q [B, T, H, Dh], k and v [B, T, Hkv, Dh]."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, T, Hkv, H // Hkv, Dh)
    rows = max(1, min(T, SCORE_BYTES // (4 * B * H * T)))
    outs = []
    for a in range(0, T, rows):
        b = min(T, a + rows)
        outs.append(checkpoint(_attn_block, q[:, a:b], k[:, :b], v[:, :b], a,
                               use_reentrant=False))
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


def _gpt_layer(x, p, l, cfg):
    B, T, d = x.shape
    H = cfg["n_head"]
    eps = cfg["layer_norm_epsilon"]
    theta = cfg["assumed"]["rope_theta"]
    q, k, v = (rmsnorm(x, p["ln1_g"][l], eps) @ p["attn_qkv"][l]).chunk(3, dim=-1)
    q = rope(q.reshape(B, T, H, d // H), theta)
    k = rope(k.reshape(B, T, H, d // H), theta)
    x = x + attention(q, k, v.reshape(B, T, H, d // H)) @ p["attn_out"][l]
    h = rmsnorm(x, p["ln2_g"][l], eps)
    return x + F.gelu(h @ p["mlp_in"][l], approximate="tanh") @ p["mlp_out"][l]


def _mistral_layer(x, p, l, cfg):
    B, T, d = x.shape
    H, Hkv, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = rmsnorm(x, p["ln1_g"][l], eps)
    q = rope((h @ p["attn_q"][l]).reshape(B, T, H, Dh), theta)
    k, v = (h @ p["attn_kv"][l]).chunk(2, dim=-1)
    k = rope(k.reshape(B, T, Hkv, Dh), theta)
    x = x + attention(q, k, v.reshape(B, T, Hkv, Dh)) @ p["attn_out"][l]
    h = rmsnorm(x, p["ln2_g"][l], eps)
    return x + (F.silu(h @ p["mlp_gate"][l]) * (h @ p["mlp_up"][l])) @ p["mlp_down"][l]


def loss(params: dict, tokens, targets, cfg: dict):
    """Mean next-token cross-entropy of fp32 parameters on tokens [B, T]."""
    x = params["tok_emb"][tokens]
    if cfg["model_type"] == "gpt2":
        layer, L, eps = _gpt_layer, cfg["n_layer"], cfg["layer_norm_epsilon"]
        head = params["tok_emb"].t()
    else:
        layer, L, eps = _mistral_layer, cfg["num_hidden_layers"], cfg["rms_norm_eps"]
        head = params["head"]
    for l in range(L):
        x = checkpoint(layer, x, params, l, cfg, use_reentrant=False)
    return ce_loss(rmsnorm(x, params["lnf_g"], eps), head, targets)
