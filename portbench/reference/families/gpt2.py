"""gpt2 (configs/gpt2-medium.json with its `assumed` departures): per layer
RMSNorm (eps from the file), one qkv product, rotary embeddings on the two
halves of each head, causal softmax attention, the out product, RMSNorm,
x W_in, GELU (tanh form, "gelu_new"), x W_out, each added to the residual;
the tied head (the embedding's transpose). No biases."""

from __future__ import annotations

import torch.nn.functional as F

from portbench.reference.model import attention, rmsnorm, rope


def n_layer(cfg: dict) -> int:
    return cfg["n_layer"]


def norm_eps(cfg: dict) -> float:
    return cfg["layer_norm_epsilon"]


def head(params: dict, cfg: dict):
    return params["tok_emb"].t()


def layer(x, p, l, cfg):
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
