"""mistral (configs/mistral-7b-v0.3.json): gpt2's skeleton with
grouped-query attention (kv head h // G serves q head h), a SwiGLU MLP
(silu(x W_gate) * (x W_up)) W_down, and an untied head. No biases."""

from __future__ import annotations

import torch.nn.functional as F

from portbench.reference.model import attention, rmsnorm, rope


def n_layer(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def norm_eps(cfg: dict) -> float:
    return cfg["rms_norm_eps"]


def head(params: dict, cfg: dict):
    return params["head"]


def layer(x, p, l, cfg):
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
