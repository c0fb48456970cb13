"""lfm2_moe (configs/lfm2-8b-a1b.json), from LiquidAI's description of
LFM2-8B-A1B: layer l is x += Mixer(RMSNorm(x)); x += FFN(RMSNorm(x)), every
RMSNorm with `norm_eps`.

- conv layers: [B | C | X] = h W_in (chunks in that order), u = B * X,
  v_t = sum_j w[:, j] u_{t-K+1+j} (K = conv_L_cache, u before the sequence
  zero, no bias), y = (C * v) W_out;
- full_attention layers: q = h W_q, [k | v] = h W_kv, each head of q and
  k RMS-normalised over Dh with its own gain, then rotary embeddings, causal
  grouped-query attention, the out product;
- the first num_dense_layers FFNs: (silu(h W_gate) * h W_up) W_down; the
  others: s = sigmoid(h W_router) over the experts, the top
  num_experts_per_tok of s + b chosen (b the expert bias, zeros here, or
  params["moe_bias"][expert layer] where a test gives one), each chosen
  expert weighted by s_e over the chosen s' sum (norm_topk_prob) times
  routed_scaling_factor; out = sum of weight x SwiGLU_e(h), every token
  through all its experts. The experts run one at a time over their tokens;
- the head is the embedding's transpose.

Departures in layout only: an expert's gate and up matrices are one [d,
2f] matrix (gate columns first), the conv taps [d, K]. No biases."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import attention, rmsnorm, rope


def n_layer(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def norm_eps(cfg: dict) -> float:
    return cfg["norm_eps"]


def head(params: dict, cfg: dict):
    return params["tok_emb"].t()


def _conv(h, p, i):
    T = h.shape[1]
    b, c, x = (h @ p["conv_in"][i]).chunk(3, dim=-1)
    u = b * x
    w = p["conv_w"][i]
    K = w.shape[-1]
    # tap j reads u_{t - lag}, lag = K - 1 - j: u shifted lag steps later
    v = sum(w[:, j] * F.pad(u[:, :T - (K - 1 - j)], (0, 0, K - 1 - j, 0)) for j in range(K))
    return (c * v) @ p["conv_out"][i]


def _attn(h, p, i, cfg):
    B, T, d = h.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, eps, theta = d // H, cfg["norm_eps"], float(cfg["rope_theta"])
    q = rmsnorm((h @ p["attn_q"][i]).reshape(B, T, H, Dh), p["q_norm"][i], eps)
    k, v = (h @ p["attn_kv"][i]).chunk(2, dim=-1)
    k = rmsnorm(k.reshape(B, T, Hkv, Dh), p["k_norm"][i], eps)
    return attention(rope(q, theta), rope(k, theta), v.reshape(B, T, Hkv, Dh)) \
        @ p["attn_out"][i]


def _experts(h, p, m, cfg):
    B, T, d = h.shape
    x = h.reshape(B * T, d)
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    s = torch.sigmoid(x @ p["moe_router"][m])
    bias = p["moe_bias"][m] if "moe_bias" in p else torch.zeros(E, device=x.device)
    chosen = torch.topk(s.detach() + bias, k, dim=-1).indices
    w = s.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(E):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = (x[tok] @ p["moe_gate_up"][m, e]).chunk(2, dim=-1)
        y = (F.silu(gate) * up) @ p["moe_down"][m, e]
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out.reshape(B, T, d)


def layer(x, p, l, cfg):
    types, eps = cfg["layer_types"], cfg["norm_eps"]
    i = types[:l].count(types[l])            # the layer's index among its kind
    h = rmsnorm(x, p["op_norm"][l], eps)
    x = x + (_conv(h, p, i) if types[l] == "conv" else _attn(h, p, i, cfg))
    h = rmsnorm(x, p["ffn_norm"][l], eps)
    dense = cfg["num_dense_layers"]
    if l < dense:
        return x + (F.silu(h @ p["mlp_gate"][l]) * (h @ p["mlp_up"][l])) @ p["mlp_down"][l]
    return x + _experts(h, p, l - dense, cfg)
