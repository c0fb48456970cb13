"""Mistral (configs/mistral-7b-v0.3.json) as pccl_tpu_torch/models/llama.py
runs it: grouped-query attention (q [d, H Dh], one kv product [d, 2 Hkv
Dh], out [H Dh, d]), a SwiGLU MLP of width `intermediate_size`, an untied
head."""

from __future__ import annotations


def n_layer(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def port_config(cfg: dict, block: int):
    from pccl_tpu_torch.models.llama import LlamaConfig

    out = LlamaConfig(vocab_size=cfg["vocab_size"],
                      n_layer=cfg["num_hidden_layers"],
                      n_head=cfg["num_attention_heads"],
                      n_kv_head=cfg["num_key_value_heads"],
                      n_embd=cfg["hidden_size"],
                      ffn_dim=cfg["intermediate_size"], block_size=block,
                      rope_theta=cfg["rope_theta"])
    if out.head_dim != cfg["head_dim"]:
        raise ValueError(f"head_dim {cfg['head_dim']} is not hidden_size / "
                         f"num_attention_heads = {out.head_dim}")
    return out


def param_shapes(cfg: dict) -> dict:
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    f = cfg["intermediate_size"]
    return {
        "tok_emb": ((V, d), 0.02, False),
        "ln1_g": ((L, d), None, False),
        "ln2_g": ((L, d), None, False),
        "attn_q": ((L, d, q), d ** -0.5, False),
        "attn_kv": ((L, d, 2 * kv), d ** -0.5, False),
        "attn_out": ((L, q, d), q ** -0.5, True),
        "mlp_gate": ((L, d, f), d ** -0.5, False),
        "mlp_up": ((L, d, f), d ** -0.5, False),
        "mlp_down": ((L, f, d), f ** -0.5, True),
        "lnf_g": ((d,), None, False),
        "head": ((d, V), d ** -0.5, False),
    }


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once a token: every layer's
    projections and the head; the embedding lookup and the gains are no
    products."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    dh = cfg["head_dim"]
    q = cfg["num_attention_heads"] * dh
    kv = cfg["num_key_value_heads"] * dh
    f = cfg["intermediate_size"]
    return L * (d * q + d * 2 * kv + q * d + 3 * d * f) + d * V


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 x the matmul parameters, plus 6 L T (H Dh) for causal attention, as
    families/gpt2.py counts it."""
    width = cfg["num_attention_heads"] * cfg["head_dim"]
    return 6.0 * matmul_params(cfg) + 6.0 * cfg["num_hidden_layers"] * seq_len * width


def flash_calls(cfg: dict, batch: int, block: int) -> list:
    return [(cfg["num_hidden_layers"],
             dict(B=batch, T=block, H=cfg["num_attention_heads"],
                  Hkv=cfg["num_key_value_heads"], D=cfg["head_dim"],
                  causal=True, window=None))]
