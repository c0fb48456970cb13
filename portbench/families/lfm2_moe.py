"""lfm2_moe (configs/lfm2-8b-a1b.json) as pccl_tpu_torch/models/lfm2.py runs
it: gated short-conv and QK-norm grouped-query attention layers by
`layer_types`, SwiGLU FFNs in the first `num_dense_layers` layers and a
dropless top-k of `num_experts` SwiGLU experts in the others, the head tied
to the embedding. Each kind's weights are stacked over the layers of that
kind; moe_gate_up holds an expert's gate and up columns side by side."""

from __future__ import annotations


def n_layer(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def _kinds(cfg: dict) -> tuple:
    """(conv layers, attention layers, dense FFN layers, expert layers)."""
    types = cfg["layer_types"]
    if len(types) != n_layer(cfg):
        raise ValueError(f"{len(types)} layer_types for {n_layer(cfg)} layers")
    dense = cfg["num_dense_layers"]
    return (types.count("conv"), types.count("full_attention"), dense, n_layer(cfg) - dense)


def _head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def port_config(cfg: dict, block: int):
    from pccl_tpu_torch.models.lfm2 import Lfm2MoeConfig

    if cfg["conv_bias"]:
        raise ValueError("models/lfm2.py's short conv has no bias")
    return Lfm2MoeConfig(vocab_size=cfg["vocab_size"], layer_types=tuple(cfg["layer_types"]),
                         n_head=cfg["num_attention_heads"],
                         n_kv_head=cfg["num_key_value_heads"], n_embd=cfg["hidden_size"],
                         ffn_dim=cfg["intermediate_size"],
                         num_dense_layers=cfg["num_dense_layers"],
                         n_experts=cfg["num_experts"],
                         expert_dim=cfg["moe_intermediate_size"],
                         top_k=cfg["num_experts_per_tok"],
                         norm_topk_prob=cfg["norm_topk_prob"],
                         routed_scale=float(cfg["routed_scaling_factor"]),
                         conv_width=cfg["conv_L_cache"], block_size=block,
                         rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["norm_eps"])


def param_shapes(cfg: dict) -> dict:
    d, L, V = cfg["hidden_size"], n_layer(cfg), cfg["vocab_size"]
    Lc, La, Ld, Lm = _kinds(cfg)
    q = cfg["num_attention_heads"] * _head_dim(cfg)
    kv = cfg["num_key_value_heads"] * _head_dim(cfg)
    ffn, E, f = cfg["intermediate_size"], cfg["num_experts"], cfg["moe_intermediate_size"]
    K = cfg["conv_L_cache"]
    shapes = {
        "tok_emb": ((V, d), 0.02, False),
        "op_norm": ((L, d), None, False),
        "ffn_norm": ((L, d), None, False),
        "conv_in": ((Lc, d, 3 * d), d ** -0.5, False),
        "conv_w": ((Lc, d, K), K ** -0.5, False),
        "conv_out": ((Lc, d, d), d ** -0.5, True),
        "attn_q": ((La, d, q), d ** -0.5, False),
        "attn_kv": ((La, d, 2 * kv), d ** -0.5, False),
        "attn_out": ((La, q, d), q ** -0.5, True),
        "q_norm": ((La, _head_dim(cfg)), None, False),
        "k_norm": ((La, _head_dim(cfg)), None, False),
        "mlp_gate": ((Ld, d, ffn), d ** -0.5, False),
        "mlp_up": ((Ld, d, ffn), d ** -0.5, False),
        "mlp_down": ((Ld, ffn, d), ffn ** -0.5, True),
        "moe_router": ((Lm, d, E), d ** -0.5, False),
        "moe_gate_up": ((Lm, E, d, 2 * f), d ** -0.5, False),
        "moe_down": ((Lm, E, f, d), f ** -0.5, True),
        "lnf_g": ((d,), None, False),
    }
    return {k: v for k, v in shapes.items() if v[0][0]}


def matmul_params(cfg: dict) -> float:
    """Parameters that enter a matrix product once a token: the conv
    layers' in and out products (the taps are elementwise), the attention
    products, the dense FFNs, each expert layer's router and k of its E
    experts, and the tied head; the embedding lookup and the gains are no
    products."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    Lc, La, Ld, Lm = _kinds(cfg)
    q = cfg["num_attention_heads"] * _head_dim(cfg)
    kv = cfg["num_key_value_heads"] * _head_dim(cfg)
    E, k, f = cfg["num_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    return (Lc * 4 * d * d + La * (d * q + d * 2 * kv + q * d)
            + Ld * 3 * d * cfg["intermediate_size"] + Lm * (d * E + k * 3 * d * f) + d * V)


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 x the active matmul parameters, plus 6 L_attn T (H Dh) for causal
    attention, as families/gpt2.py counts it."""
    width = cfg["num_attention_heads"] * _head_dim(cfg)
    return 6.0 * matmul_params(cfg) + 6.0 * _kinds(cfg)[1] * seq_len * width


def flash_calls(cfg: dict, batch: int, block: int) -> list:
    return [(_kinds(cfg)[1], dict(B=batch, T=block, H=cfg["num_attention_heads"],
                                  Hkv=cfg["num_key_value_heads"], D=_head_dim(cfg),
                                  causal=True, window=None))]


def moe_gemm_calls(cfg: dict, batch: int, block: int) -> dict:
    """variant -> [(FLOPs, bytes), ...] of each launch of the experts'
    grouped products in one pass of an expert layer (ops/moe_gemm.py: the
    gate-up product [d, 2f] and the down product [f, d], each a forward, a
    dx and a dw launch). Dropless: S = batch x block x k rows whatever the
    routing. Bytes: each operand read once and the result written once,
    bf16 but the fp32 dw."""
    S = batch * block * cfg["num_experts_per_tok"]
    d, E, f = cfg["hidden_size"], cfg["num_experts"], cfg["moe_intermediate_size"]
    out = {"moe_gemm_fwd": [], "moe_gemm_dx": [], "moe_gemm_dw": []}
    for K, N in ((d, 2 * f), (f, d)):
        fl, x, y, w = 2 * S * K * N, 2 * S * K, 2 * S * N, E * K * N
        out["moe_gemm_fwd"].append((fl, x + 2 * w + y))
        out["moe_gemm_dx"].append((fl, y + 2 * w + x))
        out["moe_gemm_dw"].append((fl, x + y + 4 * w))
    return out
