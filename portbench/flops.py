"""Operations and bytes from shapes, shared by `mfu` and the rooflines.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989
TFLOP/s in bf16 and 3.35 TB/s of HBM3, keyed by the name that
torch.cuda.get_device_name() gives.
"""

from __future__ import annotations

PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}


def peaks(device_name: str) -> tuple:
    """(bf16 FLOP/s, bytes/s) of a card; KeyError for a card not listed,
    so no share is ever taken of a guessed peak."""
    return PEAKS[device_name]


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once a token: every layer's
    projections and the head (tied or not); the embedding lookup and the
    gains are no products."""
    if cfg["model_type"] == "gpt2":
        d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
        return L * 12 * d * d + d * V
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    dh = cfg["head_dim"]
    q = cfg["num_attention_heads"] * dh
    kv = cfg["num_key_value_heads"] * dh
    f = cfg["intermediate_size"]
    return L * (d * q + d * 2 * kv + q * d + 3 * d * f) + d * V


def n_layer(cfg: dict) -> int:
    return cfg.get("n_layer", cfg.get("num_hidden_layers"))


def attn_width(cfg: dict) -> int:
    """Width of the attention products: heads x head dim."""
    if cfg["model_type"] == "gpt2":
        return cfg["n_embd"]
    return cfg["num_attention_heads"] * cfg["head_dim"]


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token (forward and backward): 6 x the
    matmul parameters, plus 6 L T d for causal attention (QK^T and PV over
    the T/2 keys a query sees on average, forward 2 x 2 x T/2 x d, backward
    twice that). Recomputation is not counted."""
    return 6.0 * matmul_params(cfg) + 6.0 * n_layer(cfg) * seq_len * attn_width(cfg)


def visible_pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


def flash_work(B, T, H, Hkv, D, causal=True) -> dict:
    """kernel -> (FLOPs of its products, bytes read once and written once)
    of one call of K1 (flash_fwd), K2 (flash_bwd_dq), K3 (flash_bwd_dkv)."""
    pairs = B * H * visible_pairs(T, causal)
    q_b, kv_b, vec_b = B * T * H * D * 2, B * T * Hkv * D * 2, B * H * T * 4
    return {
        # QK^T and PV
        "flash_fwd": (4 * pairs * D, 2 * q_b + 2 * kv_b + vec_b),
        # QK^T, dO V^T, dS K
        "flash_bwd_dq": (6 * pairs * D, 3 * q_b + 2 * kv_b + 2 * vec_b),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (8 * pairs * D, 2 * q_b + 4 * kv_b + 2 * vec_b),
    }


def bounds(B, T, H, Hkv, D, causal=True, peak_flops=989e12,
           peak_bytes=3.35e12) -> dict:
    """kernel -> (least ms of one call, "operations" or "bytes"): the larger
    of FLOPs over the bf16 peak and bytes over the HBM rate."""
    out = {}
    for name, (fl, nbytes) in flash_work(B, T, H, Hkv, D, causal).items():
        t_ops, t_bytes = fl / peak_flops * 1e3, nbytes / peak_bytes * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def attn_shape(cfg: dict, batch: int, block: int) -> tuple:
    """(B, T, H, Hkv, Dh) of the model's attention calls."""
    if cfg["model_type"] == "gpt2":
        h = cfg["n_head"]
        return batch, block, h, h, cfg["n_embd"] // h
    return (batch, block, cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"])


def hash_bound_ms(nbytes: int, peak_bytes=3.35e12) -> float:
    """H1 reads every byte once: its least time is the bytes over HBM."""
    return nbytes / peak_bytes * 1e3
