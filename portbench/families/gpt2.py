"""GPT-2 (configs/gpt2-medium.json) as pccl_tpu_torch/models/gpt.py runs it:
per layer one qkv product [d, 3d], the out product, an MLP of width 4d;
the head is the embedding's transpose."""

from __future__ import annotations


def n_layer(cfg: dict) -> int:
    return cfg["n_layer"]


def port_config(cfg: dict, block: int):
    from pccl_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=cfg["vocab_size"], n_layer=cfg["n_layer"],
                     n_head=cfg["n_head"], n_embd=cfg["n_embd"],
                     block_size=block,
                     rope_theta=cfg["assumed"]["rope_theta"])


def param_shapes(cfg: dict) -> dict:
    d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    return {
        "tok_emb": ((V, d), 0.02, False),
        "ln1_g": ((L, d), None, False),
        "ln2_g": ((L, d), None, False),
        "attn_qkv": ((L, d, 3 * d), d ** -0.5, False),
        "attn_out": ((L, d, d), d ** -0.5, True),
        "mlp_in": ((L, d, 4 * d), d ** -0.5, False),
        "mlp_out": ((L, 4 * d, d), (4 * d) ** -0.5, True),
        "lnf_g": ((d,), None, False),
    }


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once a token: 12 d^2 a layer
    and the tied head; the embedding lookup and the gains are no
    products."""
    d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    return L * 12 * d * d + d * V


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 x the matmul parameters, plus 6 L T d for causal attention (QK^T
    and PV over the T/2 keys a query sees on average, forward 2 x 2 x T/2
    x d, backward twice that)."""
    return 6.0 * matmul_params(cfg) + 6.0 * cfg["n_layer"] * seq_len * cfg["n_embd"]


def flash_calls(cfg: dict, batch: int, block: int) -> list:
    h = cfg["n_head"]
    return [(cfg["n_layer"], dict(B=batch, T=block, H=h, Hkv=h, D=cfg["n_embd"] // h,
                                  causal=True, window=None))]
