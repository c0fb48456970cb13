"""The inputs of a run, made from --seed on the device: the weights, in the
port's parameter layout (named tensors, per-layer tensors stacked over a
leading [n_layer] dim, `x @ W` weights laid out [in, out], fp32), and each
peer's token batches. The peers and the reference call the same functions
with the same seed on the same kind of card, so both get the same numbers.

Distributions, GPT-2 style as the port's models document them: N(0, 0.02)
embedding, N(0, 1/fan_in) projections, the residual outputs scaled by
1/sqrt(2 L), unit gains.
"""

from __future__ import annotations

import math

import torch


def _sub_seed(seed: int, stream: int) -> int:
    return (seed * 1_000_003 + 7_919 * stream) % (1 << 63)


def param_shapes(cfg: dict) -> dict:
    """name -> (shape, std, residual), in draw order; std None is a gain
    (ones)."""
    if cfg["model_type"] == "gpt2":
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


@torch.no_grad()
def init_params(cfg: dict, seed: int, device) -> dict:
    """fp32 parameters on `device`, one randn call a tensor from one
    generator on that device."""
    L = cfg.get("n_layer", cfg.get("num_hidden_layers"))
    res = 1.0 / math.sqrt(2 * L)
    gen = torch.Generator(device=device).manual_seed(_sub_seed(seed, 0))
    out = {}
    for name, (shape, std, residual) in param_shapes(cfg).items():
        if std is None:
            out[name] = torch.ones(shape, device=device)
            continue
        t = torch.randn(shape, generator=gen, device=device)
        out[name] = t.mul_(std * (res if residual else 1.0))
    return out


class Batches:
    """Peer `rank`'s stream of (tokens, targets) int64 [B, T]: uniform
    token ids, every row its own draw; batch i is the i-th draw of one
    generator on the device."""

    def __init__(self, seed: int, rank: int, batch: int, block: int,
                 vocab: int, device):
        self.shape = (batch, block + 1)
        self.vocab = vocab
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(
            _sub_seed(seed, 1 + rank))

    def next(self):
        x = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                          device=self.device)
        return x[:, :-1], x[:, 1:]

