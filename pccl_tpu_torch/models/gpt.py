"""Decoder-only transformer (GPT family) in PyTorch, with the JAX package's
parameters: a dict of tensors with the same names and shapes, per-layer
tensors stacked over a leading [n_layer] dim, and `x @ W` weights laid out
[in, out]. Weights cross between the two packages with no transpose
(models/convert.py).

Numerics follow pccl_tpu/models/gpt.py: parameters in fp32, compute in
`compute_dtype` (bf16 by default); RMSNorm in fp32 with eps 1e-6 inside the
rsqrt; rotary embeddings on two halves of the head dim (not interleaved),
with cos and sin cast to the compute dtype; GELU with the tanh
approximation (jax.nn.gelu's default); the tied head with compute-dtype
operands and an fp32 result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ._common import chunked_ce_loss, gather_ce_loss, matmul_f32, run_blocks


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    dropout: float = 0.0  # kept for parity; no dropout is applied
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16
    untie_head: bool = False

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head


_LAYER_KEYS = ("ln1_g", "ln2_g", "attn_qkv", "attn_out", "mlp_in", "mlp_out")


def param_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Name -> shape of every parameter, in init_params' order."""
    d, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    shapes = {
        "tok_emb": (V, d),
        "ln1_g": (L, d),
        "ln2_g": (L, d),
        "attn_qkv": (L, d, 3 * d),
        "attn_out": (L, d, d),
        "mlp_in": (L, d, 4 * d),
        "mlp_out": (L, 4 * d, d),
        "lnf_g": (d,),
    }
    if cfg.untie_head:
        shapes["head"] = (d, V)
    return shapes


def init_params(generator: torch.Generator, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """fp32 parameters on the generator's device, GPT-2 style: N(0, 0.02)
    embedding, N(0, 1/fan_in) linears, residual outputs scaled by
    1/sqrt(2 n_layer), unit gains. Same distributions as the JAX package;
    the numbers differ (another generator), so tests pass weights across
    with models/convert.py instead."""
    shapes = param_shapes(cfg)
    dev = generator.device

    def normal(name, std):
        return torch.randn(shapes[name], generator=generator, device=dev) * std

    d, L = cfg.n_embd, cfg.n_layer
    scale_res = 1.0 / math.sqrt(2 * L)
    params = {
        "tok_emb": normal("tok_emb", 0.02),
        "ln1_g": torch.ones(shapes["ln1_g"], device=dev),
        "ln2_g": torch.ones(shapes["ln2_g"], device=dev),
        "attn_qkv": normal("attn_qkv", 1.0 / math.sqrt(d)),
        "attn_out": normal("attn_out", 1.0 / math.sqrt(d)) * scale_res,
        "mlp_in": normal("mlp_in", 1.0 / math.sqrt(d)),
        "mlp_out": normal("mlp_out", 1.0 / math.sqrt(4 * d)) * scale_res,
        "lnf_g": torch.ones(shapes["lnf_g"], device=dev),
    }
    if cfg.untie_head:
        params["head"] = normal("head", 1.0 / math.sqrt(d))
    return params


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * gain).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of x [B, T, H, Dh]: the first and
    second halves rotate as pairs."""
    _, T, _, Dh = x.shape
    half = Dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v):
    """Dense causal attention, q/k/v [B, T, H, Dh]: scores in q's dtype,
    softmax in fp32 with a -1e30 mask, probabilities cast back."""
    T, Dh = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(Dh))
    i = torch.arange(T, device=q.device)
    logits = logits.float().masked_fill(i[None, :] > i[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block(x, params, layer: int, cfg: GPTConfig, attn_fn=None):
    B, T, d = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    h = _rmsnorm(x, params["ln1_g"][layer])
    qkv = h @ params["attn_qkv"][layer].to(h.dtype)
    q, k, v = qkv.split(d, dim=-1)
    q = _rope(q.reshape(B, T, H, Dh), cfg.rope_theta)
    k = _rope(k.reshape(B, T, H, Dh), cfg.rope_theta)
    v = v.reshape(B, T, H, Dh)
    att = (attn_fn or _attention)(q, k, v).reshape(B, T, d)
    x = x + att @ params["attn_out"][layer].to(att.dtype)
    h = _rmsnorm(x, params["ln2_g"][layer])
    h = F.gelu(h @ params["mlp_in"][layer].to(h.dtype), approximate="tanh")
    return x + h @ params["mlp_out"][layer].to(h.dtype)


def hidden(params, tokens, cfg: GPTConfig, attn_fn=None, remat=False):
    """tokens int [B, T] -> final-norm hidden states [B, T, d]."""
    x = params["tok_emb"][tokens.long()].to(cfg.compute_dtype)
    x = run_blocks(lambda h, layer: _block(h, params, layer, cfg, attn_fn),
                   x, cfg.n_layer, remat)
    return _rmsnorm(x, params["lnf_g"])


def _head_mat(params, cfg: GPTConfig) -> torch.Tensor:
    """[d, vocab] unembedding; weight-tied to tok_emb by default."""
    return params["head"] if cfg.untie_head else params["tok_emb"].t()


def forward(params, tokens, cfg: GPTConfig, attn_fn=None, remat=False):
    """tokens int [B, T] -> logits fp32 [B, T, vocab]. attn_fn overrides the
    attention op (e.g. ops.flash_attention); remat checkpoints each block."""
    x = hidden(params, tokens, cfg, attn_fn, remat)
    return matmul_f32(x, _head_mat(params, cfg))


def loss_fn(params, tokens, targets, cfg: GPTConfig, attn_fn=None,
            remat=False, loss_chunk: "int | None" = None) -> torch.Tensor:
    """Mean next-token cross-entropy. loss_chunk computes the head and the
    loss in checkpointed sequence chunks (models/_common.py) and must
    divide T."""
    T = targets.shape[1]
    if loss_chunk and T % loss_chunk:
        raise ValueError(f"loss_chunk {loss_chunk} must divide T={T}")
    if loss_chunk and T > loss_chunk:
        x = hidden(params, tokens, cfg, attn_fn, remat)
        return chunked_ce_loss(x, _head_mat(params, cfg), targets, loss_chunk)
    return gather_ce_loss(forward(params, tokens, cfg, attn_fn, remat), targets)


def tiny_config(**overrides) -> GPTConfig:
    """Small config for tests."""
    base = dict(vocab_size=512, n_layer=2, n_head=4, n_embd=128, block_size=128)
    base.update(overrides)
    return GPTConfig(**base)


# The presets of the JAX package. vocab 50304 is GPT-2's 50257 padded to a
# multiple of 64.
PRESETS = {
    "nano": dict(vocab_size=256, n_layer=2, n_head=4, n_embd=64, block_size=64),
    "tiny": dict(vocab_size=512, n_layer=2, n_head=4, n_embd=128, block_size=128),
    "gpt2": dict(vocab_size=50304, n_layer=12, n_head=12, n_embd=768,
                 block_size=1024),
    "gpt2-medium": dict(vocab_size=50304, n_layer=24, n_head=16, n_embd=1024,
                        block_size=1024),
    "gpt2-large": dict(vocab_size=50304, n_layer=36, n_head=20, n_embd=1280,
                       block_size=1024),
    "gpt2-xl": dict(vocab_size=50304, n_layer=48, n_head=25, n_embd=1600,
                    block_size=1024),
}


def named_config(name: str, **overrides) -> GPTConfig:
    """Preset config by name (see PRESETS); overrides win."""
    base = dict(PRESETS[name])
    base.update(overrides)
    return GPTConfig(**base)
