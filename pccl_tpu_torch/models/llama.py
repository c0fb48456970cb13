"""Llama-family decoder in PyTorch: grouped-query attention, SwiGLU MLPs and
an untied head, with the JAX package's parameters (pccl_tpu/models/llama.py):
a dict of tensors with the same names and shapes, per-layer tensors stacked
over a leading [n_layer] dim, `x @ W` weights laid out [in, out].

K/V stay Hkv-shaped from the kv projection into `attn_fn`: the flash kernels
take grouped K/V directly (kv head h // G serves q head h), so no repeated
K/V tensor is ever made on the card. Only the dense `_attention` repeats
them, inside itself.

Numerics follow the JAX package: parameters in fp32, compute in
`compute_dtype` (bf16 by default); RMSNorm and rotary embeddings as in
models/gpt.py (the same functions); SiLU gating; the untied head with
compute-dtype operands and an fp32 result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ._common import chunked_ce_loss, gather_ce_loss, matmul_f32, run_blocks
from .gpt import _rmsnorm, _rope


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 8
    n_head: int = 8
    n_kv_head: int = 4          # grouped-query: kv heads < query heads
    n_embd: int = 512
    ffn_dim: int = 1408         # SwiGLU hidden (about 8/3 d, rounded to 64)
    block_size: int = 1024
    rope_theta: float = 500000.0
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    def __post_init__(self):
        if self.n_head % self.n_kv_head:
            raise ValueError(f"n_kv_head {self.n_kv_head} must divide n_head "
                             f"{self.n_head}")


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Name -> shape of every parameter, in init_params' order."""
    d, L, f, V = cfg.n_embd, cfg.n_layer, cfg.ffn_dim, cfg.vocab_size
    kv = cfg.n_kv_head * cfg.head_dim
    return {
        "tok_emb": (V, d),
        "ln1_g": (L, d),
        "ln2_g": (L, d),
        "attn_q": (L, d, d),
        "attn_kv": (L, d, 2 * kv),
        "attn_out": (L, d, d),
        "mlp_gate": (L, d, f),
        "mlp_up": (L, d, f),
        "mlp_down": (L, f, d),
        "lnf_g": (d,),
        "head": (d, V),
    }


def init_params(generator: torch.Generator, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """fp32 parameters on the generator's device: N(0, 0.02) embedding,
    N(0, 1/fan_in) linears, the residual outputs (attn_out, mlp_down) scaled
    by 1/sqrt(2 n_layer), unit gains. Same distributions as the JAX package;
    the numbers differ (another generator), so tests pass weights across
    with models/convert.py instead."""
    shapes = param_shapes(cfg)
    dev = generator.device

    def linear(name, fan_in):
        return torch.randn(shapes[name], generator=generator, device=dev) \
            * (1.0 / math.sqrt(fan_in))

    d = cfg.n_embd
    scale_res = 1.0 / math.sqrt(2 * cfg.n_layer)
    return {
        "tok_emb": torch.randn(shapes["tok_emb"], generator=generator, device=dev) * 0.02,
        "ln1_g": torch.ones(shapes["ln1_g"], device=dev),
        "ln2_g": torch.ones(shapes["ln2_g"], device=dev),
        "attn_q": linear("attn_q", d),
        "attn_kv": linear("attn_kv", d),
        "attn_out": linear("attn_out", d) * scale_res,
        "mlp_gate": linear("mlp_gate", d),
        "mlp_up": linear("mlp_up", d),
        "mlp_down": linear("mlp_down", cfg.ffn_dim) * scale_res,
        "lnf_g": torch.ones(shapes["lnf_g"], device=dev),
        "head": linear("head", d),
    }


def _attention(q, k, v):
    """Dense causal attention, q [B, T, H, Dh], k/v [B, T, Hkv, Dh]: GQA
    K/V repeated here (the kernels never do); scores in q's dtype, softmax
    in fp32 with a -1e30 mask, probabilities cast back."""
    T, H, Dh = q.shape[1], q.shape[2], q.shape[3]
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(Dh))
    i = torch.arange(T, device=q.device)
    logits = logits.float().masked_fill(i[None, :] > i[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block(x, params, layer: int, cfg: LlamaConfig, attn_fn=None):
    B, T, d = x.shape
    H, Hkv, Dh = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    h = _rmsnorm(x, params["ln1_g"][layer])
    q = (h @ params["attn_q"][layer].to(h.dtype)).reshape(B, T, H, Dh)
    k, v = (h @ params["attn_kv"][layer].to(h.dtype)).chunk(2, dim=-1)
    q = _rope(q, cfg.rope_theta)
    k = _rope(k.reshape(B, T, Hkv, Dh), cfg.rope_theta)
    v = v.reshape(B, T, Hkv, Dh)
    att = (attn_fn or _attention)(q, k, v).reshape(B, T, d)
    x = x + att @ params["attn_out"][layer].to(att.dtype)
    h = _rmsnorm(x, params["ln2_g"][layer])
    gated = F.silu(h @ params["mlp_gate"][layer].to(h.dtype)) \
        * (h @ params["mlp_up"][layer].to(h.dtype))
    return x + gated @ params["mlp_down"][layer].to(h.dtype)


def hidden(params, tokens, cfg: LlamaConfig, attn_fn=None, remat=False):
    """tokens int [B, T] -> final-norm hidden states [B, T, d]."""
    x = params["tok_emb"][tokens.long()].to(cfg.compute_dtype)
    x = run_blocks(lambda h, layer: _block(h, params, layer, cfg, attn_fn),
                   x, cfg.n_layer, remat)
    return _rmsnorm(x, params["lnf_g"])


def forward(params, tokens, cfg: LlamaConfig, attn_fn=None, remat=False):
    """tokens int [B, T] -> logits fp32 [B, T, vocab]: the untied head with
    compute-dtype operands and fp32 accumulation."""
    return matmul_f32(hidden(params, tokens, cfg, attn_fn, remat), params["head"])


def loss_fn(params, tokens, targets, cfg: LlamaConfig, attn_fn=None,
            remat=False, loss_chunk: "int | None" = None) -> torch.Tensor:
    """Mean next-token cross-entropy. loss_chunk computes the head and the
    loss in checkpointed sequence chunks (models/_common.py) and must
    divide T."""
    T = targets.shape[1]
    if loss_chunk and T % loss_chunk:
        raise ValueError(f"loss_chunk {loss_chunk} must divide T={T}")
    if loss_chunk and T > loss_chunk:
        x = hidden(params, tokens, cfg, attn_fn, remat)
        return chunked_ce_loss(x, params["head"], targets, loss_chunk)
    return gather_ce_loss(forward(params, tokens, cfg, attn_fn, remat), targets)


def tiny_config(**overrides) -> LlamaConfig:
    """Small config for tests."""
    base = dict(PRESETS["tiny"])
    base.update(overrides)
    return LlamaConfig(**base)


# The presets of the JAX package. 700m (24 layers, d 1536, 12 q heads over
# 4 kv heads, head dim 128, T 2048) is its single-chip benchmark shape.
PRESETS = {
    "nano": dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, n_embd=64,
                 ffn_dim=192, block_size=64),
    "tiny": dict(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2, n_embd=128,
                 ffn_dim=320, block_size=128),
    "700m": dict(vocab_size=32000, n_layer=24, n_head=12, n_kv_head=4,
                 n_embd=1536, ffn_dim=4096, block_size=2048),
    "1b": dict(vocab_size=32000, n_layer=16, n_head=32, n_kv_head=8,
               n_embd=2048, ffn_dim=5632, block_size=2048),
    "7b": dict(vocab_size=32000, n_layer=32, n_head=32, n_kv_head=32,
               n_embd=4096, ffn_dim=11008, block_size=4096),
    "8b": dict(vocab_size=128256, n_layer=32, n_head=32, n_kv_head=8,
               n_embd=4096, ffn_dim=14336, block_size=8192,
               rope_theta=500000.0),
}


def named_config(name: str, **overrides) -> LlamaConfig:
    """Preset config by name (see PRESETS); overrides win."""
    base = dict(PRESETS[name])
    base.update(overrides)
    return LlamaConfig(**base)
