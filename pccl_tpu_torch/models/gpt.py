"""Decoder-only transformer (GPT family) in PyTorch, with the JAX package's
parameters: a dict of tensors with the same names and shapes, per-layer
tensors stacked over a leading [n_layer] dim, and `x @ W` weights laid out
[in, out]. Weights cross between the two packages with no transpose
(models/convert.py).

Numerics follow pccl_tpu/models/gpt.py: parameters in fp32, compute in
`compute_dtype` (bf16 by default); RMSNorm in fp32 with eps 1e-6 inside the
rsqrt and rotary embeddings on two halves of the head dim (not
interleaved), with cos and sin cast to the compute dtype
(models/_common.py: rmsnorm, rope); GELU with the tanh approximation
(jax.nn.gelu's default); the tied head with compute-dtype operands and an
fp32 result.

Tensor parallelism (`tp=`, a process group, or None): each rank holds its
block of the parameters (models/convert.py: whole heads of q, k and v,
columns of mlp_in, rows of attn_out and mlp_out, vocab rows of tok_emb),
and the block runs Megatron's sequence: copy_to, the local in-projections,
RoPE, attention on the rank's heads, the local out-projection with an fp32
result, reduce_from in fp32, one cast. In the backward the in-projections'
partial input gradients are fp32 too, summed over the ranks by copy_to
in fp32 and cast once (models/_common.py:_ColumnIn). The embedding and the loss are
vocab-parallel (models/_common.py). Without a group, or with a group of
1, every result is bitwise what it is without the argument.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ._common import (check_tp, column, column_input, dense_attention, embed,
                      head_logits, head_loss, layer_views, rmsnorm, rope,
                      row_parallel, run_blocks, tp_group)

ONE_RANK = False


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


LAYER_KEYS = ("ln1_g", "ln2_g", "attn_qkv", "attn_out", "mlp_in", "mlp_out")


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


def block(x, layer: Dict[str, torch.Tensor], cfg: GPTConfig, attn_fn=None,
          pos_offset=0, tp=None):
    """One block on this rank's heads, with `layer` its slices of the
    stacked leaves (layer_views): H = the local qkv width / 3 Dh (all heads
    without a tp group)."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    h = rmsnorm(x, layer["ln1_g"])
    qkv = column(column_input(h, tp), layer["attn_qkv"], h.dtype, tp)
    q, k, v = qkv.chunk(3, dim=-1)
    H = q.shape[-1] // Dh
    q = rope(q.reshape(B, T, H, Dh), cfg.rope_theta, pos_offset)
    k = rope(k.reshape(B, T, H, Dh), cfg.rope_theta, pos_offset)
    v = v.reshape(B, T, H, Dh)
    att = (attn_fn or dense_attention)(q, k, v).reshape(B, T, H * Dh)
    x = x + row_parallel(att, layer["attn_out"], tp)
    h = rmsnorm(x, layer["ln2_g"])
    h = F.gelu(column(column_input(h, tp), layer["mlp_in"], h.dtype, tp),
               approximate="tanh")
    return x + row_parallel(h, layer["mlp_out"], tp)


def hidden(params, tokens, cfg: GPTConfig, attn_fn=None, remat=False,
           pos_offset: int = 0, tp=None):
    """tokens int [B, T] at global positions pos_offset.. -> final-norm
    hidden states [B, T, d] (the same on every rank of a tp group)."""
    tp = tp_group(tp)
    x = embed(params["tok_emb"], tokens, cfg.compute_dtype, tp)
    layers = layer_views(params, LAYER_KEYS)
    x = run_blocks(lambda h, i: block(h, layers[i], cfg, attn_fn, pos_offset, tp),
                   x, cfg.n_layer, remat)
    return rmsnorm(x, params["lnf_g"])


def _head_mat(params, cfg: GPTConfig) -> torch.Tensor:
    """[d, vocab] unembedding; weight-tied to tok_emb by default."""
    return params["head"] if cfg.untie_head else params["tok_emb"].t()


def forward(params, tokens, cfg: GPTConfig, attn_fn=None, remat=False,
            pos_offset: int = 0, tp=None):
    """tokens int [B, T] -> logits fp32 [B, T, vocab]. attn_fn overrides the
    attention op (e.g. ops.flash_attention); remat checkpoints each block;
    pos_offset is the global position of the first token. With a tp group:
    this rank's vocab block of the logits, [B, T, vocab/tp]."""
    tp = tp_group(tp)
    return head_logits(hidden(params, tokens, cfg, attn_fn, remat, pos_offset, tp),
                       _head_mat(params, cfg), tp)


def loss_fn(params, tokens, targets, cfg: GPTConfig, attn_fn=None,
            remat=False, loss_chunk: "int | None" = None,
            pos_offset: int = 0, tp=None, profiler=None) -> torch.Tensor:
    """Mean next-token cross-entropy (models/_common.py:head_loss; with a
    tp group vocab-parallel and the same on every rank); pos_offset as in
    forward. profiler is ignored: this family records no section."""
    tp = tp_group(tp)
    return head_loss(hidden(params, tokens, cfg, attn_fn, remat, pos_offset, tp),
                     _head_mat(params, cfg), targets, loss_chunk, tp)


# ------------------------------------------------------------ tensor parallel

# The JAX package's tp rules (pccl_tpu/parallel/mesh.py:GPT_PARAM_SPECS):
# the mesh axis of each dim of each parameter, or None
_PARAM_SPECS: Dict[str, tuple] = {
    # vocab-parallel embedding (Megatron-style); the tied head is its
    # transpose
    "tok_emb": ("tp", None),
    "ln1_g": (None, None),
    "ln2_g": (None, None),
    # column-parallel in-projections: output features over tp
    "attn_qkv": (None, None, "tp"),
    "mlp_in": (None, None, "tp"),
    # row-parallel out-projections: input features over tp
    "attn_out": (None, "tp", None),
    "mlp_out": (None, "tp", None),
    "lnf_g": (None,),
}


def tp_specs(cfg: GPTConfig, tp: int) -> Dict[str, tuple]:
    """The spec of each parameter, the untied head's vocab-parallel like
    Llama's; raises where tp does not split whole heads, the FFN width or
    the vocab."""
    check_tp(tp, {"n_head": cfg.n_head, "vocab_size": cfg.vocab_size,
                  "ffn width": 4 * cfg.n_embd})
    if cfg.untie_head:
        return {**_PARAM_SPECS, "head": (None, "tp")}
    return dict(_PARAM_SPECS)


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
