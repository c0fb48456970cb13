"""Llama-family decoder in PyTorch: grouped-query attention, SwiGLU MLPs and
an untied head, with the JAX package's parameters (pccl_tpu/models/llama.py):
a dict of tensors with the same names and shapes, per-layer tensors stacked
over a leading [n_layer] dim, `x @ W` weights laid out [in, out].

K/V stay Hkv-shaped from the kv projection into `attn_fn`: the flash kernels
take grouped K/V directly (kv head h // G serves q head h), so no repeated
K/V tensor is ever made on the card. Only the dense attention
(models/_common.py:dense_attention) repeats them, inside itself.

Numerics follow the JAX package: parameters in fp32, compute in
`compute_dtype` (bf16 by default); RMSNorm and rotary embeddings as in
models/gpt.py (the same functions, models/_common.py); SiLU gating; the
untied head with compute-dtype operands and an fp32 result.

Tensor parallelism (`tp=`) as in models/gpt.py: a rank holds whole q heads
[r·H/tp, ...) and the kv heads they read (models/_common.py:kv_ranges:
[r·Hkv/tp, ...) where tp divides n_kv_head; one kv head, shared with the
other ranks whose q heads read it, where n_kv_head divides tp), columns
of mlp_gate and mlp_up, rows of attn_out and mlp_down, and vocab blocks
of tok_emb and the head. A shared kv head's weight gradient is summed
over the ranks that hold it, in fp32 (_common.shared_kv_sum).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ._common import (check_tp, column, column_input, dense_attention, embed,
                      head_logits, head_loss, kv_grad_sum, kv_ranges,
                      layer_views, rmsnorm, rope, row_parallel, run_blocks,
                      tp_group)

ONE_RANK = False


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


LAYER_KEYS = ("ln1_g", "ln2_g", "attn_q", "attn_kv", "attn_out", "mlp_gate",
               "mlp_up", "mlp_down")


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


def attention(h, layer: Dict[str, torch.Tensor], cfg, attn_fn=None, pos_offset=0,
              tp=None, qk_norm=None):
    """The attention of a block on this rank's heads, from the normed h:
    the q and kv products, rotary embeddings, attn_fn, the out product. H
    and Hkv follow from the local q and kv widths. qk_norm (q gain, k gain,
    eps) RMS-normalises each head of q and k over Dh before the rotary
    embeddings (models/lfm2.py)."""
    B, T, _ = h.shape
    Dh = cfg.head_dim
    h_in = column_input(h, tp)
    q = column(h_in, layer["attn_q"], h.dtype, tp)
    H = q.shape[-1] // Dh
    q = q.reshape(B, T, H, Dh)
    k, v = column(h_in, layer["attn_kv"], h.dtype, tp,
                  w_sum=kv_grad_sum(cfg, tp)).chunk(2, dim=-1)
    Hkv = k.shape[-1] // Dh
    k = k.reshape(B, T, Hkv, Dh)
    if qk_norm is not None:
        q_gain, k_gain, eps = qk_norm
        q, k = rmsnorm(q, q_gain, eps), rmsnorm(k, k_gain, eps)
    q = rope(q, cfg.rope_theta, pos_offset)
    k = rope(k, cfg.rope_theta, pos_offset)
    v = v.reshape(B, T, Hkv, Dh)
    att = (attn_fn or dense_attention)(q, k, v).reshape(B, T, H * Dh)
    return row_parallel(att, layer["attn_out"], tp)


def swiglu(h, gate, up, down, tp=None):
    """(silu(h W_gate) * h W_up) W_down on this rank's columns."""
    h_in = column_input(h, tp)
    gated = F.silu(column(h_in, gate, h.dtype, tp)) * column(h_in, up, h.dtype, tp)
    return row_parallel(gated, down, tp)


def block(x, layer: Dict[str, torch.Tensor], cfg: LlamaConfig, attn_fn=None,
          pos_offset=0, tp=None):
    """One block on this rank's heads (all of them without a tp group),
    with `layer` its slices of the stacked leaves (layer_views)."""
    x = x + attention(rmsnorm(x, layer["ln1_g"]), layer, cfg, attn_fn, pos_offset, tp)
    return x + swiglu(rmsnorm(x, layer["ln2_g"]), layer["mlp_gate"],
                      layer["mlp_up"], layer["mlp_down"], tp)


def hidden(params, tokens, cfg: LlamaConfig, attn_fn=None, remat=False,
           pos_offset: int = 0, tp=None):
    """tokens int [B, T] at global positions pos_offset.. -> final-norm
    hidden states [B, T, d] (the same on every rank of a tp group)."""
    tp = tp_group(tp)
    x = embed(params["tok_emb"], tokens, cfg.compute_dtype, tp)
    layers = layer_views(params, LAYER_KEYS)
    x = run_blocks(lambda h, i: block(h, layers[i], cfg, attn_fn, pos_offset, tp),
                   x, cfg.n_layer, remat)
    return rmsnorm(x, params["lnf_g"])


def forward(params, tokens, cfg: LlamaConfig, attn_fn=None, remat=False,
            pos_offset: int = 0, tp=None):
    """tokens int [B, T] -> logits fp32 [B, T, vocab]: the untied head with
    compute-dtype operands and fp32 accumulation. pos_offset is the global
    position of the first token. With a tp group: this rank's vocab block,
    [B, T, vocab/tp]."""
    tp = tp_group(tp)
    return head_logits(hidden(params, tokens, cfg, attn_fn, remat, pos_offset, tp),
                       params["head"], tp)


def loss_fn(params, tokens, targets, cfg: LlamaConfig, attn_fn=None,
            remat=False, loss_chunk: "int | None" = None,
            pos_offset: int = 0, tp=None, profiler=None) -> torch.Tensor:
    """Mean next-token cross-entropy (models/_common.py:head_loss; with a
    tp group vocab-parallel and the same on every rank); pos_offset as in
    forward. profiler is ignored: this family records no section."""
    tp = tp_group(tp)
    return head_loss(hidden(params, tokens, cfg, attn_fn, remat, pos_offset, tp),
                     params["head"], targets, loss_chunk, tp)


# ------------------------------------------------------------ tensor parallel

# The JAX package's tp rules (pccl_tpu/parallel/mesh.py:LLAMA_PARAM_SPECS):
# the mesh axis of each dim of each parameter, or None
_PARAM_SPECS: Dict[str, tuple] = {
    "tok_emb": ("tp", None),
    "ln1_g": (None, None),
    "ln2_g": (None, None),
    # column-parallel in-projections (q, grouped kv, both MLP branches)
    "attn_q": (None, None, "tp"),
    "attn_kv": (None, None, "tp"),
    "mlp_gate": (None, None, "tp"),
    "mlp_up": (None, None, "tp"),
    # row-parallel out-projections
    "attn_out": (None, "tp", None),
    "mlp_down": (None, "tp", None),
    "lnf_g": (None,),
    "head": (None, "tp"),  # untied unembedding: vocab-parallel
}


def tp_specs(cfg: LlamaConfig, tp: int) -> Dict[str, tuple]:
    """The spec of each parameter; raises where tp does not split whole
    heads, the FFN width or the vocab, or where neither of tp and
    n_kv_head divides the other (_common.kv_ranges)."""
    check_tp(tp, {"n_head": cfg.n_head, "vocab_size": cfg.vocab_size,
                  "ffn width": cfg.ffn_dim})
    kv_ranges(cfg.n_head, cfg.n_kv_head, tp)
    return dict(_PARAM_SPECS)


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
