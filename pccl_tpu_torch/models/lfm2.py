"""LFM2 with sparse experts (LiquidAI's LFM2-8B-A1B, Hugging Face
`model_type` lfm2_moe) in PyTorch, in the port's parameter layout: a dict of
tensors, `x @ W` weights laid out [in, out], per-layer tensors stacked over
a leading dim by layer kind. The JAX package has no such model.

Layer l is pre-norm and residual, x += Mixer(RMSNorm(x)); x +=
FFN(RMSNorm(x)), its mixer chosen by `layer_types[l]`:

- "conv", the gated short convolution: [B | C | X] = h W_in ([d, 3d], the
  chunks in that order), u = B * X, v_t = sum_j w[:, j] * u_{t-K+1+j} for
  j < K (causal, depthwise, no bias, u before the sequence is zero), y =
  (C * v) W_out. Plain torch: K shifted products and their sum.
- "full_attention": models/llama.py's grouped-query attention through the
  `attn_fn` it is given (K1-K3 on the card), with each head's q and k
  RMS-normalised over Dh by its own gain before the rotary embeddings.

The FFN of the first `num_dense_layers` layers is llama.py's SwiGLU; every
later one is ops/moe.py's dropless top-k expert layer: sigmoid router
scores, the experts chosen by score + expert bias, weighted by the chosen
scores renormalised (norm_topk_prob) and scaled by routed_scale. A final
RMSNorm, and the head tied to the embedding. Every RMSNorm takes
`norm_eps`.

Leaves (param_shapes): the norms per layer (op_norm, ffn_norm [L, d]),
each kind's weights stacked over the layers of that kind (conv_* [Lc,
...], attn_*, q_norm, k_norm [La, ...], mlp_* [Ld, ...], moe_* [Lm, ...]);
moe_gate_up [Lm, E, d, 2f] holds each expert's gate and up columns side
by side, so both run as one grouped product. A kind with no layer has no
leaves.

The expert bias is a buffer (init_buffers: "moe_bias" [Lm, E], zeros), not
a parameter: AdamW does not train it, and it is not in a DiLoCo outer
vector. parallel/train.py keeps it in TrainState.buffers and passes it to
loss_fn.

Numerics as in models/llama.py: fp32 parameters, products in
`compute_dtype` with fp32 accumulation, RMSNorm in fp32; the router's
logits are fp32 (ops/moe.py). Runs on one rank: tensor, pipeline and
sequence parallelism raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops import moe
from ._common import embed, head_logits, head_loss, layer_views, rmsnorm, run_blocks
from .llama import attention, swiglu

KINDS = ("conv", "full_attention")
# parallel/train.py refuses tensor and sequence parallelism for this family
ONE_RANK = True


@dataclasses.dataclass(frozen=True)
class Lfm2MoeConfig:
    vocab_size: int = 65536
    layer_types: Tuple[str, ...] = ("conv", "conv", "full_attention", "conv",
                                    "conv", "conv")
    n_head: int = 32
    n_kv_head: int = 8
    n_embd: int = 2048
    ffn_dim: int = 7168           # the dense layers' SwiGLU width
    num_dense_layers: int = 2
    n_experts: int = 32
    expert_dim: int = 1792        # each expert's SwiGLU width
    top_k: int = 4
    norm_topk_prob: bool = True
    routed_scale: float = 1.0
    conv_width: int = 3           # conv_L_cache
    block_size: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    compute_dtype: Any = torch.bfloat16

    @property
    def n_layer(self) -> int:
        return len(self.layer_types)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def layers_of(self, kind: str) -> list:
        return [l for l, k in enumerate(self.layer_types) if k == kind]

    @property
    def n_moe_layers(self) -> int:
        return self.n_layer - self.num_dense_layers

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        bad = sorted(set(self.layer_types) - set(KINDS))
        if bad:
            raise ValueError(f"unknown layer types {bad}; have {KINDS}")
        if self.n_embd % self.n_head or self.n_head % self.n_kv_head:
            raise ValueError(f"n_head {self.n_head} must divide n_embd {self.n_embd} "
                             f"and n_kv_head {self.n_kv_head} n_head")
        if not 0 <= self.num_dense_layers <= self.n_layer:
            raise ValueError(f"num_dense_layers {self.num_dense_layers} outside "
                             f"[0, {self.n_layer}]")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} outside [1, {self.n_experts}]")


# the stacked leaves of each kind; op_norm and ffn_norm are per layer
_NORM_KEYS = ("op_norm", "ffn_norm")
_CONV_KEYS = ("conv_in", "conv_w", "conv_out")
_ATTN_KEYS = ("attn_q", "attn_kv", "attn_out", "q_norm", "k_norm")
_MLP_KEYS = ("mlp_gate", "mlp_up", "mlp_down")
_MOE_KEYS = ("moe_router", "moe_gate_up", "moe_down")
# the residual outputs, scaled by 1/sqrt(2 n_layer) in init_params
_RESIDUAL = ("conv_out", "attn_out", "mlp_down", "moe_down")


def param_shapes(cfg: Lfm2MoeConfig) -> Dict[str, tuple]:
    """Name -> shape of every parameter, in init_params' order."""
    d, V, L = cfg.n_embd, cfg.vocab_size, cfg.n_layer
    Lc, La = len(cfg.layers_of("conv")), len(cfg.layers_of("full_attention"))
    Ld, Lm = cfg.num_dense_layers, cfg.n_moe_layers
    Dh, E, f = cfg.head_dim, cfg.n_experts, cfg.expert_dim
    shapes = {
        "tok_emb": (V, d),
        "op_norm": (L, d),
        "ffn_norm": (L, d),
        "conv_in": (Lc, d, 3 * d),
        "conv_w": (Lc, d, cfg.conv_width),
        "conv_out": (Lc, d, d),
        "attn_q": (La, d, cfg.n_head * Dh),
        "attn_kv": (La, d, 2 * cfg.n_kv_head * Dh),
        "attn_out": (La, cfg.n_head * Dh, d),
        "q_norm": (La, Dh),
        "k_norm": (La, Dh),
        "mlp_gate": (Ld, d, cfg.ffn_dim),
        "mlp_up": (Ld, d, cfg.ffn_dim),
        "mlp_down": (Ld, cfg.ffn_dim, d),
        "moe_router": (Lm, d, E),
        "moe_gate_up": (Lm, E, d, 2 * f),
        "moe_down": (Lm, E, f, d),
        "lnf_g": (d,),
    }
    return {k: s for k, s in shapes.items() if s[0]}


def init_params(generator: torch.Generator, cfg: Lfm2MoeConfig) -> Dict[str, torch.Tensor]:
    """fp32 parameters on the generator's device, in param_shapes' order:
    N(0, 0.02) embedding, N(0, 1/fan_in) products (the conv taps' fan-in
    is conv_width), the residual outputs (conv_out, attn_out, mlp_down,
    moe_down) scaled by 1/sqrt(2 n_layer), unit gains."""
    dev = generator.device
    res = 1.0 / math.sqrt(2 * cfg.n_layer)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm") or name == "lnf_g":
            out[name] = torch.ones(shape, device=dev)
            continue
        std = 0.02 if name == "tok_emb" else shape[-2] ** -0.5
        if name == "conv_w":
            std = cfg.conv_width ** -0.5
        t = torch.randn(shape, generator=generator, device=dev)
        out[name] = t * (std * (res if name in _RESIDUAL else 1.0))
    return out


def init_buffers(cfg: Lfm2MoeConfig, device) -> Dict[str, torch.Tensor]:
    """The expert bias of each expert layer, zeros: it enters the choice
    of experts only, and no gradient trains it."""
    return {"moe_bias": torch.zeros(cfg.n_moe_layers, cfg.n_experts, device=device)}


def short_conv(h, layer: Dict[str, torch.Tensor]):
    """The gated short convolution of h [B, T, d] (see the module's
    docstring), in h's dtype."""
    T = h.shape[1]
    b, c, x = (h @ layer["conv_in"].to(h.dtype)).chunk(3, dim=-1)
    u = b * x
    w = layer["conv_w"].to(h.dtype)              # [d, K]
    K = w.shape[-1]
    u = F.pad(u, (0, 0, K - 1, 0))               # K - 1 zero steps before t = 0
    v = u[:, K - 1:] * w[:, K - 1]
    for j in range(K - 1):
        v = v + u[:, j:j + T] * w[:, j]
    return (c * v) @ layer["conv_out"].to(h.dtype)


def hidden(params, tokens, cfg: Lfm2MoeConfig, attn_fn=None, remat=False,
           moe_bias=None, profiler=None):
    """tokens int [B, T] -> final-norm hidden states [B, T, d]."""
    x = embed(params["tok_emb"], tokens, cfg.compute_dtype)
    if moe_bias is None:
        moe_bias = torch.zeros(cfg.n_moe_layers, cfg.n_experts, device=x.device)
    norms = layer_views(params, _NORM_KEYS)
    mixers = {}
    for kind, keys in (("conv", _CONV_KEYS), ("full_attention", _ATTN_KEYS)):
        if cfg.layers_of(kind):
            mixers.update(zip(cfg.layers_of(kind), layer_views(params, keys)))
    ffns = layer_views(params, _MLP_KEYS) if cfg.num_dense_layers else []
    ffns += layer_views(params, _MOE_KEYS) if cfg.n_moe_layers else []
    eps = cfg.norm_eps

    def block(x, l):
        h = rmsnorm(x, norms[l]["op_norm"], eps)
        mix = mixers[l]
        if cfg.layer_types[l] == "conv":
            x = x + short_conv(h, mix)
        else:
            x = x + attention(h, mix, cfg, attn_fn,
                              qk_norm=(mix["q_norm"], mix["k_norm"], eps))
        h = rmsnorm(x, norms[l]["ffn_norm"], eps)
        ffn = ffns[l]
        if l < cfg.num_dense_layers:
            return x + swiglu(h, ffn["mlp_gate"], ffn["mlp_up"], ffn["mlp_down"])
        m = l - cfg.num_dense_layers
        return x + moe.moe_topk(h, ffn["moe_router"], ffn["moe_gate_up"], ffn["moe_down"],
                                moe_bias[m], k=cfg.top_k, norm_topk_prob=cfg.norm_topk_prob,
                                scale=cfg.routed_scale, layer=l, profiler=profiler)

    x = run_blocks(block, x, cfg.n_layer, remat)
    return rmsnorm(x, params["lnf_g"], eps)


def forward(params, tokens, cfg: Lfm2MoeConfig, attn_fn=None, remat=False,
            moe_bias=None, profiler=None):
    """tokens int [B, T] -> logits fp32 [B, T, vocab] through the tied head,
    with compute-dtype operands and fp32 accumulation."""
    return head_logits(hidden(params, tokens, cfg, attn_fn, remat, moe_bias, profiler),
                       params["tok_emb"].t())


def loss_fn(params, tokens, targets, cfg: Lfm2MoeConfig, attn_fn=None,
            remat=False, loss_chunk: "int | None" = None, pos_offset: int = 0,
            tp=None, moe_bias=None, profiler=None) -> torch.Tensor:
    """Mean next-token cross-entropy (models/_common.py:head_loss).
    moe_bias [Lm, E] (init_buffers; None: zeros) shifts the choice of
    experts; profiler (utils/profiler.Profiler) takes ops/moe.py's
    sections. A tp group or a sequence block (pos_offset) raises."""
    if tp is not None or pos_offset:
        raise ValueError("LFM2 runs on one rank: no tensor, pipeline or sequence "
                         "parallelism")
    return head_loss(hidden(params, tokens, cfg, attn_fn, remat, moe_bias, profiler),
                     params["tok_emb"].t(), targets, loss_chunk)


def tiny_config(**overrides) -> Lfm2MoeConfig:
    """Small config for tests: every kind of layer, 8 experts of which 4 a
    token."""
    base = dict(vocab_size=512, layer_types=("conv", "conv", "full_attention", "conv",
                                             "conv", "conv"),
                n_head=4, n_kv_head=2, n_embd=128, ffn_dim=192, num_dense_layers=2,
                n_experts=8, expert_dim=48, top_k=4, block_size=128)
    base.update(overrides)
    return Lfm2MoeConfig(**base)
