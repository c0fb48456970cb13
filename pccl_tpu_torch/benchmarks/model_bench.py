"""Train-step benchmark on the card: tokens/s and MFU.

The twin of pccl_tpu/benchmarks/model_bench.py: the bf16 train step of
parallel/train.py (build_train_step, AdamW over fp32 parameters, the
attention through K1-K3 of ops/flash_attention.py) on one CUDA device,
reported as tokens/s and model-FLOPs utilization.

Method, as in the JAX twin:

- **Fencing.** Each timed window ends with a host readback of the loss
  (`loss.item()`), which a training loop does anyway; the steps inside a
  window run back to back, so the window measures the step rate with the
  host's dispatch included.
- **MFU convention.** Model FLOPs are the algorithmic count (6 x matmul
  parameters a token + 12 L T d of attention, the PaLM appendix's
  formula); the flash backward's recompute is not counted, so the MFU is
  conservative. The denominator is the card's dense bf16 peak, looked up
  by `torch.cuda.get_device_name()` in PEAK_BF16_TFLOPS.
- **Trimmed windows.** Windows below 60 % of the best are left out of the
  median, and their count is reported as `stall_windows`; the raw min and
  max stay in the result, so the spread is never hidden.

The result also carries `launches`, the K1/K2/K3 counts over the timed
windows (set to 0 after the warm-up step), and `peak_mib`, the card's
`max_memory_allocated` over the run (None on the CPU).

    python -m pccl_tpu_torch.benchmarks.model_bench gpt [batch=16 seq=1024 ...]

prints one JSON line.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict

import numpy as np

# Dense bf16 peak of a card, by the prefix of its device name (the
# datasheet's figure without sparsity); the MFU denominator.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,     # H100 SXM
}

# Per-family bench shapes for one 80 GB card, no remat: the largest batch
# of 8, 16 and 32 whose peak allocation stays at or under 60 GB (PERF.md
# lists each choice with its measured peak).
DEFAULT_SHAPES = {
    "gpt": dict(preset="gpt2-medium", batch=16, seq=1024, remat=False),
    "llama": dict(preset="700m", batch=8, seq=2048, remat=False),
}


def peak_tflops(device_name: str) -> float:
    """The dense bf16 peak of the card named `device_name` (the longest
    matching prefix of PEAK_BF16_TFLOPS)."""
    for prefix, tf in sorted(PEAK_BF16_TFLOPS.items(), key=lambda kv: -len(kv[0])):
        if device_name.startswith(prefix):
            return tf
    raise ValueError(f"unknown device {device_name!r}; add its dense bf16 "
                     "peak to PEAK_BF16_TFLOPS")


def flops_per_token(cfg, seq: int) -> float:
    """Algorithmic train FLOPs per token (forward 2 x matmul parameters +
    attention, backward = 2 x forward)."""
    from ..models import llama

    d, L = cfg.n_embd, cfg.n_layer
    if isinstance(cfg, llama.LlamaConfig):
        kv = cfg.n_kv_head * cfg.head_dim
        per_layer = d * d + d * 2 * kv + d * d + 3 * d * cfg.ffn_dim
        head = cfg.vocab_size * d            # untied unembedding
    else:
        per_layer = 12 * d * d               # qkv + out + mlp_in + mlp_out
        head = cfg.vocab_size * d            # tied unembedding matmul
    matmul_params = L * per_layer + head
    # attention: QK^T + AV are 2·T·d each fwd per layer → ×3 for fwd+bwd
    return 6.0 * matmul_params + 12.0 * L * seq * d


def _named_config(family: str, preset: str, seq: int, **overrides):
    from ..models import gpt, llama

    mod = llama if family == "llama" else gpt
    return mod.named_config(preset, block_size=seq, **overrides)


def _repeat_kv_attn(q, k, v):
    """The ablation's attention: K/V expanded to the q heads in memory
    before the kernel, forfeiting GQA's smaller K/V reads."""
    from ..ops.flash_attention import flash_attention

    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    return flash_attention(q, k, v)


def run_cuda_train_bench(family: str = "gpt", preset: str | None = None,
                         batch: int | None = None, seq: int | None = None,
                         steps_per_window: int = 8, windows: int = 5,
                         use_flash: bool = True,
                         remat: "bool | str | None" = None,
                         repeat_kv: bool = False,
                         loss_chunk: int = 0, device="cuda",
                         **cfg_overrides) -> Dict[str, Any]:
    """Measure the train step on `device` (a CUDA card unless "cpu" is
    asked for; raises RuntimeError when CUDA is asked for and missing).

    Returns {stall_windows, config, tokens_s (median of the kept windows),
    tokens_s_min/max, step_s, model_tflops_per_step, mfu (None on the
    CPU), loss_first, loss_last, launches, peak_mib}. On a card,
    use_flash=False raises ValueError: dense attention runs only on the
    CPU, where the flash op takes its plain version anyway."""
    import torch

    from .._device import resolve_device
    from ..ops import flash_attention as fa
    from ..parallel import train as train_lib

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card and not use_flash:
        raise ValueError("dense attention runs only on the CPU; the card "
                         "runs the flash kernels")
    shape = dict(DEFAULT_SHAPES[family])
    if preset:
        shape["preset"] = preset
    if batch:
        shape["batch"] = batch
    if seq:
        shape["seq"] = seq
    if remat is not None:
        shape["remat"] = remat
    B, T = shape["batch"], shape["seq"]
    do_remat = shape.get("remat", False)
    cfg = _named_config(family, shape["preset"], T, **cfg_overrides)

    attn_fn = None
    if use_flash:
        attn_fn = _repeat_kv_attn if repeat_kv else fa.flash_attention
    if on_card:
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"

    state = train_lib.make_train_state(0, cfg, dev)
    step = train_lib.build_train_step(cfg, attn_fn, remat=do_remat,
                                      loss_chunk=loss_chunk or None)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                             dtype=torch.int32).to(dev)
    targets = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                              dtype=torch.int32).to(dev)

    # warm-up: the first step builds the kernels' libraries and AdamW's
    # state; its readback is the first fence
    loss_first = step(state, tokens, targets).item()
    fa.reset_launch_counts()

    rates = []
    loss_last = loss_first
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps_per_window):
            loss = step(state, tokens, targets)
        loss_last = loss.item()          # host readback = the fence
        dt = time.perf_counter() - t0
        rates.append(steps_per_window * B * T / dt)
    launches = dict(fa.launches)

    trimmed = [r for r in rates if r >= 0.6 * max(rates)]
    tok_s = statistics.median(trimmed)
    ftok = flops_per_token(cfg, T)
    return {
        "stall_windows": len(rates) - len(trimmed),
        "config": f"{family}/{shape['preset']} b{B}x{T} "
                  f"{'flash' if use_flash else 'dense'}"
                  f"{'+remat' if do_remat is True else ''}"
                  f"{'+remat:' + do_remat if isinstance(do_remat, str) else ''}"
                  f"{'+ce:' + str(loss_chunk) if loss_chunk else ''}"
                  f"{'+repeatkv' if repeat_kv else ''}"
                  f" ({kind})",
        "tokens_s": tok_s,
        "tokens_s_min": min(rates),
        "tokens_s_max": max(rates),
        "step_s": B * T / tok_s,
        "model_tflops_per_step": ftok * B * T / 1e12,
        # a CPU has no peak to divide by
        "mfu": tok_s * ftok / (peak_tflops(kind) * 1e12) if on_card else None,
        "loss_first": loss_first,
        "loss_last": loss_last,
        "launches": launches,
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2 ** 20 if on_card else None,
    }


def _parse_args(argv) -> tuple:
    """(family, kwargs) from `family k=v ...`, the JAX twin's command line
    (plus device=)."""
    fam = argv[0] if argv else "gpt"
    kw: Dict[str, Any] = {}
    for a in argv[1:]:
        k, v = a.split("=")
        if k in ("preset", "device"):
            kw[k] = v
        elif k == "remat":
            kw[k] = v if v in ("dots", "sqrt") else bool(int(v))
        elif k in ("use_flash", "untie_head", "repeat_kv"):
            kw[k] = bool(int(v))
        else:
            kw[k] = int(v)  # batch/seq/windows + int config overrides
    return fam, kw


if __name__ == "__main__":
    import json
    import sys

    fam, kw = _parse_args(sys.argv[1:])
    print(json.dumps(run_cuda_train_bench(fam, **kw)))
