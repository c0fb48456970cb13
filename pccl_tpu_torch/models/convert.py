"""Weights across the two packages: numpy dicts with the JAX package's
names and shapes <-> this package's tensor dicts. Both layouts are the same
(stacked [n_layer, ...] tensors, [in, out] weights), so nothing is
transposed; only names and shapes are checked."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.train import family


def params_from_numpy(np_params: Dict[str, np.ndarray], cfg,
                      device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Tensors on `device` from a numpy dict whose names and shapes are
    exactly those of init_params(cfg) of the config's family (a GPTConfig
    or a LlamaConfig)."""
    want = family(cfg).param_shapes(cfg)
    if set(np_params) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(np_params))}, unexpected "
                         f"{sorted(set(np_params) - set(want))}")
    dev = resolve_device(device)
    out = {}
    for name, shape in want.items():
        arr = np.asarray(np_params[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != {shape}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev, dtype)
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """fp32 numpy copies of every tensor (bf16 is widened: numpy has no
    bf16)."""
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()}
