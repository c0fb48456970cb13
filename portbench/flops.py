"""Operations and bytes from shapes, shared by `mfu` and the rooflines.

A model type's own counts (its FLOPs a token and the shapes of its
attention calls) are in families/<type>.py; flops_per_token and
flash_calls find it by the configuration's `model_type`.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989
TFLOP/s in bf16 and 3.35 TB/s of HBM3, keyed by the name that
torch.cuda.get_device_name() gives.
"""

from __future__ import annotations

from portbench import spec

PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}


def peaks(device_name: str) -> tuple:
    """(bf16 FLOP/s, bytes/s) of a card; KeyError for a card not listed,
    so no share is ever taken of a guessed peak."""
    return PEAKS[device_name]


def flops_per_token(cfg: dict, seq_len: int, here=spec.HERE) -> float:
    """Model FLOPs of one trained token (forward and backward) at sequence
    length `seq_len`, as the model type's family counts them."""
    return spec.family(cfg["model_type"], here).flops_per_token(cfg, seq_len)


def flash_calls(cfg: dict, batch: int, block: int, here=spec.HERE) -> list:
    """[(layers, dict(B, T, H, Hkv, D, causal, window)), ...]: each distinct
    shape of the model's K1-K3 calls with the layers that have it."""
    return spec.family(cfg["model_type"], here).flash_calls(cfg, batch, block)


def visible_pairs(T: int, causal: bool, window=None) -> int:
    """(query, key) pairs of one head: every pair without a mask; under a
    causal mask a query sees itself and the keys before it, under a window
    itself and the window - 1 keys before it (the sliding-window
    convention of the Hugging Face configs)."""
    if window is None or window >= T:
        return T * (T + 1) // 2 if causal else T * T
    if not causal:
        raise ValueError("a window is counted only under a causal mask")
    return window * (window + 1) // 2 + (T - window) * window


def flash_work(B, T, H, Hkv, D, causal=True, window=None) -> dict:
    """kernel -> (FLOPs of its products, bytes read once and written once)
    of one call of K1 (flash_fwd), K2 (flash_bwd_dq), K3 (flash_bwd_dkv)."""
    pairs = B * H * visible_pairs(T, causal, window)
    q_b, kv_b, vec_b = B * T * H * D * 2, B * T * Hkv * D * 2, B * H * T * 4
    return {
        # QK^T and PV
        "flash_fwd": (4 * pairs * D, 2 * q_b + 2 * kv_b + vec_b),
        # QK^T, dO V^T, dS K
        "flash_bwd_dq": (6 * pairs * D, 3 * q_b + 2 * kv_b + 2 * vec_b),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (8 * pairs * D, 2 * q_b + 4 * kv_b + 2 * vec_b),
    }


def bounds(B, T, H, Hkv, D, causal=True, window=None, peak_flops=989e12,
           peak_bytes=3.35e12) -> dict:
    """kernel -> (least ms of one call, "operations" or "bytes"): the larger
    of FLOPs over the bf16 peak and bytes over the HBM rate."""
    out = {}
    for name, (fl, nbytes) in flash_work(B, T, H, Hkv, D, causal, window).items():
        t_ops, t_bytes = fl / peak_flops * 1e3, nbytes / peak_bytes * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def call_bounds(calls: list, peak_flops=989e12, peak_bytes=3.35e12) -> dict:
    """kernel -> least ms of one call of a model's K1-K3: the mean of
    bounds() over flash_calls' shapes, weighted by their layers (one shape:
    its bound exactly)."""
    total = sum(n for n, _ in calls)
    out = {}
    for n, shape in calls:
        for k, (ms, _) in bounds(**shape, peak_flops=peak_flops,
                                 peak_bytes=peak_bytes).items():
            out[k] = out.get(k, 0.0) + n / total * ms
    return out


def hash_bound_ms(nbytes: int, peak_bytes=3.35e12) -> float:
    """H1 reads every byte once: its least time is the bytes over HBM."""
    return nbytes / peak_bytes * 1e3
