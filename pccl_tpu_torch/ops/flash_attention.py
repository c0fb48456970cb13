"""Flash attention: the three CUDA kernels for Hopper, their plain PyTorch
versions, and the differentiable functions the model calls.

Kernels (pccl_tpu_torch/csrc, built by ops/_build.py):
- K1 `flash_fwd`: (out, lse) by online softmax over k tiles;
- K2 `flash_bwd_dq`: dq, rebuilding p = exp(s - lse) from the saved lse;
- K3 `flash_bwd_dkv`: dk and dv, summed over the q heads of each kv head.

Layout: q, out [B, T, H, Dh]; k, v [B, T, Hkv, Dh] with Hkv dividing H
(GQA); lse and delta [B, H, T] fp32: the JAX package's public layout.

Each wrapper takes its plain version for tensors on the CPU, and launches
its kernel for tensors on a CUDA card (bf16, contiguous, Dh 64 or 128),
raising on anything else; there is no fallback from one to the other. A
wrapper counts its kernel launches in `launches`.

The backward needs delta = rowsum(do * o) in fp32, computed here outside
the kernels; the (out, lse) form folds the lse cotangent into it:
ds = p * (dp - (delta - dlse)), since d lse / d s = p.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MASK = -1e30
SUPPORTED_HEAD_DIMS = (64, 128)

# launches of each kernel since the last reset_launch_counts()
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain versions

def _expand_kv(x: torch.Tensor, H: int) -> torch.Tensor:
    """[B, T, Hkv, Dh] -> [B, T, H, Dh] by repeating each kv head G times
    (kv head h // G serves q head h)."""
    Hkv = x.shape[2]
    return x if Hkv == H else x.repeat_interleave(H // Hkv, dim=2)


def _visible(T: int, causal: bool, device) -> torch.Tensor | None:
    if not causal:
        return None
    i = torch.arange(T, device=device)
    return i[None, :] <= i[:, None]                   # [Tq, Tk]


def _scores(q, k, causal: bool) -> torch.Tensor:
    """Masked scaled scores in fp32, [B, H, Tq, Tk]."""
    H, Dh = q.shape[2], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k, H).float())
    s = s * (1.0 / math.sqrt(Dh))
    vis = _visible(q.shape[1], causal, q.device)
    return s if vis is None else s.masked_fill(~vis, MASK)


def flash_fwd_plain(q, k, v, causal: bool = True):
    """Plain version of K1, in fp32: (out in q's dtype, lse [B, H, T] fp32)."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, _expand_kv(v, q.shape[2]).float())
    return out.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal: bool):
    """p and ds = p * (do.v^T - delta) * scale, fp32 [B, H, Tq, Tk]."""
    H, Dh = q.shape[2], q.shape[3]
    p = torch.exp(_scores(q, k, causal) - lse[..., None].float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(v, H).float())
    ds = p * (dp - delta[..., None].float()) * (1.0 / math.sqrt(Dh))
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of K2, in fp32: dq in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _expand_kv(k, q.shape[2]).float())
    return dq.to(q.dtype)


def _fold_groups(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, Hkv, Dh], summing the G q heads of each kv
    head."""
    B, T, H, Dh = x.shape
    return x.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True):
    """Plain version of K3, in fp32: (dk, dv) in k's dtype, [B, T, Hkv, Dh]."""
    Hkv = k.shape[2]
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return _fold_groups(dk, Hkv).to(k.dtype), _fold_groups(dv, Hkv).to(v.dtype)


# ------------------------------------------------------------ kernel wrappers

_DECLARED: dict = {}


def _kernel(lib_name: str, fn_name: str, n_ptrs: int):
    fn = _DECLARED.get(fn_name)
    if fn is None:
        fn = getattr(_build.kernel_lib(lib_name), fn_name)
        fn.restype = ctypes.c_int
        # pointers, then B, T, H, Hkv, Dh, causal, then the stream
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        _DECLARED[fn_name] = fn
    return fn


def _check_qkv(q, k, v, *extra_like_q):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,T,H,Dh] and k, v [B,T,Hkv,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, Dh = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != Dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"GQA requires n_kv_head to divide n_head; got H={H}, "
                         f"Hkv={k.shape[2]}")
    for t in (k, v, *extra_like_q):
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims {SUPPORTED_HEAD_DIMS}, "
                         f"got {Dh}")
    for t in (q, k, v, *extra_like_q):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels take bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def _check_vec(x, q):
    B, T, H, _ = q.shape
    if x.shape != (B, H, T) or x.dtype != torch.float32 \
            or not x.is_contiguous() or x.device != q.device:
        raise ValueError(f"lse/delta must be contiguous fp32 [B, H, T] = "
                         f"{(B, H, T)} on {q.device}; got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")


def _launch(fn, name: str, ptrs, q, k, causal: bool):
    B, T, H, Dh = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(*[t.data_ptr() for t in ptrs], B, T, H, k.shape[2], Dh,
                  int(causal), stream)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code}")
    launches[name] += 1


def flash_fwd(q, k, v, causal: bool = True):
    """K1: (out [B,T,H,Dh] in q's dtype, lse [B,H,T] fp32)."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    B, T, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch(_kernel("flash_fwd", "pccl_flash_fwd", 5), "flash_fwd",
            (q, k, v, out, lse), q, k, causal)
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """K2: dq [B,T,H,Dh]."""
    _check_qkv(q, k, v, do)
    _check_vec(lse, q)
    _check_vec(delta, q)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dq = torch.empty_like(q)
    _launch(_kernel("flash_bwd", "pccl_flash_bwd_dq", 7), "flash_bwd_dq",
            (q, k, v, do, lse, delta, dq), q, k, causal)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """K3: (dk, dv) [B,T,Hkv,Dh]."""
    _check_qkv(q, k, v, do)
    _check_vec(lse, q)
    _check_vec(delta, q)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_kernel("flash_bwd", "pccl_flash_bwd_dkv", 8), "flash_bwd_dkv",
            (q, k, v, do, lse, delta, dk, dv), q, k, causal)
    return dk, dv


def _delta(do, out):
    """rowsum(do * o) in fp32, as [B, H, T]."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _backward(saved, causal, do, dlse=None):
    """dq, dk, dv from the forward's saved (q, k, v, lse, out); dlse, when
    given, folds into delta."""
    q, k, v, lse, out = saved
    if do is None:
        do = torch.zeros_like(out)
    do = do.contiguous()
    delta = _delta(do, out)
    if dlse is not None:
        delta = (delta - dlse.float()).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv, None


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, lse, out)
        return out

    @staticmethod
    def backward(ctx, do):
        # saved_tensors is read once: checkpointing allows one unpack
        return _backward(ctx.saved_tensors, ctx.causal, do)


class _FlashAttentionWithLse(torch.autograd.Function):
    """(out, lse) = attention(q, k, v), both differentiable: the lse
    cotangent folds into delta, so the same kernels serve."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, lse, out)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx.saved_tensors, ctx.causal, do, dlse)


def flash_attention(q, k, v, *, causal: bool = True):
    """Fused attention. q [B,T,H,Dh], k/v [B,T,Hkv,Dh] -> [B,T,H,Dh].
    Differentiable; the kernels on a CUDA card, the plain versions on the
    CPU."""
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """(out [B,T,H,Dh], lse [B,H,T] fp32), both differentiable."""
    return _FlashAttentionWithLse.apply(q, k, v, causal)


def dense_attention_with_lse(q, k, v, causal: bool = True):
    """Dense twin of flash_attention_with_lse: K1's plain version, in plain
    PyTorch ops that autograd differentiates on any device. GQA K/V are
    repeated."""
    return flash_fwd_plain(q, k, v, causal)


def reference_attention(q, k, v, causal: bool = True):
    """Dense attention; q [B,T,H,Dh], k/v [B,T,Hkv,Dh]."""
    return dense_attention_with_lse(q, k, v, causal)[0]
