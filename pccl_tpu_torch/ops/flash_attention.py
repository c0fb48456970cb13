"""Flash attention: the three CUDA kernels for Hopper, their plain PyTorch
versions, and the differentiable functions the model calls.

Kernels (pccl_tpu_torch/csrc, built by ops/_build.py):
- K1 `flash_fwd` (flash_fwd.cu): (out, lse) by online softmax over k tiles;
- K2 `flash_bwd_dq` (flash_bwd.cu): dq, rebuilding p = exp(s - lse) from
  the saved lse;
- K3 `flash_bwd_dkv` (flash_bwd_dkv.cu): dk and dv, summed over the q
  heads of each kv head.

Layout: q, out [B, T, H, Dh]; k, v [B, T, Hkv, Dh] with Hkv dividing H
(GQA); lse and delta [B, H, T] fp32: the JAX package's public layout.

Each wrapper takes its plain version for tensors on the CPU, and launches
its kernel for tensors on a CUDA card (bf16, contiguous, 16-byte aligned,
Dh 16, 32, 64 or 128: every preset of both families), raising on anything
else, fp32 included; there is no fallback from one to the other. Dh 16
and 32 run the Dh 64 kernels at a padded width (csrc/hopper.cuh). A
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
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

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


def _scores(q, k, causal: bool, q0: int = 0) -> torch.Tensor:
    """Masked scaled scores in fp32, [B, H, Tq, Tk], for the queries at
    sequence rows q0..q0+Tq against keys 0..Tk."""
    H, Dh = q.shape[2], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k, H).float())
    s = s * (1.0 / math.sqrt(Dh))
    if not causal:
        return s
    i = torch.arange(q0, q0 + q.shape[1], device=q.device)
    j = torch.arange(k.shape[1], device=q.device)
    return s.masked_fill(j[None, :] > i[:, None], MASK)


def _query_blocks(T: int, Tk: int, causal: bool, q_block: int | None):
    """(q0, q1, k1) for each block of q_block query rows (all T rows when
    None) and the keys 0..k1 it can see: with the causal mask the block
    sees none past its last row, so its scores are [B, H, q1 - q0, k1]
    and the full [B, H, T, T] is never held."""
    step = q_block or T
    for q0 in range(0, T, step):
        q1 = min(q0 + step, T)
        yield q0, q1, (q1 if causal else Tk)


def flash_fwd_plain(q, k, v, causal: bool = True, q_block: int | None = None):
    """Plain version of K1, in fp32: (out in q's dtype, lse [B, H, T] fp32);
    q_block rows of scores at a time where given."""
    H, outs, lses = q.shape[2], [], []
    for q0, q1, k1 in _query_blocks(q.shape[1], k.shape[1], causal, q_block):
        s = _scores(q[:, q0:q1], k[:, :k1], causal, q0)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        del s
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p,
                                 _expand_kv(v[:, :k1], H).float()).to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _p_ds(q, k, v, do, lse, delta, causal: bool, bf16_p: bool = False, q0: int = 0):
    """p and ds = p * (do.v^T - delta) * scale, fp32 [B, H, Tq, Tk], for
    the queries at sequence rows q0..; with bf16_p each rounded to bf16,
    as K2 and K3 (and the TPU kernels) round them before the second
    products."""
    H, Dh = q.shape[2], q.shape[3]
    p = torch.exp(_scores(q, k, causal, q0) - lse[..., None].float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(v, H).float())
    ds = p * (dp - delta[..., None].float()) * (1.0 / math.sqrt(Dh))
    if bf16_p:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       bf16_p: bool = False, q_block: int | None = None):
    """Plain version of K2, in fp32 (ds rounded to bf16 with bf16_p): dq in
    q's dtype; q_block rows of scores at a time where given."""
    H, parts = q.shape[2], []
    for q0, q1, k1 in _query_blocks(q.shape[1], k.shape[1], causal, q_block):
        _, ds = _p_ds(q[:, q0:q1], k[:, :k1], v[:, :k1], do[:, q0:q1],
                      lse[..., q0:q1], delta[..., q0:q1], causal, bf16_p, q0)
        parts.append(torch.einsum("bhqk,bkhd->bqhd", ds,
                                  _expand_kv(k[:, :k1], H).float()).to(q.dtype))
    return torch.cat(parts, dim=1)


def _fold_groups(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, Hkv, Dh], summing the G q heads of each kv
    head."""
    B, T, H, Dh = x.shape
    return x.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        bf16_p: bool = False, q_block: int | None = None):
    """Plain version of K3, in fp32 (p and ds rounded to bf16 with bf16_p):
    (dk, dv) in k's dtype, [B, T, Hkv, Dh]; q_block rows of scores at a
    time where given, each block's share summed into fp32 dk and dv."""
    B, Tk, Hkv, Dh = k.shape
    dk = torch.zeros((B, Tk, q.shape[2], Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0, q1, k1 in _query_blocks(q.shape[1], Tk, causal, q_block):
        p, ds = _p_ds(q[:, q0:q1], k[:, :k1], v[:, :k1], do[:, q0:q1],
                      lse[..., q0:q1], delta[..., q0:q1], causal, bf16_p, q0)
        dv[:, :k1] += torch.einsum("bhqk,bqhd->bkhd", p, do[:, q0:q1].float())
        dk[:, :k1] += torch.einsum("bhqk,bqhd->bkhd", ds, q[:, q0:q1].float())
        del p, ds
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
    _check_aligned(q, k, v, *extra_like_q)


def _check_aligned(*tensors):
    """The kernels read their bf16 operands by TMA and 16-byte loads, which
    need a base address on a 16-byte boundary; a contiguous view with a
    storage offset may have another."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA kernels take tensors whose address is "
                             f"16-byte aligned; got one at offset "
                             f"{t.data_ptr() % 16} (a view? pass .clone())")


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
    _launch(_kernel("flash_bwd_dkv", "pccl_flash_bwd_dkv", 8), "flash_bwd_dkv",
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
