"""Grouped GEMM over experts: the kernel of csrc/moe_gemm.cu (built by
ops/_build.py), its plain PyTorch versions, and the differentiable product
that ops/moe.py's dropless layer calls.

x [S, K] holds the rows of every expert, sorted by expert: expert e's rows
are [offsets[e], offsets[e + 1]) for offsets [E + 1] int32 on x's device
(offsets[0] = 0, offsets[E] = S), and w [E, K, N] holds one [K, N] matrix
an expert. grouped_mm(x, w, offsets) is y [S, N] with y[s] = x[s] w[e] for
each row s of expert e, in x's dtype with fp32 accumulation. Its backward
is two more grouped products: dx = dy w[e]^T (the `dx` variant) and dw[e] =
x_e^T dy_e (the `dw` variant, fp32, into the gradient of w).

On a CUDA card the three variants run the kernel (bf16 x and dy, K and N
multiples of 8, contiguous and 16-byte aligned); the segments are read on
the card, so nothing here waits for it. On the CPU the plain versions run
a loop of torch.matmul over the segments, which reads the offsets on the
host. There is no fallback from one to the other. `launches` counts the
kernel's launches by variant.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of each variant since the last reset_launch_counts()
launches = {"moe_gemm_fwd": 0, "moe_gemm_dx": 0, "moe_gemm_dw": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain versions

def _segments(offsets):
    bounds = offsets.tolist()
    return [(e, a, b) for e, (a, b) in enumerate(zip(bounds, bounds[1:])) if b > a]


def grouped_mm_plain(x, w, offsets):
    """y [S, N] in x's dtype: each segment's rows times its expert's
    matrix, in fp32."""
    y = x.new_zeros(x.shape[0], w.shape[-1])
    for e, a, b in _segments(offsets):
        y[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return y


def grouped_mm_dx_plain(dy, w, offsets):
    """dx [S, K] in dy's dtype: each segment's rows of dy times its
    expert's matrix transposed, in fp32."""
    dx = dy.new_zeros(dy.shape[0], w.shape[1])
    for e, a, b in _segments(offsets):
        dx[a:b] = (dy[a:b].float() @ w[e].float().t()).to(dy.dtype)
    return dx


def grouped_mm_dw_plain(x, dy, offsets):
    """dw [E, K, N] fp32: x_e^T dy_e for each expert, zeros for an expert
    with no rows."""
    E = offsets.numel() - 1
    dw = torch.zeros(E, x.shape[1], dy.shape[1], dtype=torch.float32, device=x.device)
    for e, a, b in _segments(offsets):
        dw[e] = x[a:b].float().t() @ dy[a:b].float()
    return dw


# ------------------------------------------------------------ kernel

_FNS: dict = {}


def _kernel(variant: str):
    fn = _FNS.get(variant)
    if fn is None:
        fn = getattr(_build.kernel_lib("moe_gemm"), f"pccl_{variant}")
        fn.restype = ctypes.c_int
        # four pointers (two operands, the result, offsets), E, S, K, N, stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _FNS[variant] = fn
    return fn


def _check(what: str, offsets, E: int, K: int, N: int, *tensors) -> None:
    """What the kernel takes: offsets contiguous int32 [E + 1], K and N
    multiples of 8, and every tensor bf16, contiguous, 16-byte aligned, on
    offsets' CUDA card."""
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (E + 1,) \
            or not offsets.is_contiguous():
        raise ValueError(f"{what}: offsets must be contiguous int32 [E + 1] = "
                         f"[{E + 1}]; got {offsets.dtype} {tuple(offsets.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"{what}: the kernel takes K and N multiples of 8; got {K}, {N}")
    for t in tensors:
        if t.device != offsets.device or t.device.type != "cuda":
            raise ValueError(f"{what}: all inputs on one CUDA card")
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: the kernel takes contiguous 16-byte aligned "
                             f"bf16; got {t.dtype}, contiguous {t.is_contiguous()}")


def _rows(what: str, t, cols: int) -> None:
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{what}: expected [S, {cols}], got {tuple(t.shape)}")


def _launch(variant: str, a, b, out, offsets, K: int, N: int) -> None:
    E = offsets.numel() - 1
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        code = _kernel(variant)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                offsets.data_ptr(), E, a.shape[0], K, N, stream)
    if code != 0:
        raise RuntimeError(f"{variant} kernel launch failed: cudaError {code}")
    launches[variant] += 1


def grouped_mm_fwd(x, w, offsets):
    """y [S, N] = x [S, K] @ w[e] [K, N] over each expert's rows."""
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, offsets)
    E, K, N = w.shape
    _rows("moe_gemm_fwd", x, K)
    _check("moe_gemm_fwd", offsets, E, K, N, x, w)
    y = torch.empty(x.shape[0], N, dtype=x.dtype, device=x.device)
    _launch("moe_gemm_fwd", x, w, y, offsets, K, N)
    return y


def grouped_mm_dx(dy, w, offsets):
    """dx [S, K] = dy [S, N] @ w[e]^T over each expert's rows."""
    if dy.device.type == "cpu":
        return grouped_mm_dx_plain(dy, w, offsets)
    E, K, N = w.shape
    _rows("moe_gemm_dx", dy, N)
    _check("moe_gemm_dx", offsets, E, K, N, dy, w)
    dx = torch.empty(dy.shape[0], K, dtype=dy.dtype, device=dy.device)
    _launch("moe_gemm_dx", dy, w, dx, offsets, K, N)
    return dx


def grouped_mm_dw(x, dy, offsets):
    """dw [E, K, N] fp32 = x_e^T dy_e for each expert."""
    if x.device.type == "cpu":
        return grouped_mm_dw_plain(x, dy, offsets)
    E, K, N = offsets.numel() - 1, x.shape[1], dy.shape[1]
    _rows("moe_gemm_dw", dy, N)
    if x.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"moe_gemm_dw: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         "must have the same rows")
    _check("moe_gemm_dw", offsets, E, K, N, x, dy)
    dw = torch.empty(E, K, N, dtype=torch.float32, device=x.device)
    _launch("moe_gemm_dw", x, dy, dw, offsets, K, N)
    return dw


class _GroupedMM(torch.autograd.Function):
    """grouped_mm with the fp32 leaf w cast to x's dtype inside (in the
    forward, and again in the backward rather than kept); dw is fp32."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        return grouped_mm_fwd(x, w.to(x.dtype), offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_mm_dx(dy, w.to(x.dtype), offsets)
        if ctx.needs_input_grad[1]:
            dw = grouped_mm_dw(x, dy, offsets).to(w.dtype)
        return dx, dw, None


def grouped_mm(x, w, offsets):
    """Differentiable grouped product (see the module's docstring): x [S, K]
    in the compute dtype, w [E, K, N] (an fp32 leaf), offsets [E + 1]
    int32."""
    return _GroupedMM.apply(x.contiguous(), w, offsets)
