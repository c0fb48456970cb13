"""The flash-attention CUDA kernels against their plain versions, on a CUDA
card (bf16). Skipped where there is none; run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda

Tolerance, as in chip_smoke.py: each output is held both by its relative
L2 error and element by element, |kernel - plain| <= atol * rms(plain) +
rtol * |plain|, so that neither the few large rows of the causal mask nor
the many small ones can hide an error. The bf16 outputs get rtol = one bf16
ulp (2^-8); p and ds are cast to bf16 before the second product, as in the
TPU kernels. The fp32 lse only sees exp/log and summation order.
"""

import pytest
import torch

from pccl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

SHAPES = [  # B, T, H, Hkv, D, causal
    (2, 256, 4, 4, 64, True),
    (1, 200, 8, 2, 128, True),
    (2, 130, 4, 4, 64, False),
    (1, 64, 2, 1, 128, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {  # name: (rel, atol, rtol)
    "out": (1e-2, 0.15, 2 ** -8), "lse": (2e-7, 1e-6, 5e-7),
    "dq": (1e-2, 0.15, 2 ** -8), "dk": (1e-2, 0.15, 2 ** -8),
    "dv": (1e-2, 0.15, 2 ** -8)}


def _close(name, got, ref):
    rel_tol, atol, rtol = TOL[name]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rel = (err.norm() / ref.norm()).item()
    assert rel <= rel_tol, (name, rel)
    limit = atol * ref.pow(2).mean().sqrt() + rtol * ref.abs()
    assert bool((err <= limit).all()), (name, (err - limit).max().item())


@pytest.mark.parametrize("B,T,H,Hkv,D,causal", SHAPES)
def test_kernels_match_plain(cuda, B, T, H, Hkv, D, causal):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(heads):
        return torch.randn((B, T, heads, D), generator=g, device=cuda,
                           dtype=torch.bfloat16)

    q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
    f32 = [x.float() for x in (q, k, v, do)]
    fa.reset_launch_counts()
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(*f32[:3], causal)
    delta = (f32[3] * ref_out).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    _close("out", out, ref_out)
    _close("lse", lse, ref_lse)
    _close("dq", dq, fa.flash_bwd_dq_plain(*f32, ref_lse, delta, causal))
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*f32, ref_lse, delta, causal)
    _close("dk", dk, ref_dk)
    _close("dv", dv, ref_dv)
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(x, x, x)
    y = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_fwd(y, y, y)
