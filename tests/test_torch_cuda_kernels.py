"""The CUDA kernels against their plain versions, on a CUDA card: the
flash-attention kernels (bf16) and H1, the `simple-tpu` hash (bit for bit,
also against the numpy twin). Skipped where there is none; run them on the
card with

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
from pccl_tpu_torch.ops import hashing

pytestmark = pytest.mark.cuda

SHAPES = [  # B, T, H, Hkv, D, causal
    (2, 256, 4, 4, 64, True),
    (1, 200, 8, 2, 128, True),
    (2, 130, 4, 4, 64, False),
    (1, 64, 2, 1, 128, False),
    # the edges of K1's and K3's 128-row tiles and K3's 64-row q tiles
    (1, 1, 2, 2, 64, True),
    (1, 65, 2, 2, 128, True),
    (1, 127, 2, 1, 64, False),
    (1, 129, 2, 2, 64, True),
    (2, 200, 4, 4, 64, False),
    # G = 4 q heads per kv head
    (1, 256, 8, 2, 64, True),
    (1, 256, 8, 2, 64, False),
    (1, 256, 8, 2, 128, True),
    (1, 192, 8, 2, 128, False),
    # a long causal walk
    (1, 2048, 4, 4, 64, True),
    # the edges of K2's 64-row k tiles (BK = 64 at both head dims), and a
    # ragged G = 4 causal walk at Dh = 128
    (1, 63, 2, 2, 64, True),
    (1, 64, 2, 2, 64, False),
    (1, 65, 2, 1, 64, True),
    (1, 63, 2, 2, 128, False),
    (1, 64, 2, 1, 128, True),
    (1, 191, 8, 2, 128, True),
    # Llama-700m's attention: G = 3 q heads per kv head at Dh = 128, the
    # shape of chip_smoke.py's phase 7; and a ragged G = 3 walk
    (2, 2048, 12, 4, 128, True),
    (1, 200, 6, 2, 128, False),
    # head dims 16 and 32 (the `nano` and `tiny` presets), which run the
    # Dh 64 kernels at a padded width: the presets' shapes, ragged walks and
    # the tiles' edges
    (8, 64, 4, 4, 16, True),
    (8, 64, 4, 2, 32, True),
    (2, 100, 4, 2, 16, False),
    (2, 200, 4, 4, 32, False),
    (1, 1, 2, 2, 16, True),
    (1, 129, 4, 1, 32, True),
    (1, 65, 2, 2, 16, False),
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
    if not ref.any():
        # T = 1: one visible key, so ds = p (dp - delta) * scale is 0 and dq
        # and dk vanish; what is left is the rounding of dp - delta, O(1e-7)
        # on N(0, 1) inputs
        assert err.max().item() <= 1e-4, (name, err.max().item())
        return
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
    x = torch.zeros(1, 64, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd(x, x, x)
    y = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_fwd(y, y, y)
    base = torch.zeros(1 + 64 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 64, 2, 64)  # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(shifted, shifted, shifted)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_kernels_are_deterministic(cuda, D):
    """No atomics: two calls on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(1)
    B, T, H, Hkv = 2, 300, 8, 2
    q, do = (torch.randn((B, T, H, D), generator=g, device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v, True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
        runs.append((out, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# H1 at chip_smoke.py's byte counts: under one word, ragged words, one and
# two lane rows and just past them, 4 rows
H1_BYTES = [1, 3, 4, 17, 65536 * 4, 65536 * 4 + 4, 65536 * 8 + 7, 1 << 20]


def _h1_agrees(t):
    hashing.reset_launch_counts()
    planes = hashing.device_planes(t)
    assert hashing.launches["simplehash_tpu"] == 1
    assert torch.equal(planes, hashing.planes_plain(t))
    host = t.reshape(-1).view(torch.uint8).cpu().numpy()
    assert hashing.torch_simplehash_device(t) == hashing.simplehash_tpu(host)


@pytest.mark.parametrize("nbytes", H1_BYTES)
def test_h1_matches_plain_and_twin(cuda, nbytes):
    g = torch.Generator(device=cuda).manual_seed(nbytes)
    _h1_agrees(torch.randint(0, 256, (nbytes,), generator=g, device=cuda,
                             dtype=torch.uint8))


@pytest.mark.parametrize("case", ["bf16", "int8", "uint64", "tok_emb", "view"])
def test_h1_dtypes_and_layouts(cuda, case):
    g = torch.Generator(device=cuda).manual_seed(5)
    t = {
        "bf16": lambda: torch.randn(3 * 65536 + 1, generator=g,
                                    device=cuda).bfloat16(),
        "int8": lambda: torch.randint(-128, 128, (131075,), generator=g,
                                      device=cuda, dtype=torch.int8),
        "uint64": lambda: torch.randint(-2 ** 62, 2 ** 62, (100003,), generator=g,
                                        device=cuda,
                                        dtype=torch.int64).view(torch.uint64),
        "tok_emb": lambda: torch.randn((50304, 768), generator=g, device=cuda),
        # not 16-byte aligned, and strided: hashed from a contiguous copy
        "view": lambda: torch.randn(70001, generator=g, device=cuda)[1:],
    }[case]()
    _h1_agrees(t)
    if case == "view":
        _h1_agrees(torch.randn((300, 257), generator=g, device=cuda).t())


def test_h1_is_deterministic(cuda):
    x = torch.randn((590, 65536), device=cuda)
    runs = [hashing.device_planes(x) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
