"""The experts' grouped GEMM (csrc/moe_gemm.cu through ops/moe_gemm.py) on
the card against its plain versions (a loop of fp32 products over the
segments, on the same bf16 inputs), and the dropless layer that calls it:
uneven segments, empty experts, one expert taking every row, segments of
exactly one and two tiles, columns and depths that are not multiples of the
kernel's tiles, and the model's own widths; rows past a segment's end that
must count for nothing; two calls bit-equal. Card only: each test skips
without CUDA (decided in the fixture).

Tolerances: the kernel and the plain version sum the same bf16 products in
fp32 in different orders (about 1e-6 relative), and fwd and dx then round
to bf16, where that order can move a value by one step of bf16 (2^-8
relative): fwd and dx within 2^-7 of the largest value, dw (fp32) within
1e-4 of the largest value.

    python -m pytest --noconftest tests/test_torch_moe_gemm.py -m cuda -q
"""

import pytest
import torch

from pccl_tpu_torch.ops import moe, moe_gemm

# (name, rows of each expert, K, N)
CASES = [
    ("uneven", [0, 1, 127, 128, 129, 300, 0, 513], 256, 384),
    ("one_takes_all", [0] * 5 + [1000] + [0] * 26, 128, 256),
    ("ragged_edges", [3, 0, 70, 200], 40, 24),
    # segments of exactly one and two tiles: 64 and 128 rows are one and two
    # depth tiles of dw, 128 and 256 rows one and two row tiles of fwd and dx
    ("whole_tiles", [64, 128, 128, 256], 128, 256),
    # N (fwd, dw) and K (dx) not multiples of the 256-wide tile, nor of 64
    ("partial_width", [300, 0, 77, 129], 200, 136),
    ("gate_up", None, 2048, 3584),
    ("down", None, 1792, 2048),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(counts, K, N, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if counts is None:   # the model's widths: 32 experts, 4096 rows drawn unevenly
        E, S = 32, 4096
        e = torch.multinomial(torch.linspace(0.1, 3.0, E, device=dev), S, replacement=True,
                              generator=gen)
        counts = torch.bincount(e, minlength=E).tolist()
    E, S = len(counts), sum(counts)
    offsets = torch.tensor([0] + counts, device=dev).cumsum(0).to(torch.int32)
    x = torch.randn(S, K, generator=gen, device=dev).bfloat16()
    w = (torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5).bfloat16()
    dy = torch.randn(S, N, generator=gen, device=dev).bfloat16()
    return x, w, dy, offsets


def _close_bf16(got, want):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 ** -7 * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name,counts,K,N", CASES, ids=[c[0] for c in CASES])
def test_three_variants_match_the_plain_loop(card, name, counts, K, N):
    x, w, dy, offsets = _inputs(counts, K, N, card)
    moe_gemm.reset_launch_counts()
    y = moe_gemm.grouped_mm_fwd(x, w, offsets)
    dx = moe_gemm.grouped_mm_dx(dy, w, offsets)
    dw = moe_gemm.grouped_mm_dw(x, dy, offsets)
    torch.cuda.synchronize()
    assert moe_gemm.launches == {"moe_gemm_fwd": 1, "moe_gemm_dx": 1, "moe_gemm_dw": 1}
    _close_bf16(y, moe_gemm.grouped_mm_plain(x, w, offsets))
    _close_bf16(dx, moe_gemm.grouped_mm_dx_plain(dy, w, offsets))
    want = moe_gemm.grouped_mm_dw_plain(x, dy, offsets)
    assert dw.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((dw - want).abs().max()) <= 1e-4 * scale
    # an expert with no rows gets a zero gradient, every entry written
    for e, n in enumerate((offsets[1:] - offsets[:-1]).tolist()):
        if n == 0:
            assert not dw[e].any()


@pytest.mark.cuda
def test_rows_past_a_segment_count_for_nothing(card):
    """Each segment of fwd, dx and dw against its own plain product, held to
    its own largest value, where the next segment's rows are 2^10 times
    larger: a row tile of fwd or dx and the last depth tile of dw that run
    past a segment's end read those rows, which must neither be stored over
    (fwd, dx) nor be added (dw)."""
    counts = [70, 200, 5, 130]
    x, w, dy, offsets = _inputs(counts, 256, 512, card)
    bounds = offsets.tolist()
    x[bounds[1]:bounds[2]] *= 1024
    dy[bounds[1]:bounds[2]] *= 1024
    got = (moe_gemm.grouped_mm_fwd(x, w, offsets), moe_gemm.grouped_mm_dx(dy, w, offsets),
           moe_gemm.grouped_mm_dw(x, dy, offsets))
    want = (moe_gemm.grouped_mm_plain(x, w, offsets),
            moe_gemm.grouped_mm_dx_plain(dy, w, offsets),
            moe_gemm.grouped_mm_dw_plain(x, dy, offsets))
    torch.cuda.synchronize()
    for e, (a, b) in enumerate(zip(bounds, bounds[1:])):
        _close_bf16(got[0][a:b], want[0][a:b])
        _close_bf16(got[1][a:b], want[1][a:b])
        scale = float(want[2][e].abs().max())
        assert float((got[2][e] - want[2][e]).abs().max()) <= 1e-4 * scale, e


@pytest.mark.cuda
def test_two_calls_are_bit_equal(card):
    """No atomics and no split depth: the same inputs give the same bits."""
    x, w, dy, offsets = _inputs(None, 2048, 3584, card)
    first = (moe_gemm.grouped_mm_fwd(x, w, offsets), moe_gemm.grouped_mm_dx(dy, w, offsets),
             moe_gemm.grouped_mm_dw(x, dy, offsets))
    second = (moe_gemm.grouped_mm_fwd(x, w, offsets), moe_gemm.grouped_mm_dx(dy, w, offsets),
              moe_gemm.grouped_mm_dw(x, dy, offsets))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_matches_cpu(card):
    """grouped_mm's forward and backward on the card against the same
    function on the CPU (the plain versions) on the same bf16 inputs."""
    x, w, dy, offsets = _inputs([5, 0, 260, 31], 64, 96, card)
    w32 = w.float()
    outs = {}
    for dev in (card, torch.device("cpu")):
        xd = x.to(dev, copy=True).requires_grad_(True)
        wd = w32.to(dev, copy=True).requires_grad_(True)
        y = moe_gemm.grouped_mm(xd, wd, offsets.to(dev))
        y.backward(dy.to(dev))
        outs[dev.type] = (y.cpu(), xd.grad.cpu(), wd.grad.cpu())
    for got, want in zip(outs["cuda"][:2], outs["cpu"][:2]):
        _close_bf16(got, want)
    assert torch.allclose(outs["cuda"][2], outs["cpu"][2], rtol=0,
                          atol=1e-4 * float(outs["cpu"][2].abs().max()))


@pytest.mark.cuda
def test_expert_layer_has_no_host_sync(card):
    """The dropless layer's forward and backward at the model's widths run
    with torch's sync debug mode set to raise: no .item(), no copy to the
    host, no shape read from the card."""
    gen = torch.Generator(device=card).manual_seed(1)
    d, E, f, n = 2048, 32, 1792, 4096
    h = torch.randn(1, n, d, generator=gen, device=card).bfloat16().requires_grad_(True)
    router = (torch.randn(d, E, generator=gen, device=card) * d ** -0.5).requires_grad_(True)
    gate_up = (torch.randn(E, d, 2 * f, generator=gen, device=card) * d ** -0.5).requires_grad_(True)
    down = (torch.randn(E, f, d, generator=gen, device=card) * f ** -0.5).requires_grad_(True)
    bias = torch.zeros(E, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.moe_topk(h, router, gate_up, down, bias, k=4, layer=None)
        out.float().square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == h.shape and h.grad is not None and down.grad is not None
