"""FLOP counts against the hand-worked figures, the windowed pair count
against the mask, and the kernels' bounds against chip_smoke.bounds()."""

import json

import pytest
import torch

from portbench import flops, spec


def _config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,layers,seq,gflop", [
    ("gpt2-medium", None, 1024, 2.272),
    # 2 layers: 6 x (2 x 218.1M + the 134.2M head) + 6 x 2 x 32768 x 4096
    ("mistral-7b-v0.3", 2, 32768, 5.033),
    # the file's 6 layers: 6 x (6 x 218.1M + 134.2M) + 6 x 6 x 32768 x 4096
    ("mistral-7b-v0.3", None, 32768, 13.489)])
def test_flops_per_token(name, layers, seq, gflop):
    cfg = _config(name)
    if layers:
        cfg["num_hidden_layers"] = layers
    assert flops.flops_per_token(cfg, seq) / 1e9 == pytest.approx(gflop, abs=5e-4)


def test_matmul_params_gpt2_medium():
    # 24 x 12 d^2 + the tied head d x 50304
    assert spec.family("gpt2").matmul_params(_config("gpt2-medium")) == \
        24 * 12 * 1024 ** 2 + 1024 * 50304


@pytest.mark.parametrize("shape", [(8, 1024, 16, 16, 64), (1, 32768, 32, 8, 128)])
def test_bounds_match_chip_smoke(shape):
    import chip_smoke

    ours = flops.bounds(*shape)
    theirs = chip_smoke.bounds(*shape, True)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert ours[k][0] == pytest.approx(theirs[k][0], rel=1e-12)
        assert ours[k][1] == theirs[k][1]


def test_attn_shape():
    full = dict(causal=True, window=None)
    assert flops.flash_calls(_config("mistral-7b-v0.3"), 1, 32768) == \
        [(6, dict(B=1, T=32768, H=32, Hkv=8, D=128, **full))]
    assert flops.flash_calls(_config("gpt2-medium"), 8, 1024) == \
        [(24, dict(B=8, T=1024, H=16, Hkv=16, D=64, **full))]


@pytest.mark.parametrize("T,window", [(1, 1), (7, 1), (7, 3), (64, 5), (100, 99), (1000, 128)])
def test_visible_pairs_window_counts_the_mask(T, window):
    # a query sees itself and the window - 1 keys before it
    q, k = torch.arange(T)[:, None], torch.arange(T)[None, :]
    assert flops.visible_pairs(T, True, window) == int(((k <= q) & (k > q - window)).sum())
    assert flops.visible_pairs(T, True) == int((k <= q).sum())
    assert flops.visible_pairs(T, False) == T * T


@pytest.mark.parametrize("T", [1, 8, 1024, 32768])
def test_window_at_least_T_is_causal(T):
    for w in (T, T + 1, 4 * T):
        assert flops.visible_pairs(T, True, w) == flops.visible_pairs(T, True)
        assert flops.flash_work(2, T, 4, 2, 64, True, w) == flops.flash_work(2, T, 4, 2, 64)


def test_window_scales_only_the_products():
    full, win = flops.flash_work(1, 8192, 32, 4, 128), flops.flash_work(1, 8192, 32, 4, 128,
                                                                        window=1024)
    share = flops.visible_pairs(8192, True, 1024) / flops.visible_pairs(8192, True)
    for k in full:
        assert win[k][0] == pytest.approx(full[k][0] * share, rel=1e-12)
        assert win[k][1] == full[k][1]
    with pytest.raises(ValueError):
        flops.visible_pairs(8, False, 4)


def test_call_bounds_weigh_shapes_by_layers():
    a = dict(B=1, T=8192, H=32, Hkv=4, D=128, causal=True, window=1024)
    b = dict(a, window=None)
    one = flops.call_bounds([(6, b)])
    mixed = flops.call_bounds([(3, a), (1, b)])
    for k, (ms, _) in flops.bounds(**b).items():
        assert one[k] == ms                  # one shape: its bound exactly
        assert mixed[k] == pytest.approx(0.75 * flops.bounds(**a)[k][0] + 0.25 * ms,
                                         rel=1e-12)
