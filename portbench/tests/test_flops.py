"""FLOP counts against the hand-worked figures, and the kernels' bounds
against chip_smoke.bounds()."""

import json

import pytest

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
    assert flops.matmul_params(_config("gpt2-medium")) == 24 * 12 * 1024 ** 2 + 1024 * 50304


@pytest.mark.parametrize("shape", [(8, 1024, 16, 16, 64), (1, 32768, 32, 8, 128)])
def test_bounds_match_chip_smoke(shape):
    import chip_smoke

    ours = flops.bounds(*shape)
    theirs = chip_smoke.bounds(*shape, True)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert ours[k][0] == pytest.approx(theirs[k][0], rel=1e-12)
        assert ours[k][1] == theirs[k][1]


def test_attn_shape():
    assert flops.attn_shape(_config("mistral-7b-v0.3"), 1, 32768) == (1, 32768, 32, 8, 128)
    assert flops.attn_shape(_config("gpt2-medium"), 8, 1024) == (8, 1024, 16, 16, 64)
