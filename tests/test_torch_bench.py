"""The port's benchmarks (pccl_tpu_torch.benchmarks) against the JAX
package's (pccl_tpu.benchmarks) on the CPU.

model_bench: flops_per_token, the MFU numerator, equals the JAX function's
for every preset of both families; the peak table knows the H100 SXM by
name; run_cuda_train_bench returns the JAX dict's keys (plus `launches`
and `peak_mib`) at a small size. hash_bench: the port's device digest
equals the JAX package's device digest and its numpy twin on the same
bytes, and the bench holds its own staging parity. The default device is
the card: without one every entry point raises.
"""

import math
import re

import numpy as np
import pytest
import torch

from pccl_tpu.benchmarks import model_bench as jax_mb
from pccl_tpu.models import gpt as jax_gpt
from pccl_tpu.models import llama as jax_llama
from pccl_tpu_torch.benchmarks import bench, hash_bench, model_bench
from pccl_tpu_torch.models import gpt, llama

FLOPS_CASES = [(fam, preset, seq)
               for fam, mod in (("gpt", gpt), ("llama", llama))
               for preset in mod.PRESETS for seq in (64, 1024, 2048)]
JAX_KEYS = {"stall_windows", "config", "tokens_s", "tokens_s_min",
            "tokens_s_max", "step_s", "model_tflops_per_step", "mfu",
            "loss_first", "loss_last"}


def test_presets_match_jax():
    assert gpt.PRESETS == jax_gpt.PRESETS
    assert llama.PRESETS == jax_llama.PRESETS


@pytest.mark.parametrize("family,preset,seq", FLOPS_CASES,
                         ids=[f"{f}-{p}-{s}" for f, p, s in FLOPS_CASES])
def test_flops_per_token_matches_jax(family, preset, seq):
    port = model_bench.flops_per_token(
        model_bench._named_config(family, preset, seq), seq)
    ref = jax_mb.flops_per_token(jax_mb._named_config(family, preset, seq), seq)
    assert port == ref


def test_peak_tflops():
    assert model_bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    with pytest.raises(ValueError):
        model_bench.peak_tflops("NVIDIA GeForce RTX 3090")
    with pytest.raises(ValueError):
        model_bench.peak_tflops("cpu")


@pytest.mark.parametrize("family,preset", [("gpt", "nano"), ("gpt", "tiny"),
                                           ("llama", "nano"), ("llama", "tiny")])
def test_train_bench_on_cpu(family, preset):
    B, T = 2, 64
    r = model_bench.run_cuda_train_bench(family, preset=preset, batch=B, seq=T,
                                         windows=2, steps_per_window=2,
                                         device="cpu")
    assert set(r) == JAX_KEYS | {"launches", "peak_mib"}
    assert math.isclose(r["tokens_s"] * r["step_s"], B * T, rel_tol=1e-6)
    assert r["tokens_s_min"] <= r["tokens_s"] <= r["tokens_s_max"]
    assert 0 <= r["stall_windows"] < 2   # the best window is always kept
    assert math.isfinite(r["loss_first"]) and math.isfinite(r["loss_last"])
    assert r["mfu"] is None and r["peak_mib"] is None   # no peak on a CPU
    # on the CPU the flash op takes its plain versions: no kernel launches
    assert r["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert re.fullmatch(rf"{family}/{preset} b{B}x{T} flash \(cpu\)", r["config"])
    cfg = model_bench._named_config(family, preset, T)
    assert r["model_tflops_per_step"] == \
        model_bench.flops_per_token(cfg, T) * B * T / 1e12


def test_train_bench_config_string():
    """The config string follows the JAX format for remat, the chunked CE
    and the repeat_kv ablation."""
    r = model_bench.run_cuda_train_bench("llama", preset="nano", batch=1, seq=64,
                                         windows=1, steps_per_window=1,
                                         remat=True, loss_chunk=32,
                                         repeat_kv=True, device="cpu")
    assert r["config"] == "llama/nano b1x64 flash+remat+ce:32+repeatkv (cpu)"
    assert math.isfinite(r["loss_last"])


def test_main_arguments_match_jax():
    fam, kw = model_bench._parse_args(["llama", "batch=1", "seq=8192",
                                       "use_flash=1", "remat=1",
                                       "loss_chunk=2048", "repeat_kv=1"])
    assert fam == "llama"
    assert kw == dict(batch=1, seq=8192, use_flash=True, remat=True,
                      loss_chunk=2048, repeat_kv=True)
    assert model_bench._parse_args(["gpt", "remat=dots", "device=cpu"])[1] == \
        dict(remat="dots", device="cpu")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError):
        model_bench.run_cuda_train_bench("gpt", preset="nano", batch=1, seq=64)
    with pytest.raises(RuntimeError):
        hash_bench.run_hash_bench(sizes_mb=(1,))
    with pytest.raises(RuntimeError):
        bench.main(["--fast"])


def test_hash_bench_on_cpu():
    r = hash_bench.run_hash_bench(sizes_mb=(1, 4), device="cpu")
    assert set(r) == {"devhash_1mb_s", "stagehash_1mb_s", "devhash_4mb_s",
                      "stagehash_4mb_s", "h1_launches"}
    assert all(v >= 0 for v in r.values())
    assert r["h1_launches"] == 0        # the CPU takes H1's plain version


@pytest.mark.parametrize("nbytes,dtype", [(1 << 20, np.float32),
                                          (4 << 20, np.float32),
                                          ((1 << 20) + 7, np.uint8)])
def test_hash_digest_matches_jax(nbytes, dtype):
    import jax.numpy as jnp

    from pccl_tpu.ops import hashing as jax_hashing
    from pccl_tpu_torch.ops import hashing

    rng = np.random.default_rng(nbytes)
    x = rng.integers(0, 256, nbytes, dtype=np.uint8).view(dtype)
    port = hashing.torch_simplehash_device(torch.from_numpy(x.copy()))
    assert port == jax_hashing.jax_simplehash_device(jnp.asarray(x))
    assert port == jax_hashing.simplehash_tpu(x)
