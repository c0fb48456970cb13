"""The port's int8 ring all-reduce and local_mean over torch.distributed
against the JAX package's (pccl_tpu/ops/quantized_collectives.py,
pccl_tpu/parallel/hierarchical.py:local_mean) on the CPU.

The torch side is one gloo world of 4 spawned ranks (tests/torch_ranks.py),
which runs every case once for the whole file; the JAX side runs here under
shard_map on 4 of the 8 virtual CPU devices, on the same numpy inputs.

Tolerances: the quantized ring is bitwise equal across the torch ranks,
and its error against the exact sum is held to the JAX test's bound of 16
int8 steps of max|x|. The codec is bitwise equal to JAX's run op by op
(both divide in fp32 and round half to even). Under jit, XLA's CPU backend
rewrites the division by 127 into a product with 1/127 and fuses the
dequantizing product with the add, so a scale or a sum can differ from the
port's in its last bit (about a third of the elements of the 4-rank ring
differ by one ulp); the ring is therefore held to the jitted JAX ring within
one final quantization step (max|result| / 127), as the ranks' results are
held bitwise to each other. local_mean to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_ranks
from pccl_tpu.ops import quantized_collectives as jq
from pccl_tpu.ops.quantized_collectives import (quantized_pmean,
                                                quantized_ring_all_reduce)
from pccl_tpu.parallel.hierarchical import local_mean
from pccl_tpu_torch.ops import quantized_collectives as tq

N = 4


def _inputs():
    rng = np.random.default_rng(3)
    constant = np.stack([np.full(2048, 127.0 * (r + 1), dtype=np.float32)
                         for r in range(N)])
    constant[3] *= -1.0  # sign coverage
    return {
        "random": rng.standard_normal((N, 3 * 1024 + 111)).astype(np.float32),
        "constant": constant,
        "tree_w": rng.standard_normal((N, 512)).astype(np.float32),
        # bf16-representable values: the torch ranks cast them to bf16
        "tree_b": np.asarray(jnp.asarray(
            rng.standard_normal((N, 64)), jnp.bfloat16).astype(jnp.float32)),
        "local": rng.standard_normal((N * 8, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return inputs, torch_ranks.run_world(torch_ranks.quantized_cases, inputs,
                                         world=N, timeout=180)


def _jax_ring(x, fn):
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("dp"),
                                 out_specs=P("dp")))(x)


def _ranks(world_results, case):
    return [torch_ranks.result(world_results, case, r) for r in range(N)]


def test_quantized_ring_matches_jax_and_is_bitwise_across_ranks(world):
    inputs, res = world
    x = inputs["random"]
    got = _ranks(res, "random")
    for r in range(1, N):
        assert np.array_equal(got[0], got[r]), f"rank {r} diverged"
    want = np.asarray(_jax_ring(
        x[:, None, :], lambda s: quantized_ring_all_reduce(s[0], "dp")[None]))
    for r in range(N):
        np.testing.assert_allclose(got[0], want[r, 0], rtol=0,
                                   atol=np.abs(want).max() / 127.0)
    scale = np.abs(x).max() / 127.0
    assert np.abs(got[0] - x.sum(axis=0)).max() <= 16 * scale


def test_codec_matches_jax_bitwise():
    """_quantize_block, _dequantize_block and the reduce-scatter's
    dequantize-and-add against the JAX package's, op by op (no jit)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(64 * 256) * 3).astype(np.float32)
    x[:256] = 0.0                       # an all-zero block takes scale 1
    x[256:512] = 2.5                    # ties round half to even
    mine = rng.standard_normal(x.size).astype(np.float32)
    with jax.disable_jit():
        qj, sj = jq._quantize_block(jnp.asarray(x), 256)
        aj = jq._dequantize_block(qj, sj, 256) + jnp.asarray(mine)
    qt, st = tq._quantize_block(torch.from_numpy(x), 256)
    at = tq._dequantize_block(qt, st, 256) + torch.from_numpy(mine)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_quantized_ring_exact_on_constant_blocks(world):
    """Multiples of 127 keep every scale an exact fp32 integer at every
    hop, so the constants come through exactly."""
    inputs, res = world
    for got in _ranks(res, "constant"):
        np.testing.assert_array_equal(got, inputs["constant"].sum(axis=0))


def test_quantized_pmean_tree_keeps_dtypes(world):
    inputs, res = world
    jtree = {"w": jnp.asarray(inputs["tree_w"]),
             "b": jnp.asarray(inputs["tree_b"], jnp.bfloat16)}
    want = _jax_ring(jtree, lambda t: quantized_pmean(
        jax.tree.map(lambda a: a.reshape(-1), t), "dp"))
    shapes = {"w": (512,), "b": (64,)}
    got = _ranks(res, "tree")
    for r in range(N):
        assert got[r]["w"][:2] == ("torch.float32", shapes["w"])
        assert got[r]["b"][:2] == ("torch.bfloat16", shapes["b"])
        for k in ("w", "b"):
            assert np.array_equal(got[r][k][2], got[0][k][2])
            w = np.asarray(want[k].astype(jnp.float32)).reshape(N, -1)[r]
            # one final step, and a bf16 rounding of the bf16 leaf
            np.testing.assert_allclose(got[r][k][2], w, rtol=2 ** -8,
                                       atol=np.abs(w).max() / 127.0)


def test_quantized_ring_single_rank_group_is_identity(world):
    inputs, res = world
    for r, got in enumerate(_ranks(res, "single")):
        np.testing.assert_array_equal(got, inputs["random"][r])


def test_local_mean_matches_jax(world):
    inputs, res = world
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    want = np.asarray(local_mean(jnp.asarray(inputs["local"]), mesh, axis="dp"))
    assert want.shape == (8, 3)
    for got in _ranks(res, "local_mean"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_local_mean_over_two_axes_matches_jax(world):
    """local_mean over (dp, sp) of a 2 x 2 mesh is the mean over all four
    ranks: JAX's local_mean over a 4-device axis."""
    inputs, res = world
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    want = np.asarray(local_mean(jnp.asarray(inputs["local"]), mesh, axis="dp"))
    got = _ranks(res, "local_mean_2d")
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g, got[0])
