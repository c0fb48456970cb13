"""Expert-parallel MoE in the port (ops/moe.py) against the JAX package's
(pccl_tpu/ops/moe.py) on the CPU.

The torch side is one gloo world of 4 spawned ranks (tests/torch_ranks.py):
S=2 expert ranks on a (dp, ep) = (2, 2) mesh, S=4 on (1, 4); each rank
holds B/S batch rows and E/S experts. The JAX side runs here under
shard_map on the virtual CPU devices, on the same numpy weights and
inputs (tests/test_moe.py's sizes: d=32, f=64, B=4, T=16), in fp32.

Tolerances: at capacity_factor = E (no drops) the outputs within 1e-5 of
JAX's moe_mlp_ep and moe_mlp_dense, and each rank's routing (expert, slot)
exactly JAX's `_route` on the same tokens, with the experts those of the
dense routing; the gradients of sum(out²) within 1e-5 (the gate's summed
over the ranks); at a capacity of about 0 most rows are zero, as in JAX;
at cf = 1.0 with a local token count (40) not divisible by E (8), JAX's
per-shard ceiling, the same outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from pccl_tpu.ops import moe as jmoe
from pccl_tpu.parallel import mesh as jmesh
from pccl_tpu_torch.ops import moe

N = 4
CONFIGS = [(2, 4), (4, 4), (4, 8)]


def _setup(E, B=4, T=16, d=32, f=64, seed=0):
    params = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, E)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (B, T, d), jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}, np.asarray(x)


def _inputs():
    out = {"configs": CONFIGS, "grad": _setup(4, B=2, T=8),
           "ragged": _setup(8, B=4, T=40, seed=3)}
    for E in sorted({E for _, E in CONFIGS}):
        out[f"moe_{E}"] = _setup(E)
    return out


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return inputs, torch_ranks.run_world(torch_ranks.moe_cases, inputs,
                                         world=N, timeout=240)


def _ranks(world_results, case):
    return [torch_ranks.result(world_results, case, r) for r in range(N)]


def _ep_rank(r, S):
    return r % S


def _jax_ep(np_params, x, S, cf):
    mesh = jmesh.make_mesh(jax.devices()[:S], ("ep",), (S,))
    params = jmoe.shard_moe_params({k: jnp.asarray(v) for k, v in np_params.items()},
                                   mesh)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ep")))
    fn = jax.jit(lambda xx, pp: jmoe.moe_mlp_ep(
        xx, pp, mesh, capacity_factor=cf, compute_dtype=jnp.float32))
    return mesh, params, xs, fn


def _jax_route(x_local, gate, C):
    dispatch, _ = jmoe._route(jnp.asarray(x_local.reshape(-1, x_local.shape[-1])),
                              jnp.asarray(gate), C)
    flat = np.asarray(dispatch).reshape(dispatch.shape[0], -1)
    hit = flat.sum(-1) > 0
    idx = flat.argmax(-1)
    return np.stack([np.where(hit, idx // C, -1), np.where(hit, idx % C, -1)], -1)


@pytest.mark.parametrize("S,E", CONFIGS)
def test_moe_ep_matches_jax_and_dense(world, S, E):
    inputs, res = world
    np_params, x = inputs[f"moe_{E}"]
    _, params, xs, fn = _jax_ep(np_params, x, S, float(E))
    want = np.asarray(fn(xs, params))
    dense = np.asarray(jmoe.moe_mlp_dense(jnp.asarray(x), np_params,
                                          capacity_factor=float(E),
                                          compute_dtype=jnp.float32))
    b = x.shape[0] // S
    n = b * x.shape[1]
    C = moe.capacity_ep(n, float(E), E)
    dense_experts = np.asarray(jnp.argmax(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, x.shape[-1])) @ np_params["gate"], -1), -1))
    for r, got in enumerate(_ranks(res, f"ep_{S}_{E}")):
        e = _ep_rank(r, S)
        rows = slice(e * b, (e + 1) * b)
        np.testing.assert_allclose(got["out"], want[rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["out"], dense[rows], rtol=1e-5, atol=1e-5)
        route = _jax_route(x[rows], np_params["gate"], C)
        np.testing.assert_array_equal(got["route"], route)
        np.testing.assert_array_equal(got["route"][:, 0],
                                      dense_experts[e * n:(e + 1) * n])


def test_moe_ep_gradients_match_jax(world):
    """grad of sum(out²): the experts' blocks, the gate (summed over the
    expert ranks by copy_to) and the input rows."""
    inputs, res = world
    np_params, x = inputs["grad"]
    mesh, params, xs, _ = _jax_ep(np_params, x, 2, 4.0)

    def loss(p, xx):
        return jnp.sum(jmoe.moe_mlp_ep(xx, p, mesh, capacity_factor=4.0,
                                       compute_dtype=jnp.float32) ** 2)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, xs)
    gp = {k: np.asarray(v) for k, v in gp.items()}
    gx = np.asarray(gx)
    E, S = np_params["gate"].shape[-1], 2
    b, El = x.shape[0] // S, E // S
    for r, got in enumerate(_ranks(res, "grads")):
        e = _ep_rank(r, S)
        g = got["grads"]
        np.testing.assert_allclose(g["gate"], gp["gate"], rtol=1e-5,
                                   atol=1e-5 * np.abs(gp["gate"]).max())
        for k in ("w_in", "w_out"):
            want = gp[k][e * El:(e + 1) * El]
            np.testing.assert_allclose(g[k], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=k)
            assert np.abs(g[k]).sum() > 0
        np.testing.assert_allclose(got["dx"], gx[e * b:(e + 1) * b], rtol=1e-5,
                                   atol=1e-5 * np.abs(gx).max())


def test_moe_capacity_drops_tokens(world):
    """At capacity_factor 0.01 (C=1 a shard) most rows are dropped to zero,
    as JAX's; the outputs equal JAX's."""
    inputs, res = world
    np_params, x = inputs["grad"]
    _, params, xs, fn = _jax_ep(np_params, x, 2, 0.01)
    want = np.asarray(fn(xs, params))
    b = x.shape[0] // 2
    for r, got in enumerate(_ranks(res, "drops")):
        out = got["out"]
        assert np.isfinite(out).all()
        assert (np.abs(out).sum(axis=-1) == 0).mean() >= 0.5
        e = _ep_rank(r, 2)
        np.testing.assert_allclose(out, want[e * b:(e + 1) * b], rtol=1e-5, atol=1e-5)


def test_moe_capacity_ceiling_with_ragged_local_tokens(world):
    """n_local = 40 tokens a rank over E = 8 at cf = 1.0: JAX's per-shard
    capacity is ceil(40 / 8) = 5 (the dense floor over 160 tokens is 20);
    the port takes the same C and drops the same tokens."""
    inputs, res = world
    np_params, x = inputs["ragged"]
    assert moe.capacity_ep(40, 1.0, 8) == 5
    assert moe.capacity_ep(41, 1.0, 8) == 6
    _, params, xs, fn = _jax_ep(np_params, x, 4, 1.0)
    want = np.asarray(fn(xs, params))
    for r, got in enumerate(_ranks(res, "ragged")):
        np.testing.assert_allclose(got["out"], want[r:r + 1], rtol=1e-5, atol=1e-5)
        route = _jax_route(x[r:r + 1], np_params["gate"], 5)
        np.testing.assert_array_equal(got["route"], route)
