"""GPipe pipeline parallelism in the port (parallel/pipeline.py) against
the JAX package's (pccl_tpu/parallel/pipeline.py) on the CPU.

The torch side is one gloo world of 4 spawned ranks (tests/torch_ranks.py):
S=2 stages on a (dp, pp) = (2, 2) mesh, S=4 on (1, 4); the JAX side runs
here under shard_map on the virtual CPU devices, on the same numpy weights
(the config of tests/test_pipeline.py: 4 layers, d=32, 2 heads, vocab
128). Tolerances: the pipelined logits within 1e-4 of JAX's pipelined
forward in fp32 and within JAX's own 2e-2 in bf16; the gradients of the
mean CE at S=2 within 1e-4 of JAX's pipelined and dense gradients in fp32
(a wrong transpose of the replicated input or output scales tok_emb's by
S or drops a stage).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from pccl_tpu.models import gpt as jgpt
from pccl_tpu.parallel import mesh as jmesh
from pccl_tpu.parallel import pipeline as jpipeline

N = 4
CFG = dict(n_layer=4, n_head=2, n_embd=32, block_size=32, vocab_size=128)
SCHEDULES = [(2, 2), (4, 4), (4, 2)]


def _cfg(dtype):
    return jgpt.tiny_config(**CFG, compute_dtype=dtype)


def _inputs():
    params = {k: np.asarray(v) for k, v in
              jgpt.init_params(jax.random.PRNGKey(0), _cfg(jnp.float32)).items()}
    rng = np.random.default_rng(1)
    return {"cfg": CFG, "schedules": SCHEDULES,
            "fwd": (params, rng.integers(0, 128, (4, 32)).astype(np.int32)),
            "grad": (params, rng.integers(0, 128, (2, 16)).astype(np.int32))}


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return inputs, torch_ranks.run_world(torch_ranks.pp_cases, inputs,
                                         world=N, timeout=240)


def _ranks(world_results, case):
    return [torch_ranks.result(world_results, case, r) for r in range(N)]


def _jax_setup(np_params, S, dtype):
    mesh = jmesh.make_mesh(jax.devices()[:S], ("pp",), (S,))
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    params = {**params, **jpipeline.shard_layer_params(
        {k: params[k] for k in jgpt._LAYER_KEYS}, mesh)}
    return mesh, _cfg(dtype), params


@pytest.mark.parametrize("S,M", SCHEDULES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pipelined_forward_matches_jax(world, S, M, dtype):
    inputs, res = world
    np_params, tokens = inputs["fwd"]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    mesh, cfg, params = _jax_setup(np_params, S, jdt)
    fwd = jpipeline.build_pipelined_forward(cfg, mesh, microbatches=M)
    want = np.asarray(jax.jit(fwd)(params, jnp.asarray(tokens)))
    tol = 1e-4 if dtype == "fp32" else 2e-2
    for got in _ranks(res, f"fwd_{S}_{M}_{dtype}"):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_pipelined_gradients_match_jax_and_dense(world):
    inputs, res = world
    np_params, tokens = inputs["grad"]
    mesh, cfg, params = _jax_setup(np_params, 2, jnp.float32)
    tok = jnp.asarray(tokens)
    fwd = jpipeline.build_pipelined_forward(cfg, mesh)

    def loss_piped(p):
        logp = jax.nn.log_softmax(fwd(p, tok), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tok[..., None], axis=-1)[..., 0])

    g_piped = jax.jit(jax.grad(loss_piped))(params)
    dense_p = {k: jnp.asarray(v) for k, v in np_params.items()}
    g_dense = jax.grad(lambda p: jgpt.loss_fn(p, tok, tok, cfg))(dense_p)
    want_loss = float(loss_piped(params))
    for loss, grads in _ranks(res, "grads"):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
        for name, g in grads.items():
            for ref in (g_piped, g_dense):
                np.testing.assert_allclose(g, np.asarray(ref[name]), rtol=1e-4,
                                           atol=1e-4, err_msg=name)
