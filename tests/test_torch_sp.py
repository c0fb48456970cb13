"""Sequence parallelism in the port (ops/ring_attention.py, parallel/mesh.py,
train.build_train_step(mesh=, seq_axis=)) against the JAX package's on the
CPU: ring attention, the models' forwards with it, and two sharded train
steps.

The torch side is one gloo world of 4 spawned ranks (tests/torch_ranks.py),
which runs every case once for the whole file; each rank holds its block of
the sequence (and of the batch on a dp axis) and hands back its outputs.
The JAX side runs here under shard_map on 4 of the 8 virtual CPU devices,
on the same numpy inputs and weights (models/convert.py).

Tolerances, those of tests/test_attention.py: ring attention 2e-5 against
the JAX ring and dense attention; its gradients 1e-4; the tiny models'
logits 1e-4 in fp32 and 2e-2 in bf16; two AdamW steps 1e-4 on the losses
and the parameters, which are also bitwise equal on every torch rank.
The remat modes' gradients equal remat=False's bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from pccl_tpu.models import gpt as jgpt
from pccl_tpu.models import llama as jllama
from pccl_tpu.ops import reference_attention
from pccl_tpu.ops.ring_attention import make_ring_attn_fn as jring_attn_fn
from pccl_tpu.ops.ring_attention import ring_attention as jring_attention
from pccl_tpu.parallel import mesh as jmesh
from pccl_tpu.parallel import train as jtrain
from pccl_tpu_torch.models import gpt
from pccl_tpu_torch.models._common import rope
from pccl_tpu_torch.parallel import mesh as mesh_lib
from pccl_tpu_torch.parallel import train

N = 4
LR = 1e-3
LAYOUTS = [("2x2", ("dp", "sp"), (2, 2)), ("4x1", ("dp", "sp"), (4, 1)),
           ("default", ("dp", "tp"), None), ("1x2x2", ("a", "b", "c"), (1, 2, 2))]


def _qkv(rng, B=2, T=64, H=4, Hkv=4, Dh=16):
    return tuple(rng.standard_normal((B, T, h, Dh)).astype(np.float32)
                 for h in (H, Hkv, Hkv))


def _jparams(mod, cfg, seed=0):
    return {k: np.asarray(v) for k, v in
            mod.init_params(jax.random.PRNGKey(seed), cfg).items()}


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (2, 64)).astype(np.int32)
    batches = [tuple(rng.integers(0, 512, (2, 64)).astype(np.int32)
                     for _ in range(2)) for _ in range(2)]
    return {
        "layouts": LAYOUTS,
        "qkv": _qkv(rng),
        "gqa": _qkv(rng, Hkv=2),
        "qkv_grad": _qkv(rng, T=32, H=2, Hkv=2, Dh=8),
        "gpt": (_jparams(jgpt, jgpt.tiny_config(block_size=64)), tokens),
        "llama": (_jparams(jllama, jllama.tiny_config(block_size=64)), tokens),
        "train": (_jparams(jgpt, jgpt.tiny_config(), seed=1), batches, LR),
    }


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return inputs, torch_ranks.run_world(torch_ranks.sp_cases, inputs,
                                         world=N, timeout=240)


def _ranks(world_results, case):
    return [torch_ranks.result(world_results, case, r) for r in range(N)]


def _jax_mesh(shape=(1, N)):
    return jmesh.make_mesh(jax.devices()[:N], ("dp", "sp"), shape)


def _blocks(x, shape=(1, N)):
    """The global array's [B/dp, T/sp] block of each rank, in rank order."""
    dp, sp = shape
    nb, nt = x.shape[0] // dp, x.shape[1] // sp
    return [x[(r // sp) * nb:(r // sp + 1) * nb, (r % sp) * nt:(r % sp + 1) * nt]
            for r in range(dp * sp)]


def _jax_ring(q, k, v, shape=(1, N), causal=True):
    mesh = _jax_mesh(shape)
    sh = NamedSharding(mesh, P("dp", "sp"))
    qs, ks, vs = (jax.device_put(jnp.asarray(x), sh) for x in (q, k, v))
    return np.asarray(jax.jit(lambda a, b, c: jring_attention(
        a, b, c, mesh, causal=causal))(qs, ks, vs))


def _check_attn(world_results, case, q, k, v, shape=(1, N), causal=True):
    want = _jax_ring(q, k, v, shape, causal)
    G = q.shape[2] // k.shape[2]
    dense = np.asarray(reference_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=2),
        jnp.repeat(jnp.asarray(v), G, axis=2), causal=causal))
    for got, w, d in zip(_ranks(world_results, case), _blocks(want, shape),
                         _blocks(dense, shape)):
        np.testing.assert_allclose(got, w, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, d, rtol=2e-5, atol=2e-5)


def test_ring_attention_sp4_matches_jax_and_dense(world):
    inputs, res = world
    _check_attn(res, "attn_sp4", *inputs["qkv"])


def test_ring_attention_dp2_sp2(world):
    inputs, res = world
    _check_attn(res, "attn_dp2sp2", *inputs["qkv"], shape=(2, 2))


def test_ring_attention_noncausal(world):
    inputs, res = world
    _check_attn(res, "attn_noncausal", *inputs["qkv"], causal=False)


def test_ring_attention_gqa_rotates_grouped_kv(world):
    inputs, res = world
    _check_attn(res, "attn_gqa", *inputs["gqa"])


def test_ring_attention_grads_match_jax(world):
    inputs, res = world
    q, k, v = (jnp.asarray(x) for x in inputs["qkv_grad"])
    mesh = jmesh.make_mesh(jax.devices()[:N], ("sp",), (N,))

    def loss(q, k, v):
        return jnp.sum(jring_attention(q, k, v, mesh, batch_axis=None) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for r, got in enumerate(_ranks(res, "attn_grads")):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, _blocks(np.asarray(w))[r],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-4), ("bf16", 2e-2)])
def test_gpt_forward_with_ring_attention(world, dtype, tol):
    inputs, res = world
    np_params, tokens = inputs["gpt"]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    cfg = jgpt.tiny_config(block_size=64, compute_dtype=jdt)
    dense = np.asarray(jgpt.forward(np_params, jnp.asarray(tokens), cfg))
    for got, want in zip(_ranks(res, f"gpt_{dtype}"), _blocks(dense)):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_llama_forward_with_ring_attention(world):
    inputs, res = world
    np_params, tokens = inputs["llama"]
    cfg = jllama.tiny_config(block_size=64, compute_dtype=jnp.float32)
    dense = np.asarray(jllama.forward(np_params, jnp.asarray(tokens), cfg))
    for got, want in zip(_ranks(res, "llama_fp32"), _blocks(dense)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sp_train_steps_match_jax(world):
    """Two AdamW steps of build_train_step(mesh, seq_axis="sp") against the
    JAX package's on a 1 x 4 (dp, sp) mesh with its ring attention."""
    inputs, res = world
    np_params, batches, lr = inputs["train"]
    cfg = jgpt.tiny_config(compute_dtype=jnp.float32)
    mesh = _jax_mesh()
    _, tx, _ = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, mesh, lr=lr)
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    opt_state = tx.init(params)
    step = jtrain.build_train_step(cfg, tx, mesh,
                                   attn_fn=jring_attn_fn(mesh),
                                   seq_axis="sp")
    jlosses = []
    for tok, tgt in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tok),
                                       jnp.asarray(tgt))
        jlosses.append(float(loss))
    got = _ranks(res, "train")
    for r in range(N):
        losses, tparams = got[r]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
        for name, want in params.items():
            np.testing.assert_allclose(tparams[name], np.asarray(want),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
            assert np.array_equal(tparams[name], got[0][1][name]), \
                f"rank {r}'s {name} differs from rank 0's"


@pytest.mark.parametrize("mode", ["True", "dots", "sqrt"])
def test_remat_modes_give_the_grads_of_no_remat(world, mode):
    """Under remat the backward replays each block's forward hops; every
    rank replays them in the same order."""
    _, res = world
    for got in _ranks(res, "remat"):
        loss0, grads0 = got["False"]
        loss, grads = got[mode]
        assert loss == loss0
        for name, g in grads0.items():
            np.testing.assert_array_equal(grads[name], g, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_offset_is_a_slice_of_the_full_sequence(dtype):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 48, 4, 16)).astype(np.float32)).to(dtype)
    full = rope(x, 10000.0)
    for a, b in ((0, 16), (16, 32), (8, 48)):
        assert torch.equal(full[:, a:b], rope(x[:, a:b], 10000.0, pos_offset=a))


def test_factor_mesh_matches_jax():
    for n in range(1, 17):
        for n_axes in (1, 2, 3):
            assert mesh_lib.factor_mesh(n, n_axes) == jmesh.factor_mesh(n, n_axes)


def test_make_mesh_layout_matches_jax(world):
    """Rank r sits where the JAX mesh puts device r, for every layout."""
    _, res = world
    got = _ranks(res, "layouts")
    for name, axes, shape in LAYOUTS:
        jm = jmesh.make_mesh(jax.devices()[:N], axes, shape)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(N):
            mshape, coords = got[r][name]
            assert mshape == dict(jm.shape), name
            assert ids[tuple(coords[a] for a in axes)] == r, (name, r)


def _fake_mesh(dp, sp, rank_dp, rank_sp):
    """A Mesh without process groups: enough for what touches no group."""
    return mesh_lib.Mesh(("dp", "sp"), {"dp": dp, "sp": sp},
                         {"dp": rank_dp, "sp": rank_sp}, {})


def test_local_batch_slices_and_offsets():
    tokens = torch.arange(4 * 32).reshape(4, 32)
    block, off = mesh_lib.local_batch(tokens, _fake_mesh(2, 4, 1, 3), "sp")
    assert off == 24 and torch.equal(block, tokens[2:4, 24:32])
    block, off = mesh_lib.local_batch(tokens[None], _fake_mesh(2, 4, 0, 1), "sp")
    assert off == 8 and torch.equal(block, tokens[None, 0:2, 8:16])
    block, off = mesh_lib.local_batch(tokens, _fake_mesh(2, 4, 1, 3))
    assert off == 0 and torch.equal(block, tokens[2:4])
    with pytest.raises(ValueError):
        mesh_lib.local_batch(tokens[:, :30], _fake_mesh(2, 4, 0, 0), "sp")


def test_a_split_sequence_needs_ring_attention():
    cfg = gpt.tiny_config(compute_dtype=torch.float32)
    mesh = _fake_mesh(1, 4, 0, 0)
    with pytest.raises(ValueError, match="make_ring_attn_fn"):
        train.build_loss_and_grad(cfg, mesh=mesh, seq_axis="sp")
    with pytest.raises(ValueError, match="not an axis"):
        train.build_train_step(cfg, mesh=dataclasses.replace(
            mesh, axis_names=("dp",), shape={"dp": 1}), seq_axis="sp")
