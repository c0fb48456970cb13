"""Tensor parallelism in the port (parallel/mesh.py's tp rules and
collectives, models/convert.py's per-head layout, the models' `tp=` path
and train.build_train_step(mesh=) with a "tp" axis) against the JAX
package's GSPMD sharding on the CPU.

The torch side is one gloo world of 4 spawned ranks (tests/torch_ranks.py)
that runs every case once for the whole file; the JAX side runs here on
the 8 virtual CPU devices, on the same numpy weights and tokens.

Tolerances: the tiny GPT's logits at tp=4 within 1e-4 of JAX's
`gpt.forward` in fp32; in bf16, and for the tiny Llama at tp=2 against
JAX with `llama_param_sharding` on a (4, 2) mesh, the bounds of
tests/test_model_llama.py (elementwise 0.1, mean |diff| < 0.03); two AdamW
steps at (dp, tp) = (2, 2) 1e-4 on the losses and the gathered
parameters, with the replicated gains bitwise equal across the ranks. The
tp gradient of tok_emb and of the gains equals the unsharded gradient to
fp32 summation order (1e-5 of its scale: a factor of tp fails).

Where tp is larger than n_kv_head (the tiny Llama's 2 kv heads over
tp=4), ranks share kv heads: the forward at tp=4 against JAX on a (1, 4)
mesh and two AdamW steps there, under the Llama bounds above, with the
ranks that share a kv head holding it bitwise equal. loss_chunk under
tp=4: the loss and the gathered gradients within 1e-4 of JAX's
loss_chunk on a (1, 4) mesh, in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from pccl_tpu.models import gpt as jgpt
from pccl_tpu.models import llama as jllama
from pccl_tpu.parallel import mesh as jmesh
from pccl_tpu.parallel import train as jtrain
from pccl_tpu_torch.models import convert, gpt, llama
from pccl_tpu_torch.parallel import mesh as mesh_lib

N = 4
LR = 1e-3
LAYOUTS = [("2x2", ("dp", "tp"), (2, 2)), ("1x4", ("dp", "tp"), (1, 4)),
           ("default", ("dp", "tp"), None)]


def _jparams(mod, cfg, seed=0):
    return {k: np.asarray(v) for k, v in
            mod.init_params(jax.random.PRNGKey(seed), cfg).items()}


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 64)).astype(np.int32)
    batches = [tuple(rng.integers(0, 512, (4, 64)).astype(np.int32)
                     for _ in range(2)) for _ in range(2)]
    return {
        "layouts": LAYOUTS,
        "gpt": (_jparams(jgpt, jgpt.tiny_config(block_size=64)), tokens),
        "llama": (_jparams(jllama, jllama.tiny_config(block_size=64)), tokens),
        "train_gpt": (_jparams(jgpt, jgpt.tiny_config(), seed=1), batches, LR),
        "train_llama": (_jparams(jllama, jllama.tiny_config(), seed=2), batches, LR),
    }


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    return inputs, torch_ranks.run_world(torch_ranks.tp_cases, inputs,
                                         world=N, timeout=240)


def _ranks(world_results, case):
    return [torch_ranks.result(world_results, case, r) for r in range(N)]


def _coords(rank, shape):
    dp, tp = shape
    return rank // tp, rank % tp


def _assemble(blocks, shape, axis=-1):
    """The global [B, T, V] from each rank's [B/dp, T, V/tp] block."""
    dp, tp = shape
    rows = [np.concatenate([blocks[i * tp + j] for j in range(tp)], axis=axis)
            for i in range(dp)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("family,tp", [("gpt", 2), ("gpt", 4), ("llama", 2),
                                       ("llama", 4)])
def test_shard_gather_round_trip_is_bitwise(world, family, tp):
    """gather_params(shard_params(p)) == p bitwise, and each rank's
    attention block holds whole heads of q, k and v."""
    _, res = world
    got = _ranks(res, f"roundtrip_{family}_{tp}")
    shape = (1, 4) if tp == 4 else (2, 2)
    for r, g in enumerate(got):
        assert g["equal"], r
        t = _coords(r, shape)[1]
        full, local = g["full"], g["local"]
        if family == "gpt":
            d = full["attn_qkv"].shape[1]
            w = d // tp
            want = np.concatenate([full["attn_qkv"][..., s * d + t * w:s * d + (t + 1) * w]
                                   for s in range(3)], -1)
            np.testing.assert_array_equal(local["attn_qkv"], want)
        else:
            kv = full["attn_kv"].shape[-1] // 2
            w = kv // tp
            want = np.concatenate([full["attn_kv"][..., s * kv + t * w:s * kv + (t + 1) * w]
                                   for s in range(2)], -1)
            np.testing.assert_array_equal(local["attn_kv"], want)
        V = full["tok_emb"].shape[0]
        np.testing.assert_array_equal(local["tok_emb"],
                                      full["tok_emb"][t * V // tp:(t + 1) * V // tp])
        np.testing.assert_array_equal(local["ln1_g"], full["ln1_g"])


def test_tp_that_splits_kv_heads_raises():
    """Where neither of tp and n_kv_head divides the other, a rank's q
    heads would read its kv heads in unequal groups: the layout raises.
    So does a tp that does not divide the vocab."""
    with pytest.raises(ValueError, match="n_kv_head"):
        # 3 q heads a rank over kv heads 0, 0, 1 and 1, 2, 2
        convert.tp_layout(llama.tiny_config(n_head=6, n_kv_head=3, n_embd=96), 2)
    with pytest.raises(ValueError, match="vocab_size"):
        convert.tp_layout(gpt.tiny_config(vocab_size=510), 4)


def test_shared_kv_heads_round_trip_is_bitwise(world):
    """The tiny Llama's 2 kv heads over tp=4: ranks 0 and 1 hold k and v
    head 0, ranks 2 and 3 head 1; gather_params(shard_params(p)) == p."""
    _, res = world
    for r, g in enumerate(_ranks(res, "kv_shared_roundtrip")):
        assert g["equal"], r
        full = g["full"]
        kv = full.shape[-1] // 2
        dh = kv // 2
        h = r // 2
        want = np.concatenate([full[..., s * kv + h * dh:s * kv + (h + 1) * dh]
                               for s in range(2)], -1)
        np.testing.assert_array_equal(g["local"], want)


def _jax_1x4(np_params, cfg):
    mesh = jmesh.make_mesh(jax.devices()[:N], ("dp", "tp"), (1, 4))
    sh = jtrain.family(cfg)[1](mesh, cfg)
    return mesh, {k: jax.device_put(jnp.asarray(v), sh[k])
                  for k, v in np_params.items()}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_llama_forward_sharing_kv_heads_at_tp4_matches_jax(world, dtype):
    """GQA at tp=4 over 2 kv heads (1 q head over 1 shared kv head a
    rank) against JAX's forward on a (1, 4) mesh."""
    inputs, res = world
    np_params, tokens = inputs["llama"]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    cfg = jllama.tiny_config(block_size=64, compute_dtype=jdt)
    mesh, params = _jax_1x4(np_params, cfg)
    tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("dp", None)))
    want = np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, cfg))(params, tok))
    got = _assemble(_ranks(res, f"kv_shared_{dtype}"), (1, 4))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0.1, atol=0.1)
        assert np.mean(np.abs(got - want)) < 0.03


def test_llama_train_steps_sharing_kv_heads_at_tp4_match_jax(world):
    """Two AdamW steps at tp=4 over 2 kv heads against JAX's
    build_train_step on a (1, 4) mesh: each shared kv head's gradient is
    the sum over the ranks that hold it, so their copies stay bitwise
    equal and the gathered parameters are JAX's."""
    inputs, res = world
    np_params, batches, lr = inputs["train_llama"]
    cfg = jllama.tiny_config(compute_dtype=jnp.float32)
    mesh, params = _jax_1x4(np_params, cfg)
    _, tx, _ = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, mesh, lr=lr)
    opt_state = tx.init(params)
    step = jtrain.build_train_step(cfg, tx, mesh)
    jlosses = []
    for tok, tgt in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tok),
                                       jnp.asarray(tgt))
        jlosses.append(float(loss))
    got = _ranks(res, "kv_shared_train")
    for r in range(N):
        losses, tparams, kv = got[r]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
        for name, want in params.items():
            np.testing.assert_allclose(tparams[name], np.asarray(want),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        assert np.array_equal(kv, got[r - r % 2][2]), \
            f"rank {r}'s kv block differs from its sharer's"


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_loss_chunk_under_tp_matches_jax(world, family):
    """build_loss_and_grad(loss_chunk=16) at tp=4 (the tied GPT head, and
    the untied Llama head over shared kv heads): the loss and the gathered
    gradients within 1e-4 of JAX's loss_chunk on a (1, 4) mesh."""
    inputs, res = world
    jmod = jgpt if family == "gpt" else jllama
    np_params, batches, _ = inputs[f"train_{family}"]
    cfg = jmod.tiny_config(compute_dtype=jnp.float32)
    _, params = _jax_1x4(np_params, cfg)
    tok, tgt = (jnp.asarray(a) for a in batches[0])
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_fn(p, tok, tgt, cfg, None, False, 16)))(params)
    for loss, grads in _ranks(res, f"chunk_{family}"):
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4, atol=1e-4)
        for name, g in want.items():
            np.testing.assert_allclose(grads[name], np.asarray(g), rtol=1e-4,
                                       atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gpt_forward_at_tp4_matches_jax(world, dtype):
    inputs, res = world
    np_params, tokens = inputs["gpt"]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    cfg = jgpt.tiny_config(block_size=64, compute_dtype=jdt)
    want = np.asarray(jgpt.forward(np_params, jnp.asarray(tokens), cfg))
    got = _assemble(_ranks(res, f"gpt_{dtype}"), (1, 4))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0.1, atol=0.1)
        assert np.mean(np.abs(got - want)) < 0.03


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_llama_forward_at_tp2_matches_jax_sharded(world, dtype):
    """GQA at tp=2 (2 q heads over 1 kv head a rank) against JAX's forward
    with llama_param_sharding on a (4, 2) mesh."""
    inputs, res = world
    np_params, tokens = inputs["llama"]
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    cfg = jllama.tiny_config(block_size=64, compute_dtype=jdt)
    mesh = jmesh.make_mesh(jax.devices()[:8], ("dp", "tp"), (4, 2))
    sh = jmesh.llama_param_sharding(mesh)
    params = {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in np_params.items()}
    tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("dp", None)))
    want = np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, cfg))(params, tok))
    got = _assemble(_ranks(res, f"llama_{dtype}"), (2, 2))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0.1, atol=0.1)
        assert np.mean(np.abs(got - want)) < 0.03


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_train_steps_at_dp2_tp2_match_jax(world, family):
    """Two AdamW steps of build_train_step(mesh) on a (2, 2) (dp, tp)
    mesh against JAX's build_train_step(cfg, tx, mesh) on the same mesh
    shape; the replicated gains stay bitwise equal across the ranks."""
    inputs, res = world
    jmod = jgpt if family == "gpt" else jllama
    np_params, batches, lr = inputs[f"train_{family}"]
    cfg = jmod.tiny_config(compute_dtype=jnp.float32)
    mesh = jmesh.make_mesh(jax.devices()[:N], ("dp", "tp"), (2, 2))
    _, tx, _ = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, mesh, lr=lr)
    sh = jtrain.family(cfg)[1](mesh, cfg)
    params = {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in np_params.items()}
    opt_state = tx.init(params)
    step = jtrain.build_train_step(cfg, tx, mesh)
    jlosses = []
    for tok, tgt in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tok),
                                       jnp.asarray(tgt))
        jlosses.append(float(loss))
    got = _ranks(res, f"train_{family}")
    for r in range(N):
        losses, tparams, gains = got[r]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
        for name, want in params.items():
            np.testing.assert_allclose(tparams[name], np.asarray(want),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        for name, g in gains.items():
            assert np.array_equal(g, got[0][2][name]), \
                f"rank {r}'s {name} differs from rank 0's"


def test_tp_gradients_of_replicated_and_vocab_parallel_params(world):
    """copy_to's and reduce_from's transposes: the tp=4 gradient of tok_emb
    (embedding and tied head, both vocab-parallel) and of the replicated
    gains equals the unsharded gradient; a transpose that scales by tp
    (an all_reduce where the identity belongs) or drops the other ranks'
    part fails by far more than the tolerance."""
    _, res = world
    for got in _ranks(res, "transposes"):
        (loss_f, gf), (loss_t, gt) = got["full"], got["tp"]
        np.testing.assert_allclose(loss_t, loss_f, rtol=1e-6, atol=1e-6)
        for name in gf:
            scale = np.abs(gf[name]).max()
            np.testing.assert_allclose(gt[name], gf[name], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("mode", ["True", "dots", "sqrt"])
def test_remat_under_tp_gives_the_grads_of_no_remat(world, mode):
    """The backward's recompute replays the blocks' tp collectives in one
    order on every rank; the gradients are remat=False's bitwise."""
    _, res = world
    for got in _ranks(res, "remat"):
        loss0, grads0 = got["False"]
        loss, grads = got[mode]
        assert loss == loss0
        for name, g in grads0.items():
            np.testing.assert_array_equal(grads[name], g, err_msg=name)


def test_make_mesh_over_dp_tp_matches_jax(world):
    """Rank r sits where the JAX (dp, tp) mesh puts device r; factor_mesh
    is JAX's."""
    _, res = world
    got = _ranks(res, "layouts")
    for name, axes, shape in LAYOUTS:
        jm = jmesh.make_mesh(jax.devices()[:N], axes, shape)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(N):
            mshape, coords = got[r][name]
            assert mshape == dict(jm.shape), name
            assert ids[tuple(coords[a] for a in axes)] == r, (name, r)
    for n in range(1, 17):
        assert mesh_lib.factor_mesh(n, 2) == jmesh.factor_mesh(n, 2)


def test_specs_are_the_jax_rules():
    """The port's tp rules name the same split dim as JAX's specs."""
    untied = {**jmesh.GPT_PARAM_SPECS, "head": jmesh._GPT_HEAD_SPEC}
    for port, jax_specs in (
            (gpt.tp_specs(gpt.tiny_config(), 1), jmesh.GPT_PARAM_SPECS),
            (gpt.tp_specs(gpt.tiny_config(untie_head=True), 1), untied),
            (llama.tp_specs(llama.tiny_config(), 1), jmesh.LLAMA_PARAM_SPECS)):
        assert set(port) == set(jax_specs)
        for name, spec in port.items():
            assert tuple(spec) == tuple(jax_specs[name]), name


def test_no_tp_group_is_the_unsharded_model():
    """tp=None is the path without the argument, bitwise."""
    cfg = gpt.tiny_config(compute_dtype=torch.bfloat16)
    params = gpt.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(gpt.forward(params, tok, cfg),
                           gpt.forward(params, tok, cfg, tp=None))
