"""pccl_tpu_torch.models.gpt against pccl_tpu.models.gpt on the CPU.

Both sides get the same weights (the JAX package's init_params, carried
across by models/convert.py) and the same tokens. fp32 compute; the JAX side
runs its Pallas flash kernels in interpret mode, the torch side the plain
versions behind the same autograd path the kernels use on the card.
Tolerances: 1e-4 on logits and losses, 1e-4 on gradients (the JAX package's
kernel tolerance), both relative to magnitudes of order one.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pccl_tpu.models import gpt as jgpt
from pccl_tpu.ops import flash_attention as jax_flash
from pccl_tpu_torch.models import convert, gpt
from pccl_tpu_torch.models._common import matmul_f32, rmsnorm, rope
from pccl_tpu_torch.ops.flash_attention import flash_attention
from pccl_tpu_torch.parallel import pipeline, train
from torch_layer_views import edges_into, indexed_hidden

TOL = 1e-4
JAX_ATTN = partial(jax_flash, block_q=32, block_k=32, interpret=True)


def _configs(**kw):
    return (jgpt.tiny_config(compute_dtype=jnp.float32, **kw),
            gpt.tiny_config(compute_dtype=torch.float32, **kw))


def _setup(seed=0, B=2, T=64, **kw):
    jcfg, tcfg = _configs(**kw)
    jparams = jgpt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = convert.params_from_numpy(np_params, tcfg, device="cpu")
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tok, tgt


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_logits_match_jax():
    jcfg, tcfg, jp, tp, tok, _ = _setup()
    want = jgpt.forward(jp, jnp.asarray(tok), jcfg, attn_fn=JAX_ATTN)
    got = gpt.forward(tp, torch.from_numpy(tok), tcfg, attn_fn=flash_attention)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.detach().numpy(), want)
    # the dense attention of the model itself agrees too
    _close(gpt.forward(tp, torch.from_numpy(tok), tcfg).detach().numpy(),
           jgpt.forward(jp, jnp.asarray(tok), jcfg))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jcfg, tcfg, jp, tp, tok, tgt = _setup(seed=1)
    jloss, jgrads = jax.value_and_grad(jgpt.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg, JAX_ATTN, remat)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                       attn_fn=flash_attention, remat=remat)
    loss.backward()
    _close(loss.item(), float(jloss))
    for name in tp:
        _close(tp[name].grad.numpy(), jgrads[name])


def test_chunked_loss_matches_jax():
    jcfg, tcfg, jp, tp, tok, tgt = _setup(seed=2)
    jloss, jgrads = jax.value_and_grad(jgpt.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg, None, False, 16)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                       loss_chunk=16)
    loss.backward()
    _close(loss.item(), float(jloss))
    full = gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg)
    _close(loss.item(), full.item(), 1e-5)
    for name in tp:
        _close(tp[name].grad.numpy(), jgrads[name])


def test_loss_chunk_must_divide():
    _, tcfg, _, tp, tok, tgt = _setup()
    with pytest.raises(ValueError, match="must divide"):
        gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                    loss_chunk=24)


def test_untied_head_matches_jax():
    jcfg, tcfg, jp, tp, tok, _ = _setup(seed=3, untie_head=True)
    _close(gpt.forward(tp, torch.from_numpy(tok), tcfg).detach().numpy(),
           jgpt.forward(jp, jnp.asarray(tok), jcfg))


def test_numerical_traps_match_jax():
    """gelu is the tanh form; rope rotates two halves (not interleaved) with
    cos/sin in the compute dtype; rmsnorm runs in fp32 with eps 1e-6."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 4, 32).astype(np.float32) * 3
    _close(rope(torch.from_numpy(x), 10000.0).numpy(),
           jgpt._rope(jnp.asarray(x), 10000.0), 1e-5)
    h = rng.randn(2, 8, 64).astype(np.float32) * 1e-3   # eps matters here
    g = rng.randn(64).astype(np.float32)
    _close(rmsnorm(torch.from_numpy(h), torch.from_numpy(g)).numpy(),
           jgpt._rmsnorm(jnp.asarray(h), jnp.asarray(g)), 1e-5)
    z = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh").numpy(),
           jax.nn.gelu(jnp.asarray(z)), 1e-6)
    # bf16: rope's tables are cast before the multiply, as in JAX
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    got = rope(torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
               10000.0)
    _close(got.float().numpy(), jgpt._rope(xb, 10000.0).astype(jnp.float32), 1e-2)


def test_tied_head_has_fp32_output_from_bf16_operands():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 5, 16).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(16, 40).astype(np.float32))
    out = matmul_f32(x, w)
    assert out.dtype == torch.float32
    exact = x.double() @ w.to(torch.bfloat16).double()
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=1e-6, atol=1e-5)
    want = jnp.matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                      jnp.asarray(w.numpy()).astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    _close(out.numpy(), want, 1e-5)


def test_bf16_loss_close_to_jax():
    """The default compute dtype: bf16 on both sides. The frameworks round
    in different places, so only agreement to bf16 precision is asked: 2e-3
    nats, a few times the 3e-4 by which they differ on the CPU."""
    jcfg, tcfg = jgpt.tiny_config(), gpt.tiny_config()
    jp = jgpt.init_params(jax.random.PRNGKey(6), jcfg)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tcfg, device="cpu")
    rng = np.random.RandomState(6)
    tok = rng.randint(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    jloss = jgpt.loss_fn(jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    loss = gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                       attn_fn=flash_attention)
    assert abs(loss.item() - float(jloss)) < 2e-3


def test_param_names_and_shapes_match_jax():
    for name, kw in (("tiny", {}), ("gpt2", {}), ("nano", {"untie_head": True})):
        jcfg = jgpt.named_config(name, **kw)
        tcfg = gpt.named_config(name, **kw)
        want = jax.eval_shape(lambda: jgpt.init_params(jax.random.PRNGKey(0), jcfg))
        assert gpt.param_shapes(tcfg) == {k: tuple(v.shape) for k, v in want.items()}
    assert gpt.PRESETS == jgpt.PRESETS


def test_convert_checks_and_roundtrips():
    _, tcfg, jp, tp, _, _ = _setup()
    back = convert.params_to_numpy(tp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    bad = dict(back)
    bad["attn_qkv"] = bad["attn_qkv"][:, :, :-1]
    with pytest.raises(ValueError, match="attn_qkv"):
        convert.params_from_numpy(bad, tcfg, device="cpu")
    missing = dict(back)
    del missing["lnf_g"]
    with pytest.raises(ValueError, match="lnf_g"):
        convert.params_from_numpy(missing, tcfg, device="cpu")


def test_init_params_statistics():
    """Same distributions as the JAX package (the draws differ)."""
    cfg = gpt.named_config("tiny")
    p = gpt.init_params(torch.Generator().manual_seed(0), cfg)
    assert abs(p["tok_emb"].std().item() - 0.02) < 2e-3
    assert abs(p["attn_qkv"].std().item() - 128 ** -0.5) < 5e-3
    assert torch.equal(p["ln1_g"], torch.ones(2, 128))
    q = gpt.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(p[k], q[k]) for k in p)


# ------------------------------------------------ the stacked leaves' views

MODES = [False, True, "dots", "sqrt"]


def _small(dtype=torch.float32):
    return gpt.tiny_config(n_layer=4, n_head=2, n_embd=32, vocab_size=64,
                           block_size=16, compute_dtype=dtype)


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("remat", MODES, ids=str)
def test_layer_views_keep_the_indexed_gradients(remat, dtype, accum_steps,
                                                monkeypatch):
    """One train step with each leaf unbound once per forward gives every
    leaf's .grad, and the updated parameters, bitwise equal to the step
    that indexed each layer's slice inside its block."""
    cfg = _small(dtype)
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (accum_steps, 2, 16), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (accum_steps, 2, 16), generator=g)
    if accum_steps == 1:
        tok, tgt = tok[0], tgt[0]
    step = train.build_train_step(cfg, attn_fn=flash_attention, remat=remat,
                                  accum_steps=accum_steps)
    states = []
    for hidden in (gpt.hidden, indexed_hidden(gpt)):
        monkeypatch.setattr(gpt, "hidden", hidden)
        state = train.make_train_state(0, cfg, device="cpu")
        step(state, tok, tgt)
        states.append(state.params)
    views, indexed = states
    for name in gpt.param_shapes(cfg):
        assert views[name].grad.abs().sum() > 0, name
        assert torch.equal(views[name].grad, indexed[name].grad), name
        assert torch.equal(views[name], indexed[name]), name


@pytest.mark.parametrize("remat", MODES, ids=str)
def test_one_unbind_reaches_each_stacked_leaf(remat):
    """The only node with an edge into a stacked leaf's AccumulateGrad is
    one UnbindBackward0; the indexed forward, the control, had n_layer
    SelectBackward0 there."""
    cfg = _small()
    params = {k: v.requires_grad_(True) for k, v in
              gpt.init_params(torch.Generator().manual_seed(0), cfg).items()}
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    stacked = {k: params[k] for k in gpt.LAYER_KEYS}
    assert set(stacked) == {k for k, s in gpt.param_shapes(cfg).items()
                            if len(s) > 1 and s[0] == cfg.n_layer}
    loss = gpt.loss_fn(params, tok, tok, cfg, remat=remat)
    assert edges_into(loss, stacked) == \
        {k: {"UnbindBackward0": 1} for k in stacked}
    x = indexed_hidden(gpt)(params, tok, cfg, remat=remat)
    assert edges_into(x.sum(), stacked) == \
        {k: {"SelectBackward0": cfg.n_layer} for k in stacked}


def test_one_unbind_reaches_each_stage_leaf():
    """One pipeline stage's local stack (2 of the stage's layers): the
    same, with one unbind per call."""
    cfg = _small()
    full = gpt.init_params(torch.Generator().manual_seed(0), cfg)
    local = {k: full[k][:2].clone().requires_grad_(True)
             for k in gpt.LAYER_KEYS}
    x = torch.randn(2, 16, cfg.n_embd, generator=torch.Generator().manual_seed(1))
    out = pipeline._run_local_stack(local, x, cfg, flash_attention)
    assert edges_into(out.square().mean(), local) == \
        {k: {"UnbindBackward0": 1} for k in local}
    out = pipeline._run_local_stack(local, out, cfg, None)
    assert edges_into(out.square().mean(), local) == \
        {k: {"UnbindBackward0": 2} for k in local}
