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
from pccl_tpu_torch.models._common import matmul_f32
from pccl_tpu_torch.ops.flash_attention import flash_attention

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


@pytest.mark.parametrize("mode", ["dots", "sqrt"])
def test_unported_remat_modes_raise(mode):
    _, tcfg, _, tp, tok, tgt = _setup()
    with pytest.raises(NotImplementedError):
        gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                    remat=mode)


def test_untied_head_matches_jax():
    jcfg, tcfg, jp, tp, tok, _ = _setup(seed=3, untie_head=True)
    _close(gpt.forward(tp, torch.from_numpy(tok), tcfg).detach().numpy(),
           jgpt.forward(jp, jnp.asarray(tok), jcfg))


def test_numerical_traps_match_jax():
    """gelu is the tanh form; rope rotates two halves (not interleaved) with
    cos/sin in the compute dtype; rmsnorm runs in fp32 with eps 1e-6."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 4, 32).astype(np.float32) * 3
    _close(gpt._rope(torch.from_numpy(x), 10000.0).numpy(),
           jgpt._rope(jnp.asarray(x), 10000.0), 1e-5)
    h = rng.randn(2, 8, 64).astype(np.float32) * 1e-3   # eps matters here
    g = rng.randn(64).astype(np.float32)
    _close(gpt._rmsnorm(torch.from_numpy(h), torch.from_numpy(g)).numpy(),
           jgpt._rmsnorm(jnp.asarray(h), jnp.asarray(g)), 1e-5)
    z = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh").numpy(),
           jax.nn.gelu(jnp.asarray(z)), 1e-6)
    # bf16: rope's tables are cast before the multiply, as in JAX
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    got = gpt._rope(torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
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
