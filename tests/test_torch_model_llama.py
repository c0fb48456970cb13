"""pccl_tpu_torch.models.llama (and the train step and codec over it)
against pccl_tpu.models.llama on the CPU.

Both sides get the same weights (the JAX package's init_params, carried
across by models/convert.py) and the same tokens. fp32 compute; the JAX side
runs its Pallas flash kernels in interpret mode, the torch side the plain
versions behind the same autograd path the kernels use on the card. Two GQA
groupings: G = 2 (tiny: H 4 over Hkv 2) and G = 3 (H 6 over Hkv 2, the
group of Llama-700m). Tolerances: 1e-4 on logits, losses and gradients, as
in the GPT tests, all of magnitudes of order one.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pccl_tpu.models import llama as jllama
from pccl_tpu.ops import flash_attention as jax_flash
from pccl_tpu.parallel import codec as jcodec
from pccl_tpu.parallel import mesh as mesh_lib
from pccl_tpu.parallel import train as jtrain
from pccl_tpu_torch.models import convert, gpt, llama
from pccl_tpu_torch.ops.flash_attention import flash_attention
from pccl_tpu_torch.parallel import codec, train

TOL = 1e-4
LR = 1e-3
JAX_ATTN = partial(jax_flash, block_q=32, block_k=32, interpret=True)
# G = q heads per kv head
GROUPS = {2: {}, 3: dict(n_head=6, n_kv_head=2, n_embd=192)}


def _configs(G=2, **kw):
    kw = {**GROUPS[G], **kw}
    return (jllama.tiny_config(compute_dtype=jnp.float32, **kw),
            llama.tiny_config(compute_dtype=torch.float32, **kw))


def _setup(seed=0, B=2, T=64, G=2, **kw):
    jcfg, tcfg = _configs(G, **kw)
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tparams = convert.params_from_numpy(np_params, tcfg, device="cpu")
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tok, tgt


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("G", [2, 3])
def test_logits_match_jax(G):
    jcfg, tcfg, jp, tp, tok, _ = _setup(G=G)
    assert tcfg.n_head // tcfg.n_kv_head == G
    want = jllama.forward(jp, jnp.asarray(tok), jcfg, attn_fn=JAX_ATTN)
    got = llama.forward(tp, torch.from_numpy(tok), tcfg, attn_fn=flash_attention)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.detach().numpy(), want)
    # the dense attention of the model itself agrees too
    _close(llama.forward(tp, torch.from_numpy(tok), tcfg).detach().numpy(),
           jllama.forward(jp, jnp.asarray(tok), jcfg))


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat, G):
    jcfg, tcfg, jp, tp, tok, tgt = _setup(seed=1, G=G)
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg, JAX_ATTN, remat)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = llama.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                         attn_fn=flash_attention, remat=remat)
    loss.backward()
    _close(loss.item(), float(jloss))
    assert set(tp) == set(jgrads)
    for name in tp:
        _close(tp[name].grad.numpy(), jgrads[name])


def test_chunked_loss_matches_jax():
    jcfg, tcfg, jp, tp, tok, tgt = _setup(seed=2, G=3)
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg, None, False, 16)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = llama.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                         loss_chunk=16)
    loss.backward()
    _close(loss.item(), float(jloss))
    full = llama.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg)
    _close(loss.item(), full.item(), 1e-5)
    for name in tp:
        _close(tp[name].grad.numpy(), jgrads[name])
    with pytest.raises(ValueError, match="must divide"):
        llama.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                      loss_chunk=24)


@pytest.mark.parametrize("G", [2, 3])
def test_bf16_loss_close_to_jax(G):
    """The default compute dtype: bf16 on both sides. The frameworks round
    in different places, so only agreement to bf16 precision is asked: 2e-3
    nats, as for GPT."""
    jcfg = jllama.tiny_config(**GROUPS[G])
    tcfg = llama.tiny_config(**GROUPS[G])
    jp = jllama.init_params(jax.random.PRNGKey(6), jcfg)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tcfg, device="cpu")
    rng = np.random.RandomState(6)
    tok = rng.randint(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    jloss = jllama.loss_fn(jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    loss = llama.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                         attn_fn=flash_attention)
    assert abs(loss.item() - float(jloss)) < 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_equals_mha_with_tiled_kv_weights(dtype):
    """A GQA model equals a full-head model whose k/v projection weights
    are the grouped weights tiled across each head group. A swapped k/v
    split, a wrong head-major reshape or a wrong repeat axis breaks this
    wholesale. fp32: to rounding (1e-5); bf16: the JAX test's bounds."""
    cfg_g = llama.tiny_config(compute_dtype=dtype, **GROUPS[3])
    cfg_f = llama.tiny_config(compute_dtype=dtype, **{**GROUPS[3], "n_kv_head": 6})
    params = llama.init_params(torch.Generator().manual_seed(3), cfg_g)
    H, Hkv, Dh = cfg_g.n_head, cfg_g.n_kv_head, cfg_g.head_dim
    kw, vw = params["attn_kv"].chunk(2, dim=-1)

    def tile(w):  # [L, d, Hkv*Dh] -> [L, d, H*Dh], repeating per head group
        L, d, _ = w.shape
        return w.reshape(L, d, Hkv, Dh).repeat_interleave(H // Hkv, dim=2) \
            .reshape(L, d, H * Dh)

    params_f = dict(params, attn_kv=torch.cat([tile(kw), tile(vw)], -1))
    tok = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg_g.vocab_size, (2, 12)))
    for attn in (None, flash_attention):
        out_g = llama.forward(params, tok, cfg_g, attn_fn=attn).numpy()
        out_f = llama.forward(params_f, tok, cfg_f, attn_fn=attn).numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(out_g, out_f, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(out_g, out_f, rtol=2e-2, atol=2e-2)
            assert np.mean(np.abs(out_g - out_f)) < 1e-3


def test_param_names_and_shapes_match_jax():
    """Every preset, shapes only: jax.eval_shape allocates nothing."""
    assert llama.PRESETS == jllama.PRESETS
    for name in llama.PRESETS:
        jcfg, tcfg = jllama.named_config(name), llama.named_config(name)
        want = jax.eval_shape(lambda: jllama.init_params(jax.random.PRNGKey(0), jcfg))
        assert llama.param_shapes(tcfg) == {k: tuple(v.shape) for k, v in want.items()}
    shapes = llama.param_shapes(llama.named_config("700m"))
    assert sum(int(np.prod(s)) for s in shapes.values()) == 702_359_040
    t = llama.tiny_config()
    assert (t.n_head, t.n_kv_head, t.head_dim) == (4, 2, 32)
    with pytest.raises(ValueError, match="must divide"):
        llama.tiny_config(n_kv_head=3)


def test_codec_order_and_opt_state_leaves_match_optax():
    """One AdamW step on both sides: the flat vector lines up with the JAX
    codec's element for element, and the 23 optimizer leaves (count, mu and
    nu of the 11 parameters) with optax's, in order, shape and dtype."""
    jcfg, tcfg, jp, tp, tok, tgt = _setup(seed=7, G=3, B=2, T=32)
    mesh = mesh_lib.make_mesh(jax.devices()[:1], ("dp", "tp"), shape=(1, 1))
    _, tx, opt_state = jtrain.make_train_state(jax.random.PRNGKey(7), jcfg, mesh,
                                               lr=LR)
    np.testing.assert_array_equal(codec.build_codec(tp).flat(tp).numpy(),
                                  np.asarray(jcodec.build_codec(jp).flat(jp)))
    grads = jax.grad(jllama.loss_fn)(jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    updates, opt_state = tx.update(grads, opt_state, jp)
    jp = optax.apply_updates(jp, updates)
    state = train.make_train_state(0, tcfg, "cpu", lr=LR, params=tp)
    train.build_train_step(tcfg)(state, torch.from_numpy(tok), torch.from_numpy(tgt))
    jleaves = jax.tree.flatten(opt_state)[0]
    leaves = train.opt_state_leaves(state)
    assert len(leaves) == len(jleaves) == 23
    for i, (x, y) in enumerate(zip(leaves, jleaves)):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape and x.numpy().dtype == y.dtype, i
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1e-30),
                                   err_msg=f"leaf {i}")
    np.testing.assert_allclose(codec.build_codec(state.params).flat(state.params).numpy(),
                               np.asarray(jcodec.build_codec(jp).flat(jp)),
                               rtol=0, atol=3 * LR)


def test_three_adamw_steps_match_jax():
    """The train step dispatches on the family: three AdamW steps from the
    same Llama weights on the same batches, fp32, held as test_torch_train
    holds GPT (losses to 1e-5; parameters to 2e-5 for all but one in 10^4
    of them, and at most 2 lr a step). G = 2: Adam moves a weight by about
    lr whatever its gradient, so the weights whose gradients are at the
    frameworks' rounding level take steps that differ, and at G = 3's
    widths there are 0.01-0.06 % of them (measured); G = 3's gradients are
    held to 1e-4 by test_loss_and_grads_match_jax."""
    jcfg, tcfg = _configs(2)
    assert train.family(tcfg) is llama and train.family(gpt.tiny_config()) is gpt
    mesh = mesh_lib.make_mesh(jax.devices()[:1], ("dp", "tp"), shape=(1, 1))
    jparams, tx, opt_state = jtrain.make_train_state(
        jax.random.PRNGKey(0), jcfg, mesh, lr=LR)
    state = train.make_train_state(0, tcfg, "cpu", lr=LR, params=convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, device="cpu"))
    jstep = jtrain.build_train_step(jcfg, tx, mesh)
    tstep = train.build_train_step(tcfg)
    rng = np.random.RandomState(0)
    for _ in range(3):
        tok, tgt = (rng.randint(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
                    for _ in range(2))
        jparams, opt_state, jloss = jstep(jparams, opt_state, jnp.asarray(tok),
                                          jnp.asarray(tgt))
        loss = tstep(state, torch.from_numpy(tok), torch.from_numpy(tgt))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    got = convert.params_to_numpy(state.params)
    for name, want in jparams.items():
        diff = np.abs(got[name] - np.asarray(want))
        assert np.mean(diff > 2e-5) <= 1e-4, name
        assert diff.max() <= 3 * 2 * LR, name


def test_convert_checks_and_roundtrips():
    _, tcfg, jp, tp, _, _ = _setup()
    back = convert.params_to_numpy(tp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    bad = dict(back)
    bad["attn_kv"] = bad["attn_kv"][:, :, :-1]
    with pytest.raises(ValueError, match="attn_kv"):
        convert.params_from_numpy(bad, tcfg, device="cpu")
    gpt_named = dict(back)
    del gpt_named["head"]
    with pytest.raises(ValueError, match="head"):
        convert.params_from_numpy(gpt_named, tcfg, device="cpu")


def test_init_params_statistics():
    """Same distributions as the JAX package (the draws differ)."""
    cfg = llama.named_config("tiny")
    p = llama.init_params(torch.Generator().manual_seed(0), cfg)
    assert abs(p["tok_emb"].std().item() - 0.02) < 2e-3
    assert abs(p["attn_q"].std().item() - 128 ** -0.5) < 5e-3
    assert abs(p["head"].std().item() - 128 ** -0.5) < 5e-3
    assert abs(p["mlp_down"].std().item() - 320 ** -0.5 / 2) < 5e-3
    assert torch.equal(p["ln1_g"], torch.ones(2, 128))
    q = llama.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_causality():
    cfg = llama.tiny_config(**GROUPS[3])
    params = llama.init_params(torch.Generator().manual_seed(0), cfg)
    t1 = torch.zeros((1, 8), dtype=torch.int64)
    t2 = t1.clone()
    t2[0, 7] = 3
    for attn in (None, flash_attention):
        l1 = llama.forward(params, t1, cfg, attn_fn=attn)
        l2 = llama.forward(params, t2, cfg, attn_fn=attn)
        torch.testing.assert_close(l1[0, :7], l2[0, :7], rtol=0, atol=1e-5)
        assert not torch.allclose(l1[0, 7], l2[0, 7])
