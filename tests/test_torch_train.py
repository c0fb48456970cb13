"""pccl_tpu_torch.parallel.train against pccl_tpu.parallel.train on the CPU:
three AdamW steps from the same weights on the same batches.

fp32 compute on both sides. Tolerance: 1e-5 on the losses, and 2e-5 on the
parameters after three steps for all but one in 10^4 of them. Adam moves
each weight by about lr (1e-3 here) a step whatever the size of its
gradient, so a weight whose gradient is as small as the two frameworks'
rounding differences can take a different step; those few are held to the
most three steps can differ by, 2 * lr each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pccl_tpu.models import gpt as jgpt
from pccl_tpu.parallel import mesh as mesh_lib
from pccl_tpu.parallel import train as jtrain
from pccl_tpu_torch.models import convert, gpt
from pccl_tpu_torch.parallel import train

LR = 1e-3


def _batches(cfg, n=3, B=2, T=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32),
             rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("schedule", [False, True])
def test_three_adamw_steps_match_jax(schedule):
    jcfg = jgpt.tiny_config(compute_dtype=jnp.float32)
    tcfg = gpt.tiny_config(compute_dtype=torch.float32)
    mesh = mesh_lib.make_mesh(jax.devices()[:1], ("dp", "tp"), shape=(1, 1))
    jsched = jtrain.cosine_warmup_schedule(LR, 3, 1) if schedule else None
    tsched = train.cosine_warmup_schedule(LR, 3, 1) if schedule else None
    jparams, tx, opt_state = jtrain.make_train_state(
        jax.random.PRNGKey(0), jcfg, mesh, lr=LR, schedule=jsched)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    state = train.make_train_state(
        0, tcfg, "cpu", lr=LR, schedule=tsched,
        params=convert.params_from_numpy(np_params, tcfg, device="cpu"))
    jstep = jtrain.build_train_step(jcfg, tx, mesh)
    tstep = train.build_train_step(tcfg)
    for tok, tgt in _batches(jcfg):
        jparams, opt_state, jloss = jstep(jparams, opt_state, jnp.asarray(tok),
                                          jnp.asarray(tgt))
        loss = tstep(state, torch.from_numpy(tok), torch.from_numpy(tgt))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    got = convert.params_to_numpy(state.params)
    for name, want in jparams.items():
        diff = np.abs(got[name] - np.asarray(want))
        assert np.mean(diff > 2e-5) <= 1e-4, name
        assert diff.max() <= 3 * 2 * LR, name


def test_cosine_schedule_matches_optax():
    for lr, total, warmup, min_lr in ((1e-3, 20, 5, 1e-4), (3e-4, 10, 0, 0.0),
                                      (1e-3, 4, 8, 0.0)):
        want = jtrain.cosine_warmup_schedule(lr, total, warmup, min_lr)
        got = train.cosine_warmup_schedule(lr, total, warmup, min_lr)
        for count in range(total + 5):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"count {count}")


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """A CUDA device is the default; without one the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt.tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.make_train_state(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_numpy(
            {k: np.zeros(s, np.float32) for k, s in gpt.param_shapes(cfg).items()},
            cfg)
