"""The checkpointing modes of pccl_tpu_torch.models._common.run_blocks
(False, True, "dots", "sqrt") against pccl_tpu.models on the CPU, and what
each mode runs.

Parity: both packages get the same weights (the JAX package's init_params,
carried across by models/convert.py) and the same tokens; fp32 compute;
the JAX side runs its Pallas flash kernels in interpret mode, the torch
side the plain versions behind the same autograd path the kernels use on
the card. n_layer 4 groups "sqrt" as G = 2; n_layer 3 is prime, so "sqrt"
falls back to per-block checkpointing, as JAX's scan_blocks does.
Tolerance: 1e-4 on the loss and the gradients, as the model tests hold
them (magnitudes of order one).

Structure: a remat mode changes what the backward runs again, never the
result, so the counts below are the mode's whole meaning:
- block calls per step: L without remat; 2L with True and "dots" (each
  block's forward again in the backward); for "sqrt" 3L - L/G. The group
  checkpoint's recompute runs blocks 0..G-2 of its group and enters the
  last block's checkpoint only to save that block's input: the group's
  saved tensors are then all there, and torch's early stop
  (torch.utils.checkpoint.set_checkpoint_early_stop, on by default) ends
  the recompute before the last block's forward. Each block's own
  checkpoint then recomputes it once more: L + (L - L/G) + L.
- weight products (aten.mm on activations [B*T, d_in] and a weight
  [d_in, d_out], both contiguous, as a forward product is; a gradient
  product has a transposed operand) run again in the backward under True
  and "sqrt", and never under "dots", which keeps their outputs. Early
  stop shows here too: a block's recompute ends once the tensors its
  backward saved are back, which is before its last product (the residual
  add's backward needs no input, and that product's own backward needs
  only its operands), so a per-block recompute runs P - 1 of the block's
  P products; the group recompute of "sqrt" runs its first G - 1 blocks
  whole.
"""

from functools import partial

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from pccl_tpu.models import _common as jcommon
from pccl_tpu.models import gpt as jgpt
from pccl_tpu.models import llama as jllama
from pccl_tpu.ops import flash_attention as jax_flash
from pccl_tpu_torch.models import _common, convert, gpt, llama
from pccl_tpu_torch.ops.flash_attention import flash_attention

TOL = 1e-4
JAX_ATTN = partial(jax_flash, block_q=32, block_k=32, interpret=True)
MODES = [False, True, "dots", "sqrt"]
FAMILIES = {"gpt": (jgpt, gpt), "llama": (jllama, llama)}
# weight products of one block: GPT qkv, out, mlp in and out; Llama q, kv,
# out, gate, up and down
PRODUCTS = {"gpt": 4, "llama": 6}


def _setup(family, n_layer, seed=1, B=2, T=64):
    jmod, tmod = FAMILIES[family]
    jcfg = jmod.tiny_config(compute_dtype=jnp.float32, n_layer=n_layer)
    tcfg = tmod.tiny_config(compute_dtype=torch.float32, n_layer=n_layer)
    jparams = jmod.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, tcfg, device="cpu")
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tok, tgt


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("remat", MODES, ids=str)
@pytest.mark.parametrize("n_layer", [4, 3])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_loss_and_grads_match_jax(family, n_layer, remat):
    jcfg, tcfg, jp, tp, tok, tgt = _setup(family, n_layer)
    jmod, tmod = FAMILIES[family]
    jloss, jgrads = jax.value_and_grad(jmod.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg, JAX_ATTN, remat)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = tmod.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                        attn_fn=flash_attention, remat=remat)
    loss.backward()
    _close(loss.item(), float(jloss))
    for name in tp:
        _close(tp[name].grad.numpy(), jgrads[name])


def test_sqrt_divisor_is_jaxs():
    for n in list(range(1, 50)) + [97, 100]:
        assert _common._sqrt_divisor(n) == jcommon._sqrt_divisor(n), n


def _expected_block_calls(remat, L):
    G = _common._sqrt_divisor(L)
    if remat == "sqrt" and G > 1:
        return 3 * L - L // G
    return L if not remat else 2 * L


@pytest.mark.parametrize("remat", MODES, ids=str)
@pytest.mark.parametrize("n_layer", [4, 9, 7])
def test_block_calls_per_step(remat, n_layer, monkeypatch):
    """L, 2L, 2L and 3L - L/G (G = 2 at L = 4, 3 at L = 9; 7 is prime, so
    sqrt is True's 2L); the forward alone always L."""
    _, tcfg, _, tp, tok, tgt = _setup("gpt", n_layer, T=32)
    calls = []
    block = gpt.block
    monkeypatch.setattr(gpt, "block", lambda *a, **k: calls.append(1) or block(*a, **k))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss = gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                       attn_fn=flash_attention, remat=remat)
    assert len(calls) == n_layer
    loss.backward()
    assert len(calls) == _expected_block_calls(remat, n_layer)


class _CountWeightProducts(TorchDispatchMode):
    """Counts aten.mm calls shaped as a forward weight product: both operands
    contiguous and the first with `rows` rows."""

    def __init__(self, rows):
        super().__init__()
        self.rows, self.count = rows, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.mm:
            a, b = args[0], args[1]
            if a.shape[0] == self.rows and a.is_contiguous() and b.is_contiguous():
                self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", MODES, ids=str)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dots_recomputes_no_weight_product(family, remat):
    """The weight products that run in the forward and again in the
    backward, counted by a dispatch mode outside the checkpoints (which
    sees only the products a checkpoint really runs, not those it hands
    back from its cache)."""
    L, B, T = 4, 2, 32
    _, tcfg, _, tp, tok, tgt = _setup(family, L, T=T)
    _, tmod = FAMILIES[family]
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    with _CountWeightProducts(B * T) as fwd:
        loss = tmod.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt),
                            tcfg, attn_fn=flash_attention, remat=remat)
    with _CountWeightProducts(B * T) as bwd:
        loss.backward()
    per_block = PRODUCTS[family]
    # the head outside the blocks adds one product: Llama's in the forward,
    # and the tied GPT head's in the backward (its weight is tok_emb
    # transposed, so the forward product has a transposed operand and the
    # cotangent's product g @ tok_emb has none)
    assert fwd.count == L * per_block + (family == "llama")
    G = _common._sqrt_divisor(L)
    again = {False: 0, True: L * (per_block - 1), "dots": 0,
             "sqrt": L * (per_block - 1) + (L - L // G) * per_block}[remat]
    assert bwd.count == again + (family == "gpt")


def test_unknown_remat_mode_raises():
    _, tcfg, _, tp, tok, tgt = _setup("gpt", 2)
    with pytest.raises(ValueError, match="unknown remat mode"):
        gpt.loss_fn(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg,
                    remat="everything")
