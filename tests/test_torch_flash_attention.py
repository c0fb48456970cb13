"""pccl_tpu_torch.ops.flash_attention against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

Same inputs (numpy, from a seed) on both sides, fp32, T=128 with 32-row
blocks on the JAX side. Tolerances are the JAX package's own for its
kernels against its dense reference (tests/test_attention.py): 2e-5 on the
forward, 1e-4 on gradients.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pccl_tpu_torch.ops import flash_attention as tfa

# the package's __init__ re-exports the function under the module's name
jfa = importlib.import_module("pccl_tpu.ops.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
CASES = [pytest.param(causal, hkv, id=f"{'causal' if causal else 'full'}-"
                      f"{'mha' if hkv == 4 else 'gqa'}")
         for causal in (True, False) for hkv in (4, 2)]


def _inputs(hkv, B=1, T=128, H=4, Dh=16, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, Dh).astype(np.float32)
    k = rng.randn(B, T, hkv, Dh).astype(np.float32)
    v = rng.randn(B, T, hkv, Dh).astype(np.float32)
    w_out = rng.randn(B, T, H, Dh).astype(np.float32)
    w_lse = rng.randn(B, H, T).astype(np.float32)
    return q, k, v, w_out, w_lse


def _t(*arrs, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrs]


def _jax_flash(causal):
    return lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, block_q=32,
                                               block_k=32, interpret=True)


def _jax_flash_lse(causal):
    return lambda q, k, v: jfa.flash_attention_with_lse(q, k, v, causal, 32, 32, True)


@pytest.mark.parametrize("causal,hkv", CASES)
def test_forward_matches_pallas(causal, hkv):
    """K1's plain version and the autograd path: out and lse."""
    q, k, v, _, _ = _inputs(hkv)
    j_out, j_lse = _jax_flash_lse(causal)(q, k, v)
    qt, kt, vt = _t(q, k, v)
    p_out, p_lse = tfa.flash_fwd_plain(qt, kt, vt, causal)
    a_out, a_lse = tfa.flash_attention_with_lse(qt, kt, vt, causal)
    for got in (p_out, a_out, tfa.flash_attention(qt, kt, vt, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_out),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    for got in (p_lse, a_lse):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_lse),
                                   rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal,hkv", CASES)
def test_backward_kernels_match_pallas(causal, hkv):
    """K2 and K3's plain versions against the Pallas dq and dk/dv kernels on
    the same q, k, v, do, lse and delta."""
    q, k, v, do, _ = _inputs(hkv)
    B, T, H, Dh = q.shape

    def bhtd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, T, Dh)

    def bthd(x, heads):
        return np.asarray(x).reshape(B, heads, T, Dh).transpose(0, 2, 1, 3)

    o, lse = jfa._flash_bhtd(bhtd(q), bhtd(k), bhtd(v), block_q=32, block_k=32,
                             causal=causal, interpret=True)
    j_dq, j_dk, j_dv = jfa._flash_bwd_bhtd(
        bhtd(q), bhtd(k), bhtd(v), o, bhtd(do), lse, block_q=32, block_k=32,
        causal=causal, interpret=True, n_kv_head=hkv)
    delta = (np.asarray(o) * np.asarray(bhtd(do))).sum(-1).reshape(B, H, T)
    lse_t = torch.from_numpy(np.asarray(lse).reshape(B, H, T).copy())
    delta_t = torch.from_numpy(delta.astype(np.float32))
    qt, kt, vt, dot = _t(q, k, v, do)
    dq = tfa.flash_bwd_dq(qt, kt, vt, dot, lse_t, delta_t, causal)
    dk, dv = tfa.flash_bwd_dkv(qt, kt, vt, dot, lse_t, delta_t, causal)
    for got, want, heads in ((dq, j_dq, H), (dk, j_dk, hkv), (dv, j_dv, hkv)):
        np.testing.assert_allclose(got.numpy(), bthd(want, heads),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal,hkv", CASES)
def test_grads_match_pallas(causal, hkv):
    """The flash_attention autograd.Function: dq, dk, dv of sum(out * w)."""
    q, k, v, w, _ = _inputs(hkv)
    jg = jax.grad(lambda q, k, v: jnp.sum(_jax_flash(causal)(q, k, v) * w),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, k, v, grad=True)
    (tfa.flash_attention(qt, kt, vt, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal,hkv", CASES)
def test_lse_cotangent_matches_pallas(causal, hkv):
    """The (out, lse) autograd.Function: the lse cotangent folds into delta
    exactly as the JAX package's _flash_lse_bwd does."""
    q, k, v, w, u = _inputs(hkv)

    def jloss(q, k, v):
        out, lse = _jax_flash_lse(causal)(q, k, v)
        return jnp.sum(out * w) + jnp.sum(lse * u)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = _t(q, k, v, grad=True)
    out, lse = tfa.flash_attention_with_lse(qt, kt, vt, causal)
    ((out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(u)).sum()).backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_matches_jax_dense(causal):
    q, k, v, w, u = _inputs(2, T=48, seed=3)
    j_out, j_lse = jfa.dense_attention_with_lse(q, k, v, causal)
    qt, kt, vt = _t(q, k, v)
    t_out, t_lse = tfa.dense_attention_with_lse(qt, kt, vt, causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(tfa.reference_attention(qt, kt, vt, causal).numpy(),
                               np.asarray(jfa.reference_attention(q, k, v, causal)),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_ragged_length_plain_matches_dense():
    """A length that no tile divides: the CPU path needs no blocks at all
    (the kernels mask the ragged edge in place)."""
    q, k, v, _, _ = _inputs(4, T=45, seed=5)
    qt, kt, vt = _t(q, k, v)
    out, lse = tfa.flash_fwd_plain(qt, kt, vt, causal=False)
    d_out, d_lse = tfa.dense_attention_with_lse(qt, kt, vt, causal=False)
    np.testing.assert_allclose(out.numpy(), d_out.numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), d_lse.numpy(), rtol=FWD_TOL, atol=FWD_TOL)


def test_wrapper_checks():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="GQA"):
        tfa.flash_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="match"):
        tfa.flash_fwd(torch.zeros(1, 8, 4, 16), torch.zeros(1, 9, 2, 16),
                      torch.zeros(1, 9, 2, 16))
    q4 = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="lse/delta"):
        tfa.flash_bwd_dq(q4, kv, kv, q4, torch.zeros(1, 8, 4), torch.zeros(1, 4, 8))
    # a tensor neither on the CPU nor on a CUDA card is refused, not
    # computed some other way
    meta = torch.empty(1, 64, 4, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(meta, meta, meta)


def test_cpu_path_counts_no_launch():
    tfa.reset_launch_counts()
    q, k, v, _, _ = _inputs(2, T=32)
    qt, kt, vt = _t(q, k, v, grad=True)
    tfa.flash_attention(qt, kt, vt).sum().backward()
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_scale_is_inverse_sqrt_head_dim():
    """One visible key: out is v and lse is its scaled score."""
    q = torch.ones(1, 1, 1, 64)
    k = torch.full((1, 1, 1, 64), 0.5)
    v = torch.arange(64.0).reshape(1, 1, 1, 64)
    out, lse = tfa.flash_fwd_plain(q, k, v)
    assert torch.equal(out, v)
    assert math.isclose(lse.item(), 32 / math.sqrt(64), rel_tol=1e-6)


def test_alignment_check():
    """The kernels' TMA loads need 16-byte aligned operands; a contiguous
    view with a storage offset may not be. The check looks only at the
    address, so it runs here without a card."""
    base = torch.zeros(1 + 64 * 64, dtype=torch.bfloat16)
    shifted = base[1:].view(1, 64, 1, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_aligned(shifted)
    tfa._check_aligned(torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("causal,hkv", CASES)
def test_bf16_p_plain_matches_pallas_in_bf16(causal, hkv):
    """With bf16 inputs the Pallas backward rounds p and ds to bf16 before
    the second products; the plain versions with bf16_p=True round them
    alike, so dq, dk and dv agree within a bf16 ulp or two of the outputs
    (the phase 3 reference at T=8192 and 32768 on the card), and the fp32
    plain versions do not."""
    q, k, v, do, _ = _inputs(hkv)
    B, T, H, Dh = q.shape
    bf = [x.astype(jnp.bfloat16) for x in (q, k, v, do)]

    def bhtd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, T, Dh)

    def bthd(x, heads):
        return np.asarray(x.astype(jnp.float32)).reshape(B, heads, T, Dh) \
            .transpose(0, 2, 1, 3)

    o, lse = jfa._flash_bhtd(*map(bhtd, bf[:3]), block_q=32, block_k=32,
                             causal=causal, interpret=True)
    j_dq, j_dk, j_dv = jfa._flash_bwd_bhtd(
        *map(bhtd, bf[:3]), o, bhtd(bf[3]), lse, block_q=32, block_k=32,
        causal=causal, interpret=True, n_kv_head=hkv)
    delta = (np.asarray(o.astype(jnp.float32)) *
             np.asarray(bhtd(bf[3]).astype(jnp.float32))).sum(-1).reshape(B, H, T)
    lse_t = torch.from_numpy(np.asarray(lse).reshape(B, H, T).copy())
    delta_t = torch.from_numpy(delta.astype(np.float32))
    qt, kt, vt, dot = (torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                       .bfloat16() for x in bf)
    got = {}
    for bf16_p in (True, False):
        dq = tfa.flash_bwd_dq_plain(qt, kt, vt, dot, lse_t, delta_t, causal,
                                    bf16_p=bf16_p)
        dk, dv = tfa.flash_bwd_dkv_plain(qt, kt, vt, dot, lse_t, delta_t, causal,
                                         bf16_p=bf16_p)
        got[bf16_p] = [x.float().numpy() for x in (dq, dk, dv)]
    wants = [bthd(j_dq, H), bthd(j_dk, hkv), bthd(j_dv, hkv)]
    for rounded, fp32, want in zip(got[True], got[False], wants):
        np.testing.assert_allclose(rounded, want, rtol=2 ** -7, atol=1e-5)
        # the rounding is what brings the plain version to the kernel: the
        # fp32 plain version lies 50 times further from it or more (relative
        # L2 2.4e-3 to 2.8e-3 against at most 1.3e-5 in these cases)
        assert 50 * np.linalg.norm(rounded - want) < np.linalg.norm(fp32 - want)


@pytest.mark.parametrize("causal,hkv", CASES)
@pytest.mark.parametrize("q_block", [64, 96])
def test_plain_versions_by_query_blocks_match_whole(causal, hkv, q_block):
    """The plain versions computed q_block query rows at a time (the card's
    reference at T=32768, where the whole [B, H, T, T] scores would not
    fit) give what the whole computation gives, a ragged last block
    included (T=200)."""
    q, k, v, w_out, _ = _inputs(hkv, B=2, T=200)
    qt, kt, vt, dot = _t(q, k, v, w_out)
    for bf16_p in (False, True):
        whole, blocks = [], []
        for qb, acc in ((None, whole), (q_block, blocks)):
            out, lse_b = tfa.flash_fwd_plain(qt, kt, vt, causal, q_block=qb)
            delta = (dot * out).sum(-1).transpose(1, 2).contiguous()
            acc += [out, lse_b, tfa.flash_bwd_dq_plain(
                qt, kt, vt, dot, lse_b, delta, causal, bf16_p, q_block=qb),
                *tfa.flash_bwd_dkv_plain(qt, kt, vt, dot, lse_b, delta, causal,
                                         bf16_p, q_block=qb)]
        for a, b in zip(whole, blocks):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
