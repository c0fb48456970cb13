"""pccl_tpu_torch.models.lfm2 (LFM2 with sparse experts) and ops/moe.py's
dropless top-k layer on the CPU, against the benchmark's plain reference
(portbench/reference/families/lfm2_moe.py, fp32, which imports no port):
the JAX package has no such model.

The port computes in fp32 here, the experts through the grouped product's
plain versions (ops/moe_gemm.py). Tolerances as in the JAX parity tests:
2e-5 on the loss, 1e-4 (relative and absolute) on every leaf's gradient,
all of magnitudes near one. Also: the conv's causality, the layer under
total skew, the expert bias, one DiLoCo outer step over the new leaves,
tp, pp and sp refused, the Zipf token law, and the GPT and Llama losses
bit for bit what they were before rmsnorm took an eps.
"""

import math
import subprocess
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from pccl_tpu_torch import models
from pccl_tpu_torch.models import gpt, lfm2, llama
from pccl_tpu_torch.models._common import dense_attention, rope
from pccl_tpu_torch.ops import flash_attention as fa
from pccl_tpu_torch.ops import moe, moe_gemm
from pccl_tpu_torch.parallel import diloco, pipeline, train
from portbench import spec
from portbench.reference import model as ref_model

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
ROOT = spec.ROOT


def _ref_cfg(cfg: lfm2.Lfm2MoeConfig) -> dict:
    """The port's config as the reference's configuration file names it."""
    return {"model_type": "lfm2_moe", "num_hidden_layers": cfg.n_layer,
            "layer_types": list(cfg.layer_types), "hidden_size": cfg.n_embd,
            "num_attention_heads": cfg.n_head, "num_key_value_heads": cfg.n_kv_head,
            "intermediate_size": cfg.ffn_dim, "num_dense_layers": cfg.num_dense_layers,
            "num_experts": cfg.n_experts, "num_experts_per_tok": cfg.top_k,
            "moe_intermediate_size": cfg.expert_dim, "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scale, "conv_L_cache": cfg.conv_width,
            "conv_bias": False, "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "norm_eps": cfg.norm_eps}


def _setup(seed=0, B=2, T=32, tokens="uniform", **kw):
    cfg = lfm2.tiny_config(compute_dtype=torch.float32, **kw)
    params = lfm2.init_params(torch.Generator().manual_seed(seed), cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    if tokens == "uniform":
        tok = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    else:                       # every position the same id
        tok = torch.full((B, T), 7, dtype=torch.long)
    tgt = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    return cfg, params, tok, tgt


def _grads(loss_of, params):
    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    loss = loss_of(p)
    loss.backward()
    return float(loss.detach()), {n: t.grad for n, t in p.items()}


def _assert_match(cfg, params, tok, tgt, bias=None, **port_kw):
    ref_extra = {} if bias is None else {"moe_bias": bias}
    ref_loss, ref_g = _grads(
        lambda p: ref_model.loss({**p, **ref_extra}, tok, tgt, _ref_cfg(cfg)), params)
    loss, g = _grads(lambda p: lfm2.loss_fn(p, tok, tgt, cfg, moe_bias=bias, **port_kw),
                     params)
    assert loss == pytest.approx(ref_loss, abs=LOSS_TOL, rel=LOSS_TOL)
    assert set(g) == set(ref_g)
    for n in g:
        torch.testing.assert_close(g[n], ref_g[n], rtol=GRAD_TOL, atol=GRAD_TOL, msg=n)
    return ref_loss


@pytest.mark.parametrize("tokens", ["uniform", "one_id"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat, tokens):
    cfg, params, tok, tgt = _setup(seed=3, tokens=tokens)
    _assert_match(cfg, params, tok, tgt, attn_fn=fa.flash_attention, remat=remat)


def test_chunked_loss_matches_reference():
    cfg, params, tok, tgt = _setup(seed=4)
    _assert_match(cfg, params, tok, tgt, loss_chunk=8)


def test_expert_bias_moves_the_choice_not_the_weights():
    """A bias that favours some experts changes which experts a token gets,
    while the weights stay the chosen sigmoid scores renormalised; the
    model with it still matches the reference given the same bias."""
    cfg, params, tok, tgt = _setup(seed=5)
    E, k = cfg.n_experts, cfg.top_k
    bias = torch.zeros(cfg.n_moe_layers, E)
    bias[:, :k] = 10.0           # the first k experts win every choice
    h = torch.randn(64, cfg.n_embd)
    router = params["moe_router"][0]
    plain, _ = moe.route_topk(h, router, torch.zeros(E), k)
    chosen, w = moe.route_topk(h, router, bias[0], k)
    assert not torch.equal(plain.sort(-1).values, chosen.sort(-1).values)
    assert torch.equal(chosen.sort(-1).values, torch.arange(k).expand(64, k))
    s = torch.sigmoid(h @ router)
    want = s.gather(-1, chosen)
    torch.testing.assert_close(w, want / want.sum(-1, keepdim=True))
    _assert_match(cfg, params, tok, tgt, bias=bias)


def test_short_conv_is_causal():
    """The output at t does not move when the inputs after t change, in the
    conv mixer and in the whole model's logits."""
    cfg, params, tok, _ = _setup(seed=6)
    layer = {k: params[k][0] for k in ("conv_in", "conv_w", "conv_out")}
    h = torch.randn(1, 16, cfg.n_embd)
    h2 = h.clone()
    h2[:, 9:] = torch.randn(1, 7, cfg.n_embd)
    a, b = lfm2.short_conv(h, layer), lfm2.short_conv(h2, layer)
    assert torch.equal(a[:, :9], b[:, :9]) and not torch.equal(a[:, 9:], b[:, 9:])
    tok2 = tok.clone()
    tok2[:, 20:] = (tok2[:, 20:] + 1) % cfg.vocab_size
    la = lfm2.forward(params, tok, cfg, attn_fn=fa.flash_attention)
    lb = lfm2.forward(params, tok2, cfg, attn_fn=fa.flash_attention)
    torch.testing.assert_close(la[:, :20], lb[:, :20], rtol=0, atol=1e-6)
    assert not torch.allclose(la[:, 20:], lb[:, 20:])


def test_dropless_layer_under_total_skew():
    """Every token routed to the same k experts (the others get no row):
    every slot is computed, none dropped, and the layer equals the
    reference's expert loop; the load counters hold n k slots."""
    cfg, params, _, _ = _setup(seed=7)
    E, k, n = cfg.n_experts, cfg.top_k, 96
    h = torch.randn(1, n, cfg.n_embd)
    bias = torch.zeros(E)
    bias[E - k:] = 10.0
    moe.reset_stats()
    got = moe.moe_topk(h, params["moe_router"][0], params["moe_gate_up"][0],
                       params["moe_down"][0], bias, k=k, layer=0)
    loads = moe.stats()["loads"][0]
    assert loads == [0] * (E - k) + [n] * k
    assert moe.stats()["max_over_mean"][0] == pytest.approx(E / k)
    ref_fam = spec.reference_family("lfm2_moe")
    p = {n_: params[n_] for n_ in ("moe_router", "moe_gate_up", "moe_down")}
    want = ref_fam._experts(h, {**p, "moe_bias": bias[None]}, 0, _ref_cfg(cfg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the same slots through a dense per-token loop: nothing dropped
    s = torch.sigmoid(h[0] @ params["moe_router"][0])
    w = s[:, E - k:] / s[:, E - k:].sum(-1, keepdim=True)
    dense = sum(w[:, i, None] * (F.silu(g) * u) @ params["moe_down"][0][E - k + i]
                for i, (g, u) in enumerate(
                    (h[0] @ params["moe_gate_up"][0][e]).chunk(2, dim=-1)
                    for e in range(E - k, E)))
    torch.testing.assert_close(got[0], dense, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("counts", [[0, 3, 0, 9, 1], [13, 0, 0, 0, 0], [0, 0, 0, 0, 0]])
def test_grouped_product_plain_segments(counts):
    """The grouped product's plain versions (the CPU path) against a
    per-row product, with empty, uneven and all-in-one segments, forward
    and both gradients."""
    E, K, N = len(counts), 8, 16
    offsets = torch.tensor([0] + counts).cumsum(0).to(torch.int32)
    expert = torch.repeat_interleave(torch.arange(E), torch.tensor(counts))
    x = torch.randn(sum(counts), K, requires_grad=True)
    w = torch.randn(E, K, N, requires_grad=True)
    y = moe_gemm.grouped_mm(x, w, offsets)
    dy = torch.randn_like(y)
    y.backward(dy)
    x2, w2 = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    y2 = torch.einsum("sk,skn->sn", x2, w2[expert])
    y2.backward(dy)
    torch.testing.assert_close(y, y2)
    torch.testing.assert_close(x.grad, x2.grad)
    torch.testing.assert_close(w.grad, w2.grad)


def test_train_step_and_one_outer_step():
    """build_train_step with K1-K3's CPU versions over the new leaves, then
    one DiLoCo outer step: the expert bias is a buffer, outside the
    parameters, AdamW and the outer vector; the outer step is DiLoCo's."""
    cfg = lfm2.tiny_config()
    state = train.make_train_state(0, cfg, "cpu", lr=1e-3)
    assert models.family(cfg) is lfm2
    assert set(state.buffers) == {"moe_bias"} and "moe_bias" not in state.params
    opt_params = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in state.params.values()}
    outer0 = {n: p.detach().clone() for n, p in state.params.items()}
    dl = diloco.Diloco(None, state.params, diloco.DilocoConfig(outer_lr=0.7,
                                                               outer_momentum=0.9))
    assert dl.outer_vec.numel() == sum(p.numel() for p in state.params.values())
    step = train.build_train_step(cfg, attn_fn=fa.flash_attention)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
        loss = step(state, tok, torch.roll(tok, -1, 1))
        assert math.isfinite(float(loss))
    inner = {n: p.detach().clone() for n, p in state.params.items()}
    dl.outer_step(state.params)
    for n, p in state.params.items():
        delta = outer0[n] - inner[n]
        want = outer0[n] - 0.7 * (delta + 0.9 * delta)
        torch.testing.assert_close(p.detach(), want, rtol=1e-5, atol=1e-6, msg=n)
    assert not state.buffers["moe_bias"].any()


def test_tp_pp_and_sp_raise():
    cfg = lfm2.tiny_config()
    with pytest.raises(ValueError, match="one rank"):
        train.build_train_step(cfg, mesh=types.SimpleNamespace(shape={"dp": 1, "tp": 2}))
    with pytest.raises(ValueError, match="one rank"):
        train.build_train_step(cfg, mesh=types.SimpleNamespace(shape={"sp": 2}),
                               seq_axis="sp")
    with pytest.raises(TypeError, match="GPTConfig"):
        pipeline.build_pipelined_forward(cfg, mesh=None)
    _, params, tok, tgt = _setup()
    with pytest.raises(ValueError, match="one rank"):
        lfm2.loss_fn(params, tok, tgt, cfg, tp=object())
    with pytest.raises(ValueError, match="one rank"):
        lfm2.loss_fn(params, tok, tgt, cfg, pos_offset=32)


def test_param_shapes_match_the_benchmark_family():
    """The port's leaves and the harness's weight draw agree, at the
    benchmark's configuration and at the tiny one."""
    for path in (spec.HERE / "configs" / "lfm2-8b-a1b.json",
                 spec.HERE / "tests" / "tiny" / "lfm2_moe.json"):
        cfgd = spec.load_json(path)
        fam = spec.family("lfm2_moe")
        pcfg = fam.port_config(cfgd, 64)
        want = {n: s for n, (s, _, _) in fam.param_shapes(cfgd).items()}
        assert lfm2.param_shapes(pcfg) == want


def test_reference_family_imports_no_port():
    code = ("import sys, torch\n"
            "from portbench import spec, weights\n"
            "from portbench.reference import model\n"
            "cfg = spec.load_json(spec.HERE / 'tests' / 'tiny' / 'lfm2_moe.json')\n"
            "p = weights.init_params(cfg, 1, 'cpu')\n"
            "tok, tgt = weights.Batches(1, 0, 1, 16, cfg['vocab_size'], 'cpu', 'zipf').next()\n"
            "float(model.loss(p, tok, tgt, cfg))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pccl_tpu', 'pccl_tpu_torch')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_zipf_law_is_seeded_and_follows_one_over_rank():
    zipf = spec.token_law("zipf")
    V, n = 64, 1 << 20
    a = zipf.draw(torch.Generator().manual_seed(9), (n,), V, "cpu")
    b = zipf.draw(torch.Generator().manual_seed(9), (n,), V, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < V
    p = 1.0 / torch.arange(1, V + 1, dtype=torch.float64)
    p /= p.sum()
    freq = torch.bincount(a, minlength=V).double() / n
    # each frequency within 5 standard errors of its binomial draw
    assert bool(((freq - p).abs() <= 5 * (p * (1 - p) / n).sqrt()).all())
    c = zipf.draw(torch.Generator().manual_seed(10), (n,), V, "cpu")
    assert not torch.equal(a, c)


# ------------------------------------------------------------ rmsnorm's eps

def _rmsnorm_before(x, gain):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * gain).to(x.dtype)


def _llama_block_before(x, layer, cfg, attn_fn=None, pos_offset=0, tp=None):
    B, T, _ = x.shape
    Dh = cfg.head_dim
    h = _rmsnorm_before(x, layer["ln1_g"])
    q = (h @ layer["attn_q"].to(h.dtype)).reshape(B, T, -1, Dh)
    k, v = (h @ layer["attn_kv"].to(h.dtype)).chunk(2, dim=-1)
    q = rope(q, cfg.rope_theta, pos_offset)
    k = rope(k.reshape(B, T, -1, Dh), cfg.rope_theta, pos_offset)
    v = v.reshape(B, T, -1, Dh)
    att = (attn_fn or dense_attention)(q, k, v).reshape(B, T, -1)
    x = x + att @ layer["attn_out"].to(x.dtype)
    h = _rmsnorm_before(x, layer["ln2_g"])
    gated = F.silu(h @ layer["mlp_gate"].to(h.dtype)) * (h @ layer["mlp_up"].to(h.dtype))
    return x + gated @ layer["mlp_down"].to(h.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_gpt_and_llama_losses_are_what_they_were(family, dtype, monkeypatch):
    mod = {"gpt": gpt, "llama": llama}[family]
    cfg = mod.tiny_config(compute_dtype=dtype)
    params = mod.init_params(torch.Generator().manual_seed(2), cfg)
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    tgt = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    now, g_now = _grads(lambda p: mod.loss_fn(p, tok, tgt, cfg, fa.flash_attention), params)
    # the name each family's blocks look rmsnorm up by
    monkeypatch.setattr(gpt, "rmsnorm", _rmsnorm_before)
    monkeypatch.setattr(llama, "rmsnorm", _rmsnorm_before)
    if family == "llama":
        monkeypatch.setattr(llama, "block", _llama_block_before)
    before, g_before = _grads(lambda p: mod.loss_fn(p, tok, tgt, cfg, fa.flash_attention),
                              params)
    assert now == before
    assert all(torch.equal(g_now[n], g_before[n]) for n in g_now)
