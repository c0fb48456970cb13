"""The plain reference against the port at a tiny size on the CPU, with the
port computing in float32 (the reference never imports the port; this
test may), for every model type found on disk. Also: the seed's weight
draw against the port's own init, the windowed attention against a masked
softmax, and the reference's families loaded without the port."""

import pytest
import torch

from portbench import weights
from portbench.reference import model, train
from portbench.tests.conftest import FAMILIES, tiny_config, tiny_traffic


def _port_cfg(kind, compute=torch.float32):
    import dataclasses

    from portbench import port

    return dataclasses.replace(port.model_config(tiny_config(kind), 32), compute_dtype=compute)


@pytest.mark.parametrize("kind", FAMILIES)
def test_loss_and_grad_match_port(kind):
    from pccl_tpu_torch.parallel import train as port_train

    cfg = tiny_config(kind)
    params = weights.init_params(cfg, 11, "cpu")
    tok, tgt = weights.Batches(11, 0, 2, 32, cfg["vocab_size"], "cpu").next()
    ref_p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    ref_loss = model.loss(ref_p, tok, tgt, cfg)
    ref_loss.backward()
    pcfg = _port_cfg(kind)
    port_p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    loss = port_train.family(pcfg).loss_fn(port_p, tok, tgt, pcfg)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), abs=1e-5)
    for n in params:
        scale = float(ref_p[n].grad.abs().max())
        assert torch.allclose(port_p[n].grad, ref_p[n].grad, rtol=1e-4, atol=1e-5 * scale), n


@pytest.mark.parametrize("kind", FAMILIES)
def test_follow_matches_port_steps(kind):
    """Three AdamW steps: the reference's per-leaf norms against the
    port's train step in float32."""
    from pccl_tpu_torch.parallel import train as port_train

    from portbench import probes

    cfg, tr = tiny_config(kind), tiny_traffic()
    ref = train.follow(cfg, tr, 5, [1], "cpu", 3)
    pcfg = _port_cfg(kind)
    state = port_train.make_train_state(0, pcfg, "cpu", lr=tr["inner_lr"],
                                        params=weights.init_params(cfg, 5, "cpu"))
    step = port_train.build_train_step(pcfg)
    feed = weights.Batches(5, 1, 2, 32, cfg["vocab_size"], "cpu")
    p0 = {n: p.detach().clone() for n, p in state.params.items()}
    losses = []
    for i in range(3):
        losses.append(float(step(state, *feed.next())))
        if i == 0:
            grad = probes.adam_grad_norms(state)
    assert losses == pytest.approx(ref["losses"], abs=1e-5)
    for n in p0:
        assert grad[n] == pytest.approx(ref["grad_norms"][n], rel=1e-4)
        change = probes.norm64(state.params[n].detach() - p0[n])
        assert change == pytest.approx(ref["update_norms"][n], rel=1e-3)


@pytest.mark.parametrize("kind", FAMILIES)
def test_weight_draw_scales_match_port_init(kind):
    """Each leaf's std and mean of the seed's draw against the port's
    init_params at a tiny width (the draw on the card uses the same code
    with a card generator)."""
    from pccl_tpu_torch.parallel import train as port_train

    from portbench import port

    cfg = tiny_config(kind)
    ours = weights.init_params(cfg, 3, "cpu")
    theirs = port_train.family(port.model_config(cfg, 32)).init_params(
        torch.Generator().manual_seed(3), port.model_config(cfg, 32))
    assert sorted(ours) == sorted(theirs)
    for n in ours:
        assert ours[n].shape == theirs[n].shape, n
        assert float(ours[n].std()) == pytest.approx(float(theirs[n].std()), rel=0.1, abs=1e-6), n
        assert float(ours[n].mean()) == pytest.approx(float(theirs[n].mean()), abs=0.02), n


def test_outer_sketch_is_the_outer_step():
    """The projections of the reference's outer steps on whole tensors equal
    the outer steps on the projections, over two steps with momentum."""
    from portbench import probes

    g = torch.Generator().manual_seed(0)
    outer = {"a": torch.randn(1000, generator=g), "b": torch.randn(10, 7, generator=g)}
    names = sorted(outer)

    def sk(t):
        return probes.sketch(t, names, 9)

    mom = mom_sk = None
    for _ in range(2):
        inners = [{n: t + 0.01 * torch.randn(t.shape, generator=g) for n, t in outer.items()}
                  for _ in range(3)]
        new, mom = train.outer_step(outer, inners, 0.7, 0.9, mom=mom)
        want, mom_sk = train.outer_sketch(sk(outer), [sk(i) for i in inners], 0.7, 0.9, mom_sk)
        got = sk(new)
        for n in names:
            assert got[n] == pytest.approx(want[n], rel=1e-5, abs=1e-5)
        outer = new


def test_outer_steps_match_port_diloco():
    """Two outer steps of the port's Diloco (one peer, no ring) against the
    reference's, momentum carried."""
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(1000, generator=g), "b": torch.randn(10, 7, generator=g)}
    dl = Diloco(None, params, DilocoConfig(inner_steps=1, outer_lr=0.7, outer_momentum=0.9))
    outer = {n: t.clone() for n, t in params.items()}
    mom = None
    for _ in range(2):
        with torch.no_grad():
            for t in params.values():
                t.add_(0.01 * torch.randn(t.shape, generator=g))
        inner = {n: t.clone() for n, t in params.items()}
        dl.outer_step(params)
        outer, mom = train.outer_step(outer, [inner], 0.7, 0.9, mom=mom)
        for n in params:
            assert torch.allclose(params[n], outer[n], rtol=1e-6, atol=1e-6), n


@pytest.mark.parametrize("T,window", [(32, None), (32, 1), (32, 7), (40, 16), (32, 32), (32, 99)])
def test_attention_window_is_the_masked_softmax(T, window, monkeypatch):
    """The blockwise reference attention, in blocks of 8 rows (keys cut to
    the window), against one softmax over the whole masked [T, T] scores."""
    g = torch.Generator().manual_seed(T + (window or 0))
    q = torch.randn(2, T, 4, 8, generator=g, dtype=torch.float64)
    k, v = (torch.randn(2, T, 2, 8, generator=g, dtype=torch.float64) for _ in range(2))
    monkeypatch.setattr(model, "SCORE_BYTES", 4 * 2 * 4 * T * 8)
    got = model.attention(q, k, v, window)
    qi, ki = torch.arange(T)[:, None], torch.arange(T)[None, :]
    seen = (ki <= qi) & ((ki > qi - window) if window else True)
    kk, vv = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / 8 ** 0.5
    p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vv).reshape(2, T, 32)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_reference_families_load_no_port():
    """Every reference family, loaded and run in a fresh process, loads
    neither the port nor JAX nor the JAX package."""
    import subprocess
    import sys

    from portbench import spec

    code = (
        "import sys\n"
        "from portbench import spec, weights\n"
        "from portbench.guard import forbidden_modules\n"
        "from portbench.reference import model\n"
        "for t in sys.argv[1:]:\n"
        "    spec.reference_family(t)\n"
        "    cfg = spec.load_json(spec.HERE / 'tests' / 'tiny' / f'{t}.json')\n"
        "    tok, tgt = weights.Batches(1, 0, 1, 8, cfg['vocab_size'], 'cpu').next()\n"
        "    model.loss(weights.init_params(cfg, 1, 'cpu'), tok, tgt, cfg)\n"
        "bad = forbidden_modules(sys.modules)\n"
        "bad += sorted(n for n in sys.modules if n.split('.')[0] == 'pccl_tpu_torch')\n"
        "print(','.join(bad))\n")
    p = subprocess.run([sys.executable, "-c", code, *FAMILIES], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "", p.stdout
