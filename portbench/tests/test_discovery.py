"""A cell, a configuration, a model type, a traffic mix, a token law and a
per-layer metric added as files are found by name, with no edit to the
harness; a model type with no file raises; the families give what the
harness computed before they existed (frozen copies below); and every file
that BENCHMARK.json names is there and keeps the contract's forms."""

import json
import math
import re
import shutil

import pytest
import torch

from portbench import flops, port, spec, weights
from portbench.reference import model
from portbench.tests.conftest import tiny_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|proj|_dim$|_rank$|head_size|"
                   r"expansion|experts_per_tok|n_embd|n_inner)")


def test_throwaway_cell_found(tmp_path):
    here = _copied_tree(tmp_path)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    (here / "configs" / "throwaway.json").write_text(json.dumps(
        {"model_type": "gpt2", "n_layer": 1, "n_embd": 64, "n_head": 4, "vocab_size": 128}))
    (here / "traffic" / "throwaway.mix.json").write_text(json.dumps({"mode": "diloco", "batch": 1}))
    (here / "limits" / "thrown.away.json").write_text(json.dumps({"loss_gap": 1.0}))
    (here / "metrics" / "throwaway.metric.py").write_text("def read(ctx):\n    return 1.5\n")
    bench["configs"].append({"name": "throwaway", "source": "https://example.org",
                             "file": "portbench/configs/throwaway.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "thrown.away", "config": "throwaway",
                               "traffic": "throwaway.mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway.metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "x",
                               "moves": "tokens_per_s", "workloads": ["thrown.away"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("thrown.away", root=tmp_path, here=here)
    assert cell.config["n_layer"] == 1 and cell.traffic["batch"] == 1
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["throwaway.metric"]
    assert spec.metric_reader("throwaway.metric", here=here).read({}) == 1.5


THROWAWAY_FAMILY = """
def n_layer(cfg):
    return cfg["depth"]


def port_config(cfg, block):
    from pccl_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=cfg["vocab_size"], n_layer=cfg["depth"], n_head=cfg["heads"],
                     n_embd=cfg["width"], block_size=block, rope_theta=10000.0)


def param_shapes(cfg):
    d, L, V = cfg["width"], cfg["depth"], cfg["vocab_size"]
    return {"tok_emb": ((V, d), 0.02, False), "ln1_g": ((L, d), None, False),
            "ln2_g": ((L, d), None, False), "attn_qkv": ((L, d, 3 * d), d ** -0.5, False),
            "attn_out": ((L, d, d), d ** -0.5, True), "mlp_in": ((L, d, 4 * d), d ** -0.5, False),
            "mlp_out": ((L, 4 * d, d), (4 * d) ** -0.5, True), "lnf_g": ((d,), None, False)}


def flops_per_token(cfg, seq_len):
    return 7.0 * cfg["width"]


def flash_calls(cfg, batch, block):
    h = cfg["heads"]
    return [(cfg["depth"], dict(B=batch, T=block, H=h, Hkv=h, D=cfg["width"] // h,
                                causal=True, window=block // 4))]
"""

THROWAWAY_REFERENCE = """
import torch.nn.functional as F

from portbench.reference.model import attention, rmsnorm, rope


def n_layer(cfg):
    return cfg["depth"]


def norm_eps(cfg):
    return 1e-6


def head(params, cfg):
    return params["tok_emb"].t()


def layer(x, p, l, cfg):
    B, T, d = x.shape
    H = cfg["heads"]
    q, k, v = (rmsnorm(x, p["ln1_g"][l], 1e-6) @ p["attn_qkv"][l]).chunk(3, dim=-1)
    q, k = (rope(t.reshape(B, T, H, d // H), 10000.0) for t in (q, k))
    x = x + attention(q, k, v.reshape(B, T, H, d // H)) @ p["attn_out"][l]
    h = rmsnorm(x, p["ln2_g"][l], 1e-6)
    return x + F.gelu(h @ p["mlp_in"][l], approximate="tanh") @ p["mlp_out"][l]
"""

THROWAWAY_LAW = """
import torch


def draw(gen, shape, vocab, device):
    return torch.randint(0, vocab // 4, shape, generator=gen, device=device)
"""


def _copied_tree(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return here


def test_throwaway_family_runs(tmp_path):
    """A model type added to a copied tree as new files only (a family, a
    reference family, a configuration, a traffic file with its token law)
    runs through the cell's loading, the port mapping, the weights, the
    FLOPs, the token draw and the reference's loss, which equals the
    port's (the throwaway type is GPT-2's block under other key names)."""
    import dataclasses

    from pccl_tpu_torch.parallel import train as port_train

    here = _copied_tree(tmp_path)
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "families" / "throwaway.py").write_text(THROWAWAY_FAMILY)
    (here / "reference" / "families" / "throwaway.py").write_text(THROWAWAY_REFERENCE)
    (here / "tokens" / "throwaway.py").write_text(THROWAWAY_LAW)
    (here / "configs" / "throwaway.json").write_text(json.dumps(
        {"model_type": "throwaway", "depth": 2, "width": 64, "heads": 4, "vocab_size": 256}))
    (here / "traffic" / "throwaway.mix.json").write_text(json.dumps(
        {"mode": "diloco", "batch": 2, "block": 32, "token_law": "throwaway"}))
    (here / "limits" / "thrown.away.json").write_text(json.dumps({"loss_gap": 1.0}))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "https://example.org",
                             "file": "portbench/configs/throwaway.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "thrown.away", "config": "throwaway",
                               "traffic": "throwaway.mix", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())   # no file edited

    cell = spec.load_cell("thrown.away", root=tmp_path, here=here)
    cfg, tr = cell.config, cell.traffic
    pcfg = port.model_config(cfg, tr["block"], here=here)
    assert (pcfg.n_layer, pcfg.n_embd, pcfg.n_head) == (2, 64, 4)
    params = weights.init_params(cfg, 7, "cpu", here=here)
    shapes = port_train.family(pcfg).param_shapes(pcfg)
    assert {n: tuple(t.shape) for n, t in params.items()} == \
        {n: tuple(s) for n, s in shapes.items()}
    assert flops.flops_per_token(cfg, tr["block"], here=here) == 7.0 * 64
    calls = flops.flash_calls(cfg, tr["batch"], tr["block"], here=here)
    assert calls[0][1]["window"] == 8
    assert flops.flash_work(**calls[0][1])["flash_fwd"][0] < \
        flops.flash_work(2, 32, 4, 4, 16)["flash_fwd"][0]
    feed = weights.Batches(7, 0, tr["batch"], tr["block"], cfg["vocab_size"], "cpu",
                           tr["token_law"], here=here)
    tok, tgt = feed.next()
    assert tok.shape == (2, 32) and int(tok.max()) < 64
    ref = model.loss(params, tok, tgt, cfg, here=here)
    pcfg = dataclasses.replace(pcfg, compute_dtype=torch.float32)
    got = port_train.family(pcfg).loss_fn(params, tok, tgt, pcfg)
    assert math.isfinite(float(ref))
    assert float(got) == pytest.approx(float(ref), abs=1e-5)


def test_unknown_model_type_raises(tmp_path):
    """A configuration whose model type has no file raises at every call
    site and in load_cell, naming the file it looked for; nothing falls
    through to another type."""
    cfg = dict(tiny_config("mistral"), model_type="no_such_type")
    want = str(spec.HERE / "families" / "no_such_type.py")
    for call in (lambda: port.model_config(cfg, 32),
                 lambda: weights.init_params(cfg, 1, "cpu"),
                 lambda: flops.flops_per_token(cfg, 32),
                 lambda: flops.flash_calls(cfg, 1, 32)):
        with pytest.raises(FileNotFoundError, match=re.escape(want)):
            call()
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(spec.HERE / "reference" / "families"))):
        model.loss({"tok_emb": torch.zeros(256, 64)}, torch.zeros(1, 4, dtype=torch.long),
                   torch.zeros(1, 4, dtype=torch.long), cfg)
    with pytest.raises(FileNotFoundError, match="no_such_law"):
        weights.Batches(1, 0, 1, 4, 8, "cpu", "no_such_law")
    # load_cell looks for both families before a run starts
    here = _copied_tree(tmp_path)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    (here / "configs" / "gpt2-medium.json").write_text(json.dumps(
        dict(json.loads((here / "configs" / "gpt2-medium.json").read_text()),
             model_type="no_such_type")))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError, match="no_such_type.py"):
        spec.load_cell("gpt2m.diloco", root=tmp_path, here=here)


def test_no_type_names_outside_the_families():
    """No harness file but a family compares a model type with a name."""
    compare = re.compile(r"model_type[\"'\]]*\s*(==|!=|\bin\b)|(==|!=)\s*[^\n]*model_type")
    found = [str(p) for p in spec.HERE.rglob("*.py")
             if not {"families", "tests"} & set(p.relative_to(spec.HERE).parts)
             and compare.search(p.read_text())]
    assert found == []


# The harness's type-dependent functions as they were before the families,
# kept to hold the families to them.

def _frozen_param_shapes(cfg):
    if cfg["model_type"] == "gpt2":
        d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
        return {
            "tok_emb": ((V, d), 0.02, False), "ln1_g": ((L, d), None, False),
            "ln2_g": ((L, d), None, False), "attn_qkv": ((L, d, 3 * d), d ** -0.5, False),
            "attn_out": ((L, d, d), d ** -0.5, True),
            "mlp_in": ((L, d, 4 * d), d ** -0.5, False),
            "mlp_out": ((L, 4 * d, d), (4 * d) ** -0.5, True), "lnf_g": ((d,), None, False),
        }
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    f = cfg["intermediate_size"]
    return {
        "tok_emb": ((V, d), 0.02, False), "ln1_g": ((L, d), None, False),
        "ln2_g": ((L, d), None, False), "attn_q": ((L, d, q), d ** -0.5, False),
        "attn_kv": ((L, d, 2 * kv), d ** -0.5, False), "attn_out": ((L, q, d), q ** -0.5, True),
        "mlp_gate": ((L, d, f), d ** -0.5, False), "mlp_up": ((L, d, f), d ** -0.5, False),
        "mlp_down": ((L, f, d), f ** -0.5, True), "lnf_g": ((d,), None, False),
        "head": ((d, V), d ** -0.5, False),
    }


def _frozen_init_params(cfg, seed, device):
    L = cfg.get("n_layer", cfg.get("num_hidden_layers"))
    res = 1.0 / math.sqrt(2 * L)
    gen = torch.Generator(device=device).manual_seed(weights._sub_seed(seed, 0))
    out = {}
    for name, (shape, std, residual) in _frozen_param_shapes(cfg).items():
        if std is None:
            out[name] = torch.ones(shape, device=device)
            continue
        t = torch.randn(shape, generator=gen, device=device)
        out[name] = t.mul_(std * (res if residual else 1.0))
    return out


def _frozen_batches(seed, rank, batch, block, vocab, device, n):
    gen = torch.Generator(device=device).manual_seed(weights._sub_seed(seed, 1 + rank))
    return [torch.randint(0, vocab, (batch, block + 1), generator=gen, device=device)
            for _ in range(n)]


def _frozen_matmul_params(cfg):
    if cfg["model_type"] == "gpt2":
        d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
        return L * 12 * d * d + d * V
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    dh = cfg["head_dim"]
    q = cfg["num_attention_heads"] * dh
    kv = cfg["num_key_value_heads"] * dh
    f = cfg["intermediate_size"]
    return L * (d * q + d * 2 * kv + q * d + 3 * d * f) + d * V


def _frozen_flops_per_token(cfg, seq_len):
    L = cfg.get("n_layer", cfg.get("num_hidden_layers"))
    width = cfg["n_embd"] if cfg["model_type"] == "gpt2" else \
        cfg["num_attention_heads"] * cfg["head_dim"]
    return 6.0 * _frozen_matmul_params(cfg) + 6.0 * L * seq_len * width


def _frozen_attn_shape(cfg, batch, block):
    if cfg["model_type"] == "gpt2":
        h = cfg["n_head"]
        return batch, block, h, h, cfg["n_embd"] // h
    return (batch, block, cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"])


def _cells():
    """(configuration, traffic) of each cell of BENCHMARK.json."""
    return [(c.config, c.traffic) for c in
            (spec.load_cell(w["name"]) for w in spec.benchmark()["workloads"])]


@pytest.mark.parametrize("kind", ["gpt2", "mistral"])
@pytest.mark.parametrize("seed", [0, 5, 3_000_000_019])
def test_weights_equal_the_frozen_draw(kind, seed):
    cfg = tiny_config(kind)
    ours, frozen = weights.init_params(cfg, seed, "cpu"), _frozen_init_params(cfg, seed, "cpu")
    assert list(ours) == list(frozen)
    assert all(torch.equal(ours[n], frozen[n]) for n in ours)


@pytest.mark.parametrize("seed", [0, 5, 3_000_000_019])
def test_uniform_law_equals_the_frozen_draw(seed):
    """A traffic file that names no token law draws what Batches drew
    before the laws, batch after batch."""
    feed = weights.Batches(seed, 1, 3, 16, 1000, "cpu")
    for x in _frozen_batches(seed, 1, 3, 16, 1000, "cpu", 3):
        tok, tgt = feed.next()
        assert torch.equal(tok, x[:, :-1]) and torch.equal(tgt, x[:, 1:])


@pytest.mark.parametrize("cell", range(len(spec.benchmark()["workloads"])))
def test_cells_count_what_they_counted(cell):
    """At each cell's configuration and shape: the same parameter shapes in
    the same order, mfu's FLOPs a token equal to the float, one attention
    shape whose least times equal the frozen shape's exactly."""
    cfg, tr = _cells()[cell]
    fam = spec.family(cfg["model_type"])
    assert list(fam.param_shapes(cfg).items()) == list(_frozen_param_shapes(cfg).items())
    for T in (1024, 32768, tr["block"]):
        assert flops.flops_per_token(cfg, T) == _frozen_flops_per_token(cfg, T)
    calls = flops.flash_calls(cfg, tr["batch"], tr["block"])
    B, T, H, Hkv, D = _frozen_attn_shape(cfg, tr["batch"], tr["block"])
    assert calls == [(fam.n_layer(cfg), dict(B=B, T=T, H=H, Hkv=Hkv, D=D, causal=True,
                                             window=None))]
    frozen = flops.bounds(B, T, H, Hkv, D, True, peak_flops=989e12, peak_bytes=3.35e12)
    assert flops.call_bounds(calls) == {k: v[0] for k, v in frozen.items()}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")


def test_benchmark_files_and_names():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cell = spec.load_cell(w["name"])
        assert cell.traffic["peers"] // cell.traffic["peers_per_chip"] == w["chips"]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)
