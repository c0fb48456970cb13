"""A gloo world of spawned ranks for the port's collective tests, and the
cases each rank runs (tests/test_torch_sp.py, tests/test_torch_quantized.py,
tests/test_torch_tp.py, tests/test_torch_pipeline.py, tests/test_torch_moe.py,
tests/test_torch_diloco_mesh.py).

`run_world(cases, inputs)` spawns `world` processes on the CPU, joins them
into one torch.distributed gloo group through a FileStore, and has each run
`cases(rank, inputs) -> {case name: result}` once: the whole file's cases
in one world, so the spawning is paid once a file. Results are numpy arrays
(or plain values); a case that raises reports its traceback under its name,
and the others still run. This module imports no JAX: the ranks run the
port alone, the test process holds the JAX side.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ERROR = "__error__"


def _rank_main(cases, rank: int, world: int, store: str, inputs, out) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        try:
            out.put((rank, cases(rank, inputs)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the test, then re-raised
        out.put((rank, {ERROR: traceback.format_exc()}))
        raise


def run_world(cases, inputs, world: int = 4, timeout: float = 240.0) -> list:
    """Each rank's {case: result}, in rank order. Raises if a rank dies
    without reporting or the world does not finish within `timeout`
    seconds; every process is stopped before it returns."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(cases, r, world, store, inputs, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    rank, res = out.get(timeout=1.0)
                    results[rank] = res
                    continue
                except queue.Empty:
                    pass
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world} ranks did not "
                                       f"finish in {timeout} s; reported: "
                                       f"{sorted(results)}")
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    for r in range(world):
        if ERROR in results[r]:
            raise RuntimeError(f"rank {r} failed:\n{results[r][ERROR]}")
    return [results[r] for r in range(world)]


def result(world_results: list, case: str, rank: int):
    """One rank's result of one case; raises with the rank's traceback if
    the case failed there."""
    res = world_results[rank][case]
    if isinstance(res, dict) and ERROR in res:
        raise AssertionError(f"case {case} failed on rank {rank}:\n{res[ERROR]}")
    return res


def _run_case(res: dict, name: str, fn) -> None:
    try:
        res[name] = fn()
    except Exception:  # noqa: BLE001 - reported per case
        res[name] = {ERROR: traceback.format_exc()}


def _np(t):
    import torch

    return t.detach().to(torch.float32).numpy()


# ------------------------------------------------------------ quantized ring

def quantized_cases(rank: int, inputs: dict) -> dict:
    import torch

    from pccl_tpu_torch.ops.quantized_collectives import (
        quantized_pmean, quantized_ring_all_reduce)
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel.hierarchical import local_mean

    mesh = mesh_lib.make_mesh(("dp", "one"), (4, 1), backend="gloo")
    mesh_2d = mesh_lib.make_mesh(("dp", "sp"), (2, 2), backend="gloo")
    group = mesh.group("dp")
    res = {}

    def ring(name):
        x = torch.from_numpy(inputs[name][rank])
        return quantized_ring_all_reduce(x, group).numpy()

    def tree():
        t = {"w": torch.from_numpy(inputs["tree_w"][rank]),
             "b": torch.from_numpy(inputs["tree_b"][rank]).to(torch.bfloat16)}
        out = quantized_pmean(t, group)
        return {k: (str(v.dtype), tuple(v.shape), _np(v)) for k, v in out.items()}

    def single():
        x = torch.from_numpy(inputs["random"][rank])
        return quantized_ring_all_reduce(x, mesh.group("one")).numpy()

    def mean():
        k = len(inputs["local"]) // 4          # rows of each rank
        x = torch.from_numpy(inputs["local"][rank * k:(rank + 1) * k])
        return local_mean({"x": x}, mesh, axis="dp")["x"].numpy()

    def mean_2d():
        # the same four blocks on a 2 x 2 mesh, averaged over both axes
        k = len(inputs["local"]) // 4
        x = torch.from_numpy(inputs["local"][rank * k:(rank + 1) * k])
        return local_mean(x, mesh_2d, ("dp", "sp")).numpy()

    _run_case(res, "random", lambda: ring("random"))
    _run_case(res, "constant", lambda: ring("constant"))
    _run_case(res, "tree", tree)
    _run_case(res, "single", single)
    _run_case(res, "local_mean", mean)
    _run_case(res, "local_mean_2d", mean_2d)
    return res


# ------------------------------------------------------------ sequence parallel

def _block_of(x: np.ndarray, mesh):
    """This rank's [B/dp, T/sp, ...] block of a global [B, T, ...] array."""
    import torch

    B, T = x.shape[:2]
    nb = B // mesh.size("dp")
    b0 = mesh.rank("dp") * nb
    nt = T // mesh.size("sp")
    t0 = mesh.rank("sp") * nt
    return torch.from_numpy(np.ascontiguousarray(x[b0:b0 + nb, t0:t0 + nt]))


def sp_cases(rank: int, inputs: dict) -> dict:
    import torch

    from pccl_tpu_torch.models import convert, gpt, llama
    from pccl_tpu_torch.ops.ring_attention import make_ring_attn_fn, ring_attention
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import train

    res = {}
    # layouts first: each make_mesh is collective over the world
    layouts = {}
    for name, axes, shape in inputs["layouts"]:
        m = mesh_lib.make_mesh(axes, shape, backend="gloo")
        layouts[name] = (dict(m.shape), dict(m.coords))
    res["layouts"] = layouts
    sp4 = mesh_lib.make_mesh(("dp", "sp"), (1, 4), backend="gloo")
    dp2sp2 = mesh_lib.make_mesh(("dp", "sp"), (2, 2), backend="gloo")

    def attn(mesh, qkv, causal=True):
        q, k, v = (_block_of(x, mesh) for x in inputs[qkv])
        return _np(ring_attention(q, k, v, mesh, causal=causal))

    def grads():
        q, k, v = (_block_of(x, sp4).requires_grad_(True) for x in inputs["qkv_grad"])
        (ring_attention(q, k, v, sp4, batch_axis=None) ** 2).sum().backward()
        return [_np(t.grad) for t in (q, k, v)]

    def forward(mod, key, dtype):
        np_params, tokens = inputs[key]
        cfg = mod.tiny_config(block_size=tokens.shape[1], compute_dtype=dtype)
        params = convert.params_from_numpy(np_params, cfg, device="cpu")
        tok, off = mesh_lib.local_batch(torch.from_numpy(tokens), sp4, "sp")
        with torch.no_grad():
            out = mod.forward(params, tok, cfg, attn_fn=make_ring_attn_fn(sp4),
                              pos_offset=off)
        return _np(out)

    def steps():
        np_params, batches, lr = inputs["train"]
        cfg = gpt.tiny_config(compute_dtype=torch.float32)
        state = train.make_train_state(
            0, cfg, "cpu", lr=lr,
            params=convert.params_from_numpy(np_params, cfg, device="cpu"))
        step = train.build_train_step(cfg, attn_fn=make_ring_attn_fn(sp4),
                                      mesh=sp4, seq_axis="sp")
        losses = [step(state, torch.from_numpy(tok), torch.from_numpy(tgt)).item()
                  for tok, tgt in batches]
        return losses, convert.params_to_numpy(state.params)

    def remat_grads():
        np_params, batches, _ = inputs["train"]
        tok, tgt = (torch.from_numpy(a) for a in batches[0])
        cfg = gpt.tiny_config(compute_dtype=torch.float32)
        out = {}
        for mode in (False, True, "dots", "sqrt"):
            state = train.make_train_state(
                0, cfg, "cpu",
                params=convert.params_from_numpy(np_params, cfg, device="cpu"))
            lg = train.build_loss_and_grad(cfg, attn_fn=make_ring_attn_fn(sp4),
                                           remat=mode, mesh=sp4, seq_axis="sp")
            loss = lg(state, tok, tgt).item()
            out[str(mode)] = (loss, {n: _np(p.grad) for n, p in state.params.items()})
        return out

    _run_case(res, "attn_sp4", lambda: attn(sp4, "qkv"))
    _run_case(res, "attn_dp2sp2", lambda: attn(dp2sp2, "qkv"))
    _run_case(res, "attn_noncausal", lambda: attn(sp4, "qkv", causal=False))
    _run_case(res, "attn_gqa", lambda: attn(sp4, "gqa"))
    _run_case(res, "attn_grads", grads)
    _run_case(res, "gpt_fp32", lambda: forward(gpt, "gpt", torch.float32))
    _run_case(res, "gpt_bf16", lambda: forward(gpt, "gpt", torch.bfloat16))
    _run_case(res, "llama_fp32", lambda: forward(llama, "llama", torch.float32))
    _run_case(res, "train", steps)
    _run_case(res, "remat", remat_grads)
    return res


# ------------------------------------------------------------ tensor parallel

def _tp_params(mod, np_params, dtype, mesh=None, tp_cfg=None):
    """(cfg, full params on the CPU) from a tiny JAX config's numpy
    weights, or (cfg, this rank's blocks) with a mesh."""
    import torch

    from pccl_tpu_torch.models import convert

    cfg = tp_cfg or mod.tiny_config(block_size=64, compute_dtype=dtype)
    full = convert.params_from_numpy(np_params, cfg, device="cpu")
    if mesh is None:
        return cfg, full
    return cfg, convert.shard_params(full, cfg, mesh)


def tp_cases(rank: int, inputs: dict) -> dict:
    import torch

    from pccl_tpu_torch.models import convert, gpt, llama
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import train

    res = {}
    layouts = {}
    for name, axes, shape in inputs["layouts"]:
        m = mesh_lib.make_mesh(axes, shape, backend="gloo")
        layouts[name] = (dict(m.shape), dict(m.coords))
    res["layouts"] = layouts
    tp4 = mesh_lib.make_mesh(("dp", "tp"), (1, 4), backend="gloo")
    tp2 = mesh_lib.make_mesh(("dp", "tp"), (2, 2), backend="gloo")
    meshes = {2: tp2, 4: tp4}

    def roundtrip(mod, tp, **over):
        cfg = mod.tiny_config(**over)
        full = mod.init_params(torch.Generator().manual_seed(tp), cfg)
        local = convert.shard_params(full, cfg, meshes[tp])
        back = convert.gather_params(local, cfg, meshes[tp])
        return {"equal": all(torch.equal(back[k], full[k]) for k in full),
                "local": {k: _np(v) for k, v in local.items()},
                "full": {k: _np(v) for k, v in full.items()}}

    def forward(mod, key, dtype, mesh):
        np_params, tokens = inputs[key]
        cfg, local = _tp_params(mod, np_params, dtype, mesh)
        tok, _ = mesh_lib.local_batch(torch.from_numpy(tokens), mesh)
        with torch.no_grad():
            return _np(mod.forward(local, tok, cfg, tp=mesh.group("tp")))

    def steps(mod, key):
        np_params, batches, lr = inputs[key]
        cfg, full = _tp_params(mod, np_params, torch.float32)
        state = train.make_train_state(0, cfg, "cpu", lr=lr, params=full,
                                       mesh=tp2)
        step = train.build_train_step(cfg, mesh=tp2)
        losses = [step(state, torch.from_numpy(tok), torch.from_numpy(tgt)).item()
                  for tok, tgt in batches]
        gathered = convert.gather_params(state.params, cfg, tp2)
        gains = {k: _np(state.params[k]) for k in ("ln1_g", "ln2_g", "lnf_g")}
        return losses, {k: _np(v) for k, v in gathered.items()}, gains

    def grads(mod, key, mesh, remat=False, tp=True):
        np_params, batches, _ = inputs[key]
        cfg, full = _tp_params(mod, np_params, torch.float32)
        state = train.make_train_state(0, cfg, "cpu", params=full,
                                       mesh=mesh if tp else None)
        lg = train.build_loss_and_grad(cfg, remat=remat,
                                       mesh=mesh if tp else None)
        tok, tgt = (torch.from_numpy(a) for a in batches[0])
        loss = lg(state, tok, tgt).item()
        gr = {n: p.grad for n, p in state.params.items()}
        if tp:
            gr = convert.gather_params(gr, cfg, mesh)
        return loss, {n: _np(g) for n, g in gr.items()}

    def transposes():
        # the unsharded gradient on every rank alone, then the tp=4 one
        return {"full": grads(gpt, "train_gpt", tp4, tp=False),
                "tp": grads(gpt, "train_gpt", tp4)}

    def remat():
        return {str(m): grads(llama, "train_llama", tp2, remat=m)
                for m in (False, True, "dots", "sqrt")}

    def chunked(mod, key):
        # loss_chunk under tp=4: the loss and the gathered gradients
        np_params, batches, _ = inputs[key]
        cfg, full = _tp_params(mod, np_params, torch.float32)
        state = train.make_train_state(0, cfg, "cpu", params=full, mesh=tp4)
        lg = train.build_loss_and_grad(cfg, loss_chunk=16, mesh=tp4)
        tok, tgt = (torch.from_numpy(a) for a in batches[0])
        loss = lg(state, tok, tgt).item()
        gr = convert.gather_params({n: p.grad for n, p in state.params.items()},
                                   cfg, tp4)
        return loss, {n: _np(g) for n, g in gr.items()}

    def shared_kv_roundtrip():
        # the tiny Llama's 2 kv heads over tp=4: ranks 0, 1 hold kv head 0
        cfg = llama.tiny_config()
        full = llama.init_params(torch.Generator().manual_seed(4), cfg)
        local = convert.shard_params(full, cfg, tp4)
        back = convert.gather_params(local, cfg, tp4)
        return {"equal": all(torch.equal(back[k], full[k]) for k in full),
                "local": _np(local["attn_kv"]), "full": _np(full["attn_kv"])}

    def shared_kv_steps():
        # two AdamW steps of the tiny Llama (2 kv heads) at tp=4
        np_params, batches, lr = inputs["train_llama"]
        cfg, full = _tp_params(llama, np_params, torch.float32)
        state = train.make_train_state(0, cfg, "cpu", lr=lr, params=full,
                                       mesh=tp4)
        step = train.build_train_step(cfg, mesh=tp4)
        losses = [step(state, torch.from_numpy(tok), torch.from_numpy(tgt)).item()
                  for tok, tgt in batches]
        gathered = convert.gather_params(state.params, cfg, tp4)
        return losses, {k: _np(v) for k, v in gathered.items()}, \
            _np(state.params["attn_kv"])

    for fam, mod in (("gpt", gpt), ("llama", llama)):
        for tp in (2, 4):
            over = {"n_kv_head": 4} if mod is llama and tp == 4 else {}
            _run_case(res, f"roundtrip_{fam}_{tp}",
                      lambda mod=mod, tp=tp, over=over: roundtrip(mod, tp, **over))
    _run_case(res, "gpt_fp32", lambda: forward(gpt, "gpt", torch.float32, tp4))
    _run_case(res, "gpt_bf16", lambda: forward(gpt, "gpt", torch.bfloat16, tp4))
    _run_case(res, "llama_fp32", lambda: forward(llama, "llama", torch.float32, tp2))
    _run_case(res, "llama_bf16", lambda: forward(llama, "llama", torch.bfloat16, tp2))
    _run_case(res, "train_gpt", lambda: steps(gpt, "train_gpt"))
    _run_case(res, "train_llama", lambda: steps(llama, "train_llama"))
    _run_case(res, "transposes", transposes)
    _run_case(res, "remat", remat)
    _run_case(res, "chunk_gpt", lambda: chunked(gpt, "train_gpt"))
    _run_case(res, "chunk_llama", lambda: chunked(llama, "train_llama"))
    _run_case(res, "kv_shared_roundtrip", shared_kv_roundtrip)
    _run_case(res, "kv_shared_fp32", lambda: forward(llama, "llama", torch.float32, tp4))
    _run_case(res, "kv_shared_bf16", lambda: forward(llama, "llama", torch.bfloat16, tp4))
    _run_case(res, "kv_shared_train", shared_kv_steps)
    return res


# ------------------------------------------------------------ pipeline

def pp_cases(rank: int, inputs: dict) -> dict:
    import torch

    from pccl_tpu_torch.models import convert, gpt
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import pipeline

    res = {}
    meshes = {2: mesh_lib.make_mesh(("dp", "pp"), (2, 2), backend="gloo"),
              4: mesh_lib.make_mesh(("dp", "pp"), (1, 4), backend="gloo")}

    def params_of(key, dtype, mesh):
        np_params, tokens = inputs[key]
        cfg = gpt.GPTConfig(**inputs["cfg"], compute_dtype=dtype)
        full = convert.params_from_numpy(np_params, cfg, device="cpu")
        local = {**full, **pipeline.shard_layer_params(
            {k: full[k] for k in gpt.LAYER_KEYS}, mesh)}
        return cfg, local, torch.from_numpy(tokens)

    def forward(S, M, dtype):
        mesh = meshes[S]
        cfg, local, tok = params_of("fwd", dtype, mesh)
        with torch.no_grad():
            return _np(pipeline.build_pipelined_forward(
                cfg, mesh, microbatches=M)(local, tok))

    def grads():
        mesh = meshes[2]
        cfg, local, tok = params_of("grad", torch.float32, mesh)
        local = {k: v.requires_grad_(True) for k, v in local.items()}
        logits = pipeline.build_pipelined_forward(cfg, mesh)(local, tok)
        loss = -torch.log_softmax(logits, -1).gather(
            -1, tok[..., None].long())[..., 0].mean()
        loss.backward()
        layers = {k: mesh_lib.gather_all(local[k].grad, mesh.group("pp"))
                  for k in gpt.LAYER_KEYS}
        out = {k: _np(torch.cat(v)) for k, v in layers.items()}
        out.update({k: _np(local[k].grad) for k in ("tok_emb", "lnf_g")})
        return loss.item(), out

    for S, M in inputs["schedules"]:
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            _run_case(res, f"fwd_{S}_{M}_{name}",
                      lambda S=S, M=M, dt=dt: forward(S, M, dt))
    _run_case(res, "grads", grads)
    return res


# ------------------------------------------------------------ MoE

def moe_cases(rank: int, inputs: dict) -> dict:
    import torch

    from pccl_tpu_torch.ops import moe
    from pccl_tpu_torch.parallel import mesh as mesh_lib

    res = {}
    meshes = {2: mesh_lib.make_mesh(("dp", "ep"), (2, 2), backend="gloo"),
              4: mesh_lib.make_mesh(("dp", "ep"), (1, 4), backend="gloo")}

    def run(key, S, cf, grad=False):
        np_params, x = inputs[key]
        mesh = meshes[S]
        params = {k: torch.from_numpy(v) for k, v in np_params.items()}
        local = moe.shard_moe_params(params, mesh)
        b = x.shape[0] // S
        r = mesh.rank("ep")
        xl = torch.from_numpy(x[r * b:(r + 1) * b])
        if grad:
            local = {k: v.requires_grad_(True) for k, v in local.items()}
            xl.requires_grad_(True)
        out = moe.moe_mlp_ep(xl, local, mesh, capacity_factor=cf,
                             compute_dtype=torch.float32)
        got = {"out": _np(out)}
        # this rank's routing: (expert, slot) of each token, -1 if dropped
        C = moe.capacity_ep(xl.shape[0] * xl.shape[1], cf, params["gate"].shape[-1])
        dispatch, _ = moe._route(xl.detach().reshape(-1, xl.shape[-1]),
                                 params["gate"], C)
        flat = dispatch.reshape(dispatch.shape[0], -1)
        hit = flat.sum(-1) > 0
        idx = flat.argmax(-1)
        got["route"] = torch.stack([torch.where(hit, idx // C, -1),
                                    torch.where(hit, idx % C, -1)], -1).numpy()
        if grad:
            (out ** 2).sum().backward()
            got["grads"] = {k: _np(v.grad) for k, v in local.items()}
            got["dx"] = _np(xl.grad)
        return got

    for S, E in inputs["configs"]:
        _run_case(res, f"ep_{S}_{E}", lambda S=S, E=E: run(f"moe_{E}", S, float(E)))
    _run_case(res, "grads", lambda: run("grad", 2, 4.0, grad=True))
    _run_case(res, "drops", lambda: run("grad", 2, 0.01))
    _run_case(res, "ragged", lambda: run("ragged", 4, 1.0))
    return res


# ------------------------------------------------------------ DiLoCo mesh

def mesh_cases(rank: int, inputs: dict) -> dict:
    import numpy as np
    import torch

    from pccl_tpu_torch.models import convert, llama
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import train
    from pccl_tpu_torch.parallel.codec import build_codec
    from pccl_tpu_torch.parallel.diloco import Diloco

    res = {}
    mesh = mesh_lib.make_mesh(("dp", "tp"), (1, 2), backend="gloo")

    def adoption():
        # a joiner's adoption on a peer of 2 ranks: the lead's sync writes
        # the winning outer state into its shared-state buffers (a stand-in
        # comm does here), and every rank gets its blocks of it
        cfg = llama.tiny_config(compute_dtype=torch.float32)
        state = train.make_train_state(0, cfg, "cpu", mesh=mesh)
        shards = convert.MeshShards(cfg, mesh)
        dl = Diloco(None, state.params, shards=shards)
        adopted = inputs["adopted"]
        if shards.lead:
            class Won:
                def sync_shared_state(self, st, strategy):
                    np.copyto(dl._ss_vec, adopted)
                    dl._ss_mom[:] = 0.5
                    dl._ss_step[0] = 7
                    return "info"

            dl.comm = Won()
        info = dl.sync_shared_state(params=state.params)
        full = convert.gather_params(state.params, cfg, mesh)
        want = build_codec(full).unflat(torch.from_numpy(adopted))
        return {"info": info, "step": dl.step, "digest": dl.digest(),
                "equal": all(torch.equal(full[k], want[k]) for k in want)}

    _run_case(res, "adoption", adoption)
    return res


def diloco_run(batches, inner_steps: int, lr: float, mesh=None):
    """Sync DiLoCo with no ring (one peer) of the fp32 nano GPT from seed
    0, on the whole model or, with a (dp, tp) mesh, as a peer of its
    ranks (Diloco(shards=MeshShards), build_train_step(mesh=)), an outer
    step after every `inner_steps` of `batches` ([(tokens, targets)],
    numpy). Returns the outer vector (None on a peer's other ranks) and
    the BLAKE2b of this rank's parameters gathered over its tp group."""
    import hashlib

    import torch

    from pccl_tpu_torch.models import convert, gpt
    from pccl_tpu_torch.parallel import train
    from pccl_tpu_torch.parallel.codec import build_codec
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    cfg = gpt.named_config("nano", block_size=batches[0][0].shape[1],
                           compute_dtype=torch.float32)
    state = train.make_train_state(0, cfg, "cpu", lr=lr, mesh=mesh)
    step = train.build_train_step(cfg, mesh=mesh)
    shards = None if mesh is None else convert.MeshShards(cfg, mesh)
    dl = Diloco(None, state.params,
                DilocoConfig(inner_steps=inner_steps, outer_lr=0.7), shards=shards)
    for i, (tok, tgt) in enumerate(batches):
        step(state, torch.from_numpy(tok), torch.from_numpy(tgt))
        if (i + 1) % inner_steps == 0:
            dl.outer_step(state.params)
    full = state.params if mesh is None else \
        convert.gather_params(state.params, cfg, mesh)
    flat = build_codec(full).flat(full).detach()
    return (_np(dl.outer_vec) if dl.lead else None,
            hashlib.blake2b(flat.numpy().data, digest_size=16).hexdigest())


def dp_tp_cases(rank: int, inputs: dict) -> dict:
    from pccl_tpu_torch.parallel import mesh as mesh_lib

    res = {}
    mesh = mesh_lib.make_mesh(("dp", "tp"), (2, 4), backend="gloo")
    _run_case(res, "diloco", lambda: diloco_run(mesh=mesh, **inputs))
    return res
