"""A gloo world of spawned ranks for the port's collective tests, and the
cases each rank runs (tests/test_torch_sp.py, tests/test_torch_quantized.py).

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
