#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pccl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device: CUDA must be available; prints the card's name and power limit;
2. build: the CUDA kernels (one nvcc per pccl_tpu_torch/csrc/*.cu, all at
   once, with ptxas resource reports) and, when no library is found,
   libpcclt.so from pccl_tpu/native/src, in parallel;
3. kernels: K1 (forward), K2 (dq) and K3 (dk, dv) against their plain
   PyTorch versions (fp32 on the same bf16 inputs) at three shapes: the
   main path's, a GQA shape at head dim 128, and a ragged non-causal shape;
   with median CUDA-event times of the kernel, the plain version,
   F.scaled_dot_product_attention (a yardstick; the port never calls it) and
   the least time the card could take;
4. model: a 2-layer GPT at GPT-2 widths in bf16 on the card, flash kernels
   against dense attention (loss and gradients);
5. main path: a master and two sync-DiLoCo peers (GPT-2 124M, B=8, T=1024,
   4 inner steps, 2 outer steps) on the same card over the native ring. Both
   peers must exit 0 with world 2, finite losses, equal outer-state digests
   at every outer step and every kernel launched.

Then one JSON line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.

Bounds use the H100 SXM datasheet figures: 989 TFLOP/s dense bf16 and
3.35 TB/s of HBM bandwidth.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
LOG_DIR = REPO / "build" / "chip_smoke"
PEAK_FLOPS = 989e12     # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12    # H100 SXM, HBM3

# name, route, source, the TPU kernel it replaces
KERNELS = [
    ("flash_fwd", "pccl_tpu_torch/csrc/flash_fwd.cu",
     "pccl_tpu/ops/flash_attention.py:83"),
    ("flash_bwd_dq", "pccl_tpu_torch/csrc/flash_bwd.cu",
     "pccl_tpu/ops/flash_attention.py:195"),
    ("flash_bwd_dkv", "pccl_tpu_torch/csrc/flash_bwd.cu",
     "pccl_tpu/ops/flash_attention.py:231"),
]

SHAPES = [
    ("main", dict(B=8, T=1024, H=12, Hkv=12, D=64, causal=True)),
    ("gqa", dict(B=1, T=2048, H=32, Hkv=8, D=128, causal=True)),
    ("ragged", dict(B=2, T=1000, H=4, Hkv=4, D=64, causal=False)),
]

# Each output is held two ways, so that neither its largest elements nor its
# bulk can hide an error (causal rows differ in size by tens of times: row 0
# is one v row, deep rows average hundreds):
#   ||got - ref|| / ||ref|| <= rel, and
#   every element |got - ref| <= atol * rms(ref) + rtol * |ref|.
# The kernels round their outputs to bf16 (2^-9 relative; rtol is one bf16
# ulp) and, like the TPU kernels, cast p and ds to bf16 before the second
# product; fp32 lse only sees exp/log and summation order.
TOL = {  # name: (rel, atol, rtol)
    "out": (1e-2, 0.15, 2 ** -8), "lse": (2e-7, 1e-6, 5e-7),
    "dq": (1e-2, 0.15, 2 ** -8), "dk": (1e-2, 0.15, 2 ** -8),
    "dv": (1e-2, 0.15, 2 ** -8)}

MAIN = dict(model="gpt2", block=1024, batch=8, inner_steps=4, outer_steps=2)
PEER_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeError(RuntimeError):
    pass


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 2

def phase_build() -> None:
    from pccl_tpu_torch.comm import _native
    from pccl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    found = _native.find_library()
    with ThreadPoolExecutor(2) as ex:
        kernels = ex.submit(_build.build_kernels, True)
        core = ex.submit(_build.build_pcclt) if found is None else None
        report = kernels.result()
        lib = core.result() if core is not None else found
    for line in report.splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            log(f"  ptxas: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s (kernels in {_build.BUILD_DIR}; "
        f"libpcclt {'built' if core is not None else 'found'} at {lib})")


# ------------------------------------------------------------------ phase 3

def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() by CUDA events, one pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def visible_pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


def bounds(B, T, H, Hkv, D, causal):
    """Least time in ms of each kernel on this data: max(FLOPs of its
    products over the bf16 peak, bytes read once and written once over the
    HBM rate), and which of the two bounds it."""
    pairs = B * H * visible_pairs(T, causal)
    q_b, kv_b, vec_b = B * T * H * D * 2, B * T * Hkv * D * 2, B * H * T * 4
    work = {
        # QK^T and PV
        "flash_fwd": (4 * pairs * D, 2 * q_b + 2 * kv_b + vec_b),
        # QK^T, dO V^T, dS K
        "flash_bwd_dq": (6 * pairs * D, 3 * q_b + 2 * kv_b + 2 * vec_b),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (8 * pairs * D, 2 * q_b + 4 * kv_b + 2 * vec_b),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def compare(name: str, got, ref) -> dict:
    """The error of one output against TOL[name]: max |got - ref|, the
    relative L2 error, and the least atol (in units of rms(ref)) every
    element would pass with."""
    rel_tol, atol_tol, rtol = TOL[name]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rms = ref.pow(2).mean().sqrt()
    e = {"max_abs": err.max().item(),
         "rel": (err.norm() / ref.norm()).item(),
         "atol": ((err - rtol * ref.abs()) / rms).max().item()}
    e["ok"] = all(math.isfinite(x) for x in e.values()) \
        and e["rel"] <= rel_tol and e["atol"] <= atol_tol
    return e


def fmt_err(name: str, e: dict) -> str:
    rel_tol, atol_tol, _ = TOL[name]
    return (f"{name} max {e['max_abs']:.3e} rel {e['rel']:.3e} (tol {rel_tol:g}) "
            f"atol {e['atol']:.3e} (tol {atol_tol:g})")


def check_the_check(qf, kf, vf, dof, lse, delta, causal, refs) -> None:
    """The check must reject what a kernel that skips one 64-wide tile of
    its loop would give: out and dq without one k tile's v (its P.V and
    dO.V^T shares), dk and dv without one q tile's share. The tile sits at
    T/2, so under the causal mask only the deep rows miss it."""
    from pccl_tpu_torch.ops import flash_attention as fa

    t0 = qf.shape[1] // 2
    v_cut, do_cut, delta_cut = vf.clone(), dof.clone(), delta.clone()
    v_cut[:, t0:t0 + 64] = 0
    do_cut[:, t0:t0 + 64] = 0
    delta_cut[..., t0:t0 + 64] = 0
    bad = {"out": fa.flash_fwd_plain(qf, kf, v_cut, causal)[0],
           "dq": fa.flash_bwd_dq_plain(qf, kf, v_cut, dof, lse, delta, causal)}
    bad["dk"], bad["dv"] = fa.flash_bwd_dkv_plain(qf, kf, vf, do_cut, lse,
                                                  delta_cut, causal)
    for name, x in bad.items():
        e = compare(name, x.bfloat16(), refs[name])
        log(f"  control, one tile skipped: {fmt_err(name, e)}")
        if e["ok"]:
            raise SmokeError(f"the {name} check passes an output that skips a tile")


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from pccl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    results = {}
    for tag, s in SHAPES:
        B, T, H, Hkv, D, causal = (s[k] for k in ("B", "T", "H", "Hkv", "D", "causal"))
        gen = torch.Generator(device=dev).manual_seed(1234)

        def rnd(heads):
            return torch.randn((B, T, heads, D), generator=gen, device=dev,
                               dtype=torch.bfloat16)

        q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()

        out, lse = fa.flash_fwd(q, k, v, causal)
        ref_out, ref_lse = fa.flash_fwd_plain(qf, kf, vf, causal)
        # both backward versions get the same lse and delta
        delta = (dof * ref_out).sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
        ref_dq = fa.flash_bwd_dq_plain(qf, kf, vf, dof, ref_lse, delta, causal)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(qf, kf, vf, dof, ref_lse, delta, causal)
        torch.cuda.synchronize()

        pairs = (("out", out, ref_out), ("lse", lse, ref_lse), ("dq", dq, ref_dq),
                 ("dk", dk, ref_dk), ("dv", dv, ref_dv))
        errs = {name: compare(name, got, ref) for name, got, ref in pairs}
        if tag == "main":
            check_the_check(qf, kf, vf, dof, ref_lse, delta, causal, dict(
                (name, ref) for name, _, ref in pairs))

        ms = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal)),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, ref_lse,
                                                            delta, causal)),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, ref_lse,
                                                              delta, causal)),
        }
        plain_ms = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(qf, kf, vf, causal), reps=5),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_plain(
                qf, kf, vf, dof, ref_lse, delta, causal), reps=5),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
                qf, kf, vf, dof, ref_lse, delta, causal), reps=5),
        }
        # library yardstick: SDPA forward, and its backward (one call that
        # computes dq, dk and dv together; it stands beside K2 and K3)
        qs, ks, vs = (x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v))
        gqa = H != Hkv

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                  enable_gqa=gqa)

        o_s = sdpa()
        do_s = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s,
                                                       retain_graph=True))
        library_ms = {"flash_fwd": cuda_ms(sdpa), "flash_bwd_dq": sdpa_bwd,
                      "flash_bwd_dkv": sdpa_bwd}
        bnd = bounds(B, T, H, Hkv, D, causal)

        ok = all(e["ok"] for e in errs.values())
        log(f"kernels @ {tag} {s}:")
        for name, e in errs.items():
            log(f"  {fmt_err(name, e)}{'' if e['ok'] else '  FAIL'}")
        for name, _, _ in KERNELS:
            log(f"  {name}: kernel {ms[name]:.3f} ms, plain {plain_ms[name]:.3f} ms, "
                f"sdpa {library_ms[name]:.3f} ms, bound {bnd[name][0]:.4f} ms "
                f"({bnd[name][1]})")
        results[tag] = dict(errs=errs, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bounds=bnd, ok=ok)
        del q, k, v, do, qf, kf, vf, dof, out, lse, ref_out, ref_lse, delta
        del dq, dk, dv, ref_dq, ref_dk, ref_dv, qs, ks, vs, o_s, do_s
        torch.cuda.empty_cache()
        if not ok:
            raise SmokeError(f"kernels disagree with their plain versions at {tag}")
    return results


# ------------------------------------------------------------------ phase 4

def phase_model() -> None:
    """A 2-layer GPT at GPT-2 widths, bf16: flash kernels vs dense
    attention."""
    import torch

    from pccl_tpu_torch.models import gpt
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib

    cfg = gpt.named_config("gpt2", n_layer=2, block_size=256)
    state = train_lib.make_train_state(0, cfg, "cuda")
    params = list(state.params.values())
    rng = torch.Generator().manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (2, 256), generator=rng).cuda()
    tgt = torch.randint(0, cfg.vocab_size, (2, 256), generator=rng).cuda()
    res = {}
    for name, attn in (("flash", fa.flash_attention), ("dense", None)):
        loss = gpt.loss_fn(state.params, tok, tgt, cfg, attn_fn=attn)
        grads = torch.autograd.grad(loss, params)
        res[name] = (loss.item(), torch.cat([g.float().reshape(-1) for g in grads]))
    (lf, gf), (ld, gd) = res["flash"], res["dense"]
    cos = torch.nn.functional.cosine_similarity(gf, gd, dim=0).item()
    log(f"model (gpt2 widths, 2 layers, bf16): loss flash {lf:.5f} dense {ld:.5f}, "
        f"grad cosine {cos:.6f}")
    # limits at a few times the gap the two bf16 paths show (6e-5 nats and
    # 1 - cosine 4e-5 on an H100 80GB HBM3 at 700 W): a layer with a wrong
    # attention moves both by far more
    if not (math.isfinite(lf) and abs(lf - ld) <= 1e-3 and cos >= 0.9998):
        raise SmokeError("model with flash kernels disagrees with dense attention")
    del state, params, res, gf, gd
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5

LINE = re.compile(r"outer (\d+) loss (\S+) world (\d+) revision (\d+) tok_s (\S+) "
                  r"outer_s (\S+) launches (\d+) (\d+) (\d+) digest (\w+)")


def free_ports(n: int, offsets=(0,)) -> list:
    """n base ports chosen by the OS, each with base + offset free for every
    offset (a peer listens at base, base+4 and base+8). All are held until
    the n are found, so two bases never share a port, and two smoke runs on
    one machine do not meet."""
    held, bases = [], []
    try:
        while len(bases) < n:
            s = socket.socket()
            held.append(s)
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
            try:
                for off in offsets[1:]:
                    t = socket.socket()
                    held.append(t)
                    t.bind(("127.0.0.1", base + off))
            except OSError:
                continue
            bases.append(base)
    finally:
        for s in held:
            s.close()
    return bases


def stop(proc) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


def phase_main_path() -> dict:
    """Master + two peers; returns per-kernel launch totals and the peers'
    per-outer-step records."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    py = sys.executable
    port, = free_ports(1)
    procs, files, peers = [], [], []
    try:
        files.append(open(LOG_DIR / "master.log", "w"))
        master = subprocess.Popen(
            [py, "-m", "pccl_tpu_torch.comm.master", "--listen", "127.0.0.1",
             "--port", str(port)], cwd=REPO, env=env, stdout=files[-1],
            stderr=subprocess.STDOUT)
        procs.append(master)
        deadline = time.time() + 60
        while "master listening" not in (LOG_DIR / "master.log").read_text():
            if master.poll() is not None or time.time() > deadline:
                raise SmokeError("master did not start: "
                                 + (LOG_DIR / "master.log").read_text())
            time.sleep(0.2)
        for rank, base in enumerate(free_ports(2, offsets=(0, 4, 8))):
            files.append(open(LOG_DIR / f"peer{rank}.log", "w"))
            cmd = [py, "-m", "pccl_tpu_torch.examples.sync_diloco",
                   "--master-port", str(port), "--base-port", str(base),
                   "--data-shard", str(rank),
                   "--min-world", "2", "--model", MAIN["model"],
                   "--block", str(MAIN["block"]), "--batch", str(MAIN["batch"]),
                   "--inner-steps", str(MAIN["inner_steps"]),
                   "--outer-steps", str(MAIN["outer_steps"]),
                   "--device", "cuda", "--attn", "flash",
                   # 8 steps from random init at GPT-2 width cannot show
                   # learning (AdamW without warmup moves the loss up and
                   # down by ~0.1 there); the check here is the ring's
                   # invariant: equal outer digests on both peers
                   "--no-descent-check"]
            peers.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=files[-1],
                                          stderr=subprocess.STDOUT))
            procs.append(peers[-1])
        deadline = time.time() + PEER_TIMEOUT_S
        try:
            for p in peers:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            raise SmokeError(f"peers still running after {PEER_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            stop(p)
        for f in files:
            f.close()
        for rank in range(len(peers)):
            for line in (LOG_DIR / f"peer{rank}.log").read_text().splitlines():
                log(f"  peer{rank}| {line}")
    records = []
    for rank, p in enumerate(peers):
        text = (LOG_DIR / f"peer{rank}.log").read_text()
        if p.returncode != 0:
            raise SmokeError(f"peer {rank} exited {p.returncode}")
        rows = [m.groups() for m in LINE.finditer(text)]
        if len(rows) != MAIN["outer_steps"] or "FINAL" not in text:
            raise SmokeError(f"peer {rank}: expected {MAIN['outer_steps']} outer "
                             f"lines and FINAL")
        records.append(rows)
    totals = {name: 0 for name, _, _ in KERNELS}
    for rank, rows in enumerate(records):
        for row in rows:
            loss, world = float(row[1]), int(row[2])
            if not math.isfinite(loss) or world != 2:
                raise SmokeError(f"peer {rank}: loss {loss}, world {world}")
            for (name, _, _), n in zip(KERNELS, row[6:9]):
                if int(n) <= 0:
                    raise SmokeError(f"peer {rank}: {name} never launched")
                totals[name] += int(n)
    for step in range(MAIN["outer_steps"]):
        digests = {rows[step][9] for rows in records}
        if len(digests) != 1:
            raise SmokeError(f"outer step {step}: digests differ across peers: "
                             f"{sorted(digests)}")
    log(f"main path: 2 peers, world 2, digests equal at every outer step, "
        f"launches {totals}")
    return {"launches": totals, "records": records}


# ------------------------------------------------------------------ main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    kres = phase_kernels()
    phase_model()
    from pccl_tpu_torch.ops import flash_attention as fa

    # the main path runs in the peer processes, whose counts start at 0;
    # the comparisons above do not count
    fa.reset_launch_counts()
    main_path = phase_main_path()

    m = kres["main"]
    out_names = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
                 "flash_bwd_dkv": ("dk", "dv")}
    kernels = []
    for name, source, replaces in KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": max(m["errs"][o]["max_abs"] for o in out_names[name]),
            "ms": m["ms"][name], "plain_ms": m["plain_ms"][name],
            "bound_ms": m["bounds"][name][0], "bound_by": m["bounds"][name][1],
            "library_ms": m["library_ms"][name],
            "ok": all(r["ok"] for r in kres.values()),
        })
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
