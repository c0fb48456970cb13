#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pccl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device: CUDA must be available; prints the card's name and power limit;
2. build: the CUDA kernels (one nvcc per pccl_tpu_torch/csrc/*.cu, all at
   once, with ptxas resource reports) and libpcclt.so from
   pccl_tpu/native/src, in parallel. The library is always rebuilt here
   (a copied tree may carry one built on another machine) and every
   process of the smoke loads it through PCCLT_LIB. Every kernel must
   show 0 bytes of spills, and K1, K2 and K3, where cuobjdump is found,
   HGMMA and UTMALDG instructions in their SASS (whose highest register
   index is logged);
3. kernels: K1 (forward), K2 (dq) and K3 (dk, dv) against their plain
   PyTorch versions (fp32 on the same bf16 inputs) at three shapes: the
   main path's, a GQA shape at head dim 128, and a ragged non-causal shape;
   with CUDA-event times (`cuda_ms`) of the kernel, the plain version,
   F.scaled_dot_product_attention (a yardstick; the port never calls it) and
   the least time the card could take; and the backward's total, K2 + K3,
   beside SDPA's backward, which computes dq, dk and dv in one call;
3b. hash: H1 (the `simple-tpu` content hash) bit for bit against its plain
   version on the card, the numpy twin and the C++ core's pccltHashBuffer,
   at ragged byte counts, bf16, int8, uint64 and GPT-2's tok_emb; a one-bit
   flip must change the digest; times of H1 at tok_emb and over the 25
   entries of a GPT-2 sync, the plain version, the bound, a one-read
   yardstick (half the time of a copy_ of the same bytes) beside an int32
   sum over them, and the host's cost of the 8-byte readbacks;
4. model: a 2-layer GPT at GPT-2 widths in bf16 on the card, flash kernels
   against dense attention (loss and gradients);
5. main path, sync DiLoCo: a master and two peers (GPT-2 124M, B=8, T=1024,
   4 inner steps, 2 outer steps) on the same card over the native ring. Both
   peers must exit 0 with world 2, finite losses, equal outer-state digests
   at every outer step and every kernel launched;
6. main path, DDP with shared-state sync hashed by H1: a master and two
   `train_ddp` peers (GPT-2 124M, B=8, T=1024, PCCLT_SS_HASH=simple-tpu;
   the first stages its gradients through registered shm, --shm-staging,
   the others through pinned buffers), and a third that starts once the first has logged step 2 and adopts the
   cohort's parameters and AdamW state. Syncs move no bytes before it
   comes and after it adopted; it receives every entry's bytes; the three
   print equal digests at every common step and equal final parameters;
   every kernel (K1-K3 and H1) is launched on every peer;
7. main path, async DiLoCo on Llama-700m (GQA: 12 q heads over 4 kv heads,
   head dim 128): a master and two `async_diloco` peers (B=2, T=2048, 8
   inner steps, 3 outer steps). Every line must show world 2 and a finite
   loss, K1-K3 launched on both peers, and equal outer-state digests at
   every outer step and after finish(), and the --profile table of each;
   logs tok_s, join_s (the wait for the previous step's reduce) and each
   peer's peak allocation;
7b. the outer step's routes at Llama-700m's parameter count: two peers in
   this process, each a Diloco over one fp32 vector of 702,359,040 elements
   on the card (outer lr 1, no momentum, inner = outer - (rank + 1)): the
   pipelined windowed reduce through registered shm (4 windows), then the
   staged and the unstaged ring, two outer steps each. The results must be
   exactly -1.5 and -3 everywhere and bit-identical on both peers; logs
   each step's profile (D2H, stage copy, ring, H2D and apply): the first
   step pays each buffer's allocation and first touch, the second is warm;
8. accumulation and remat at Llama-700m (L=24, T=2048), in this process:
   on the same weights and 4 sequences, train.build_loss_and_grad with
   remat False, True, "dots" and "sqrt" at A=1, B=4, then A=2, B=2 at
   remat False. Each logs what the forward holds for the backward
   (allocation when loss_fn returns, less the allocation before), the
   peak over the call, the step ms, K1-K3 launches, the loss and the
   gradients' cosine against remat False at A=1. Fails unless every loss
   is within 1e-3 nats and every cosine >= 0.9998 of that reference; K2
   and K3 launch L times per microbatch; K1 L times for False, 2L for True
   and "dots", 3L - L/G for "sqrt" (G = 4; the CPU test
   test_torch_remat.py explains the early stop behind - L/G); what the
   forward holds orders sqrt < True < dots < False; and the peak at A=2
   lies below the peak at A=1;
9. sync DiLoCo resume, GPT-2 widths with byte-level text data (vocab
   256), two peers (B=8, T=1024, H=4, cosine schedule, a checkpoint every
   outer step, --profile and --trace-out): 2 outer steps, then the peers
   and the master stop and a fresh master and both peers run to 3. Each must print `resumed from
   outer step 2` with the digest outer step 1 printed, the peers' digests
   must agree at every step, each trace must hold one process_name event
   and one event per section entered, and the table must list `inner` and
   `outer/ring+sgd`;
10. DDP with accumulation, eval and resume, the same model, two peers
   (PCCLT_SS_HASH=simple-tpu; A=2, B=4, T=1024, eval every 3 steps, a
   checkpoint at step 6): 6 steps, then both restart against a
   fresh master and run to 9. Both must print `resumed from step 6`, probe
   at revision 0, agree on the digest at every step and on the final
   parameters, and print eval lines; logs peak allocation, ring_s, tok_s
   (A·B·T tokens a step) and the checkpoint's size and times;
11. the 2D grid: a master and four `grid_diloco` cells on the card (GPT-2
   124M, B=8, T=1024, 4 inner and 12 outer steps; 2 outer-state shards x 2
   replicas, one ring per shard, one grid file). Every line must show the
   grid 2x2 at global world 4, the two cells of each group equal shard
   digests at every outer step, every sync after the first 0 bytes (the
   shard bit-identical across the group), falling losses and K1-K3
   launched; logs each cell's tok_s, outer_s, peak allocation and RSS;
12. the comm surface: three communicators in this process, vectors on the
   card staged through pinned host buffers: broadcast of the GPT-2 flat
   parameters from slot 1 (bit-equal to the root's on every peer),
   reduce_scatter of as many integer-valued floats (each chunk bit-equal
   to the card's own sum of the three inputs; integer values make the
   fold order-free), all_gather of each peer's 25 H1 digests of a GPT-2
   state (each at its gather_slot everywhere), all_to_all of three blocks,
   the edges' tx_bytes against the bytes the ops sent, ring events in the
   flight recorder, and an all-reduce after optimize_topology, bit-equal
   across the peers.

Every peer's FINAL line reports its own peak host RSS: each is started
through a relay that forks it (utils/rss.relay_argv): a user-space kernel
(gVisor) may have no VmHWM, and ru_maxrss passes from launcher to child.

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
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
LOG_DIR = REPO / "build" / "chip_smoke"
PEAK_FLOPS = 989e12     # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12    # H100 SXM, HBM3

# name, source, the TPU kernel it replaces, ptxas's mangled names of its
# kernels and how many there are (the flash kernels at both head dims, H1's
# two passes), and whether its machine code must hold wgmma (HGMMA) and TMA
# loads (UTMALDG). None may spill.
KERNELS = [
    ("flash_fwd", "pccl_tpu_torch/csrc/flash_fwd.cu",
     "pccl_tpu/ops/flash_attention.py:83", r"flash_fwd_kernelILi(64|128)E", 2, True),
    ("flash_bwd_dq", "pccl_tpu_torch/csrc/flash_bwd.cu",
     "pccl_tpu/ops/flash_attention.py:195", r"flash_bwd_dq_kernelILi(64|128)E",
     2, True),
    ("flash_bwd_dkv", "pccl_tpu_torch/csrc/flash_bwd_dkv.cu",
     "pccl_tpu/ops/flash_attention.py:231", r"flash_bwd_dkv_kernelILi(64|128)E",
     2, True),
    ("simplehash_tpu", "pccl_tpu_torch/csrc/simplehash_tpu.cu",
     "pccl_tpu/ops/hashing.py:241", r"simplehash_tpu_(planes|fold)", 2, False),
]
FLASH = [k[0] for k in KERNELS[:3]]


SHAPES = [
    ("main", dict(B=8, T=1024, H=12, Hkv=12, D=64, causal=True)),
    ("gqa", dict(B=1, T=2048, H=32, Hkv=8, D=128, causal=True)),
    ("ragged", dict(B=2, T=1000, H=4, Hkv=4, D=64, causal=False)),
    # phase 7's attention: Llama-700m, G = 3 q heads per kv head
    ("llama700m", dict(B=2, T=2048, H=12, Hkv=4, D=128, causal=True)),
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

# the first spin ahead of a timed batch: ~5 ms at the H100's 1.98 GHz boost
# clock (cuda_ms doubles it where 20 calls' host work takes longer)
HOST_LEAD_CYCLES = 10_000_000

MAIN = dict(model="gpt2", block=1024, batch=8, inner_steps=4, outer_steps=2)
DDP = dict(model="gpt2", block=1024, batch=8, steps=80)
ASYNC = dict(family="llama", model="700m", block=2048, batch=2, inner_steps=8,
             outer_steps=3)
LLAMA700M_PARAMS = 702_359_040
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

SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
ENTRY = re.compile(r"Compiling entry function '(\w+)'")


def spills(report: str) -> dict:
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    ptxas -v output."""
    out, entry = {}, None
    for line in report.splitlines():
        m = ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = SPILL.search(line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), int(m.group(2)))
    return out


def sass_counts(lib: Path, cuobjdump: str) -> tuple:
    """HGMMA and UTMALDG counts in a library's SASS, and the highest register
    index each of its kernels touches, by head dim (a kernel that asks for
    more registers by setmaxnreg than ptxas reports shows here whether
    ptxas used them)."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
    top = {}
    for part in sass.split("Function : ")[1:]:
        dh = re.search(r"ILi(\d+)E", part.split("\n", 1)[0])
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        if dh and regs:
            top[f"Dh {dh.group(1)}"] = f"R{max(regs)}"
    return counts, top


def phase_build() -> None:
    from pccl_tpu_torch.comm import _native
    from pccl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        kernels = ex.submit(_build.build_kernels, True)
        core = ex.submit(_build.build_pcclt, True)
        report = kernels.result()
        lib = core.result()
    # this process and every peer it starts load the library just built
    os.environ["PCCLT_LIB"] = str(lib)
    if _native.find_library() != lib:
        raise SmokeError(f"the port would load {_native.find_library()}, not {lib}")
    for line in report.splitlines():
        if re.search(r"Compiling entry|registers|spill|warning", line):
            log(f"  ptxas: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s (kernels in {_build.BUILD_DIR}; "
        f"libpcclt rebuilt at {lib})")
    spilled = spills(report)
    cuobjdump = shutil.which("cuobjdump") \
        or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    for name, source, _, fn, builds, wgmma in KERNELS:
        entries = {e: sp for e, sp in spilled.items() if re.search(fn, e)}
        if len(entries) != builds:
            raise SmokeError(f"ptxas reported {len(entries)} builds of {fn}, "
                             f"not {builds}")
        bad = {e: sp for e, sp in entries.items() if sp != (0, 0)}
        if bad:
            raise SmokeError(f"{fn} spills (store, load bytes): {bad}")
        if not wgmma:
            log(f"  {name}: 0 bytes of spills")
            continue
        if not Path(cuobjdump).exists():
            log(f"  {name}: 0 bytes of spills; no cuobjdump, SASS not counted")
            continue
        counts, top = sass_counts(_build.BUILD_DIR / f"lib{Path(source).stem}.so",
                                  cuobjdump)
        log(f"  {name}: 0 bytes of spills; SASS {counts}, highest register {top}")
        if not all(counts.values()):
            raise SmokeError(f"{name}: no HGMMA or no UTMALDG in its SASS: {counts}")


# ------------------------------------------------------------------ phase 3

def cuda_ms(fn, calls: int = 20, pairs: int = 5, warmup: int = 3) -> float:
    """Milliseconds per call of fn(): `calls` back-to-back calls between one
    pair of CUDA events, divided by `calls`; the median of `pairs` such
    batches, after `warmup` calls. Each batch is queued behind a spin on the
    card, so that the host has queued every call before the first event
    fires and the figure holds the card's time only, not the host's work
    before each launch. A batch whose host side outlasted the spin is timed
    again behind a spin twice as long. fn must not wait for the card, or no
    spin is long enough: that is refused past a spin of ~5 s."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, times = HOST_LEAD_CYCLES, []
    while len(times) < pairs:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if host_ms >= s.elapsed_time(a):
            if cycles >= HOST_LEAD_CYCLES << 10:
                raise SmokeError("cuda_ms: the host never got ahead of a 5 s "
                                 "spin; the timed function waits for the card")
            cycles *= 2
            continue
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def synced_ms(fn, calls: int = 3, warmup: int = 1) -> float:
    """Milliseconds per call of fn() on the host clock between two
    synchronisations, launch overhead included: for a function that
    launches too many kernels to queue behind cuda_ms's spin (the launch
    queue fills, and the host waits for the card)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


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
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(qf, kf, vf, causal), calls=3),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_plain(
                qf, kf, vf, dof, ref_lse, delta, causal), calls=3),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
                qf, kf, vf, dof, ref_lse, delta, causal), calls=3),
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
        for name in FLASH:
            log(f"  {name}: kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.3f} ms, "
                f"sdpa {library_ms[name]:.4f} ms, bound {bnd[name][0]:.4f} ms "
                f"({bnd[name][1]})")
        bwd = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
        log(f"  backward: K2 + K3 {bwd:.4f} ms, sdpa bwd {sdpa_bwd:.4f} ms "
            f"({bwd / sdpa_bwd:.2f}x), bounds K2 + K3 "
            f"{bnd['flash_bwd_dq'][0] + bnd['flash_bwd_dkv'][0]:.4f} ms")
        results[tag] = dict(errs=errs, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bounds=bnd, ok=ok)
        del q, k, v, do, qf, kf, vf, dof, out, lse, ref_out, ref_lse, delta
        del dq, dk, dv, ref_dq, ref_dk, ref_dv, qs, ks, vs, o_s, do_s
        torch.cuda.empty_cache()
        if not ok:
            raise SmokeError(f"kernels disagree with their plain versions at {tag}")
    return results


# ------------------------------------------------------------------ phase 3b

# byte counts across H1's edges: under one word, one word, ragged words,
# exactly one and two lane rows and just past them, and 4 rows
HASH_BYTES = [1, 3, 4, 17, 65536 * 4, 65536 * 4 + 4, 65536 * 8 + 7, 1 << 20]
GPT2_PARAM_BYTES = 494_349_312   # 123,587,328 fp32 parameters


def gpt2_sync_entries(dev) -> list:
    """Tensors shaped as the 25 device-hashed entries of a GPT-2 DDP sync:
    8 parameters, AdamW's count, and mu and nu of each parameter."""
    import torch

    from pccl_tpu_torch.models import gpt

    shapes = list(gpt.param_shapes(gpt.named_config("gpt2")).values())
    xs = [torch.randn(s, device=dev) for s in shapes]
    return xs + [torch.zeros((), dtype=torch.int32, device=dev)] \
        + [torch.randn(s, device=dev) for s in shapes * 2]


def phase_hash() -> dict:
    """H1 against its plain version on the card, the numpy twin and
    pccltHashBuffer(2, ...), bit for bit; times, bound and yardstick."""
    import numpy as np
    import torch

    from pccl_tpu_torch.comm import _native
    from pccl_tpu_torch.ops import hashing

    dev = torch.device("cuda")
    lib = _native.load()
    gen = torch.Generator(device=dev).manual_seed(99)
    tok_emb = torch.randn((50304, 768), generator=gen, device=dev)
    cases = [(f"u8 x {n}", torch.randint(0, 256, (n,), generator=gen, device=dev,
                                         dtype=torch.uint8)) for n in HASH_BYTES]
    cases += [
        ("bf16 x 196609", torch.randn(3 * 65536 + 1, generator=gen,
                                      device=dev).bfloat16()),
        ("i8 x 131075", torch.randint(-128, 128, (131075,), generator=gen,
                                      device=dev, dtype=torch.int8)),
        ("u64 x 100003", torch.randint(-2 ** 62, 2 ** 62, (100003,), generator=gen,
                                       device=dev, dtype=torch.int64).view(torch.uint64)),
        ("tok_emb fp32 50304 x 768", tok_emb),
    ]
    max_err = 0    # the largest |kernel - plain| over every plane compared
    for tag, t in cases:
        kernel = hashing.device_planes(t)
        plain = hashing.planes_plain(t)
        digest = hashing.torch_simplehash_device(t)
        host = t.reshape(-1).view(torch.uint8).cpu().numpy()
        twin = hashing.simplehash_tpu(host)
        native = lib.pccltHashBuffer(2, host.ctypes.data, host.size)
        max_err = max(max_err, int((kernel - plain).abs().max()))
        ok = torch.equal(kernel, plain) and digest == twin == native
        log(f"  H1 {tag}: planes {kernel.tolist()} plain {plain.tolist()}, digest "
            f"{digest:016x} twin {twin:016x} native {native:016x}"
            f"{'' if ok else '  FAIL'}")
        if not ok:
            raise SmokeError(f"H1 disagrees at {tag}")
    empty = torch.empty(0, device=dev)
    if hashing.torch_simplehash_device(empty) != lib.pccltHashBuffer(2, None, 0):
        raise SmokeError("the 0-byte digest differs from the native one")
    base = hashing.torch_simplehash_device(tok_emb)
    words = tok_emb.numel()
    for w in (0, 65535, 65536, words - 1):
        flip = tok_emb.view(torch.int32).clone().reshape(-1)
        flip[w] ^= 1
        if hashing.torch_simplehash_device(flip) == base:
            raise SmokeError(f"a one-bit flip at word {w} leaves the digest as is")
    log("  H1: a one-bit flip at words 0, 65535, 65536 and the last changes "
        "the digest")

    entries = gpt2_sync_entries(dev)
    sync_bytes = sum(x.numel() * x.element_size() for x in entries)
    if sync_bytes != 3 * GPT2_PARAM_BYTES + 4:
        raise SmokeError(f"GPT-2 sync entries hold {sync_bytes} bytes")
    nbytes = tok_emb.numel() * 4
    copy_dst = torch.empty_like(tok_emb)
    res = {
        "cases": len(cases), "max_abs_err": max_err,
        "ms": cuda_ms(lambda: hashing.device_planes(tok_emb)),
        # the plain version launches some 600 small kernels a call
        "plain_ms": synced_ms(lambda: hashing.planes_plain(tok_emb)),
        "bound_ms": nbytes / PEAK_BYTES * 1e3,
        "sum_ms": cuda_ms(lambda: tok_emb.view(torch.int32).sum(dtype=torch.int64)),
        # a copy reads and writes the bytes once each: half its time is
        # what one read takes at the rate the card's copy reaches
        "read_ms": cuda_ms(lambda: copy_dst.copy_(tok_emb)) / 2,
        "sync_ms": cuda_ms(lambda: [hashing.device_planes(x) for x in entries],
                           calls=2),
        "sync_bound_ms": sync_bytes / PEAK_BYTES * 1e3,
    }
    # the host's side of a sync's digests: 25 launches, each followed by
    # the 8-byte readback that waits for it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        for x in entries:
            hashing.torch_simplehash_device(x)
    res["sync_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"hash (H1) @ tok_emb ({nbytes} bytes): kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.3f} ms (host clock), bound {res['bound_ms']:.4f} ms (bytes), "
        f"one-read yardstick (half a copy_) {res['read_ms']:.4f} ms, "
        f"int32 sum {res['sum_ms']:.4f} ms")
    log(f"hash (H1) @ a GPT-2 sync (25 entries, {sync_bytes} bytes): kernels "
        f"{res['sync_ms']:.4f} ms, bound {res['sync_bound_ms']:.4f} ms; with "
        f"the 25 readbacks, host clock {res['sync_host_ms']:.3f} ms")
    del tok_emb, cases, entries, kernel, plain, flip, copy_dst
    torch.cuda.empty_cache()
    return res


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


def start_master(procs: list, files: list, env: dict) -> int:
    """A master on an OS-chosen port, logging to LOG_DIR/master.log; returns
    the port once it listens."""
    port, = free_ports(1)
    files.append(open(LOG_DIR / "master.log", "w"))
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env, stdout=files[-1],
        stderr=subprocess.STDOUT)
    procs.append(master)
    deadline = time.time() + 60
    while "master listening" not in (LOG_DIR / "master.log").read_text():
        if master.poll() is not None or time.time() > deadline:
            raise SmokeError("master did not start: "
                             + (LOG_DIR / "master.log").read_text())
        time.sleep(0.2)
    return port


def spawn(procs: list, files: list, env: dict, log_name: str, cmd: list):
    """`python -m *cmd` logging to LOG_DIR/log_name, started through
    utils/rss.relay_argv: this process's peak RSS grows to tens of GB, and
    a peer spawned from it directly would report that as its own peak on
    a kernel without VmHWM (gVisor)."""
    from pccl_tpu_torch.utils.rss import relay_argv

    files.append(open(LOG_DIR / log_name, "w"))
    procs.append(subprocess.Popen(relay_argv([sys.executable, "-m", *cmd]),
                                  cwd=REPO, env=env, stdout=files[-1],
                                  stderr=subprocess.STDOUT))
    return procs[-1]


def wait_all(peers: list, deadline: float) -> None:
    try:
        for p in peers:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        raise SmokeError(f"peers still running after {PEER_TIMEOUT_S} s") from None


def dump_logs(names: list) -> None:
    for name in names:
        for line in (LOG_DIR / name).read_text().splitlines():
            log(f"  {name.removesuffix('.log')}| {line}")


def run_peer_pair(names: list, module: str, args: list, per_rank=None,
                  env_extra=None) -> list:
    """A master and two peers `python -m module --master-port P --base-port
    B --data-shard rank --min-world 2 *args *per_rank(rank)`, logging to
    LOG_DIR/names[rank]; returns each peer's (exit code, log text) once
    both have ended. Stops every process it started."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1", **(env_extra or {}))
    procs, files, peers = [], [], []
    try:
        port = start_master(procs, files, env)
        for rank, base in enumerate(free_ports(2, offsets=(0, 4, 8))):
            peers.append(spawn(procs, files, env, names[rank], [
                module, "--master-port", str(port), "--base-port", str(base),
                "--data-shard", str(rank), "--min-world", "2", *args,
                *(per_rank(rank) if per_rank else [])]))
        wait_all(peers, time.time() + PEER_TIMEOUT_S)
    finally:
        for p in procs:
            stop(p)
        for f in files:
            f.close()
        dump_logs(names[:len(peers)])
    return [(p.returncode, (LOG_DIR / n).read_text()) for n, p in zip(names, peers)]


def phase_main_path() -> dict:
    """Master + two sync-DiLoCo peers; returns per-kernel launch totals and
    the peers' per-outer-step records."""
    peers = run_peer_pair(
        [f"peer{rank}.log" for rank in range(2)],
        "pccl_tpu_torch.examples.sync_diloco",
        ["--model", MAIN["model"],
         "--block", str(MAIN["block"]), "--batch", str(MAIN["batch"]),
         "--inner-steps", str(MAIN["inner_steps"]),
         "--outer-steps", str(MAIN["outer_steps"]),
         "--device", "cuda", "--attn", "flash",
         # 8 steps from random init at GPT-2 width cannot show learning
         # (AdamW without warmup moves the loss up and down by ~0.1 there);
         # the check here is the ring's invariant: equal outer digests on
         # both peers
         "--no-descent-check"])
    records = []
    for rank, (code, text) in enumerate(peers):
        if code != 0:
            raise SmokeError(f"peer {rank} exited {code}")
        rows = [m.groups() for m in LINE.finditer(text)]
        if len(rows) != MAIN["outer_steps"] or "FINAL" not in text:
            raise SmokeError(f"peer {rank}: expected {MAIN['outer_steps']} outer "
                             f"lines and FINAL")
        records.append(rows)
    totals = {name: 0 for name in FLASH}
    for rank, rows in enumerate(records):
        for row in rows:
            loss, world = float(row[1]), int(row[2])
            if not math.isfinite(loss) or world != 2:
                raise SmokeError(f"peer {rank}: loss {loss}, world {world}")
            for name, n in zip(FLASH, row[6:9]):
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


# ------------------------------------------------------------------ phase 6

DDP_LINE = re.compile(
    r"^step (\d+) loss (\S+) world (\d+) revision (\d+) tok_s (\S+) ring_s (\S+) "
    r"sync_s (\S+) tx (\d+) rx (\d+) launches (\d+) (\d+) (\d+) (\d+) "
    r"digest (\w+)$", re.M)
# everything a late joiner receives: parameters, mu and nu in fp32, AdamW's
# int32 count and the u64 step
ADOPT_BYTES = 3 * GPT2_PARAM_BYTES + 4 + 8


def ddp_rows(text: str) -> dict:
    """{step: dict of the step line's fields} of one peer's log."""
    keys = ("loss", "world", "revision", "tok_s", "ring_s", "sync_s", "tx", "rx",
            *FLASH, "simplehash_tpu", "digest")
    rows = {}
    for m in DDP_LINE.finditer(text):
        row = dict(zip(keys, m.groups()[1:]))
        for k in keys[1:-1]:
            row[k] = float(row[k]) if k.endswith("_s") else int(row[k])
        row["loss"] = float(row["loss"])
        rows[int(m.group(1))] = row
    return rows


def phase_ddp() -> dict:
    """Master, DDP peers A and B, and C, which joins late and adopts their
    state; returns per-kernel launch totals and the per-step rows."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1", PCCLT_SS_HASH="simple-tpu")
    procs, files, peers = [], [], []
    names = [f"ddp_{p}.log" for p in "abc"]
    try:
        port = start_master(procs, files, env)
        bases = free_ports(3, offsets=(0, 4, 8))

        def peer(rank, min_world):
            # A stages its gradients through registered shm, B and C
            # through pinned buffers: the digests must not notice
            return spawn(procs, files, env, names[rank], [
                "pccl_tpu_torch.examples.train_ddp",
                "--master-port", str(port), "--base-port", str(bases[rank]),
                "--data-shard", str(rank), "--min-world", str(min_world),
                "--model", DDP["model"], "--block", str(DDP["block"]),
                "--batch", str(DDP["batch"]), "--steps", str(DDP["steps"]),
                "--device", "cuda", "--attn", "flash",
                # a few dozen steps from random init at GPT-2 width need not
                # show learning; the checks here are the DDP invariants
                "--no-descent-check", *(["--shm-staging"] if rank == 0 else [])])

        peers += [peer(0, 2), peer(1, 2)]
        deadline = time.time() + PEER_TIMEOUT_S
        # C starts once A has logged step 2, as the JAX package's late-join
        # test gates its joiner
        while not re.search(r"^step 2 ", (LOG_DIR / names[0]).read_text(), re.M):
            if peers[0].poll() is not None or time.time() > deadline:
                raise SmokeError("DDP peer A never reached step 2")
            time.sleep(0.2)
        peers.append(peer(2, 3))
        wait_all(peers, deadline)
    finally:
        for p in procs:
            stop(p)
        for f in files:
            f.close()
        dump_logs(names[:len(peers)])
    texts = [(LOG_DIR / n).read_text() for n in names]
    m = re.search(r"adopted shared state at step (\d+)", texts[2])
    if m is None:
        raise SmokeError(f"the late joiner C never joined the DDP cohort (A and B "
                         f"ran {DDP['steps']} steps before it came; raise "
                         f"DDP['steps'])")
    for rank, p in enumerate(peers):
        if p.returncode != 0 or "FINAL" not in texts[rank]:
            raise SmokeError(f"DDP peer {'abc'[rank]} exited {p.returncode}")
    rows = [ddp_rows(t) for t in texts]
    k = int(m.group(1))
    a, b, c = rows
    if k <= 0 or min(c) != k or len(c) < 10:
        raise SmokeError(f"C adopted at step {k} and trained {len(c)} steps "
                         f"with the others (needs k > 0 and >= 10 steps)")
    for tag, r in zip("abc", rows):
        if not any(row["world"] == 3 for row in r.values()):
            raise SmokeError(f"DDP peer {tag} never saw world 3")
        if not all(math.isfinite(row["loss"]) for row in r.values()):
            raise SmokeError(f"DDP peer {tag}: a loss is not finite")
    for tag, r in zip("ab", rows):
        moved = [s for s in r if s < k and (r[s]["tx"], r[s]["rx"]) != (0, 0)]
        if moved:
            raise SmokeError(f"{tag}'s syncs before C came moved bytes at steps "
                             f"{moved}: the device hashes disagree across peers")
    if c[k]["rx"] != ADOPT_BYTES or a[k]["tx"] + b[k]["tx"] != ADOPT_BYTES:
        raise SmokeError(f"adoption at step {k}: C received {c[k]['rx']}, A and B "
                         f"sent {a[k]['tx']} + {b[k]['tx']}; expected {ADOPT_BYTES}")
    for s in sorted(set(a) | set(b)):
        peers_at = [r[s] for r in rows if s in r]
        if len(peers_at) < (3 if s >= k else 2) or s not in a or s not in b:
            raise SmokeError(f"step {s} is missing from a peer's log")
        if len({row["digest"] for row in peers_at}) != 1:
            raise SmokeError(f"step {s}: digests differ across peers")
        if s > k and any((row["tx"], row["rx"]) != (0, 0) for row in peers_at):
            raise SmokeError(f"step {s}: a sync after the adoption moved bytes")
    finals = {re.search(r"params_blake2b=(\w+)", t).group(1) for t in texts}
    if len(finals) != 1:
        raise SmokeError(f"final parameters differ: {sorted(finals)}")
    totals = {name: 0 for name, *_ in KERNELS}
    for tag, r in zip("abc", rows):
        for name in totals:
            n = sum(row[name] for row in r.values())
            if n <= 0:
                raise SmokeError(f"DDP peer {tag}: {name} never launched")
            totals[name] += n
    peaks = [re.search(r"peak_alloc_mib=(\d+)", t).group(1) for t in texts]
    rss = [re.search(r"peak_rss_mib=(\d+)", t).group(1) for t in texts]
    log(f"DDP path (A staged its gradients through registered shm, B and C "
        f"through pinned buffers): C adopted {ADOPT_BYTES} bytes at step {k} (A sent {a[k]['tx']}, "
        f"B {b[k]['tx']}) and trained {len(c)} steps; 0-byte syncs before and "
        f"after; digests equal at every step; params_blake2b {finals.pop()}; peak "
        f"allocated MiB a/b/c {'/'.join(peaks)}; peak host RSS MiB a/b/c "
        f"{'/'.join(rss)}; launches {totals}")
    return {"launches": totals, "rows": rows, "adopted_at": k}


# ------------------------------------------------------------------ phase 7

ASYNC_LINE = re.compile(
    r"outer (\d+) loss (\S+) world (\d+) revision (\d+) tok_s (\S+) "
    r"outer_s (\S+) join_s (\S+) launches (\d+) (\d+) (\d+) digest (\w+)")
ASYNC_FINAL = re.compile(r"FINAL .*revision=(\d+) digest=(\w+) "
                         r"peak_alloc_mib=(\d+) peak_rss_mib=(\d+)")


def phase_async() -> dict:
    """Master + two async-DiLoCo Llama-700m peers; returns per-kernel launch
    totals, the per-outer-step records and the FINAL fields."""
    a = ASYNC
    peers = run_peer_pair(
        [f"async{rank}.log" for rank in range(2)],
        "pccl_tpu_torch.examples.async_diloco",
        ["--family", a["family"], "--model", a["model"],
         "--block", str(a["block"]), "--batch", str(a["batch"]),
         "--inner-steps", str(a["inner_steps"]),
         "--outer-steps", str(a["outer_steps"]),
         "--device", "cuda", "--attn", "flash", "--profile",
         # 24 steps from random init need not show learning; the checks
         # here are the ring's invariants
         "--no-descent-check"])
    records, finals = [], []
    for rank, (code, text) in enumerate(peers):
        if code != 0:
            raise SmokeError(f"async peer {rank} exited {code}")
        rows = [m.groups() for m in ASYNC_LINE.finditer(text)]
        final = ASYNC_FINAL.search(text)
        if len(rows) != a["outer_steps"] or final is None:
            raise SmokeError(f"async peer {rank}: expected {a['outer_steps']} "
                             f"outer lines and FINAL with its digest")
        records.append(rows)
        finals.append(final.groups())
        table = {line.split()[0] for line in text.splitlines() if line.split()}
        if not {"inner", "outer/async", "outer/finish"} <= table:
            raise SmokeError(f"async peer {rank}: no --profile table")
    totals = {name: 0 for name in FLASH}
    for rank, rows in enumerate(records):
        for step, row in enumerate(rows):
            loss, world, revision = float(row[1]), int(row[2]), int(row[3])
            if not math.isfinite(loss) or world != 2 or revision != step:
                raise SmokeError(f"async peer {rank}: loss {loss}, world {world}, "
                                 f"revision {revision} at outer step {step}")
            for name, n in zip(FLASH, row[7:10]):
                if int(n) <= 0:
                    raise SmokeError(f"async peer {rank}: {name} never launched")
                totals[name] += int(n)
    for step in range(a["outer_steps"]):
        digests = {rows[step][10] for rows in records}
        if len(digests) != 1:
            raise SmokeError(f"async outer step {step}: digests differ across "
                             f"peers: {sorted(digests)}")
    if len({f[1] for f in finals}) != 1 \
            or any(int(f[0]) != a["outer_steps"] for f in finals):
        raise SmokeError(f"async FINAL: revisions and digests {finals} differ")
    for rank, rows in enumerate(records):
        log(f"  async peer {rank}: tok_s {' '.join(r[4] for r in rows)}; outer_s "
            f"{' '.join(r[5] for r in rows)}; join_s {' '.join(r[6] for r in rows)}; "
            f"peak allocated MiB {finals[rank][2]}, peak host RSS MiB "
            f"{finals[rank][3]}")
    log(f"async path: 2 Llama-700m peers, world 2, digests equal at every outer "
        f"step and after finish() ({finals[0][1]}), launches {totals}")
    return {"launches": totals, "records": records, "finals": finals}


# ------------------------------------------------------------------ phase 7b

ROUTES = [("pipelined", dict(shm_staging=True, comm_windows=4)),
          ("staged", dict(shm_staging=True, comm_windows=1)),
          ("unstaged", dict(shm_staging=False, comm_windows=1))]


def phase_pipelined() -> dict:
    """Two peers in this process, each a Diloco over one fp32 vector of
    Llama-700m's parameter count on the card, two outer steps through each
    route of the outer step; returns {route: [[profile of each step] of
    each peer]}."""
    import torch

    from pccl_tpu_torch.comm import Communicator, MasterNode
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    port, = free_ports(1)
    bases = free_ports(2, offsets=(0, 4, 8))
    master = MasterNode("127.0.0.1", port)
    master.run()
    outs, profiles, exact, errors = {}, {}, {}, []

    def peer(rank):
        comm = Communicator("127.0.0.1", master.port, p2p_port=bases[rank],
                            ss_port=bases[rank] + 4, bench_port=bases[rank] + 8)
        try:
            comm.connect()
            deadline = time.time() + 60
            while comm.world_size < 2:
                if time.time() > deadline:
                    raise SmokeError("7b: the world never reached 2")
                if comm.are_peers_pending():
                    comm.update_topology()
                time.sleep(0.01)
            for route, kw in ROUTES:
                cfg = DilocoConfig(outer_lr=1.0, outer_momentum=0.0,
                                   nesterov=False, profile=True, **kw)
                w = torch.zeros(LLAMA700M_PARAMS, device="cuda")
                dl = Diloco(comm, {"w": w}, cfg)
                profiles[route, rank], exact[route, rank] = [], []
                for step in range(2):
                    # the pseudo-gradient outer - inner is rank + 1
                    # everywhere; outer_step writes the new outer into w
                    dl.outer_step({"w": w.sub_(rank + 1)})
                    profiles[route, rank].append(dl.last_profile)
                    exact[route, rank].append(bool((w == -1.5 * (step + 1)).all()))
                outs[route, rank] = w
                del dl
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append((rank, repr(e)))
        finally:
            comm.destroy()

    threads = [threading.Thread(target=peer, args=(r,), daemon=True)
               for r in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PEER_TIMEOUT_S)
    finally:
        master.interrupt()
        master.destroy()
    if any(t.is_alive() for t in threads):
        raise SmokeError(f"7b: a peer thread still runs after {PEER_TIMEOUT_S} s")
    if errors:
        raise SmokeError(f"7b: peer failures: {errors}")
    res = {}
    for route, _ in ROUTES:
        ok = exact[route, 0] + exact[route, 1]
        same = torch.equal(outs[route, 0], outs[route, 1])
        for rank in range(2):
            for step, p in enumerate(profiles[route, rank]):
                phases = ", ".join(f"{k} {v:.3f}" for k, v in p.items()
                                   if not k.endswith("_cpu"))
                # process_time counts both peers' threads of this process
                cpu = ", ".join(f"{k} {v:.3f}" for k, v in p.items()
                                if k.endswith("_cpu"))
                log(f"  7b {route} peer {rank} step {step} "
                    f"({'cold' if step == 0 else 'warm'}) (s): {phases}; "
                    f"process CPU s: {cpu}")
        log(f"  7b {route}: {LLAMA700M_PARAMS} elements, exactly -1.5 then -3 "
            f"{ok}, bit-identical across peers {same}")
        if not (all(ok) and same):
            raise SmokeError(f"7b {route}: the averaged updates are not exact and "
                             f"equal on both peers")
        res[route] = [profiles[route, r] for r in range(2)]
    del outs
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------ phase 8

REMAT = dict(model="700m", block=2048, batch=4)
# (remat, microbatches A): A x B/A sequences a step
REMAT_RUNS = [(False, 1), (True, 1), ("dots", 1), ("sqrt", 1), (False, 2)]


def phase_remat() -> dict:
    """Llama-700m through train.build_loss_and_grad in each remat mode, and
    with accumulation; returns the launch totals and each run's figures."""
    import torch

    from pccl_tpu_torch.models import llama
    from pccl_tpu_torch.models._common import _sqrt_divisor
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib

    dev = torch.device("cuda")
    B, T = REMAT["batch"], REMAT["block"]
    cfg = llama.named_config(REMAT["model"], block_size=T)
    L, G = cfg.n_layer, _sqrt_divisor(cfg.n_layer)
    state = train_lib.make_train_state(0, cfg, dev)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen).to(dev)
    targets = torch.randint(0, cfg.vocab_size, (B, T), generator=gen).to(dev)
    names = sorted(state.params)

    # what loss_fn leaves allocated when it returns: the first microbatch's
    # (the entry point looks loss_fn up at each call)
    held = {}
    loss_fn = llama.loss_fn

    def measured(*a, **kw):
        out = loss_fn(*a, **kw)
        held.setdefault("bytes", torch.cuda.memory_allocated(dev) - held["base"])
        return out

    k1 = {False: L, True: 2 * L, "dots": 2 * L, "sqrt": 3 * L - L // G}
    runs, ref = [], None
    llama.loss_fn = measured
    try:
        for remat, A in REMAT_RUNS:
            lg = train_lib.build_loss_and_grad(cfg, attn_fn=fa.flash_attention,
                                               remat=remat, accum_steps=A)
            x, y = (tokens, targets) if A == 1 else \
                (tokens.reshape(A, B // A, T), targets.reshape(A, B // A, T))
            held["base"] = torch.cuda.memory_allocated(dev)
            lg(state, x, y)                      # warm-up
            state.optimizer.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            held.clear()
            held["base"] = base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = dict(fa.launches)
            loss = float(lg(state, x, y))
            torch.cuda.synchronize()
            run = {"remat": remat, "A": A, "B": B // A, "loss": loss,
                   "held": held["bytes"],
                   "peak": torch.cuda.max_memory_allocated(dev) - base,
                   "launches": {k: fa.launches[k] - before[k] for k in FLASH}}
            grads = torch.cat([state.params[n].grad.reshape(-1) for n in names])
            # the step's time: the median of three more calls (the host
            # clock around each, ending in a synchronisation), which leave
            # the same gradients
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                lg(state, x, y)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            run["ms"] = ms = statistics.median(times)
            state.optimizer.zero_grad(set_to_none=True)
            if ref is None:
                ref = (loss, grads)
            run["loss_gap"] = abs(loss - ref[0])
            run["cosine"] = torch.nn.functional.cosine_similarity(
                grads, ref[1], dim=0).item()
            run["bitwise"] = torch.equal(grads, ref[1])
            del grads
            runs.append(run)
            log(f"  8 remat={remat!s:5} A={A} B={B // A}: held after forward "
                f"{run['held'] / 2**20:.0f} MiB, peak {run['peak'] / 2**20:.0f} MiB, "
                f"step {ms:.1f} ms ({' '.join(f'{t:.1f}' for t in times)}), "
                f"launches K1/K2/K3 {run['launches']['flash_fwd']}/"
                f"{run['launches']['flash_bwd_dq']}/{run['launches']['flash_bwd_dkv']}, "
                f"loss {loss:.6f} (gap {run['loss_gap']:.2e}), grad cosine "
                f"{run['cosine']:.7f}, bitwise equal {run['bitwise']}")
    finally:
        llama.loss_fn = loss_fn
        del state, ref
        torch.cuda.empty_cache()
    # every launch of the phase: the warm-up, measured and timed calls
    totals = dict(fa.launches)
    for run in runs:
        remat, A, n = run["remat"], run["A"], run["launches"]
        want = {"flash_fwd": A * k1[remat], "flash_bwd_dq": A * L,
                "flash_bwd_dkv": A * L}
        if n != want:
            raise SmokeError(f"8 remat={remat} A={A}: launches {n}, expected {want}")
        if not (math.isfinite(run["loss"]) and run["loss_gap"] <= 1e-3
                and run["cosine"] >= 0.9998):
            raise SmokeError(f"8 remat={remat} A={A} disagrees with remat=False: "
                             f"loss gap {run['loss_gap']}, cosine {run['cosine']}")
    by = {(r["remat"], r["A"]): r for r in runs}
    order = [by["sqrt", 1]["held"], by[True, 1]["held"], by["dots", 1]["held"],
             by[False, 1]["held"]]
    if not order == sorted(order) or len(set(order)) != 4:
        raise SmokeError(f"8: held after forward sqrt/True/dots/False {order} is "
                         f"not increasing")
    if not by[False, 2]["peak"] < by[False, 1]["peak"]:
        raise SmokeError(f"8: peak at A=2 {by[False, 2]['peak']} is not below A=1's "
                         f"{by[False, 1]['peak']}")
    log(f"remat path: Llama-700m L={L} G={G} B={B} T={T}: every mode within the "
        f"limits; held sqrt < True < dots < False; peak A=2 < A=1; launches {totals}")
    return {"launches": totals, "runs": runs}


# ------------------------------------------------------------------ phase 9

RESUME = dict(model="gpt2", block=1024, batch=8, inner_steps=4, outer_steps=(2, 3))
RESUMED = re.compile(r"^resumed from outer step (\d+) digest (\w+) restore_s (\S+)$",
                     re.M)
SAVED = re.compile(r"^checkpoint (?:outer )?step (\d+) bytes (\d+) save_s (\S+)$", re.M)


def check_trace(path: Path, sections: dict) -> None:
    """A --trace-out file: one process_name event, then one complete event
    per section entered, `sections` giving how often each was entered."""
    events = json.loads(path.read_text())["traceEvents"]
    meta = [e for e in events if e.get("ph") == "M" and e.get("name") == "process_name"]
    spans = {}
    for e in events:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    if len(meta) != 1 or spans != sections or len(events) != 1 + sum(sections.values()):
        raise SmokeError(f"trace {path.name}: {len(meta)} process_name events and "
                         f"spans {spans}, expected 1 and {sections}")


def phase_diloco_resume() -> dict:
    """Two sync-DiLoCo peers at GPT-2 widths with checkpoints, stopped after
    2 outer steps and resumed to 3 under a fresh master; returns the launch
    totals and the checkpoint figures."""
    r = RESUME
    ck = LOG_DIR / "resume_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    totals = {name: 0 for name in FLASH}
    texts = []
    for run, outer_steps in enumerate(r["outer_steps"]):
        peers = run_peer_pair(
            [f"resume{run}_{rank}.log" for rank in range(2)],
            "pccl_tpu_torch.examples.sync_diloco",
            ["--model", r["model"], "--block", str(r["block"]),
             "--batch", str(r["batch"]), "--inner-steps", str(r["inner_steps"]),
             "--outer-steps", str(outer_steps), "--device", "cuda", "--attn", "flash",
             "--data", "text", "--lr-schedule", "cosine", "--warmup-steps", "2",
             "--checkpoint-every", "1", "--profile", "--no-descent-check"],
            per_rank=lambda rank, run=run: [
                "--checkpoint-dir", str(ck / f"peer{rank}"),
                "--trace-out", str(LOG_DIR / f"resume{run}_{rank}.trace.json")])
        for rank, (code, text) in enumerate(peers):
            if code != 0 or "FINAL" not in text:
                raise SmokeError(f"9: run {run} peer {rank} exited {code}")
            rows = [m.groups() for m in LINE.finditer(text)]
            first = r["outer_steps"][0] if run else 0
            if [int(row[0]) for row in rows] != list(range(first, outer_steps)):
                raise SmokeError(f"9: run {run} peer {rank} logged outer steps "
                                 f"{[row[0] for row in rows]}")
            for row in rows:
                if not math.isfinite(float(row[1])) or int(row[2]) != 2:
                    raise SmokeError(f"9: run {run} peer {rank}: {row}")
                for name, n in zip(FLASH, row[6:9]):
                    if int(n) <= 0:
                        raise SmokeError(f"9: peer {rank}: {name} never launched")
                    totals[name] += int(n)
            table = {line.split()[0] for line in text.splitlines() if line.split()}
            if not {"inner", "outer/ring+sgd"} <= table:
                raise SmokeError(f"9: run {run} peer {rank}: no profile table")
            steps = outer_steps - first
            check_trace(LOG_DIR / f"resume{run}_{rank}.trace.json",
                        {"inner": steps, "outer/ring+sgd": steps})
        texts.append([text for _, text in peers])
    first_digests = [[row[9] for row in (m.groups() for m in LINE.finditer(t))]
                     for t in texts[0]]
    resumed = [RESUMED.search(t) for t in texts[1]]
    for rank, m in enumerate(resumed):
        if m is None or int(m.group(1)) != r["outer_steps"][0]:
            raise SmokeError(f"9: peer {rank} did not resume from outer step 2")
        if m.group(2) != first_digests[rank][-1]:
            raise SmokeError(f"9: peer {rank} restored digest {m.group(2)}, outer "
                             f"step 1 printed {first_digests[rank][-1]}")
    for run, pair in enumerate(texts):
        rows = [[m.groups() for m in LINE.finditer(t)] for t in pair]
        if [row[9] for row in rows[0]] != [row[9] for row in rows[1]]:
            raise SmokeError(f"9: run {run}: digests differ across peers")
    saves = [(int(b), float(s)) for t in texts[0] for _, b, s in SAVED.findall(t)]
    restores = [float(m.group(3)) for m in resumed]
    rss = [re.search(r"peak_rss_mib=(\d+)", t).group(1) for pair in texts
           for t in pair]
    log(f"resume path (sync DiLoCo): both peers resumed from outer step 2 with "
        f"the digest of outer step 1 ({resumed[0].group(2)}); digests equal at "
        f"every step; checkpoint {saves[0][0]} bytes, save_s "
        f"{' '.join(str(s) for _, s in saves)}, restore_s "
        f"{' '.join(str(x) for x in restores)}; peak host RSS MiB (run 0 peers, "
        f"run 1 peers) {'/'.join(rss)}; launches {totals}")
    return {"launches": totals, "saves": saves, "restores": restores}


# ------------------------------------------------------------------ phase 10

DDP_RESUME = dict(model="gpt2", block=1024, batch=4, grad_accum=2, steps=(6, 9))
EVAL = re.compile(r"^eval step (\d+) loss (\S+) launches (\d+)$", re.M)
DDP_RESUMED = re.compile(r"^resumed from step (\d+) restore_s (\S+)$", re.M)


def phase_ddp_resume() -> dict:
    """Two DDP peers at GPT-2 widths with accumulation, eval and
    checkpoints, stopped at step 6 and resumed to 9 under a fresh master;
    returns the launch totals and the per-step rows."""
    d = DDP_RESUME
    ck = LOG_DIR / "ddp_resume_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    totals = {name: 0 for name, *_ in KERNELS}
    texts, rows = [], []
    for run, steps in enumerate(d["steps"]):
        peers = run_peer_pair(
            [f"ddp_resume{run}_{rank}.log" for rank in range(2)],
            "pccl_tpu_torch.examples.train_ddp",
            ["--model", d["model"], "--block", str(d["block"]),
             "--batch", str(d["batch"]), "--grad-accum", str(d["grad_accum"]),
             "--steps", str(steps), "--device", "cuda", "--attn", "flash",
             "--data", "text", "--eval-every", "3", "--eval-batches", "2",
             "--checkpoint-every", "6", "--no-descent-check"],
            per_rank=lambda rank: ["--checkpoint-dir", str(ck / f"peer{rank}")],
            env_extra={"PCCLT_SS_HASH": "simple-tpu"})
        for rank, (code, text) in enumerate(peers):
            if code != 0 or "FINAL" not in text:
                raise SmokeError(f"10: run {run} peer {rank} exited {code}")
        pair = [ddp_rows(text) for _, text in peers]
        first = d["steps"][0] if run else 0
        for rank, r in enumerate(pair):
            if sorted(r) != list(range(first, steps)):
                raise SmokeError(f"10: run {run} peer {rank} logged steps {sorted(r)}")
            for row in r.values():
                if row["world"] != 2 or not math.isfinite(row["loss"]):
                    raise SmokeError(f"10: run {run} peer {rank}: {row}")
                for name in totals:
                    totals[name] += row[name]
        for s in pair[0]:
            if pair[0][s]["digest"] != pair[1][s]["digest"]:
                raise SmokeError(f"10: run {run} step {s}: digests differ")
        texts.append([text for _, text in peers])
        rows.append(pair)
    for rank, text in enumerate(texts[1]):
        m = DDP_RESUMED.search(text)
        if m is None or int(m.group(1)) != d["steps"][0]:
            raise SmokeError(f"10: peer {rank} did not resume from step 6")
        probe = rows[1][rank][d["steps"][0]]
        if probe["revision"] != 0 or (probe["tx"], probe["rx"]) != (0, 0):
            raise SmokeError(f"10: peer {rank}'s first sync after the resume: "
                             f"revision {probe['revision']}, tx/rx {probe['tx']}/"
                             f"{probe['rx']} (expected a 0-byte probe at 0)")
    evals = [EVAL.findall(t) for pair in texts for t in pair]
    if not all(evals):
        raise SmokeError("10: a peer printed no eval line")
    for e in evals:
        totals["flash_fwd"] += sum(int(x[2]) for x in e)
    finals = {re.search(r"params_blake2b=(\w+)", t).group(1) for t in texts[1]}
    if len(finals) != 1:
        raise SmokeError(f"10: final parameters differ: {sorted(finals)}")
    peaks = [re.search(r"peak_alloc_mib=(\d+)", t).group(1) for pair in texts
             for t in pair]
    rss = [re.search(r"peak_rss_mib=(\d+)", t).group(1) for pair in texts
           for t in pair]
    saves = [(int(b), float(s)) for t in texts[0] for _, b, s in SAVED.findall(t)]
    restores = [float(DDP_RESUMED.search(t).group(2)) for t in texts[1]]
    tokens = d["grad_accum"] * d["batch"] * d["block"]
    for run, pair in enumerate(rows):
        for rank, r in enumerate(pair):
            cols = {k: " ".join(str(row[k]) for row in r.values())
                    for k in ("tok_s", "ring_s", "sync_s")}
            log(f"  10 run {run} peer {rank}: tok_s ({tokens} tokens a step) "
                f"{cols['tok_s']}; ring_s {cols['ring_s']}; sync_s {cols['sync_s']}")
    log(f"DDP resume path: both peers resumed from step 6 through a 0-byte "
        f"revision-0 probe (sync_s {rows[1][0][6]['sync_s']:.3f}/"
        f"{rows[1][1][6]['sync_s']:.3f}); digests equal at every step; "
        f"params_blake2b {finals.pop()}; eval lines {[len(e) for e in evals]}; "
        f"peak allocated MiB {'/'.join(peaks)}; peak host RSS MiB "
        f"{'/'.join(rss)}; checkpoint {saves[0][0]} bytes, "
        f"save_s {' '.join(str(s) for _, s in saves)}, restore_s "
        f"{' '.join(str(x) for x in restores)}; launches {totals}")
    return {"launches": totals, "rows": rows, "saves": saves, "restores": restores}


# ------------------------------------------------------------------ phase 11

# 12 outer steps: from random init at GPT-2 width AdamW at 1e-3 swings the
# loss by ~0.2 nats a step; over 3 outer steps one cell of four did not
# learn, over 8 one fell by only 0.14 nats
GRID = dict(model="gpt2", block=1024, batch=8, inner_steps=4, outer_steps=12,
            shards=2, replicas=2)
GRID_LINE = re.compile(
    r"^outer (\d+) loss (\S+) grid (\d+)x(\d+) global (\d+) shard (\d+) "
    r"\[(\d+):(\d+)\] tok_s (\S+) outer_s (\S+) launches (\d+) (\d+) (\d+) "
    r"digest (\w+) tx (\d+) rx (\d+)$", re.M)
GRID_FINAL = re.compile(r"^FINAL first_loss=(\S+) last_loss=(\S+) "
                        r"last_sync_tx=(\d+) last_sync_rx=(\d+)"
                        r"(?: peak_alloc_mib=(\d+))? peak_rss_mib=(\d+)$", re.M)


def phase_grid(dev: str = "cuda") -> dict:
    """A master and a 2 x 2 grid of `grid_diloco` cells on the card (two
    outer-state shards, two replicas each), sharing one grid file; returns
    the launch totals and each cell's rows."""
    gr = GRID
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    # the file holds the full fp32 outer vector; /dev/shm as the JAX
    # example's default when it has room, else the log directory
    need = 2 * GPT2_PARAM_BYTES
    shm = Path("/dev/shm")
    where = shm if shm.is_dir() and shutil.disk_usage(shm).free > need else LOG_DIR
    grid_file = where / f"pcclt_grid_smoke_{os.getpid()}.bin"
    names = [f"grid{g}{r}.log" for g in range(gr["shards"])
             for r in range(gr["replicas"])]
    procs, files, cells = [], [], []
    try:
        port = start_master(procs, files, env)
        bases = free_ports(len(names), offsets=(0, 4, 8))
        for i, name in enumerate(names):
            g = i // gr["replicas"]
            cells.append(spawn(procs, files, env, name, [
                "pccl_tpu_torch.examples.grid_diloco", "--master-port", str(port),
                "--num-shards", str(gr["shards"]), "--peer-group", str(g),
                "--base-port", str(bases[i]), "--data-shard", str(i),
                "--grid-file", str(grid_file),
                "--min-replicas", str(gr["replicas"]), "--model", gr["model"],
                "--block", str(gr["block"]), "--batch", str(gr["batch"]),
                "--inner-steps", str(gr["inner_steps"]),
                "--outer-steps", str(gr["outer_steps"]), "--device", dev,
                "--attn", "flash" if dev == "cuda" else "dense"]))
        wait_all(cells, time.time() + PEER_TIMEOUT_S)
    finally:
        for p in procs:
            stop(p)
        for f in files:
            f.close()
        dump_logs(names[:len(cells)])
        grid_file.unlink(missing_ok=True)     # the cells remove it on success
    texts = [(LOG_DIR / n).read_text() for n in names]
    rows, finals = [], []
    for i, (p, text) in enumerate(zip(cells, texts)):
        final = GRID_FINAL.search(text)
        if p.returncode != 0 or final is None:
            # exit 4: the last loss was not below the first
            raise SmokeError(f"11: grid cell {names[i]} exited {p.returncode}")
        r = GRID_LINE.findall(text)
        if len(r) != gr["outer_steps"]:
            raise SmokeError(f"11: {names[i]} logged {len(r)} outer steps")
        rows.append(r)
        finals.append(final.groups())
    totals = {name: 0 for name in FLASH}
    full = f"{gr['shards']}x{gr['replicas']}"
    world = gr["shards"] * gr["replicas"]
    for i, r in enumerate(rows):
        g = i // gr["replicas"]
        for step, row in enumerate(r):
            if (f"{row[2]}x{row[3]}", int(row[4]), int(row[5])) != (full, world, g) \
                    or not math.isfinite(float(row[1])):
                raise SmokeError(f"11: {names[i]} outer step {step}: {row}")
            if step and (row[14], row[15]) != ("0", "0"):
                raise SmokeError(f"11: {names[i]}'s sync at outer step {step} "
                                 f"moved tx {row[14]} rx {row[15]} bytes")
            for name, n in zip(FLASH, row[10:13]):
                if int(n) <= 0:
                    raise SmokeError(f"11: {names[i]}: {name} never launched")
                totals[name] += int(n)
        if finals[i][2:4] != ("0", "0"):
            raise SmokeError(f"11: {names[i]}'s closing sync moved bytes")
        if not float(finals[i][1]) < float(finals[i][0]):
            raise SmokeError(f"11: {names[i]}: loss did not fall {finals[i][:2]}")
    for g in range(gr["shards"]):
        group = rows[g * gr["replicas"]:(g + 1) * gr["replicas"]]
        for step in range(gr["outer_steps"]):
            if len({r[step][13] for r in group}) != 1:
                raise SmokeError(f"11: group {g}'s digests differ at outer "
                                 f"step {step}")
    for i, (r, f) in enumerate(zip(rows, finals)):
        log(f"  grid cell {names[i].removesuffix('.log')} (shard {r[0][5]} "
            f"[{r[0][6]}:{r[0][7]}]): loss {' '.join(x[1] for x in r)}; tok_s "
            f"{' '.join(x[8] for x in r)}; outer_s {' '.join(x[9] for x in r)}; "
            f"peak allocated MiB {f[4]}, peak host RSS MiB {f[5]}")
    log(f"grid path: {full} cells, global {world} at every outer step; each "
        f"group's digests equal at every step; syncs after the first 0 bytes; "
        f"losses fell; grid file in {where}; launches {totals}")
    return {"launches": totals, "rows": rows, "finals": finals}


# ------------------------------------------------------------------ phase 12

COMM_PEERS = 3
A2A_BLOCK = 1 << 20          # elements of each all_to_all block


def phase_comm(dev: str = "cuda") -> dict:
    """Three communicators in this process over one master, with vectors
    that start on the card and are staged through pinned host buffers:
    broadcast of the GPT-2 flat parameters, reduce_scatter of a vector of
    that size, all_gather of each peer's 25 H1 digests of a GPT-2 state,
    all_to_all of three blocks, the counters, the flight recorder, and an
    all-reduce after optimize_topology; returns the H1 launches and each
    op's seconds and bytes."""
    import hashlib

    import numpy as np
    import torch

    from pccl_tpu_torch.comm import (Communicator, MasterNode, ReduceOp,
                                     trace_clear, trace_enable, trace_events)
    from pccl_tpu_torch.models import gpt
    from pccl_tpu_torch.ops import hashing
    from pccl_tpu_torch.parallel.codec import build_codec

    dev = torch.device(dev)
    pin = dev.type == "cuda"
    cfg = gpt.named_config(GRID["model"])
    params = gpt.init_params(torch.Generator().manual_seed(0), cfg)
    root_vec = build_codec(params).flat(params).to(dev)
    del params
    n = root_vec.numel()
    gen = torch.Generator(device=dev)
    # integer-valued floats below 512: a sum of three is exact in fp32, so
    # the card's sum and the ring's agree bit for bit whatever the order
    rs_in = [torch.randint(0, 512, (n,), generator=gen.manual_seed(s),
                           device=dev).float() for s in range(COMM_PEERS)]
    rs_total = rs_in[0] + rs_in[1] + rs_in[2]
    states = [gpt2_sync_entries(dev) for _ in range(COMM_PEERS)]
    a2a = [torch.arange(COMM_PEERS * A2A_BLOCK, device=dev, dtype=torch.float32)
           + 1e7 * s for s in range(COMM_PEERS)]

    port, = free_ports(1)
    bases = free_ports(COMM_PEERS, offsets=(0, 4, 8))
    saved = os.environ.get("PCCLT_BENCH_SECONDS")
    os.environ["PCCLT_BENCH_SECONDS"] = "0.2"   # short bandwidth probes
    master = MasterNode("127.0.0.1", port)
    master.run()
    hashing.reset_launch_counts()
    trace_clear()
    trace_enable(True)
    res, errors = {}, []

    def host_of(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        h.copy_(t)                          # D2H; waits for the device
        return h

    def peer(rank):
        comm = Communicator("127.0.0.1", master.port, p2p_port=bases[rank],
                            ss_port=bases[rank] + 4, bench_port=bases[rank] + 8)
        try:
            comm.connect()
            deadline = time.time() + 60
            while comm.world_size < COMM_PEERS:
                if time.time() > deadline:
                    raise SmokeError("12: the world never reached 3")
                if comm.are_peers_pending():
                    comm.update_topology()
                time.sleep(0.01)
            slot, out, moved = comm.gather_slot, {}, 0

            def timed_op(name, fn):
                nonlocal moved
                t0 = time.perf_counter()
                r = fn()
                info = r[-1] if isinstance(r, tuple) else r
                out[name + "_s"] = time.perf_counter() - t0
                out[name + "_tx"] = info.tx_bytes
                moved += info.tx_bytes
                return r

            # broadcast of the GPT-2 flat parameters from slot 1
            vec = root_vec.clone() if slot == 1 else torch.zeros_like(root_vec)
            h = host_of(vec)
            timed_op("broadcast", lambda: comm.broadcast(h.numpy(), root=1, tag=21))
            vec.copy_(h)
            out["broadcast_ok"] = torch.equal(vec, root_vec)
            del vec, h
            # reduce_scatter: the chunk against the card's own sum
            h = host_of(rs_in[slot])
            chunk = torch.empty(-(-n // COMM_PEERS), pin_memory=pin)
            c, off, _ = timed_op("reduce_scatter", lambda: comm.reduce_scatter(
                h.numpy(), chunk.numpy(), tag=22))
            got = torch.from_numpy(c).to(dev)
            out["reduce_scatter_ok"] = torch.equal(got, rs_total[off:off + c.size])
            out["reduce_scatter_span"] = (off, c.size)
            del h, chunk, got
            # all_gather of this peer's 25 H1 digests
            digests = np.array([hashing.torch_simplehash_device(x)
                                for x in states[slot]], dtype=np.uint64)
            gathered, _ = timed_op("all_gather",
                                   lambda: comm.all_gather(digests, tag=23))
            out["digests"], out["gathered"] = digests, np.array(gathered)
            # all_to_all of three blocks: block j to the peer of slot j
            h = host_of(a2a[slot])
            recv, _ = timed_op("all_to_all", lambda: comm.all_to_all(h.numpy(), tag=24))
            out["all_to_all_ok"] = all(
                np.array_equal(recv[i * A2A_BLOCK:(i + 1) * A2A_BLOCK],
                               a2a[i][slot * A2A_BLOCK:(slot + 1) * A2A_BLOCK].cpu().numpy())
                for i in range(COMM_PEERS))
            del h
            st = comm.stats()
            out["edge_tx"] = sum(e["tx_bytes"] for e in st["edges"].values())
            out["moved"] = moved
            out["edges"] = len(st["edges"])
            # a new ring from measured bandwidths; then an all-reduce of
            # random floats (not order-free) must be bit-equal on all peers
            t0 = time.perf_counter()
            comm.optimize_topology()
            out["optimize_s"] = time.perf_counter() - t0
            x = torch.randn(1 << 24, generator=torch.Generator(device=dev)
                            .manual_seed(100 + slot), device=dev)
            h = host_of(x)
            comm.all_reduce(h.numpy(), op=ReduceOp.AVG, tag=25)
            out["after_optimize"] = hashlib.blake2b(h.numpy().data,
                                                    digest_size=16).hexdigest()
            res[slot] = out
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append((rank, repr(e)))
        finally:
            comm.destroy()

    threads = [threading.Thread(target=peer, args=(r,), daemon=True)
               for r in range(COMM_PEERS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PEER_TIMEOUT_S)
        events = trace_events()
    finally:
        trace_enable(False)
        trace_clear()
        master.interrupt()
        master.destroy()
        if saved is None:
            os.environ.pop("PCCLT_BENCH_SECONDS", None)
        else:
            os.environ["PCCLT_BENCH_SECONDS"] = saved
    if any(t.is_alive() for t in threads):
        raise SmokeError(f"12: a peer thread still runs after {PEER_TIMEOUT_S} s")
    if errors:
        raise SmokeError(f"12: peer failures: {errors}")
    for slot, out in res.items():
        for check in ("broadcast_ok", "reduce_scatter_ok", "all_to_all_ok"):
            if not out[check]:
                raise SmokeError(f"12: slot {slot}: {check.removesuffix('_ok')} "
                                 f"disagrees")
        for s in range(COMM_PEERS):
            if not np.array_equal(out["gathered"][s], res[s]["digests"]):
                raise SmokeError(f"12: slot {slot} sees other digests at slot {s}")
        if out["edges"] != COMM_PEERS - 1 or out["edge_tx"] < out["moved"]:
            raise SmokeError(f"12: slot {slot}: {out['edges']} edges carried "
                             f"{out['edge_tx']} bytes, ops reported {out['moved']}")
    spans = sorted(out["reduce_scatter_span"] for out in res.values())
    if spans[0][0] != 0 or sum(c for _, c in spans) != n:
        raise SmokeError(f"12: reduce_scatter chunks {spans} do not tile {n}")
    if len({out["after_optimize"] for out in res.values()}) != 1:
        raise SmokeError("12: the all-reduce after optimize_topology differs "
                         "across peers")
    names = {e.get("name") for e in events}
    if not {"reduce_scatter", "all_gather"} <= names:
        raise SmokeError(f"12: the flight recorder holds no ring events: "
                         f"{sorted(n for n in names if n)}")
    launches = {"simplehash_tpu": hashing.launches["simplehash_tpu"]}
    for slot in sorted(res):
        out = res[slot]
        log(f"  12 slot {slot}: " + ", ".join(
            f"{op} {out[op + '_s']:.3f} s tx {out[op + '_tx']}"
            for op in ("broadcast", "reduce_scatter", "all_gather", "all_to_all"))
            + f"; edges tx {out['edge_tx']} >= {out['moved']}; "
              f"optimize_topology {out['optimize_s']:.3f} s")
    log(f"comm surface: 3 peers; broadcast of {n} fp32 bit-equal to the root's; "
        f"reduce_scatter chunks {spans} equal to the card's sum (integer-valued "
        f"floats); each peer's 25 H1 digests at its gather_slot on every peer; "
        f"all_to_all exact; {len(events)} trace events; the all-reduce after "
        f"optimize_topology bit-equal; launches {launches}")
    del root_vec, rs_in, rs_total, states, a2a
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "peers": res}


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

    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops import hashing

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    kres = timed("kernels", phase_kernels)
    hres = timed("hash", phase_hash)
    timed("model", phase_model)
    # each main path runs in its peer processes, whose counts start at 0;
    # the comparisons above do not count
    fa.reset_launch_counts()
    hashing.reset_launch_counts()
    main_path = timed("diloco", phase_main_path)
    fa.reset_launch_counts()
    hashing.reset_launch_counts()
    ddp = timed("ddp", phase_ddp)
    fa.reset_launch_counts()
    async_path = timed("async", phase_async)
    timed("pipelined", phase_pipelined)
    # phase 8 runs in this process: its counts start at 0 here
    fa.reset_launch_counts()
    remat = timed("remat", phase_remat)
    fa.reset_launch_counts()
    resume = timed("diloco resume", phase_diloco_resume)
    fa.reset_launch_counts()
    hashing.reset_launch_counts()
    ddp_resume = timed("ddp resume", phase_ddp_resume)
    fa.reset_launch_counts()
    grid = timed("grid", phase_grid)
    # phase 12 runs in this process and sets H1's count to 0 itself just
    # before its peers start
    comm = timed("comm", phase_comm)
    paths = (main_path, ddp, async_path, remat, resume, ddp_resume, grid, comm)

    m, ll = kres["main"], kres["llama700m"]
    out_names = {"flash_fwd": ("out", "lse"), "flash_bwd_dq": ("dq",),
                 "flash_bwd_dkv": ("dk", "dv")}
    kernels = []
    for name, source, replaces, *_ in KERNELS:
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(p["launches"].get(name, 0) for p in paths)}
        if name in FLASH:
            def at(r):
                return {
                    "max_abs_err": max(r["errs"][o]["max_abs"] for o in out_names[name]),
                    "ms": r["ms"][name], "plain_ms": r["plain_ms"][name],
                    "bound_ms": r["bounds"][name][0], "bound_by": r["bounds"][name][1],
                    "library_ms": r["library_ms"][name]}

            # times at the GPT-2 paths' shape, and at phase 7's beside them
            row.update(at(m))
            row["llama700m"] = at(ll)
            row["ok"] = all(r["ok"] for r in kres.values())
        else:   # H1, times at tok_emb; the error over phase 3b's cases,
            # whose digests were compared exactly; no library call
            row.update({"max_abs_err": hres["max_abs_err"], "ms": hres["ms"],
                        "plain_ms": hres["plain_ms"], "bound_ms": hres["bound_ms"],
                        "bound_by": "bytes", "library_ms": None,
                        "ok": hres["max_abs_err"] == 0})
        kernels.append(row)
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
