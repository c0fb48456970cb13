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
   PyTorch versions (fp32 on the same bf16 inputs) at the shapes of
   SHAPES: the main path's, a GQA shape at head dim 128, a ragged
   non-causal shape, phase 7's Llama-700m shape, phase 13's ring
   steps (causal and not, and at Dh 128 with GQA), phase 14's tp
   ranks' blocks (Llama-700m at tp=4: 3 q heads over 1 kv head; GPT-2 at
   tp=2: 6 heads, at B=8 and at the (2, 2) mesh's B=2), phase 15's
   pipeline stages (one GPT-2 sequence), phase 18a's Llama-700m peer
   of 2 tp ranks (6 q heads over 2 kv heads, `tp2_llama`), and phase
   19's head dims 16 and 32 (`nano`, `tiny_gqa` and two ragged
   non-causal walks), which run the Dh 64 kernels at a padded width, and
   phase 21's bench shapes (`bench_gpt`: gpt2-medium, B=16, T=1024, 16
   heads; `bench_llama`: Llama-700m, B=8, T=2048; `long_gpt` and
   `long_llama`: batch 1 at T=8192; `long32k`: Llama-700m at T=32768,
   whose plain versions run 2048 query rows at a time);
   with CUDA-event times (`cuda_ms`) of the kernel, the plain version,
   F.scaled_dot_product_attention (a yardstick; the port never calls it) and
   the least time the card could take; and the backward's total, K2 + K3,
   beside SDPA's backward, which computes dq, dk and dv in one call;
3a. with_lse: flash_attention_with_lse's forward, and its backward with a
   random lse cotangent (folded into K2's and K3's delta, as every ring
   step's backward gets it), against dense_attention_with_lse under
   autograd at phase 13's ring-step shapes; dq and dk without the lse
   cotangent must fail the check;
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
   the others through pinned buffers; 32 steps), and a third that starts
   once the first has logged step 2 and adopts the
   cohort's parameters and AdamW state. Syncs move no bytes before it
   comes and after it adopted; it receives every entry's bytes; the three
   print equal digests at every common step and equal final parameters;
   every kernel (K1-K3 and H1) is launched on every peer;
7. main path, async DiLoCo on Llama-700m (GQA: 12 q heads over 4 kv heads,
   head dim 128): a master and two `async_diloco` peers (B=2, T=2048, 4
   inner steps, 3 outer steps). Every line must show world 2 and a finite
   loss, K1-K3 launched on both peers, and equal outer-state digests at
   every outer step and after finish(), and the --profile table of each;
   logs tok_s, join_s (the wait for the previous step's reduce) and each
   peer's peak allocation;
7b. the outer step's routes at Llama-700m's parameter count: two peers in
   this process, each a Diloco over one fp32 vector of 702,359,040 elements
   on the card (outer lr 1, no momentum, inner = outer - (rank + 1)): the
   pipelined windowed reduce through registered shm (4 windows), then the
   staged and the unstaged ring, two outer steps each, each peer on its
   own stream. The results must be exactly -1.5 and -3 everywhere and
   bit-identical on both peers; logs each step's profile (D2H, stage copy,
   ring, H2D and apply; the card's time of that peer's work, which shares
   the card with the other's): the first step pays each buffer's
   allocation and first touch, the second is warm;
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
   must agree at every step, each trace must hold its two metadata events
   and one event per section entered (`inner`, `outer/ring+sgd` and the
   train step's `train.*`) on a host row and again on the device's row,
   and the table must list `inner` and `outer/ring+sgd`;
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
13. sequence parallelism: four rank processes on the card in one gloo
   world (`python -m chip_smoke --sp-rank R --sp-port P`, started
   through the relay), each on its block of a GPT-2 124M batch (B=2,
   global T=4096, sp=4, so K1-K3 at [2, 1024, 12, 64]): 2 steps of
   train.build_train_step(mesh, seq_axis="sp") with ring attention. Rank
   0 first runs the full T=4096 step with flash_attention alone; step 0's
   loss must agree with it within 1e-3 nats and the averaged gradient
   have cosine >= 0.9998 (phase 4's limits). After every step H1's
   digests of the parameters must be equal on all ranks, and the hops
   must have sent 2 (n-1) L K/V pairs a rank; K1-K3 must launch 2 x 12 x 4
   times on every rank. Then Llama-700m widths at 2 layers (G=3, Dh 128)
   on a 2 x 2 (dp, sp) mesh, one loss-and-grad against its full-sequence
   reference with the same limits, and quantized_pmean (bitwise equal on
   every rank, within 16 int8 steps of max|x| of the exact sum) and
   local_mean (allclose to the fp32 mean) of 123,587,328 fp32 a rank.
   Logs each step's tok/s over the global tokens, the share of the step
   spent in hops (and in their D2H/H2D staging), and the collectives'
   seconds and bytes.
14. tensor parallelism: four rank processes on the card in one gloo world
   (`python -m chip_smoke --par-rank R --par-port P`, which go on to
   phases 15 and 16): Llama-700m at (dp, tp) = (1, 4), B=2, T=2048, 3
   AdamW steps of train.build_loss_and_grad(mesh=) + apply on each rank's
   blocks (K1-K3 at 3 q heads over 1 kv head). First, from the initial
   parameters, the tp loss-and-grad on each of the 3 batches, and rank 0
   the unsharded one in bf16 and in fp32 (dense attention): the loss must
   agree with the bf16 one within 1e-3 nats, and, since two bf16 steps of
   Llama-700m's 24 layers differ by more than phase 4's cosine, the
   gathered gradient's distance from the bf16 step is held to the bf16
   step's own rounding: (1 - cos(tp, bf16)) / (1 - cos(bf16, fp32)) <=
   TP_RATIO_LIMIT. A control reads each batch again with each rank's
   row-parallel partial rounded to bf16 before the sum (the fault the
   port's fp32 sum avoids) and must read above the limit. Then the
   steps: the losses and the H1 digests of the replicated gains must be
   equal on all ranks after every step; K1-K3 launch 2 x 24 times a rank.
   Then GPT-2 widths at 2 layers on a (2, 2) (dp, tp) mesh, B=4, T=1024,
   with the tied vocab-parallel head, one loss-and-grad under phase 4's
   limits against the unsharded bf16 one (loss gap <= 1e-3, cosine >=
   0.9998).
   Logs tok/s over the global tokens and the share of the step in the tp
   collectives (their calls and bytes);
15. pipeline: GPT-2 124M over 4 stages (3 layers each), B=8, T=1024, M=8
   microbatches, two forward-backward runs; the CE of the pipelined
   logits within 1e-3 nats of rank 0's gpt.forward, gradient cosine >=
   0.9998 over every parameter (layers gathered from the stages); K1-K3
   launch 3 x 11 times a stage a run. Logs step and hop seconds, hop bytes
   and the bubble share (S-1)/(M+S-1);
16. MoE at GPT-2 widths (d=768, d_ff=3072), E=8 over 4 expert ranks, x
   [8, 1024, 768]: at capacity_factor E every token's (expert, slot)
   equals rank 0's moe_mlp_dense routing (the dense slot is the shard's
   plus the earlier shards' counts) and the output is within 2e-2 of it;
   at 1.0 finite outputs, the dropped share, and sum(out²)'s gradient
   non-zero at the gate and w_in on every rank. Logs the all_to_all
   seconds and bytes;
17. `train_ddp --tp 2`: two GPT-2 124M peers, each a tp group of 2 ranks
   (the peer's process and the rank it spawns), and a master (B=8,
   T=1024, 16 steps, PCCLT_SS_HASH=simple-tpu). The peers' digests must
   agree at every step, every sync after the first move 0 bytes, the
   final params_blake2b agree and the loss fall; every rank of each peer
   must launch K1-K3 at every step (rank 0 gathers the counts); logs
   ring_s, sync_s and gather_s;
18. the DiLoCo peers' in-peer mesh (`--ranks N`: N processes on the
   mesh factor_mesh(N) over (dp, tp), rank 0 holding the comm and the
   whole outer state, gathering the ranks' blocks for each outer step and
   scattering them back): 18a, sync DiLoCo on Llama-700m (B=2, T=2048,
   2 inner and 2 outer steps), a peer of 2 ranks (tp=2: K1-K3 at 6 q
   heads over 2 kv heads) beside a peer of 1, both on data shard 0, and
   a master; the 2-rank peer's loss at each outer step after the first
   (the steps that start from a scatter) must be within MESH_LOSS_GAP of
   the 1-rank peer's; 18b, async
   DiLoCo on GPT-2 124M (B=8, T=1024, 4 inner and 2 outer steps), two
   peers of 2 ranks; 18c, phase 11's grid at 2 outer steps with one cell
   of each group at 2 ranks. Each peer of 2 ranks must log both ranks on
   the card; every rank of every peer must launch K1-K3 at every outer
   step; digests must be equal across the peers at every outer step (and
   after the async finish()), the grid's within each group, and every
   grid sync after the first must move 0 bytes. Logs tok_s, outer_s,
   gather_s and scatter_s (the outer step's gather to rank 0 and scatter
   back), join_s, each rank's launches and the peaks.
19. the examples at their default command line, on the card: `python -m
   pccl_tpu_torch.examples.sync_diloco --solo` (GPT `nano`, Dh 16) and
   `async_diloco --solo --family llama --model tiny` (Dh 32, 4 q over 2
   kv heads), at once; each must exit 0 (its loss fell), print world 1
   and K1-K3 launches at every outer step, and FINAL;
20. the fault-tolerance soak with CUDA shared states: `python -m
   pccl_tpu_torch.examples.stress.stress_orchestrator --device cuda
   --duration 45 --peers 3 --sync-churn 1048576 --stall-seconds 60
   --sync-degrade-mbit 0`: a master and three `ft_peer` processes on the
   card, dying at random and relaunched, a joiner flood and a seeder
   kill; each peer's 4 MiB state a `TensorInfo.from_torch_device` entry
   hashed by H1 on every sync. It must print SOAK PASSED with a relaunch
   or more and a SYNC SUMMARY with no wrong adoption, no failed sync and
   H1 launches (log `soak.log`);
21. the port's benchmarks, each part in a process of its own printing one
   JSON line (logs `bench_*.log`): `python -m
   pccl_tpu_torch.benchmarks.model_bench gpt` and `llama` at their default
   shapes (gpt2-medium B=16 T=1024, Llama-700m B=8 T=2048, no remat), 3
   windows of 4 steps: K1-K3 launched n_layer times a step each, the
   loss falling on the repeated batch, 0 < MFU <= 1.05; Llama-700m at
   T=32768, batch 1, remat and loss_chunk 2048 (bench.py's longest leg), 2
   windows of 2 steps: finite losses, K1 2 n_layer and K2, K3 n_layer
   launches a step (its kernels held at that shape in phase 3,
   `long32k`); `hash_bench` (H1's digest equal to the staging digest at
   16 and 64 MB, H1 launched); and native_bench's DiLoCo legs with the
   outer state on the card (`python -m chip_smoke --bench-part NAME`):
   the outer step at 100M fp32 elements over two peers (equal digests,
   every element at the synthetic step's closed form), the 100
   Mbit/s-paced sync leg at 1 and 4 windows and the async leg beside its
   sync twin (a 1 s matmul burn), whose times and phases are logged. The
   T=32768 leg, hash_bench and the three DiLoCo parts run at once, after
   the two model_bench legs, which run alone. Phases 9 and 10 run at
   once, and so do phases 19 and 20.

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
    # phase 13's ring steps: GPT-2 at sp=4 (step 0 causal, the others
    # not), and Llama-700m widths on the 2 x 2 (dp, sp) mesh
    ("sp", dict(B=2, T=1024, H=12, Hkv=12, D=64, causal=False)),
    ("sp_causal", dict(B=2, T=1024, H=12, Hkv=12, D=64, causal=True)),
    ("sp_gqa", dict(B=1, T=2048, H=12, Hkv=4, D=128, causal=False)),
    # phase 14's tp ranks: Llama-700m at tp=4 (3 q heads over 1 kv head a
    # rank) and GPT-2 at tp=2
    ("tp", dict(B=2, T=2048, H=3, Hkv=1, D=128, causal=True)),
    ("tp_gpt", dict(B=8, T=1024, H=6, Hkv=6, D=64, causal=True)),
    # phase 14's GPT-2 check on the (2, 2) (dp, tp) mesh, and phase 15's
    # pipeline stages (a microbatch of one GPT-2 sequence)
    ("tp_dp", dict(B=2, T=1024, H=6, Hkv=6, D=64, causal=True)),
    ("pp", dict(B=1, T=1024, H=12, Hkv=12, D=64, causal=True)),
    # phase 18a's Llama-700m peer of 2 tp ranks: 6 q heads over 2 kv heads
    ("tp2_llama", dict(B=2, T=2048, H=6, Hkv=2, D=128, causal=True)),
    # phase 19's examples at their defaults: GPT `nano` (Dh 16) and Llama
    # `tiny` (Dh 32, 4 q over 2 kv heads), which run the Dh 64 kernels at a
    # padded width; and ragged non-causal walks at both head dims
    ("nano", dict(B=8, T=64, H=4, Hkv=4, D=16, causal=True)),
    ("tiny_gqa", dict(B=8, T=64, H=4, Hkv=2, D=32, causal=True)),
    ("ragged16", dict(B=2, T=100, H=4, Hkv=2, D=16, causal=False)),
    ("ragged32", dict(B=2, T=200, H=4, Hkv=4, D=32, causal=False)),
    # phase 21's bench shapes: gpt2-medium and Llama-700m at model_bench's
    # default batches, the long-context legs at T=8192, and Llama-700m at
    # T=32768, phase 21's longest leg, whose plain versions run 2048 query
    # rows at a time (the whole [B, H, T, T] fp32 scores, 51 GB, would not
    # fit beside their intermediates)
    ("bench_gpt", dict(B=16, T=1024, H=16, Hkv=16, D=64, causal=True)),
    ("bench_llama", dict(B=8, T=2048, H=12, Hkv=4, D=128, causal=True)),
    ("long_gpt", dict(B=1, T=8192, H=16, Hkv=16, D=64, causal=True)),
    ("long_llama", dict(B=1, T=8192, H=12, Hkv=4, D=128, causal=True)),
    ("long32k", dict(B=1, T=32768, H=12, Hkv=4, D=128, causal=True, q_block=2048)),
]
# the shapes whose outputs must also fail the check with one tile skipped
CONTROL_SHAPES = ("main", "nano", "tiny_gqa", "long_gpt", "long_llama", "long32k")
# Shapes whose dq, dk and dv are held to TOL against the plain versions
# with p and ds rounded to bf16 where the kernels round them (bf16_p), and
# to TOL's relative L2 against the fp32 ones. A causal dk or dv row sums
# the rows that see it, so at T=8192 the first rows are tens of times the
# tensor's rms, and the bf16 rounding of p, which the kernels share with
# the TPU kernels, gives an error there that grows past 0.15 rms (long_gpt's
# dv read 0.153 against the fp32 versions on an H100; PERF.md, section 6).
BF16_P_SHAPES = ("long_gpt", "long_llama", "long32k")
WITH_LSE_SHAPES = ("sp", "sp_causal", "sp_gqa")

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
# 32 steps: the late joiner adopts near steps 14-16 and must train 10 or
# more with the others (80 until the smoke grew phase 18, 48 until it grew
# phase 21)
DDP = dict(model="gpt2", block=1024, batch=8, steps=32)
# 4 inner steps (once 8, cut to make room for phases 19 and 20): the
# checks are digests and launches at every outer step, which 4 hold as
# well as 8
ASYNC = dict(family="llama", model="700m", block=2048, batch=2, inner_steps=4,
             outer_steps=3)
LLAMA700M_PARAMS = 702_359_040
PEER_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn):
    """fn(), logging its seconds as phase `name`."""
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


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


def check_the_check(qf, kf, vf, dof, lse, delta, causal, refs,
                    q_block=None) -> None:
    """The check must reject what a kernel that skips one 64-wide tile of
    its loop would give: out and dq without one k tile's v (its P.V and
    dO.V^T shares), dk and dv without one q tile's share. The tile sits at
    T/2, so under the causal mask only the deep rows miss it; at T = 64
    (the `nano` and `tiny_gqa` shapes) it is rows 32..63, half of the one
    tile."""
    from pccl_tpu_torch.ops import flash_attention as fa

    t0 = qf.shape[1] // 2
    v_cut, do_cut, delta_cut = vf.clone(), dof.clone(), delta.clone()
    v_cut[:, t0:t0 + 64] = 0
    do_cut[:, t0:t0 + 64] = 0
    delta_cut[..., t0:t0 + 64] = 0
    bad = {"out": fa.flash_fwd_plain(qf, kf, v_cut, causal, q_block=q_block)[0],
           "dq": fa.flash_bwd_dq_plain(qf, kf, v_cut, dof, lse, delta, causal,
                                       q_block=q_block)}
    bad["dk"], bad["dv"] = fa.flash_bwd_dkv_plain(qf, kf, vf, do_cut, lse,
                                                  delta_cut, causal, q_block=q_block)
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
        qb = s.get("q_block")
        gen = torch.Generator(device=dev).manual_seed(1234)

        def rnd(heads):
            return torch.randn((B, T, heads, D), generator=gen, device=dev,
                               dtype=torch.bfloat16)

        q, k, v, do = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()

        out, lse = fa.flash_fwd(q, k, v, causal)
        ref_out, ref_lse = fa.flash_fwd_plain(qf, kf, vf, causal, q_block=qb)
        # both backward versions get the same lse and delta
        delta = (dof * ref_out).sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
        bf16_p = tag in BF16_P_SHAPES
        ref_dq = fa.flash_bwd_dq_plain(qf, kf, vf, dof, ref_lse, delta, causal,
                                       bf16_p, q_block=qb)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(qf, kf, vf, dof, ref_lse, delta,
                                                causal, bf16_p, q_block=qb)
        torch.cuda.synchronize()

        pairs = (("out", out, ref_out), ("lse", lse, ref_lse), ("dq", dq, ref_dq),
                 ("dk", dk, ref_dk), ("dv", dv, ref_dv))
        errs = {name: compare(name, got, ref) for name, got, ref in pairs}
        notes = []
        if bf16_p:
            f32 = {"dq": fa.flash_bwd_dq_plain(qf, kf, vf, dof, ref_lse, delta,
                                               causal, q_block=qb)}
            f32["dk"], f32["dv"] = fa.flash_bwd_dkv_plain(qf, kf, vf, dof, ref_lse,
                                                          delta, causal, q_block=qb)
            for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
                e = compare(name, got, f32[name])
                e["ok"] = e["rel"] <= TOL[name][0]
                notes.append(f"  against the fp32 plain version: {fmt_err(name, e)} "
                             f"(relative L2 held){'' if e['ok'] else '  FAIL'}")
                errs[name]["ok"] &= e["ok"]
            del f32
        if tag in CONTROL_SHAPES:
            check_the_check(qf, kf, vf, dof, ref_lse, delta, causal, dict(
                (name, ref) for name, _, ref in pairs), q_block=qb)

        # the kernels and SDPA at T=32768 take milliseconds a call, the
        # plain versions at T=8192 tens of ms, at 32768 hundreds: fewer calls
        kern = dict(calls=5, pairs=3, warmup=1) if T > 8192 else {}
        ms = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal), **kern),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, ref_lse,
                                                            delta, causal), **kern),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, ref_lse,
                                                              delta, causal), **kern),
        }
        few = dict(calls=1, pairs=3, warmup=1) if T > 4096 else dict(calls=3)
        plain_ms = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(qf, kf, vf, causal,
                                                            q_block=qb), **few),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_plain(
                qf, kf, vf, dof, ref_lse, delta, causal, q_block=qb), **few),
            "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
                qf, kf, vf, dof, ref_lse, delta, causal, q_block=qb), **few),
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
                                                       retain_graph=True), **kern)
        library_ms = {"flash_fwd": cuda_ms(sdpa, **kern), "flash_bwd_dq": sdpa_bwd,
                      "flash_bwd_dkv": sdpa_bwd}
        bnd = bounds(B, T, H, Hkv, D, causal)
        ok = all(e["ok"] for e in errs.values())
        log(f"kernels @ {tag} {s}:")
        for name, e in errs.items():
            log(f"  {fmt_err(name, e)}{'' if e['ok'] else '  FAIL'}")
        for note in notes:
            log(note)
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


def phase_with_lse() -> dict:
    """flash_attention_with_lse (K1; K2 and K3 with delta - dlse) against
    dense_attention_with_lse under autograd, on the same bf16 inputs (the
    dense one in fp32), with a random lse cotangent: the ring folds each
    step's lse, so every step's backward gets one. Returns the errors."""
    import torch

    from pccl_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    shapes = dict(SHAPES)
    results = {}
    for tag in WITH_LSE_SHAPES:
        B, T, H, Hkv, D, causal = (shapes[tag][k] for k in
                                   ("B", "T", "H", "Hkv", "D", "causal"))
        gen = torch.Generator(device=dev).manual_seed(4321)

        def rnd(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        q, k, v, do = rnd(B, T, H, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D), \
            rnd(B, T, H, D)
        dlse = rnd(B, H, T, dtype=torch.float32)

        def run(attn, dtype, cot_lse):
            xs = [x.to(dtype).requires_grad_(True) for x in (q, k, v)]
            out, lse = attn(*xs, causal)
            grads = torch.autograd.grad((out, lse), xs,
                                        (do.to(dtype), cot_lse))
            return dict(zip(("out", "lse", "dq", "dk", "dv"),
                            (out.detach(), lse.detach(), *grads)))

        got = run(fa.flash_attention_with_lse, torch.bfloat16, dlse)
        ref = run(fa.dense_attention_with_lse, torch.float32, dlse)
        torch.cuda.synchronize()
        errs = {name: compare(name, got[name], ref[name]) for name in ref}
        log(f"with_lse @ {tag} {shapes[tag]}:")
        for name, e in errs.items():
            log(f"  {fmt_err(name, e)}{'' if e['ok'] else '  FAIL'}")
        if not all(e["ok"] for e in errs.values()):
            raise SmokeError(f"flash_attention_with_lse disagrees with "
                             f"dense_attention_with_lse at {tag}")
        # the check must see the lse cotangent: the reference's dq and dk
        # without it (dv does not depend on it) must fail
        no_dlse = run(fa.dense_attention_with_lse, torch.float32,
                      torch.zeros_like(dlse))
        for name in ("dq", "dk"):
            e = compare(name, no_dlse[name].bfloat16(), ref[name])
            log(f"  control, lse cotangent dropped: {fmt_err(name, e)}")
            if e["ok"]:
                raise SmokeError(f"the {name} check passes a backward that "
                                 f"drops the lse cotangent at {tag}")
        results[tag] = errs
        del q, k, v, do, dlse, got, ref, no_dlse
        torch.cuda.empty_cache()
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


def cosine(a, b) -> float:
    """The cosine of two tensors taken flat, their products summed in fp64
    chunk by chunk: an fp32 reduction over hundreds of millions of
    elements can be off by more than the 2e-4 the checks resolve (on the
    CPU, cosine_similarity gave 1.0145 for two 700m-width gradients whose
    cosine is 0.99997)."""
    dot = na = nb = 0.0
    for x, y in zip(a.reshape(-1).split(1 << 24), b.reshape(-1).split(1 << 24)):
        x, y = x.double(), y.double()
        dot += (x @ y).item()
        na += (x @ x).item()
        nb += (y @ y).item()
    return dot / math.sqrt(na * nb)


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
    cos = cosine(gf, gd)
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
            # taken, or past 65535 (a kernel may hand out ports up to there)
            except (OSError, OverflowError):
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


def start_master(procs: list, files: list, env: dict,
                 log_name: str = "master.log") -> int:
    """A master on an OS-chosen port, logging to LOG_DIR/log_name; returns
    the port once it listens."""
    port, = free_ports(1)
    path = LOG_DIR / log_name
    files.append(open(path, "w"))
    master = subprocess.Popen(
        [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--listen",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env, stdout=files[-1],
        stderr=subprocess.STDOUT)
    procs.append(master)
    deadline = time.time() + 60
    while "master listening" not in path.read_text():
        if master.poll() is not None or time.time() > deadline:
            raise SmokeError("master did not start: " + path.read_text())
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
    LOG_DIR/names[rank] (the master to master_<names[0]>); returns each peer's
    (exit code, log text) once both have ended. Stops every process it
    started."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1", **(env_extra or {}))
    procs, files, peers = [], [], []
    try:
        port = start_master(procs, files, env, f"master_{names[0]}")
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
         # 12 steps from random init need not show learning; the checks
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
            # a stream a peer, so each profile's events time that peer's
            # work alone and its stream idles through its host phases
            with torch.cuda.stream(torch.cuda.Stream()):
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
                        exact[route, rank].append(
                            bool((w == -1.5 * (step + 1)).all()))
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
            run["cosine"] = cosine(grads, ref[1])
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
    """A --trace-out file of a peer on a card: one process_name event, one
    thread_name event naming the device's row, then one complete event per
    section entered on a host row and one on the device's row, `sections`
    giving how often each was entered."""
    from pccl_tpu_torch.utils.profiler import DEVICE_TID

    events = json.loads(path.read_text())["traceEvents"]
    meta = [e for e in events if e.get("ph") == "M"]
    host, device = {}, {}
    for e in events:
        if e.get("ph") == "X":
            row = device if e["tid"] == DEVICE_TID else host
            row[e["name"]] = row.get(e["name"], 0) + 1
    if (sorted(e["name"] for e in meta) != ["process_name", "thread_name"]
            or host != sections or device != sections
            or len(events) != 2 + 2 * sum(sections.values())):
        raise SmokeError(f"trace {path.name}: metadata {meta}, host spans {host}, "
                         f"device spans {device}, expected {sections} on each")


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
            inner = steps * r["inner_steps"]
            check_trace(LOG_DIR / f"resume{run}_{rank}.trace.json",
                        {"inner": steps, "outer/ring+sgd": steps,
                         "train.forward": inner, "train.backward": inner,
                         "train.optimizer": inner})
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


def phases_9_10() -> tuple:
    """Phases 9 and 10 at once (two resumed pairs of GPT-2-width peers, each
    under its own masters, checkpoints and logs); returns their results."""
    with ThreadPoolExecutor(2) as ex:
        resume = ex.submit(timed, "diloco resume", phase_diloco_resume)
        ddp_resume = ex.submit(timed, "ddp resume", phase_ddp_resume)
        return resume.result(), ddp_resume.result()


# ------------------------------------------------------------------ phase 11

# 12 outer steps: from random init at GPT-2 width AdamW at 1e-3 swings the
# loss by ~0.2 nats a step; over 3 outer steps one cell of four did not
# learn, over 8 one fell by only 0.08 nats
GRID = dict(model="gpt2", block=1024, batch=8, inner_steps=4, outer_steps=12,
            shards=2, replicas=2)
GRID_LINE = re.compile(
    r"^outer (\d+) loss (\S+) grid (\d+)x(\d+) global (\d+) shard (\d+) "
    r"\[(\d+):(\d+)\] tok_s (\S+) outer_s (\S+) launches (\d+) (\d+) (\d+) "
    r"digest (\w+) tx (\d+) rx (\d+)"
    r"(?: gather_s (\S+) scatter_s (\S+) rank_launches (\S+))?$", re.M)
GRID_FINAL = re.compile(r"^FINAL first_loss=(\S+) last_loss=(\S+) "
                        r"last_sync_tx=(\d+) last_sync_rx=(\d+)"
                        r"(?: peak_alloc_mib=(\d+))? peak_rss_mib=(\d+)$", re.M)


def phase_grid(dev: str = "cuda", gr: dict = GRID, tag: str = "11") -> dict:
    """A master and a 2 x 2 grid of `grid_diloco` cells on the card (two
    outer-state shards, two replicas each), sharing one grid file; returns
    the launch totals and each cell's rows. gr["ranks"], where given, is
    each replica's --ranks (phase 18c)."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    # the file holds the full fp32 outer vector; /dev/shm as the JAX
    # example's default when it has room, else the log directory
    need = 2 * GPT2_PARAM_BYTES
    shm = Path("/dev/shm")
    where = shm if shm.is_dir() and shutil.disk_usage(shm).free > need else LOG_DIR
    grid_file = where / f"pcclt_grid_smoke_{tag}_{os.getpid()}.bin"
    names = [f"grid{tag}_{g}{r}.log" for g in range(gr["shards"])
             for r in range(gr["replicas"])]
    ranks = gr.get("ranks", [1] * gr["replicas"])
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
                "--attn", "flash" if dev == "cuda" else "dense",
                "--ranks", str(ranks[i % gr["replicas"]]),
                *([] if gr.get("descent", True) else ["--no-descent-check"])]))
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
            raise SmokeError(f"{tag}: grid cell {names[i]} exited {p.returncode}")
        r = GRID_LINE.findall(text)
        if len(r) != gr["outer_steps"]:
            raise SmokeError(f"{tag}: {names[i]} logged {len(r)} outer steps")
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
                raise SmokeError(f"{tag}: {names[i]} outer step {step}: {row}")
            if step and (row[14], row[15]) != ("0", "0"):
                raise SmokeError(f"{tag}: {names[i]}'s sync at outer step {step} "
                                 f"moved tx {row[14]} rx {row[15]} bytes")
            for name, n in zip(FLASH, row[10:13]):
                if int(n) <= 0:
                    raise SmokeError(f"{tag}: {names[i]}: {name} never launched")
                totals[name] += int(n)
            check_rank_launches(f"{tag}: {names[i]} outer step {step}",
                                row[18], ranks[i % gr["replicas"]])
        check_mesh_devices(f"{tag}: {names[i]}", texts[i], ranks[i % gr["replicas"]])
        if finals[i][2:4] != ("0", "0"):
            raise SmokeError(f"{tag}: {names[i]}'s closing sync moved bytes")
        if gr.get("descent", True) and not float(finals[i][1]) < float(finals[i][0]):
            raise SmokeError(f"{tag}: {names[i]}: loss did not fall {finals[i][:2]}")
    for g in range(gr["shards"]):
        group = rows[g * gr["replicas"]:(g + 1) * gr["replicas"]]
        for step in range(gr["outer_steps"]):
            if len({r[step][13] for r in group}) != 1:
                raise SmokeError(f"{tag}: group {g}'s digests differ at outer "
                                 f"step {step}")
    for i, (r, f) in enumerate(zip(rows, finals)):
        log(f"  grid cell {names[i].removesuffix('.log')} (shard {r[0][5]} "
            f"[{r[0][6]}:{r[0][7]}]): loss {' '.join(x[1] for x in r)}; tok_s "
            f"{' '.join(x[8] for x in r)}; outer_s {' '.join(x[9] for x in r)}; "
            + (f"gather_s {' '.join(x[16] for x in r)}; scatter_s "
               f"{' '.join(x[17] for x in r)}; rank launches "
               f"{' '.join(x[18] for x in r)}; " if r[0][18] else "")
            + f"peak allocated MiB {f[4]}, peak host RSS MiB {f[5]}")
    log(f"grid path ({tag}): {full} cells of {ranks} ranks, global {world} at "
        f"every outer step; each group's digests equal at every step; syncs "
        f"after the first 0 bytes{'; losses fell' if gr.get('descent', True) else ''}; "
        f"grid file in {where}; launches {totals}")
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


# ------------------------------------------------------------------ phase 13

# GPT-2 124M at 4 sp ranks on the card: each rank runs K1-K3 at [2, 1024,
# 12, 64]; then Llama-700m widths at 2 layers on a 2 x 2 (dp, sp) mesh
# 2 steps (3 until phase 21 came): step 0 against the full-sequence step,
# the digests and the hop bytes after each
SP = dict(model="gpt2", batch=2, block=4096, steps=2, ranks=4)
SP_GQA = dict(model="700m", n_layer=2, batch=2, block=4096, mesh=(2, 2))
SP_TIMEOUT_S = 300
QRING_BLOCK = 256


def _flat_grads(state):
    import torch

    return torch.cat([state.params[n].grad.float().reshape(-1)
                      for n in sorted(state.params)])


def _against_reference(state, ref) -> dict:
    """The loss gap and the gradient cosine of this rank's averaged
    gradients against the full-sequence reference (loss, flat gradient)."""
    return {"ref_loss": ref[0],
            "cosine": cosine(_flat_grads(state), ref[1])}


def _reference(cfg, state, tokens, targets):
    """One process's full-sequence loss and gradients: flash_attention
    directly, no ring."""
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib

    loss = train_lib.build_loss_and_grad(cfg, attn_fn=fa.flash_attention)(
        state, tokens, targets).item()
    grads = _flat_grads(state)
    state.optimizer.zero_grad(set_to_none=True)
    return loss, grads


def sp_rank(rank: int, port: int) -> None:
    """One of phase 13's four ranks (`python -m chip_smoke --sp-rank R
    --sp-port P`): all share the card over gloo; writes its figures to
    LOG_DIR/sp<R>.json."""
    import datetime
    import hashlib

    import torch
    import torch.distributed as dist

    from pccl_tpu_torch.models import gpt, llama
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops import hashing
    from pccl_tpu_torch.ops.quantized_collectives import quantized_pmean
    from pccl_tpu_torch.ops.ring_attention import make_ring_attn_fn
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.hierarchical import local_mean

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=SP["ranks"],
                            timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    out = {"rank": rank}
    try:
        # ---- the main path: GPT-2 124M train steps over 4 sp ranks
        mesh = mesh_lib.make_mesh(("dp", "sp"), (1, SP["ranks"]), backend="gloo")
        B, T = SP["batch"], SP["block"]
        cfg = gpt.named_config(SP["model"], block_size=T)
        state = train_lib.make_train_state(0, cfg, dev)
        gen = torch.Generator().manual_seed(13)
        batches = [tuple(torch.randint(0, cfg.vocab_size, (B, T), generator=gen).to(dev)
                         for _ in range(2)) for _ in range(SP["steps"])]
        ref = _reference(cfg, state, *batches[0]) if rank == 0 else None
        step = train_lib.build_train_step(cfg, attn_fn=make_ring_attn_fn(mesh, "sp"),
                                          mesh=mesh, seq_axis="sp")
        ring = mesh.ring("sp")
        dist.barrier()
        fa.reset_launch_counts()
        hashing.reset_launch_counts()
        rows = []
        for i, (tok, tgt) in enumerate(batches):
            torch.cuda.synchronize()
            hop0, stage0, bytes0 = ring.seconds, ring.stage_seconds, ring.bytes
            t0 = time.perf_counter()
            loss = step(state, tok, tgt).item()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            row = {"loss": loss, "step_s": step_s, "tok_s": B * T / step_s,
                   "hop_s": ring.seconds - hop0, "stage_s": ring.stage_seconds - stage0,
                   "hop_bytes": ring.bytes - bytes0}
            if ref is not None and i == 0:
                row.update(_against_reference(state, ref))
            row["digest"] = " ".join(
                f"{hashing.torch_simplehash_device(state.params[n].detach()):016x}"
                for n in sorted(state.params))
            rows.append(row)
        out["steps"] = rows
        out["launches"] = {**fa.launches, **hashing.launches}
        del state, step, batches, ref
        torch.cuda.empty_cache()

        # ---- GQA: Llama-700m widths, 2 layers, a 2 x 2 (dp, sp) mesh
        gq = SP_GQA
        gmesh = mesh_lib.make_mesh(("dp", "sp"), gq["mesh"], backend="gloo")
        gcfg = llama.named_config(gq["model"], n_layer=gq["n_layer"],
                                  block_size=gq["block"])
        gstate = train_lib.make_train_state(0, gcfg, dev)
        gen = torch.Generator().manual_seed(17)
        tok, tgt = (torch.randint(0, gcfg.vocab_size, (gq["batch"], gq["block"]),
                                  generator=gen).to(dev) for _ in range(2))
        gref = _reference(gcfg, gstate, tok, tgt) if rank == 0 else None
        dist.barrier()
        fa.reset_launch_counts()
        loss = train_lib.build_loss_and_grad(
            gcfg, attn_fn=make_ring_attn_fn(gmesh, "sp"), mesh=gmesh,
            seq_axis="sp")(gstate, tok, tgt).item()
        out["gqa"] = {"loss": loss, "launches": dict(fa.launches)}
        if gref is not None:
            out["gqa"].update(_against_reference(gstate, gref))
        del gstate, gref
        torch.cuda.empty_cache()

        # ---- the quantized ring and local_mean at GPT-2's parameter count
        n = GPT2_PARAM_BYTES // 4
        group = mesh.group("sp")
        xs = [torch.randn(n, device=dev, generator=torch.Generator(dev).manual_seed(100 + r))
              for r in range(SP["ranks"])]
        total = xs[0] + xs[1] + xs[2] + xs[3]
        for name, fn in (("qring", lambda: quantized_pmean(
                             {"x": xs[rank]}, group, block=QRING_BLOCK)),
                         ("local_mean", lambda: local_mean({"x": xs[rank]}, mesh, "sp"))):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()["x"]
            torch.cuda.synchronize()
            out[name] = {"s": time.perf_counter() - t0,
                         "blake2b": hashlib.blake2b(got.cpu().numpy().tobytes(),
                                                    digest_size=16).hexdigest()}
            if name == "qring":
                # the JAX test's bound, on the sum: 16 int8 steps of max|x|
                out[name].update(
                    err=(got * SP["ranks"] - total).abs().max().item(),
                    bound=16 * max(x.abs().max().item() for x in xs) / 127)
            else:
                out[name]["allclose"] = bool(torch.allclose(
                    got, total / SP["ranks"], rtol=1e-5, atol=1e-6))
                out[name]["max_abs_err"] = (got - total / SP["ranks"]).abs().max().item()
    finally:
        (LOG_DIR / f"sp{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def phase_sp() -> dict:
    """Four ranks on the card, one process each over gloo (sp_rank):
    GPT-2 124M sequence-parallel train steps with ring attention, a GQA
    loss-and-grad on a dp x sp mesh, the quantized ring and local_mean;
    returns the main path's launch totals."""
    return check_sp(run_ranks("sp", "sp", SP["ranks"], SP_TIMEOUT_S))


def _each(spec: str, values) -> str:
    return " ".join(spec.format(v) for v in values)


def check_sp(res: list) -> dict:
    """Phase 13's checks over the ranks' figures; returns the main path's
    launch totals."""
    from pccl_tpu_torch.models import gpt

    cfg = gpt.named_config(SP["model"])
    n, L = SP["ranks"], cfg.n_layer
    r0 = res[0]
    for i in range(SP["steps"]):
        rows = [r["steps"][i] for r in res]
        if len({row["loss"] for row in rows}) != 1 or not math.isfinite(rows[0]["loss"]):
            raise SmokeError(f"13: step {i}: losses {[row['loss'] for row in rows]}")
        if len({row["digest"] for row in rows}) != 1:
            raise SmokeError(f"13: step {i}: H1 digests of the parameters differ "
                             f"across the ranks")
        log(f"  sp step {i}: loss {rows[0]['loss']:.5f}, tok/s (global tokens) "
            f"{_each('{:.0f}', [x['tok_s'] for x in rows])}, step s "
            f"{_each('{:.3f}', [x['step_s'] for x in rows])}, hop share "
            f"{_each('{:.3f}', [x['hop_s'] / x['step_s'] for x in rows])} (of it "
            f"D2H/H2D staging {_each('{:.3f}', [x['stage_s'] / x['step_s'] for x in rows])}; "
            f"{rows[0]['hop_bytes']} bytes sent a rank); H1 digests equal")
    first = r0["steps"][0]
    gap = abs(first["loss"] - first["ref_loss"])
    log(f"  sp vs the full-sequence reference (T={SP['block']}): loss "
        f"{first['loss']:.6f} vs {first['ref_loss']:.6f} (gap {gap:.2e}), "
        f"gradient cosine {first['cosine']:.7f}")
    # phase 4's limits
    if not (gap <= 1e-3 and first["cosine"] >= 0.9998):
        raise SmokeError("13: the sp step disagrees with the full-sequence step")
    # a hop moves K and V, [B, T/n, H, Dh] bf16 each; n - 1 hops a layer
    # in the forward and as many in the backward
    hop_bytes = 2 * (n - 1) * L * 2 * SP["batch"] * SP["block"] // n \
        * cfg.n_embd * 2
    if any(r["steps"][i]["hop_bytes"] != hop_bytes
           for r in res for i in range(SP["steps"])):
        raise SmokeError(f"13: a rank's hops sent other than {hop_bytes} bytes "
                         f"a step")
    want = SP["steps"] * L * n
    for r in res:
        got = [r["launches"][k] for k in FLASH]
        if got != [want] * 3 or r["launches"]["simplehash_tpu"] <= 0:
            raise SmokeError(f"13: rank {r['rank']} launched {r['launches']}, "
                             f"K1-K3 {want} each expected ({SP['steps']} steps x "
                             f"{L} layers x {n} ring steps)")
    log(f"  sp launches per rank: {[r['launches'] for r in res]}")

    g = r0["gqa"]
    gap = abs(g["loss"] - g["ref_loss"])
    gl = SP_GQA["n_layer"]
    log(f"  GQA (Llama-700m widths, {gl} layers, dp x sp {SP_GQA['mesh']}): loss "
        f"{g['loss']:.6f} vs {g['ref_loss']:.6f} (gap {gap:.2e}), gradient "
        f"cosine {g['cosine']:.7f}; launches {[r['gqa']['launches'] for r in res]}")
    if not (gap <= 1e-3 and g["cosine"] >= 0.9998):
        raise SmokeError("13: the GQA sp loss-and-grad disagrees with its reference")
    for r in res:
        if [r["gqa"]["launches"][k] for k in FLASH] != [gl * SP_GQA["mesh"][1]] * 3:
            raise SmokeError(f"13: rank {r['rank']}'s GQA launches {r['gqa']['launches']}")

    q = [r["qring"] for r in res]
    if len({x["blake2b"] for x in q}) != 1:
        raise SmokeError("13: the quantized ring's results differ across the ranks")
    if any(x["err"] > x["bound"] for x in q):
        raise SmokeError(f"13: quantized ring error {[x['err'] for x in q]} over "
                         f"its bound {q[0]['bound']}")
    lm = [r["local_mean"] for r in res]
    if not all(x["allclose"] for x in lm):
        raise SmokeError(f"13: local_mean off the fp32 mean by "
                         f"{[x['max_abs_err'] for x in lm]}")
    # each of the 2(n - 1) hops carries a chunk of int8 codes and its scales
    chunk = -(-(GPT2_PARAM_BYTES // 4) // (n * QRING_BLOCK)) * QRING_BLOCK
    qbytes = 2 * (n - 1) * (chunk + 4 * chunk // QRING_BLOCK)
    log(f"  quantized_pmean of {GPT2_PARAM_BYTES // 4} fp32 over {n} ranks: s "
        f"{_each('{:.3f}', [x['s'] for x in q])}, bytes sent a rank {qbytes} "
        f"in {2 * (n - 1)} hops, error of the sum {max(x['err'] for x in q):.4g} "
        f"(bound {q[0]['bound']:.4g}), bitwise equal on every rank")
    log(f"  local_mean of the same vector: s "
        f"{_each('{:.3f}', [x['s'] for x in lm])}, max |err| "
        f"{max(x['max_abs_err'] for x in lm):.3g}, results "
        f"{'bitwise equal' if len({x['blake2b'] for x in lm}) == 1 else 'NOT bitwise equal'}"
        f" across the ranks")
    totals = {k: sum(r["launches"][k] for r in res) for k in (*FLASH, "simplehash_tpu")}
    log(f"sp path: {n} ranks on one card over gloo, losses and H1 digests equal "
        f"at every step; launches {totals}")
    return {"launches": totals, "ranks": res}


# ------------------------------------------------------------ phases 14-16

# "over": overrides of the preset's config (its depth only, here)
# 2 steps (3 until phase 21 came): the losses and the gains' digests after
# every step; the ratio check reads 3 batches from the initial parameters
TP = dict(model="700m", over={}, batch=2, block=2048, steps=2, mesh=(1, 4))
TP_GPT = dict(model="gpt2", over=dict(n_layer=2), batch=4, block=1024, mesh=(2, 2))
PP = dict(model="gpt2", over={}, batch=8, block=1024, stages=4, microbatches=8,
          runs=2)
MOE = dict(d=768, f=3072, experts=8, batch=8, block=1024, ep=4)
# Phase 14's Llama-700m check. The unsharded bf16 step is itself only
# 0.99954-0.99961 (cosine) from the fp32 step at 24 layers (NVIDIA H100
# 80GB HBM3, PERF.md §6), so phase 4's fixed 0.9998 does not fit it.
# The tp step's gradient distance from the bf16 step is held to that
# rounding instead: (1 - cos(tp, bf16)) / (1 - cos(bf16, fp32)) <= this,
# at each batch read. A sound tp step repeats the bf16 step's roundings
# but for the order of its fp32 sums, and read 0.600-0.633; with each
# rank's row-parallel partial rounded to bf16 (_bf16_partials) it read
# 0.861. Its distance to the fp32 step cannot tell them apart (0.963-1.019
# against 1.041).
TP_RATIO_LIMIT = 0.75
PAR_RANKS = 4
PAR_TIMEOUT_S = 480
GAINS = ("ln1_g", "ln2_g", "lnf_g")


def _flat(tensors: dict):
    import torch

    return torch.cat([tensors[n].float().reshape(-1) for n in sorted(tensors)])


def _exact_reference(cfg, params, tokens, targets):
    """The unsharded loss and flat gradient in fp32 compute (dense
    attention, each block checkpointed to bound its memory) at `params`:
    the function the bf16 steps approximate."""
    import dataclasses

    import torch

    from pccl_tpu_torch.parallel import train as train_lib

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    state = train_lib.make_train_state(0, cfg32, tokens.device, params={
        k: v.detach() for k, v in params.items()})
    loss = train_lib.build_loss_and_grad(cfg32, remat=True)(state, tokens,
                                                           targets).item()
    grads = _flat_grads(state)
    del state
    return loss, grads


def _bf16_partials(x, w, tp=None):
    """The fault phase 14's control plants in place of
    models/_common.row_parallel: each rank's partial product rounded to
    the compute dtype before the sum, where the port sums fp32 partials
    and rounds once."""
    from pccl_tpu_torch.parallel import mesh as mesh_lib

    if tp is None:
        return x @ w.to(x.dtype)
    return mesh_lib.reduce_from((x @ w.to(x.dtype)).float(), tp).to(x.dtype)


def _tp_readings(rank, cfg, mod, full, state, shards, lg, batches, exact):
    """The tp loss-and-grad on each batch from the same initial parameters,
    its gradient gathered to rank 0 and held there against the unsharded
    bf16 step of `full` (a one-process state) and, with `exact`, the fp32
    step; with `exact`, each batch once more with _bf16_partials planted
    as the model's row_parallel (the control). Returns the rows (on rank
    0; [] elsewhere) and the launches of the tp calls alone (the counts
    set to 0 just before each and read just after it)."""
    import torch

    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops import hashing

    rows, launches = [], {}
    runs = [(b, f) for b in batches for f in ((False, True) if exact else (False,))]
    ref = ex = None
    for (tok, tgt), fault in runs:
        if rank == 0 and not fault:
            ref = ex = None     # the previous batch's, freed first
            ref = _reference(cfg, full, tok, tgt)
            ex = _exact_reference(cfg, full.params, tok, tgt) if exact else None
        plain = mod.row_parallel
        mod.row_parallel = _bf16_partials if fault else plain
        fa.reset_launch_counts()
        hashing.reset_launch_counts()
        try:
            loss = lg(state, tok, tgt).item()
        finally:
            mod.row_parallel = plain
        for k, n in {**fa.launches, **hashing.launches}.items():
            launches[k] = launches.get(k, 0) + n
        grads = shards.gather({n: p.grad for n, p in state.params.items()}, dst=0)
        state.optimizer.zero_grad(set_to_none=True)
        if rank == 0:
            flat = _flat(grads)
            row = {"fault": fault, "loss": loss, "ref_loss": ref[0],
                   "cosine": cosine(flat, ref[1])}
            if exact:
                row.update(exact_loss=ex[0], cosine_exact=cosine(flat, ex[1]),
                           ref_cosine_exact=cosine(ref[1], ex[1]))
            rows.append(row)
            del flat
        del grads
        torch.cuda.empty_cache()
    return rows, launches


def _tp_part(rank: int, dev) -> dict:
    """Phase 14 on one rank: Llama-700m at (dp, tp) = (1, 4), its readings
    against the unsharded steps, then its train steps; then a GPT-2
    loss-and-grad at (2, 2)."""
    import torch
    import torch.distributed as dist

    from pccl_tpu_torch.models import gpt, llama
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.ops import hashing
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import train as train_lib

    out = {}
    for tag, spec, mod in (("llama", TP, llama), ("gpt", TP_GPT, gpt)):
        mesh = mesh_lib.make_mesh(("dp", "tp"), spec["mesh"], backend="gloo")
        B, T = spec["batch"], spec["block"]
        cfg = mod.named_config(spec["model"], block_size=T, **spec["over"])
        gen = torch.Generator().manual_seed(14)
        steps = spec.get("steps", 1)
        batches = [tuple(torch.randint(0, cfg.vocab_size, (B, T), generator=gen).to(dev)
                         for _ in range(2)) for _ in range(steps)]
        full = train_lib.make_train_state(0, cfg, dev) if rank == 0 else None
        state = train_lib.make_train_state(0, cfg, dev, mesh=mesh)
        shards = train_lib.tp_shards(cfg, mesh)
        lg = train_lib.build_loss_and_grad(cfg, attn_fn=fa.flash_attention, mesh=mesh)
        dist.barrier()
        readings, launches = _tp_readings(rank, cfg, mod, full, state, shards, lg,
                                          batches, exact=tag == "llama")
        full = None
        torch.cuda.empty_cache()
        dist.barrier()
        rows = []
        if tag == "llama":
            # the train steps: the counts of this part of the path alone
            fa.reset_launch_counts()
            hashing.reset_launch_counts()
            for tok, tgt in batches:
                torch.cuda.synchronize()
                mesh_lib.reset_collective_stats(timed=True)
                t0 = time.perf_counter()
                loss = lg(state, tok, tgt).item()
                train_lib.apply(state)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
                coll = dict(mesh_lib.collective_stats)
                rows.append({
                    "loss": loss, "step_s": step_s, "tok_s": B * T / step_s,
                    "coll_share": coll["seconds"] / step_s,
                    "coll_bytes": coll["bytes"], "coll_calls": coll["calls"],
                    "gains": " ".join(
                        f"{hashing.torch_simplehash_device(state.params[g].detach()):016x}"
                        for g in GAINS)})
            launches = {**fa.launches, **hashing.launches}
        out[tag] = {"rows": rows, "readings": readings, "launches": launches}
        del state, lg, batches
        torch.cuda.empty_cache()
    return out


def _pp_part(rank: int, dev) -> dict:
    """Phase 15 on one rank: GPT-2 124M through the GPipe pipeline, stage
    `rank` of 4."""
    import torch
    import torch.distributed as dist

    from pccl_tpu_torch.models import gpt
    from pccl_tpu_torch.models._common import gather_ce_loss
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import mesh as mesh_lib
    from pccl_tpu_torch.parallel import pipeline

    mesh = mesh_lib.make_mesh(("pp",), (PP["stages"],), backend="gloo")
    group, ring = mesh.group("pp"), mesh.ring("pp")
    B, T = PP["batch"], PP["block"]
    cfg = gpt.named_config(PP["model"], block_size=T, **PP["over"])
    full = {k: v.to(dev) for k, v in
            gpt.init_params(torch.Generator().manual_seed(0), cfg).items()}
    gen = torch.Generator().manual_seed(15)
    tok, tgt = (torch.randint(0, cfg.vocab_size, (B, T), generator=gen).to(dev)
                for _ in range(2))
    ref = None
    if rank == 0:
        params = {k: v.clone().requires_grad_(True) for k, v in full.items()}
        loss = gather_ce_loss(gpt.forward(params, tok, cfg,
                                          attn_fn=fa.flash_attention), tgt)
        loss.backward()
        ref = (loss.item(), _flat({k: p.grad for k, p in params.items()}))
        del params, loss
        torch.cuda.empty_cache()
    local = {**{k: full[k] for k in ("tok_emb", "lnf_g")},
             **pipeline.shard_layer_params({k: full[k] for k in gpt._LAYER_KEYS},
                                           mesh)}
    del full
    fwd = pipeline.build_pipelined_forward(cfg, mesh, microbatches=PP["microbatches"],
                                           attn_fn=fa.flash_attention)
    dist.barrier()
    fa.reset_launch_counts()
    runs = []
    for i in range(PP["runs"]):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in local.items()}
        torch.cuda.synchronize()
        hop_s, hop_b = ring.seconds, ring.bytes
        t0 = time.perf_counter()
        loss = gather_ce_loss(fwd(params, tok), tgt)
        loss.backward()
        torch.cuda.synchronize()
        row = {"loss": loss.item(), "step_s": time.perf_counter() - t0,
               "hop_s": ring.seconds - hop_s, "hop_bytes": ring.bytes - hop_b}
        if i == 0:
            grads = {k: params[k].grad for k in ("tok_emb", "lnf_g")}
            for k in gpt._LAYER_KEYS:
                got = mesh_lib.gather_to(params[k].grad, group, 0)
                if got is not None:
                    grads[k] = torch.cat(got)
            if ref is not None:
                row.update(ref_loss=ref[0], cosine=cosine(_flat(grads), ref[1]))
            del grads
        runs.append(row)
        del params, loss
    return {"rows": runs, "launches": dict(fa.launches)}


def _route_of(x2d, gate, C):
    """(expert, slot) of each token, -1 where dropped, int64 [n, 2]."""
    import torch

    from pccl_tpu_torch.ops import moe

    d, _ = moe._route(x2d, gate, C)
    flat = d.reshape(d.shape[0], -1)
    hit, idx = flat.sum(-1) > 0, flat.argmax(-1)
    return torch.stack([torch.where(hit, idx // C, -1),
                        torch.where(hit, idx % C, -1)], -1)


def _moe_part(rank: int, dev) -> dict:
    """Phase 16 on one rank: expert-parallel MoE at GPT-2 widths, E=8 over
    4 ranks."""
    import torch
    import torch.distributed as dist

    from pccl_tpu_torch.ops import moe
    from pccl_tpu_torch.parallel import mesh as mesh_lib

    S, E = MOE["ep"], MOE["experts"]
    mesh = mesh_lib.make_mesh(("ep",), (S,), backend="gloo")
    group = mesh.group("ep")
    gen = torch.Generator(device=dev).manual_seed(16)
    params = moe.init_moe_params(gen, MOE["d"], MOE["f"], E)
    x = torch.randn((MOE["batch"], MOE["block"], MOE["d"]), generator=gen, device=dev)
    b = MOE["batch"] // S
    xl = x[rank * b:(rank + 1) * b]
    n = b * MOE["block"]
    local = moe.shard_moe_params(params, mesh)
    res = {}
    dist.barrier()
    # cf = E: no drops; the routing and the output against the dense one
    torch.cuda.synchronize()
    mesh_lib.reset_collective_stats(timed=True)
    t0 = time.perf_counter()
    out = moe.moe_mlp_ep(xl, local, mesh, capacity_factor=float(E))
    torch.cuda.synchronize()
    res["ep_s"] = time.perf_counter() - t0
    res["a2a"] = dict(mesh_lib.collective_stats)
    route = _route_of(xl.reshape(n, -1), params["gate"], moe.capacity_ep(n, float(E), E))
    routes = mesh_lib.gather_to(route, group, 0)
    outs = mesh_lib.gather_to(out, group, 0)
    if rank == 0:
        dense = moe.moe_mlp_dense(x, params, capacity_factor=float(E))
        dense_route = _route_of(x.reshape(S * n, -1), params["gate"], S * n)
        # dense slots count over all shards: shard r's slot of expert e
        # follows the tokens shards < r sent to e
        counts = torch.stack([torch.bincount(r[:, 0], minlength=E) for r in routes])
        offset = torch.cumsum(counts, 0) - counts
        want = torch.cat([torch.stack([r[:, 0], r[:, 1] + offset[i][r[:, 0]]], -1)
                          for i, r in enumerate(routes)])
        got = torch.cat(outs)
        res.update(route_equal=bool(torch.equal(want, dense_route)),
                   dropped_dense=int((dense_route[:, 0] < 0).sum()),
                   max_abs_err=(got.float() - dense.float()).abs().max().item())
        del dense, dense_route, got
    del outs, routes, out
    torch.cuda.empty_cache()
    # cf = 1: drops; sum(out²)'s gradient reaches the gate and w_in
    params_g = {k: v.detach().clone().requires_grad_(True) for k, v in local.items()}
    mesh_lib.reset_collective_stats(timed=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = moe.moe_mlp_ep(xl, params_g, mesh, capacity_factor=1.0)
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    route = _route_of(xl.reshape(n, -1), params["gate"], moe.capacity_ep(n, 1.0, E))
    res.update(cf1_s=time.perf_counter() - t0, cf1_a2a=dict(mesh_lib.collective_stats),
               cf1_finite=bool(torch.isfinite(out).all()),
               cf1_dropped=(route[:, 0] < 0).float().mean().item(),
               gate_grad=params_g["gate"].grad.abs().sum().item(),
               w_in_grad=params_g["w_in"].grad.abs().sum().item())
    return res


def par_rank(rank: int, port: int) -> None:
    """One of phases 14-16's four ranks (`python -m chip_smoke --par-rank R
    --par-port P`): all share the card over gloo and run tp, then the
    pipeline, then MoE; writes its figures to LOG_DIR/par<R>.json."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=PAR_RANKS,
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    out = {"rank": rank}
    try:
        for name, part in (("tp", _tp_part), ("pp", _pp_part), ("moe", _moe_part)):
            dist.barrier()
            t0 = time.perf_counter()
            out[name] = part(rank, dev)
            out[name]["phase_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    finally:
        (LOG_DIR / f"par{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def run_ranks(tag: str, flag: str, n: int, timeout: float) -> list:
    """n rank processes `python -m chip_smoke --<flag>-rank R --<flag>-port
    P` on the card, logging to LOG_DIR/<tag>R.log; each rank's
    LOG_DIR/<tag>R.json, once all have ended. A rank that fails stops
    them all (the others would wait in gloo)."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    port, = free_ports(1)
    names = [f"{tag}{r}.log" for r in range(n)]
    for r in range(n):
        (LOG_DIR / f"{tag}{r}.json").unlink(missing_ok=True)
    procs, files = [], []
    try:
        for r in range(n):
            spawn(procs, files, env, names[r],
                  ["chip_smoke", f"--{flag}-rank", str(r), f"--{flag}-port", str(port)])
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                raise SmokeError(f"{tag} ranks still running after {timeout} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            stop(p)
        for f in files:
            f.close()
        dump_logs(names[:len(procs)])
    res = []
    for r, p in enumerate(procs):
        path = LOG_DIR / f"{tag}{r}.json"
        if p.returncode != 0 or not path.exists():
            raise SmokeError(f"{tag} rank {r} exited {p.returncode}")
        res.append(json.loads(path.read_text()))
    return res


def phase_par() -> list:
    """Phases 14-16's four ranks (par_rank); returns their figures."""
    res = run_ranks("par", "par", PAR_RANKS, PAR_TIMEOUT_S)
    for name in ("tp", "pp", "moe"):
        log(f"phase {name} (in the ranks): "
            f"{_each('{:.1f}', [r[name]['phase_s'] for r in res])} s")
    return res


def _agree(tag: str, row: dict) -> None:
    """Phase 4's limits against the unsharded bf16 step: loss gap <= 1e-3
    nats and gradient cosine >= 0.9998."""
    gap = abs(row["loss"] - row["ref_loss"])
    log(f"  {tag} vs its unsharded reference: loss {row['loss']:.6f} vs "
        f"{row['ref_loss']:.6f} (gap {gap:.2e}), gradient cosine {row['cosine']:.7f}")
    if not (math.isfinite(row["loss"]) and gap <= 1e-3 and row["cosine"] >= 0.9998):
        raise SmokeError(f"{tag} disagrees with its unsharded reference")


def _ratio(tag: str, row: dict) -> tuple:
    """Phase 14's Llama-700m reading, logged with the losses: the tp step's
    gradient distance (1 - cosine) from the fp32 step and from the bf16
    step, each over the bf16 step's distance from the fp32 step."""
    base = 1 - row["ref_cosine_exact"]
    to_exact, to_bf16 = (1 - row["cosine_exact"]) / base, (1 - row["cosine"]) / base
    log(f"  {tag}: loss {row['loss']:.6f}, the bf16 step's {row['ref_loss']:.6f} "
        f"(gap {abs(row['loss'] - row['ref_loss']):.2e}), the fp32 step's "
        f"{row['exact_loss']:.6f}; gradient cosine with the bf16 step "
        f"{row['cosine']:.7f}, with the fp32 step {row['cosine_exact']:.7f} (the "
        f"bf16 step's {row['ref_cosine_exact']:.7f}); distance ratios to fp32 "
        f"{to_exact:.4f}, to bf16 {to_bf16:.4f}")
    return to_exact, to_bf16


def check_tp(res: list) -> dict:
    """Phase 14's checks; returns its launch totals."""
    from pccl_tpu_torch.models import gpt, llama

    L = llama.named_config(TP["model"], **TP["over"]).n_layer
    for i in range(TP["steps"]):
        rows = [r["tp"]["llama"]["rows"][i] for r in res]
        if len({row["loss"] for row in rows}) != 1:
            raise SmokeError(f"14: step {i}: losses differ across the tp ranks: "
                             f"{[row['loss'] for row in rows]}")
        if len({row["gains"] for row in rows}) != 1:
            raise SmokeError(f"14: step {i}: H1 digests of the gains differ across "
                             f"the tp ranks")
        log(f"  tp step {i}: loss {rows[0]['loss']:.5f}, tok/s (global tokens) "
            f"{_each('{:.0f}', [x['tok_s'] for x in rows])}, step s "
            f"{_each('{:.3f}', [x['step_s'] for x in rows])}, tp collective share "
            f"{_each('{:.3f}', [x['coll_share'] for x in rows])} ({rows[0]['coll_calls']} "
            f"calls, {rows[0]['coll_bytes']} bytes a rank); gains' H1 digests equal")
    # Llama-700m: two bf16 computations of one step differ by their
    # roundings, at 24 layers by more than phase 4's cosine, so the tp
    # step is held to the fp32 step, at every batch read, by its distance
    # ratio; the control, with the fault _bf16_partials planted, must read
    # above the limit
    for i, row in enumerate(res[0]["tp"]["llama"]["readings"]):
        tag = (f"14: Llama-700m at tp=4, batch {i // 2}"
               + (" with bf16 partials planted (control)" if row["fault"] else ""))
        _, ratio = _ratio(tag, row)
        if row["fault"]:
            if not ratio > TP_RATIO_LIMIT:
                raise SmokeError(f"{tag}: distance ratio {ratio:.4f} within "
                                 f"{TP_RATIO_LIMIT}: the check cannot see the fault")
        elif not (math.isfinite(row["loss"]) and abs(row["loss"] - row["ref_loss"]) <= 1e-3
                  and ratio <= TP_RATIO_LIMIT):
            raise SmokeError(f"{tag}: disagrees with the unsharded steps")
    _agree("14: GPT-2 2 layers at (dp, tp) = (2, 2)",
           res[0]["tp"]["gpt"]["readings"][0])
    gl = gpt.named_config(TP_GPT["model"], **TP_GPT["over"]).n_layer
    for r in res:
        for tag, want in (("llama", TP["steps"] * L), ("gpt", gl)):
            got = [r["tp"][tag]["launches"][k] for k in FLASH]
            if got != [want] * 3:
                raise SmokeError(f"14: rank {r['rank']} launched K1-K3 {got} at "
                                 f"{tag}, {want} each expected")
    totals = {k: sum(r["tp"][t]["launches"][k] for r in res for t in ("llama", "gpt"))
              for k in (*FLASH, "simplehash_tpu")}
    log(f"tp path: 4 ranks on one card over gloo (Llama-700m at tp=4, 3 q heads "
        f"over 1 kv head a rank), launches {totals}")
    return {"launches": totals}


def check_pp(res: list) -> dict:
    """Phase 15's checks; returns its launch totals."""
    from pccl_tpu_torch.models import gpt

    S, M = PP["stages"], PP["microbatches"]
    L = gpt.named_config(PP["model"], **PP["over"]).n_layer
    for i in range(PP["runs"]):
        rows = [r["pp"]["rows"][i] for r in res]
        if len({row["loss"] for row in rows}) != 1:
            raise SmokeError(f"15: run {i}: losses differ across the stages")
        log(f"  pp run {i}: loss {rows[0]['loss']:.5f}, step s "
            f"{_each('{:.3f}', [x['step_s'] for x in rows])}, hop s "
            f"{_each('{:.3f}', [x['hop_s'] for x in rows])}, hop bytes a stage "
            f"{rows[0]['hop_bytes']}, bubble share (S-1)/(M+S-1) = "
            f"{(S - 1) / (M + S - 1):.3f}")
    _agree("15: GPT-2 124M pipelined over 4 stages", res[0]["pp"]["rows"][0])
    per_stage = L // S * (M + S - 1) * PP["runs"]
    for r in res:
        got = [r["pp"]["launches"][k] for k in FLASH]
        if got != [per_stage] * 3:
            raise SmokeError(f"15: stage {r['rank']} launched K1-K3 {got}, "
                             f"{per_stage} each expected")
    totals = {k: sum(r["pp"]["launches"][k] for r in res) for k in FLASH}
    log(f"pipeline path: launches {totals}")
    return {"launches": totals}


def check_moe(res: list) -> None:
    """Phase 16's checks."""
    r0 = res[0]["moe"]
    log(f"  moe cf=E: ep s {_each('{:.3f}', [r['moe']['ep_s'] for r in res])}, "
        f"all_to_all {res[0]['moe']['a2a']['calls']} calls "
        f"{_each('{:.3f}', [r['moe']['a2a']['seconds'] for r in res])} s, "
        f"{res[0]['moe']['a2a']['bytes']} bytes a rank; routing equal to dense: "
        f"{r0['route_equal']} (dense dropped {r0['dropped_dense']}); max |ep - dense| "
        f"{r0['max_abs_err']:.3e}")
    if not r0["route_equal"] or r0["dropped_dense"] or not r0["max_abs_err"] <= 2e-2:
        raise SmokeError("16: expert-parallel MoE disagrees with the dense one")
    for r in res:
        m = r["moe"]
        log(f"  moe cf=1 rank {r['rank']}: dropped share {m['cf1_dropped']:.4f}, "
            f"fwd+bwd s {m['cf1_s']:.3f}, collectives {m['cf1_a2a']['calls']} calls "
            f"{m['cf1_a2a']['seconds']:.3f} s {m['cf1_a2a']['bytes']} bytes, "
            f"|grad| gate {m['gate_grad']:.4g} w_in {m['w_in_grad']:.4g}")
        if not (m["cf1_finite"] and m["gate_grad"] > 0 and m["w_in_grad"] > 0):
            raise SmokeError(f"16: rank {r['rank']}: cf=1 output or gradient wrong")


# ------------------------------------------------------------------ phase 17

# 16 steps: from random init at GPT-2 width AdamW moves the loss up and
# down for the first ~10 steps (step 8's, 11.1369, is still above step 0's,
# 10.9781; step 11's 10.7617), and the example's own descent check needs
# the last step's below the first's with room to spare
DDP_TP = dict(model="gpt2", block=1024, batch=8, steps=16, tp=2)
DDP_TP_LINE = re.compile(
    r"^step (\d+) loss (\S+) world (\d+) revision \d+ tok_s (\S+) ring_s (\S+) "
    r"sync_s (\S+) gather_s (\S+) rank_launches (\S+) tx (\d+) rx (\d+) "
    r"launches (\d+) (\d+) (\d+) (\d+) digest (\w+)$", re.M)


def phase_ddp_tp() -> dict:
    """Two `train_ddp --tp 2` peers (each a process and the rank it
    spawns) and a master; returns per-kernel launch totals."""
    peers = run_peer_pair(
        [f"ddp_tp{rank}.log" for rank in range(2)],
        "pccl_tpu_torch.examples.train_ddp",
        ["--model", DDP_TP["model"], "--block", str(DDP_TP["block"]),
         "--batch", str(DDP_TP["batch"]), "--steps", str(DDP_TP["steps"]),
         "--tp", str(DDP_TP["tp"]), "--device", "cuda", "--attn", "flash"],
        env_extra={"PCCLT_SS_HASH": "simple-tpu"})
    keys = ("loss", "world", "tok_s", "ring_s", "sync_s", "gather_s", "ranks", "tx",
            "rx", *FLASH, "simplehash_tpu", "digest")
    rows = []
    for rank, (code, text) in enumerate(peers):
        if code != 0 or "FINAL" not in text:
            raise SmokeError(f"17: tp peer {rank} exited {code}")
        r = {int(m.group(1)): dict(zip(keys, m.groups()[1:]))
             for m in DDP_TP_LINE.finditer(text)}
        if sorted(r) != list(range(DDP_TP["steps"])):
            raise SmokeError(f"17: tp peer {rank} logged steps {sorted(r)}")
        rows.append(r)
    for s in range(DDP_TP["steps"]):
        a, b = rows[0][s], rows[1][s]
        if a["digest"] != b["digest"] or a["world"] != "2" or b["world"] != "2":
            raise SmokeError(f"17: step {s}: digests {a['digest']} {b['digest']}, "
                             f"worlds {a['world']} {b['world']}")
        if s > 0 and any((r["tx"], r["rx"]) != ("0", "0") for r in (a, b)):
            raise SmokeError(f"17: step {s}: a sync moved bytes")
        log(f"  ddp tp step {s}: loss {a['loss']} / {b['loss']}, ring_s {a['ring_s']} / "
            f"{b['ring_s']}, sync_s {a['sync_s']} / {b['sync_s']}, gather_s "
            f"{a['gather_s']} / {b['gather_s']}, tok_s {a['tok_s']} / {b['tok_s']}")
    texts = [t for _, t in peers]
    finals = {re.search(r"params_blake2b=(\w+)", t).group(1) for t in texts}
    if len(finals) != 1:
        raise SmokeError(f"17: final parameters differ: {sorted(finals)}")
    # K1-K3 on every rank of each peer (rank 0 gathers the others' counts
    # each step), H1 on rank 0, which hashes the gathered state
    totals = {name: 0 for name, *_ in KERNELS}
    for peer, r in enumerate(rows):
        for s, row in r.items():
            ranks = [[int(n) for n in x.split(",")] for x in row["ranks"].split("/")]
            if len(ranks) != DDP_TP["tp"] or any(x != ranks[0] or min(x) <= 0
                                                 for x in ranks):
                raise SmokeError(f"17: peer {peer} step {s}: K1-K3 launches by rank "
                                 f"{ranks}")
            for rank_counts in ranks:
                for name, n in zip(FLASH, rank_counts):
                    totals[name] += n
            totals["simplehash_tpu"] += int(row["simplehash_tpu"])
        if not any(int(row["simplehash_tpu"]) for row in r.values()):
            raise SmokeError(f"17: tp peer {peer}: simplehash_tpu never launched")
    log(f"ddp tp path: 2 peers of tp=2, digests equal at every step, 0-byte syncs, "
        f"params_blake2b {finals.pop()}; K1-K3 on every rank; launches {totals}")
    return {"launches": totals}


# ------------------------------------------------------------------ phase 18

# 18a: Llama-700m sync DiLoCo, a peer of 2 ranks beside one of 1; 18b:
# GPT-2 async DiLoCo, two peers of 2 ranks; 18c: the grid with one cell of
# each group at 2 ranks. Too few steps to show learning from random init:
# the checks are the ring's invariants, and in 18a the losses of two
# peers that read the same batches (same_data: both on data shard 0)
MESH_SYNC = dict(family="llama", model="700m", block=2048, batch=2, inner_steps=2,
                 outer_steps=2, ranks=(2, 1), same_data=True)
# 18b and 18c at 2 outer steps (3 and 4 until phase 21 came): the second
# holds every check the later ones did (the async reduce of step 0 lands
# in it; its grid sync is the first that must move 0 bytes)
MESH_ASYNC = dict(family="gpt", model="gpt2", block=1024, batch=8, inner_steps=4,
                  outer_steps=2, ranks=(2, 2))
MESH_GRID = dict(GRID, outer_steps=2, ranks=[2, 1], descent=False)
# The digests cannot tell a sound 2-rank peer from one whose scatter writes
# the wrong blocks or whose tp step computes another function: every peer
# adds one averaged pseudo-gradient to one outer vector. On the same
# batches and from the same outer parameters (after the first outer
# step's scatter), the 2-rank peer's loss must follow the 1-rank peer's,
# to within what the tp split's bf16 sums move it over the inner steps.
# Readings on an H100 80GB HBM3 at 700 W (PERF.md §6), deterministic across runs:
# sound 0.0081; a peer whose rank 1 keeps its stale blocks after the
# scatter 0.1247, one whose tp ranks trade blocks 0.0453. The first outer
# step's gap (0.098, sound) is logged, not held: it starts from the
# seed, and AdamW's first update, ±lr on every element whatever the
# gradient's size, turns the bf16 noise in the signs of small gradients
# into whole steps
MESH_LOSS_GAP = 0.02
MESH_SUFFIX = r"(?: gather_s (\S+) scatter_s (\S+) rank_launches (\S+))?$"
MESH_LINE = {
    "sync": re.compile(r"^outer (\d+) loss (\S+) world (\d+) revision (\d+) "
                       r"tok_s (\S+) outer_s (\S+)() launches (\d+) (\d+) (\d+) "
                       r"digest (\w+)" + MESH_SUFFIX, re.M),
    "async": re.compile(r"^outer (\d+) loss (\S+) world (\d+) revision (\d+) "
                        r"tok_s (\S+) outer_s (\S+) join_s (\S+) launches (\d+) "
                        r"(\d+) (\d+) digest (\w+)" + MESH_SUFFIX, re.M),
}
MESH_KEYS = ("step", "loss", "world", "revision", "tok_s", "outer_s", "join_s",
             *FLASH, "digest", "gather_s", "scatter_s", "ranks")


def check_rank_launches(what: str, field: str, n: int) -> None:
    """Every one of a peer's n ranks launched K1-K3 (its `rank_launches`
    field, a,b,c/a,b,c/...; none for one rank), and all on the card."""
    if n == 1:
        if field:
            raise SmokeError(f"{what}: a one-rank peer printed rank launches")
        return
    counts = [[int(x) for x in r.split(",")] for r in (field or "").split("/")
              if r]
    if len(counts) != n or any(min(c) <= 0 for c in counts):
        raise SmokeError(f"{what}: K1-K3 launches by rank {counts} (want {n} "
                         f"ranks, each launching every kernel)")


def check_mesh_devices(what: str, text: str, n: int) -> None:
    """A peer of n > 1 ranks logged each rank's device: all on a card."""
    if n == 1:
        return
    m = re.search(r"^mesh dp (\d+) tp (\d+) devices (.+)$", text, re.M)
    if m is None or int(m.group(1)) * int(m.group(2)) != n:
        raise SmokeError(f"{what}: no mesh line for {n} ranks")
    devices = m.group(3).split()
    if len(devices) != n or any(not d.startswith("cuda") for d in devices):
        raise SmokeError(f"{what}: a rank is not on the card: {devices}")


def phase_mesh_diloco(kind: str, spec: dict, tag: str) -> dict:
    """Two DiLoCo peers (sync_diloco or async_diloco) of spec["ranks"]
    ranks each, and a master; returns the launch totals. Digests must be
    equal at every outer step (and after an async finish), every rank of
    each peer must launch K1-K3 at every step, on the card."""
    module = f"pccl_tpu_torch.examples.{kind}_diloco"
    names = [f"mesh{tag}{i}.log" for i in range(2)]
    peers = run_peer_pair(
        names, module,
        ["--family", spec["family"], "--model", spec["model"],
         "--block", str(spec["block"]), "--batch", str(spec["batch"]),
         "--inner-steps", str(spec["inner_steps"]),
         "--outer-steps", str(spec["outer_steps"]), "--device", "cuda",
         "--attn", "flash", "--no-descent-check"],
        # a second --data-shard overrides run_peer_pair's own
        per_rank=lambda rank: ["--ranks", str(spec["ranks"][rank])] + (
            ["--data-shard", "0"] if spec.get("same_data") else []))
    rows = []
    for i, (code, text) in enumerate(peers):
        n = spec["ranks"][i]
        if code != 0 or "FINAL" not in text:
            raise SmokeError(f"{tag}: peer {i} ({n} ranks) exited {code}")
        check_mesh_devices(f"{tag}: peer {i}", text, n)
        r = [dict(zip(MESH_KEYS, m.groups()))
             for m in MESH_LINE[kind].finditer(text)]
        if len(r) != spec["outer_steps"]:
            raise SmokeError(f"{tag}: peer {i} logged {len(r)} outer steps")
        rows.append(r)
    totals = {name: 0 for name in FLASH}
    for i, r in enumerate(rows):
        n = spec["ranks"][i]
        for step, row in enumerate(r):
            what = f"{tag}: peer {i} outer step {step}"
            if row["world"] != "2" or not math.isfinite(float(row["loss"])):
                raise SmokeError(f"{what}: world {row['world']}, loss {row['loss']}")
            if (row["gather_s"] is None) != (n == 1):
                raise SmokeError(f"{what}: gather_s/scatter_s for {n} ranks")
            check_rank_launches(what, row["ranks"], n)
            for name in FLASH:
                if int(row[name]) <= 0:
                    raise SmokeError(f"{what}: {name} never launched")
                totals[name] += int(row[name])
    for step in range(spec["outer_steps"]):
        digests = {r[step]["digest"] for r in rows}
        if len(digests) != 1:
            raise SmokeError(f"{tag}: outer step {step}: digests differ across "
                             f"peers of {spec['ranks']} ranks: {sorted(digests)}")
    gaps = []
    if spec.get("same_data"):
        gaps = [abs(float(a["loss"]) - float(b["loss"])) for a, b in zip(*rows)]
        log(f"  {tag}: |loss gap| of the peers of {spec['ranks']} ranks on the "
            f"same batches: {' '.join(f'{g:.4f}' for g in gaps)} (limit "
            f"{MESH_LOSS_GAP})")
        if max(gaps[1:]) > MESH_LOSS_GAP:
            raise SmokeError(f"{tag}: the peers' losses on the same batches "
                             f"differ by {gaps}, above {MESH_LOSS_GAP} after "
                             f"the first outer step")
    if kind == "async":
        finals = {re.search(r"FINAL .*revision=(\d+) digest=(\w+)", t).groups()
                  for _, t in peers}
        if len(finals) != 1:
            raise SmokeError(f"{tag}: FINAL revisions and digests differ: {finals}")
    for i, r in enumerate(rows):
        peak = re.search(r"(?:peak_alloc_mib=(\d+) )?peak_rss_mib=(\d+)", peers[i][1])
        log(f"  {tag} peer {i} ({spec['ranks'][i]} ranks): loss "
            f"{' '.join(x['loss'] for x in r)}; tok_s {' '.join(x['tok_s'] for x in r)}; "
            f"outer_s {' '.join(x['outer_s'] for x in r)}; "
            + (f"join_s {' '.join(x['join_s'] for x in r)}; " if kind == "async" else "")
            + (f"gather_s {' '.join(x['gather_s'] for x in r)}; scatter_s "
               f"{' '.join(x['scatter_s'] for x in r)}; launches by rank "
               f"{' '.join(x['ranks'] for x in r)}; " if r[0]["gather_s"] else
               f"launches {' '.join(x['flash_fwd'] for x in r)} (K1); ")
            + f"peak allocated MiB {peak.group(1)} (rank 0), host RSS MiB "
              f"{peak.group(2)}")
    log(f"{tag}: {kind} DiLoCo, peers of {spec['ranks']} ranks at "
        f"{spec['model']}, world 2, digests equal at every outer step; K1-K3 on "
        f"every rank; launches {totals}")
    return {"launches": totals, "rows": rows, "gaps": gaps}


def phase_mesh() -> dict:
    """Phase 18: 18a, 18b and 18c; returns their launch totals summed."""
    parts = [timed("18a", lambda: phase_mesh_diloco("sync", MESH_SYNC, "18a")),
             timed("18b", lambda: phase_mesh_diloco("async", MESH_ASYNC, "18b")),
             timed("18c", lambda: phase_grid("cuda", MESH_GRID, "18c"))]
    return {"launches": {name: sum(p["launches"][name] for p in parts)
                         for name in FLASH}}


# ------------------------------------------------------------------ phase 19

# the port's examples at their default command line (GPT `nano`, Dh 16)
# and at Llama `tiny` (Dh 32, GQA): log name, module, arguments, the line
# of an outer step, the index of its K1 launch count in the line's groups,
# and the outer steps its defaults run
EXAMPLES = [
    ("example_sync_nano.log", "pccl_tpu_torch.examples.sync_diloco",
     ["--solo"], LINE, 6, 8),
    ("example_async_tiny.log", "pccl_tpu_torch.examples.async_diloco",
     ["--solo", "--family", "llama", "--model", "tiny"], ASYNC_LINE, 7, 10),
]


def phase_examples() -> dict:
    """Each example of EXAMPLES in a process of its own, both at once, on
    the card with no device or attention flag: each must exit 0 (the loss
    fell: the examples' own descent check), print `world 1` and K1-K3
    launches at every outer step, and FINAL. Returns the launch totals."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs, files = [], []
    try:
        for name, module, args, *_ in EXAMPLES:
            spawn(procs, files, env, name, [module, *args])
        wait_all(procs, time.time() + PEER_TIMEOUT_S)
    finally:
        for p in procs:
            stop(p)
        for f in files:
            f.close()
        dump_logs([e[0] for e in EXAMPLES])
    totals = {name: 0 for name in FLASH}
    for (name, module, args, line, k1, outer_steps), proc in zip(EXAMPLES, procs):
        text = (LOG_DIR / name).read_text()
        if proc.returncode != 0:
            raise SmokeError(f"19: {module} exited {proc.returncode}")
        rows = [m.groups() for m in line.finditer(text)]
        if len(rows) != outer_steps or "FINAL" not in text:
            raise SmokeError(f"19: {module}: {len(rows)} outer lines, not "
                             f"{outer_steps}, or no FINAL")
        for row in rows:
            if int(row[2]) != 1 or not math.isfinite(float(row[1])):
                raise SmokeError(f"19: {module}: world {row[2]}, loss {row[1]}")
            for kernel, n in zip(FLASH, row[k1:k1 + 3]):
                if int(n) <= 0:
                    raise SmokeError(f"19: {module}: {kernel} not launched at "
                                     f"outer step {row[0]}")
                totals[kernel] += int(n)
        log(f"19: {module} {' '.join(args)}: "
            f"{outer_steps} outer steps at world 1, loss {rows[0][1]} -> "
            f"{rows[-1][1]}, K1-K3 at every step")
    log(f"19: launches {totals}")
    return {"launches": totals}


# ------------------------------------------------------------------ phase 20

# the soak's shared-state lane on the card: the JAX orchestrator's defaults
# (die-prob 0.002, chunk 256 KiB, 250 Mbit/s pacing) with a 4 MiB state,
# and no seeder-edge degrade. Entries hashed on the card carry no chunk
# leaves, so their syncs ride the legacy transport, whose serves have no
# watchdog: the degrade's gate could never trip here (PERF.md, section 6)
SOAK = dict(duration=45, peers=3, sync_churn=1048576, stall_seconds=60,
            degrade_mbit=0)
SOAK_TIMEOUT_S = 240
SOAK_SUMMARY = re.compile(r"^SYNC SUMMARY: (.*)$", re.M)
SOAK_PASSED = re.compile(r"^SOAK PASSED: (\d+) heartbeat steps, (\d+) relaunches",
                         re.M)


def phase_soak() -> dict:
    """The fault-tolerance soak with CUDA shared states: the port's
    orchestrator and its master and peers on the card, each peer's state a
    TensorInfo.from_torch_device entry hashed by H1 on every sync. It must
    print SOAK PASSED with a relaunch or more, and a SYNC SUMMARY with no
    wrong adoption, no failed sync (on live peers and over every peer
    life) and H1 launches. Returns H1's launches (the peers' last STATS
    lines, summed by the orchestrator)."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    master_port, = free_ports(1)
    base, = free_ports(1, offsets=tuple(16 * i + o for i in range(SOAK["peers"])
                                        for o in (0, 4, 8)))
    cmd = [sys.executable, "-m", "pccl_tpu_torch.examples.stress.stress_orchestrator",
           "--device", "cuda", "--duration", str(SOAK["duration"]),
           "--peers", str(SOAK["peers"]), "--sync-churn", str(SOAK["sync_churn"]),
           "--stall-seconds", str(SOAK["stall_seconds"]),
           "--sync-degrade-mbit", str(SOAK["degrade_mbit"]),
           "--master-port", str(master_port), "--base-port", str(base)]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    try:
        r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=SOAK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeError(f"20: the soak ran past {SOAK_TIMEOUT_S} s") from None
    (LOG_DIR / "soak.log").write_text(r.stdout + r.stderr)
    dump_logs(["soak.log"])
    passed = SOAK_PASSED.search(r.stdout)
    summary = SOAK_SUMMARY.search(r.stdout)
    if r.returncode != 0 or passed is None or summary is None:
        raise SmokeError(f"20: the soak exited {r.returncode} without SOAK PASSED "
                         f"and a SYNC SUMMARY")
    fields = {k: int(v) for k, v in (kv.split("=") for kv in summary.group(1).split())}
    steps, relaunches = int(passed.group(1)), int(passed.group(2))
    if relaunches < 1:
        raise SmokeError("20: no peer was relaunched")
    bad = {k: fields[k] for k in ("wrong", "aborted", "syncs_failed") if fields[k]}
    if bad or fields["h1_launches"] < 1:
        raise SmokeError(f"20: SYNC SUMMARY {fields}")
    log(f"20: soak on the card: {steps} heartbeat steps, {relaunches} relaunches; "
        f"legacy_syncs {fields['legacy_syncs']}, chunks_fetched "
        f"{fields['chunks_fetched']}, syncs_ok {fields['syncs_ok']}, wrong 0, "
        f"failed 0; H1 launches {fields['h1_launches']}")
    return {"launches": {"simplehash_tpu": fields["h1_launches"]}, "steps": steps,
            "relaunches": relaunches, "summary": fields}


def phases_19_20() -> tuple:
    """Phases 19 and 20 at once (the examples are two small solo processes
    beside the soak); returns their results."""
    with ThreadPoolExecutor(2) as ex:
        examples = ex.submit(timed, "examples", phase_examples)
        soak = ex.submit(timed, "soak", phase_soak)
        return examples.result(), soak.result()


# ------------------------------------------------------------------ phase 21

# model_bench at its defaults (DEFAULT_SHAPES: gpt2-medium and Llama-700m,
# no remat) for 3 windows of 4 steps (5 of 8 when run alone), and bench.py's
# longest leg: Llama-700m at T=32768, batch 1, remat, the chunked CE
BENCH_MODEL = dict(windows=3, steps_per_window=4)
BENCH_LONG = dict(seq=32768, batch=1, remat=1, loss_chunk=2048, windows=2,
                  steps_per_window=2)
BENCH_MFU_MAX = 1.05
BENCH_TIMEOUT_S = 300
# a native_bench peer at `rank` listens at base + 4 rank, + 1000 and + 2000
BENCH_OFFSETS = (0, 4, 1000, 1004, 2000, 2004)


def bench_part(name: str) -> None:
    """One DiLoCo part of phase 21 in a process of its own (`python -m
    chip_smoke --bench-part NAME`, ports chosen here): prints its result
    as one JSON line."""
    from pccl_tpu_torch.comm import native_bench as nb

    if name == "diloco_outer":
        mport, = free_ports(1)
        base, = free_ports(1, offsets=BENCH_OFFSETS)
        med, phases, ranks = nb.run_diloco_outer_bench(
            params_n=100_000_000, master_port=mport, base=base, details=True)
        out = {"outer_step_s": med, "phases": phases, "ranks": ranks,
               "closed_form": nb.diloco_closed_form(2, ranks[0]["steps"])}
    elif name == "diloco_cuda":
        out = nb.run_diloco_cuda_bench(
            iters=2, mports=tuple(free_ports(2)),
            bases=tuple(free_ports(2, offsets=BENCH_OFFSETS)))
    elif name == "async_diloco_cuda":
        out = nb.run_async_diloco_cuda_bench(
            iters=2, inner_s=1.0, mports=tuple(free_ports(2)),
            bases=tuple(free_ports(2, offsets=BENCH_OFFSETS)))
    else:
        raise SmokeError(f"unknown bench part {name!r}")
    print(json.dumps(out), flush=True)


def run_json(tag: str, cmd: list) -> dict:
    """`python -m *cmd` through the relay (its peers' RSS stays their own),
    in a process of its own; its last stdout line, logged as JSON under
    `tag`. Its output lands in LOG_DIR/bench_<tag>.log."""
    from pccl_tpu_torch.utils.rss import relay_argv

    LOG_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(relay_argv([sys.executable, "-m", *cmd]), cwd=REPO,
                           env=dict(os.environ, PYTHONUNBUFFERED="1"),
                           capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeError(f"21 {tag}: ran past {BENCH_TIMEOUT_S} s") from None
    (LOG_DIR / f"bench_{tag}.log").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        dump_logs([f"bench_{tag}.log"])
        raise SmokeError(f"21 {tag}: {' '.join(cmd)} exited {r.returncode}")
    line = r.stdout.strip().splitlines()[-1]
    log(f"21 {tag} ({time.perf_counter() - t0:.1f} s): {line}")
    return json.loads(line)


def _model_checks(tag: str, res: dict, layers: int, steps: int, remat: bool) -> None:
    """K1-K3 launched as the remat mode gives (phase 8's counts: K1 L a step
    without remat, 2L with; K2 and K3 L), finite losses."""
    want = {"flash_fwd": (2 if remat else 1) * layers * steps,
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
    if res["launches"] != want:
        raise SmokeError(f"21 {tag}: launches {res['launches']}, not {want}")
    if not all(math.isfinite(res[k]) for k in ("loss_first", "loss_last")):
        raise SmokeError(f"21 {tag}: losses {res['loss_first']}, {res['loss_last']}")


def phase_bench() -> dict:
    """The port's bench modules on the card, each part in a process of its
    own: model_bench for each family at its defaults (K1-K3 at every layer
    of every step, a falling loss on the repeated batch, 0 < MFU <= 1.05),
    model_bench at Llama-700m T=32768 under remat with the chunked CE
    (finite losses), hash_bench (H1 digests equal to the staging digests,
    as it asserts), and native_bench's DiLoCo legs with their outer state
    on the card: the outer step at 100M elements (digests equal, values at
    the synthetic step's closed form), the paced sync leg at 1 and 4
    windows and the async leg beside its sync twin; the T=32768 leg,
    hash_bench and these three at once. Returns the launch totals."""
    from pccl_tpu_torch.benchmarks import model_bench
    from pccl_tpu_torch.models import gpt, llama

    totals = {name: 0 for name in FLASH}
    steps = BENCH_MODEL["windows"] * BENCH_MODEL["steps_per_window"]
    for fam, mod in (("gpt", gpt), ("llama", llama)):
        shape = model_bench.DEFAULT_SHAPES[fam]
        res = run_json(fam, ["pccl_tpu_torch.benchmarks.model_bench", fam,
                             *(f"{k}={v}" for k, v in BENCH_MODEL.items())])
        _model_checks(fam, res, mod.named_config(shape["preset"]).n_layer, steps,
                      remat=False)
        if not res["loss_last"] < res["loss_first"]:
            raise SmokeError(f"21 {fam}: the loss did not fall on the repeated "
                             f"batch: {res['loss_first']} -> {res['loss_last']}")
        if not 0 < res["mfu"] <= BENCH_MFU_MAX:
            raise SmokeError(f"21 {fam}: MFU {res['mfu']}")
        log(f"21 {fam}: {res['config']}: {res['tokens_s']:.1f} tok/s "
            f"({res['tokens_s_min']:.1f}-{res['tokens_s_max']:.1f}), step "
            f"{res['step_s']:.4f} s, MFU {res['mfu']:.4f}, peak "
            f"{res['peak_mib']:.0f} MiB, loss {res['loss_first']:.3f} -> "
            f"{res['loss_last']:.3f}")
        for k in FLASH:
            totals[k] += res["launches"][k]

    # the T=32768 leg, hash_bench and the DiLoCo parts at once (each DiLoCo
    # part on its own master and ports): their times are logged, not held,
    # since they share the card and the host; the bench runs them one by one
    with ThreadPoolExecutor(5) as ex:
        parts = [ex.submit(run_json, "llama32k", [
            "pccl_tpu_torch.benchmarks.model_bench", "llama",
            *(f"{k}={v}" for k, v in BENCH_LONG.items())])]
        parts.append(ex.submit(run_json, "hash",
                               ["pccl_tpu_torch.benchmarks.hash_bench"]))
        parts += [ex.submit(run_json, part, ["chip_smoke", "--bench-part", part])
                  for part in ("diloco_outer", "diloco_cuda", "async_diloco_cuda")]
        long, hashed, res = [f.result() for f in parts][:3]
    _model_checks("llama32k", long, llama.named_config("700m").n_layer,
                  BENCH_LONG["windows"] * BENCH_LONG["steps_per_window"], remat=True)
    log(f"21 llama32k: {long['config']}: {long['tokens_s']:.1f} tok/s, MFU "
        f"{long['mfu']:.4f}, peak {long['peak_mib']:.0f} MiB, loss "
        f"{long['loss_first']:.3f} -> {long['loss_last']:.3f}")
    for k in FLASH:
        totals[k] += long["launches"][k]
    if hashed["h1_launches"] < 1:
        raise SmokeError(f"21 hash: H1 not launched: {hashed}")
    totals["simplehash_tpu"] = hashed["h1_launches"]
    want = res["closed_form"]
    for r in res["ranks"]:
        if r["platform"] != "cuda" or not (r["w_min"] == r["w_max"] == r["first"]) \
                or abs(r["first"] - want) > 1e-5 * abs(want):
            raise SmokeError(f"21 diloco_outer: rank {r['rank']} on {r['platform']} "
                             f"holds [{r['w_min']}, {r['w_max']}], closed form {want}")
    log(f"21 diloco_outer: 100M fp32, outer step {res['outer_step_s']:.4f} s, "
        f"digests equal ({res['ranks'][0]['digest']}), every element "
        f"{res['ranks'][0]['first']} (closed form {want:.7f}); peer RSS "
        f"{[r['peak_rss_mib'] for r in res['ranks']]} MiB")
    log(f"21: launches {totals}")
    return {"launches": totals}


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

    timed("build", phase_build)
    kres = timed("kernels", phase_kernels)
    lres = timed("with_lse", phase_with_lse)
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
    # phases 9 and 10 run in peer processes of their own, whose counts
    # start at 0, at once
    resume, ddp_resume = phases_9_10()
    fa.reset_launch_counts()
    grid = timed("grid", phase_grid)
    # phase 12 runs in this process and sets H1's count to 0 itself just
    # before its peers start
    comm = timed("comm", phase_comm)
    # phase 13's ranks are processes of their own, whose counts start at 0
    sp = timed("sp", phase_sp)
    # phases 14-16 share four rank processes, which set their counts to 0
    # before each phase and read them after it
    par = timed("tp, pp, moe", phase_par)
    tp = check_tp(par)
    pp = check_pp(par)
    check_moe(par)
    ddp_tp = timed("ddp tp", phase_ddp_tp)
    # phase 18's peers and their ranks are processes of their own, whose
    # counts start at 0
    mesh = timed("diloco mesh", phase_mesh)
    # phases 19 and 20 run in processes of their own, whose counts start at 0
    examples, soak = phases_19_20()
    # phase 21's parts run in processes of their own, whose counts start at 0
    bench = timed("bench", phase_bench)
    paths = (main_path, ddp, async_path, remat, resume, ddp_resume, grid, comm, sp,
             tp, pp, ddp_tp, mesh, examples, soak, bench)

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

            # times at the GPT-2 paths' shape, and at phase 7's and phase
            # 13's non-causal ring step beside them
            row.update(at(m))
            row["llama700m"] = at(ll)
            row["sp"] = at(kres["sp"])
            # and at phase 14's tp ranks' shapes
            row["tp"] = at(kres["tp"])
            row["tp_gpt"] = at(kres["tp_gpt"])
            # and at phase 15's pipeline stages'
            row["pp"] = at(kres["pp"])
            # and at phase 18a's Llama-700m peer of 2 tp ranks
            row["tp2_llama"] = at(kres["tp2_llama"])
            # and at phase 19's examples' defaults (Dh 16 and 32, padded)
            row["nano"] = at(kres["nano"])
            row["tiny_gqa"] = at(kres["tiny_gqa"])
            # and at phase 21's bench shapes: model_bench's batches, and the
            # long-context legs at T=8192 and 32768
            for tag in ("bench_gpt", "bench_llama", "long_gpt", "long_llama",
                        "long32k"):
                row[tag] = at(kres[tag])
            # through flash_attention_with_lse with an lse cotangent (3a)
            row["with_lse_max_abs_err"] = max(
                e[o]["max_abs"] for e in lres.values() for o in out_names[name])
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
    if "--bench-part" in sys.argv:
        # one of phase 21's DiLoCo parts
        bench_part(sys.argv[sys.argv.index("--bench-part") + 1])
        sys.exit(0)
    if "--sp-rank" in sys.argv or "--par-rank" in sys.argv:
        # one of phase 13's ranks, or of phases 14-16's
        import argparse

        kind = "sp" if "--sp-rank" in sys.argv else "par"
        ap = argparse.ArgumentParser()
        ap.add_argument(f"--{kind}-rank", type=int, required=True)
        ap.add_argument(f"--{kind}-port", type=int, required=True)
        a = vars(ap.parse_args())
        (sp_rank if kind == "sp" else par_rank)(a[f"{kind}_rank"], a[f"{kind}_port"])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
