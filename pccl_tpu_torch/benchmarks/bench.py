"""The port's headline benchmark: the twin of the repo's bench.py.

    python -m pccl_tpu_torch.benchmarks.bench [--fast] [--bytes N] [--iters N]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

Headline (BASELINE config 1): fp32 all-reduce busbw, 2 loopback peers,
over the native core, through the port's comm/native_bench.py. Baseline:
the reference's best sustained all-reduce figure, 45 Gbit/s (5.625 GB/s;
BASELINE.md); vs_baseline is value / 5.625. The library is built through
ops/_build.ensure_pcclt(), so there is no pure-Python fallback.

"extra" carries, in bench.py's order and under its keys:
- the host legs of native_bench (bf16, quantized, shared state, soak, the
  DiLoCo outer step at 100M and 1B elements with their outer state on the
  card, churn, hierarchical, the paced-wire legs, master recovery,
  topology, schedule, telemetry, attribution, degraded, swarm, master
  scale). A host leg that fails records None, prints its error on stderr
  and is listed in extra["failed_legs"]. The 1B leg runs only when
  /proc/meminfo's MemAvailable covers native_bench.diloco_1b_host_bytes();
  extra["diloco_1b_gate"] says which way it went.
- the card legs, each under a `cuda_` key where bench.py wrote `tpu_`:
  model_bench for each family at its defaults, the long-context legs
  (T=8192, 16384 and 32768 at batch 1, flash, remat=1, loss_chunk=2048 at
  32k) and the Llama repeat_kv ablation, hash_bench (each a subprocess of
  its own, as bench.py runs them), then run_diloco_cuda_bench and
  run_async_diloco_cuda_bench. A card leg that fails records None, is
  listed in extra["failed_legs"], and makes the run exit 1 after the line
  is printed: no card leg is reported as a success it was not.

--fast runs only the headline and the card legs. Without CUDA it raises
RuntimeError before any leg.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Any, Callable, Dict, List

BASELINE_GBPS = 45.0 / 8.0  # 45 Gbit/s → GB/s

# (extra key prefix, family, seq, extra model_bench arguments): batch 1,
# flash, remat=1, as bench.py's long-context legs
LONG_CONTEXT = (
    ("cuda_longctx", "gpt", 8192, ()),
    ("cuda_longctx16k", "gpt", 16384, ()),
    ("cuda_longctx_llama", "llama", 8192, ()),
    ("cuda_longctx16k_llama", "llama", 16384, ()),
    # T=32768 with the chunked CE: the [1, 32768, vocab] fp32 logits and
    # their cotangent are never held whole
    ("cuda_longctx32k", "gpt", 32768, ("loss_chunk=2048",)),
    ("cuda_longctx32k_llama", "llama", 32768, ("loss_chunk=2048",)),
    # the GQA A/B: the same Llama leg with K/V repeated to the q heads in
    # memory before the kernel
    ("cuda_longctx_llama_repeatkv", "llama", 8192, ("repeat_kv=1",)),
)


def _json_tail(cmd: List[str], timeout: int) -> dict:
    """Run `cmd` (a python -m module of this package); its last stdout
    line as JSON. Raises on a non-zero exit, showing its stderr's tail."""
    p = subprocess.run([sys.executable, "-m", *cmd], capture_output=True,
                       text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {p.returncode}: "
                           f"{p.stderr.strip()[-2000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


class _Legs:
    """Runs legs into `extra`, recording each failure."""

    def __init__(self, extra: Dict[str, Any]):
        self.extra = extra
        self.failed: List[str] = []
        self.card_failed = False

    def run(self, name: str, fn: Callable[[], Dict[str, Any]],
            none_keys=(), card: bool = False) -> None:
        try:
            self.extra.update(fn())
        except Exception as e:  # noqa: BLE001 — one leg must not kill the rest
            print(f"bench: {name} failed ({type(e).__name__}: {e})",
                  file=sys.stderr)
            for k in none_keys:
                self.extra[k] = None
            self.failed.append(name)
            self.card_failed |= card


def _mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return int(line.split()[1]) * 1024
    return 0


def host_legs(legs: _Legs, nb) -> None:
    """bench.py's extras on the native stack, in its order."""
    for key, fn in [
            ("bf16_busbw_gbps", nb.run_allreduce_bench_bf16),
            ("quant4_busbw_gbps", nb.run_quantized_concurrent_bench),
            # fp32 twin of config 2: the loopback inversion (fp32 beats u8
            # on a free wire) recorded in the artifact itself
            ("concurrent4_fp32_busbw_gbps",
             lambda: nb.run_quantized_concurrent_bench(quantize=False)),
            ("shared_state4_step_s", nb.run_shared_state_bench),
            ("soak8_step_s", nb.run_soak_bench)]:
        legs.run(key, lambda fn=fn, key=key: {key: fn()}, (key,))

    def diloco():
        med, phases = nb.run_diloco_outer_bench()
        return {"diloco_outer_step_s": med, "diloco_phases_s": phases}

    legs.run("diloco", diloco, ("diloco_outer_step_s", "diloco_phases_s"))
    legs.run("diloco churn", nb.run_diloco_churn_bench,
             ("diloco_steady_step_s", "diloco_churn_step_s", "worlds_seen",
              "steps_completed", "rejoiner_joined"))

    need, avail = nb.diloco_1b_host_bytes(), _mem_available_bytes()
    legs.extra["diloco_1b_gate"] = {"mem_available_gib": avail / 2 ** 30,
                                    "needs_gib": need / 2 ** 30,
                                    "ran": avail >= need}
    if avail >= need:
        legs.run("diloco 1b", nb.run_diloco_1b_bench, ("diloco_1b_step_s",))
    else:
        print(f"bench: skipping 1B diloco leg (MemAvailable "
              f"{avail / 2 ** 30:.1f} GiB < {need / 2 ** 30:.1f})", file=sys.stderr)

    for name, fn, keys in [
            ("hierarchical", nb.run_hierarchical_bench,
             ("hier2_step_s", "hier2_q8_step_s")),
            ("hierarchical wan", nb.run_hierarchical_wan_bench,
             ("hier2_wan_quant_speedup",)),
            ("diloco wan", nb.run_diloco_wan_bench, ("diloco_wan_quant_speedup",)),
            ("wan", nb.run_wan_bench, ("wan_quant_speedup",)),
            ("wan bf16", nb.run_wan_bf16_bench, ("wan_bf16_quant_speedup",)),
            ("wan rtt", nb.run_wan_rtt_windowed_bench,
             ("wan_rtt_windowed_speedup",))]:
        legs.run(name, fn, keys)
    # the pipelined plane on the same fat-long-pipe map, against the two
    # keys just measured
    base = {k: legs.extra.get(k) for k in ("wan_rtt_single_busbw_gbps",
                                           "wan_rtt_windowed_busbw_gbps")}
    legs.run("wan pipelined", lambda: nb.run_wan_pipelined_bench(baselines=base),
             ("wan_pipelined_speedup",))
    for name, fn, keys in [
            ("wan striped", nb.run_wan_striped_bench, ("wan_striped_speedup",)),
            ("master recovery", nb.run_master_recovery_bench,
             ("master_recovery_s",)),
            ("topology opt", nb.run_topology_opt_bench, ("topology_opt_speedup",)),
            ("schedule bench", nb.run_schedule_bench,
             ("sched_hub_speedup", "sched_2dc_speedup")),
            ("telemetry overhead", nb.run_telemetry_overhead_bench,
             ("telemetry_overhead_pct",)),
            ("attribution", nb.run_attribution_bench, ("attribution_coverage",)),
            ("degraded recovery", nb.run_degraded_recovery_bench,
             ("degraded_recovery_s", "relay_overhead_pct")),
            ("sync swarm", nb.run_sync_swarm_bench, ("sync_swarm_speedup",)),
            ("master scale", nb.run_master_scale_bench,
             ("master_scale_ingest_rate",))]:
        legs.run(name, fn, keys)


def card_legs(legs: _Legs, nb) -> None:
    """The legs on the card, each model and hash leg in a process of its
    own."""
    for fam in ("gpt", "llama"):
        def model(fam=fam):
            r = _json_tail(["pccl_tpu_torch.benchmarks.model_bench", fam], 900)
            return {f"cuda_train_tokens_s_{fam}": r["tokens_s"],
                    f"cuda_mfu_{fam}": r["mfu"],
                    f"cuda_config_{fam}": r["config"],
                    f"cuda_step_s_{fam}": r["step_s"],
                    f"cuda_tokens_s_minmax_{fam}": [r["tokens_s_min"],
                                                    r["tokens_s_max"]],
                    f"cuda_peak_mib_{fam}": r["peak_mib"],
                    f"cuda_launches_{fam}": r["launches"]}

        legs.run(f"cuda {fam}", model, (f"cuda_train_tokens_s_{fam}",), card=True)
    for key, fam, seq, ab in LONG_CONTEXT:
        def long_leg(key=key, fam=fam, seq=seq, ab=ab):
            r = _json_tail(["pccl_tpu_torch.benchmarks.model_bench", fam, "batch=1",
                            f"seq={seq}", "use_flash=1", "remat=1", *ab], 900)
            return {f"{key}_tokens_s": r["tokens_s"], f"{key}_mfu": r["mfu"],
                    f"{key}_config": r["config"], f"{key}_peak_mib": r["peak_mib"]}

        legs.run(key, long_leg, (f"{key}_tokens_s",), card=True)

    def hash_leg():
        r = _json_tail(["pccl_tpu_torch.benchmarks.hash_bench"], 600)
        return {f"cuda_{k}": v for k, v in r.items()}

    legs.run("hash bench", hash_leg, ("cuda_devhash_256mb_s",), card=True)
    # headline aliases point at the flagship (gpt) leg
    legs.extra["cuda_train_tokens_s"] = legs.extra.get("cuda_train_tokens_s_gpt")
    legs.extra["cuda_mfu"] = legs.extra.get("cuda_mfu_gpt")
    legs.run("diloco cuda", nb.run_diloco_cuda_bench, ("diloco_cuda_step_s",),
             card=True)
    legs.run("async diloco cuda", nb.run_async_diloco_cuda_bench,
             ("async_diloco_cuda_step_s",), card=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="only the headline and the card legs")
    ap.add_argument("--bytes", type=int, default=64 << 20,
                    help="headline all-reduce payload in bytes")
    # 16 iterations: the median is stable to a few % on a loaded host
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..comm import native_bench as nb
    from ..ops import _build

    # the card legs, and the DiLoCo legs' peers, need one: refuse at once
    resolve_device("cuda")
    _build.ensure_pcclt()
    extra: Dict[str, Any] = {}
    stats = nb.run_allreduce_bench(nbytes=args.bytes, iters=args.iters,
                                   return_stats=True)
    busbw = stats["med"]
    extra["headline_gbps_minmax"] = [stats["min"], stats["max"]]
    # flight-recorder phase breakdown for the headline op (mean per reduce,
    # seconds): where a regression lives — ring phases vs wire stall
    if "phases" in stats:
        extra["allreduce_phases_s"] = stats["phases"]

    legs = _Legs(extra)
    if not args.fast:
        host_legs(legs, nb)
    card_legs(legs, nb)
    extra["failed_legs"] = legs.failed
    print(json.dumps({
        "metric": "allreduce_busbw_fp32_2peer_loopback(native)",
        "value": round(busbw, 3),
        "unit": "GB/s",
        "vs_baseline": round(busbw / BASELINE_GBPS, 3),
        "extra": extra,
    }), flush=True)
    return 1 if legs.card_failed else 0


if __name__ == "__main__":
    sys.exit(main())
