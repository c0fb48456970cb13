"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: it builds the port's native code (libpcclt.so and the CUDA
kernels, into pccl_tpu_torch/build/ of this checkout), starts the cell's
master, starts one peer process a peer (portbench/peer.py; with one chip a
peer, each sees only its own card), gathers their records, runs the plain
reference on the card once they have exited, and prints
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}. The numbers compared and their limits go last on standard error
too. It exits 3, printing no result, without the cards the cell asks for.

--control reads the control's numbers instead (the reference in the next
lower precision put in the program's place; no peers, no window), with
--fault NAME that fault planted in the reference instead (stale_step,
half_batch); --fault NAME alone runs the peers with the fault planted
under the program (faults.py). None of these is part of a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

from portbench import check, flops, spec  # noqa: E402
from portbench.guard import forbidden_modules  # noqa: E402

PEER_GRACE_S = 240


def free_ports(n: int, offsets=(0,)) -> list:
    """n base ports chosen by the OS, each with base + offset free for every
    offset (a peer listens at base, base+4 and base+8). All are held until
    the n are found, so two bases never share a port."""
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
            # taken, or past 65535
            except (OSError, OverflowError):
                continue
            bases.append(base)
    finally:
        for s in held:
            s.close()
    return bases


def peer_env(rank: int, traffic: dict, device: str) -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["USE_FLAX"] = "0"
    env["PYTHONPATH"] = str(spec.ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(traffic.get("env", {}))
    if device == "cuda":
        per_card = traffic["peers_per_chip"]
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = visible.split(",") if visible else None
        card = rank // per_card
        env["CUDA_VISIBLE_DEVICES"] = cards[card] if cards else str(card)
    return env


def _pump(proc, sink: list) -> None:
    for line in proc.stdout:
        if line.startswith("PORTBENCH_PEER "):
            sink.append(json.loads(line[len("PORTBENCH_PEER "):]))
        else:
            sys.stderr.write(line)


def run_peers(cell, seed: int, seconds: float, trace: int, device: str,
              fault=None) -> tuple:
    """Master and peers of one run: (records in rank order, failed peers)."""
    from pccl_tpu_torch.comm.api import MasterNode

    tr = cell.traffic
    n = tr["peers"]
    master_port, *bases = free_ports(n + 1, offsets=(0, 4, 8))
    master = None
    if n > 1:
        master = MasterNode("127.0.0.1", master_port)
        master.run()
    procs, sinks, threads = [], [], []
    try:
        for rank in range(n):
            peer_spec = {"config": cell.config, "traffic": tr, "seed": seed,
                         "seconds": seconds, "trace": trace, "rank": rank,
                         "world": n, "master_port": master_port,
                         "base_port": bases[rank], "device": device,
                         "fault": fault}
            p = subprocess.Popen([sys.executable, "-m", "portbench.peer",
                                  json.dumps(peer_spec)],
                                 stdout=subprocess.PIPE, text=True,
                                 env=peer_env(rank, tr, device), cwd=spec.ROOT)
            sink = []
            t = threading.Thread(target=_pump, args=(p, sink), daemon=True)
            t.start()
            procs.append(p)
            sinks.append(sink)
            threads.append(t)
        # a peer that fails leaves the others blocked in the ring: end them
        deadline = time.time() + seconds + PEER_GRACE_S
        while time.time() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in threads:
            t.join(timeout=10)
        if master is not None:
            master.interrupt()
            master.await_termination()
            master.destroy()
    records = [s[0] if s else None for s in sinks]
    failed = [i for i, (p, r) in enumerate(zip(procs, records))
              if p.returncode != 0 or r is None]
    return records, failed


def end_to_end(cell, records: list, seconds: float) -> dict:
    tr = cell.traffic
    per_card = tr["peers_per_chip"]
    cards = {}
    for r in records:
        card = r["rank"] // per_card
        cards[card] = cards.get(card, 0) + r.get("mem_peak_bytes", 0)
    values = {
        "tokens_per_s": sum(r["tokens"] for r in records) / seconds,
        "peak_mem_gib": max(cards.values()) / 2 ** 30,
        "setup_s": max(r["t_window_start"] for r in records) - T_START,
    }
    return values, max(cards.values())


def setup_split(t_built: float, records: list) -> dict:
    """setup_s cut at its marks, the slowest peer at each: the launcher's
    imports, card check and builds; the peers' interpreter and imports;
    weights and training state; connect (the world complete); the checked
    steps and set-up's two outer steps."""
    marks = [r["setup_marks"] for r in records]
    cuts = [("launcher", [t_built]),
            ("start_imports", [m["imported"] for m in marks]),
            ("weights_state", [m["state"] for m in marks]),
            ("connect", [m["connected"] for m in marks]),
            ("checked_steps", [m["checked"] for m in marks]),
            ("to_window", [r["t_window_start"] for r in records])]
    out, prev = {}, T_START
    for name, ts in cuts:
        t = max(ts)
        out[name] = t - prev
        prev = t
    return out


def device_busy(cell, records: list) -> tuple:
    """(busy seconds averaged over the cards, window seconds): the union of
    every device op of a card's peers over the window, on one wall clock."""
    per_card = cell.traffic["peers_per_chip"]
    cards = {}
    for r in records:
        cards.setdefault(r["rank"] // per_card, []).extend(r["trace"]["busy_ns"])
    busy = []
    for ivs in cards.values():
        total, end = 0, None
        for s, t in sorted(ivs):
            if end is None or s > end:
                total += t - s
                end = t
            elif t > end:
                total += t - end
                end = t
        busy.append(total / 1e9)
    w0, w1 = records[0]["trace"]["window_ns"]
    return sum(busy) / len(busy), (w1 - w0) / 1e9


def breakdown(cell, records: list) -> dict:
    """The device ops that took most time, and the card's longest idle
    gaps named by the host span of peer 0 that covers them."""
    ops = {}
    for r in records:
        for name, (_, ns) in r["trace"]["ops"].items():
            ops[name] = ops.get(name, 0) + ns
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    per_card = cell.traffic["peers_per_chip"]
    ivs = sorted(iv for r in records if r["rank"] // per_card == 0
                 for iv in r["trace"]["busy_ns"])
    w0, w1 = records[0]["trace"]["window_ns"]
    gaps, end = [], w0
    for s, t in ivs:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if w1 > end:
        gaps.append((end, w1))
    spans = sorted(records[0]["trace"]["spans"], key=lambda s: s[2] - s[1])
    named = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = next((s[0] for s in spans if s[1] <= mid <= s[2]), "other")
        named[name] = named.get(name, 0) + (b - a)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}


def per_layer(cell, records: list, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    return {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak)}


def run_cell(cell, seed: int, seconds: float, trace: int, device: str = "cuda",
             fault=None) -> dict:
    """One run of a cell; the result line's object (checks last)."""
    import importlib

    import torch

    checks_mod = importlib.import_module(f"portbench.checks.{cell.traffic['mode']}")
    from pccl_tpu_torch.ops import _build

    if cell.traffic["peers"] > 1:
        _build.ensure_pcclt()
    if device == "cuda":
        _build.build_kernels()
    t_built = time.time()
    records, failed = run_peers(cell, seed, seconds, trace, device, fault)
    attempted = sum(r["steps"] for r in records if r) + len(failed)
    result = {"correct": False, "attempted": attempted, "failed": len(failed),
              "metrics": {}, "device": device_info(device, cell.chips, 0)}
    if failed:
        result["checks"] = {"peers_failed": {"value": len(failed), "limit": 0}}
        return result
    found = sorted({m for r in records for m in r.get("forbidden", [])})
    if found:
        raise SystemExit(f"a peer loaded {', '.join(found)}")
    e2e, peak = end_to_end(cell, records, seconds)
    sys.stderr.write("setup " + json.dumps(setup_split(t_built, records)) + "\n")
    outer = [o for r in records for o in r.get("outer", [])]
    sys.stderr.write("outer_steps " + json.dumps(
        {"host_s": [(o["t1_ns"] - o["t0_ns"]) / 1e9 for o in outer],
         "device_s": [o.get("device_s") for o in outer]}) + "\n")
    result["device"] = device_info(device, cell.chips, peak)
    if trace:
        busy, window = device_busy(cell, records)
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = window
        ctx = {"cell": cell, "records": records, "e2e": e2e, "busy_s": busy,
               "window_s": window, "flops": flops,
               "device_name": result["device"]["kind"]}
        result["metrics"] = per_layer(cell, records, ctx)
        result["breakdown"] = breakdown(cell, records)
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    for r in records:
        r.pop("trace", None)
    numbers = checks_mod.numbers(cell, seed, records, torch.device(device, 0)
                                 if device == "cuda" else torch.device("cpu"))
    result["correct"] = check.judge(numbers, cell.limits)
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    # the control and the faults read in the reference need one card
    need = 1 if args.control else cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"cell {cell.name} needs {need} CUDA card(s); "
                         f"this machine has {have}\n")
        return 3
    if args.control:
        import importlib

        mod = importlib.import_module(f"portbench.checks.{cell.traffic['mode']}")
        numbers = mod.control(cell, args.seed, torch.device("cuda", 0), args.fault)
        what = args.fault or "control"
        for k in cell.limits:
            sys.stderr.write(f"{what} {k} {numbers[k]!r} limit {cell.limits[k]!r}\n")
        print(json.dumps({what: numbers, "limits": cell.limits,
                          "correct": check.judge(numbers, cell.limits)}))
        return 0
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda", args.fault)
    return finish(result)


def finish(result: dict) -> int:
    """The sys.modules check, the compared numbers on standard error, and
    the result line; exit 4 and no result if a forbidden module loaded."""
    found = forbidden_modules(sys.modules)
    if found:
        sys.stderr.write(f"forbidden modules loaded: {', '.join(found)}\n")
        return 4
    checks = result.pop("checks")
    result["checks"] = checks
    for k, c in checks.items():
        sys.stderr.write(f"check {k} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
