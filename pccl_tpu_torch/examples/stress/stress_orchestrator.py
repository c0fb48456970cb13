"""Fault-tolerance soak: churn real peer processes until the clock runs out.

    python -m pccl_tpu_torch.examples.stress.stress_orchestrator \
        --duration 120 --peers 3 [--device cpu]

A master and N peers (ft_peer.py) on loopback; the peers kill themselves
at random mid-run (--die-prob) and are relaunched, and a stall detector
watches their heartbeat lines. Progress anywhere in the group within the
stall window is healthy; no progress means the collective runtime wedged,
and the soak FAILS. Every peer gets --device (the card by default): its
vector and shared state are torch tensors there.

Master churn: with --master-kill-interval > 0 the MASTER process is also
SIGKILLed on a schedule and restarted on the same port; the peers
reconnect and training resumes. Without a journal the peers rejoin with
fresh communicators (ft_peer.py's rejoin path); with --journal PATH the
restarted master rehydrates its state from the write-ahead journal and the
peers SESSION-RESUME under their old UUIDs instead, so a master restart is
a blip, not a world reset (docs/10_high_availability.md). The summary
prints the measured master downtime and the resumes against full rejoins.

The shared-state lane (--sync-churn N): every peer syncs an N-float32
state each step over the content-addressed chunk plane, through a joiner
flood and a seeder kill, and the SYNC SUMMARY gates on zero wrong
adoptions and zero failed syncs. On a card the state is hashed by H1
(PCCLT_SS_HASH=simple-tpu, set here for every peer), and the summary adds
`h1_launches`, the sum of H1's launches over the peers' last STATS lines,
which must be above 0.

Usage:
    python -m pccl_tpu_torch.examples.stress.stress_orchestrator \
        --duration 120 --peers 3 --master-kill-interval 30
    python -m pccl_tpu_torch.examples.stress.stress_orchestrator \
        --duration 45 --peers 3 --sync-churn 1048576 --stall-seconds 60
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
PEER = "pccl_tpu_torch.examples.stress.ft_peer"


class MasterProc:
    """The master as a killable subprocess (python -m
    pccl_tpu_torch.comm.master)."""

    _instance = 0

    def __init__(self, port: int, journal: str | None = None,
                 metrics_port: int | None = None):
        self.port = port
        MasterProc._instance += 1
        log = os.environ.get("MASTER_LOG")
        out = (open(f"{log}.{MasterProc._instance}", "wb")
               if log else subprocess.DEVNULL)
        cmd = [sys.executable, "-m", "pccl_tpu_torch.comm.master", "--port",
               str(port)]
        if journal:
            cmd += ["--journal", journal]
        if metrics_port is not None:
            cmd += ["--metrics-port", str(metrics_port)]
        self.proc = subprocess.Popen(
            cmd, cwd=str(REPO), stdout=out, stderr=subprocess.STDOUT)
        deadline = time.time() + 15
        while time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=1):
                    return
            except OSError:
                if self.proc.poll() is not None:
                    raise RuntimeError("master process died on startup")
                time.sleep(0.1)
        raise RuntimeError("master never started listening")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=10)


class Peer:
    def __init__(self, master_port: int, idx: int, base_port: int,
                 die_prob: float, seed: int, env: dict | None = None,
                 count: int = 4096, extra_args: list | None = None,
                 device: str = "cuda"):
        self.idx = idx
        self.base_port = base_port
        cmd = [sys.executable, "-m", PEER, "--master-port", str(master_port),
               "--rank", str(idx), "--base-port", str(base_port),
               "--steps", "1000000", "--min-world", "2",
               "--step-interval", "0.05", "--count", str(count),
               "--die-prob", str(die_prob), "--seed", str(seed),
               "--device", device]
        cmd += extra_args or []
        if env:
            cmd += ["--stats-every", "10"]
        penv = {**os.environ, **(env or {})}
        self.proc = subprocess.Popen(cmd, cwd=str(REPO), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=penv)
        self.stats: dict = {}  # newest STATS snapshot (chaos runs)
        self.steps = 0
        self.wrong_sync = 0  # bit-wrong shared-state adoptions (gate: 0)
        self.resumes = 0  # total session resumes across this peer's comm lives
        self.rejoins = 0  # full re-registrations (fresh communicator)
        # RESUMED total=N is per-COMMUNICATOR and resets to 0 on a rejoin, so
        # fold each comm life's max into a base when a REJOIN line arrives
        self._resume_base = 0
        self._life_max = 0
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t.start()

    def _pump(self) -> None:
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            if line.startswith("STEP "):
                self.steps += 1
            elif line.startswith("WRONG SYNC"):
                self.wrong_sync += 1
                print(f"peer {self.idx}: {line.rstrip()}", flush=True)
            elif line.startswith("STATS "):
                try:
                    self.stats = json.loads(line[6:])
                except ValueError:
                    pass
            elif line.startswith("INJECT"):
                # surface the victim's chaos injection (or its failure)
                print(f"peer {self.idx}: {line.rstrip()}", flush=True)
            elif line.startswith("RESUMED total="):
                try:
                    n = int(line.split("total=")[1].split()[0])
                except (ValueError, IndexError):
                    continue
                self._life_max = max(self._life_max, n)
                self.resumes = self._resume_base + self._life_max
            elif line.startswith("REJOIN"):
                self.rejoins += 1
                self._resume_base += self._life_max
                self._life_max = 0
                self.resumes = self._resume_base

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=10)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--peers", type=int, default=3)
    ap.add_argument("--die-prob", type=float, default=0.002)
    ap.add_argument("--master-port", type=int, default=48900)
    ap.add_argument("--base-port", type=int, default=58000)
    ap.add_argument("--master-kill-interval", type=float, default=0.0,
                    help="SIGKILL + restart the master every this many "
                         "seconds (0 = master never dies)")
    ap.add_argument("--master-down-time", type=float, default=1.5,
                    help="how long the master stays dead before restart")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="master HA journal: restarts rehydrate state and "
                         "peers session-resume instead of rejoining")
    ap.add_argument("--stall-seconds", type=float, default=120.0,
                    help="fail if NO peer makes progress for this long "
                         "(the native core's own stress test uses 5 "
                         "minutes)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="observability plane: master serves /metrics + "
                         "/health here, peers push telemetry digests, and "
                         "the exit summary prints the fleet health view "
                         "(docs/09_observability.md)")
    ap.add_argument("--telemetry-push-ms", type=int, default=250,
                    help="digest cadence for the peers when --metrics-port "
                         "is set")
    ap.add_argument("--chaos", default=None, metavar="SCHEDULE",
                    help="scripted fault injection (docs/05): the victim "
                         "sender (peer 1) injects this chaos schedule "
                         "(e.g. 'flap@t=10s:200msx5;degrade@t=20s:"
                         "20mbit/15s') on its OUTBOUND ring edge mid-run "
                         "(self-discovered from stats, ring-order-proof); "
                         "the edge watchdog + window failover turn on "
                         "fleet-wide and a CHAOS SUMMARY exit line prints. "
                         "A raw 'endpoint=schedule,...' map is applied "
                         "verbatim via PCCLT_WIRE_CHAOS_MAP instead.")
    ap.add_argument("--chaos-mbps", type=float, default=300.0,
                    help="baseline emulated per-edge bandwidth for chaos "
                         "runs (per-endpoint netem edges must exist for "
                         "the schedule to retune)")
    ap.add_argument("--count", type=int, default=4096,
                    help="per-step all-reduce element count (chaos runs "
                         "want real payloads so windows exist to fail over)")
    ap.add_argument("--sync-churn", type=int, default=0, metavar="ELEMS",
                    help="churn-proof shared-state lane (docs/04): every "
                         "peer syncs an ELEMS-float32 state per step over "
                         "the content-addressed chunk plane; the schedule "
                         "adds a JOINER FLOOD (half the peers SIGKILLed at "
                         "once at 1/3 duration, relaunched as cold "
                         "joiners) and a busiest-SEEDER kill at 2/3 "
                         "duration (picked by ss_seeder_chunks_served). "
                         "Exit prints a SYNC SUMMARY with gates: zero "
                         "wrong-content adoptions, zero failed syncs on "
                         "live peers.")
    ap.add_argument("--fleet-scale", type=int, default=0, metavar="N",
                    help="fleet-scale observability lane (docs/09): a "
                         "native digest bot keeps N simulated OBSERVER "
                         "sessions (PCCP/2 hello tail byte; they push "
                         "telemetry, never join the world) flooding the "
                         "master for the whole soak while the real peers "
                         "churn. Exit prints a FLEET SCALE summary with "
                         "digests pushed, ingest-queue drops, and a "
                         "promlint verdict on the final /metrics scrape. "
                         "Requires --metrics-port.")
    ap.add_argument("--fleet-edges", type=int, default=8,
                    help="edges per simulated observer for --fleet-scale")
    ap.add_argument("--fleet-hz", type=float, default=5.0,
                    help="digest cadence per simulated observer for "
                         "--fleet-scale")
    ap.add_argument("--sync-chunk-bytes", type=int, default=262144,
                    help="PCCLT_SS_CHUNK_BYTES for --sync-churn peers")
    ap.add_argument("--sync-mbps", type=float, default=250.0,
                    help="per-process wildcard egress pacing for "
                         "--sync-churn (models a per-NIC bottleneck so "
                         "multi-source fetch genuinely multiplies "
                         "bandwidth)")
    ap.add_argument("--sync-degrade-mbit", type=float, default=2.0,
                    help="--sync-churn schedules a seeder-edge DEGRADE to "
                         "this rate on peer 0's egress bucket from 1/3 "
                         "duration (the joiner flood) through the seeder "
                         "kill, so its serves toward recovering joiners "
                         "stall and the serve-side watchdog SUSPECT rung "
                         "fires in every soak, not only when a peer "
                         "happens to die mid-serve (0 = no degrade)")
    ap.add_argument("--device", default="cuda",
                    help="every peer's --device: where its vector and shared "
                         "state live (cpu or cuda)")
    args = ap.parse_args()
    on_card = args.device.startswith("cuda")

    if args.metrics_port is not None:
        # peers inherit the cadence; the master flag rides the CLI
        os.environ["PCCLT_TELEMETRY_PUSH_MS"] = str(args.telemetry_push_ms)

    # chaos plane (docs/05): every peer gets a uniform emulated mesh + the
    # watchdog. Schedule mode: the victim SENDER (peer 1) injects the
    # schedule on its OUTBOUND ring edge at runtime, discovered from its
    # own stats() — the ATSP-adopted ring order decides who its successor
    # is, so a hardcoded edge could land on one the ring never uses. Its
    # failover then relays through a peer whose edges stay healthy. A raw
    # "endpoint=schedule" map is still applied verbatim via the env.
    chaos_env: dict[int, dict] = {}
    chaos_args: dict[int, list] = {}
    if args.chaos:
        p2p = {i: args.base_port + i * 16 for i in range(args.peers)}
        mbps_map = ",".join(f"127.0.0.1:{p}={args.chaos_mbps}"
                            for p in p2p.values())
        base = {"PCCLT_WIRE_MBPS_MAP": mbps_map, "PCCLT_WATCHDOG": "1"}
        for i in range(args.peers):
            chaos_env[i] = dict(base)
        raw_map = "=" in args.chaos.split("@", 1)[0]
        if raw_map:
            for i in range(args.peers):
                chaos_env[i]["PCCLT_WIRE_CHAOS_MAP"] = args.chaos
        elif args.peers >= 2:
            chaos_args[1] = ["--inject-spec", args.chaos, "--inject-at", "10"]

    # churn-sync lane env + per-peer args (docs/04)
    sync_args: list = []
    if args.sync_churn > 0:
        sync_args = ["--sync-state", str(args.sync_churn)]
        base_env = {"PCCLT_SS_CHUNK_BYTES": str(args.sync_chunk_bytes),
                    "PCCLT_WIRE_MBPS_MAP": f"127.0.0.1={args.sync_mbps}",
                    "PCCLT_WATCHDOG": "1"}
        if on_card:
            # the card's entries are hashed by H1; every peer must hash alike
            base_env["PCCLT_SS_HASH"] = "simple-tpu"
        for i in range(args.peers):
            chaos_env.setdefault(i, {}).update(base_env)
        if args.sync_degrade_mbit > 0:
            # scheduled seeder-edge degrade (docs/04): peer 0 — flood-proof,
            # so always up-to-date and in the seeder directory — has its
            # per-process egress bucket degraded from the joiner flood
            # (1/3 duration) through past the seeder kill. Its serves
            # toward the recovering joiners then stall past the watchdog
            # deadline and the SUSPECT rung fires in every soak; the
            # joiners' deadline re-source rescues the chunks from the
            # healthy seeders, so the round still completes.
            t0 = max(1, int(args.duration / 3))
            dur = max(8, int(args.duration / 2))
            spec = (f"127.0.0.1=degrade@t={t0}s:"
                    f"{args.sync_degrade_mbit:g}mbit/{dur}s")
            # a raw --chaos map owns the schedule; the degrade only rides
            # when the operator did not script their own
            chaos_env[0].setdefault("PCCLT_WIRE_CHAOS_MAP", spec)
            print(f"sync-churn: scheduled seeder-edge degrade on peer 0 "
                  f"({spec})", flush=True)
        for i in range(args.peers):
            chaos_args.setdefault(i, []).extend(sync_args)

    if args.fleet_scale > 0 and args.metrics_port is None:
        print("--fleet-scale requires --metrics-port (the summary gates on "
              "the scrape)", flush=True)
        return 2

    master = MasterProc(args.master_port, args.journal, args.metrics_port)

    # fleet-scale digest bot (docs/09): one daemon thread drives the native
    # flood in short rounds so a master assassination mid-soak just costs
    # one failed round — the next round's observers reconnect
    fleet_stop = threading.Event()
    fleet_sent = [0]
    fleet_failed_rounds = [0]

    def fleet_bot() -> None:
        from pccl_tpu_torch.comm import _native
        lib = _native.load()
        while not fleet_stop.is_set():
            sent = ctypes.c_uint64(0)
            wall = ctypes.c_double(0.0)
            rc = lib.pccltDigestFlood(
                b"127.0.0.1", args.master_port, args.fleet_scale,
                args.fleet_edges, args.fleet_hz, 5.0,
                min(8, max(1, args.fleet_scale // 64)),
                ctypes.byref(sent), ctypes.byref(wall))
            fleet_sent[0] += sent.value
            if rc != 0:
                fleet_failed_rounds[0] += 1
                time.sleep(1.0)  # master probably down; back off one beat

    fleet_thread = None
    if args.fleet_scale > 0:
        fleet_thread = threading.Thread(target=fleet_bot, daemon=True)
        fleet_thread.start()

    peers: list[Peer] = []
    seed = 1
    total_relaunches = 0
    master_restarts = 0
    master_downtime_s: list[float] = []  # SIGKILL -> listening again
    retired_steps = 0  # steps of peers that died; keeps the total monotone
    retired_resumes = 0
    retired_rejoins = 0
    next_master_kill = (time.time() + args.master_kill_interval
                        if args.master_kill_interval > 0 else None)
    # chaos accounting, folded across peer lives (relaunches reset stats)
    chaos_acc = {"faults_armed": 0, "faults_activated": 0, "failovers": 0,
                 "relays": 0, "relay_forwarded": 0, "dup_bytes": 0,
                 "suspects": 0, "confirms": 0, "aborted": 0}
    # churn-sync accounting (docs/04), folded the same way. Since the chunk
    # plane rides the pooled p2p conns, the per-edge stripe/watchdog/relay
    # counters now cover sync bytes too — fold them into the summary so the
    # CI lane can gate on "the hardened transport actually engaged".
    sync_acc = {"chunks_fetched": 0, "chunks_resourced": 0, "chunks_dup": 0,
                "promotions": 0, "seeder_deaths_survived": 0,
                "legacy_syncs": 0, "syncs_ok": 0, "syncs_failed": 0,
                "stripe_windows": 0, "stripe_bytes": 0, "suspects": 0,
                "relays": 0, "relay_bytes": 0, "aborted": 0, "h1_launches": 0}
    sync_events = {"floods": 0, "seeder_kills": 0, "wrong": 0}

    def fold_sync(stats: dict) -> None:
        c = stats.get("counters", {}) if stats else {}
        sync_acc["chunks_fetched"] += c.get("ss_chunks_fetched", 0)
        sync_acc["chunks_resourced"] += c.get("ss_chunks_resourced", 0)
        sync_acc["chunks_dup"] += c.get("ss_chunks_dup", 0)
        sync_acc["promotions"] += c.get("ss_seeder_promotions", 0)
        sync_acc["seeder_deaths_survived"] += c.get("ss_seeders_lost", 0)
        sync_acc["legacy_syncs"] += c.get("ss_legacy_syncs", 0)
        sync_acc["syncs_ok"] += c.get("syncs_ok", 0)
        sync_acc["syncs_failed"] += c.get("syncs_failed", 0)
        sync_acc["aborted"] += c.get("collectives_aborted", 0)
        # the card's peers: H1's launches in that peer life
        sync_acc["h1_launches"] += stats.get("h1_launches", 0) if stats else 0
        for e in (stats.get("edges", {}) if stats else {}).values():
            sync_acc["stripe_windows"] += e.get("tx_stripe_windows", 0)
            sync_acc["stripe_bytes"] += e.get("tx_stripe_bytes", 0)
            sync_acc["suspects"] += e.get("wd_suspects", 0)
            sync_acc["relays"] += e.get("wd_relays", 0)
            sync_acc["relay_bytes"] += e.get("rx_relay_bytes", 0)

    def fold_chaos(stats: dict) -> None:
        if not stats:
            return
        c = stats.get("counters", {})
        chaos_acc["relay_forwarded"] += c.get("relay_forwarded", 0)
        chaos_acc["aborted"] += c.get("collectives_aborted", 0)
        chaos_acc["faults_armed"] += c.get("chaos_faults_armed", 0)
        chaos_acc["faults_activated"] += c.get("chaos_faults_activated", 0)
        for e in stats.get("edges", {}).values():
            chaos_acc["failovers"] += e.get("wd_reissues", 0)
            chaos_acc["relays"] += e.get("wd_relays", 0)
            chaos_acc["dup_bytes"] += e.get("dup_bytes", 0)
            chaos_acc["suspects"] += e.get("wd_suspects", 0)
            chaos_acc["confirms"] += e.get("wd_confirms", 0)

    try:
        for i in range(args.peers):
            peers.append(Peer(args.master_port, i, args.base_port + i * 16,
                              args.die_prob, seed, chaos_env.get(i),
                              args.count, chaos_args.get(i), args.device))
            seed += 1
        deadline = time.time() + args.duration
        last_progress = time.time()
        last_total = 0
        # churn-sync schedule (docs/04): one joiner flood at 1/3 duration,
        # one busiest-seeder kill at 2/3
        flood_at = (time.time() + args.duration / 3
                    if args.sync_churn > 0 else None)
        seeder_kill_at = (time.time() + 2 * args.duration / 3
                          if args.sync_churn > 0 else None)
        while time.time() < deadline:
            time.sleep(1.0)
            # monotone: a relaunched peer restarts at 0, so dead peers'
            # counts are folded into retired_steps at relaunch time
            total = retired_steps + sum(p.steps for p in peers)
            if total > last_total:
                last_total = total
                last_progress = time.time()
            if time.time() - last_progress > args.stall_seconds:
                print(f"STALL: no progress for {args.stall_seconds}s "
                      f"(total steps {total})", flush=True)
                return 1
            # scheduled master assassination (the whole point of the
            # master-churn soak): SIGKILL, leave it dead for a window,
            # restart on the same port, peers must rejoin
            if next_master_kill is not None and time.time() >= next_master_kill:
                master_restarts += 1
                print(f"killing master (#{master_restarts}); down for "
                      f"{args.master_down_time:.1f}s", flush=True)
                t_kill = time.time()
                master.kill()
                time.sleep(args.master_down_time)
                master = MasterProc(args.master_port, args.journal,
                                    args.metrics_port)
                down = time.time() - t_kill
                master_downtime_s.append(down)
                print(f"master restarted (downtime {down:.2f}s)", flush=True)
                next_master_kill = time.time() + args.master_kill_interval
            elif not master.alive():
                # master died on its own: that's a soak failure
                print(f"MASTER DIED unexpectedly (exit code "
                      f"{master.proc.returncode})", flush=True)
                return 1
            # churn-sync events: flood half the peers at once (they come
            # back as simultaneous cold joiners), then kill the peer the
            # STATS lines prove is the busiest seeder — mid-serve death,
            # the exact failure the chunk plane exists to survive
            if flood_at is not None and time.time() >= flood_at:
                flood_at = None
                victims = peers[1:1 + max(1, args.peers // 2)]
                print(f"JOINER FLOOD: SIGKILLing {len(victims)} peers at "
                      "once", flush=True)
                sync_events["floods"] += 1
                for p in victims:
                    p.kill()
            if seeder_kill_at is not None and time.time() >= seeder_kill_at:
                seeder_kill_at = None

                def served_of(p):
                    return ((p.stats or {}).get("counters", {})
                            .get("ss_seeder_chunks_served", 0))
                busiest = max((p for p in peers if p.alive()),
                              key=served_of, default=None)
                if busiest is not None:
                    print(f"SEEDER KILL: peer {busiest.idx} "
                          f"(served={served_of(busiest)} chunks)", flush=True)
                    sync_events["seeder_kills"] += 1
                    busiest.kill()
            # relaunch the dead (the churn is the point)
            for i, p in enumerate(peers):
                if not p.alive():
                    total_relaunches += 1
                    retired_steps += p.steps
                    retired_resumes += p.resumes
                    retired_rejoins += p.rejoins
                    fold_chaos(p.stats)
                    fold_sync(p.stats)
                    sync_events["wrong"] += p.wrong_sync
                    print(f"peer {p.idx} died (steps={p.steps}); relaunching "
                          f"(#{total_relaunches})", flush=True)
                    peers[i] = Peer(args.master_port, p.idx, p.base_port,
                                    args.die_prob, seed,
                                    chaos_env.get(p.idx), args.count,
                                    chaos_args.get(p.idx), args.device)
                    seed += 1
        total = retired_steps + sum(p.steps for p in peers)
        if total == 0:
            print("SOAK FAILED: zero heartbeat steps over the whole run",
                  flush=True)
            return 1
        if next_master_kill is not None and master_restarts == 0:
            print("SOAK FAILED: master churn requested but never exercised",
                  flush=True)
            return 1
        resumes = retired_resumes + sum(p.resumes for p in peers)
        rejoins = retired_rejoins + sum(p.rejoins for p in peers)
        if master_downtime_s:
            print(f"master downtime: "
                  f"{sum(master_downtime_s) / len(master_downtime_s):.2f}s "
                  f"mean / {max(master_downtime_s):.2f}s max over "
                  f"{len(master_downtime_s)} restarts", flush=True)
        print(f"recovery mix: {resumes} session resumes, {rejoins} full "
              f"rejoins (journal={'on' if args.journal else 'off'})",
              flush=True)
        if args.metrics_port is not None:
            # fleet-health exit summary: one line an operator (or the CI
            # lane's grep) can eyeball — what the MASTER thinks the world
            # looked like when the soak ended
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{args.metrics_port}/health",
                        timeout=5) as r:
                    h = json.load(r)
                up = sum(1 for p in h["peers"] if p["up"])
                stragglers = sum(1 for e in h["edges"] if e["straggler"])
                print(f"FLEET HEALTH: epoch={h['epoch']} "
                      f"world={h['world_size']} peers_up={up}/"
                      f"{len(h['peers'])} digests={h['telemetry_digests']} "
                      f"stragglers={stragglers}", flush=True)
            except (OSError, ValueError, KeyError) as e:
                # the summary is informational: a malformed /health body
                # must not fail a soak that already passed
                print(f"FLEET HEALTH: scrape failed "
                      f"({type(e).__name__}: {e})", flush=True)
        if args.chaos:
            for p in peers:
                fold_chaos(p.stats)
            reopts = "n/a"
            if args.metrics_port is not None:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{args.metrics_port}/metrics",
                            timeout=5) as r:
                        for line in r.read().decode().splitlines():
                            if line.startswith(
                                    "pcclt_master_stragglers_flagged_total "):
                                reopts = line.split()[-1]
                except OSError:
                    pass
            print(f"CHAOS SUMMARY: faults_armed={chaos_acc['faults_armed']} "
                  f"activated={chaos_acc['faults_activated']} "
                  f"failovers={chaos_acc['failovers']} "
                  f"relays={chaos_acc['relays']} "
                  f"relay_forwarded={chaos_acc['relay_forwarded']} "
                  f"suspects={chaos_acc['suspects']} "
                  f"confirms={chaos_acc['confirms']} "
                  f"dup_bytes={chaos_acc['dup_bytes']} "
                  f"reopts={reopts} aborted={chaos_acc['aborted']}",
                  flush=True)
            if args.die_prob == 0 and chaos_acc["aborted"] > 0:
                # scripted faults alone must never abort an op: the ladder
                # (watchdog -> failover/relay -> re-opt) limps home instead
                print("CHAOS FAILED: scripted faults aborted collectives",
                      flush=True)
                return 1
        if args.sync_churn > 0:
            live_failed = 0
            for p in peers:
                fold_sync(p.stats)
                sync_events["wrong"] += p.wrong_sync
                live_failed += ((p.stats or {}).get("counters", {})
                                .get("syncs_failed", 0))
            print(f"SYNC SUMMARY: "
                  f"chunks_fetched={sync_acc['chunks_fetched']} "
                  f"resourced={sync_acc['chunks_resourced']} "
                  f"dup={sync_acc['chunks_dup']} "
                  f"promotions={sync_acc['promotions']} "
                  f"seeder_deaths_survived={sync_acc['seeder_deaths_survived']} "
                  f"legacy_syncs={sync_acc['legacy_syncs']} "
                  f"syncs_ok={sync_acc['syncs_ok']} "
                  f"syncs_failed={sync_acc['syncs_failed']} "
                  f"stripe_windows={sync_acc['stripe_windows']} "
                  f"stripe_bytes={sync_acc['stripe_bytes']} "
                  f"suspects={sync_acc['suspects']} "
                  f"relays={sync_acc['relays']} "
                  f"relay_bytes={sync_acc['relay_bytes']} "
                  f"floods={sync_events['floods']} "
                  f"seeder_kills={sync_events['seeder_kills']} "
                  f"wrong={sync_events['wrong']} "
                  f"aborted={live_failed} "
                  f"collective_aborts={sync_acc['aborted']}"
                  + (f" h1_launches={sync_acc['h1_launches']}" if on_card else ""),
                  flush=True)
            if sync_events["wrong"] > 0:
                print("SYNC FAILED: bit-wrong shared-state adoption",
                      flush=True)
                return 1
            if live_failed > 0:
                # the churn-proof claim: scheduled seeder death + joiner
                # floods never FAIL a round for a surviving peer — the
                # chunk plane re-sources around every loss
                print("SYNC FAILED: unrecovered sync failures on live peers",
                      flush=True)
                return 1
            if sync_events["floods"] == 0 or sync_events["seeder_kills"] == 0:
                print("SYNC FAILED: churn schedule never fired", flush=True)
                return 1
            if sync_acc["syncs_failed"] > 0:
                # folded across every peer life: a sync round must never
                # FAIL under scheduled churn — the chunk plane re-sources
                # around deaths and degrades (collective_aborts is NOT
                # gated: SIGKILLing a peer mid-allreduce legitimately
                # aborts the in-flight op, which survivors then retry)
                print("SYNC FAILED: sync rounds failed under churn",
                      flush=True)
                return 1
            if args.sync_degrade_mbit > 0 and sync_acc["suspects"] == 0:
                # the degrade exists to prove the serve-side watchdog sees
                # sync traffic; a soak where it never tripped proves nothing
                print("SYNC FAILED: scheduled seeder-edge degrade never "
                      "tripped the watchdog", flush=True)
                return 1
            if on_card and sync_acc["h1_launches"] == 0:
                # the card's lane exists to run H1 on every sync
                print("SYNC FAILED: no peer hashed its shared state with H1",
                      flush=True)
                return 1
            if int(os.environ.get("PCCLT_STRIPE_CONNS", "1")) > 1 \
                    and sync_acc["stripe_bytes"] == 0:
                print("SYNC FAILED: stripe conns requested but no sync "
                      "bytes were striped", flush=True)
                return 1
        if args.fleet_scale > 0:
            fleet_stop.set()
            if fleet_thread is not None:
                fleet_thread.join(timeout=30)
            drops = lint_errs = "n/a"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{args.metrics_port}/metrics",
                        timeout=10) as r:
                    text = r.read().decode()
                for line in text.splitlines():
                    if line.startswith(
                            "pcclt_master_digest_queue_dropped_total "):
                        drops = line.split()[-1]
                from pccl_tpu_torch.comm import promlint
                lint_errs = str(len(promlint.lint(text)))
            except OSError:
                pass
            print(f"FLEET SCALE: observers={args.fleet_scale} "
                  f"digests_pushed={fleet_sent[0]} "
                  f"failed_rounds={fleet_failed_rounds[0]} "
                  f"queue_drops={drops} promlint_violations={lint_errs}",
                  flush=True)
            if fleet_sent[0] == 0:
                print("FLEET SCALE FAILED: digest bot never landed a round",
                      flush=True)
                return 1
            if lint_errs not in ("n/a", "0"):
                print("FLEET SCALE FAILED: /metrics is not valid "
                      "prometheus text", flush=True)
                return 1
        print(f"SOAK PASSED: {total} heartbeat steps, "
              f"{total_relaunches} relaunches, "
              f"{master_restarts} master restarts in {args.duration:.0f}s",
              flush=True)
        return 0
    finally:
        fleet_stop.set()
        for p in peers:
            p.kill()
        master.kill()


if __name__ == "__main__":
    sys.exit(main())
