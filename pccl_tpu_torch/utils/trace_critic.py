"""Cross-peer critical-path attribution over PCCLT flight-recorder traces.

The port's copy of `analyze_files` and the helpers it needs from
tools/trace_critic/__init__.py (the repo's `tools/` is not packaged, so an
installed port could not import it); comm/native_bench.py's attribution
leg calls it. For every collective it walks each peer's spans
(``commence_wait`` → ``op_setup`` → per-stage
``rs_stage``/``ag_stage``/``gather_stage``, each carrying its ``stall_ns``
and the inbound edge endpoint in ``detail``), reconstructs the binding
chain, and classifies the op:

* **setup-dominated** — master consensus + link setup bound the op (the
  ``commence_wait``/``op_setup`` residual);
* **codec-limited** — quantize/dequantize kernels bound it;
* **stall-straggler** — ONE edge's wire-stall bound it (the edge is
  named: the actionable verdict per arXiv 2606.01680);
* **wire-limited** — stall spread across edges (the pipe itself, not a
  specific hop);
* **balanced** — compute/overlap bound; nothing pathological.

Attribution is duration-based, so no cross-peer clock alignment is
needed; the per-op *binding peer* is simply the one whose op span is
longest. Coverage = attributed segment time / per-peer wall time — the
acceptance gate asserts >= 0.95, i.e. the timeline decomposition explains
the op, it doesn't sample it.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Dict, List, Sequence

OP_NAMES = ("allreduce", "allgather")
STAGE_NAMES = ("rs_stage", "ag_stage", "gather_stage")

# verdict thresholds (fractions of the binding peer's wall time)
SETUP_FRAC = 0.35
CODEC_FRAC = 0.30
STALL_FRAC = 0.35
# a single edge owning this share of the binding peer's stall names it
STRAGGLER_EDGE_SHARE = 0.60


def _events_of(doc: Any) -> List[dict]:
    evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in evs if isinstance(e, dict)]


def _collect_peer(events: Sequence[dict]) -> Dict[tuple, dict]:
    """(epoch, seq) -> this peer's per-collective record (times in µs)."""
    out: Dict[tuple, dict] = {}

    def rec(args) -> dict:
        key = (int(args.get("epoch", 0)), int(args["seq"]))
        return out.setdefault(key, {
            "op_start": None, "op_end": None, "op_us": 0.0,
            "cw_start": None, "cw_us": 0.0, "setup_us": 0.0,
            "stages": [], "quant_us": 0.0, "dequant_us": 0.0,
            "drain_us": 0.0, "drain_edge": "",
            "wd_confirm": set(), "wd_suspect": set(),
        })

    for e in events:
        args = e.get("args") or {}
        if "seq" not in args:
            continue
        name = e.get("name")
        ts = float(e.get("ts", 0.0))
        dur = float(e.get("dur", 0.0))
        if e.get("ph") == "X" and name in OP_NAMES:
            r = rec(args)
            # keep the longest op span per key (retries overwrite shorter)
            if dur >= r["op_us"]:
                r.update(op_start=ts, op_end=ts + dur, op_us=dur)
        elif e.get("ph") == "X" and name == "commence_wait":
            r = rec(args)
            r["cw_start"] = ts if r["cw_start"] is None else min(r["cw_start"], ts)
            r["cw_us"] += dur
        elif e.get("ph") == "X" and name == "op_setup":
            rec(args)["setup_us"] += dur
        elif e.get("ph") == "X" and name == "zombie_drain":
            # post-failover wait for stalled direct copies to crawl out at
            # the degraded rate — charged to the OUTBOUND edge
            r = rec(args)
            r["drain_us"] += dur
            r["drain_edge"] = args.get("detail") or r["drain_edge"]
        elif e.get("ph") == "X" and name in STAGE_NAMES:
            rec(args)["stages"].append({
                "stage": int(args.get("stage", -1)),
                "kind": name,
                "us": dur,
                "stall_us": float(args.get("stall_ns", 0)) / 1e3,
                "edge": args.get("detail") or "",
            })
        elif name == "quantize":
            rec(args)["quant_us"] += float(args.get("ns", 0)) / 1e3
        elif name == "dequantize":
            rec(args)["dequant_us"] += float(args.get("ns", 0)) / 1e3
        elif name in ("edge_confirm", "edge_suspect"):
            # the data plane's own watchdog verdict, carrying the OUTBOUND
            # edge endpoint in detail — the strongest attribution signal
            # (in a coupled ring every peer stalls; only the watchdog
            # names the hop that caused it)
            edge = args.get("detail") or ""
            if edge:
                kind = "wd_confirm" if name == "edge_confirm" else "wd_suspect"
                rec(args)[kind].add(edge)
    return {k: v for k, v in out.items() if v["op_start"] is not None}


def _peer_breakdown(r: dict) -> dict:
    """Attribute one peer's collective: wall, segments, coverage."""
    start = r["cw_start"] if r["cw_start"] is not None else r["op_start"]
    wall = max(r["op_end"] - start, 1e-9)
    stage_us = sum(s["us"] for s in r["stages"])
    stall_us = sum(s["stall_us"] for s in r["stages"])
    per_edge_stall: Dict[str, float] = defaultdict(float)
    per_edge_stage: Dict[str, float] = defaultdict(float)
    for s in r["stages"]:
        per_edge_stall[s["edge"]] += s["stall_us"]
        per_edge_stage[s["edge"]] += s["us"]
    if r["drain_us"]:
        # the drain is a stall on the outbound hop in all but name
        per_edge_stall[r["drain_edge"]] += r["drain_us"]
        stall_us += r["drain_us"]
    attributed = r["cw_us"] + r["setup_us"] + stage_us + r["drain_us"]
    return {
        "wall_us": wall,
        "coverage": min(attributed / wall, 1.0),
        "cw_us": r["cw_us"],
        "setup_us": r["setup_us"],
        "stage_us": stage_us,
        "stall_us": stall_us,
        "drain_us": r["drain_us"],
        "codec_us": r["quant_us"] + r["dequant_us"],
        "per_edge_stall": dict(per_edge_stall),
        "per_edge_stage": dict(per_edge_stage),
        "n_stages": len(r["stages"]),
        "wd_confirm": sorted(r["wd_confirm"]),
        "wd_suspect": sorted(r["wd_suspect"]),
    }


def _classify(b: dict, members: "Dict[str, dict]") -> tuple:
    """(verdict, named_edge) for a binding peer's breakdown.

    The straggler test is FLEET-relative: on a healthy wire-paced ring
    every peer stalls comparably on its own inbound hop (the wire is the
    bound — that's wire-limited, not a straggler); only when one directed
    hop owns most of the op's stall fleet-wide is it named."""
    wall = b["wall_us"]
    setup_frac = (b["cw_us"] + b["setup_us"]) / wall
    codec_frac = b["codec_us"] / wall
    stall_frac = b["stall_us"] / wall
    if setup_frac > SETUP_FRAC:
        return "setup-dominated", ""
    if codec_frac >= CODEC_FRAC:
        return "codec-limited", ""
    if stall_frac >= STALL_FRAC:
        fleet_total = sum(m["stall_us"] for m in members.values())
        fleet_edges: Dict[tuple, float] = defaultdict(float)
        for lbl, m in members.items():
            for edge, us in m["per_edge_stall"].items():
                fleet_edges[(lbl, edge)] += us
        if fleet_total > 0 and fleet_edges:
            (_, edge), top = max(fleet_edges.items(), key=lambda kv: kv[1])
            if top >= STRAGGLER_EDGE_SHARE * fleet_total:
                return "stall-straggler", edge
        return "wire-limited", ""
    return "balanced", ""


def analyze_docs(docs: Sequence[Any],
                 labels: "Sequence[str] | None" = None) -> dict:
    labels = list(labels) if labels else [f"peer{i}" for i in range(len(docs))]
    per_peer = {labels[i]: _collect_peer(_events_of(d))
                for i, d in enumerate(docs)}
    keys = sorted({k for recs in per_peer.values() for k in recs})

    collectives: List[dict] = []
    verdicts: Counter = Counter()
    edge_stall: Dict[tuple, float] = defaultdict(float)  # (witness, edge)
    edge_stage: Dict[tuple, float] = defaultdict(float)
    phase_totals: Dict[str, float] = defaultdict(float)
    coverages: List[float] = []
    wd_named: Counter = Counter()  # watchdog-confirmed edges across the run

    for key in keys:
        members = {lbl: _peer_breakdown(recs[key])
                   for lbl, recs in per_peer.items() if key in recs}
        if not members:
            continue
        binding = max(members, key=lambda lbl: members[lbl]["wall_us"])
        bb = members[binding]
        verdict, named_edge = _classify(bb, members)
        # watchdog override: the data plane CONFIRMed a specific edge
        # during this collective — in a coupled ring every peer's stall is
        # comparable, so the in-band verdict outranks the stall ranking
        wd_edges = sorted({e for m in members.values()
                           for e in m["wd_confirm"]})
        if wd_edges and verdict in ("wire-limited", "stall-straggler",
                                    "balanced"):
            verdict, named_edge = "stall-straggler", wd_edges[0]
        for e in wd_edges:
            wd_named[e] += 1
        verdicts[verdict] += 1
        coverages.append(min(m["coverage"] for m in members.values()))
        # run-level edge ranking: every peer's witness counts, not just
        # the binding one — a hop binding HALF the ops still dominates
        crit_peer, crit_edge, crit_stall = binding, named_edge, 0.0
        if named_edge:  # a watchdog-named edge is final for this op
            crit_stall = float("inf")
        for lbl, m in members.items():
            in_stage_stall = m["stall_us"] - m["drain_us"]
            phase_totals["commence_wait"] += m["cw_us"]
            phase_totals["op_setup"] += m["setup_us"]
            phase_totals["stage"] += m["stage_us"] - in_stage_stall
            phase_totals["stall"] += in_stage_stall
            phase_totals["drain"] += m["drain_us"]
            # NOTE: codec OVERLAPS the stage bucket (kernels run inside
            # the stage windows) — sum the other five for a disjoint wall
            # decomposition; codec is a cross-cutting view
            phase_totals["codec"] += m["codec_us"]
            for edge, us in m["per_edge_stall"].items():
                edge_stall[(lbl, edge)] += us
                if us > crit_stall:
                    crit_peer, crit_edge, crit_stall = lbl, edge, us
            for edge, us in m["per_edge_stage"].items():
                edge_stage[(lbl, edge)] += us
        collectives.append({
            "epoch": key[0], "seq": key[1],
            "peers": len(members),
            "binding_peer": binding,
            "wall_us": bb["wall_us"],
            "coverage": min(m["coverage"] for m in members.values()),
            "verdict": verdict,
            "critical_edge": crit_edge,
            "critical_witness": crit_peer,
            "fracs": {
                "setup": (bb["cw_us"] + bb["setup_us"]) / bb["wall_us"],
                "codec": bb["codec_us"] / bb["wall_us"],
                "stall": bb["stall_us"] / bb["wall_us"],
            },
            "members": members,
        })

    edges = [{"witness": w, "edge": e, "stall_us": us,
              "stage_us": edge_stage.get((w, e), 0.0)}
             for (w, e), us in sorted(edge_stall.items(),
                                      key=lambda kv: -kv[1])]
    # run-level critical edge: a watchdog-confirmed edge wins outright
    # (the data plane proved the hop); otherwise the top stall witness
    if wd_named:
        crit_edge = wd_named.most_common(1)[0][0]
        crit_wit = "watchdog"
    elif edges and edges[0]["stall_us"] > 0:
        crit_edge, crit_wit = edges[0]["edge"], edges[0]["witness"]
    else:
        crit_edge = crit_wit = ""
    agg = {
        "ops": len(collectives),
        "peers": len(docs),
        "mean_coverage": (sum(coverages) / len(coverages)) if coverages else 0.0,
        "min_coverage": min(coverages) if coverages else 0.0,
        "verdicts": dict(verdicts),
        "edges": edges,
        "wd_confirmed_edges": dict(wd_named),
        "critical_edge": crit_edge,
        "critical_witness": crit_wit,
        "phase_totals_us": dict(phase_totals),
    }
    return {"collectives": collectives, "aggregate": agg}


def analyze_files(paths: Sequence[Path],
                  labels: "Sequence[str] | None" = None) -> dict:
    docs = [json.loads(Path(p).read_text()) for p in paths]
    return analyze_docs(
        docs, list(labels) if labels else [Path(p).stem for p in paths])
