"""Sync DiLoCo: the reference follows one peer's checked inner steps from
the seed, drawn from the seed, and set-up's two outer steps from the
peers' projections (it can only follow those from the program's own
state: the inner steps that precede them are checked on their own).

- loss_gap, grad_gap, update_gap: check.step_numbers of the sampled peer;
- outer_gap: the worst peer's new parameters after the first outer step
  against that step applied to the projections of the outer and inner
  parameters;
- outer2_gap: the same for the second outer step, whose momentum carries
  the first's pseudo-gradient;
- window_still: leaves of the outer vector that no outer step of the
  window moved (its projections bit-equal before and after the window);
- start_mismatch, final_mismatch: leaves whose outer projections differ
  between peers before the first outer step and after the window.
"""

from __future__ import annotations

import sys

from portbench import check
from portbench.reference import train


def sampled_peer(seed: int, peers: int) -> int:
    return seed % peers


def numbers(cell, seed: int, records: list, device) -> dict:
    tr = cell.traffic
    peer = sampled_peer(seed, len(records))
    ref = train.follow(cell.config, tr, seed, [peer], device, tr["checked_steps"])
    out = check.step_numbers(records[peer]["check"], ref)
    sys.stderr.write(f"peer {peer} losses {records[peer]['check']['losses']} "
                     f"reference {ref['losses']}\n")
    checks = [r["check"] for r in records]
    gaps = outer_gaps(checks, tr["outer_lr"], tr["outer_momentum"])
    sys.stderr.write(f"outer gaps by peer {gaps}\n")
    out["outer_gap"] = max(g[0] for g in gaps)
    out["outer2_gap"] = max(g[1] for g in gaps)
    out["window_still"] = max(still(c["outer_mid"], c["final"]) for c in checks)
    out["start_mismatch"] = check.mismatches([c["outer_pre"] for c in checks])
    out["final_mismatch"] = check.mismatches([c["final"] for c in checks])
    return out


def outer_gaps(checks: list, lr: float, mu: float) -> list:
    """Each peer's (outer_gap, outer2_gap): its parameters after set-up's
    two outer steps against those steps applied, momentum carried, to the
    projections of peer 0's outer parameters and every peer's inner ones."""
    o0, o1 = checks[0]["outer_pre"], checks[0]["outer_post"]
    expect1, mom = train.outer_sketch(o0, [c["inner_pre"] for c in checks], lr, mu)
    expect2, _ = train.outer_sketch(o1, [c["inner_pre2"] for c in checks], lr, mu, mom)
    return [[check.outer_gap(c["outer_post"], expect1, o0),
             check.outer_gap(c["outer_post2"], expect2, o1)] for c in checks]


def still(before: dict, after: dict) -> int:
    """Leaves whose projections are bit-equal before and after."""
    return sum(1 for n in before if before[n] == after[n])


def control(cell, seed: int, device, fault=None) -> dict:
    """The control's numbers: the reference put in the program's place and
    kept in bfloat16 (parameters, AdamW's state, the outer state), judged
    as the program is. With `fault` (faults.REFERENCE_FAULTS), instead that
    fault planted in the reference put in the program's place, in float32.
    Needs no ring and no window. The second outer period repeats the
    first's pseudo-gradient from the new outer parameters (the reference
    follows no inner step after an outer step). One peer's exchange is
    the identity, so the control has none to leave out."""
    import torch

    from portbench import faults, probes, weights

    if fault is not None and fault not in faults.REFERENCE_FAULTS:
        raise ValueError(f"{fault} is planted only under the program (run.py --fault)")
    tr = cell.traffic
    lr, mu = tr["outer_lr"], tr["outer_momentum"]
    peers = tr["peers"]
    steps = tr["checked_steps"]
    base = [train.follow(cell.config, tr, seed, [r], device, steps, keep_params=True)
            for r in range(peers)]
    peer = sampled_peer(seed, peers)
    store = torch.float32 if fault else torch.bfloat16
    low = train.follow(cell.config, tr, seed, [peer], device, steps, store=store,
                       fault=fault)
    out = check.step_numbers(low, base[peer])
    outer = weights.init_params(cell.config, seed, device)
    names = sorted(outer)

    def sk(t):
        return probes.sketch(t, names, seed)

    inners = [b["params"] for b in base]
    o1, mom = train.outer_step(outer, inners, lr, mu, store=store)
    inners2 = [{n: o1[n] + i[n] - outer[n] for n in names} for i in inners]
    o2, _ = train.outer_step(o1, inners2, lr, mu, store=store, mom=mom)
    sk_outer, sk_o1 = sk(outer), sk(o1)
    expect1, mom_sk = train.outer_sketch(sk_outer, [sk(i) for i in inners], lr, mu)
    expect2, _ = train.outer_sketch(sk_o1, [sk(i) for i in inners2], lr, mu, mom_sk)
    out["outer_gap"] = check.outer_gap(sk_o1, expect1, sk_outer)
    out["outer2_gap"] = check.outer_gap(sk(o2), expect2, sk_o1)
    out["window_still"] = out["start_mismatch"] = out["final_mismatch"] = 0
    return out
