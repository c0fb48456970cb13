"""The comparison that decides `correct`: numbers, each against its limit
from limits/<cell>.json.

The gaps are taken by the worst leaf (a parameter tensor): the gap between
the program's norm of a leaf and the reference's, over the reference's
norm of that leaf or of the median leaf, whichever is larger, since some
leaves are all but still. Leaves whose first gradient in the reference is
under a thousandth of the median leaf's move under AdamW by round-off
alone and are left out of the change.
"""

from __future__ import annotations

import math
import statistics

SMALL_GRAD = 1e-3


def _rms(xs) -> float:
    return math.sqrt(sum(x * x for x in xs) / len(xs))


def leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    leaves = sorted(ref) if leaves is None else leaves
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves)


def moving_leaves(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return sorted(n for n, g in ref_grad.items() if g >= SMALL_GRAD * med)


def loss_gap(prog: list, ref: list) -> float:
    """|first step's loss - reference's| in nats. The later steps' losses
    are printed but not compared: after AdamW's first, sign-like update,
    rounding flips the sign of the update of the leaves' smallest
    gradients, so the two sides' second losses part by a seed-dependent
    amount (1e-5 to 1.2e-2 nats at 32k, from 2 % to 7 % of the loss's
    move); the update itself is compared by update_gap."""
    return abs(prog[0] - ref[0])


def step_numbers(prog_check: dict, ref: dict) -> dict:
    """loss_gap, grad_gap, update_gap."""
    return {
        "loss_gap": loss_gap(prog_check["losses"], ref["losses"]),
        "grad_gap": leaf_gap(prog_check["grad_norms"], ref["grad_norms"]),
        "update_gap": leaf_gap(prog_check["update_norms"], ref["update_norms"],
                               moving_leaves(ref["grad_norms"])),
    }


def outer_gap(new: dict, expect: dict, outer_pre: dict) -> float:
    """Worst leaf: rms over the projections of (program - reference) after
    the outer step, over the rms of the reference's change (the rms of K
    Gaussian projections of a vector estimates its norm)."""
    scale = {n: _rms([a - b for a, b in zip(outer_pre[n], expect[n])]) for n in expect}
    med = statistics.median(scale.values())
    return max(_rms([a - b for a, b in zip(new[n], expect[n])]) / max(scale[n], med, 1e-30)
               for n in expect)


def mismatches(sketches: list) -> int:
    """Leaves whose projections differ, bit for bit, between peers."""
    first = sketches[0]
    return sum(1 for n in first if any(s[n] != first[n] for s in sketches[1:]))


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits) and \
        all(math.isfinite(v) for v in numbers.values())

