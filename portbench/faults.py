"""Faults planted under a run, for the tests that must see `correct` come
out false, and for reading each fault's numbers on the card
(run.py --fault NAME). None leaves the program as it is.

- stale_step: the train step computes its loss and gradients and returns
  the state unchanged (no optimizer step);
- half_batch: the step leaves out half of the batch's rows and takes the
  mean over the rest;
- no_exchange: the peer's collective is left out: Diloco without a ring
  (each peer applies its own pseudo-gradient);
- zero_momentum: the outer optimizer's momentum is zeroed before every
  outer step, so each starts from none (the outer state not carried);
- stale_outer: the outer steps after set-up's return at once, leaving
  the outer state unchanged (the window's outer steps do nothing).

stale_step and half_batch can also be planted in the reference put in
the program's place (checks/<mode>.control); the others only under the
program.
"""

from __future__ import annotations

FAULTS = ("stale_step", "half_batch", "no_exchange", "zero_momentum", "stale_outer")
REFERENCE_FAULTS = ("stale_step", "half_batch")


def wrap_step(fault, step_fn, loss_and_grad):
    """step_fn with `fault` planted under it; loss_and_grad is the same
    step without its update (parallel/train.build_loss_and_grad)."""
    if fault == "stale_step":
        return loss_and_grad
    if fault == "half_batch":
        def half(state, tokens, targets):
            b = tokens.shape[0] // 2
            return step_fn(state, tokens[:b], targets[:b])
        return half
    return step_fn


def wrap_outer(fault, dl, setup_steps: int):
    """Diloco.outer_step of `dl` with `fault` planted under it; set-up
    makes the first `setup_steps` calls."""
    step = dl.outer_step
    if fault == "zero_momentum":
        def fresh(params):
            dl._momentum_vec.zero_()
            return step(params)
        return fresh
    if fault == "stale_outer":
        calls = [0]

        def still(params):
            calls[0] += 1
            return step(params) if calls[0] <= setup_steps else params
        return still
    return step
