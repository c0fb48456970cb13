"""The reference's inner steps and outer step.

AdamW as the port documents its step (parallel/train.py: betas 0.9 and
0.95, eps 1e-8, weight decay 0.1 on every parameter, decoupled, constant
lr): p -= lr wd p; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).

The outer step, DiLoCo's with Nesterov momentum (zero before the first):
delta = mean over peers of (outer - inner_i); mom = mu mom + delta;
outer -= lr (delta + mu mom).

`store` is the precision the parameters, AdamW's state and the outer
state are kept in between steps: float32 is the reference; bfloat16 is
the control, the step below the configuration's fp32 parameters.
"""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import model

BETAS, EPS, WEIGHT_DECAY = (0.9, 0.95), 1e-8, 0.1


def _keep(t: torch.Tensor, store) -> torch.Tensor:
    return t if store == torch.float32 else t.to(store).float()


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.reshape(-1), dtype=torch.float64))


def follow(cfg: dict, traffic: dict, seed: int, ranks: list, device,
           steps: int, store=torch.float32, keep_params: bool = False,
           fault=None) -> dict:
    """The first `steps` steps from the seed's weights, on the batches of
    the peers in `ranks` (one rank: a DiLoCo peer's own steps; several: a
    DDP step on their mean gradient). Returns each step's loss (the mean
    over the ranks), each leaf's first-gradient norm, and each leaf's change
    over the steps; with keep_params the parameters after them. fault
    plants one of faults.FAULTS in the reference put in the program's
    place: stale_step updates nothing, half_batch takes half the rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T, lr = traffic["batch"], traffic["block"], traffic["inner_lr"]
    p0 = weights.init_params(cfg, seed, device)
    params = {n: _keep(t.clone(), store).requires_grad_(True) for n, t in p0.items()}
    feeds = [weights.Batches(seed, r, B, T, cfg["vocab_size"], device,
                             traffic.get("token_law")) for r in ranks]
    m = {n: torch.zeros_like(t) for n, t in p0.items()}
    v = {n: torch.zeros_like(t) for n, t in p0.items()}
    b1, b2 = BETAS
    losses, grad_norms = [], None
    for t in range(1, steps + 1):
        grads, loss_sum = None, 0.0
        for feed in feeds:
            tok, tgt = feed.next()
            if fault == "half_batch":
                tok, tgt = tok[:B // 2], tgt[:B // 2]
            loss = model.loss(params, tok, tgt, cfg)
            g = torch.autograd.grad(loss, list(params.values()))
            loss_sum += float(loss.detach())
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            del loss, g
        grads = {n: gi / len(feeds) for n, gi in zip(params, grads)}
        losses.append(loss_sum / len(feeds))
        if t == 1:
            grad_norms = {n: _norm(g) * (fault != "stale_step")
                          for n, g in grads.items()}
        if fault == "stale_step":
            continue
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                p.mul_(1 - lr * WEIGHT_DECAY)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(EPS)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                p.copy_(_keep(p, store))
                m[n].copy_(_keep(m[n], store))
                v[n].copy_(_keep(v[n], store))
        del grads
    with torch.no_grad():
        change = {n: _norm(params[n] - p0[n]) for n in params}
    out = {"losses": losses, "grad_norms": grad_norms, "update_norms": change}
    if keep_params:
        out["params"] = {n: p.detach() for n, p in params.items()}
    return out


def outer_sketch(outer_pre: dict, inner_pre: list, lr: float, mu: float,
                 mom=None) -> tuple:
    """The projections of the new outer parameters after an outer step and
    of the momentum after it, from the projections of the outer parameters,
    of each peer's inner ones and of the momentum before it (None: zero,
    the first step). The step is linear, so it commutes with a projection."""
    new, mom_out = {}, {}
    for n, o in outer_pre.items():
        k = len(o)
        delta = [sum(o[j] - s[n][j] for s in inner_pre) / len(inner_pre)
                 for j in range(k)]
        m = delta if mom is None else [mu * mom[n][j] + delta[j] for j in range(k)]
        new[n] = [o[j] - lr * (delta[j] + mu * m[j]) for j in range(k)]
        mom_out[n] = m
    return new, mom_out


@torch.no_grad()
def outer_step(outer: dict, inners: list, lr: float, mu: float,
               store=torch.float32, mom=None) -> tuple:
    """outer_sketch on whole tensors, its state kept in `store`: (the new
    outer parameters, the momentum)."""
    out, mom_out = {}, {}
    for n, o in outer.items():
        o = _keep(o, store)
        delta = _keep(sum(o - _keep(i[n], store) for i in inners) / len(inners), store)
        m = delta if mom is None else _keep(mu * mom[n] + delta, store)
        out[n] = _keep(o - lr * (delta + mu * m), store)
        mom_out[n] = m
    return out, mom_out
