"""Sync DiLoCo, the loop of pccl_tpu_torch/examples/sync_diloco.py: H inner
AdamW steps (parallel/train.build_train_step over models/ and K1-K3), then
one outer step (parallel/diloco.Diloco: flatten, D2H, the ring's AVG over
comm/ and libpcclt.so, H2D, Nesterov), staged through pinned buffers over
loopback TCP as peers on different hosts stage.

Set-up builds the one training state and Diloco of the run from the seed
and drives them through the checked steps: `checked_steps` inner steps
(each loss; the first gradient's per-leaf norm from AdamW's state; the
per-leaf change after them) and one outer step (random projections of the
outer vector, of this peer's inner parameters before it and of the new
parameters after it), then one more inner step and a second outer step,
whose momentum carries the first's (projections of the inner parameters
before it, of the parameters and of the outer vector after it). The
window starts where that outer step ends, so every run holds whole outer
periods; at each period's start the peers vote over the ring whether the
window has closed (a 1-element MAX), so all stop at the same outer step.
Each window outer step is timed on the host clock and, for the spread's
look, by CUDA events on the card.
"""

from __future__ import annotations

import time

import numpy as np

VOTE_TAG = 7
SETUP_OUTER_STEPS = 2


def run(spec: dict, dev) -> dict:
    from pccl_tpu_torch.comm import ReduceOp
    from pccl_tpu_torch.ops import flash_attention as fa
    from pccl_tpu_torch.parallel import train as train_lib
    from pccl_tpu_torch.parallel.diloco import Diloco, DilocoConfig

    from portbench import faults, port, probes, weights
    from portbench.peer import connect, sync

    cfgd, tr = spec["config"], spec["traffic"]
    seed, rank, trace = spec["seed"], spec["rank"], bool(spec["trace"])
    B, T, H = tr["batch"], tr["block"], tr["inner_steps"]
    cfg = port.model_config(cfgd, T)
    state = train_lib.make_train_state(
        seed, cfg, dev, lr=tr["inner_lr"],
        params=weights.init_params(cfgd, seed, dev))
    opts = dict(attn_fn=fa.flash_attention, remat=tr["remat"],
                loss_chunk=tr["loss_chunk"])
    step_fn = faults.wrap_step(
        spec.get("fault"), train_lib.build_train_step(cfg, **opts),
        train_lib.build_loss_and_grad(cfg, **opts))
    feed = weights.Batches(seed, rank, B, T, cfgd["vocab_size"], dev, tr.get("token_law"))
    sync(dev)
    marks_setup = {"state": time.time()}
    # a peer alone on its card has no ring: the chip's share of a DiLoCo
    # run, the outer step without its exchange (D2H, H2D, the apply)
    comm = connect(spec) if spec["world"] > 1 else None
    ring = None if spec.get("fault") == "no_exchange" else comm
    dl = Diloco(ring, state.params,
                DilocoConfig(inner_steps=H, outer_lr=tr["outer_lr"],
                             outer_momentum=tr["outer_momentum"],
                             profile=trace))
    names = dl.codec.names
    outer_step = faults.wrap_outer(spec.get("fault"), dl, SETUP_OUTER_STEPS)
    marks_setup["connected"] = time.time()

    # the checked steps, through the window's own call and feed
    losses, grad = [], None
    for i in range(tr["checked_steps"]):
        tok, tgt = feed.next()
        losses.append(float(step_fn(state, tok, tgt)))
        if i == 0:
            grad = probes.adam_grad_norms(state)
    update = probes.change_norms(state.params, dl.outer_vec, dl.codec)
    outer_pre = probes.sketch_flat(dl.outer_vec, dl.codec, seed)
    inner_pre = probes.sketch(state.params, names, seed)
    outer_step(state.params)
    sync(dev)
    outer_post = probes.sketch(state.params, names, seed)
    # the second outer step, on the momentum the first left
    tok, tgt = feed.next()
    step_fn(state, tok, tgt)
    inner_pre2 = probes.sketch(state.params, names, seed)
    outer_step(state.params)
    sync(dev)
    outer_post2 = probes.sketch(state.params, names, seed)
    outer_mid = probes.sketch_flat(dl.outer_vec, dl.codec, seed)

    marks_setup["checked"] = time.time()

    # the window
    tracer = probes.Tracer(trace, dev)
    tracer.start()
    cuda = dev.type == "cuda"
    vote = np.zeros(1, dtype=np.float32)
    t_start = time.time()
    deadline = t_start + spec["seconds"]
    clock = probes.StepClock(cuda)
    marks, outers, outer_events = [], [], []
    while True:
        with tracer.span("stop_vote"):
            vote[0] = float(time.time() >= deadline)
            if comm is not None:
                comm.all_reduce(vote, op=ReduceOp.MAX, tag=VOTE_TAG)
        if vote[0] > 0:
            break
        with tracer.span("inner_steps"):
            start = clock.mark()
            for _ in range(H):
                tok, tgt = feed.next()
                loss = step_fn(state, tok, tgt)
                end = clock.mark()
                marks.append((start, end))
                start = end
        with tracer.span("loss_wait"):
            float(loss)                      # waits for the last inner step
        tx0 = _tx_bytes(comm) if trace and comm else 0
        t0 = time.time_ns()
        e0 = clock.mark()
        outer_step(state.params)
        e1 = clock.mark()
        sync(dev)
        t1 = time.time_ns()
        outer_events.append((e0, e1))
        outers.append({"t0_ns": t0, "t1_ns": t1, "profile": dl.last_profile,
                       "tx_bytes": _tx_bytes(comm) - tx0 if trace and comm else 0})
        tracer.add_span("outer_step", t0, t1)
        if dl.last_profile:
            _phase_spans(tracer, t0, dl.last_profile)
    tracer.stop()
    sync(dev)
    in_window = clock.share_in_window(marks, spec["seconds"])
    for o, (e0, e1) in zip(outers, outer_events):
        o["device_s"] = clock.seconds(e1) - clock.seconds(e0)
    final = probes.sketch_flat(dl.outer_vec, dl.codec, seed)
    w0 = int(t_start * 1e9)
    record = {
        "t_window_start": t_start,
        "setup_marks": marks_setup,
        "tokens": in_window * B * T,
        "steps": len(marks),
        "outer": outers,
        "check": {"losses": losses, "grad_norms": grad, "update_norms": update,
                  "outer_pre": outer_pre, "inner_pre": inner_pre,
                  "outer_post": outer_post, "inner_pre2": inner_pre2,
                  "outer_post2": outer_post2, "outer_mid": outer_mid,
                  "final": final},
        "trace": tracer.report(w0, w0 + int(spec["seconds"] * 1e9)),
    }
    if comm is not None:
        comm.destroy()
    return record


def _tx_bytes(comm) -> int:
    return sum(e["tx_bytes"] for e in comm.stats()["edges"].values())


def _phase_spans(tracer, t0_ns: int, profile: dict) -> None:
    """Diloco.last_profile's phases, fenced one after another, as spans
    from the outer step's start."""
    t = t0_ns
    for k, v in profile.items():
        if k.endswith("_cpu") or k == "total":
            continue
        t1 = t + int(v * 1e9)
        tracer.add_span("outer." + k, t, t1)
        t = t1
