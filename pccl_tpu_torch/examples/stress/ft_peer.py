"""One peer of the fault-tolerance soak (stress_orchestrator.py):

    python -m pccl_tpu_torch.examples.stress.ft_peer --master-port P \\
        --base-port B [--device cpu] [--sync-state N] ...

It loops an all-reduce of a vector of ones (the sum must equal the world
size), prints a heartbeat line per step, and may die on purpose at a step
or with a probability per step. The orchestrator reads its stdout; these
lines are the contract, the same as the JAX package's peer prints:

    STEP <step> world=<W> rank=<R>
    DYING at step <step>
    REJOIN                      (a fresh communicator after losing the master)
    RESUMED total=<N> epoch=<E> (session resumes absorbed by the native core)
    RETRY step=<step> cause=<error>
    SYNC RETRY step=<step> cause=<error>
    WRONG SYNC ... / WRONG RESULT ...    (then exit 3)
    STATS {json}                (comm.stats(), every --stats-every steps)
    INJECTED <endpoint> / INJECT FAILED <error>
    DONE

The vector and the shared state are torch tensors on --device (the card
by default). On a card the all-reduce stages through two pinned host
buffers (D2H, the ring over host memory, H2D); the shared state `w` of
--sync-state is a `TensorInfo.from_torch_device` entry, whose digest H1
computes on the card (it needs PCCLT_SS_HASH=simple-tpu on every peer),
and the STATS line then also carries `h1_launches`, H1's launches in this
process. On the CPU `w` is a `TensorInfo.from_torch` entry, hashed by the
native core, and the vector is reduced in place of its own storage.

Start-up imports only torch, numpy and pccl_tpu_torch.comm (and the
package's device helper), so that a relaunched peer is back quickly; H1's
module loads with the first card entry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from pccl_tpu_torch._device import resolve_device
from pccl_tpu_torch.comm import (
    Communicator,
    ConnectionLostError,
    DataType,
    KickedError,
    MasterUnreachableError,
    OperationAbortedError,
    PcclError,
    QuantizationAlgorithm,
    ReduceOp,
    SharedState,
    TensorInfo,
    TooFewPeersError,
    netem_inject,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--master-port", type=int, required=True)
    ap.add_argument("--rank", type=int, default=0,
                    help="label for heartbeat lines (ports come from --base-port)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--min-world", type=int, default=2)
    ap.add_argument("--join-delay", type=float, default=0.0)
    ap.add_argument("--die-at", type=int, default=-1,
                    help="exit abruptly before this step (a simulated crash)")
    ap.add_argument("--die-prob", type=float, default=0.0,
                    help="probability of an abrupt exit at each step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-port", type=int, required=True)
    ap.add_argument("--count", type=int, default=4096)
    ap.add_argument("--quantize", choices=["none", "minmax"], default="none",
                    help="run the quantized wire path under churn")
    ap.add_argument("--peer-group", type=int, default=0,
                    help="collectives and shared-state partition")
    ap.add_argument("--step-interval", type=float, default=0.0,
                    help="sleep between steps (paces the incumbents, so that "
                         "churn lands mid-run)")
    ap.add_argument("--sync-state", type=int, default=0, metavar="ELEMS",
                    help="sync an ELEMS-float32 shared state every step: the "
                         "revision advances by one a step and the content is "
                         "full(revision); a relaunched peer offers revision 0 "
                         "and adopts as a cold joiner. Prints 'WRONG SYNC' "
                         "and exits 3 if adopted content ever disagrees with "
                         "its revision.")
    ap.add_argument("--stats-every", type=int, default=0,
                    help="print 'STATS {json}' (the comm's counters and edges) "
                         "every N steps")
    ap.add_argument("--inject-spec", default="",
                    help="chaos schedule injected on this peer's outbound ring "
                         "edge (found from stats() as the edge with the most "
                         "tx bytes) before step --inject-at")
    ap.add_argument("--inject-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="where the vector and the shared state live")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.join_delay > 0:
        time.sleep(args.join_delay)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    # Losing the master is a two-tier recovery: the native client resumes
    # its session against a journaled restarted master by itself (ops see
    # at worst a retryable ConnectionLost/Aborted); only when that is
    # impossible (no journal, budget spent, kicked) does the error land
    # here, and the peer rejoins with a fresh communicator.
    master_loss = (ConnectionLostError, MasterUnreachableError, KickedError)

    def build_comm(budget_s: float = 90.0):
        deadline = time.time() + budget_s
        while True:
            c = Communicator("127.0.0.1", args.master_port,
                             p2p_port=args.base_port, ss_port=args.base_port + 4,
                             bench_port=args.base_port + 8,
                             peer_group=args.peer_group)
            try:
                c.connect()
                return c
            except PcclError:
                c.destroy()
                if time.time() > deadline:
                    raise
                time.sleep(0.5)

    def rejoin(old):
        print("REJOIN", flush=True)
        try:
            old.destroy()
        except Exception:  # noqa: BLE001 — the link is already dead
            pass
        return build_comm()

    comm = build_comm()
    deadline = time.time() + 60
    while comm.world_size < args.min_world:
        if time.time() > deadline:
            print("TIMEOUT waiting for world", flush=True)
            return 2
        try:
            if comm.are_peers_pending():
                comm.update_topology()
        except master_loss:
            comm = rejoin(comm)
        time.sleep(0.02)

    rng = np.random.RandomState(args.seed or args.base_port)
    x = torch.ones(args.count, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    # the ring runs over host memory: on a card, pinned staging buffers; on
    # the CPU, the tensors' own storage
    xh = torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if on_card else x
    yh = torch.empty(y.shape, dtype=y.dtype, pin_memory=True) if on_card else y
    step = 0
    last_resumes = 0
    # the shared-state lane: the offered revision and its content. The
    # content synced at revision R is full(R), so any adopter can check
    # locally that what it adopted is bit-correct.
    sync_rev = 0
    w = torch.zeros(max(1, args.sync_state), dtype=torch.float32, device=dev)
    while step < args.steps:
        if args.die_prob > 0 and rng.rand() < args.die_prob:
            print(f"DYING at step {step}", flush=True)
            os._exit(0)
        if args.die_at >= 0 and step >= args.die_at:
            # a simulated crash: no destroy(), no goodbye; the master must
            # see the dead connection and abort our running ops
            print(f"DYING at step {step}", flush=True)
            sys.stdout.flush()
            os._exit(0)
        # admit pending joiners between steps
        try:
            if comm.are_peers_pending():
                comm.update_topology()
        except master_loss:
            comm = rejoin(comm)
            continue
        except Exception:  # noqa: BLE001 — churn mid-vote; retry next loop
            time.sleep(0.05)
            continue
        if on_card:
            xh.copy_(x)                     # D2H; waits for the card
        try:
            if args.quantize == "minmax":
                info = comm.all_reduce(
                    xh.numpy(), yh.numpy(), op=ReduceOp.SUM,
                    quantization=QuantizationAlgorithm.MIN_MAX,
                    quantized_dtype=DataType.UINT8)
            else:
                info = comm.all_reduce(xh.numpy(), yh.numpy(), op=ReduceOp.SUM)
        except (KickedError, MasterUnreachableError):
            comm = rejoin(comm)
            continue
        except (ConnectionLostError, OperationAbortedError) as e:
            print(f"RETRY step={step} cause={type(e).__name__}", flush=True)
            try:
                comm.update_topology()
            except master_loss:
                comm = rejoin(comm)
            except Exception:  # noqa: BLE001
                time.sleep(0.05)
            continue
        except TooFewPeersError:
            # alone: everyone else died or left; counts as progress
            yh.copy_(xh)
            info = None
        if on_card:
            y.copy_(yh)                     # H2D
        if args.sync_state > 0:
            entry = (TensorInfo.from_torch_device("w", w) if on_card
                     else TensorInfo.from_torch("w", w))
            try:
                sinfo = comm.sync_shared_state(SharedState([entry],
                                                           revision=sync_rev))
            except (KickedError, MasterUnreachableError):
                comm = rejoin(comm)
                sync_rev = 0
                w.zero_()
                continue
            except (ConnectionLostError, OperationAbortedError) as e:
                print(f"SYNC RETRY step={step} cause={type(e).__name__}",
                      flush=True)
                continue
            if on_card and entry.updated:
                w.copy_(entry.torch_value())
            # bit-correct adoption: whatever revision won, its content must
            # be full(revision) everywhere
            w0, w1 = float(w[0]), float(w[-1])
            if sinfo.revision > 0 and (w0 != float(sinfo.revision)
                                       or w1 != float(sinfo.revision)):
                print(f"WRONG SYNC step={step} rev={sinfo.revision} "
                      f"w0={w0}", flush=True)
                return 3
            sync_rev = sinfo.revision + 1
            w.fill_(float(sync_rev))
        world = info.world_size if info is not None else 1
        tol = 1e-5 if args.quantize == "none" else 2e-2 * world
        y0 = float(y[0])
        if info is not None and abs(y0 - world) > tol:
            print(f"WRONG RESULT step={step} y={y0} world={world}", flush=True)
            return 3
        # surface the session resumes (absorbed master restarts), so the
        # orchestrator can count resumes against full rejoins
        rc = comm.reconnect_count
        if rc > last_resumes:
            print(f"RESUMED total={rc} epoch={comm.master_epoch}", flush=True)
        last_resumes = rc  # a rejoin resets the comm's counter to 0
        print(f"STEP {step} world={world} rank={args.rank}", flush=True)
        step += 1
        if args.inject_spec and step == args.inject_at:
            edges = comm.stats()["edges"]
            if edges:
                ep = max(edges.items(), key=lambda kv: kv[1]["tx_bytes"])[0]
                try:
                    netem_inject(ep, args.inject_spec)
                    print(f"INJECTED {ep}", flush=True)
                except PcclError as e:
                    print(f"INJECT FAILED {e}", flush=True)
        if args.stats_every > 0 and step % args.stats_every == 0:
            try:
                stats = comm.stats()
            except Exception:  # noqa: BLE001 — a snapshot raced a rejoin
                stats = None
            if stats is not None:
                if on_card:
                    from pccl_tpu_torch.ops import hashing

                    stats["h1_launches"] = hashing.launches["simplehash_tpu"]
                print("STATS " + json.dumps(stats), flush=True)
        if args.step_interval > 0:
            time.sleep(args.step_interval)
    comm.destroy()
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
