"""DiLoCo: H inner steps, then one outer step over the native ring; sync
(`Diloco`) or one step delayed (`AsyncDiloco`).

The outer step, as in pccl_tpu/parallel/diloco.py:
1. the pseudo-gradient delta = outer - inner, one flat fp32 vector on the
   device (leaves in JAX's sorted order, parallel/codec.py);
2. device -> host, AVG all-reduce over the ring (the native core reads
   host memory only), host -> device. Three routes, chosen from the config
   alone (never from `profile`: window tags must match on every peer):
   - pipelined (`shm_staging` and `comm_windows` > 1, unquantized): the
     vector is cut into k windows; each window's D2H runs on a side stream
     into a pinned buffer, is copied into a registered shm stage
     (comm.shm_ndarray) once its own event fires, and is reduced as its own
     tagged async collective while the later windows still copy;
   - staged (`shm_staging`): D2H into a pinned buffer, one copy into the
     shm stage, the ring between the two shm buffers;
   - unstaged: D2H into a pinned buffer, the ring out of place into a
     second pinned buffer;
3. Nesterov SGD on the device, in place on the outer vector and momentum
   (JAX donated those buffers): mom = mu*mom + delta; upd = delta + mu*mom;
   outer -= lr*upd;
4. the new outer parameters are written into the caller's parameter
   tensors, from which inner training continues.

`cfg.profile` fills `last_profile` with each phase's seconds, fenced with
torch.cuda.synchronize (the JAX package's phase names).

`shared_state()` / `sync_shared_state()` expose outer params, momentum and
step as a revisioned SharedState staged through host numpy, so a late
joiner catches up bit-identically.

A peer may be several ranks on a (dp, tp) mesh (`shards=`, a
models/convert.MeshShards), the JAX package's peer over its local mesh.
Its lead, rank (0, 0), holds the communicator and the whole outer state,
the full fp32 vector and momentum in the codec order of the full
tensors, which is what the JAX Diloco flattens from its global arrays:
so a peer of any number of ranks, a one-rank peer and a JAX peer put
every element at the same index of the ring's vector. Each outer step
the ranks' inner parameters are gathered to the lead, the lead runs the
outer step above on the full tensors, and every rank gets its blocks of
the new parameters back (the shards time both). Every rank calls every
method; the other ranks hold no outer state and no step (digest() is
None there).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..comm import (
    Communicator,
    DataType,
    PcclError,
    QuantizationAlgorithm,
    ReduceOp,
    SharedState,
    SharedStateSyncStrategy,
    TensorInfo,
    TooFewPeersError,
    shm_ndarray,
)
from .codec import build_codec
from .ring import _MIN_WINDOW_ELEMS, avg_all_reduce_windowed


@dataclasses.dataclass(frozen=True)
class DilocoConfig:
    """Outer-loop hyperparameters (outer SGD lr 0.7, Nesterov momentum
    0.9)."""

    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    nesterov: bool = True
    inner_steps: int = 50
    quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE
    quantized_dtype: DataType = DataType.UINT8
    max_retries: int = 16
    # stage the pseudo-gradient in registered shm buffers, so that peers on
    # one host reduce zero-copy; costs one host copy of the vector a step
    shm_staging: bool = False
    # split the outer reduce into this many concurrent tagged collectives
    comm_windows: int = 1
    # record each outer step's phases in Diloco.last_profile (fenced with
    # device synchronisations, so leave off in production)
    profile: bool = False


class Diloco:
    """Synchronous DiLoCo driver around a Communicator (None = no ring: the
    outer step applies this peer's own pseudo-gradient).

        dl = Diloco(comm, state.params, cfg)
        for outer in range(n):
            for _ in range(cfg.inner_steps):
                step(state, tokens, targets)
            dl.outer_step(state.params)   # ring AVG + outer SGD, in place
    """

    # tag band of the pipelined windows: apart from the blocking default 0,
    # small user tags, the MultipleWithRetry band (1 << 16) and the auto
    # band (1 << 32); window i has the same tag on every peer
    _WINDOW_TAG_BASE = 1 << 20

    def __init__(self, comm: Optional[Communicator],
                 params: Dict[str, torch.Tensor],
                 cfg: DilocoConfig = DilocoConfig(), shards=None):
        self.comm = comm
        self.cfg = cfg
        self.step = 0
        self.shards = shards
        self.device = next(iter(params.values())).device
        full = params if shards is None else shards.gather(params)
        self.lead = full is not None
        if comm is not None and not self.lead:
            raise ValueError("only the lead rank of a peer holds the comm")
        # host buffers, each allocated at its first use: the pinned D2H
        # target, the unstaged ring's pinned output, the two shm stages
        self._host: Optional[torch.Tensor] = None
        self._host_out: Optional[torch.Tensor] = None
        self._shm_stage: Optional[np.ndarray] = None
        self._shm_out: Optional[np.ndarray] = None
        self._side_stream = None
        self.last_profile: Optional[dict] = None
        self.codec = self._outer_vec = self._momentum_vec = self._delta = None
        self.count = 0
        if not self.lead:
            return
        self.codec = build_codec(full)
        self.count = self.codec.count
        # the canonical outer state: flat fp32 vectors on the parameters'
        # device; delta is a reused scratch vector
        self._outer_vec = self.codec.flat(full)
        self._momentum_vec = torch.zeros_like(self._outer_vec)
        self._delta = torch.empty_like(self._outer_vec)

    # -- the outer step --

    @property
    def outer_vec(self) -> torch.Tensor:
        return self._outer_vec

    def params(self) -> Dict[str, torch.Tensor]:
        """Fresh tensors holding the current outer parameters (the full
        tensors, on the lead only)."""
        return self.codec.unflat(self._outer_vec)

    def copy_outer_into(self, params: Dict[str, torch.Tensor]) -> None:
        """Write the current outer parameters into `params` in place (each
        rank's blocks of them, on every rank of a peer of several)."""
        if self.shards is None:
            self.codec.unflat_into(self._outer_vec, params)
            return
        self.shards.scatter(self.params() if self.lead else None, params)

    def _pinned(self) -> torch.Tensor:
        """A host fp32 vector of the outer vector's size, pinned when the
        vector lies on a card (so that the copies are DMA transfers)."""
        return torch.empty(self.count, dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _d2h(self, delta: torch.Tensor) -> torch.Tensor:
        """delta copied into the pinned host buffer; waits for the device."""
        if self._host is None:
            self._host = self._pinned()
        self._host.copy_(delta)
        return self._host

    def _ensure_shm_stage(self) -> None:
        if self._shm_stage is None:
            # two buffers: the ring reduces stage -> out out of place, which
            # skips the core's in-place abort-restore backup (a copy of the
            # whole vector per step)
            self._shm_stage = shm_ndarray(self.count, np.float32)
            self._shm_out = shm_ndarray(self.count, np.float32)

    def _reduce_host(self, vec: np.ndarray, out: np.ndarray) -> int:
        return avg_all_reduce_windowed(
            self.comm, vec, windows=self.cfg.comm_windows, out=out,
            quantization=self.cfg.quantization,
            quantized_dtype=self.cfg.quantized_dtype,
            max_retries=self.cfg.max_retries)

    def _d2h_windows(self, delta: torch.Tensor, host: torch.Tensor,
                     wins: List[slice]) -> list:
        """Start the D2H of every window into `host` on a side stream, with
        one event after each; returns the events (None each on the CPU,
        where the copy is done on return)."""
        if self.device.type != "cuda":
            host.copy_(delta)
            return [None] * len(wins)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        events = []
        with torch.cuda.stream(side):
            for w in wins:
                host[w].copy_(delta[w], non_blocking=True)
                events.append(torch.cuda.Event())
                events[-1].record(side)
        return events

    def _reduce_pipelined(self, delta: torch.Tensor) -> bool:
        """The pipelined reduce into self._shm_out: window k+1's D2H
        overlaps window k's ring (the windows are independent tagged
        collectives). Returns False, having done nothing, when the vector is
        too small for two windows. Failed windows retry over the survivor
        world through MultipleWithRetry; completed ones stand."""
        k = min(self.cfg.comm_windows, max(1, self.count // _MIN_WINDOW_ELEMS), 8)
        if k <= 1:
            return False
        self._ensure_shm_stage()
        if self._host is None:
            self._host = self._pinned()
        host = self._host.numpy()
        bounds = [self.count * i // k for i in range(k + 1)]
        wins = [slice(bounds[i], bounds[i + 1]) for i in range(k)]
        events = self._d2h_windows(delta, self._host, wins)
        handles, failed = [], []
        for i, w in enumerate(wins):
            view, out_view = self._shm_stage[w], self._shm_out[w]
            if events[i] is not None:
                events[i].synchronize()     # this window's bytes only
            np.copyto(view, host[w])
            # a launch-time failure must not escape while earlier windows
            # are in flight on these buffers: record it for the retry batch
            try:
                handles.append((i, self.comm.all_reduce_async(
                    view, out_view, op=ReduceOp.AVG,
                    tag=self._WINDOW_TAG_BASE + i)))
            except TooFewPeersError:
                np.copyto(out_view, view)   # alone: the window is its own avg
            except PcclError:
                # never launched: seed the out view with the input so the
                # in-place retry below reduces real data
                np.copyto(out_view, view)
                failed.append(i)
        for i, h in handles:
            try:
                h.wait()
            except TooFewPeersError:
                np.copyto(self._shm_out[wins[i]], self._shm_stage[wins[i]])
            except PcclError:
                # aborted mid-op: the core restored the out view from the
                # untouched staged input
                failed.append(i)
        if failed:
            # the survivors agree on the failed set but not on its order,
            # and MultipleWithRetry assigns tags by list position: sort
            failed = sorted(set(failed))
            self.comm.update_topology()
            try:
                self.comm.all_reduce_multiple_with_retry(
                    [self._shm_out[wins[i]] for i in failed], op=ReduceOp.AVG)
            except TooFewPeersError:
                pass
        return True

    @torch.no_grad()
    def _apply(self, delta: torch.Tensor) -> None:
        """Outer Nesterov SGD in place, with delta as scratch. Each line is
        the JAX package's arithmetic as XLA compiles it on the CPU (a*b + c
        as one fused multiply-add), so the outer vector is bit-equal there."""
        lr, mu = self.cfg.outer_lr, self.cfg.outer_momentum
        mom = self._momentum_vec
        torch.add(delta, mom, alpha=mu, out=mom)                 # mu*mom + delta
        upd = delta.add_(mom, alpha=mu) if self.cfg.nesterov else mom
        self._outer_vec.add_(upd, alpha=-lr)                     # outer -= lr*upd

    def _marker(self):
        """(profile dict or None, mark): mark(name, t0) fences the device,
        records the wall and CPU seconds since t0 under name and name_cpu,
        and returns the new t0. A no-op when profiling is off."""
        prof = {} if self.cfg.profile else None
        cpu = [time.process_time()]

        def mark(name: str, t0: float) -> float:
            if prof is None:
                return t0
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            prof[name] = t1 - t0
            # CPU seconds beside wall: on a busy host the gap is waiting
            # (scheduler, peers), not the phase's work
            c1 = time.process_time()
            prof[name + "_cpu"] = c1 - cpu[0]
            cpu[0] = c1
            return t1

        return prof, mark

    @torch.no_grad()
    def outer_step(self, inner_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Average pseudo-gradients across peers, apply outer Nesterov SGD,
        and write the new outer parameters into `inner_params` (in place;
        the same dict is returned). On a peer of several ranks: gathered
        to the lead, stepped there, scattered back."""
        if self.shards is None:
            return self._outer_step(inner_params)
        full = self.shards.gather(inner_params)
        if self.lead:
            self._outer_step(full)
        self.shards.scatter(full, inner_params)
        return inner_params

    def _outer_step(self, inner_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        prof, mark = self._marker()
        t = time.perf_counter()
        delta = self.codec.flat_delta_vec(self._outer_vec, inner_params,
                                          out=self._delta)
        t = mark("delta_compute", t)
        # a quantized ring sends from its quantize scratch, not from the
        # stage: staging would be a pure extra copy there
        use_shm = (self.cfg.shm_staging and self.comm is not None
                   and self.cfg.quantization == QuantizationAlgorithm.NONE)
        if use_shm and self.cfg.comm_windows > 1 and self._reduce_pipelined(delta):
            # D2H, staging and ring overlap: one combined phase
            src = torch.from_numpy(self._shm_out)
            t = mark("d2h_stage_ring_pipelined", t)
        else:
            src = self._d2h(delta)
            t = mark("d2h", t)
            if use_shm:
                self._ensure_shm_stage()
                np.copyto(self._shm_stage, src.numpy())
                t = mark("stage_copy", t)
                self._reduce_host(self._shm_stage, self._shm_out)
                src = torch.from_numpy(self._shm_out)
            else:
                t = mark("stage_copy", t)   # the pinned buffer feeds the ring
                if self.comm is not None:
                    if self._host_out is None:
                        self._host_out = self._pinned()
                    self._reduce_host(src.numpy(), self._host_out.numpy())
                    src = self._host_out
            t = mark("ring_reduce", t)
        # H2D without a host wait from a pinned buffer: the next write to it
        # comes after a synchronising D2H, which orders after this copy. From
        # shm (pageable) the copy returns once the bytes have left the buffer
        delta.copy_(src, non_blocking=True)
        self._apply(delta)
        self.step += 1
        t = mark("h2d_apply", t)
        self.codec.unflat_into(self._outer_vec, inner_params)
        mark("unflat_out", t)
        if prof is not None:
            prof["total"] = sum(v for k, v in prof.items() if not k.endswith("_cpu"))
            self.last_profile = prof
        return inner_params

    def digest(self) -> Optional[str]:
        """BLAKE2b of the outer vector's bytes: equal on every peer after a
        sync outer step (the peers apply one averaged delta to one state).
        None on the ranks of a peer other than its lead."""
        if not self.lead:
            return None
        with torch.no_grad():
            host = self._outer_vec.cpu()
        return hashlib.blake2b(host.numpy().data, digest_size=16).hexdigest()

    # -- shared state --

    def shared_state(self) -> SharedState:
        """Outer params + momentum + step as a revisioned SharedState on
        host copies. Revision = outer step count."""
        self._ss_vec = self._outer_vec.to("cpu", copy=True).numpy()
        self._ss_mom = self._momentum_vec.to("cpu", copy=True).numpy()
        self._ss_step = np.array([self.step], dtype=np.uint64)
        return SharedState([
            TensorInfo.from_numpy("diloco.outer_params", self._ss_vec),
            TensorInfo.from_numpy("diloco.outer_momentum", self._ss_mom),
            TensorInfo.from_numpy("diloco.step", self._ss_step),
        ], revision=self.step)

    def sync_shared_state(
            self,
            strategy: SharedStateSyncStrategy = SharedStateSyncStrategy.ENFORCE_POPULAR,
            params: Optional[Dict[str, torch.Tensor]] = None):
        """Sync outer state with the group and adopt what wins the election
        into the outer vector, momentum and step; with `params`, write the
        adopted outer parameters into them (copy_outer_into). On a peer of
        several ranks every rank calls it: the lead syncs, and each rank
        gets its blocks into `params`.
        Returns the sync's info (None on the other ranks)."""
        info = None
        if self.lead:
            if self.comm is None:
                raise ValueError("sync_shared_state needs a communicator")
            st = self.shared_state()
            info = self.comm.sync_shared_state(st, strategy)
            self.step = int(self._ss_step[0])
            with torch.no_grad():
                self._outer_vec.copy_(torch.from_numpy(self._ss_vec))
                self._momentum_vec.copy_(torch.from_numpy(self._ss_mom))
        if params is not None:
            self.copy_outer_into(params)
        return info


class AsyncDiloco(Diloco):
    """One-step-delayed DiLoCo: the reduce of outer step t runs on a
    background thread while the inner steps of t+1 compute, and lands at
    the next outer boundary.

        dl = AsyncDiloco(comm, state.params, cfg)
        for outer in range(n):
            for _ in range(cfg.inner_steps):
                step(state, tokens, targets)
            dl.outer_step_async(state.params)   # launch; continue in place
        dl.finish(state.params)                 # land the last reduce

    The thread only runs the ring over pinned host buffers (ctypes releases
    the GIL for the native call); it never touches the card.

    On a peer of several ranks (`shards=`) the reduce runs on the lead;
    each outer_step_async gathers the inner parameters and scatters the
    parameters to continue from (the previous step's update applied at
    the join), and finish() scatters those of the last one.
    """

    def __init__(self, comm: Optional[Communicator], params: Dict[str, torch.Tensor],
                 cfg: DilocoConfig = DilocoConfig(), shards=None):
        super().__init__(comm, params, cfg, shards)
        self._inflight: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        # two pinned send buffers, alternated: the next D2H fills one while
        # the in-flight reduce still reads the other; and the pooled output
        self._async_send: List[Optional[torch.Tensor]] = [None, None]
        self._send_i = 0
        self._async_out: Optional[torch.Tensor] = None
        # the H2D from _async_out, which the next reduce must not overwrite
        # before it has landed
        self._applied: Optional[torch.cuda.Event] = None
        # the pseudo-gradient baseline: the outer vector the inner phase
        # started from, before the delayed update from step t-1 landed. It
        # is the outer vector itself until something updates that in place
        self._baseline: Optional[torch.Tensor] = None
        # seconds the last outer_step_async waited for the previous reduce
        self.join_s = 0.0

    def _reduce_bg(self, host: np.ndarray, out: np.ndarray) -> None:
        try:
            if self.comm is not None:
                # out of place into the pooled buffer: skips the core's
                # in-place backup copy
                self._reduce_host(host, out)
            else:
                np.copyto(out, host)
        except BaseException as e:  # noqa: BLE001 — raised again on join
            self._err = e

    def _join_inflight(self) -> None:
        """Join the in-flight reduce and apply it (not fused with an unflat:
        the params are read at times decoupled from the join)."""
        if self._inflight is None:
            return
        t0 = time.perf_counter()
        self._inflight.join()
        self.join_s = time.perf_counter() - t0
        self._inflight = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if self._baseline is self._outer_vec:
            # the apply updates the outer vector in place; a live baseline
            # must keep the values the inner phase started from
            self._baseline = self._outer_vec.clone()
        with torch.no_grad():
            self._delta.copy_(self._async_out, non_blocking=True)
            self._apply(self._delta)
        if self.device.type == "cuda":
            self._applied = torch.cuda.Event()
            self._applied.record(torch.cuda.current_stream(self.device))
        self.step += 1

    @torch.no_grad()
    def outer_step_async(self, inner_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply the previous in-flight reduce (if any), launch the reduce of
        this step's pseudo-gradient, and write the outer parameters to
        continue from (the delayed update has landed, this step's has not)
        into `inner_params` in place; the same dict is returned."""
        if self.shards is None:
            return self._outer_step_async(inner_params)
        full = self.shards.gather(inner_params)
        if self.lead:
            self._outer_step_async(full)
        self.shards.scatter(full, inner_params)
        return inner_params

    def _outer_step_async(self, inner_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        baseline = self._baseline if self._baseline is not None else self._outer_vec
        delta = self.codec.flat_delta_vec(baseline, inner_params, out=self._delta)
        if self._async_send[self._send_i] is None:
            self._async_send[self._send_i] = self._pinned()
        send = self._async_send[self._send_i]
        self._send_i ^= 1
        send.copy_(delta)               # D2H; waits for the device
        self._baseline = None           # consumed: the join needs no copy
        self.join_s = 0.0
        self._join_inflight()
        if self._async_out is None:
            self._async_out = self._pinned()
        if self._applied is not None:
            self._applied.synchronize()
            self._applied = None
        self._inflight = threading.Thread(
            target=self._reduce_bg, args=(send.numpy(), self._async_out.numpy()),
            daemon=True)
        self._inflight.start()
        self._baseline = self._outer_vec
        self.codec.unflat_into(self._outer_vec, inner_params)
        return inner_params

    def sync_shared_state(
            self,
            strategy: SharedStateSyncStrategy = SharedStateSyncStrategy.ENFORCE_POPULAR,
            params: Optional[Dict[str, torch.Tensor]] = None):
        """Land (or fail) the in-flight update before the election, so the
        offered state is self-consistent, and drop the baseline afterwards:
        adopted parameters invalidate it (the delta would hold the whole
        jump)."""
        self._join_inflight()
        info = super().sync_shared_state(strategy)
        self._baseline = None
        if params is not None:
            self.copy_outer_into(params)
        return info

    def finish(self, inner_params: Optional[Dict[str, torch.Tensor]] = None):
        """Join any in-flight reduce and apply it. Writes the final outer
        parameters into `inner_params` in place and returns it, or returns
        fresh tensors when none is given (a one-rank peer only)."""
        if self.lead:
            self._join_inflight()
        if inner_params is None:
            return self.params()
        self.copy_outer_into(inner_params)
        return inner_params
