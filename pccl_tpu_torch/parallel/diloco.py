"""Sync DiLoCo: H inner steps, then one outer step over the native ring.

The outer step, as in pccl_tpu/parallel/diloco.py (unpipelined path):
1. the pseudo-gradient delta = outer - inner, one flat fp32 vector on the
   device (leaves in JAX's sorted order, parallel/codec.py);
2. device -> host into a pinned fp32 buffer allocated once; its numpy
   view feeds the ring (the native core reads host memory only);
3. AVG all-reduce over the ring, out of place into a second pinned buffer,
   with the retry policy of parallel/ring.py;
4. host -> device (non_blocking), then Nesterov SGD on the device:
   mom = mu*mom + delta; upd = delta + mu*mom; outer -= lr*upd.
   It runs in place on the device vectors (JAX donated the buffers);
5. the new outer parameters are written into the caller's parameter
   tensors, from which inner training continues.

`shared_state()` / `sync_shared_state()` expose outer params, momentum and
step as a revisioned SharedState staged through host numpy, so a late
joiner catches up bit-identically.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..comm import (
    Communicator,
    DataType,
    QuantizationAlgorithm,
    SharedState,
    SharedStateSyncStrategy,
    TensorInfo,
)
from .codec import build_codec
from .ring import avg_all_reduce_windowed


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
    # split the outer reduce into this many concurrent tagged collectives
    comm_windows: int = 1


class Diloco:
    """Synchronous DiLoCo driver around a Communicator (None = no ring: the
    outer step applies this peer's own pseudo-gradient).

        dl = Diloco(comm, state.params, cfg)
        for outer in range(n):
            for _ in range(cfg.inner_steps):
                step(state, tokens, targets)
            dl.outer_step(state.params)   # ring AVG + outer SGD, in place
    """

    def __init__(self, comm: Optional[Communicator],
                 params: Dict[str, torch.Tensor],
                 cfg: DilocoConfig = DilocoConfig()):
        self.comm = comm
        self.cfg = cfg
        self.step = 0
        self.codec = build_codec(params)
        self.count = self.codec.count
        # the canonical outer state: flat fp32 vectors on the parameters'
        # device; delta is a reused scratch vector
        self._outer_vec = self.codec.flat(params)
        self.device = self._outer_vec.device
        self._momentum_vec = torch.zeros_like(self._outer_vec)
        self._delta = torch.empty_like(self._outer_vec)
        # host staging: pinned so the copies are DMA transfers; allocated
        # once, the ring reads and writes their numpy views
        pin = self.device.type == "cuda"
        self._host = torch.empty(self.count, dtype=torch.float32, pin_memory=pin)
        self._host_out = torch.empty(self.count, dtype=torch.float32,
                                     pin_memory=pin)

    # -- the outer step --

    @property
    def outer_vec(self) -> torch.Tensor:
        return self._outer_vec

    def params(self) -> Dict[str, torch.Tensor]:
        """Fresh tensors holding the current outer parameters."""
        return self.codec.unflat(self._outer_vec)

    def copy_outer_into(self, params: Dict[str, torch.Tensor]) -> None:
        """Write the current outer parameters into `params` in place."""
        self.codec.unflat_into(self._outer_vec, params)

    def _reduce_host(self, vec: np.ndarray, out: np.ndarray) -> int:
        return avg_all_reduce_windowed(
            self.comm, vec, windows=self.cfg.comm_windows, out=out,
            quantization=self.cfg.quantization,
            quantized_dtype=self.cfg.quantized_dtype,
            max_retries=self.cfg.max_retries)

    @torch.no_grad()
    def outer_step(self, inner_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Average pseudo-gradients across peers, apply outer Nesterov SGD,
        and write the new outer parameters into `inner_params` (in place;
        the same dict is returned)."""
        delta = self.codec.flat_delta_vec(self._outer_vec, inner_params,
                                          out=self._delta)
        self._host.copy_(delta)            # D2H; waits for the device
        src = self._host
        if self.comm is not None:
            self._reduce_host(self._host.numpy(), self._host_out.numpy())
            src = self._host_out
        # H2D without a host wait: the next write to either pinned buffer
        # comes after a synchronising D2H, which orders after this copy
        delta.copy_(src, non_blocking=True)
        lr, mu = self.cfg.outer_lr, self.cfg.outer_momentum
        mom = self._momentum_vec
        mom.mul_(mu).add_(delta)                    # mom = mu*mom + delta
        upd = delta.add_(mom, alpha=mu) if self.cfg.nesterov else mom
        self._outer_vec.add_(upd, alpha=-lr)        # outer -= lr*upd
        self.step += 1
        self.codec.unflat_into(self._outer_vec, inner_params)
        return inner_params

    def digest(self) -> str:
        """BLAKE2b of the outer vector's bytes: equal on every peer after a
        sync outer step (the peers apply one averaged delta to one state)."""
        with torch.no_grad():
            self._host.copy_(self._outer_vec)
        return hashlib.blake2b(self._host.numpy().data,
                               digest_size=16).hexdigest()

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
            strategy: SharedStateSyncStrategy = SharedStateSyncStrategy.ENFORCE_POPULAR):
        """Sync outer state with the group and adopt what wins the election
        into the outer vector, momentum and step. Take the adopted
        parameters with params() or copy_outer_into()."""
        if self.comm is None:
            raise ValueError("sync_shared_state needs a communicator")
        st = self.shared_state()
        info = self.comm.sync_shared_state(st, strategy)
        self.step = int(self._ss_step[0])
        with torch.no_grad():
            self._outer_vec.copy_(torch.from_numpy(self._ss_vec))
            self._momentum_vec.copy_(torch.from_numpy(self._ss_mom))
        return info
