"""Global gradient averaging for a DDP peer: the peer's gradients cross the
native ring as one flat fp32 vector.

The JAX package's HierarchicalAllReduce (pccl_tpu/parallel/hierarchical.py)
treats a TPU slice as one peer: an intra-slice hop over ICI, then the ring
across slices. A peer of the port is one card, so the intra-node hop is the
identity, as it is in JAX for gradients out of an SPMD-jit step. What is
left, per all_reduce:

1. the gradients, flattened in the JAX package's leaf order
   (parallel/codec.py), into one fp32 vector on the card, allocated once;
2. device -> host into a pinned buffer, or with `shm_staging` into a
   registered shm buffer (comm.shm_ndarray) through a CPU tensor view of
   it, so that peers on one host reduce zero-copy; either is allocated
   once;
3. AVG all-reduce in place over the ring, with the retry policy of
   parallel/ring.py: quantization optional, `windows` concurrent tagged
   collectives, `max_retries` for the single-op path;
4. host -> device, then the vector back into the gradient tensors.

Shm staging applies only without quantization, as in the JAX package: a
quantized ring sends from its quantize scratch, not from the stage.
`comm=None` is the identity, so one loop runs alone or in a group.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..comm import Communicator, DataType, QuantizationAlgorithm, shm_ndarray
from .codec import build_codec
from .ring import avg_all_reduce_windowed


class HierarchicalAllReduce:
    """Peer-as-one-card global averaging::

        ring = HierarchicalAllReduce(comm, state.params)
        ring.all_reduce({n: p.grad for n, p in state.params.items()})
    """

    def __init__(self, comm: Optional[Communicator],
                 template: Dict[str, torch.Tensor], *,
                 quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE,
                 quantized_dtype: DataType = DataType.UINT8,
                 max_retries: int = 16, shm_staging: bool = False,
                 windows: int = 1):
        self.comm = comm
        self.quantization = quantization
        self.quantized_dtype = quantized_dtype
        self.max_retries = max_retries
        self.windows = windows
        self.shm_staging = shm_staging and \
            quantization == QuantizationAlgorithm.NONE
        self._codec = build_codec(template)
        self._vec = self._host = None
        if comm is not None:
            dev = next(iter(template.values())).device
            n = self._codec.count
            self._vec = torch.empty(n, dtype=torch.float32, device=dev)
            if self.shm_staging:
                self._host = torch.from_numpy(shm_ndarray(n, np.float32))
            else:
                self._host = torch.empty(n, dtype=torch.float32,
                                         pin_memory=dev.type == "cuda")

    @property
    def count(self) -> int:
        return self._codec.count

    @torch.no_grad()
    def all_reduce(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Replace each tensor of `grads` by its mean across the group, in
        place; returns `grads`. Returns at once when there is no comm."""
        if self.comm is None:
            return grads
        self._codec.flat_into(grads, self._vec)
        self._host.copy_(self._vec)        # D2H; waits for the device
        avg_all_reduce_windowed(self.comm, self._host.numpy(),
                                windows=self.windows,
                                quantization=self.quantization,
                                quantized_dtype=self.quantized_dtype,
                                max_retries=self.max_retries)
        # H2D without a host wait from the pinned buffer: its next write is
        # the synchronising D2H above, which orders after this copy (from
        # the pageable shm stage the copy is synchronous)
        self._vec.copy_(self._host, non_blocking=True)
        self._codec.unflat_into(self._vec, grads)
        return grads
