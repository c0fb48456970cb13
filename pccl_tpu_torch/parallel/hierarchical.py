"""Global gradient averaging for a DDP peer: the peer's gradients cross the
native ring as one flat fp32 vector.

The JAX package's HierarchicalAllReduce (pccl_tpu/parallel/hierarchical.py)
treats a TPU slice as one peer: an intra-slice hop over ICI, then the ring
across slices. A peer of the port is one card, so the intra-node hop is the
identity, as it is in JAX for gradients out of an SPMD-jit step. What is
left, per all_reduce:

1. the gradients, flattened in the JAX package's leaf order
   (parallel/codec.py), into one fp32 vector on the card, allocated once;
2. device -> host into a pinned buffer, allocated once;
3. AVG all-reduce in place over the ring, with the retry policy of
   parallel/ring.py (quantization optional);
4. host -> device, then the vector back into the gradient tensors.

`comm=None` is the identity, so one loop runs alone or in a group.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..comm import Communicator, QuantizationAlgorithm
from .codec import build_codec
from .ring import avg_all_reduce_windowed


class HierarchicalAllReduce:
    """Peer-as-one-card global averaging::

        ring = HierarchicalAllReduce(comm, state.params)
        ring.all_reduce({n: p.grad for n, p in state.params.items()})
    """

    def __init__(self, comm: Optional[Communicator],
                 template: Dict[str, torch.Tensor], *,
                 quantization: QuantizationAlgorithm = QuantizationAlgorithm.NONE):
        self.comm = comm
        self.quantization = quantization
        self._codec = build_codec(template)
        self._vec = self._host = None
        if comm is not None:
            dev = next(iter(template.values())).device
            self._vec = torch.empty(self._codec.count, dtype=torch.float32,
                                    device=dev)
            self._host = torch.empty(self._codec.count, dtype=torch.float32,
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
                                quantization=self.quantization)
        # H2D without a host wait: the next write to the pinned buffer is
        # the synchronising D2H above, which orders after this copy
        self._vec.copy_(self._host, non_blocking=True)
        self._codec.unflat_into(self._vec, grads)
        return grads
