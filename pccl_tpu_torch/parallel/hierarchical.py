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

`local_mean` is the intra-node hop for a peer of several cards, one rank
each, over torch.distributed (parallel/mesh.py).

A peer may be a tensor-parallel group of ranks (`tp=`, a
models/convert.TpShards): the JAX package's slice as one peer, with more
than one rank in the slice. The ring's flat vector is then JAX's, the full
tensors in codec order, which is what `device_get` of a sharded tree
gives: rank 0 of the tp group gathers the gradient blocks (through pinned
buffers on gloo) into full tensors, runs the ring AVG with its
communicator, and scatters each rank's blocks back. Every rank of the
group calls all_reduce; the others pass comm=None.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..comm import Communicator, DataType, QuantizationAlgorithm, shm_ndarray
from .codec import build_codec
from .ring import avg_all_reduce_windowed


def local_mean(tree: Any, mesh, axis: Union[str, Sequence[str]] = "dp") -> Any:
    """The mean of each tensor of `tree` over the ranks of a mesh axis (or
    of several axes together), the same on every rank
    (pccl_tpu/parallel/hierarchical.py:local_mean).

    In JAX one program holds every device's value, stacked along each
    leaf's leading dim ([n·k, ...] -> [k, ...]); here each rank holds its
    own [k, ...] and gets the [k, ...] mean back: a SUM all_reduce over
    the axes' group, divided by its n ranks, as JAX's psum / n. New
    tensors; the inputs are left as they are."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    group, n = mesh.group(*axes), math.prod(mesh.size(a) for a in axes)

    def mean(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x.div_(n)

    return pytree.tree_map(mean, tree)


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
                 windows: int = 1, tp=None):
        self.comm = comm
        self.tp = tp
        dev = next(iter(template.values())).device
        if tp is not None:
            # the ring runs on rank 0 of the group, over the full tensors
            if tp.rank != 0 and comm is not None:
                raise ValueError("only rank 0 of a tp group holds the comm")
            template = {n: torch.empty(tp.full_shape(n, t.shape), dtype=t.dtype,
                                       device="meta")
                        for n, t in template.items()}
        self.quantization = quantization
        self.quantized_dtype = quantized_dtype
        self.max_retries = max_retries
        self.windows = windows
        self.shm_staging = shm_staging and \
            quantization == QuantizationAlgorithm.NONE
        self._codec = build_codec(template)
        self._vec = self._host = None
        if comm is not None:
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
        place; returns `grads`. Returns at once when there is no comm and
        no tp group. With a tp group, every rank of it takes part."""
        if self.tp is not None:
            full = self.tp.gather(grads, dst=0)
            if full is not None:
                self._reduce(full)
            self.tp.scatter(full, grads, src=0)
            return grads
        return self._reduce(grads)

    def _reduce(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
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
