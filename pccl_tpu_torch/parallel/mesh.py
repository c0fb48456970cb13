"""A named grid of torch.distributed process groups: the port's reading of
the JAX package's device `Mesh` (pccl_tpu/parallel/mesh.py).

In JAX one program sees every device of the mesh and `shard_map` hands each
its block; here each rank is a process that holds only its own block, and
a mesh axis is the process group of the ranks that differ only along it.
Ranks are laid out row-major over the mesh's shape, as `make_mesh` in the
JAX package reshapes its device list: for axes ("dp", "sp") of shape
(D, S), rank i_dp * S + i_sp sits at (i_dp, i_sp).

The tensor-parallel sharding rules of the JAX module wait for the tp port.

Gloo's send and receive take host tensors only, so `P2PRing` stages a card
tensor through pinned host buffers (allocated once for each slot and
shape), and several ranks can then share one card, each a process: NCCL
refuses two ranks on one device. The backend is the caller's choice
(`make_mesh(backend=)`).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def factor_mesh(n: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Factor n devices into a balanced (dp, tp, ...) shape, dp first."""
    dims = [1] * n_axes
    rem = n
    # greedily pull factors of 2 into tp (last axis) then dp
    i = n_axes - 1
    while rem % 2 == 0 and dims[i] < 8:
        dims[i] *= 2
        rem //= 2
        if dims[i] >= 4:
            i = max(0, i - 1)
    dims[0] *= rem
    return tuple(dims)


class P2PRing:
    """Neighbour exchange around one process group: `shift` sends to the
    next rank of the group and receives from the previous (or the reverse),
    one `batch_isend_irecv` for all tensors of a hop, tensor i with tag i so
    that gloo matches them alike on every rank.

    Card tensors cross through pinned host buffers on a backend other than
    NCCL. The hops' host seconds (staging included), the part of them spent
    in the D2H and H2D copies and their bytes sent accumulate in `seconds`,
    `stage_seconds` and `bytes`."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.stage = dist.get_backend(group) != "nccl"
        self._peers = {d: dist.get_global_rank(group, (self.rank + d) % self.size)
                       for d in (1, -1)}
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self.seconds = 0.0
        self.stage_seconds = 0.0
        self.bytes = 0

    def _host(self, role: str, slot: int, like: torch.Tensor) -> torch.Tensor:
        key = (role, slot, tuple(like.shape), like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._buffers[key] = buf
        return buf

    def shift(self, tensors: Sequence[torch.Tensor], direction: int = 1) -> list:
        """Each tensor sent `direction` (+1 or -1) ranks along the group;
        returns the tensors received from the opposite neighbour, new, with
        the shapes, dtypes and device of those sent."""
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        tensors = [t.detach().contiguous() for t in tensors]
        staged = self.stage and tensors[0].is_cuda
        if staged:
            # the D2H copies below wait for the card anyway; waiting first
            # keeps the card's work out of the hop's seconds
            torch.cuda.current_stream(tensors[0].device).synchronize()
        t0 = time.perf_counter()
        if staged:
            sends = [self._host("send", i, t).copy_(t)
                     for i, t in enumerate(tensors)]
            recvs = [self._host("recv", i, t) for i, t in enumerate(tensors)]
        else:
            sends = tensors
            recvs = [torch.empty_like(t) for t in tensors]
        t1 = time.perf_counter()
        to, frm = self._peers[direction], self._peers[-direction]
        ops = [dist.P2POp(dist.isend, t, to, self.group, tag=i)
               for i, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group, tag=i)
                for i, t in enumerate(recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        t2 = time.perf_counter()
        if staged:
            recvs = [r.to(t.device) for r, t in zip(recvs, tensors)]
        t3 = time.perf_counter()
        self.seconds += t3 - t0
        self.stage_seconds += (t1 - t0) + (t3 - t2)
        self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return recvs


@dataclasses.dataclass
class Mesh:
    """This rank's place in a named grid of ranks: `shape` maps each axis
    name to its size (the JAX Mesh's `shape`), `coords` to this rank's
    index along it; `groups` maps each tuple of axis names, in mesh order,
    to the process group of the ranks that differ only along those axes."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], object]
    _rings: Dict[str, P2PRing] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, *axes: str):
        """The group along one axis, or along several (any order)."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(set(axes)) or not key:
            raise KeyError(f"axes {axes} not all in mesh {self.axis_names}")
        return self.groups[key]

    def ring(self, axis: str) -> P2PRing:
        """The neighbour exchange along `axis`, made once (its staging
        buffers and counters persist)."""
        if axis not in self._rings:
            self._rings[axis] = P2PRing(self.group(axis))
        return self._rings[axis]


def make_mesh(axis_names: Tuple[str, ...] = ("dp", "sp"),
              shape: Optional[Tuple[int, ...]] = None,
              backend: Optional[str] = None) -> Mesh:
    """The mesh over every rank of the initialised default group, in the
    JAX Mesh's row-major order; shape defaults to factor_mesh of the world
    size. Every rank must call it, in the same order as any other group
    creation. backend: that of the new groups ("gloo", "nccl"); None takes
    the default group's."""
    world = dist.get_world_size()
    if shape is None:
        shape = factor_mesh(world, len(axis_names))
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"shape {shape} does not fit axes {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    rank = dist.get_rank()
    grid = torch.arange(world).reshape(shape)
    coords = dict(zip(axis_names, (int(c) for c in
                                   torch.nonzero(grid == rank)[0])))
    groups = {}
    # every subset of the axes, in a fixed order: new_group is collective
    # over the whole world, members or not
    for k in range(1, len(shape) + 1):
        for dims in itertools.combinations(range(len(shape)), k):
            others = [d for d in range(len(shape)) if d not in dims]
            moved = grid.permute(*others, *dims).reshape(-1, math.prod(
                shape[d] for d in dims))
            for ranks in moved.tolist():
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups[tuple(axis_names[d] for d in dims)] = g
    return Mesh(tuple(axis_names), dict(zip(axis_names, shape)), coords,
                groups)


def local_batch(tokens: torch.Tensor, mesh: Mesh,
                seq_axis: Optional[str] = None) -> Tuple[torch.Tensor, int]:
    """This rank's block of a global batch [..., B, T] (the JAX package's
    batch_sharding: B over "dp" where the mesh has it, T over `seq_axis`):
    [..., B/dp, T/sp], and the global position of its first token,
    rank(sp) * T/sp (0 without a sequence axis)."""
    B, T = tokens.shape[-2:]
    b0, nb, t0, nt = 0, B, 0, T
    if "dp" in mesh.shape:
        dp = mesh.size("dp")
        if B % dp:
            raise ValueError(f"batch {B} does not split over dp={dp}")
        nb = B // dp
        b0 = mesh.rank("dp") * nb
    if seq_axis is not None:
        sp = mesh.size(seq_axis)
        if T % sp:
            raise ValueError(f"sequence {T} does not split over {seq_axis}={sp}")
        nt = T // sp
        t0 = mesh.rank(seq_axis) * nt
    return tokens[..., b0:b0 + nb, t0:t0 + nt], t0
