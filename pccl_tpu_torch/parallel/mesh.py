"""A named grid of torch.distributed process groups: the port's reading of
the JAX package's device `Mesh` (pccl_tpu/parallel/mesh.py).

In JAX one program sees every device of the mesh and `shard_map` hands each
its block; here each rank is a process that holds only its own block, and
a mesh axis is the process group of the ranks that differ only along it.
Ranks are laid out row-major over the mesh's shape, as `make_mesh` in the
JAX package reshapes its device list: for axes ("dp", "sp") of shape
(D, S), rank i_dp * S + i_sp sits at (i_dp, i_sp).

The tensor-parallel rules of the JAX module (which dim of each parameter
is split over "tp") belong to the model families (their tp_specs), and
models/convert.py cuts the blocks a rank holds. Where XLA inserts the
collectives of a sharded program, a rank of the port calls them itself,
as autograd Functions over a process group:
`copy_to` (identity, backward SUM: the input of a column-parallel
product), `reduce_from` (SUM, backward identity: the output of a
row-parallel product) and `all_to_all` (lax.all_to_all over dim 0, its own
transpose).

Gloo's send, receive, all_to_all, gather and scatter take host tensors
only, so card tensors cross them through pinned host buffers (allocated
once for each role, slot and shape; `HostStage`), and several ranks can
then share one card, each a process: NCCL refuses two ranks on one device.
Gloo's all_reduce and broadcast take card tensors and stage them
themselves. The backend is the caller's choice (`make_mesh(backend=)`).
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


class HostStage:
    """Pinned host buffers for card tensors crossing a backend that takes
    host tensors only: one buffer for each (role, slot, shape, dtype),
    made at its first use and kept."""

    def __init__(self):
        self._buffers: Dict[tuple, torch.Tensor] = {}

    def __call__(self, role: str, slot: int, shape, dtype) -> torch.Tensor:
        key = (role, slot, tuple(shape), dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._buffers[key] = buf
        return buf


_STAGES: Dict[int, HostStage] = {}


def _stage_of(group) -> HostStage:
    return _STAGES.setdefault(id(group), HostStage())


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a card tensor must cross `group` through host buffers: on
    any backend but NCCL."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


# the autograd collectives' calls and bytes sent since the last
# reset_collective_stats(); with timed=True there, also their host seconds,
# each call first waiting for the card's queue to drain so that the seconds
# are the exchange's and its staging's. That wait is a synchronize a
# collective, so only a measurement asks for it.
collective_stats = {"calls": 0, "seconds": 0.0, "bytes": 0}
_timed = False


def reset_collective_stats(timed: bool = False) -> None:
    global _timed
    _timed = timed
    collective_stats.update(calls=0, seconds=0.0, bytes=0)


def _counted(fn, t: torch.Tensor):
    """fn() for a collective over t, counted in collective_stats."""
    if not _timed:
        out = fn()
    else:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        out = fn()
        collective_stats["seconds"] += time.perf_counter() - t0
    collective_stats["calls"] += 1
    collective_stats["bytes"] += t.numel() * t.element_size()
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """dist.all_reduce of t in place over group, counted; returns t."""
    _counted(lambda: dist.all_reduce(t, op=op, group=group), t)
    return t


def group_size(group) -> int:
    """The number of ranks of `group`; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product: x itself in the forward; in
    the backward the SUM of its cotangents over `group`, since each rank's
    product saw only its block of the output features. Every rank of the
    group must call it (the identity for None or a group of 1)."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel product: the SUM of the ranks' partial
    results in the forward (the same bytes on every rank); the identity in
    the backward, since each rank's loss is already the whole loss. Every
    rank of the group must call it."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def _all_to_all_raw(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()

    def exchange():
        if not _staged(group, x):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            return out
        stage = _stage_of(group)
        send = stage("a2a_send", 0, x.shape, x.dtype).copy_(x)
        recv = stage("a2a_recv", 0, x.shape, x.dtype)
        dist.all_to_all_single(recv, send, group=group)
        return recv.to(x.device)

    return _counted(exchange, x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """lax.all_to_all(x, axis, 0, 0) over `group`: x [S·k, ...] is cut
    into S blocks along dim 0, block j goes to rank j, and the result
    stacks the blocks received, in rank order. Its own transpose, so the
    backward is the same exchange. Card tensors cross gloo through pinned
    buffers, one pair for each shape."""
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not split over {n} ranks")
    return x if n == 1 else _AllToAll.apply(x, group)


def share(group, *values: int) -> list:
    """The group's rank 0's int values on every rank of it, as one int64
    broadcast (rank 0 of a peer holds the comm and decides); the values
    themselves for a one-rank peer (group None)."""
    if group is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64)
    dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return t.tolist()


@torch.no_grad()
def gather_to(x: torch.Tensor, group, dst: int = 0) -> Optional[list]:
    """Every rank's x (same shape and dtype) on the group's rank `dst`, in
    rank order, on x's device; None on the other ranks. Card tensors cross
    gloo through pinned buffers."""
    n, me = group_size(group), dist.get_rank(group)
    if n == 1:
        return [x]
    x = x.contiguous()
    staged = _staged(group, x)
    stage = _stage_of(group)
    src = stage("gather_send", 0, x.shape, x.dtype).copy_(x) if staged else x
    outs = None
    if me == dst:
        outs = [stage("gather_recv", i, x.shape, x.dtype) if staged
                else torch.empty_like(x) for i in range(n)]
    dist.gather(src, outs, dst=dist.get_global_rank(group, dst), group=group)
    if outs is None:
        return None
    return [o.to(x.device) for o in outs] if staged else outs


@torch.no_grad()
def gather_all(x: torch.Tensor, group) -> list:
    """Every rank's x (same shape and dtype), in rank order, on every rank
    of the group, on x's device."""
    n = group_size(group)
    if n == 1:
        return [x]
    x = x.contiguous()
    if not _staged(group, x):
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x, group=group)
        return outs
    stage = _stage_of(group)
    src = stage("gather_send", 0, x.shape, x.dtype).copy_(x)
    outs = [stage("gather_recv", i, x.shape, x.dtype) for i in range(n)]
    dist.all_gather(outs, src, group=group)
    return [o.to(x.device) for o in outs]


@torch.no_grad()
def scatter_from(parts: Optional[Sequence[torch.Tensor]], out: torch.Tensor,
                 group, src: int = 0) -> torch.Tensor:
    """Write rank i's part of `parts` (given on the group's rank `src`, in
    rank order, each shaped as `out`) into `out` on every rank i, in
    place; returns out."""
    n, me = group_size(group), dist.get_rank(group)
    if n == 1:
        return out.copy_(parts[0])
    staged = _staged(group, out)
    stage = _stage_of(group)
    recv = stage("scatter_recv", 0, out.shape, out.dtype) if staged \
        else torch.empty_like(out)
    ins = None
    if me == src:
        ins = [stage("scatter_send", i, out.shape, out.dtype).copy_(p) if staged
               else p.contiguous() for i, p in enumerate(parts)]
    dist.scatter(recv, ins, src=dist.get_global_rank(group, src), group=group)
    return out.copy_(recv)


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
        self._host = HostStage()
        self.seconds = 0.0
        self.stage_seconds = 0.0
        self.bytes = 0

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
            sends = [self._host("send", i, t.shape, t.dtype).copy_(t)
                     for i, t in enumerate(tensors)]
            recvs = [self._host("recv", i, t.shape, t.dtype)
                     for i, t in enumerate(tensors)]
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
