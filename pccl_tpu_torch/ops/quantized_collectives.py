"""int8 ring all-reduce over a torch.distributed process group
(pccl_tpu/ops/quantized_collectives.py, there over a mesh axis inside
shard_map).

Algorithm, as in the JAX package (and the native ring, reduce.cpp):

- reduce-scatter: n-1 hops, each carrying blockwise symmetric int8 codes
  and one fp32 scale per block. The receiver dequantizes, adds its own
  chunk in fp32, and requantizes the partial sum with fresh scales for the
  next hop.
- all-gather: the owner quantizes its fully reduced chunk once; the codes
  are forwarded verbatim and the owner dequantizes its own. Every rank
  therefore decodes the same bytes and returns bit-identical values: the
  invariant the shared-state hash depends on.

Each hop is one `dist.batch_isend_irecv` (send to rank + 1, receive from
rank - 1) through `parallel/mesh.P2PRing`, which stages card tensors
through pinned host buffers on gloo. The codec is torch ops on the
tensor's device.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..parallel.mesh import P2PRing


def _quantize_block(x: torch.Tensor, block: int):
    """Blockwise symmetric int8: codes in [-127, 127], one fp32 scale per
    block. x is 1-D fp32 with size % block == 0. Round half to even."""
    xb = x.reshape(-1, block)
    s = xb.abs().amax(dim=1, keepdim=True) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return q.reshape(-1), s.reshape(-1).to(torch.float32)


def _dequantize_block(q: torch.Tensor, s: torch.Tensor, block: int) -> torch.Tensor:
    return (q.reshape(-1, block).to(torch.float32) * s.reshape(-1, 1)).reshape(-1)


def quantized_ring_all_reduce(x: torch.Tensor, group, *, block: int = 256,
                              mean: bool = False) -> torch.Tensor:
    """int8 ring all-reduce of x (any shape, fp32 or bf16) over `group`;
    every rank of the group must call it. Returns the sum (or with mean,
    the mean) in x's dtype and shape, bit-identical on every rank. A group
    of one rank returns x's values."""
    return _ring_all_reduce(x, P2PRing(group), block, mean)


def _ring_all_reduce(x: torch.Tensor, ring: P2PRing, block: int,
                     mean: bool) -> torch.Tensor:
    n, rank = ring.size, ring.rank
    flat = x.detach().reshape(-1).to(torch.float32)
    # pad so the vector splits into n chunks of whole blocks
    chunk = -(-flat.numel() // (n * block)) * block
    size = flat.numel()
    chunks = torch.nn.functional.pad(flat, (0, n * chunk - size)).reshape(n, chunk)
    if n == 1:
        return chunks.reshape(-1)[:size].reshape(x.shape).to(x.dtype)

    # reduce-scatter: after hop s this rank holds the partial sum of chunk
    # (rank - s - 1), which has visited ranks rank - s - 1 .. rank
    q, sc = _quantize_block(chunks[rank], block)
    for s in range(n - 1):
        q, sc = ring.shift([q, sc])
        acc = _dequantize_block(q, sc, block) + chunks[(rank - s - 1) % n]
        q, sc = _quantize_block(acc, block)
    # q, sc: chunk (rank + 1) % n, fully reduced and quantized once, here

    # all-gather: verbatim forwarding for bit parity
    out = torch.empty((n, chunk), dtype=torch.float32, device=x.device)
    out[(rank + 1) % n] = _dequantize_block(q, sc, block)
    for s in range(1, n):
        q, sc = ring.shift([q, sc])
        # the packet forwarded s hops began at rank - s, owner of chunk
        # rank - s + 1
        out[(rank - s + 1) % n] = _dequantize_block(q, sc, block)
    out = out.reshape(-1)[:size]
    if mean:
        out = out / n
    return out.reshape(x.shape).to(x.dtype)


def quantized_pmean(tree, group, *, block: int = 256):
    """The quantized mean of every tensor of a tree over `group`: new
    tensors with each leaf's dtype and shape (JAX's quantized_pmean). The
    leaves share one P2PRing, and with it its staging buffers."""
    ring = P2PRing(group)
    return pytree.tree_map(lambda t: _ring_all_reduce(t, ring, block, True), tree)
