"""Weights across the two packages: numpy dicts with the JAX package's
names and shapes <-> this package's tensor dicts. Both layouts are the same
(stacked [n_layer, ...] tensors, [in, out] weights), so nothing is
transposed; only names and shapes are checked.

And weights across the ranks of a tensor-parallel axis (`TpShards`,
`shard_params`, `gather_params`): the dim each parameter splits along is
the one the JAX package's spec puts on "tp" (the family's tp_specs), but the
blocks are per head, not the spec's contiguous column blocks. Under
`P(None, None, "tp")` JAX stores GPT's fused `attn_qkv` [L, d, 3d] in
contiguous column blocks, so at tp=2 rank 0 would hold all of q and half
of k; GSPMD computes the same function anyway. A rank of the port runs
attention on its own heads, so its block of `attn_qkv` is q heads
[h0, h1), k heads [h0, h1) and v heads [h0, h1), and of Llama's `attn_kv`
[L, d, 2·Hkv·Dh] (k | v) the kv heads its q heads read
(models/_common.py:kv_ranges): q head h reads kv head h // G, so where tp
divides n_kv_head rank r holds kv heads [r·Hkv/tp, ...), and where tp is
a multiple of n_kv_head each rank holds one kv head, which tp / Hkv
ranks share (their copies stay equal: each one's gradient is the sum
over them). `gather_params` gives back the full tensors in the JAX
package's layout, each shared kv head taken from the first rank that
holds it.

`MeshShards` does the same for a peer of several ranks on a (dp, tp)
mesh: the full tensors on its rank (0, 0), every rank's blocks back from
them."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..parallel import mesh as mesh_lib
from . import family
from ._common import kv_ranges


def params_from_numpy(np_params: Dict[str, np.ndarray], cfg,
                      device="cuda", dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Tensors on `device` from a numpy dict whose names and shapes are
    exactly those of init_params(cfg) of the config's family."""
    want = family(cfg).param_shapes(cfg)
    if set(np_params) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(np_params))}, unexpected "
                         f"{sorted(set(np_params) - set(want))}")
    dev = resolve_device(device)
    out = {}
    for name, shape in want.items():
        arr = np.asarray(np_params[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != {shape}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev, dtype)
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """fp32 numpy copies of every tensor (bf16 is widened: numpy has no
    bf16)."""
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in params.items()}


# ------------------------------------------------------------ tp layout

# sections of the split dim that are cut separately: GPT's fused q | k | v
# and Llama's k | v, so that a rank's block holds whole heads of each
_SECTIONS = {"attn_qkv": 3, "attn_kv": 2}


def tp_layout(cfg, tp: int) -> Dict[str, Optional[int]]:
    """Name -> the dim split over tp (None: replicated) for every parameter
    of the config's family, from its tp_specs, which raises where tp does
    not split the family's widths (JAX's rules)."""
    return {name: (spec.index("tp") if "tp" in spec else None)
            for name, spec in family(cfg).tp_specs(cfg, tp).items()}


def _split(x: torch.Tensor, dim: int, sections: int, n: int) -> list:
    """The n ranks' blocks of x along dim: each of the `sections` equal
    parts of the dim cut in n, rank i's pieces concatenated."""
    parts = [sec.chunk(n, dim) for sec in x.chunk(sections, dim)]
    return [torch.cat([p[i] for p in parts], dim) if sections > 1 else parts[0][i]
            for i in range(n)]


def _join(blocks, dim: int, sections: int) -> torch.Tensor:
    """The inverse of _split: the full tensor from the ranks' blocks."""
    cut = [b.chunk(sections, dim) for b in blocks]
    return torch.cat([torch.cat([c[j] for c in cut], dim)
                      for j in range(sections)], dim)


class TpShards:
    """The per-head tp layout of a config's parameters over one mesh axis:
    `shard` cuts this rank's blocks from full tensors, `gather` joins the
    ranks' blocks into full tensors (on every rank, or on one), `scatter`
    writes each rank's block of full tensors held by one rank. Every rank
    of the axis must call gather and scatter, in the same order."""

    def __init__(self, cfg, mesh, axis: str = "tp"):
        self.group = mesh.group(axis)
        self.size = mesh.size(axis)
        self.rank = mesh.rank(axis)
        self.layout = tp_layout(cfg, self.size)
        # grouped kv heads (attn_kv, k | v): each rank's [lo, hi), in
        # columns of one section (k or v)
        if "attn_kv" in self.layout:
            dh = cfg.head_dim
            self._kv = [(lo * dh, hi * dh) for lo, hi in
                        kv_ranges(cfg.n_head, cfg.n_kv_head, self.size)]
            self._kv_width = cfg.n_kv_head * dh

    def _dim(self, name: str) -> Optional[int]:
        if name not in self.layout:
            raise KeyError(f"no tp layout for parameter {name!r}")
        return self.layout[name]

    def blocks(self, name: str, x: torch.Tensor) -> list:
        """Every rank's block of the full tensor x, in rank order."""
        dim = self._dim(name)
        if dim is None:
            return [x] * self.size
        if name == "attn_kv":
            k, v = x.chunk(2, dim)
            return [torch.cat([k.narrow(dim, lo, hi - lo), v.narrow(dim, lo, hi - lo)],
                              dim) for lo, hi in self._kv]
        return _split(x, dim, _SECTIONS.get(name, 1), self.size)

    def shard(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's block of each full tensor (new contiguous tensors for
        split parameters, the tensor itself for replicated ones)."""
        return {name: (x if self._dim(name) is None
                       else self.blocks(name, x)[self.rank].contiguous())
                for name, x in full.items()}

    def full_shape(self, name: str, shape) -> tuple:
        """The full tensor's shape from a block's."""
        dim, shape = self._dim(name), list(shape)
        if name == "attn_kv":
            shape[dim] = 2 * self._kv_width
        elif dim is not None:
            shape[dim] *= self.size
        return tuple(shape)

    def join(self, name: str, blocks) -> torch.Tensor:
        dim = self._dim(name)
        if dim is None:
            return blocks[0]
        if name == "attn_kv":
            # each column range from the first rank that holds it
            sections = [[], []]
            end = 0
            for (lo, hi), b in zip(self._kv, blocks):
                if hi > end:
                    for sec, part in zip(sections, b.chunk(2, dim)):
                        sec.append(part.narrow(dim, end - lo, hi - end))
                    end = hi
            return torch.cat([torch.cat(sec, dim) for sec in sections], dim)
        return _join(blocks, dim, _SECTIONS.get(name, 1))

    def gather(self, local: Dict[str, torch.Tensor],
               dst: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """Full tensors from every rank's blocks, in `local`'s order: on
        every rank (dst None), or on the axis's rank dst only (None on the
        others). Replicated tensors are this rank's own."""
        out = {}
        for name, x in local.items():
            x = x.detach()
            if self._dim(name) is None:
                out[name] = x
                continue
            blocks = (mesh_lib.gather_all(x, self.group) if dst is None
                      else mesh_lib.gather_to(x, self.group, dst))
            if blocks is not None:
                out[name] = self.join(name, blocks)
        return out if dst is None or self.rank == dst else None

    def scatter(self, full: Optional[Dict[str, torch.Tensor]],
                out: Dict[str, torch.Tensor], src: int = 0) -> None:
        """Write each rank's block of `full` (given on the axis's rank src)
        into that rank's tensors of `out`, in place; replicated tensors are
        broadcast from src."""
        for name, o in out.items():
            if self._dim(name) is None:
                with torch.no_grad():
                    if self.rank == src:
                        o.copy_(full[name])
                    torch.distributed.broadcast(
                        o, torch.distributed.get_global_rank(self.group, src),
                        group=self.group)
                continue
            parts = self.blocks(name, full[name]) if self.rank == src else None
            mesh_lib.scatter_from(parts, o, self.group, src)


def shard_params(full: Dict[str, torch.Tensor], cfg, mesh,
                 axis: str = "tp") -> Dict[str, torch.Tensor]:
    """This rank's blocks of full parameters (params_from_numpy's output,
    or init_params') in the per-head tp layout; no collective."""
    return TpShards(cfg, mesh, axis).shard(full)


def gather_params(local: Dict[str, torch.Tensor], cfg, mesh,
                  axis: str = "tp") -> Dict[str, torch.Tensor]:
    """The full parameters, in the JAX package's layout, on every rank of
    the axis, from each rank's blocks. Every rank must call it."""
    return TpShards(cfg, mesh, axis).gather(local)


class MeshShards:
    """A peer of several ranks on a (dp, tp) mesh (either axis may be
    missing or of size 1), seen from outside as one set of full tensors,
    the JAX package's global arrays: `gather` joins the blocks of dp row
    0's tp group into full tensors on the mesh's rank (0, 0), the `lead`
    (None on every other rank; dp rows > 0 hold the same blocks and take
    no part); `scatter` writes every rank's blocks of full tensors given on
    the lead: its tp group's blocks on dp row 0, then broadcast over "dp".
    Every rank of the mesh must call both, in the same order. Each records
    its seconds on this rank in `gather_s` / `scatter_s`, from a device
    sync before it to its last copy landing."""

    def __init__(self, cfg, mesh):
        self.group = mesh.group(*mesh.axis_names)
        self.tp = TpShards(cfg, mesh) if mesh.shape.get("tp", 1) > 1 else None
        self.dp = mesh.group("dp") if mesh.shape.get("dp", 1) > 1 else None
        self.dp_rank = mesh.rank("dp") if "dp" in mesh.shape else 0
        self.lead = self.dp_rank == 0 and (self.tp is None or self.tp.rank == 0)
        self.gather_s = self.scatter_s = 0.0

    @staticmethod
    def _sync(local: Dict[str, torch.Tensor]) -> None:
        x = next(iter(local.values()))
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def gather(self, local: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        """The full tensors on the lead, in `local`'s order (a one-rank tp
        axis: the lead's own tensors, detached); None elsewhere."""
        self._sync(local)
        t0 = time.perf_counter()
        full = None
        if self.dp_rank == 0:
            full = {name: x.detach() for name, x in local.items()} \
                if self.tp is None else self.tp.gather(local, dst=0)
        self.gather_s = time.perf_counter() - t0
        return full

    @torch.no_grad()
    def scatter(self, full: Optional[Dict[str, torch.Tensor]],
                local: Dict[str, torch.Tensor]) -> None:
        """Write each rank's blocks of `full` (given on the lead) into its
        tensors of `local`, in place."""
        t0 = time.perf_counter()
        if self.dp_rank == 0:
            if self.tp is not None:
                self.tp.scatter(full, local, src=0)
            else:
                for name, x in local.items():
                    if x.data_ptr() != full[name].data_ptr():
                        x.copy_(full[name])
        if self.dp is not None:
            src = torch.distributed.get_global_rank(self.dp, 0)
            for x in local.values():
                torch.distributed.broadcast(x, src, group=self.dp)
        self._sync(local)
        self.scatter_s = time.perf_counter() - t0
