"""Mixture-of-Experts with expert parallelism over a mesh axis
(pccl_tpu/ops/moe.py).

Switch-style top-1 routing with Mesh-TensorFlow's dispatch algebra:
- tokens are split over the `ep` axis (their batch rows), and the stacked
  expert FFN weights over the same axis (E/S experts a rank);
- each rank routes its own tokens: the top-1 expert, its gate
  probability, the slot in that expert by a cumulative sum; tokens past an
  expert's capacity C are dropped (capacity_factor scales C);
- dispatch and combine are einsums against a [n, E, C] 0/1 mask;
- the only traffic between ranks is one all_to_all taking the dispatched
  buckets to their expert's rank and one bringing the results back
  (parallel/mesh.all_to_all, its own transpose under autograd).

The routing and the FFN are torch ops, as they are jnp in the JAX package,
which has no Pallas kernel here. The gate is replicated over the axis, so
its gradient sums over the ranks (copy_to).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_to_all, copy_to


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int) -> Dict[str, torch.Tensor]:
    """The gate [d, E] and the stacked expert FFN weights [E, d, f] and
    [E, f, d], fp32 on the generator's device, N(0, 1/fan_in) as in the
    JAX package (other numbers: tests pass weights across)."""
    dev = generator.device

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)

    return {"gate": normal((d_model, n_experts), d_model),
            "w_in": normal((n_experts, d_model, d_ff), d_model),
            "w_out": normal((n_experts, d_ff, d_model), d_ff)}


def shard_moe_params(params: Dict[str, torch.Tensor], mesh,
                     axis: str = "ep") -> Dict[str, torch.Tensor]:
    """This rank's experts [E/S, ...] of w_in and w_out; the gate whole."""
    S, r = mesh.size(axis), mesh.rank(axis)
    E = params["gate"].shape[-1]
    if E % S:
        raise ValueError(f"{E} experts do not split over {S} ranks")
    El = E // S
    return {"gate": params["gate"],
            "w_in": params["w_in"][r * El:(r + 1) * El].contiguous(),
            "w_out": params["w_out"][r * El:(r + 1) * El].contiguous()}


def _route(x2d: torch.Tensor, gate: torch.Tensor, capacity: int):
    """Top-1 routing. x2d [n, d] -> (dispatch [n, E, C] fp32 0/1, the
    chosen expert's probability [n]). A token's slot is its 1-based count
    among the tokens routed to its expert; past the capacity it is dropped
    (a zero row). The slot mask is a comparison, where JAX's one_hot of -1
    or of an index >= C is a zero row."""
    E = gate.shape[-1]
    probs = torch.softmax(x2d.float() @ gate, dim=-1)          # [n, E]
    expert = probs.argmax(dim=-1)                              # first max
    p = probs.amax(dim=-1)
    onehot = (expert[:, None] == torch.arange(E, device=x2d.device)).float()
    pos = torch.cumsum(onehot, dim=0) * onehot                 # 1-based slot
    within = (pos <= capacity).float()
    slot = (pos - 1).long()[..., None] == torch.arange(capacity, device=x2d.device)
    return (onehot * within)[:, :, None] * slot.float(), p


def _expert_ffn(buckets: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """buckets [..., El, C, d] through the local experts [El, d, f] and
    [El, f, d], in compute_dtype, GELU with the tanh approximation."""
    h = torch.einsum("...ecd,edf->...ecf", buckets.to(compute_dtype),
                     w_in.to(compute_dtype))
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("...ecf,efd->...ecd", h, w_out.to(compute_dtype))


def moe_mlp_dense(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
                  capacity_factor: float = 1.0,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One process's reference. x [B, T, d] -> [B, T, d]; capacity
    max(1, floor(n·cf/E)) over all n = B·T tokens."""
    B, T, d = x.shape
    E = params["gate"].shape[-1]
    n = B * T
    C = max(1, int(n * capacity_factor / E))
    x2d = x.reshape(n, d)
    dispatch, p = _route(x2d, params["gate"], C)
    buckets = torch.einsum("nec,nd->ecd", dispatch, x2d.float())
    y = _expert_ffn(buckets, params["w_in"], params["w_out"], compute_dtype)
    out = torch.einsum("nec,ecd->nd", dispatch, y.float())
    return (out * p[:, None]).reshape(B, T, d).to(x.dtype)


def capacity_ep(n_local: int, capacity_factor: float, n_experts: int) -> int:
    """The slots a rank dispatches to each expert: max(1, ceil(int(n_local
    · cf) / E)), JAX's per-shard bound (so an expert's load is bounded by
    S·C = n_global·cf/E, the dense bound, with traffic proportional to the
    local tokens; drops are counted per shard)."""
    return max(1, -(-int(n_local * capacity_factor) // n_experts))


def moe_mlp_ep(x_local: torch.Tensor, params_local: Dict[str, torch.Tensor],
               mesh, *, axis: str = "ep", capacity_factor: float = 1.0,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Expert-parallel MoE MLP on this rank's tokens x_local [b, T, d] and
    its experts (shard_moe_params); every rank of the axis must call it.
    Equal to moe_mlp_dense on the global batch when no token exceeds a
    capacity (the same routing and per-token arithmetic)."""
    group = mesh.group(axis)
    S = mesh.size(axis)
    gate = copy_to(params_local["gate"], group)
    E = gate.shape[-1]
    El = params_local["w_in"].shape[0]
    if El * S != E:
        raise ValueError(f"{El} local experts x {S} ranks != {E} experts")
    b, t, d = x_local.shape
    C = capacity_ep(b * t, capacity_factor, E)
    x2d = x_local.reshape(b * t, d)
    dispatch, p = _route(x2d, gate, C)
    buckets = torch.einsum("nec,nd->ecd", dispatch, x2d.float())
    # to the experts' ranks: [E, C, d] -> [S, El, C, d], block j to rank j
    recv = all_to_all(buckets.reshape(S, El, C, d), group)
    y = _expert_ffn(recv, params_local["w_in"], params_local["w_out"],
                    compute_dtype)
    back = all_to_all(y.float(), group).reshape(E, C, d)
    out = torch.einsum("nec,ecd->nd", dispatch, back)
    return (out * p[:, None]).reshape(b, t, d).to(x_local.dtype)
