"""Mixture-of-Experts: top-1 routing with expert parallelism over a mesh
axis (pccl_tpu/ops/moe.py), and a dropless top-k expert layer on one rank
(moe_topk, models/lfm2.py's expert FFN; the JAX package has none).

Top-1 EP: Switch-style top-1 routing with Mesh-TensorFlow's dispatch algebra:
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

Dropless top-k (moe_topk): router logits in fp32 from the normed h, scores
s = sigmoid(logits); each token's k experts are the top k of s + bias (the
bias, a buffer, enters the choice only); their weights are the chosen s,
renormalised to sum to one with norm_topk_prob, times `scale`. The n·k
slots are sorted by expert on the device and their rows gathered, each
expert's rows one segment (offsets from a device cumsum of the counts);
the experts' SwiGLU runs as two grouped products over the segments
(ops/moe_gemm.py: the gate and up columns as one [d, 2f] product, then the
down product), and the slots are added back to their tokens with their
weights in fp32 (index_add). Every token reaches all k experts, whatever
the load; nothing in the layer waits for the card (no .item(), no host
copy, no shape that depends on the routing).

Counters: moe_topk adds each layer's slots routed to each expert into a
device tensor (no sync); stats() reads them with the grouped products'
launches. Sections `moe.route`, `moe.experts` and `moe.combine` go to the
profiler moe_topk is given (utils/profiler.Profiler).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_to_all, copy_to
from . import moe_gemm


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


# ------------------------------------------------------------ dropless top-k

# layer -> slots routed to each expert [E] int64 on the device, summed over
# the forward passes since reset_stats() (a checkpointed layer's recompute
# counts again)
_LOADS: Dict[int, torch.Tensor] = {}


def reset_stats() -> None:
    _LOADS.clear()
    moe_gemm.reset_launch_counts()


def stats() -> dict:
    """{"loads": {layer: [slots of each expert]}, "max_over_mean": {layer:
    the busiest expert's slots over the mean}, "launches": the grouped
    products' launches}. Reads the device counters (a sync)."""
    loads = {l: c.tolist() for l, c in sorted(_LOADS.items())}
    imbalance = {l: max(c) * len(c) / max(1, sum(c)) for l, c in loads.items()}
    return {"loads": loads, "max_over_mean": imbalance,
            "launches": dict(moe_gemm.launches)}


def route_topk(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, k: int,
               norm_topk_prob: bool = True, scale: float = 1.0):
    """h [n, d] -> (experts [n, k] int64, weights [n, k] fp32): the top k
    of sigmoid(h @ router) + bias, weighted by their scores (renormalised
    with norm_topk_prob) times scale. The logits are fp32."""
    scores = torch.sigmoid(h.float() @ router)
    experts = torch.topk(scores.detach() + bias, k, dim=-1).indices
    weights = scores.gather(-1, experts)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return experts, weights * scale


def moe_topk(h: torch.Tensor, router: torch.Tensor, gate_up: torch.Tensor,
             down: torch.Tensor, bias: torch.Tensor, *, k: int,
             norm_topk_prob: bool = True, scale: float = 1.0, layer=None,
             profiler=None) -> torch.Tensor:
    """The dropless top-k SwiGLU expert layer of h [B, T, d] in h's dtype
    (see the module's docstring): router [d, E] fp32, gate_up [E, d, 2f]
    (gate columns, then up), down [E, f, d], bias [E] (not trained).
    layer: the key of its load counter (None counts nothing)."""
    section = (lambda name: contextlib.nullcontext()) if profiler is None \
        else profiler.section
    B, T, d = h.shape
    E = router.shape[-1]
    x = h.reshape(B * T, d)
    with section("moe.route"):
        experts, weights = route_topk(x, router, bias, k, norm_topk_prob, scale)
        flat = experts.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        token_of_slot = order // k
        counts = torch.zeros(E, dtype=torch.int64, device=h.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
        if layer is not None:
            _LOADS[layer] = _LOADS[layer] + counts if layer in _LOADS else counts
        rows = torch.index_select(x, 0, token_of_slot)
    with section("moe.experts"):
        gate, up = moe_gemm.grouped_mm(rows, gate_up, offsets).chunk(2, dim=-1)
        y = moe_gemm.grouped_mm(F.silu(gate) * up, down, offsets)
    with section("moe.combine"):
        # y in h's dtype times the fp32 weight: an fp32 product, added in fp32
        slot_w = weights.reshape(-1)[order]
        out = torch.zeros(B * T, d, dtype=torch.float32, device=h.device).index_add(
            0, token_of_slot, y * slot_w[:, None])
    return out.to(h.dtype).reshape(B, T, d)
