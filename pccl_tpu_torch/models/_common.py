"""Pieces shared by the model families: RMSNorm, the rotary embedding and
the dense causal attention; the layer loop with checkpointing; the
fp32-output head product and the cross-entropy losses, and the families'
head and loss entry over them (head_logits, head_loss); and their
tensor-parallel forms: the vocab-parallel embedding lookup and
cross-entropy (whole or in sequence chunks), the row-parallel
out-projection, and the kv heads that several ranks share where tp does
not divide n_kv_head."""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from ..parallel.mesh import all_reduce_, copy_to, group_size, reduce_from
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in fp32 (eps inside the rsqrt), times the
    gain, cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * gain).to(x.dtype)


def rope(x: torch.Tensor, theta: float, pos_offset: int = 0) -> torch.Tensor:
    """Rotary embedding over the last dim of x [B, T, H, Dh] at positions
    pos_offset .. pos_offset + T - 1 (a rank's block of a sequence split
    over ranks starts at its global offset): the first and second halves
    rotate as pairs."""
    _, T, _, Dh = x.shape
    half = Dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(pos_offset, pos_offset + T, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def dense_attention(q, k, v):
    """Dense causal attention, q [B, T, H, Dh], k/v [B, T, Hkv, Dh]: GQA
    K/V repeated here (the kernels never do); scores in q's dtype, softmax
    in fp32 with a -1e30 mask, probabilities cast back. The models' attention
    where no attn_fn is given."""
    T, H, Dh = q.shape[1], q.shape[2], q.shape[3]
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(Dh))
    i = torch.arange(T, device=q.device)
    logits = logits.float().masked_fill(i[None, :] > i[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of products without a batch
    dimension (aten.mm: every `[..., d] @ W`, flattened to 2-D, and
    _MatmulF32Out's fp32-output mm) and recompute the rest, the batched
    attention products and the flash kernel included. JAX's
    checkpoint_dots_with_no_batch_dims."""
    return CheckpointPolicy.MUST_SAVE \
        if getattr(op, "overloadpacket", None) is torch.ops.aten.mm \
        else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _save_weight_products)


def _sqrt_divisor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n) (1 for primes)."""
    g = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            g = d
        d += 1
    return g


def run_blocks(block_fn, x: torch.Tensor, n_layer: int, remat) -> torch.Tensor:
    """x -> block_fn(..., l) for l in range(n_layer): the JAX package's
    lax.scan over stacked layer tensors, as a Python loop over the layer
    index, with its checkpointing (pccl_tpu/models/_common.py:scan_blocks).

    remat: False keeps every activation; True checkpoints each block (the
    backward recomputes its forward); "dots" checkpoints each block but
    keeps its weight products (_save_weight_products); "sqrt" checkpoints
    groups of G blocks, G the largest divisor of n_layer <= sqrt(n_layer),
    and each block inside a group as well, so the backward holds
    n_layer/G group inputs and, while one group is recomputed, G block
    inputs. A prime n_layer (G = 1) falls back to True."""
    if remat not in (False, True, None, "dots", "sqrt"):
        raise ValueError(f"unknown remat mode {remat!r}; use False, True, "
                         "'dots', or 'sqrt'")
    if not remat:
        for layer in range(n_layer):
            x = block_fn(x, layer)
        return x
    if remat == "sqrt":
        G = _sqrt_divisor(n_layer)
        if G == 1:
            return run_blocks(block_fn, x, n_layer, True)

        def group(h, first):
            for layer in range(first, first + G):
                h = checkpoint(block_fn, h, layer, use_reentrant=False)
            return h

        for first in range(0, n_layer, G):
            x = checkpoint(group, x, first, use_reentrant=False)
        return x
    kw = {"context_fn": _DOTS_CONTEXT} if remat == "dots" else {}
    for layer in range(n_layer):
        x = checkpoint(block_fn, x, layer, use_reentrant=False, **kw)
    return x


def layer_views(params, keys) -> list:
    """The layers' slices of the stacked [L, ...] leaves `keys` of params,
    one dict a layer. Each leaf is unbound once, so its backward
    (UnbindBackward0) stacks the L slice gradients in one pass; indexing
    params[k][layer] in every block would zero-fill a whole [L, ...]
    gradient per layer and add the L of them. Call it once per forward,
    outside any checkpoint: a block's recompute then reads the same views,
    and every gradient reaches the one unbind."""
    slices = {k: params[k].unbind(0) for k in keys}
    return [dict(zip(slices, layer)) for layer in zip(*slices.values())]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b [m, k] x [k, n] with fp32 accumulation and an fp32 result."""
    if a.dtype == torch.float32:
        return a @ b.float()
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # products of two bf16 values are exact in fp32
    return a.float() @ b.float()


class _MatmulF32Out(torch.autograd.Function):
    """x @ w with operands in x's dtype, fp32 accumulation and an fp32
    result (JAX's preferred_element_type=float32). The backward takes the
    cotangent in the operands' dtype, so both gradient products run on the
    tensor cores too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w.t()).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d] @ [d, n] in x's dtype with an fp32 result."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    return _MatmulF32Out.apply(x, w)


def gather_ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy as logsumexp(logits) - logits[target]."""
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).mean()


def chunked_ce_loss(x: torch.Tensor, head_mat: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean next-token CE without the full [B, T, vocab] logits: each
    sequence chunk's logits are computed under a checkpoint, so the backward
    recomputes them and peak logits memory is [B, chunk, vocab].

    x: [B, T, d] final hidden states; head_mat: [d, vocab]; targets [B, T].
    ``chunk`` must divide T."""
    B, T, _ = x.shape
    if T % chunk:
        raise ValueError(f"loss chunk {chunk} must divide T={T}")

    def chunk_nll(xc, tc):
        logits = matmul_f32(xc, head_mat)
        tgt = logits.gather(-1, tc[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - tgt).sum()

    tot = x.new_zeros((), dtype=torch.float32)
    for i in range(0, T, chunk):
        tot = tot + checkpoint(chunk_nll, x[:, i:i + chunk],
                               targets[:, i:i + chunk], use_reentrant=False)
    return tot / (B * T)


# ------------------------------------------------------------ tensor parallel

def tp_group(group):
    """The group a model's tp path runs over: None without one or for a
    group of 1, so that the unsharded path stays exactly what it is. The
    models' entry points (hidden, forward, loss_fn) call it; everything
    below them branches on `tp is None`."""
    return group if group_size(group) > 1 else None


class _ColumnIn(torch.autograd.Function):
    """A column-parallel in-projection x @ w with compute-dtype operands,
    taking x in fp32 (from column_input): its backward returns the
    rank's partial input gradient in fp32, so that autograd adds the
    products' shares and copy_to sums the ranks' in fp32, and the cast
    back to the compute dtype rounds once, as the unsharded product's
    gradient does. The weight gradient is the compute-dtype product's;
    with `w_sum` (columns that other ranks hold too) it is the fp32
    product passed through w_sum, which sums it over those ranks, and
    then cast once."""

    @staticmethod
    def forward(ctx, x32, w, dtype, f32_out: bool, w_sum):
        xb, wb = x32.to(dtype), w.to(dtype)
        ctx.save_for_backward(xb, wb)
        ctx.w_dtype = w.dtype
        ctx.w_sum = w_sum
        x2 = xb.reshape(-1, xb.shape[-1])
        out = _mm_f32(x2, wb) if f32_out else x2 @ wb
        return out.reshape(*xb.shape[:-1], wb.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(xb.dtype)
        dx = _mm_f32(g2, wb.t()).reshape(xb.shape)
        x2t = xb.reshape(-1, xb.shape[-1]).t()
        if ctx.w_sum is None:
            dw = (x2t @ g2).to(ctx.w_dtype)
        else:
            dw = ctx.w_sum(_mm_f32(x2t, g2)).to(xb.dtype).to(ctx.w_dtype)
        return dx, dw, None, None, None


def column_input(h: torch.Tensor, tp=None) -> torch.Tensor:
    """What the column-parallel in-projections of h take: h itself without
    a tp group; with one, h in fp32 through copy_to (see _ColumnIn)."""
    return h if tp is None else copy_to(h.float(), tp)


def column(x: torch.Tensor, w: torch.Tensor, dtype, tp, f32_out: bool = False,
           w_sum=None):
    """x @ w in `dtype` (with an fp32 result if f32_out) for x from
    column_input(h, tp): the plain product without a tp group, _ColumnIn
    with one (w_sum: see there)."""
    if tp is None:
        return matmul_f32(x, w) if f32_out else x @ w.to(dtype)
    return _ColumnIn.apply(x, w, dtype, f32_out, w_sum)


def check_tp(tp: int, widths: dict) -> None:
    """ValueError where tp does not divide one of widths (what -> size)."""
    for what, n in widths.items():
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {what}={n}")


def kv_ranges(n_head: int, n_kv_head: int, tp: int) -> list:
    """[lo, hi) of the kv heads each of tp ranks holds: those its own q
    heads [r·H/tp, (r+1)·H/tp) read, q head h reading kv head h // G. Where
    tp divides n_kv_head these are disjoint blocks; where n_kv_head
    divides tp, each rank holds one kv head and tp / n_kv_head ranks share
    it. Otherwise a rank's q heads would read its kv heads in unequal
    groups, which the GQA kernels cannot run: ValueError."""
    if n_head % tp:
        raise ValueError(f"tp={tp} does not divide n_head={n_head}")
    if n_kv_head % tp and tp % n_kv_head:
        raise ValueError(
            f"tp={tp} and n_kv_head={n_kv_head}: neither divides the other, "
            "so a rank's q heads would read its kv heads in unequal groups")
    hq, g = n_head // tp, n_head // n_kv_head
    return [(r * hq // g, ((r + 1) * hq - 1) // g + 1) for r in range(tp)]


def shared_kv_sum(dw: torch.Tensor, tp, lo: int, hi: int, n_kv_head: int,
                  head_dim: int) -> torch.Tensor:
    """The weight gradient of a rank's kv columns (k heads [lo, hi) | v
    heads [lo, hi), [d, 2·(hi-lo)·Dh]) summed over the ranks that hold the
    same heads: each rank's block is placed at its heads' columns of the
    full [d, 2·n_kv_head·Dh] layout, zeros elsewhere, the group SUMs that,
    and each rank takes its columns back. The sum runs in dw's dtype
    (fp32 from _ColumnIn)."""
    n = (hi - lo) * head_dim
    k, v = dw.chunk(2, dim=-1)
    off = n_kv_head * head_dim
    full = dw.new_zeros(*dw.shape[:-1], 2 * off)
    full[..., lo * head_dim:lo * head_dim + n] = k
    full[..., off + lo * head_dim:off + lo * head_dim + n] = v
    all_reduce_(full, tp)
    return torch.cat([full[..., lo * head_dim:lo * head_dim + n],
                      full[..., off + lo * head_dim:off + lo * head_dim + n]], -1)


def kv_grad_sum(cfg, tp):
    """column's w_sum for the kv projection of a Llama config on a tp
    group: shared_kv_sum where the group's ranks share kv heads (tp
    larger than n_kv_head), else None."""
    n = group_size(tp)
    if tp is None or cfg.n_kv_head % n == 0:
        return None
    lo, hi = kv_ranges(cfg.n_head, cfg.n_kv_head, n)[dist.get_rank(tp)]
    return functools.partial(shared_kv_sum, tp=tp, lo=lo, hi=hi,
                             n_kv_head=cfg.n_kv_head, head_dim=cfg.head_dim)


def embed(tok_emb: torch.Tensor, tokens: torch.Tensor, dtype, tp=None):
    """tok_emb[tokens] cast to dtype. With a tp group tok_emb is this rank's
    block of vocab rows [r·V/tp, (r+1)·V/tp): tokens outside it give zero
    rows, and the SUM over the group (reduce_from) adds one rank's row to
    zeros, so the result is exact."""
    tokens = tokens.long()
    if tp is None:
        return tok_emb[tokens].to(dtype)
    v = tok_emb.shape[0]
    local = tokens - dist.get_rank(tp) * v
    inside = (local >= 0) & (local < v)
    rows = tok_emb[torch.where(inside, local, 0)] * inside[..., None]
    return reduce_from(rows, tp).to(dtype)


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """x @ w for an out-projection, in x's dtype. With a tp group x holds
    this rank's block of the input features and w its block of rows: the
    partial products are fp32 (matmul_f32), summed over the group in fp32
    and cast once, where summing compute-dtype partials would round tp
    times."""
    if tp is None:
        return x @ w.to(x.dtype)
    return reduce_from(matmul_f32(x, w), tp).to(x.dtype)


class _VocabParallelCE(torch.autograd.Function):
    """Mean CE over logits split by vocab blocks over a group: the global
    max from a MAX all_reduce of the detached values, then one SUM
    all_reduce of (sum of exps, target logit); the backward is the local
    softmax minus the local one-hot. Every rank returns the same loss."""

    @staticmethod
    def forward(ctx, logits, targets, group):
        v = logits.shape[-1]
        local = targets.long() - dist.get_rank(group) * v
        inside = (local >= 0) & (local < v)
        local = torch.where(inside, local, 0)
        m = all_reduce_(logits.detach().amax(dim=-1), group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        tgt = logits.gather(-1, local[..., None])[..., 0] * inside
        sums = all_reduce_(torch.stack([e.sum(dim=-1), tgt]), group)
        ctx.save_for_backward(e, sums[0], local, inside)
        return (torch.log(sums[0]) + m - sums[1]).mean()

    @staticmethod
    def backward(ctx, g):
        e, total, local, inside = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, local[..., None], -inside[..., None].to(grad.dtype))
        return grad * (g / total.numel()), None, None


def tp_head_loss(x: torch.Tensor, head_mat: torch.Tensor, targets, tp,
                 loss_chunk) -> torch.Tensor:
    """The loss of final hidden states x against a vocab-parallel head
    block [d, V/tp] (a column-parallel product: x's cotangent sums over
    the blocks). With loss_chunk < T, chunked_ce_loss's scheme: each
    sequence chunk's logits block [B, c, V/tp] and its vocab-parallel CE
    under a checkpoint, so the backward recomputes them (with their
    collectives, in the same order on every rank); the chunk losses are
    summed and divided by B·T."""
    x_in = column_input(x, tp)
    B, T, _ = x.shape
    if not loss_chunk or T <= loss_chunk:
        return _VocabParallelCE.apply(
            column(x_in, head_mat, x.dtype, tp, f32_out=True), targets, tp)

    def chunk_nll(xc, tc):
        logits = column(xc, head_mat, x.dtype, tp, f32_out=True)
        return _VocabParallelCE.apply(logits, tc, tp) * tc.numel()

    tot = x.new_zeros((), dtype=torch.float32)
    for i in range(0, T, loss_chunk):
        tot = tot + checkpoint(chunk_nll, x_in[:, i:i + loss_chunk],
                               targets[:, i:i + loss_chunk], use_reentrant=False)
    return tot / (B * T)


# ------------------------------------------------------------ head and loss

def head_logits(x: torch.Tensor, head_mat: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits fp32 [B, T, V] of final hidden states x [B, T, d] through the
    head [d, V], with x's dtype for the operands; with a tp group, this
    rank's vocab block [B, T, V/tp] from its head block [d, V/tp]."""
    return column(column_input(x, tp), head_mat, x.dtype, tp, f32_out=True)


def head_loss(x: torch.Tensor, head_mat: torch.Tensor, targets: torch.Tensor,
              loss_chunk: "int | None" = None, tp=None) -> torch.Tensor:
    """Mean next-token cross-entropy of final hidden states x [B, T, d]
    through the head [d, V] (this rank's block [d, V/tp] with a tp group):
    with a group, tp_head_loss; else with loss_chunk < T, chunked_ce_loss;
    else gather_ce_loss of the whole head_logits. loss_chunk must divide
    T. The families' loss_fn."""
    T = targets.shape[1]
    if loss_chunk and T % loss_chunk:
        raise ValueError(f"loss_chunk {loss_chunk} must divide T={T}")
    if tp is not None:
        return tp_head_loss(x, head_mat, targets, tp, loss_chunk)
    if loss_chunk and T > loss_chunk:
        return chunked_ce_loss(x, head_mat, targets, loss_chunk)
    return gather_ce_loss(head_logits(x, head_mat), targets)
