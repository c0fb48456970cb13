"""What tests/test_torch_model_gpt.py and tests/test_torch_model_llama.py
hold the stacked leaves' views (models/_common.layer_views) to: the model's
`hidden` as it was before them, and the autograd nodes that reach each
leaf. Imports no JAX."""

from __future__ import annotations

import collections

from pccl_tpu_torch.models._common import embed, rmsnorm, run_blocks


def indexed_hidden(mod):
    """mod.hidden (models.gpt or models.llama) as it was before layer_views:
    every block indexes params[k][layer] inside its own checkpoint, a
    select per layer and leaf. Unsharded only."""

    def hidden(params, tokens, cfg, attn_fn=None, remat=False, pos_offset=0,
               tp=None):
        assert tp is None
        x = embed(params["tok_emb"], tokens, cfg.compute_dtype)
        x = run_blocks(lambda h, layer: mod.block(
            h, {k: params[k][layer] for k in mod.LAYER_KEYS}, cfg, attn_fn,
            pos_offset), x, cfg.n_layer, remat)
        return rmsnorm(x, params["lnf_g"])

    return hidden


def edges_into(loss, leaves) -> dict:
    """leaf name -> Counter of the names of the autograd nodes with an edge
    into that leaf's AccumulateGrad, over the graph behind loss."""
    names = {id(v): k for k, v in leaves.items()}
    into = {k: collections.Counter() for k in leaves}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            leaf = getattr(nxt, "variable", None)
            if leaf is not None and id(leaf) in names:
                into[names[id(leaf)]][node.name()] += 1
            todo.append(nxt)
    return into
