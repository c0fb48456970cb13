"""The system under test: the one place that maps a configuration file onto
the port's model config (pccl_tpu_torch.models). The peer loops import the
port's training, DiLoCo and comm modules themselves, as user code does."""

from __future__ import annotations


def model_config(cfg: dict, block: int):
    """configs/<name>.json -> GPTConfig or LlamaConfig at sequence length
    `block`."""
    if cfg["model_type"] == "gpt2":
        from pccl_tpu_torch.models.gpt import GPTConfig

        return GPTConfig(vocab_size=cfg["vocab_size"], n_layer=cfg["n_layer"],
                         n_head=cfg["n_head"], n_embd=cfg["n_embd"],
                         block_size=block,
                         rope_theta=cfg["assumed"]["rope_theta"])
    from pccl_tpu_torch.models.llama import LlamaConfig

    out = LlamaConfig(vocab_size=cfg["vocab_size"],
                      n_layer=cfg["num_hidden_layers"],
                      n_head=cfg["num_attention_heads"],
                      n_kv_head=cfg["num_key_value_heads"],
                      n_embd=cfg["hidden_size"],
                      ffn_dim=cfg["intermediate_size"], block_size=block,
                      rope_theta=cfg["rope_theta"])
    if out.head_dim != cfg["head_dim"]:
        raise ValueError(f"head_dim {cfg['head_dim']} is not hidden_size / "
                         f"num_attention_heads = {out.head_dim}")
    return out
