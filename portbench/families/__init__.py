"""One file a model type, found by the `model_type` of a configuration file
(spec.family): everything the harness knows of the type but its plain
reference, which is reference/families/<type>.py. A new architecture is a
new pair of files; a type with no file raises, naming the path it looked
for.

Each file defines:

- n_layer(cfg): the layers of the configuration as run;
- port_config(cfg, block): the port's model config at sequence length
  `block` (pccl_tpu_torch.models, imported inside the function);
- param_shapes(cfg): name -> (shape, std, residual) in the order the
  weights are drawn (weights.init_params); std None is a gain (ones);
- flops_per_token(cfg, seq_len): the model FLOPs of one trained token that
  `mfu` counts (recomputation not counted);
- flash_calls(cfg, batch, block): [(layers, dict(B, T, H, Hkv, D, causal,
  window)), ...], one entry for each distinct shape of the model's
  attention calls (K1-K3) with the number of layers that have it; window
  None is full causal attention (flops.visible_pairs).
"""
