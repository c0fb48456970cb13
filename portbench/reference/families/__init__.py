"""The plain reference of each model type, one file a type, found by the
`model_type` of a configuration file (spec.reference_family); the harness's
side of the type is portbench/families/<type>.py. Like the rest of the
reference, these files import neither jax, nor pccl_tpu, nor
pccl_tpu_torch.

Each defines n_layer(cfg); layer(x, params, l, cfg), layer l of the
residual stream x [B, T, d] (model.loss runs each under a checkpoint);
head(params, cfg), the [d, V] matrix of the logits; and norm_eps(cfg), the
final RMSNorm's eps.
"""
