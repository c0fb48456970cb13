"""The plain reference: fp32 PyTorch with TF32 off, written from the
models' published descriptions and the port's documented departures. It
imports neither jax, nor pccl_tpu, nor pccl_tpu_torch: it takes the seed's
inputs from portbench.weights and works everything else out itself."""
