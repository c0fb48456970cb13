"""The peers' training loops, one module a traffic mode: copies of the
user's loops in pccl_tpu_torch/examples, frozen here as the yardstick."""
