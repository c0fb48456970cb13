"""The benchmark of pccl_tpu_torch on NVIDIA H100 cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every cell, configuration, traffic mix and per-layer metric is a file found
by its name in BENCHMARK.json, and every model type and token law a file
found by the name a configuration or traffic file gives (spec.py). The
harness imports the port, never the JAX package; its plain reference
(reference/) imports neither.
"""
