"""The system under test: the one place that maps a configuration file onto
the port's model config (pccl_tpu_torch.models), through the model type's
family (families/<model_type>.py). The peer loops import the port's
training, DiLoCo and comm modules themselves, as user code does."""

from __future__ import annotations

from portbench import spec


def model_config(cfg: dict, block: int, here=spec.HERE):
    """configs/<name>.json -> the port's model config at sequence length
    `block`."""
    return spec.family(cfg["model_type"], here).port_config(cfg, block)
