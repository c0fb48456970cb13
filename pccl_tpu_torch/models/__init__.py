"""The model families, one module each (gpt, llama, lfm2), and `family`,
the one lookup from a config to its module. What the families share is in
models/_common.py. Each family module offers: param_shapes, init_params,
hidden, forward, loss_fn (parallel/train.py calls it alike for every
family: profiler goes to the families that record sections), tiny_config,
ONE_RANK (True: tensor and sequence parallelism refused) and, where that
is False, tp_specs(cfg, tp) (each parameter's split dim, the JAX
package's rules; models/convert.py cuts the blocks). A family whose model
reads tensors that no optimizer trains offers init_buffers too."""

from . import gpt, lfm2, llama

_FAMILIES = {gpt.GPTConfig: gpt, llama.LlamaConfig: llama, lfm2.Lfm2MoeConfig: lfm2}


def family(cfg):
    """The model module of a config's family: models.gpt for a GPTConfig,
    models.llama for a LlamaConfig, models.lfm2 for an Lfm2MoeConfig;
    TypeError for any other type."""
    try:
        return _FAMILIES[type(cfg)]
    except KeyError:
        raise TypeError(f"no model family for a {type(cfg).__name__}") from None
