"""The inputs of a run, made from --seed on the device: the weights, in the
port's parameter layout (named tensors, per-layer tensors stacked over a
leading [n_layer] dim, `x @ W` weights laid out [in, out], fp32; their
shapes from the model type's family), and each peer's token batches. The
peers and the reference call the same functions with the same seed on the
same kind of card, so both get the same numbers.

Distributions, GPT-2 style as the port's models document them: N(0, 0.02)
embedding, N(0, 1/fan_in) projections, the residual outputs scaled by
1/sqrt(2 L), unit gains.
"""

from __future__ import annotations

import math

import torch

from portbench import spec

DEFAULT_LAW = "uniform"


def _sub_seed(seed: int, stream: int) -> int:
    return (seed * 1_000_003 + 7_919 * stream) % (1 << 63)


@torch.no_grad()
def init_params(cfg: dict, seed: int, device, here=spec.HERE) -> dict:
    """fp32 parameters on `device`, one randn call a tensor from one
    generator on that device, in the order of the family's param_shapes
    (name -> (shape, std, residual); std None is a gain, ones)."""
    fam = spec.family(cfg["model_type"], here)
    res = 1.0 / math.sqrt(2 * fam.n_layer(cfg))
    gen = torch.Generator(device=device).manual_seed(_sub_seed(seed, 0))
    out = {}
    for name, (shape, std, residual) in fam.param_shapes(cfg).items():
        if std is None:
            out[name] = torch.ones(shape, device=device)
            continue
        t = torch.randn(shape, generator=gen, device=device)
        out[name] = t.mul_(std * (res if residual else 1.0))
    return out


class Batches:
    """Peer `rank`'s stream of (tokens, targets) int64 [B, T]: batch i is
    the i-th draw of the token law `law` (tokens/<law>.py; a traffic file's
    "token_law", uniform where it names none) from one generator on the
    device."""

    def __init__(self, seed: int, rank: int, batch: int, block: int,
                 vocab: int, device, law=None, here=spec.HERE):
        self.shape = (batch, block + 1)
        self.vocab = vocab
        self.device = device
        self.law = spec.token_law(law or DEFAULT_LAW, here)
        self.gen = torch.Generator(device=device).manual_seed(
            _sub_seed(seed, 1 + rank))

    def next(self):
        x = self.law.draw(self.gen, self.shape, self.vocab, self.device)
        return x[:, :-1], x[:, 1:]

