"""Zipf's law of word frequency, exponent 1: id r drawn with probability
proportional to 1 / (r + 1) over the vocabulary, so the low ids repeat as
frequent words do in text. Inverse transform: uniform float64 draws from
the generator against the law's cumulative sums, all on the device."""

import torch


def draw(gen, shape, vocab: int, device):
    cdf = torch.cumsum(1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                                          device=device), 0)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)
