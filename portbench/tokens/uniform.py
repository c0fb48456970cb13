"""Uniform ids, every position its own draw."""

import torch


def draw(gen, shape, vocab: int, device):
    return torch.randint(0, vocab, shape, generator=gen, device=device)
