"""Inference-only building blocks shared by the two networks.

Submodule and parameter names follow the Flax scopes of the JAX package, so
that ``weights.from_flax`` maps a checkpoint onto them by name alone.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with Flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def init_random(module: nn.Module, seed: int) -> None:
    """Seeded He-normal init of conv and dense weights (BatchNorm stays at
    identity): the weights used when a checkpoint path is empty or missing."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
