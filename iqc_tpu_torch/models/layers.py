"""Inference-only building blocks shared by the two networks.

Submodule and parameter names follow the Flax scopes of the JAX package, so
that ``weights.from_flax`` maps a checkpoint onto them by name alone.

Compute dtype follows Flax's ``dtype=`` semantics: parameters stay float32,
each convolution casts its operands to the activation dtype (bfloat16
products accumulated in float32, the output rounded to bfloat16), and
BatchNorm computes in float32 from its bfloat16 input and rounds its output.
A network in float32 runs the same operations as the plain float modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in the dtype of ``x``; a bias is added after the
    convolution, in that dtype, as Flax's ``nn.Conv`` adds it."""
    if x.dtype == torch.float32:
        return F.conv2d(x, m.weight, m.bias, m.stride, m.padding, m.dilation, m.groups)
    w = m.weight.to(x.dtype)
    if x.is_cuda:
        y = F.conv2d(x, w, None, m.stride, m.padding, m.dilation, m.groups)
    else:
        # the CPU's bfloat16 convolution does not always round the float32
        # sum once; the float32 convolution of the rounded operands does
        y = F.conv2d(x.to(torch.float32), w.to(torch.float32), None, m.stride, m.padding,
                     m.dilation, m.groups).to(x.dtype)
    return y if m.bias is None else y + m.bias.to(x.dtype).view(1, -1, 1, 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU. Below float32 it is ``x * (1 / (1 + exp(-x)))`` with every op
    rounded to the dtype: the chain XLA lowers ``jax.nn.silu`` to for
    bfloat16 (a fused sigmoid rounds differently in about a third of the
    values)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


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
        """Computed in float32, returned in the dtype of ``x``."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


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


def exact_float32(device) -> None:
    """On a CUDA device, float32 convolutions and matrix products in full
    float32 (cuDNN and cuBLAS would take TF32 by default), so that the
    card's results compare with the CPU's and the JAX reference's."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
