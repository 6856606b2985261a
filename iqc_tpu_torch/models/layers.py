"""Building blocks shared by the two networks.

Submodule and parameter names follow the Flax scopes of the JAX package, so
that ``weights.from_flax`` maps a checkpoint onto them by name alone.

Compute dtype follows Flax's ``dtype=`` semantics: parameters stay float32,
each convolution casts its operands to the activation dtype (bfloat16
products accumulated in float32, the output rounded to bfloat16), and
BatchNorm computes in float32 from its bfloat16 input and rounds its output.
A network in float32 runs the same operations as the plain float modules.

In training mode (``module.train()``) BatchNorm normalizes with the batch's
own statistics and moves its running averages, as Flax's
``nn.BatchNorm(use_running_average=False)`` does; ``init_flax`` draws the
initial weights from Flax's initializers. On a data-parallel mesh
(``set_mesh``) those statistics cover the global batch, as they do under
GSPMD in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iqc_tpu_torch.parallel.mesh import all_reduce_sum


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


class _ChannelSum(torch.autograd.Function):
    """Sum over every dim but 1 of a float32 CPU tensor, in sequence over
    the flattened N, H, W positions (each channel's running sum rounded at
    every add): the order and rounding of XLA's CPU reduction in the JAX
    package. The backward hands every input the gradient of its channel."""

    @staticmethod
    def forward(ctx, x):
        c = x.shape[1]
        rows = x.detach().movedim(1, -1).reshape(-1, c).numpy()
        ctx.shape = x.shape
        return torch.from_numpy(np.add.reduce(np.ascontiguousarray(rows), axis=0,
                                              dtype=np.float32))

    @staticmethod
    def backward(ctx, grad):
        shape = (1, -1) + (1,) * (len(ctx.shape) - 2)
        return grad.view(shape).expand(ctx.shape).contiguous()


def channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum of ``x`` over every dim but 1. On the CPU in XLA's
    summation order (``_ChannelSum``): the batch statistics' fast variance
    cancels ``mean(x^2)`` against ``mean(x)^2``, which on flat images
    magnifies a difference of summation order a thousandfold. On the card,
    PyTorch's reduction."""
    if x.device.type == "cpu":
        return _ChannelSum.apply(x)
    return x.sum([d for d in range(x.dim()) if d != 1])


def global_channel_moments(x: torch.Tensor, mesh=None):
    """Float32 ``mean(x)`` and ``mean(x^2)`` over every dim but 1 of the
    global batch that the data axis of ``mesh`` holds (None: this rank's
    batch alone): each rank sums its rows (``channel_sum``), one all-reduce
    sums both channel sums over the ranks, and the sums are scaled by the
    float32 reciprocal of the global count (not a mean of per-rank means).
    The all-reduce's backward all-reduces the gradient, so every rank's rows
    receive the gradient of every rank's loss through the statistics."""
    c = x.shape[1]
    sums = all_reduce_sum(mesh, torch.cat([channel_sum(x), channel_sum(x * x)]))
    n = x.numel() // c * (mesh.data_size if mesh is not None else 1)
    # a Python float is taken as float32 by the multiply: no copy to the card
    moments = sums * float(np.float32(1.0 / n))
    return moments[:c], moments[c:]


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with Flax's arithmetic:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    In evaluation mode mean and var are the running averages. In training
    mode they are the batch's, computed in float32 (also from bfloat16
    input) over every dim but 1 (``global_channel_moments``), the variance
    as ``mean(x^2) - mean(x)^2`` clipped at 0 (biased, Flax's fast
    variance); the running averages then move to ``momentum * running + (1
    - momentum) * batch`` with no Bessel correction. Autograd differentiates
    through the same formula. With a ``mesh`` (``set_mesh``) the batch
    statistics are the global batch's."""

    def __init__(self, features: int, eps: float, momentum: float = 0.97):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Computed in float32, returned in the dtype of ``x``."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.float32)
        if self.training:
            mean, mean_sq = global_channel_moments(xf, self.mesh)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def set_mesh(module: nn.Module, mesh) -> None:
    """Hand every BatchNorm of ``module`` the data-parallel mesh its training
    statistics are global over (``parallel.mesh.MeshSpec``; None: this
    rank's batch alone)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


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


# Flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# rescaled so that the variance is 1 / fan_in (the truncation's own std)
_TRUNCATED_STD = 0.87962566103423978


def init_flax(module: nn.Module, seed: int, bias_init=None) -> None:
    """Seeded init with Flax's defaults, from one CPU ``torch.Generator``:
    conv and dense kernels lecun_normal (variance 1 / fan_in, truncated at
    two standard deviations), biases 0, BatchNorm scale 1 and bias 0 with
    running mean 0 and variance 1. ``bias_init`` maps a submodule's name to
    a constant bias (YOLOv8's class prior, -4.6 on every ``cls_out``)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNCATED_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                m.weight.copy_(w * std)
                if m.bias is not None:
                    m.bias.fill_((bias_init or (lambda _: 0.0))(name))
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def exact_float32(device) -> None:
    """On a CUDA device, float32 convolutions and matrix products in full
    float32 (cuDNN and cuBLAS would take TF32 by default), so that the
    card's results compare with the CPU's and the JAX reference's."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
