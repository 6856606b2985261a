"""int8 ResNet-50: quantization of the trained network, the int8 forward
with a quantize before every convolution (the v1 walk), and calibration of
its activation scales.

Scheme (post-training quantization, as the JAX package's
``models/resnet_int8.py``):
- weights: per-output-channel symmetric int8; the weight scale and the
  inference BatchNorm slope fold into one dequant multiplier and a bias;
- activations: per-tensor symmetric int8 with statically calibrated scales
  (``calibrate_activation_scales``: per-convolution input absmax / 127, the
  running max over sample batches);
- int8 x int8 -> int32 convolutions (``int8_conv``); the dequant epilogue
  ``acc * (s_in * mult) + bias``, ReLU, residual adds and pooling in
  bfloat16; the mean pool and the two dense heads in float32.

``quantize_resnet`` runs in numpy on the Flax variables (HWIO kernels) in
the JAX package's order of operations, so the int8 tree it returns equals
the JAX one. ``device_tree`` puts such a tree (from either package) on a
device in the form the forwards take.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.models.int8_conv import conv_int8, prepare_weight

BF16 = torch.bfloat16


def _fold_bn(bn_params: Dict, bn_stats: Dict, eps: float = 1e-5):
    """Inference BatchNorm -> per-channel affine (a, b): y = a*x + b."""
    gamma = np.asarray(bn_params["scale"], np.float32)
    beta = np.asarray(bn_params["bias"], np.float32)
    mean = np.asarray(bn_stats["mean"], np.float32)
    var = np.asarray(bn_stats["var"], np.float32)
    a = gamma / np.sqrt(var + eps)
    return a, beta - mean * a


def _quant_conv_weights(kernel: np.ndarray):
    """HWIO float kernel -> (int8 kernel, per-output-channel scale [co])."""
    k = np.asarray(kernel, np.float32)
    scale = np.max(np.abs(k), axis=(0, 1, 2)) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _pack_conv(params: Dict, stats: Dict, conv_name: str, bn_name: str) -> Dict:
    w_q, w_scale = _quant_conv_weights(params[conv_name]["kernel"])
    a, b = _fold_bn(params[bn_name], stats[bn_name])
    return {"w_q": w_q, "mult": w_scale * a, "bias": b}


def quantize_resnet(variables: Dict, stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> Dict:
    """Flax ResNet-50 variables (numpy leaves) -> int8 tree of numpy arrays:
    {"stem", "stages": [[{"conv1", "conv2", "conv3"[, "down"]}]], "head1",
    "head2"}; each conv {"w_q" HWIO int8, "mult" [co] f32, "bias" [co] f32}."""
    params, stats = variables["params"], variables["batch_stats"]
    q: Dict[str, Any] = {"stem": _pack_conv(params, stats, "stem_conv", "stem_bn"),
                         "stages": []}
    for i, n_blocks in enumerate(stage_sizes):
        stage = []
        for j in range(n_blocks):
            bp, bs = params[f"stage{i + 1}_block{j + 1}"], stats[f"stage{i + 1}_block{j + 1}"]
            block = {"conv1": _pack_conv(bp, bs, "conv1", "bn1"),
                     "conv2": _pack_conv(bp, bs, "conv2", "bn2"),
                     "conv3": _pack_conv(bp, bs, "conv3", "bn3")}
            if "downsample_conv" in bp:
                block["down"] = _pack_conv(bp, bs, "downsample_conv", "downsample_bn")
            stage.append(block)
        q["stages"].append(stage)
    for name, src in (("head1", "head_dense1"), ("head2", "head_dense2")):
        q[name] = {"kernel": np.asarray(params[src]["kernel"], np.float32),
                   "bias": np.asarray(params[src]["bias"], np.float32)}
    return q


def device_tree(node, device) -> Any:
    """A numpy int8 tree -> the same tree on ``device``: each conv leaf
    {"w": ConvWeight, "mult" f32, "bias" f32, "bias_bf16"}, dense leaves
    {"kernel", "bias"} f32."""
    if isinstance(node, dict):
        if "w_q" in node:
            bias = torch.as_tensor(np.array(node["bias"], np.float32), device=device)
            return {"w": prepare_weight(torch.as_tensor(np.array(node["w_q"], np.int8),
                                                        device=device)),
                    "mult": torch.as_tensor(np.array(node["mult"], np.float32), device=device),
                    "bias": bias, "bias_bf16": bias.to(BF16)}
        if "kernel" in node:
            return {k: torch.as_tensor(np.array(v, np.float32), device=device)
                    for k, v in node.items()}
        return {k: device_tree(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [device_tree(v, device) for v in node]
    return node


def quantize_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Activations -> int8 codes: round(x / scale) clipped to [-127, 127],
    in float32. ``scale`` is a 0-dim tensor on x's device, so the division
    is a true division on every device."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def dequant_affine(acc: torch.Tensor, mult_bf16: torch.Tensor,
                   bias_bf16: torch.Tensor) -> torch.Tensor:
    """int32 accumulators -> bfloat16 ``acc * mult + bias``, each op rounded."""
    return acc.to(BF16) * mult_bf16 + bias_bf16


def _dyn_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.amax(torch.abs(x.to(torch.float32))) / 127.0, min=1e-12)


def _qconv(x: torch.Tensor, layer: Dict, ctx: Dict, stride: int = 1,
           padding="SAME") -> torch.Tensor:
    """Quantize x with its static (or, without scales, dynamic) scale, int8
    conv, bfloat16 dequant affine with the folded BatchNorm."""
    i = ctx["i"]
    ctx["i"] = i + 1
    s_x = ctx["scales"][i] if ctx.get("scales") is not None else _dyn_scale(x)
    if ctx.get("collect") is not None:
        ctx["collect"].append(_dyn_scale(x))
    acc = conv_int8(quantize_codes(x, s_x), layer["w"], stride, padding)
    return dequant_affine(acc, (s_x * layer["mult"]).to(BF16), layer["bias_bf16"])


def nn_max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with one pixel of padding on NHWC (the stem pool).
    int8 codes pool through a float32 cast, which is exact."""
    y = x.to(torch.float32) if x.dtype == torch.int8 else x
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    return y.to(x.dtype)


def head(features: torch.Tensor, q: Dict) -> torch.Tensor:
    """float32 pooled features -> logits through the two dense layers."""
    y = torch.relu(features @ q["head1"]["kernel"] + q["head1"]["bias"])
    return y @ q["head2"]["kernel"] + q["head2"]["bias"]


def apply(q: Dict, images: torch.Tensor, stage_sizes: Sequence[int] = (3, 4, 6, 3),
          act_scales: Optional[torch.Tensor] = None,
          _collect: Optional[List] = None) -> torch.Tensor:
    """int8 forward (v1 walk) of a ``device_tree``; images: normalised
    float NHWC -> logits float32. ``act_scales``: [n_convs] float32 on the
    images' device; None quantizes with per-batch dynamic scales."""
    ctx = {"i": 0, "scales": act_scales, "collect": _collect}
    x = images.to(BF16)
    x = torch.relu(_qconv(x, q["stem"], ctx, stride=2, padding=[(3, 3), (3, 3)]))
    x = nn_max_pool(x)
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            block = q["stages"][i][j]
            residual = x
            y = torch.relu(_qconv(x, block["conv1"], ctx))
            y = torch.relu(_qconv(y, block["conv2"], ctx, stride=stride))
            y = _qconv(y, block["conv3"], ctx)
            if "down" in block:
                residual = _qconv(residual, block["down"], ctx, stride=stride)
            x = torch.relu(y + residual)
    return head(torch.mean(x.to(torch.float32), dim=(1, 2)), q)


def n_convs(stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> int:
    """Number of quantized convs (stem + 3 a block + 1 downsample a stage)."""
    return 1 + sum(3 * n for n in stage_sizes) + len(stage_sizes)


def calibrate_activation_scales(q: Dict, sample_batches,
                                stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> torch.Tensor:
    """Per-convolution input absmax / 127 over calibration batches (running
    max), on the tree's device. Returns [n_convs] float32."""
    scales = None
    with torch.inference_mode():
        for batch in sample_batches:
            collect: List = []
            apply(q, batch, stage_sizes, act_scales=None, _collect=collect)
            s = torch.stack(collect)
            scales = s if scales is None else torch.maximum(scales, s)
    return scales


def tree_size_bytes(q) -> int:
    """Bytes of the leaves of a nested dict / list of numpy arrays, scalars
    or torch tensors."""
    if isinstance(q, dict):
        return sum(tree_size_bytes(v) for v in q.values())
    if isinstance(q, (list, tuple)):
        return sum(tree_size_bytes(v) for v in q)
    if isinstance(q, torch.Tensor):
        return q.numel() * q.element_size()
    a = np.asarray(q)
    return int(a.size) * a.dtype.itemsize
