"""Streaming int8 ResNet-50 (the v2 walk): each activation is quantized
once, in its producer's epilogue, with its consumer's calibrated scale, so
only int8 codes pass between convolutions.

The same quantized tree and scale vector as the v1 walk
(``resnet_int8.quantize_resnet``, ``resnet_int8.calibrate_activation_scales``),
walked as the JAX package's ``models/resnet_int8_stream.py``:
- the stem max pool runs on codes (quantization is monotonic, so pooling
  then quantizing equals quantizing then pooling);
- a bottleneck's residual is the block input's codes dequantized in
  bfloat16 (or its downsample conv on the same codes, with the block
  input's scale), added to conv3's bfloat16 output; the sum is quantized
  once for the next block;
- the last block's output stays bfloat16 for the float32 mean pool and the
  dense heads.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from iqc_tpu_torch.models.int8_conv import conv_int8
from iqc_tpu_torch.models.resnet_int8 import (BF16, dequant_affine, head, nn_max_pool,
                                              quantize_codes)


def _conv_affine(q_in: torch.Tensor, s_in: torch.Tensor, layer: Dict, stride: int = 1,
                 padding="SAME") -> torch.Tensor:
    """int8 codes -> int32 conv -> bfloat16 dequant affine (BatchNorm folded)."""
    acc = conv_int8(q_in, layer["w"], stride, padding)
    return dequant_affine(acc, (s_in * layer["mult"]).to(BF16), layer["bias_bf16"])


def apply(q: Dict, images: torch.Tensor, act_scales: torch.Tensor,
          stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> torch.Tensor:
    """Streaming int8 forward of a ``resnet_int8.device_tree``; images:
    normalised float NHWC -> logits float32. ``act_scales``: the [n_convs]
    vector of the v1 walk (required), on the images' device."""
    if act_scales is None:
        raise ValueError("the streaming walk needs static activation scales")
    i = 0
    s_stem = act_scales[i]
    i += 1
    x_q = quantize_codes(images.to(BF16), s_stem)
    y = torch.relu(_conv_affine(x_q, s_stem, q["stem"], stride=2, padding=[(3, 3), (3, 3)]))
    x_q = nn_max_pool(quantize_codes(y, act_scales[i]))

    n_total = sum(stage_sizes)
    done = 0
    x_bf = None
    for si, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            stride = 2 if si > 0 and j == 0 else 1
            block = q["stages"][si][j]
            has_down = "down" in block
            s1, s2, s3 = act_scales[i], act_scales[i + 1], act_scales[i + 2]
            i += 4 if has_down else 3
            done += 1
            last = done == n_total

            y = torch.relu(_conv_affine(x_q, s1, block["conv1"]))
            y = torch.relu(_conv_affine(quantize_codes(y, s2), s2, block["conv2"], stride=stride))
            y = _conv_affine(quantize_codes(y, s3), s3, block["conv3"])
            if has_down:
                residual = _conv_affine(x_q, s1, block["down"], stride=stride)
            else:
                residual = x_q.to(BF16) * s1.to(BF16)
            y = torch.relu(y + residual)
            if last:
                x_bf = y
            else:
                x_q = quantize_codes(y, act_scales[i])
    return head(torch.mean(x_bf.to(torch.float32), dim=(1, 2)), q)
