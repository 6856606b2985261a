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

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from iqc_tpu_torch.models.int8_conv import conv_int8
from iqc_tpu_torch.models.resnet_int8 import (BF16, dequant_affine, head, nn_max_pool,
                                              quantize_codes)


Trace = Optional[List[Tuple[str, torch.Tensor]]]


def _conv_affine(q_in: torch.Tensor, s_in: torch.Tensor, layer: Dict, stride: int = 1,
                 padding="SAME", trace: Trace = None, name: str = "") -> torch.Tensor:
    """int8 codes -> int32 conv -> bfloat16 dequant affine (BatchNorm folded)."""
    acc = conv_int8(q_in, layer["w"], stride, padding)
    out = dequant_affine(acc, (s_in * layer["mult"]).to(BF16), layer["bias_bf16"])
    if trace is not None:
        trace += [(f"{name}.acc", acc), (f"{name}.affine", out)]
    return out


def _codes(y: torch.Tensor, scale: torch.Tensor, trace: Trace, name: str) -> torch.Tensor:
    q = quantize_codes(y, scale)
    if trace is not None:
        trace.append((f"{name}.codes", q))
    return q


def apply(q: Dict, images: torch.Tensor, act_scales: torch.Tensor,
          stage_sizes: Sequence[int] = (3, 4, 6, 3), trace: Trace = None) -> torch.Tensor:
    """Streaming int8 forward of a ``resnet_int8.device_tree``; images:
    normalised float NHWC -> logits float32. ``act_scales``: the [n_convs]
    vector of the v1 walk (required), on the images' device. ``trace``, a
    list, receives (name, tensor) of every layer's input codes, int32
    accumulators and bfloat16 affine output in order (for comparing two
    devices layer by layer)."""
    if act_scales is None:
        raise ValueError("the streaming walk needs static activation scales")
    i = 0
    s_stem = act_scales[i]
    i += 1
    x_q = _codes(images.to(BF16), s_stem, trace, "stem")
    y = torch.relu(_conv_affine(x_q, s_stem, q["stem"], stride=2, padding=[(3, 3), (3, 3)],
                                trace=trace, name="stem"))
    x_q = nn_max_pool(_codes(y, act_scales[i], trace, "stage1_block1.conv1"))

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

            name = f"stage{si + 1}_block{j + 1}"
            kw = {"trace": trace}
            y = torch.relu(_conv_affine(x_q, s1, block["conv1"], name=f"{name}.conv1", **kw))
            y = torch.relu(_conv_affine(_codes(y, s2, trace, f"{name}.conv2"), s2,
                                        block["conv2"], stride=stride, name=f"{name}.conv2",
                                        **kw))
            y = _conv_affine(_codes(y, s3, trace, f"{name}.conv3"), s3, block["conv3"],
                             name=f"{name}.conv3", **kw)
            if has_down:
                residual = _conv_affine(x_q, s1, block["down"], stride=stride,
                                        name=f"{name}.downsample", **kw)
            else:
                residual = x_q.to(BF16) * s1.to(BF16)
            y = torch.relu(y + residual)
            if trace is not None:
                trace.append((f"{name}.out", y))
            if last:
                x_bf = y
            else:
                nxt = f"stage{si + 1 + (j + 1 == n_blocks)}_block{1 if j + 1 == n_blocks else j + 2}"
                x_q = _codes(y, act_scales[i], trace, f"{nxt}.conv1")
    features = torch.mean(x_bf.to(torch.float32), dim=(1, 2))
    logits = head(features, q)
    if trace is not None:
        trace += [("features", features), ("logits", logits)]
    return logits
