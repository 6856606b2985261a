"""ResNet-50 (v1 bottleneck) defect classifier for inference, with the head
Dense(512) -> ReLU -> Dense(num_classes) (dropout is inactive at inference).

The forward takes NHWC float [B,H,W,3] (ImageNet-normalised) and returns
logits [B,C]. Inside, activations are NCHW. BatchNorm epsilon is 1e-5.

Padding follows the checkpoints' Flax definition: the stem conv pads (3,3)
and the max pool (1,1), explicitly; every other conv pads "SAME", which for
a stride-2 3x3 conv on an even input is (0,1), not (1,1), so it is padded
explicitly with ``F.pad``.

``dtype=torch.bfloat16`` runs the backbone in bfloat16 (``layers``); the
pooled features and the head stay float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from iqc_tpu_torch.models.layers import BatchNorm, conv2d
from iqc_tpu_torch.ops import image as imops


def _same_pad(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """Bias-free conv with TensorFlow/Flax "SAME" padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride, padding=0, bias=False)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pad(x.shape[2], k, s)
        left, right = _same_pad(x.shape[3], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return conv2d(self, x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), projection shortcut on mismatch."""

    def __init__(self, cin: int, features: int, strides: int):
        super().__init__()
        self.conv1 = SameConv(cin, features, 1)
        self.bn1 = BatchNorm(features, eps=1e-5)
        self.conv2 = SameConv(features, features, 3, strides)
        self.bn2 = BatchNorm(features, eps=1e-5)
        self.conv3 = SameConv(features, features * 4, 1)
        self.bn3 = BatchNorm(features * 4, eps=1e-5)
        self.project = cin != features * 4 or strides != 1
        if self.project:
            self.downsample_conv = SameConv(cin, features * 4, 1, strides)
            self.downsample_bn = BatchNorm(features * 4, eps=1e-5)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + residual)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 5, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 head_hidden: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64, eps=1e-5)
        cin = 64
        self.blocks = []
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                name = f"stage{i + 1}_block{j + 1}"
                setattr(self, name, Bottleneck(cin, 64 * 2**i, 2 if i > 0 and j == 0 else 1))
                self.blocks.append(name)
                cin = 64 * 2**i * 4
        self.head_dense1 = nn.Linear(cin, head_hidden)
        self.head_dense2 = nn.Linear(head_hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC float [B,H,W,3] -> logits [B,C]."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self.stem_bn(conv2d(self.stem_conv, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        features = torch.mean(x, dim=(2, 3)).to(torch.float32)
        return self.head_dense2(F.relu(self.head_dense1(features)))


SEV_MINOR, SEV_MAJOR, SEV_CRITICAL = 0, 1, 2


def classifier_severity(class_ids: torch.Tensor, confidences: torch.Tensor,
                        rules=None) -> torch.Tensor:
    """class + confidence -> severity {0,1,2}: crack/dent escalate above the
    major (0.6) and critical (0.8) confidences, scratch/discoloration become
    major above the critical one, contamination stays minor. ``rules``: the
    [2,3] severity-rules tensor (classifier column 2), or None."""
    if rules is None:
        major_c, crit_c = 0.6, 0.8
    elif rules.shape[-1] >= 3:
        major_c, crit_c = rules[0, 2], rules[1, 2]
    else:
        major_c, crit_c = rules[0, 0], rules[1, 0]
    is_crit_class = (class_ids == 0) | (class_ids == 2)
    is_major_class = (class_ids == 1) | (class_ids == 3)
    sev = torch.full(class_ids.shape, SEV_MINOR, dtype=torch.int32, device=class_ids.device)
    sev = torch.where(is_major_class & (confidences > crit_c), torch.full_like(sev, SEV_MAJOR), sev)
    sev = torch.where(is_crit_class & (confidences > major_c), torch.full_like(sev, SEV_MAJOR), sev)
    sev = torch.where(is_crit_class & (confidences > crit_c), torch.full_like(sev, SEV_CRITICAL), sev)
    return sev


def preprocess_for_classifier(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B,H,W,3] uint8/float -> [B,size,size,3] ImageNet-normalised float."""
    x = imops.to_float(images)
    if tuple(x.shape[-3:-1]) != (size, size):
        x = imops.resize_bilinear(x, (size, size))
    return imops.normalize_imagenet(x)
