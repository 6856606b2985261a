"""ResNet-50 (v1 bottleneck) defect classifier, with the head Dropout(0.5)
-> Dense(512) -> ReLU -> Dropout(0.3) -> Dense(num_classes).

The forward takes NHWC float [B,H,W,3] (ImageNet-normalised) and returns
logits [B,C]. Inside, activations are NCHW. BatchNorm epsilon is 1e-5 and
its momentum 0.9. In evaluation mode the dropouts are inactive; in training
mode (``module.train()``) BatchNorm uses the batch's statistics and each
dropout keeps a value where its keep mask is set, scaled by 1/keep, as
Flax's ``nn.Dropout`` does. The masks come from the caller
(``dropout_masks``) or from the module's CPU generator (``dropout_rng``).

Padding follows the checkpoints' Flax definition: the stem conv pads (3,3)
and the max pool (1,1), explicitly; every other conv pads "SAME", which for
a stride-2 3x3 conv on an even input is (0,1), not (1,1), so it is padded
explicitly with ``F.pad``.

``dtype=torch.bfloat16`` runs the backbone in bfloat16 (``layers``); the
pooled features and the head stay float32.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iqc_tpu_torch.models.layers import BatchNorm, conv2d, exact_float32, init_flax
from iqc_tpu_torch.models.yolo import SEVERITY_NAMES
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops.jit_utils import hoisted_jit


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


RESNET50_STAGES = (3, 4, 6, 3)
RESNET101_STAGES = (3, 4, 23, 3)
HEAD_DROPOUT = (0.5, 0.3)
BN_MOMENTUM = 0.9


def _norm(features: int) -> BatchNorm:
    return BatchNorm(features, eps=1e-5, momentum=BN_MOMENTUM)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), projection shortcut on mismatch."""

    def __init__(self, cin: int, features: int, strides: int):
        super().__init__()
        self.conv1 = SameConv(cin, features, 1)
        self.bn1 = _norm(features)
        self.conv2 = SameConv(features, features, 3, strides)
        self.bn2 = _norm(features)
        self.conv3 = SameConv(features, features * 4, 1)
        self.bn3 = _norm(features * 4)
        self.project = cin != features * 4 or strides != 1
        if self.project:
            self.downsample_conv = SameConv(cin, features * 4, 1, strides)
            self.downsample_bn = _norm(features * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.relu(y + residual)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 5, stage_sizes: Sequence[int] = RESNET50_STAGES,
                 head_hidden: int = 512, dtype: torch.dtype = torch.float32,
                 head_dropout: Tuple[float, float] = HEAD_DROPOUT):
        super().__init__()
        self.compute_dtype = dtype
        self.head_dropout = tuple(head_dropout)
        self.dropout_rng = torch.Generator().manual_seed(0)
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.stem_bn = _norm(64)
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

    def draw_dropout_masks(self, batch: int, gen: torch.Generator) -> Tuple[torch.Tensor, ...]:
        """The head's two keep masks for a batch, bool [B,2048] and [B,512]
        on the CPU, each value kept with probability 1 - rate."""
        dims = (self.head_dense1.in_features, self.head_dense1.out_features)
        return tuple(torch.rand((batch, d), generator=gen) >= rate
                     for d, rate in zip(dims, self.head_dropout))

    @staticmethod
    def _dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        keep = keep.to(x.device, non_blocking=True)
        return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), device=x.device))

    def forward(self, x: torch.Tensor, return_features: bool = False,
                dropout_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """x: NHWC float [B,H,W,3] -> logits [B,C], or with
        ``return_features`` the pooled float32 features [B,2048]. In training
        mode ``dropout_masks`` (bool [B,2048], [B,512]) are the head's keep
        masks; None draws them from ``dropout_rng``."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self.stem_bn(conv2d(self.stem_conv, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        features = torch.mean(x, dim=(2, 3)).to(torch.float32)
        if return_features:
            return features
        if not self.training:
            return self.head_dense2(F.relu(self.head_dense1(features)))
        if dropout_masks is None:
            dropout_masks = self.draw_dropout_masks(features.shape[0], self.dropout_rng)
        y = self._dropout(features, dropout_masks[0], self.head_dropout[0])
        y = F.relu(self.head_dense1(y))
        y = self._dropout(y, dropout_masks[1], self.head_dropout[1])
        return self.head_dense2(y)


def init_weights(module: ResNet50, seed: int) -> None:
    """A fresh network with Flax's initializers (``layers.init_flax``) and
    each block's ``bn3`` scale at zero, so every residual block starts as
    the identity of its shortcut."""
    init_flax(module, seed)
    with torch.no_grad():
        for name in module.blocks:
            getattr(module, name).bn3.weight.zero_()


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


class ResNetClassifier:
    """Whole-image defect classifier: ResNet-50 at 224 px on one device.

    ``predict`` / ``predict_batch`` give the class, its confidence, every
    class probability and the severity; ``extract_features`` the pooled
    backbone features. Weights come from the Flax checkpoint at
    ``model_path``; without one (or where the file is missing) the network
    keeps seeded random weights, which ``get_model_info`` reports."""

    INPUT_SIZE = 224

    def __init__(self, model_path: Optional[str] = None, num_classes: int = 5,
                 class_names: Optional[List[str]] = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, device="cuda"):
        from iqc_tpu_torch.config import DEFECT_CLASSES
        from iqc_tpu_torch.weights import load_or_init

        self.model_path = model_path
        self.num_classes = num_classes
        self.class_names = list(class_names or DEFECT_CLASSES)[:num_classes]
        self.device = torch.device(device)
        exact_float32(self.device)
        self.module = ResNet50(num_classes=num_classes, dtype=dtype)
        self.weights_source = load_or_init(self.module, model_path, seed)
        self.module.to(self.device).eval()
        # one CUDA graph per input signature on the card
        self._jit_forward = hoisted_jit(self._device_forward)
        self._jit_features = hoisted_jit(self._device_features)

    def _upload(self, images) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(images)).to(self.device)

    def _device_forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = preprocess_for_classifier(images, self.INPUT_SIZE)
        probs = torch.softmax(self.module(x).to(torch.float32), dim=-1)
        conf = torch.amax(probs, dim=-1)
        cls = torch.argmax(probs, dim=-1).to(torch.int32)
        return {"probs": probs, "confidence": conf, "class_id": cls,
                "severity": classifier_severity(cls, conf)}

    def _device_features(self, images: torch.Tensor) -> torch.Tensor:
        x = preprocess_for_classifier(images, self.INPUT_SIZE)
        return self.module(x, return_features=True)

    def _forward(self, images: torch.Tensor) -> Dict[str, np.ndarray]:
        with torch.inference_mode():
            return {k: v.cpu().numpy() for k, v in self._jit_forward(images).items()}

    def _record(self, out: Dict[str, np.ndarray], i: int) -> Dict:
        return {
            "predicted_class": self.class_names[int(out["class_id"][i])],
            "confidence": float(out["confidence"][i]),
            "class_probabilities": {self.class_names[j]: float(p)
                                    for j, p in enumerate(out["probs"][i])},
            "severity": SEVERITY_NAMES[int(out["severity"][i])],
        }

    def predict(self, image: np.ndarray) -> Dict:
        """Classification of one [H,W,3] image (uint8 or float in [0,1])."""
        t0 = time.perf_counter()
        out = self._forward(self._upload(image)[None])
        result = self._record(out, 0)
        result["inference_time_ms"] = (time.perf_counter() - t0) * 1000
        return result

    def predict_batch(self, images: List[np.ndarray]) -> List[Dict]:
        """Classification of equally sized images as one batch."""
        t0 = time.perf_counter()
        batch = torch.stack([imops.to_float(self._upload(im)) for im in images])
        out = self._forward(batch)
        total = (time.perf_counter() - t0) * 1000
        results = []
        for i in range(len(images)):
            r = self._record(out, i)
            r.update({"batch_index": i, "batch_inference_time_ms": total,
                      "avg_time_per_image_ms": total / len(images)})
            results.append(r)
        return results

    def extract_features(self, image: np.ndarray) -> np.ndarray:
        """The 2048 pooled backbone features of one image."""
        with torch.inference_mode():
            return self._jit_features(self._upload(image)[None])[0].cpu().numpy()

    def get_model_info(self) -> Dict:
        return {
            "model_path": self.model_path,
            "device": str(self.device),
            "num_classes": self.num_classes,
            "class_names": self.class_names,
            "model_loaded": True,
            "weights_source": self.weights_source,
            "input_size": (self.INPUT_SIZE, self.INPUT_SIZE),
        }
