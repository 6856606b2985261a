"""YOLOv8 detector (backbone, PAN neck, decoupled DFL head) for inference.

The public forward takes NHWC float images [B,H,W,3] and returns
(dist_logits [B,A,4*reg_max], cls_logits [B,A,C]) flattened over the P3, P4
and P5 grids in that order (strides 8, 16, 32), row-major within a grid, as
the JAX package does. Inside, activations are NCHW.

Width and depth multipliers follow the YOLOv8 family (n: 0.25/0.334);
channels snap to multiples of 8. BatchNorm epsilon is 1e-3.

``dtype=torch.bfloat16`` runs the whole network in bfloat16 (``layers``);
the logits are then bfloat16. ``module.train()`` runs it in training mode
(BatchNorm on batch statistics, ``layers.BatchNorm``); ``init_weights``
draws a trainer's starting weights as Flax's initializers do.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iqc_tpu_torch.models.layers import BatchNorm, conv2d, exact_float32, init_flax, silu
from iqc_tpu_torch.ops.jit_utils import hoisted_jit

STRIDES = (8, 16, 32)

# Module definition order (both stem variants listed; a model has one).
# Index semantics follow Ultralytics' `freeze: N` (the first 10 are the
# backbone); the trainer's freeze_layers reads them.
MODULE_ORDER = (
    "stem", "stem_s2d", "down2", "c2f_2", "down3", "c2f_3", "down4",
    "c2f_4", "down5", "c2f_5", "sppf",
    "neck_td4", "neck_td3", "neck_down4", "neck_bu4", "neck_down5",
    "neck_bu5", "head_p3", "head_p4", "head_p5",
)

# The backbone's modules (the s2d stem has no down2, so its backbone is 9
# modules; freeze_layers=10 still means the whole backbone there)
BACKBONE_KEYS = frozenset(
    ("stem", "stem_s2d", "down2", "c2f_2", "down3", "c2f_3", "down4",
     "c2f_4", "down5", "c2f_5", "sppf")
)

CLS_PRIOR = -4.6  # bias of every cls_out at init: a low initial class score


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(round(x / divisor) * divisor))


def _depth(n: int, depth_mult: float) -> int:
    return max(1, round(n * depth_mult))


class ConvBN(nn.Module):
    """Conv (no bias, symmetric k//2 padding) + BatchNorm + SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.BatchNorm_0 = BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return silu(self.BatchNorm_0(conv2d(self.Conv_0, x)))


class C2fBottleneck(nn.Module):
    def __init__(self, cin: int, c: int, shortcut: bool):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, c, 3)
        self.ConvBN_1 = ConvBN(c, c, 3)
        self.add = shortcut and cin == c

    def forward(self, x):
        y = self.ConvBN_1(self.ConvBN_0(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n inner bottlenecks."""

    def __init__(self, cin: int, features: int, n: int, shortcut: bool):
        super().__init__()
        c = features // 2
        self.c = c
        self.ConvBN_0 = ConvBN(cin, 2 * c, 1)
        for i in range(n):
            setattr(self, f"C2fBottleneck_{i}", C2fBottleneck(c, c, shortcut))
        self.n = n
        self.ConvBN_1 = ConvBN((2 + n) * c, features, 1)

    def forward(self, x):
        y = self.ConvBN_0(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"C2fBottleneck_{i}")(parts[-1]))
        return self.ConvBN_1(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5x5 max pools."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        c = features // 2
        self.ConvBN_0 = ConvBN(cin, c, 1)
        self.ConvBN_1 = ConvBN(4 * c, features, 1)

    def forward(self, x):
        x = self.ConvBN_0(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.ConvBN_1(torch.cat([x, p1, p2, p3], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """NHWC [B,H,W,C] -> [B,H/b,W/b,C*b*b], channel order (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


class DetectHead(nn.Module):
    """Decoupled anchor-free head with DFL box regression (one scale)."""

    def __init__(self, cin: int, num_classes: int, reg_max: int, box_ch: int, cls_ch: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, box_ch, 3)
        self.ConvBN_1 = ConvBN(box_ch, box_ch, 3)
        self.box_out = nn.Conv2d(box_ch, 4 * reg_max, 1)
        self.ConvBN_2 = ConvBN(cin, cls_ch, 3)
        self.ConvBN_3 = ConvBN(cls_ch, cls_ch, 3)
        self.cls_out = nn.Conv2d(cls_ch, num_classes, 1)

    def forward(self, x):
        dist = conv2d(self.box_out, self.ConvBN_1(self.ConvBN_0(x)))
        cls = conv2d(self.cls_out, self.ConvBN_3(self.ConvBN_2(x)))
        return dist, cls


class YOLOv8(nn.Module):
    def __init__(self, num_classes: int = 5, width_mult: float = 0.25,
                 depth_mult: float = 0.334, reg_max: int = 16, stem_mode: str = "conv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.stem_mode = stem_mode
        ch = lambda c: _make_divisible(min(c, 1024) * width_mult)
        dp = lambda n: _depth(n, depth_mult)

        if stem_mode == "s2d":
            self.stem_s2d = ConvBN(48, ch(128), 3, 1)
        else:
            self.stem = ConvBN(3, ch(64), 3, 2)
            self.down2 = ConvBN(ch(64), ch(128), 3, 2)
        self.c2f_2 = C2f(ch(128), ch(128), dp(3), True)
        self.down3 = ConvBN(ch(128), ch(256), 3, 2)
        self.c2f_3 = C2f(ch(256), ch(256), dp(6), True)
        self.down4 = ConvBN(ch(256), ch(512), 3, 2)
        self.c2f_4 = C2f(ch(512), ch(512), dp(6), True)
        self.down5 = ConvBN(ch(512), ch(1024), 3, 2)
        self.c2f_5 = C2f(ch(1024), ch(1024), dp(3), True)
        self.sppf = SPPF(ch(1024), ch(1024))
        self.neck_td4 = C2f(ch(1024) + ch(512), ch(512), dp(3), False)
        self.neck_td3 = C2f(ch(512) + ch(256), ch(256), dp(3), False)
        self.neck_down4 = ConvBN(ch(256), ch(256), 3, 2)
        self.neck_bu4 = C2f(ch(256) + ch(512), ch(512), dp(3), False)
        self.neck_down5 = ConvBN(ch(512), ch(512), 3, 2)
        self.neck_bu5 = C2f(ch(512) + ch(1024), ch(1024), dp(3), False)
        box_ch = max(16, ch(256) // 4, 4 * reg_max)
        cls_ch = max(ch(256), min(num_classes, 100))
        for i, cin in zip((3, 4, 5), (ch(256), ch(512), ch(1024))):
            setattr(self, f"head_p{i}", DetectHead(cin, num_classes, reg_max, box_ch, cls_ch))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: NHWC float [B,H,W,3]."""
        x = x.to(self.compute_dtype)
        if self.stem_mode == "s2d":
            x = self.stem_s2d(space_to_depth(x, 4).permute(0, 3, 1, 2))
        else:
            x = self.down2(self.stem(x.permute(0, 3, 1, 2)))
        x = self.c2f_2(x)
        p3 = self.c2f_3(self.down3(x))
        p4 = self.c2f_4(self.down4(p3))
        p5 = self.sppf(self.c2f_5(self.down5(p4)))
        n4 = self.neck_td4(torch.cat([upsample2x(p5), p4], dim=1))
        o3 = self.neck_td3(torch.cat([upsample2x(n4), p3], dim=1))
        o4 = self.neck_bu4(torch.cat([self.neck_down4(o3), n4], dim=1))
        o5 = self.neck_bu5(torch.cat([self.neck_down5(o4), p5], dim=1))
        dists, clss = [], []
        for i, feat in zip((3, 4, 5), (o3, o4, o5)):
            dist, cls = getattr(self, f"head_p{i}")(feat)
            b = dist.shape[0]
            dists.append(dist.permute(0, 2, 3, 1).reshape(b, -1, 4 * self.reg_max))
            clss.append(cls.permute(0, 2, 3, 1).reshape(b, -1, self.num_classes))
        return torch.cat(dists, dim=1), torch.cat(clss, dim=1)


def init_weights(module: "YOLOv8", seed: int) -> None:
    """Flax's initializers (``layers.init_flax``) with the class prior on
    every ``cls_out`` bias, as the JAX package's module initializes."""
    init_flax(module, seed, lambda name: CLS_PRIOR if name.endswith("cls_out") else 0.0)


def feature_shapes(input_size: Tuple[int, int]) -> List[Tuple[int, int]]:
    return [(input_size[0] // s, input_size[1] // s) for s in STRIDES]


SEV_MINOR, SEV_MAJOR, SEV_CRITICAL = 0, 1, 2
SEVERITY_NAMES = ("minor", "major", "critical")


def detection_severity(confidences: torch.Tensor, areas: torch.Tensor,
                       rules: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conf/area -> severity {0,1,2}; area normalised by 1024^2 whatever the
    image size. ``rules``: optional [2,>=2] tensor
    [[major_conf, major_area_ratio, ...], [critical_conf, critical_area_ratio, ...]];
    None uses 0.8/0.05 and 0.9/0.1."""
    norm_area = areas / float(1024 * 1024)
    if rules is None:
        major_c, major_a, crit_c, crit_a = 0.8, 0.05, 0.9, 0.1
    else:
        major_c, major_a = rules[0, 0], rules[0, 1]
        crit_c, crit_a = rules[1, 0], rules[1, 1]
    sev = torch.full(confidences.shape, SEV_MINOR, dtype=torch.int32, device=confidences.device)
    sev = torch.where((confidences > major_c) | (norm_area > major_a),
                      torch.full_like(sev, SEV_MAJOR), sev)
    sev = torch.where((confidences > crit_c) | (norm_area > crit_a),
                      torch.full_like(sev, SEV_CRITICAL), sev)
    return sev


class YOLODetector:
    """The detector alone on one device: YOLOv8 -> DFL decode and
    class-aware NMS (the suppression kernel), with merge voting by default
    -> severity by confidence and area.

    ``predict`` / ``batch_predict`` resize off-size inputs to ``input_size``
    and give boxes in the input image's pixels. Thresholds are read on every
    call: ``update_thresholds`` rebuilds nothing. ``class_conf_thresholds``
    gives each class its own confidence floor; ``severity_rules`` the [2,2]
    tier thresholds [[major conf, major area ratio], [critical conf,
    critical area ratio]] (None: 0.8/0.05 and 0.9/0.1). Weights come from
    the Flax checkpoint at ``model_path``; without one (or where the file is
    missing) the network keeps seeded random weights, which
    ``get_model_info`` reports."""

    def __init__(self, model_path: Optional[str] = None, confidence_threshold: float = 0.7,
                 nms_threshold: float = 0.5, num_classes: int = 5,
                 input_size: Tuple[int, int] = (640, 640), width_mult: float = 0.25,
                 depth_mult: float = 0.334, max_detections: int = 300,
                 class_names: Optional[List[str]] = None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, stem_mode: str = "conv", box_voting: bool = True,
                 class_conf_thresholds: Optional[Sequence[float]] = None,
                 severity_rules: Optional[Sequence[Sequence[float]]] = None, device="cuda"):
        from iqc_tpu_torch.config import DEFECT_CLASSES
        from iqc_tpu_torch.ops.nms import make_anchors
        from iqc_tpu_torch.weights import load_or_init

        self.model_path = model_path
        self.box_voting = bool(box_voting)
        self.confidence_threshold = confidence_threshold
        self.class_conf_thresholds = (None if class_conf_thresholds is None
                                      else [float(v) for v in class_conf_thresholds])
        self.nms_threshold = nms_threshold
        self.input_size = tuple(input_size)
        self.max_detections = max_detections
        self.class_names = list(class_names or DEFECT_CLASSES)[:num_classes]
        self.device = torch.device(device)
        exact_float32(self.device)
        self._sev_rules = (None if severity_rules is None else
                           torch.tensor(severity_rules, dtype=torch.float32, device=self.device))
        self.module = YOLOv8(num_classes=num_classes, width_mult=width_mult,
                             depth_mult=depth_mult, stem_mode=stem_mode, dtype=dtype)
        self.weights_source = load_or_init(self.module, model_path, seed)
        self.module.to(self.device).eval()
        self._anchors, self._strides = make_anchors(feature_shapes(self.input_size), STRIDES,
                                                    device=self.device)
        # one CUDA graph per input signature on the card; the thresholds are
        # among its inputs
        self._jit_forward = hoisted_jit(self._device_forward)

    def _conf_value(self):
        """A [C] tensor of per-class floors where they are set, else the scalar."""
        if self.class_conf_thresholds is not None:
            return torch.tensor(self.class_conf_thresholds, dtype=torch.float32,
                                device=self.device)
        return float(self.confidence_threshold)

    def _device_forward(self, images: torch.Tensor, conf, iou, box_voting: bool,
                        sev_rules: Optional[torch.Tensor]):
        """[B,H,W,3] uint8 or float -> (boxes, scores, classes, valid,
        severities) on the device, at the model input's resolution."""
        from iqc_tpu_torch.ops import image as imops
        from iqc_tpu_torch.ops.boxes import box_area
        from iqc_tpu_torch.ops.nms import decode_and_nms

        x = imops.to_float(images)
        if tuple(x.shape[1:3]) != self.input_size:
            x = imops.resize_bilinear(x, self.input_size)
        dist, cls = self.module(x)
        det = decode_and_nms(dist, cls, self._anchors, self._strides,
                             reg_max=self.module.reg_max, max_detections=self.max_detections,
                             iou_threshold=iou, score_threshold=conf, box_voting=box_voting)
        sev = detection_severity(det.scores, box_area(det.boxes), sev_rules)
        return det.boxes, det.scores, det.classes, det.valid, sev

    def _forward(self, images: torch.Tensor):
        """[B,H,W,3] uint8 or float -> host (boxes, scores, classes, valid,
        severities) at the model input's resolution."""
        with torch.inference_mode():
            out = self._jit_forward(images, self._conf_value(), float(self.nms_threshold),
                                    self.box_voting, self._sev_rules)
            return tuple(t.cpu().numpy() for t in out)

    def _upload(self, images) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(images)).to(self.device)

    def _scale(self, shape) -> Tuple[float, float]:
        return shape[0] / self.input_size[0], shape[1] / self.input_size[1]

    def predict(self, image: np.ndarray) -> Dict:
        """Detections of one [H,W,3] image."""
        t0 = time.perf_counter()
        img = np.asarray(image)
        boxes, scores, classes, valid, sev = self._forward(self._upload(img)[None])
        dt = (time.perf_counter() - t0) * 1000
        dets = self.parse_detections(boxes[0], scores[0], classes[0], valid[0], sev[0],
                                     scale=self._scale(img.shape))
        return {"detections": dets, "inference_time_ms": dt, "image_shape": img.shape[:2],
                "total_detections": len(dets)}

    def batch_predict(self, images: List[np.ndarray]) -> List[Dict]:
        """Detections of equally sized images, as one batch."""
        t0 = time.perf_counter()
        boxes, scores, classes, valid, sev = self._forward(self._upload(np.stack(images)))
        dt = (time.perf_counter() - t0) * 1000
        results = []
        for i, image in enumerate(images):
            dets = self.parse_detections(boxes[i], scores[i], classes[i], valid[i], sev[i],
                                         scale=self._scale(image.shape))
            results.append({"detections": dets, "inference_time_ms": dt / len(images),
                            "image_shape": image.shape[:2], "total_detections": len(dets),
                            "batch_index": i})
        return results

    def parse_detections(self, boxes, scores, classes, valid, severities,
                         scale=(1.0, 1.0)) -> List[Dict]:
        """Fixed-capacity arrays (survivors first) -> detection records, the
        boxes scaled by (sy, sx) and truncated to whole pixels."""
        out = []
        sy, sx = scale
        for i in range(len(valid)):
            if not valid[i]:
                break
            x1, y1, x2, y2 = boxes[i]
            x1, x2 = int(x1 * sx), int(x2 * sx)
            y1, y2 = int(y1 * sy), int(y2 * sy)
            cid = int(classes[i])
            out.append({
                "id": len(out),
                "class": (self.class_names[cid] if 0 <= cid < len(self.class_names)
                          else f"class_{cid}"),
                "confidence": float(scores[i]),
                "bbox": {"x1": x1, "y1": y1, "x2": x2, "y2": y2,
                         "width": x2 - x1, "height": y2 - y1,
                         "center_x": (x1 + x2) / 2, "center_y": (y1 + y2) / 2},
                "area": (x2 - x1) * (y2 - y1),
                "severity": SEVERITY_NAMES[int(severities[i])],
            })
        return out

    def update_thresholds(self, confidence=None, nms: Optional[float] = None) -> None:
        """Set the confidence floor (a scalar, a [C] sequence or a
        {class name: floor} dict) and the NMS IoU threshold."""
        if confidence is not None:
            if isinstance(confidence, dict):
                base = self.confidence_threshold
                self.class_conf_thresholds = [float(confidence.get(n, base))
                                              for n in self.class_names]
            elif isinstance(confidence, (list, tuple)):
                self.class_conf_thresholds = [float(v) for v in confidence]
            else:
                self.confidence_threshold = float(confidence)
                self.class_conf_thresholds = None
        if nms is not None:
            self.nms_threshold = float(nms)

    def visualize_detections(self, image: np.ndarray, detections: List[Dict]) -> np.ndarray:
        from iqc_tpu_torch.inference.visualize import draw_detections

        return draw_detections(image, detections)

    def get_model_info(self) -> Dict:
        return {
            "model_path": self.model_path,
            "device": str(self.device),
            "confidence_threshold": self.confidence_threshold,
            "nms_threshold": self.nms_threshold,
            "class_names": self.class_names,
            "model_loaded": True,
            "weights_source": self.weights_source,
            "input_size": self.input_size,
            "max_detections": self.max_detections,
        }
