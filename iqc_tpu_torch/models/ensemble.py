"""The full request forward and its predictor: detection -> per-crop
classification -> fusion -> segmentation, then the result schema.

``FullForward`` runs, for a batch of NHWC images (``FullForward.ensemble``
alone is the detection-only forward, ``EnsemblePredictor.run``):
YOLOv8 -> DFL decode + class-aware merge-NMS (suppression kernel) ->
crop-and-resize of the top ``max_classified`` survivors -> ResNet-50 over
those crops (or over a batch-wide pool of the best ``crop_pool`` real
survivors) and over the whole image -> weighted confidence fusion and
severity max-fusion -> segmentation of the top ``max_segmented`` survivors
(or of a batch-wide pool of ``seg_pool``; morphology kernels). Crop slots
beyond the classified ones take the mock refinement rule (conf * 1.1 capped
at 1, the detector's class and severity).

Outputs are packed into two dense tensors (``pack_outputs``) plus the masks
and segmentation statistics, and fetched to the host in one go.

``EnsemblePredictor`` runs the forward through ``jit_utils.hoisted_jit``, as
the JAX package runs it under ``hoisted_jit``: the detection-only forward
(``run``), the same packed (``run_host``) and the full forward
(``run_full_host``), each a CUDA graph per input signature on the card. The
thresholds, fusion weights and severity rules are device tensors among the
inputs, so a new value takes effect at the next replay with no new capture.

Serving precision (``edge.precision``): ``int8`` replaces both networks by
their int8 forwards (``Int8YOLO``: the int8-resident walk of
``yolo_int8_stream`` or the v1 walk of ``yolo_int8``; ``Int8ResNet``:
``resnet_int8_stream`` or the v1 ``resnet_int8`` walk), quantized from the
float weights with activation scales calibrated at construction, on the
predictor's device, from procedurally rendered defect frames and crops.
``edge.yolo_int8: false`` keeps the float YOLOv8 in ``model.compute_dtype``
with int8-stored, dequantized weights (``optimizer``). ``fp32`` and
``bf16`` serve the float networks in ``model.compute_dtype``.
``edge.sparsity`` > 0 prunes both networks' weights by magnitude first.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from iqc_tpu_torch.config import SystemConfig
from iqc_tpu_torch.data.resize import resize_bicubic
from iqc_tpu_torch.data.yolo_dataset import SyntheticDefectDataset
from iqc_tpu_torch.models import resnet_int8, resnet_int8_stream, yolo_int8, yolo_int8_stream
from iqc_tpu_torch.models.layers import exact_float32
from iqc_tpu_torch.models.optimizer import EngineOptimizer, prune_magnitude
from iqc_tpu_torch.models.resnet import ResNet50, classifier_severity, preprocess_for_classifier
from iqc_tpu_torch.models.yolo import (SEVERITY_NAMES, STRIDES, YOLOv8, detection_severity,
                                       feature_shapes)
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops.boxes import box_area
from iqc_tpu_torch.ops.jit_utils import hoisted_jit
from iqc_tpu_torch.ops.nms import Detections, decode_and_nms, make_anchors
from iqc_tpu_torch.ops.segmentation import CLASS_TO_METHOD, segment_rois, table_lookup
from iqc_tpu_torch.parallel.mesh import all_gather_rows, create_mesh, shard_batch
from iqc_tpu_torch.weights import load_into, load_or_init, to_flax


class EnsembleOutputs(NamedTuple):
    """Outputs of the fused forward, all of fixed capacity K."""

    boxes: object            # [B,K,4] xyxy at model input resolution
    yolo_scores: object      # [B,K]
    classes: object          # [B,K] detector class
    valid: object            # [B,K]
    areas: object            # [B,K]
    yolo_severity: object    # [B,K] int {0,1,2}
    crop_class: object       # [B,K] ResNet class per crop
    crop_conf: object        # [B,K]
    crop_severity: object    # [B,K]
    crop_classified: object  # [B,K] bool: the crop network ran on this slot
    ensemble_conf: object    # [B,K] fused confidence
    final_severity: object   # [B,K] max-fused severity
    severity_counts: object  # [B,3] (#minor, #major, #critical)
    global_probs: object     # [B,C] whole-image ResNet probabilities
    image_confidence: object  # [B] per-image ensemble confidence


class Int8YOLO(nn.Module):
    """The int8 YOLOv8 as the full forward's detector: the int8-resident
    walk (``yolo_int8_stream``) or, with ``stream=False``, the v1 walk
    (``yolo_int8``). NHWC float images -> float32 (dist, cls) logits."""

    def __init__(self, q: Dict, scales, reg_max: int, num_classes: int, device,
                 stream: bool = True):
        super().__init__()
        self.reg_max, self.num_classes, self.stream = reg_max, num_classes, stream
        walk = yolo_int8_stream if stream else yolo_int8
        self.q = walk.device_tree(q, device)
        self.scales = torch.as_tensor(np.array(scales, np.float32), device=device)

    def forward(self, x: torch.Tensor):
        if self.stream:
            return yolo_int8_stream.apply(self.q, x, self.scales, self.reg_max, self.num_classes)
        return yolo_int8.apply(self.q, x, self.reg_max, self.num_classes, act_scales=self.scales)


class Int8ResNet(nn.Module):
    """The int8 ResNet-50 as the full forward's classifier: the streaming
    walk, or the v1 walk (``stream=False``), over the same tree and scales."""

    def __init__(self, q: Dict, scales, stage_sizes, stream: bool, device):
        super().__init__()
        self.stage_sizes, self.stream = tuple(stage_sizes), stream
        self.q = resnet_int8.device_tree(q, device)
        self.scales = torch.as_tensor(np.array(scales, np.float32), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stream:
            return resnet_int8_stream.apply(self.q, x, self.scales, self.stage_sizes)
        return resnet_int8.apply(self.q, x, self.stage_sizes, act_scales=self.scales)


def _env_flag(name: str, default: bool) -> bool:
    env = os.environ.get(name)
    return default if env is None else env not in ("0", "false", "")


def _top_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D key; ties keep the lower index first."""
    return torch.sort(key, descending=True, stable=True).indices[:k]


class FullForward(nn.Module):
    """The whole request on a batch, as one module."""

    def __init__(self, yolo: nn.Module, resnet: nn.Module, input_size, max_detections: int,
                 max_classified: int, classifier_input: int, max_segmented: int,
                 roi_size: int, crop_pool: int, seg_pool: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.yolo = yolo
        self.resnet = resnet
        self.compute_dtype = compute_dtype
        self.input_size = tuple(input_size)
        self.max_detections = max_detections
        self.max_classified = max_classified
        self.classifier_input = classifier_input
        self.max_segmented = max_segmented
        self.roi_size = roi_size
        self.crop_pool = crop_pool
        self.seg_pool = seg_pool
        anchors, strides = make_anchors(feature_shapes(self.input_size), STRIDES)
        self.register_buffer("anchors", anchors, persistent=False)
        self.register_buffer("strides", strides, persistent=False)

    def _input(self, images: torch.Tensor) -> torch.Tensor:
        x = imops.to_float(images)
        if tuple(x.shape[1:3]) != self.input_size:
            x = imops.resize_bilinear(x, self.input_size)
        return x

    def _classify(self, crops: torch.Tensor):
        probs = torch.softmax(self.resnet(crops).to(torch.float32), dim=-1)
        conf, cls = torch.max(probs, dim=-1)
        return conf, cls.to(torch.int32)

    def detect(self, images: torch.Tensor, conf_t, iou_t,
               sev_rules: Optional[torch.Tensor] = None) -> "_Rows":
        """The per-image half of the forward on a batch (on a mesh, this
        rank's rows): detection, the whole-image classification, the crops
        of the top ``max_classified`` survivors and the crop pool's key."""
        x = self._input(images)
        b = x.shape[0]
        kc, ci = self.max_classified, self.classifier_input

        dist, cls = self.yolo(x)
        det: Detections = decode_and_nms(
            dist, cls, self.anchors, self.strides, reg_max=self.yolo.reg_max,
            max_detections=self.max_detections, iou_threshold=iou_t,
            score_threshold=conf_t, box_voting=True,
        )
        areas = box_area(det.boxes)
        yolo_sev = detection_severity(det.scores, areas, sev_rules)
        global_probs = torch.softmax(
            self.resnet(preprocess_for_classifier(x, ci)).to(torch.float32), dim=-1)
        crops = imops.crop_and_resize(x, det.boxes[:, :kc], (ci, ci), self.compute_dtype)
        crops_flat = imops.normalize_imagenet(crops.reshape(b * kc, ci, ci, 3))
        return _Rows(x, det, areas, yolo_sev, global_probs, crops_flat,
                     _pool_key(det.valid[:, :kc], det.scores[:, :kc]))

    def fuse(self, rows: "_Rows", key: torch.Tensor, offset: int, w_yolo, w_resnet,
             sev_rules: Optional[torch.Tensor] = None) -> EnsembleOutputs:
        """Crop classification and fusion of ``rows``. ``key`` is the crop
        pool's key over the whole batch (on a mesh every rank's, gathered in
        image order) and ``offset`` the index of the first slot of ``rows``
        in it: the pool holds the best ``crop_pool`` real survivors of the
        whole batch, of which these rows classify their own."""
        x, det, areas, yolo_sev, global_probs, crops_flat = rows[:6]
        b = x.shape[0]
        kc = self.max_classified
        pool = self.crop_pool
        if pool and pool < key.shape[0]:
            # one ResNet forward over the batch's best `pool` real survivors
            n = b * kc
            flat_valid = det.valid[:, :kc].reshape(n)
            flat_scores = det.scores[:, :kc].reshape(n)
            flat_classes = det.classes[:, :kc].reshape(n)
            sel, ok = _own_slots(_top_indices(key, pool), offset, n, min(pool, n))
            ok = ok & flat_valid[sel.clamp(max=n - 1)]
            p_conf, p_class = self._classify(crops_flat[sel.clamp(max=n - 1)])
            # slot n takes the writes of the pool entries of other ranks
            mock = torch.clamp(flat_scores * 1.1, max=1.0)
            cc_conf = torch.cat([mock, mock[:1]])
            cc_conf[sel] = torch.where(ok, p_conf, cc_conf[sel])
            cc_class = torch.cat([flat_classes, flat_classes[:1]])
            cc_class[sel] = torch.where(ok, p_class, cc_class[sel])
            classified_kc = torch.zeros(n + 1, dtype=torch.bool, device=x.device)
            classified_kc[sel] = ok
            cc_conf, cc_class = cc_conf[:n].reshape(b, kc), cc_class[:n].reshape(b, kc)
            classified_kc = classified_kc[:n].reshape(b, kc)
            cc_sev = torch.where(classified_kc,
                                 classifier_severity(cc_class, cc_conf, sev_rules),
                                 yolo_sev[:, :kc])
        else:
            cc_conf, cc_class = self._classify(crops_flat)
            cc_conf, cc_class = cc_conf.reshape(b, kc), cc_class.reshape(b, kc)
            cc_sev = classifier_severity(cc_class, cc_conf, sev_rules)
            classified_kc = torch.ones((b, kc), dtype=torch.bool, device=x.device)

        pad = self.max_detections - kc
        crop_conf = torch.cat([cc_conf, torch.clamp(det.scores[:, kc:] * 1.1, max=1.0)], dim=1)
        crop_class = torch.cat([cc_class, det.classes[:, kc:]], dim=1)
        crop_sev = torch.cat([cc_sev, yolo_sev[:, kc:]], dim=1)
        classified = torch.cat(
            [classified_kc, torch.zeros((b, pad), dtype=torch.bool, device=x.device)], dim=1)

        v = det.valid
        ens_conf = torch.where(v, w_yolo * det.scores + w_resnet * crop_conf,
                               torch.zeros_like(crop_conf))
        final_sev = torch.maximum(yolo_sev, crop_sev)
        counts = torch.stack([(v & (final_sev == s)).sum(dim=1) for s in (0, 1, 2)],
                             dim=-1).to(torch.int32)
        n_valid = torch.clamp(v.sum(dim=1), min=1)
        mean_yolo = torch.where(
            v.any(dim=1),
            torch.where(v, det.scores, torch.zeros_like(det.scores)).sum(dim=1) / n_valid,
            torch.zeros(b, device=x.device))
        img_conf = w_yolo * mean_yolo + w_resnet * global_probs.max(dim=-1).values
        return EnsembleOutputs(
            boxes=det.boxes, yolo_scores=det.scores, classes=det.classes, valid=v,
            areas=areas, yolo_severity=yolo_sev, crop_class=crop_class, crop_conf=crop_conf,
            crop_severity=crop_sev, crop_classified=classified, ensemble_conf=ens_conf,
            final_severity=final_sev, severity_counts=counts, global_probs=global_probs,
            image_confidence=img_conf,
        )

    def ensemble(self, x: torch.Tensor, conf_t, iou_t, w_yolo, w_resnet,
                 sev_rules: Optional[torch.Tensor] = None) -> EnsembleOutputs:
        """Detection, classification and fusion on float images [B,H,W,3].
        ``conf_t`` (a scalar or [C] per-class floors), ``iou_t``, ``w_yolo``
        and ``w_resnet`` are floats or float32 tensors on the device."""
        rows = self.detect(x, conf_t, iou_t, sev_rules)
        return self.fuse(rows, rows.crop_key, 0, w_yolo, w_resnet, sev_rules)

    def seg_rows(self, x: torch.Tensor, out: EnsembleOutputs) -> "_SegRows":
        """The ROIs of the top ``max_segmented`` survivors of each image and
        the seg pool's key."""
        gray = imops.rgb_to_gray(x)
        b, s, r = x.shape[0], self.max_segmented, self.roi_size
        boxes = out.boxes[:, :s]
        rois = imops.crop_and_resize(gray[..., None], boxes, (r, r))[..., 0].reshape(b * s, r, r)
        return _SegRows(rois, boxes.reshape(b * s, 4), out.classes[:, :s].reshape(b * s),
                        out.valid[:, :s].reshape(b * s),
                        _pool_key(out.valid[:, :s], out.yolo_scores[:, :s]))

    def segment(self, seg: "_SegRows", key: torch.Tensor, offset: int):
        """Masks [n,R,R] and statistics [n,5] of ``seg``'s n ROIs. ``key`` and
        ``offset`` as in ``fuse``: with a seg pool the batch's best
        ``seg_pool`` real survivors are segmented, the rest get an empty
        mask, zero statistics and their class's method id."""
        rois, flat_boxes, flat_cls, flat_valid = seg[:4]
        n, r = rois.shape[0], self.roi_size

        def scales(bx):
            bw = torch.clamp(bx[:, 2] - bx[:, 0], min=1.0)
            bh = torch.clamp(bx[:, 3] - bx[:, 1], min=1.0)
            return bw / r, bh / r

        pool = self.seg_pool
        if pool and pool < key.shape[0]:
            sel, ok = _own_slots(_top_indices(key, pool), offset, n, min(pool, n))
            g = sel.clamp(max=n - 1)
            sx, sy = scales(flat_boxes[g])
            sp = segment_rois(rois[g], flat_cls[g], ok & flat_valid[g], sx, sy)
            # row n takes the writes of the pool entries of other ranks
            masks = torch.zeros((n + 1, r, r), dtype=torch.bool, device=rois.device)
            masks[sel] = sp.masks
            stats = torch.zeros((n + 1, 5), dtype=torch.float32, device=rois.device)
            for col, val in enumerate((sp.area, sp.perimeter, sp.compactness, sp.confidence)):
                stats[sel, col] = val.to(torch.float32)
            masks, stats = masks[:n], stats[:n]
            n_cls = len(CLASS_TO_METHOD)
            stats[:, 4] = table_lookup(CLASS_TO_METHOD,
                                       torch.clamp(flat_cls.long(), 0, n_cls - 1)).to(torch.float32)
        else:
            sx, sy = scales(flat_boxes)
            sp = segment_rois(rois, flat_cls, flat_valid, sx, sy)
            masks = sp.masks
            stats = torch.stack([sp.area, sp.perimeter, sp.compactness, sp.confidence,
                                 sp.method.to(torch.float32)], dim=-1)
        return masks, stats

    def forward(self, images: torch.Tensor, conf_t, iou_t, w_yolo, w_resnet,
                sev_rules: Optional[torch.Tensor] = None):
        """images [B,H,W,3] uint8 or float -> (det [B,K,15], img [B,4+C],
        masks [B,S,R,R] bool, seg_stats [B,S,5])."""
        rows = self.detect(images, conf_t, iou_t, sev_rules)
        out = self.fuse(rows, rows.crop_key, 0, w_yolo, w_resnet, sev_rules)
        seg = self.seg_rows(rows.x, out)
        masks, stats = self.segment(seg, seg.key, 0)
        det, img = pack_outputs(out)
        b, s, r = rows.x.shape[0], self.max_segmented, self.roi_size
        return det, img, masks.reshape(b, s, r, r), stats.reshape(b, s, 5)

    def sharded(self, spec, images: torch.Tensor, conf_t, iou_t, w_yolo, w_resnet,
                sev_rules: Optional[torch.Tensor] = None, full: bool = True, stages=None):
        """The forward data-parallel over the mesh ``spec``: ``images`` are
        this rank's rows of the global batch. The per-image stages run on
        the rank; the two pools choose over the whole batch from the keys
        of every rank, gathered in image order (collectives between the
        stages, never inside one). Returns this rank's rows: the
        EnsembleOutputs (``full=False``) or ``forward``'s four tensors.
        ``stages`` maps a stage's name (``detect``, ``fuse``, ``seg_rows``,
        ``segment``) to the callable that runs it (captured graphs on the
        card); by default the methods themselves."""
        stage = lambda name: (stages or {}).get(name, getattr(self, name))
        rows = stage("detect")(images, conf_t, iou_t, sev_rules)
        n_crops = rows.crop_key.shape[0]
        key = all_gather_rows(spec, rows.crop_key)
        out = stage("fuse")(rows, key, spec.data_index * n_crops, w_yolo, w_resnet, sev_rules)
        if not full:
            return out
        seg = stage("seg_rows")(rows.x, out)
        n_rois = seg.key.shape[0]
        masks, stats = stage("segment")(seg, all_gather_rows(spec, seg.key),
                                        spec.data_index * n_rois)
        det, img = pack_outputs(out)
        b, s, r = rows.x.shape[0], self.max_segmented, self.roi_size
        return det, img, masks.reshape(b, s, r, r), stats.reshape(b, s, 5)


class _Rows(NamedTuple):
    """``FullForward.detect``'s outputs on a batch of B images."""

    x: torch.Tensor            # [B,H,W,3] float input
    det: Detections
    areas: torch.Tensor        # [B,K]
    yolo_sev: torch.Tensor     # [B,K]
    global_probs: torch.Tensor  # [B,C]
    crops_flat: torch.Tensor   # [B*kc,ci,ci,3] normalised crops
    crop_key: torch.Tensor     # [B*kc] the crop pool's key


class _SegRows(NamedTuple):
    """``FullForward.seg_rows``' outputs on a batch of B images."""

    rois: torch.Tensor         # [B*S,R,R] grey ROIs
    boxes: torch.Tensor        # [B*S,4]
    classes: torch.Tensor      # [B*S]
    valid: torch.Tensor        # [B*S]
    key: torch.Tensor          # [B*S] the seg pool's key


def _pool_key(valid: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The pools' flat sort key over (image, slot): valid slots sort above
    invalid ones (scores lie in [0,1]), then by score."""
    flat = scores.reshape(-1)
    return torch.where(valid.reshape(-1), flat + 2.0, flat)


def _own_slots(idx: torch.Tensor, offset: int, n: int, m: int):
    """Of the pool's flat indices ``idx`` (into a key of the whole batch),
    the first ``m`` that fall into this batch's slots [offset, offset + n),
    in pool order, as local slot indices, then indices n (no slot) to fill
    ``m``; and whether each is one of this batch's. ``m`` is static, so
    that the shapes are."""
    loc = idx - offset
    own = (loc >= 0) & (loc < n)
    order = torch.sort((~own).to(torch.uint8), stable=True).indices[:m]
    own = own[order]
    return torch.where(own, loc[order], torch.full_like(loc[order], n)), own


def pack_outputs(out: EnsembleOutputs):
    """det [B,K,15] = boxes(4), yolo_score, class, valid, area, yolo_severity,
    crop_class, crop_conf, crop_severity, crop_classified, ensemble_conf,
    final_severity; img [B,4+C] = severity counts(3), global probs(C),
    image confidence."""
    f = lambda t: t.to(torch.float32)
    det = torch.cat(
        [f(out.boxes)] + [f(t)[..., None] for t in (
            out.yolo_scores, out.classes, out.valid, out.areas, out.yolo_severity,
            out.crop_class, out.crop_conf, out.crop_severity, out.crop_classified,
            out.ensemble_conf, out.final_severity)],
        dim=-1)
    img = torch.cat([f(out.severity_counts), f(out.global_probs),
                     f(out.image_confidence)[..., None]], dim=-1)
    return det, img


def unpack_outputs(det: np.ndarray, img: np.ndarray) -> EnsembleOutputs:
    """Host-side inverse of pack_outputs (numpy in, numpy out)."""
    det = np.asarray(det)
    img = np.asarray(img)
    return EnsembleOutputs(
        boxes=det[..., 0:4], yolo_scores=det[..., 4], classes=det[..., 5].astype(np.int32),
        valid=det[..., 6] > 0.5, areas=det[..., 7], yolo_severity=det[..., 8].astype(np.int32),
        crop_class=det[..., 9].astype(np.int32), crop_conf=det[..., 10],
        crop_severity=det[..., 11].astype(np.int32), crop_classified=det[..., 12] > 0.5,
        ensemble_conf=det[..., 13], final_severity=det[..., 14].astype(np.int32),
        severity_counts=img[..., 0:3].astype(np.int32), global_probs=img[..., 3:-1],
        image_confidence=img[..., -1],
    )


def assess_overall_quality(n_minor: int, n_major: int, n_critical: int) -> Dict:
    """A-F grading from the per-image severity counts."""
    total = n_minor + n_major + n_critical
    if total == 0:
        return {
            "quality_grade": "A", "pass_fail": "PASS", "defect_density": 0.0,
            "risk_level": "low", "recommended_action": "accept",
        }
    if n_critical > 0:
        grade, pf, risk, action = "F", "FAIL", "high", "reject"
    elif n_major > 2:
        grade, pf, risk, action = "D", "FAIL", "high", "reject"
    elif n_major > 0:
        grade, pf, risk, action = "C", "CONDITIONAL", "medium", "review"
    elif n_minor > 3:
        grade, pf, risk, action = "B", "CONDITIONAL", "low", "review"
    else:
        grade, pf, risk, action = "A", "PASS", "low", "accept"
    return {
        "quality_grade": grade, "pass_fail": pf, "defect_density": total,
        "risk_level": risk, "recommended_action": action,
        "defect_breakdown": {"critical": n_critical, "major": n_major, "minor": n_minor},
    }


class EnsemblePredictor:
    """Owns both networks and the full forward on one device."""

    def __init__(self, yolo_weights: Optional[str] = None,
                 resnet_weights: Optional[str] = None,
                 config: Optional[SystemConfig] = None, device="cuda",
                 int8_state: Optional[Dict] = None):
        """``int8_state``: {"yolo": {"q", "scales"}, "resnet": {"q", "scales"}}
        with numpy leaves (``yolo_vars`` / ``resnet_vars`` of another int8
        predictor, of either package): served instead of calibrating anew."""
        cfg = config or SystemConfig()
        if isinstance(cfg, dict):
            cfg = SystemConfig.from_dict(cfg)
        self.config = cfg
        self.device = torch.device(device)
        exact_float32(self.device)
        m = cfg.model
        self.class_names = list(cfg.quality_control.defect_classes)
        self.ensemble_weights = dict(m.ensemble_weights)
        self.confidence_threshold = m.confidence_threshold
        self.nms_threshold = m.nms_threshold
        self.input_size = tuple(cfg.processing.input_size)
        self.max_detections = m.max_detections
        self.max_classified = m.max_classified

        self.compute_dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
        self.yolo = YOLOv8(num_classes=m.num_classes, width_mult=m.width_mult,
                           depth_mult=m.depth_mult, reg_max=m.reg_max, stem_mode=m.yolo_stem,
                           dtype=self.compute_dtype)
        self.resnet = ResNet50(num_classes=m.num_classes, stage_sizes=m.resnet_stages,
                               dtype=self.compute_dtype)
        # "checkpoint" or "initialized" per network, surfaced by get_model_info
        self.weights_source: Dict[str, str] = {
            "yolo": load_or_init(self.yolo, yolo_weights or m.yolo_weights, seed=0),
            "resnet": load_or_init(self.resnet, resnet_weights or m.resnet_weights, seed=1),
        }
        self.precision_report = None
        self.pruning_report = None
        if cfg.edge.sparsity > 0.0:
            # magnitude pruning on the Flax-layout weights, before any
            # precision lowering
            reports = {}
            for name in ("yolo", "resnet"):
                module = getattr(self, name)
                pruned, reports[name] = prune_magnitude(
                    to_flax(module), cfg.edge.sparsity, cfg.edge.structured_pruning)
                load_into(module, pruned)
            self.pruning_report = reports
        # the int8 networks' state as numpy, {"q": tree, "scales": [n]}
        # (no YOLO state under weight-only int8 storage)
        self.yolo_vars = self.resnet_vars = None
        self.calibration_seconds = None
        if cfg.edge.precision == "int8":
            self._setup_int8(int8_state)
        elif int8_state is not None:
            raise ValueError("int8_state needs edge.precision int8")
        # guards the thresholds and weights that _args reads, so that an
        # update from another thread is seen whole or not at all
        self.params_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        self.crop_classified_total = 0
        self.mock_tail_total = 0
        # (values, device tensors) of the last _args
        self._scalar_cache: Optional[Tuple] = None
        fwd = self.full_forward = FullForward(
            self.yolo, self.resnet, self.input_size, self.max_detections,
            self.max_classified, classifier_input=m.classifier_input,
            max_segmented=m.max_segmented, roi_size=m.seg_roi_size,
            crop_pool=m.max_classified_pool, seg_pool=m.max_segmented_pool,
            compute_dtype=self.compute_dtype,
        ).to(self.device).eval()
        self._forward = hoisted_jit(lambda images, *a: fwd.ensemble(fwd._input(images), *a))
        self._forward_packed = hoisted_jit(
            lambda images, *a: pack_outputs(fwd.ensemble(fwd._input(images), *a)))
        self._forward_full = hoisted_jit(fwd)
        # the sharded forward's stages, each captured on its own: the
        # collectives run between them (run_sharded)
        self._stages = {name: hoisted_jit(getattr(fwd, name))
                        for name in ("detect", "fuse", "seg_rows", "segment")}
        self._mesh_spec = None

    # -- int8 serving ------------------------------------------------------------

    def _setup_int8(self, state: Optional[Dict]) -> None:
        """Quantize both networks and calibrate their activation scales on
        this predictor's device. YOLO, by ``edge.yolo_int8`` and the stream
        flag: the int8-resident walk (fold, calibrate on the folded float
        forward, quantize with the scales folded into the weights), the v1
        walk (quantize, calibrate on the v1 walk), or weight-only int8
        storage (the float network with dequantized weights, nothing to
        calibrate). Then ResNet (quantize, calibrate on the v1 walk). A
        given ``state`` is installed instead of calibrating; it holds no
        YOLO state under weight-only storage."""
        cfg, m = self.config, self.config.model
        if not cfg.edge.yolo_int8:
            self._yolo_walk = "weight-only"
        elif _env_flag("IQC_YOLO_INT8_STREAM", cfg.edge.yolo_int8_stream):
            self._yolo_walk = "stream"
        else:
            self._yolo_walk = "v1"
        self._resnet_stream = _env_flag("IQC_RESNET_INT8_STREAM", cfg.edge.resnet_int8_stream)
        yolo_fp = to_flax(self.yolo)
        resnet_fp = to_flax(self.resnet)
        self._fp_bytes = {"yolo": resnet_int8.tree_size_bytes(yolo_fp),
                          "resnet": resnet_int8.tree_size_bytes(resnet_fp)}
        self._yolo_storage_report = None
        if self._yolo_walk == "weight-only":
            dequantized, self._yolo_storage_report = \
                EngineOptimizer(precision="int8").optimize_variables(yolo_fp)
            load_into(self.yolo, dequantized)
        if state is not None:
            if state.get("yolo") is not None:
                self.install_yolo_int8(state["yolo"]["q"], state["yolo"]["scales"])
            self.install_resnet_int8(state["resnet"]["q"], state["resnet"]["scales"])
            return
        t0 = time.perf_counter()
        n_cls = len(self.class_names)
        batches = (torch.from_numpy(b).to(self.device) for b in self._yolo_calibration_batches())
        if self._yolo_walk == "stream":
            fp_tree = yolo_int8_stream.device_tree(
                yolo_int8_stream.fold_fp(yolo_fp, stem_mode=m.yolo_stem), self.device)
            yscales = yolo_int8_stream.calibrate(fp_tree, batches, reg_max=m.reg_max,
                                                 num_classes=n_cls).cpu().numpy()
            del fp_tree
            yq = yolo_int8_stream.quantize(yolo_fp, yscales, stem_mode=m.yolo_stem,
                                           reg_max=m.reg_max, num_classes=n_cls)
        elif self._yolo_walk == "v1":
            yq = yolo_int8.quantize_yolo(yolo_fp, stem_mode=m.yolo_stem)
            dev_q = yolo_int8.device_tree(yq, self.device)
            yscales = yolo_int8.calibrate_activation_scales(
                dev_q, batches, reg_max=m.reg_max, num_classes=n_cls).cpu().numpy()
            del dev_q
        stages = tuple(m.resnet_stages)
        rq = resnet_int8.quantize_resnet(resnet_fp, stages)
        dev_q = resnet_int8.device_tree(rq, self.device)
        batches = (torch.from_numpy(b).to(self.device)
                   for b in self._calibration_batches(m.classifier_input))
        rscales = resnet_int8.calibrate_activation_scales(dev_q, batches, stages).cpu().numpy()
        del dev_q
        if self._yolo_walk != "weight-only":
            self.install_yolo_int8(yq, yscales)
        self.install_resnet_int8(rq, rscales)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_seconds = time.perf_counter() - t0

    def install_yolo_int8(self, q: Dict, scales) -> None:
        """Serve the int8 YOLO of tree ``q`` and scales ``scales`` (numpy,
        of either package) on the walk the config selects: a tree of
        ``yolo_int8_stream.quantize`` for the int8-resident walk, of
        ``yolo_int8.quantize_yolo`` for the v1 walk."""
        m = self.config.model
        if self._yolo_walk == "weight-only":
            raise ValueError("edge.yolo_int8 false serves the float YOLO: no int8 state")
        stream = self._yolo_walk == "stream"
        n = (yolo_int8_stream.n_tensors(m.depth_mult, m.yolo_stem) if stream
             else yolo_int8.n_convs(m.depth_mult, m.yolo_stem))
        if len(scales) != n:
            raise ValueError(f"{len(scales)} YOLO scales for the {n} slots of the "
                             f"{self._yolo_walk} walk")
        self.yolo_vars = {"q": q, "scales": np.asarray(scales, np.float32)}
        self.yolo = Int8YOLO(q, scales, m.reg_max, len(self.class_names), self.device,
                             stream=stream)
        self._report()

    def install_resnet_int8(self, q: Dict, scales) -> None:
        """Serve the int8 ResNet of tree ``q`` and scales ``scales`` (numpy;
        ``resnet_int8.quantize_resnet`` of either package)."""
        stages = tuple(self.config.model.resnet_stages)
        if len(scales) != resnet_int8.n_convs(stages):
            raise ValueError(f"{len(scales)} ResNet scales for {resnet_int8.n_convs(stages)} convs")
        self.resnet_vars = {"q": q, "scales": np.asarray(scales, np.float32)}
        self.resnet = Int8ResNet(q, scales, stages, self._resnet_stream, self.device)
        self._report()

    def _report(self) -> None:
        if self.resnet_vars is None or (self.yolo_vars is None
                                        and self._yolo_walk != "weight-only"):
            return
        fwd = getattr(self, "full_forward", None)
        if fwd is not None:
            fwd.yolo, fwd.resnet = self.yolo, self.resnet
            for jitted in (self._forward, self._forward_packed, self._forward_full,
                           *self._stages.values()):
                jitted.clear()  # the graphs read the networks they replaced
        q_bytes = resnet_int8.tree_size_bytes(self.resnet_vars["q"])
        v1_mode = "true-int8 MXU (static calibrated activations)"
        stream_mode = "true-int8 MXU, int8-resident activations (streaming v2)"
        if self._yolo_walk == "weight-only":
            yolo_mode = "weight-only int8 storage"
            yolo_reduction = self._yolo_storage_report["size_reduction_percent"]
        else:
            yolo_mode = stream_mode if self._yolo_walk == "stream" else v1_mode
            yq_bytes = resnet_int8.tree_size_bytes(self.yolo_vars["q"])
            yolo_reduction = 100.0 * (1 - yq_bytes / max(self._fp_bytes["yolo"], 1))
        self.precision_report = {
            "precision": "int8",
            "resnet": stream_mode if self._resnet_stream else v1_mode,
            "yolo": yolo_mode,
            "resnet_size_reduction_percent": round(
                100.0 * (1 - q_bytes / max(self._fp_bytes["resnet"], 1)), 1),
            "yolo_size_reduction_percent": round(yolo_reduction, 1),
        }

    def _calibration_batches(self, ci: int, n: int = 24):
        """ImageNet-normalised synthetic defect crops (24, seed 123) for the
        ResNet's activation calibration: each image's first valid defect
        box, widened by 1.3 (at least 32 px), bicubic-resized to ci x ci."""
        ds = SyntheticDefectDataset(n, 320, 8, seed=123, cache=False)
        crops = []
        for i in range(n):
            img, boxes, _, valid = ds.load(i)
            s0 = img.shape[0]
            if valid.any():
                x1, y1, x2, y2 = boxes[np.argmax(valid)]
                cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
                half = max(x2 - x1, y2 - y1, 32) / 2 * 1.3
                x1 = int(np.clip(cx - half, 0, s0 - 2))
                y1 = int(np.clip(cy - half, 0, s0 - 2))
                x2 = int(np.clip(cx + half, x1 + 2, s0))
                y2 = int(np.clip(cy + half, y1 + 2, s0))
                patch = img[y1:y2, x1:x2]
            else:
                patch = img
            crops.append(np.asarray(resize_bicubic(patch, (ci, ci)), np.float32))
        arr = np.stack(crops) / 255.0
        arr = (arr - np.asarray(imops.IMAGENET_MEAN)) / np.asarray(imops.IMAGENET_STD)
        yield arr.astype(np.float32)

    def _yolo_calibration_batches(self, n: int = 8):
        """Synthetic defect frames (8, seed 321) bicubic-resized to the
        detector input, scaled to [0, 1], for the YOLO calibration."""
        h, w = self.input_size
        ds = SyntheticDefectDataset(n, 320, 8, seed=321, cache=False)
        frames = [np.asarray(resize_bicubic(ds.load(i)[0], (w, h)), np.float32)
                  for i in range(n)]
        yield np.stack(frames) / 255.0

    def _args(self):
        """(conf_t, iou_t, w_yolo, w_resnet, sev_rules) for the forward, with
        the qc_specific overrides applied, as float32 tensors on the device
        (sev_rules None when unset). Read from the predictor on every call,
        so a change takes effect at the next request with no rebuild; the
        tensors are made again only when a value changed (each is a copy to
        the device)."""
        with self.params_lock:
            qc = self.config.qc_specific
            conf, nms, weights = (self.confidence_threshold, self.nms_threshold,
                                  self.ensemble_weights)
        conf_vec = qc.conf_vector(self.class_names, conf)
        nms_t = qc.nms_threshold if qc.nms_threshold is not None else nms
        sev = qc.severity_array()
        key = (tuple(conf_vec) if conf_vec else float(conf), float(nms_t),
               float(weights["yolo"]), float(weights["resnet"]),
               tuple(map(tuple, sev)) if sev else None)
        cached = self._scalar_cache
        if cached is None or cached[0] != key:
            t = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
            cached = (key, tuple(None if v is None else t(v) for v in key))
            self._scalar_cache = cached
        return cached[1]

    def run(self, images) -> EnsembleOutputs:
        """The detection-only forward (detection, crop classification,
        fusion) on a [B,H,W,3] batch (tensor or numpy); tensors out, on the
        device."""
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            return self._forward(x, *self._args())

    def run_host(self, images) -> EnsembleOutputs:
        """``run`` packed into two tensors and fetched to the host in one go;
        numpy out."""
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            det, img = self._forward_packed(x, *self._args())
            return unpack_outputs(det.cpu().numpy(), img.cpu().numpy())

    def run_full_host(self, images):
        """The whole forward on a [B,H,W,3] batch (tensor or numpy). Returns
        (EnsembleOutputs, masks [B,S,R,R], seg_stats [B,S,5]) as numpy."""
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            det, img, masks, stats = self._forward_full(x, *self._args())
            det, img, masks, stats = (t.cpu().numpy() for t in (det, img, masks, stats))
        return unpack_outputs(det, img), masks, stats

    def _sharded(self, images, mesh_spec, full: bool):
        spec = mesh_spec or self._mesh_spec
        if spec is None:
            spec = self._mesh_spec = create_mesh(self.config.mesh, device=self.device)
        n = len(images)
        if n % spec.data_size:
            raise ValueError(f"a batch of {n} images does not divide over the "
                             f"{spec.data_size} ranks of the data axis")
        x = shard_batch(spec, torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images))
        with torch.inference_mode():
            out = self.full_forward.sharded(spec, x, *self._args(), full=full,
                                            stages=self._stages)
            rows = [all_gather_rows(spec, t) for t in out]
        return EnsembleOutputs(*rows) if not full else tuple(rows)

    def run_sharded(self, images, mesh_spec=None) -> EnsembleOutputs:
        """``run`` data-parallel over the mesh (``mesh_spec``, by default
        ``create_mesh(config.mesh)``): every rank is handed the same global
        batch [B,H,W,3] (B a multiple of the data size) and the same
        weights, runs its rows, and returns the whole batch's outputs
        (tensors on its device), as the JAX version returns a global array.
        The crop pool chooses over the whole batch, so the result is
        ``run``'s; the qc_specific overrides apply as in ``run``."""
        return self._sharded(images, mesh_spec, full=False)

    def run_full_sharded(self, images, mesh_spec=None):
        """``run_full_host`` data-parallel over the mesh, as ``run_sharded``
        (both pools choose over the whole batch): numpy
        (EnsembleOutputs, masks [B,S,R,R], seg_stats [B,S,5]) on every rank."""
        det, img, masks, stats = (t.cpu().numpy() for t in
                                  self._sharded(images, mesh_spec, full=True))
        return unpack_outputs(det, img), masks, stats

    def build_result(self, out: EnsembleOutputs, i: int, image_shape) -> Dict:
        """Image ``i`` of fixed-capacity host arrays -> the combined-result schema."""
        o = EnsembleOutputs(*(np.asarray(a[i]) for a in out))
        n_valid = int(np.sum(o.valid))
        n_real = int(np.sum(o.valid & o.crop_classified))
        with self._counter_lock:
            self.crop_classified_total += n_real
            self.mock_tail_total += n_valid - n_real
        sy = image_shape[0] / self.input_size[0]
        sx = image_shape[1] / self.input_size[1]
        names = self.class_names
        name = lambda c: names[c] if 0 <= c < len(names) else f"class_{c}"
        detections = []
        cap = self.config.qc_specific.max_detections_per_image
        limit = min(len(o.valid), cap) if cap else len(o.valid)
        for j in range(limit):
            if not o.valid[j]:
                break
            x1, y1, x2, y2 = o.boxes[j]
            x1, x2 = int(x1 * sx), int(x2 * sx)
            y1, y2 = int(y1 * sy), int(y2 * sy)
            detections.append({
                "id": j,
                "class": name(int(o.classes[j])),
                "confidence": float(o.yolo_scores[j]),
                "bbox": {
                    "x1": x1, "y1": y1, "x2": x2, "y2": y2,
                    "width": x2 - x1, "height": y2 - y1,
                    "center_x": (x1 + x2) / 2, "center_y": (y1 + y2) / 2,
                },
                "area": (x2 - x1) * (y2 - y1),
                "severity": SEVERITY_NAMES[int(o.yolo_severity[j])],
                "ensemble_confidence": float(o.ensemble_conf[j]),
                "yolo_confidence": float(o.yolo_scores[j]),
                "resnet_confidence": float(o.crop_conf[j]),
                "classification_details": {
                    "predicted_class": name(int(o.crop_class[j])),
                    "confidence": float(o.crop_conf[j]),
                    "region_severity": SEVERITY_NAMES[int(o.crop_severity[j])],
                    "classification_source": "crop_resnet" if bool(o.crop_classified[j])
                    else "ensemble_refined",
                },
                "final_severity": SEVERITY_NAMES[int(o.final_severity[j])],
            })
        if cap and len(detections) == limit and n_valid > limit:
            # the cap truncated the list: grade what is reported
            sev_kept = o.final_severity[:limit]
            n_minor, n_major, n_crit = (int(np.sum(sev_kept == s)) for s in (0, 1, 2))
        else:
            n_minor, n_major, n_crit = (int(c) for c in o.severity_counts)
        global_cls = int(np.argmax(o.global_probs))
        return {
            "detections": detections,
            "global_classification": {
                "predicted_class": names[global_cls],
                "confidence": float(np.max(o.global_probs)),
                "class_probabilities": {names[k]: float(p) for k, p in enumerate(o.global_probs)},
            },
            "detection_summary": self._summary(detections),
            "quality_assessment": assess_overall_quality(n_minor, n_major, n_crit),
            "ensemble_confidence": float(o.image_confidence),
        }

    def predict(self, image) -> Dict:
        """Detection-only result for one [H,W,3] image (numpy or tensor)."""
        t0 = time.perf_counter()
        out = self.run_host(torch.as_tensor(image)[None])
        result = self.build_result(out, 0, tuple(image.shape))
        result["total_inference_time_ms"] = (time.perf_counter() - t0) * 1000
        return result

    def batch_predict(self, images: List[np.ndarray]) -> List[Dict]:
        """Detection-only results for equally sized images, as one batch."""
        t0 = time.perf_counter()
        out = self.run_host(np.stack(images))
        dt = (time.perf_counter() - t0) * 1000
        results = []
        for i, image in enumerate(images):
            r = self.build_result(out, i, image.shape)
            r["batch_index"] = i
            r["total_inference_time_ms"] = dt / len(images)
            results.append(r)
        return results

    def update_ensemble_weights(self, yolo_weight: float, resnet_weight: float) -> None:
        """Set the fusion weights, renormalised to sum to 1."""
        total = yolo_weight + resnet_weight
        with self.params_lock:
            self.ensemble_weights = {"yolo": yolo_weight / total, "resnet": resnet_weight / total}

    @staticmethod
    def _summary(detections: List[Dict]) -> Dict:
        if not detections:
            return {
                "total_defects": 0, "defect_counts": {}, "severity_distribution": {},
                "average_confidence": 0.0, "max_severity": "none",
            }
        counts: Dict[str, int] = {}
        sev_counts = {"minor": 0, "major": 0, "critical": 0}
        for d in detections:
            counts[d["class"]] = counts.get(d["class"], 0) + 1
            sev_counts[d["final_severity"]] += 1
        max_sev = next((s for s in ("critical", "major", "minor") if sev_counts[s]), "none")
        return {
            "total_defects": len(detections),
            "defect_counts": counts,
            "severity_distribution": sev_counts,
            "average_confidence": float(np.mean([d["ensemble_confidence"] for d in detections])),
            "max_severity": max_sev,
        }

    def get_model_info(self) -> Dict:
        return {
            "ensemble_weights": self.ensemble_weights,
            "confidence_threshold": self.confidence_threshold,
            "models_loaded": {"yolo": True, "resnet": True},
            "weights_source": dict(self.weights_source),
            "untrained_weights": any(v != "checkpoint" for v in self.weights_source.values()),
            "yolo_info": {
                "input_size": self.input_size,
                "max_detections": self.max_detections,
                "class_names": self.class_names,
            },
            "resnet_info": {
                "num_classes": len(self.class_names),
                "input_size": (224, 224),
                "max_classified_crops": self.max_classified,
            },
            "fused_graph": True,
            "serving_precision": self.config.edge.precision,
            "precision_report": self.precision_report,
            "pruning_report": self.pruning_report,
            "device": str(self.device),
        }

    def visualize_ensemble_results(self, image: np.ndarray, results: Dict) -> np.ndarray:
        """Boxes of a result drawn on ``image``, with its pass/fail strip."""
        from iqc_tpu_torch.inference.visualize import draw_detections, draw_quality_overlay

        vis = draw_detections(image, results.get("detections", []))
        qa = results.get("quality_assessment", {})
        return draw_quality_overlay(vis, qa) if qa else vis


class EnsembleOptimizer:
    """Grid search of the fusion weights over labelled validation images.
    The weights are read by the forward on every call, so each trial reuses
    the predictor as it is."""

    def __init__(self, ensemble_predictor: EnsemblePredictor):
        self.ensemble = ensemble_predictor
        self.performance_history: List[Dict] = []

    def optimize_weights(self, validation_data: List[Tuple[np.ndarray, Dict]],
                         steps: int = 9) -> Dict:
        """Try yolo weights k / (steps + 1), k = 1..steps, keep the best
        score (the first of equal scores) and leave it set."""
        best = {"yolo": 0.6, "resnet": 0.4}
        best_score = -1.0
        original = dict(self.ensemble.ensemble_weights)
        for k in range(1, steps + 1):
            wy = k / (steps + 1)
            self.ensemble.update_ensemble_weights(wy, 1.0 - wy)
            score = self._evaluate(validation_data)
            self.performance_history.append(
                {"weights": dict(self.ensemble.ensemble_weights), "score": score})
            if score > best_score:
                best_score = score
                best = dict(self.ensemble.ensemble_weights)
        with self.ensemble.params_lock:
            self.ensemble.ensemble_weights = best if best_score >= 0 else original
        return {"best_weights": best, "best_score": best_score,
                "history": self.performance_history}

    def _evaluate(self, validation_data) -> float:
        """Mean per-image score over the label's components -- ``pass`` /
        ``PASS`` (pass/fail agreement), ``class`` (name or id: the global
        class), ``defect_count`` (1 / (1 + |error|)) -- plus 0.01 x the mean
        confidence, signed by whether the image scored at least 0.5. One
        ``batch_predict`` per image shape."""
        if not validation_data:
            return 0.0
        names = self.ensemble.class_names
        imgs = [np.asarray(img) for img, _ in validation_data]
        by_shape: Dict[Tuple[int, ...], List[int]] = {}
        for idx, img in enumerate(imgs):
            by_shape.setdefault(img.shape, []).append(idx)
        results: List[Optional[Dict]] = [None] * len(imgs)
        for idxs in by_shape.values():
            for r, idx in zip(self.ensemble.batch_predict([imgs[i] for i in idxs]), idxs):
                results[idx] = r
        scores, calib = [], []
        for result, (_, label) in zip(results, validation_data):
            parts = []
            if "pass" in label or "PASS" in label:
                want = bool(label.get("pass", label.get("PASS")))
                parts.append(float((result["quality_assessment"]["pass_fail"] == "PASS") == want))
            if "class" in label:
                want_cls = label["class"]
                if isinstance(want_cls, int) and 0 <= want_cls < len(names):
                    want_cls = names[want_cls]
                parts.append(float(result["global_classification"]["predicted_class"]
                                   == want_cls))
            if "defect_count" in label:
                got_n = len(result.get("detections", []))
                parts.append(1.0 / (1.0 + abs(got_n - int(label["defect_count"]))))
            s = float(np.mean(parts)) if parts else 0.5
            conf = float(result.get("ensemble_confidence", 0.0))
            scores.append(s)
            calib.append(conf if s >= 0.5 else -conf)
        return float(np.mean(scores)) + 0.01 * float(np.mean(calib))

    def benchmark_performance(self, test_images: List[np.ndarray]) -> Dict:
        """Wall time of ``predict`` over the images, one by one."""
        t0 = time.perf_counter()
        results = [self.ensemble.predict(img) for img in test_images]
        total = time.perf_counter() - t0
        n = max(len(test_images), 1)
        return {
            "total_images": len(test_images),
            "total_time_seconds": total,
            "average_inference_time_ms": total / n * 1000.0,
            "throughput_images_per_second": n / total if total > 0 else 0.0,
            "results": results,
        }
