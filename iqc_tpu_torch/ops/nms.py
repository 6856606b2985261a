"""DFL box decode and fixed-capacity class-aware NMS with merge voting.

Batched over images: one suppression kernel launch covers the whole batch.
Capacity K = min(max_detections, anchors) candidates per image are taken by
score (ties keep the lower anchor index first), suppressed by
``nms_kernel.suppress`` for a fixed number of rounds (or, with
``iterations=None``, by the exact sequential greedy recurrence in plain
PyTorch, ``suppress_exact``), optionally merged by
score x IoU weighted box voting, compacted to the front in score order and
padded back to ``max_detections`` slots.

The IoU and score thresholds are Python floats or tensors on the boxes'
device (0-d, or [C] per-class score floors). Nothing here builds a tensor
from a host value, so a captured forward reads the thresholds its inputs
hold at each replay.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from iqc_tpu_torch.ops.boxes import iou_matrix
from iqc_tpu_torch.ops.nms_kernel import suppress


class Detections(NamedTuple):
    """Fixed-capacity detection set; invalid slots have valid=False."""

    boxes: torch.Tensor    # [B,K,4] xyxy pixels
    scores: torch.Tensor   # [B,K]
    classes: torch.Tensor  # [B,K] int32, -1 where invalid
    valid: torch.Tensor    # [B,K] bool


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres [A,2] (x, y pixels) and per-anchor strides [A]."""
    points, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        points.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
        strs.append(torch.full((h * w,), float(s), dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(strs)


def dfl_decode(dist_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """[..., 4*reg_max] logits -> [..., 4] expected (l, t, r, b) distances in
    stride units: the softmax expectation over each reg_max-bin block. The
    exponent is taken against the per-anchor maximum over all four blocks."""
    x = dist_logits.to(torch.float32)
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    e = e.reshape(*x.shape[:-1], 4, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (e * bins).sum(-1) / torch.clamp(e.sum(-1), min=1e-20)


def decode_boxes(dist_logits: torch.Tensor, anchor_points: torch.Tensor,
                 strides: torch.Tensor, reg_max: int) -> torch.Tensor:
    """[..., A, 4*reg_max] -> [..., A, 4] xyxy pixel boxes."""
    ltrb = dfl_decode(dist_logits, reg_max) * strides[..., None]
    ax, ay = anchor_points[..., 0], anchor_points[..., 1]
    return torch.stack([ax - ltrb[..., 0], ay - ltrb[..., 1],
                        ax + ltrb[..., 2], ay + ltrb[..., 3]], dim=-1)


def suppress_exact(boxes: torch.Tensor, iou_threshold) -> torch.Tensor:
    """Greedy-NMS keep mask [B,K] of score-sorted boxes [B,K,4], exact:
    candidate i, in order, suppresses every later j with IoU > threshold
    while it is itself kept (K sequential steps)."""
    overlap = iou_matrix(boxes, boxes) > iou_threshold
    k = boxes.shape[-2]
    later = torch.arange(k, device=boxes.device)
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    for i in range(k):
        keep = keep & ~(overlap[:, i] & (later > i) & keep[:, i:i + 1])
    return keep


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B,N,...] indexed along dim 1 by idx [B,M]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


Threshold = Union[float, torch.Tensor]


def _nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
         passed: torch.Tensor, max_detections: int, iou_threshold: Threshold,
         class_aware: bool, iterations: Optional[int], box_voting: bool) -> Detections:
    """NMS over a batch: boxes [B,A,4], scores [B,A], classes [B,A] int32,
    passed [B,A] bool (candidates that cleared the score floor)."""
    s = torch.where(passed, scores, torch.full_like(scores, -1.0))
    pool = min(max_detections, s.shape[-1])
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :pool]
    top_scores = torch.gather(s, 1, order)
    top_boxes = _gather(boxes, order)
    top_classes = torch.gather(classes, 1, order)
    cand_valid = top_scores > 0.0

    if class_aware:  # offset boxes per class so IoU across classes is zero
        iou_boxes = top_boxes + top_classes.to(torch.float32)[..., None] * 1e5
    else:
        iou_boxes = top_boxes
    keep = (suppress_exact(iou_boxes, iou_threshold) if iterations is None
            else suppress(iou_boxes, iou_threshold, iterations))
    valid = cand_valid & keep

    if box_voting:
        # candidate j votes for kept box i with weight score_j * iou(i,j),
        # gated at the NMS threshold; a kept box votes for itself
        iou = iou_matrix(iou_boxes, iou_boxes)
        w = torch.where((iou >= iou_threshold) & cand_valid[:, None, :],
                        top_scores[:, None, :] * iou, torch.zeros_like(iou))
        voted = torch.bmm(w, top_boxes)
        voted = voted / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        top_boxes = torch.where(valid[..., None], voted, top_boxes)

    # survivors to the front, keeping score order
    front = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    det = Detections(
        boxes=_gather(top_boxes, front),
        scores=torch.gather(torch.where(valid, top_scores, torch.zeros_like(top_scores)), 1, front),
        classes=torch.gather(torch.where(valid, top_classes, torch.full_like(top_classes, -1)), 1, front),
        valid=torch.gather(valid, 1, front),
    )
    pad = max_detections - pool
    if pad > 0:
        b = boxes.shape[0]
        det = Detections(
            boxes=torch.cat([det.boxes, det.boxes.new_zeros(b, pad, 4)], dim=1),
            scores=torch.cat([det.scores, det.scores.new_zeros(b, pad)], dim=1),
            classes=torch.cat([det.classes, det.classes.new_full((b, pad), -1)], dim=1),
            valid=torch.cat([det.valid, det.valid.new_zeros(b, pad)], dim=1),
        )
    return det


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
               mask: torch.Tensor, max_detections: int, iou_threshold: Threshold,
               score_threshold: Threshold, class_aware: bool = True,
               iterations: Optional[int] = 16, box_voting: bool = False) -> Detections:
    """NMS of one image: boxes [A,4], scores [A], classes [A], mask [A] bool
    (pre-filter). Returns Detections of [K] slots, score-descending.
    ``iterations=None``: the exact sequential suppression."""
    passed = mask & (scores > score_threshold)
    det = _nms(boxes[None].to(torch.float32), scores[None].to(torch.float32),
               classes[None].to(torch.int32), passed[None], max_detections,
               iou_threshold, class_aware, iterations, box_voting)
    return Detections(*(x[0] for x in det))


def batched_nms(boxes: torch.Tensor, scores_all: torch.Tensor, max_detections: int,
                iou_threshold: Threshold, score_threshold: Threshold,
                class_aware: bool = True, iterations: Optional[int] = 16,
                box_voting: bool = False) -> Detections:
    """Class-aware NMS of boxes [B,A,4] with per-class scores [B,A,C].

    Each anchor takes its best class. ``score_threshold`` is a scalar or a
    [C] tensor of per-class floors (each anchor gated by its class's floor).
    """
    scores, classes = torch.max(scores_all, dim=-1)
    classes = classes.to(torch.int32)
    per_class = isinstance(score_threshold, torch.Tensor) and score_threshold.dim() == 1
    passed = scores > (score_threshold[classes.long()] if per_class else score_threshold)
    return _nms(boxes, scores, classes, passed, max_detections, iou_threshold,
                class_aware, iterations, box_voting)


def decode_and_nms(dist_logits: torch.Tensor, cls_logits: torch.Tensor,
                   anchor_points: torch.Tensor, strides: torch.Tensor, reg_max: int,
                   max_detections: int, iou_threshold: Threshold,
                   score_threshold: Threshold,
                   iterations: Optional[int] = 16, box_voting: bool = False) -> Detections:
    """DFL decode -> sigmoid scores -> class-aware NMS.
    dist_logits [B,A,4*reg_max]; cls_logits [B,A,C]."""
    boxes = decode_boxes(dist_logits, anchor_points, strides, reg_max)
    scores_all = torch.sigmoid(cls_logits.to(torch.float32))
    return batched_nms(boxes.to(torch.float32), scores_all, max_detections=max_detections,
                       iou_threshold=iou_threshold, score_threshold=score_threshold,
                       iterations=iterations, box_voting=box_voting)
