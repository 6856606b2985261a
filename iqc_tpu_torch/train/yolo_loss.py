"""YOLOv8 training losses: task-aligned assignment, CIoU, DFL and BCE.

The JAX package's ``train/yolo_loss.py`` on torch tensors, batched over the
images (the JAX package maps a per-image assignment over the batch):

- Task-aligned assigner (TAL): alignment = score^alpha * IoU^beta over the
  anchors whose centre lies inside the gt box; the top k anchors of each gt
  (among equal alignments the lower anchor index first, as ``lax.top_k``
  orders them); an anchor claimed by several gts goes to the one of highest
  IoU (the first such gt).
- Classification: BCE against alignment-normalized soft targets, optionally
  weighted per class.
- Box: CIoU loss on the assigned anchors. DFL: cross-entropy against the two
  integer bins bracketing each target ltrb distance.

Each one-hot masked sum of the JAX package selects exactly one element, so a
gather here gives the same value. The two powers of the alignment are taken
in float64 and rounded to float32, which matches XLA's float32 ``pow``
more closely than PyTorch's float32 one.

On a data-parallel mesh each rank holds some images of the global batch.
The normaliser (the sum of the target scores, at least 1) is global, as it
is in the JAX package under GSPMD: each rank all-reduces its sum before the
clamp, and its loss is then its share of the global loss (the shares sum to
it). The assignment is per image and stays on the rank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from iqc_tpu_torch.ops.boxes import ciou
from iqc_tpu_torch.ops.nms import decode_boxes
from iqc_tpu_torch.parallel.mesh import all_reduce_sum


class YoloLossConfig(NamedTuple):
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    tal_topk: int = 10


def _pairwise_iou(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """IoU between [..., M, 4] gts and [..., A, 4] preds -> [..., M, A]."""
    x1 = torch.maximum(gt[..., :, None, 0], pred[..., None, :, 0])
    y1 = torch.maximum(gt[..., :, None, 1], pred[..., None, :, 1])
    x2 = torch.minimum(gt[..., :, None, 2], pred[..., None, :, 2])
    y2 = torch.minimum(gt[..., :, None, 3], pred[..., None, :, 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ag = torch.clamp(gt[..., 2] - gt[..., 0], min=0) * torch.clamp(gt[..., 3] - gt[..., 1], min=0)
    ap = (torch.clamp(pred[..., 2] - pred[..., 0], min=0)
          * torch.clamp(pred[..., 3] - pred[..., 1], min=0))
    union = ag[..., :, None] + ap[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9), torch.zeros_like(inter))


def _pow32(x: torch.Tensor, p: float) -> torch.Tensor:
    return torch.pow(x.to(torch.float64), p).to(torch.float32)


def assign_targets(
    pred_boxes: torch.Tensor,   # [B,A,4] decoded xyxy (detached)
    pred_scores: torch.Tensor,  # [B,A,C] sigmoid class scores (detached)
    anchors: torch.Tensor,      # [A,2] centre points (pixels)
    gt_boxes: torch.Tensor,     # [B,M,4] xyxy
    gt_classes: torch.Tensor,   # [B,M] int
    gt_valid: torch.Tensor,     # [B,M] bool
    cfg: YoloLossConfig,
) -> Dict[str, torch.Tensor]:
    """Task-aligned assignment of a batch. Returns per anchor [B,A]: fg
    mask, assigned gt index, target class, target box [B,A,4] and soft
    target score."""
    a = anchors.shape[0]
    c = pred_scores.shape[-1]
    ax, ay = anchors[:, 0], anchors[:, 1]
    inside = ((ax > gt_boxes[..., 0, None]) & (ax < gt_boxes[..., 2, None])
              & (ay > gt_boxes[..., 1, None]) & (ay < gt_boxes[..., 3, None]))  # [B,M,A]
    candidate = inside & gt_valid[..., None]

    iou = _pairwise_iou(gt_boxes, pred_boxes)  # [B,M,A]
    cls_idx = torch.clamp(gt_classes.long(), 0, c - 1)
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1,
                             cls_idx[..., None].expand(-1, -1, a))  # [B,M,A]
    align = _pow32(cls_score, cfg.tal_alpha) * _pow32(iou, cfg.tal_beta)
    align = torch.where(candidate, align, torch.zeros_like(align))

    # top k anchors per gt, ties to the lower index (a stable descending
    # sort); the floor is relative (align > 0): early alignments are ~1e-14
    k = min(cfg.tal_topk, a)
    topk_idx = torch.sort(align, dim=-1, descending=True, stable=True).indices[..., :k]
    topk_mask = torch.zeros_like(candidate).scatter_(-1, topk_idx, True)
    mask = topk_mask & (align > 0.0) & candidate

    # conflict resolution: the anchor goes to the gt of highest IoU
    iou_masked = torch.where(mask, iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou_masked, dim=1)                      # [B,A]
    fg = torch.amax(iou_masked, dim=1) > -0.5                      # [B,A]

    tgt_class = torch.where(fg, torch.gather(gt_classes, 1, best_gt),
                            torch.zeros_like(best_gt, dtype=gt_classes.dtype))
    tgt_box = torch.gather(gt_boxes, 1, best_gt[..., None].expand(-1, -1, 4))  # [B,A,4]
    # soft score: alignment normalized per gt so that its max is its max IoU
    align_sel = torch.gather(align, 1, best_gt[:, None, :])[:, 0]
    gt_max_align = torch.amax(align, dim=2)                        # [B,M]
    gt_max_iou = torch.amax(torch.where(mask, iou, torch.zeros_like(iou)), dim=2)
    norm = (torch.gather(gt_max_iou, 1, best_gt)
            / torch.clamp(torch.gather(gt_max_align, 1, best_gt), min=1e-9))
    tgt_score = torch.where(fg, align_sel * norm, torch.zeros_like(align_sel))
    return {
        "fg": fg,
        "gt_index": best_gt,
        "target_class": tgt_class,
        "target_box": tgt_box,
        "target_score": torch.clamp(tgt_score, 0.0, 1.0),
    }


def dfl_loss(dist_logits: torch.Tensor, target_ltrb: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss: CE against the two bracketing bins.
    [..., A, 4*reg_max] and [..., A, 4] -> [..., A]."""
    logits = dist_logits.reshape(*dist_logits.shape[:-1], 4, reg_max).to(torch.float32)
    t = torch.clamp(target_ltrb, 0.0, reg_max - 1 - 1e-3)
    lo = torch.floor(t)
    w_hi = t - lo
    w_lo = 1.0 - w_hi
    logp = F.log_softmax(logits, dim=-1)
    lo_i = lo.long()[..., None]
    lp_lo = torch.gather(logp, -1, lo_i)[..., 0]
    lp_hi = torch.gather(logp, -1, lo_i + 1)[..., 0]
    return torch.mean(-(w_lo * lp_lo + w_hi * lp_hi), dim=-1)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (elementwise), optax's formula."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def yolo_loss(
    dist_logits: torch.Tensor,  # [B,A,4*reg_max]
    cls_logits: torch.Tensor,   # [B,A,C]
    anchors: torch.Tensor,      # [A,2]
    strides: torch.Tensor,      # [A]
    gt_boxes: torch.Tensor,     # [B,M,4]
    gt_classes: torch.Tensor,   # [B,M]
    gt_valid: torch.Tensor,     # [B,M]
    reg_max: int,
    cfg: YoloLossConfig = YoloLossConfig(),
    class_weights: Optional[torch.Tensor] = None,  # [C]
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss (0-d) and its parts. ``class_weights`` scales each class
    column of the classification BCE (positive and negative terms); box and
    DFL terms are unweighted. None is unweighted. With a ``mesh``
    (``parallel.mesh.MeshSpec``) the batch is this rank's rows of the
    global batch: the normaliser is the global one, and the loss and its
    parts are this rank's shares (``num_fg`` its own count)."""
    pred_boxes = decode_boxes(dist_logits, anchors, strides, reg_max)  # [B,A,4]
    pred_scores = torch.sigmoid(cls_logits.to(torch.float32))
    assign = assign_targets(pred_boxes.detach(), pred_scores.detach(), anchors,
                            gt_boxes, gt_classes, gt_valid, cfg)
    fg = assign["fg"]
    tgt_score = assign["target_score"]
    n_fg = torch.clamp(all_reduce_sum(mesh, torch.sum(tgt_score)), min=1.0)

    c = cls_logits.shape[-1]
    classes = torch.arange(c, device=cls_logits.device)
    onehot = ((assign["target_class"][..., None] == classes).to(torch.float32)
              * tgt_score[..., None])
    logits32 = cls_logits.to(torch.float32)
    bce = sigmoid_bce(logits32, onehot)
    if class_weights is not None:
        bce = bce * class_weights.to(torch.float32)[None, None, :]
    cls_l = torch.sum(bce) / n_fg

    ciou_val = ciou(pred_boxes, assign["target_box"])
    zero = torch.zeros_like(tgt_score)
    box_l = torch.sum(torch.where(fg, (1.0 - ciou_val) * tgt_score, zero)) / n_fg

    tb = assign["target_box"]
    target_ltrb = torch.stack([(anchors[:, 0] - tb[..., 0]) / strides,
                               (anchors[:, 1] - tb[..., 1]) / strides,
                               (tb[..., 2] - anchors[:, 0]) / strides,
                               (tb[..., 3] - anchors[:, 1]) / strides], dim=-1)
    dfl_each = dfl_loss(dist_logits, target_ltrb, reg_max)
    dfl_l = torch.sum(torch.where(fg, dfl_each * tgt_score, zero)) / n_fg

    total = cfg.box_gain * box_l + cfg.cls_gain * cls_l + cfg.dfl_gain * dfl_l
    return total, {
        "box_loss": box_l,
        "cls_loss": cls_l,
        "dfl_loss": dfl_l,
        "num_fg": torch.sum(fg.to(torch.float32)),
    }
