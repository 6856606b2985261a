"""Box geometry on [..., 4] xyxy tensors."""

from __future__ import annotations

import math

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes (negative extents count as zero)."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., N, 4] x [..., M, 4] -> [..., N, M]; zero where
    the union is empty."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    union = box_area(a) + box_area(b) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                       torch.zeros_like(inter))


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of matched xyxy boxes [..., 4] (the training loss's box
    term): IoU less the centre distance over the enclosing diagonal, less
    the aspect-ratio term."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    union = box_area(a) + box_area(b) - inter + eps
    iou = inter / union

    cx1 = torch.minimum(a[..., 0], b[..., 0])
    cy1 = torch.minimum(a[..., 1], b[..., 1])
    cx2 = torch.maximum(a[..., 2], b[..., 2])
    cy2 = torch.maximum(a[..., 3], b[..., 3])
    c2 = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2 + eps

    rho2 = (((a[..., 0] + a[..., 2]) - (b[..., 0] + b[..., 2])) ** 2
            + ((a[..., 1] + a[..., 3]) - (b[..., 1] + b[..., 3])) ** 2) / 4.0

    wa = a[..., 2] - a[..., 0]
    ha = a[..., 3] - a[..., 1] + eps
    wb = b[..., 2] - b[..., 0]
    hb = b[..., 3] - b[..., 1] + eps
    v = (4 / math.pi ** 2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = v / (v - iou + 1 + eps)
    return iou - rho2 / c2 - alpha * v


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def clamp_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Clamp xyxy boxes into the image with x2 > x1 and y2 > y1."""
    x1 = torch.clamp(boxes[..., 0], 0.0, width - 1.0)
    y1 = torch.clamp(boxes[..., 1], 0.0, height - 1.0)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], x1 + 1.0), torch.full_like(x1, float(width)))
    y2 = torch.minimum(torch.maximum(boxes[..., 3], y1 + 1.0), torch.full_like(y1, float(height)))
    return torch.stack([x1, y1, x2, y2], dim=-1)
