"""Defect segmentation of fixed-size grayscale ROIs, batched over ROIs.

Each ROI [R,R] (float in [0,1]) runs all four methods and keeps the one its
class selects:
- threshold: Otsu on the sigma-1 blur, biased per class, then cleanup;
- adaptive: Gaussian local-mean threshold, close(1), open(1), open(2);
- watershed (observable form): the cleaned full ROI when the blurred ROI has
  3x3 regional extrema, else empty;
- region growing: seeds past a contrast threshold against the border-ring
  median, grown geodesically inside |I - seed_mean| < 2 std, then cleanup.
The two iteration-heavy tails (cleanup of the threshold masks, growth plus
cleanup of the seeds) are the CUDA kernels of ``morph_kernel``. Area,
perimeter (boundary-pixel count) and compactness are measured on the ROI
grid and scaled to source-image units by the box scale.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops.jit_utils import device_constant
from iqc_tpu_torch.ops.morph_kernel import clean, grow_clean

METHOD_THRESHOLD, METHOD_ADAPTIVE, METHOD_WATERSHED, METHOD_REGION_GROWING = 0, 1, 2, 3

# class -> method: crack/scratch -> adaptive, dent -> watershed,
# discoloration -> threshold, contamination -> region growing
CLASS_TO_METHOD = np.asarray([1, 1, 2, 0, 3], dtype=np.int32)
# class -> Otsu threshold bias
CLASS_THRESH_ADJUST = np.asarray([0.9, 0.9, 1.1, 0.8, 0.85], dtype=np.float32)
# classes whose defects are darker than the background
CLASS_IS_DARK = np.asarray([1, 1, 1, 0, 0], dtype=bool)

GROW_ITERATIONS = 24
FILL_ITERATIONS = 16


def table_lookup(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a per-class numpy table and a class-id tensor; the
    table is placed on the device once (``device_constant``)."""
    return device_constant(table, idx.device)[idx.long()]


class SegmentationOutputs(NamedTuple):
    masks: torch.Tensor        # [N,R,R] bool, ROI-grid masks
    area: torch.Tensor         # [N] pixels in source-image units
    perimeter: torch.Tensor    # [N] source-image units
    compactness: torch.Tensor  # [N] 4*pi*A/P^2, clamped to [0,1]
    confidence: torch.Tensor   # [N] per-method confidence
    method: torch.Tensor       # [N] int32 method id


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def clean_mask_batch(mask: torch.Tensor) -> torch.Tensor:
    """Cleanup of [N,R,R] bool masks: open(1), hole fill, close(2), open(2)
    (K3 on the card)."""
    return clean(mask, FILL_ITERATIONS)


def grow_clean_batch(seeds: torch.Tensor, allow: torch.Tensor,
                     iterations: int = GROW_ITERATIONS) -> torch.Tensor:
    """Geodesic growth of [N,R,R] seeds inside ``allow`` for ``iterations``
    steps, then the cleanup (K2 on the card)."""
    return grow_clean(seeds, allow, iterations, FILL_ITERATIONS)


def morph_tails_batch(m_t_raw: torch.Tensor, seeds: torch.Tensor, allow: torch.Tensor,
                      iterations: int = GROW_ITERATIONS
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both iteration-heavy tails over [N,R,R]: cleanup of the raw threshold
    masks, and geodesic growth plus cleanup of the region seeds. Returns
    (m_t, m_r, full), where ``full`` [R,R] is the cleanup of an all-ones ROI
    (the watershed method's mask), cleaned in the same launch as m_t."""
    ones = torch.ones((1,) + tuple(m_t_raw.shape[1:]), dtype=torch.bool, device=m_t_raw.device)
    cleaned = clean(torch.cat([m_t_raw, ones]), FILL_ITERATIONS)
    m_r = grow_clean(seeds, allow, iterations, FILL_ITERATIONS)
    return cleaned[:-1], m_r, cleaned[-1]


def _std(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).std(dim=1, correction=0)


def _separation_confidence(roi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """|fg mean - bg mean| / (3 std), clamped to [0,1]; 0 when either side is empty."""
    n_fg = _sum(mask.to(torch.int32))
    n_bg = mask.shape[1] * mask.shape[2] - n_fg
    zero = torch.zeros_like(roi)
    fg_mean = _sum(torch.where(mask, roi, zero)) / torch.clamp(n_fg, min=1)
    bg_mean = _sum(torch.where(mask, zero, roi)) / torch.clamp(n_bg, min=1)
    sep = torch.abs(fg_mean - bg_mean) / (_std(roi) + 1e-6)
    conf = torch.clamp(sep / 3.0, max=1.0)
    return torch.where((n_fg > 0) & (n_bg > 0), conf, torch.zeros_like(conf))


def _edge_overlap_confidence(roi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0.5 + 0.5 * (Sobel edge pixels inside the mask / mask pixels); 0.3 when
    the mask covers under 1% or over 80% of the ROI."""
    ratio = mask.to(torch.float32).reshape(mask.shape[0], -1).mean(dim=1)
    edges = imops.sobel_magnitude(roi) > 0.3
    n_mask = torch.clamp(_sum(mask.to(torch.int32)), min=1)
    overlap = _sum((edges & mask).to(torch.int32)) / n_mask
    conf = torch.clamp(0.5 + 0.5 * overlap, max=1.0)
    return torch.where((ratio < 0.01) | (ratio > 0.8), torch.full_like(conf, 0.3), conf)


def _threshold_pre(roi: torch.Tensor, adjust: torch.Tensor, dark: torch.Tensor,
                   blurred: torch.Tensor) -> torch.Tensor:
    """Raw Otsu mask (before cleanup) with the per-class bias."""
    t = _bcast(imops.otsu_threshold(blurred) * adjust)
    return torch.where(_bcast(dark), blurred < t, blurred > t)


def _adaptive_segment(roi: torch.Tensor, dark: torch.Tensor, block_size: int):
    lo = roi.reshape(roi.shape[0], -1).min(dim=1).values
    hi = roi.reshape(roi.shape[0], -1).max(dim=1).values
    norm = (roi - _bcast(lo)) / _bcast(torch.clamp(hi - lo, min=1e-6))
    thresh = imops.adaptive_local_mean(norm, block_size) - 2.0 / 255.0
    mask = torch.where(_bcast(dark), norm < thresh, norm > thresh)
    mask = imops.binary_open(imops.binary_close(mask, 1), 1)
    mask = imops.binary_open(mask, 2)
    return mask, _edge_overlap_confidence(norm, mask)


def _watershed_segment(roi: torch.Tensor, dark: torch.Tensor, blurred: torch.Tensor,
                       full: torch.Tensor):
    """Marker count from 3x3 regional extrema of the blurred ROI; the mask is
    ``full`` (the cleaned all-ones ROI) wherever markers exist. Confidence
    prefers ~3 markers and ~20% coverage."""
    probe = torch.where(_bcast(dark), blurred, -blurred)
    win_min = -F.max_pool2d(-probe[:, None], 3, 1, 1)[:, 0]
    markers = probe <= win_min + 1e-7
    n_markers = _sum(markers.to(torch.int32))
    mask = full[None] & _bcast(n_markers > 0)
    ratio = mask.to(torch.float32).reshape(mask.shape[0], -1).mean(dim=1)
    region_score = 1.0 / (1.0 + torch.abs(n_markers.to(torch.float32) - 3.0))
    ratio_score = torch.clamp(1.0 - torch.abs(ratio - 0.2), min=0.0)
    conf = torch.clamp(0.5 * region_score + 0.5 * ratio_score, max=1.0)
    return mask, conf


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 1, the mean of the two middle values for even counts."""
    n = x.shape[1]
    s = torch.sort(x, dim=1).values
    return (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5


def _region_pre(roi: torch.Tensor, dark: torch.Tensor, blurred: torch.Tensor):
    """Region-growing seeds: interior pixels past 35% of the contrast against
    the border-ring median (ROIs with contrast <= 0.06 get none). Returns
    (seeds, grow_ok, n_seeds)."""
    n, h, w = roi.shape
    margin = max(h // 8, 2)
    yy = torch.arange(h, device=roi.device)[:, None]
    xx = torch.arange(w, device=roi.device)[None, :]
    ring = (yy < margin) | (yy >= h - margin) | (xx < margin) | (xx >= w - margin)
    strips = torch.cat([
        blurred[:, :margin, :].reshape(n, -1),
        blurred[:, h - margin:, :].reshape(n, -1),
        blurred[:, margin:h - margin, :margin].reshape(n, -1),
        blurred[:, margin:h - margin, w - margin:].reshape(n, -1),
    ], dim=1)
    bg = _median(strips)
    interior = ~ring
    inf = torch.full_like(blurred, math.inf)
    mx = torch.where(interior, blurred, -inf).reshape(n, -1).max(dim=1).values
    mn = torch.where(interior, blurred, inf).reshape(n, -1).min(dim=1).values
    contrast = torch.where(dark, bg - mn, mx - bg)
    thresh = torch.where(dark, bg - 0.35 * contrast, bg + 0.35 * contrast)
    has_contrast = contrast > 0.06
    seeds = torch.where(_bcast(dark), blurred < _bcast(thresh), blurred > _bcast(thresh))
    seeds = seeds & interior & _bcast(has_contrast)
    n_seeds = _sum(seeds.to(torch.int32))
    seed_mean = _sum(torch.where(seeds, roi, torch.zeros_like(roi))) / torch.clamp(n_seeds, min=1)
    grow_ok = torch.abs(roi - _bcast(seed_mean)) < _bcast(2.0 * _std(roi))
    return seeds, grow_ok, n_seeds


def _region_confidence(mask: torch.Tensor, n_seeds: torch.Tensor) -> torch.Tensor:
    ratio = mask.to(torch.float32).reshape(mask.shape[0], -1).mean(dim=1)
    seed_score = torch.clamp(n_seeds.to(torch.float32) / 5.0, max=1.0)
    coverage_score = torch.clamp(ratio * 5.0, max=1.0)
    conf = 0.6 * seed_score + 0.4 * coverage_score
    return torch.where(n_seeds > 0, conf, torch.zeros_like(conf))


def mask_stats(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(area_px, perimeter_px) of [N,R,R] masks on the ROI grid; the
    perimeter counts mask pixels not in the mask's cross erosion."""
    area = _sum(mask.to(torch.float32))
    boundary = mask & ~imops.binary_erode(mask, 1)
    return area, _sum(boundary.to(torch.float32))


def segment_rois(rois: torch.Tensor, class_ids: torch.Tensor, valid: torch.Tensor,
                 scale_x: torch.Tensor, scale_y: torch.Tensor,
                 block_size: int = 13) -> SegmentationOutputs:
    """Segment grayscale ROIs [N,R,R]. class_ids [N] select method and bias;
    scale_{x,y} [N] (box size / R) convert ROI-grid counts to source-image
    units. Invalid slots give empty masks and zero confidence."""
    n_cls = len(CLASS_TO_METHOD)
    cid = torch.clamp(class_ids.long(), 0, n_cls - 1)
    method = table_lookup(CLASS_TO_METHOD, cid)
    dark = table_lookup(CLASS_IS_DARK, cid)
    adjust = table_lookup(CLASS_THRESH_ADJUST, cid)
    rois = rois.to(torch.float32)

    blurred = imops.gaussian_blur(rois, sigma=1.0)
    m_t_raw = _threshold_pre(rois, adjust, dark, blurred)
    seeds, grow_ok, n_seeds = _region_pre(rois, dark, blurred)
    m_t, m_r, full = morph_tails_batch(m_t_raw, seeds, grow_ok, GROW_ITERATIONS)
    m_r = m_r & _bcast(n_seeds > 0)

    c_t = _separation_confidence(rois, m_t)
    m_a, c_a = _adaptive_segment(rois, dark, block_size)
    m_w, c_w = _watershed_segment(rois, dark, blurred, full)
    c_r = _region_confidence(m_r, n_seeds)
    rows = torch.arange(rois.shape[0], device=rois.device)
    masks = torch.stack([m_t, m_a, m_w, m_r], dim=1)[rows, method.long()] & _bcast(valid)
    confs = torch.stack([c_t, c_a, c_w, c_r], dim=1)[rows, method.long()]
    confs = torch.where(valid, confs, torch.zeros_like(confs))

    area_px, perim_px = mask_stats(masks)
    area = area_px * scale_x * scale_y
    perimeter = perim_px * 0.5 * (scale_x + scale_y)
    compactness = torch.where(
        (area_px > 0) & (perim_px > 0),
        torch.clamp(4.0 * math.pi * area / torch.clamp(perimeter ** 2, min=1e-6), max=1.0),
        torch.zeros_like(area),
    )
    return SegmentationOutputs(masks=masks, area=area, perimeter=perimeter,
                               compactness=compactness, confidence=confs,
                               method=method.to(torch.int32))


def segment_detections(images: torch.Tensor, boxes: torch.Tensor, class_ids: torch.Tensor,
                       valid: torch.Tensor, roi_size: int = 128) -> SegmentationOutputs:
    """Segment the boxes of one image or of a batch in one ROI batch.

    images [H,W,3] or [H,W] (or [B,...] of them), float in [0,1]; boxes
    [N,4] (or [B,N,4]) xyxy pixels; class_ids, valid [N] (or [B,N]). Gray
    conversion, bilinear ROI gather to roi_size^2, then ``segment_rois`` over
    all B*N ROIs at once; outputs come back as [N,...] (or [B,N,...])."""
    single = boxes.dim() == 2
    if single:
        images, boxes, class_ids, valid = images[None], boxes[None], class_ids[None], valid[None]
    gray = imops.rgb_to_gray(images) if images.dim() == 4 else images
    b, n = boxes.shape[:2]
    rois = imops.crop_and_resize(gray[..., None], boxes, (roi_size, roi_size))[..., 0]
    flat = boxes.reshape(b * n, 4).to(torch.float32)
    bw = torch.clamp(flat[:, 2] - flat[:, 0], min=1.0)
    bh = torch.clamp(flat[:, 3] - flat[:, 1], min=1.0)
    out = segment_rois(rois.reshape(b * n, roi_size, roi_size), class_ids.reshape(b * n),
                       valid.reshape(b * n), bw / roi_size, bh / roi_size)
    lead = (n,) if single else (b, n)
    return SegmentationOutputs(*(t.reshape(*lead, *t.shape[1:]) for t in out))
