"""Detection evaluation: precision/recall/mAP@0.5 and mAP@0.5:0.95.

A copy of the JAX package's ``train/detection_metrics.py`` (numpy only):
greedy per-image matching at each IoU threshold, 101-point interpolated
AP (COCO convention), macro-averaged over classes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)


def _iou_1_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a1 + a2 - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def match_predictions(
    pred_boxes: np.ndarray, pred_scores: np.ndarray,
    gt_boxes: np.ndarray, iou_thresh: float,
) -> Tuple[np.ndarray, int]:
    """Greedy score-ordered matching -> (tp flags per pred, n_gt)."""
    order = np.argsort(-pred_scores, kind="stable")
    tp = np.zeros(len(pred_boxes), bool)
    used = np.zeros(len(gt_boxes), bool)
    for i in order:
        if len(gt_boxes) == 0:
            break
        ious = _iou_1_to_many(pred_boxes[i], gt_boxes)
        ious[used] = -1.0
        j = int(np.argmax(ious))
        if ious[j] >= iou_thresh:
            tp[i] = True
            used[j] = True
    return tp, len(gt_boxes)


def average_precision(tp: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from global score-sorted TP flags."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    points = np.linspace(0, 1, 101)
    interp = np.zeros_like(points)
    ri = 0
    for k, r in enumerate(points):
        while ri < len(recall) and recall[ri] < r:
            ri += 1
        interp[k] = precision[ri] if ri < len(recall) else 0.0
    return float(interp.mean())


def evaluate_detections(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> Dict:
    """predictions[i]/ground_truths[i] per image:
    {"boxes": [N,4], "scores": [N] (preds only), "classes": [N]}.
    Returns mAP50, mAP50-95, macro precision/recall at IoU 0.5.
    """
    ap_per_class_thresh = np.full((num_classes, len(iou_thresholds)), np.nan)
    prec50, rec50 = [], []
    for c in range(num_classes):
        all_scores: List[np.ndarray] = []
        tp_by_thresh: List[List[np.ndarray]] = [[] for _ in iou_thresholds]
        n_gt_total = 0
        for pred, gt in zip(predictions, ground_truths):
            pm = np.asarray(pred["classes"]) == c
            gm = np.asarray(gt["classes"]) == c
            pb = np.asarray(pred["boxes"], np.float32)[pm]
            ps = np.asarray(pred["scores"], np.float32)[pm]
            gb = np.asarray(gt["boxes"], np.float32)[gm]
            n_gt_total += len(gb)
            all_scores.append(ps)
            for t, thr in enumerate(iou_thresholds):
                tp, _ = match_predictions(pb, ps, gb, thr)
                tp_by_thresh[t].append(tp)
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        for t in range(len(iou_thresholds)):
            tps = np.concatenate(tp_by_thresh[t]) if tp_by_thresh[t] else np.zeros(0, bool)
            ap_per_class_thresh[c, t] = average_precision(tps, scores, n_gt_total)
        # P/R at IoU .5 over all predictions of the class
        tps50 = (
            np.concatenate(tp_by_thresh[0]) if tp_by_thresh[0] else np.zeros(0, bool)
        )
        if len(tps50):
            prec50.append(float(tps50.mean()))
        if n_gt_total:
            rec50.append(float(tps50.sum() / n_gt_total))

    with np.errstate(invalid="ignore"):
        map50 = float(np.nanmean(ap_per_class_thresh[:, 0]))
        map5095 = float(np.nanmean(ap_per_class_thresh))
        per_thresh = np.nanmean(ap_per_class_thresh, axis=0)
    return {
        "mAP50": 0.0 if np.isnan(map50) else map50,
        "mAP50_95": 0.0 if np.isnan(map5095) else map5095,
        "precision": float(np.mean(prec50)) if prec50 else 0.0,
        "recall": float(np.mean(rec50)) if rec50 else 0.0,
        # NaN-guarded like mAP above: bare NaN in json.dumps output is
        # invalid strict JSON for downstream parsers
        "per_class_ap50": np.nan_to_num(ap_per_class_thresh[:, 0]).tolist(),
        # class-averaged AP at each IoU threshold (0.50..0.95) — shows
        # whether a mAP50-95 gap is localization sharpness (high-IoU tail)
        # or detection quality (uniform)
        "per_thresh_ap": [0.0 if np.isnan(x) else float(x)
                          for x in per_thresh],
    }
