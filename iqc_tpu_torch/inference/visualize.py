"""Host-side drawing in numpy: class-coloured detection boxes with a
severity bar, the pass/fail strip, and segmentation masks blended over the
image (the JAX package's ``inference/visualize.py``, pixel for pixel)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

CLASS_COLORS = {
    "crack": (255, 0, 0),
    "scratch": (0, 255, 0),
    "dent": (0, 0, 255),
    "discoloration": (255, 255, 0),
    "contamination": (255, 0, 255),
}
_DEFAULT_COLOR = (128, 128, 128)

PASS_COLORS = {"PASS": (0, 255, 0), "FAIL": (255, 0, 0)}


def _rect(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color, thickness: int = 2):
    h, w = img.shape[:2]
    x1, x2 = max(0, min(x1, w - 1)), max(0, min(x2, w - 1))
    y1, y2 = max(0, min(y1, h - 1)), max(0, min(y2, h - 1))
    for t in range(thickness):
        if y1 + t < h:
            img[y1 + t, x1:x2 + 1] = color
        if y2 - t >= 0:
            img[y2 - t, x1:x2 + 1] = color
        if x1 + t < w:
            img[y1:y2 + 1, x1 + t] = color
        if x2 - t >= 0:
            img[y1:y2 + 1, x2 - t] = color


def draw_detections(image: np.ndarray, detections: List[Dict]) -> np.ndarray:
    """Draw class-colored boxes with a severity-coded top bar."""
    vis = np.array(image, copy=True)
    for det in detections:
        bbox = det["bbox"]
        color = CLASS_COLORS.get(det.get("class", ""), _DEFAULT_COLOR)
        _rect(vis, int(bbox["x1"]), int(bbox["y1"]), int(bbox["x2"]), int(bbox["y2"]), color)
        # filled label bar whose height encodes severity
        sev = det.get("final_severity", det.get("severity", "minor"))
        bar = {"minor": 4, "major": 7, "critical": 10}.get(sev, 4)
        y0 = max(0, int(bbox["y1"]) - bar)
        vis[y0:int(bbox["y1"]), int(bbox["x1"]):int(bbox["x2"])] = color
    return vis


def draw_quality_overlay(image: np.ndarray, quality_assessment: Dict) -> np.ndarray:
    """Append a status strip color-coded by pass/fail
    (ensemble.py:420-448 equivalent)."""
    h, w = image.shape[:2]
    strip = np.full((24, w, 3), 50, dtype=image.dtype)
    status = quality_assessment.get("pass_fail_status", quality_assessment.get("pass_fail", ""))
    color = PASS_COLORS.get(status, (255, 255, 0))
    strip[4:20, 4:20] = color
    grade = quality_assessment.get("quality_grade", "?")
    # grade encoded as number of white ticks (A=1 .. F=6)
    ticks = max(1, min(6, ord(str(grade)[0].upper()) - ord("A") + 1)) if grade else 1
    for i in range(ticks):
        strip[8:16, 28 + i * 10 : 34 + i * 10] = (255, 255, 255)
    return np.concatenate([image, strip], axis=0)


def draw_segmentation(image: np.ndarray, masks: List[np.ndarray], alpha: float = 0.4) -> np.ndarray:
    """Blend segmentation masks over the image
    (segmentation.py:657-729 equivalent, no matplotlib)."""
    vis = image.astype(np.float32).copy()
    palette = list(CLASS_COLORS.values())
    for i, m in enumerate(masks):
        color = np.asarray(palette[i % len(palette)], dtype=np.float32)
        sel = np.asarray(m) > 0
        vis[sel] = (1 - alpha) * vis[sel] + alpha * color
    return vis.astype(image.dtype)
