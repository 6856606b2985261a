"""Procedural defect images with exact labels, the renderer that int8
calibration draws its frames and crops from (numpy only; no external data).

Defect renderers per class: crack = dark polyline, scratch = thin dark line,
dent = dark ellipse, discoloration = colour patch, contamination = bright
blob. Image ``i`` of a dataset with seed ``s`` is a function of ``s`` and
``i`` alone: the same bytes as the JAX package's ``SyntheticDefectDataset``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticDefectDataset:
    def __init__(self, n: int = 64, image_size: int = 320, max_boxes: int = 8,
                 num_classes: int = 5, seed: int = 0, cache: bool = True,
                 min_defects: int = 0, max_defects: int = 3):
        self.n = n
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.num_classes = num_classes
        self.seed = seed
        self.min_defects = min_defects
        self.max_defects = max_defects
        self._cache: Dict[int, tuple] = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def load(self, index: int):
        """-> image [S,S,3] uint8, boxes [max_boxes,4] xyxy pixels,
        classes [max_boxes] int32, valid [max_boxes] bool."""
        if self._cache is not None:
            hit = self._cache.get(index)
            if hit is None:
                hit = self._render(index)
                self._cache[index] = hit
            return hit
        return self._render(index)

    def _render(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        s = self.image_size
        base = rng.integers(120, 170)
        img = np.full((s, s, 3), base, np.float32)
        img += rng.normal(0, 6, (s, s, 3))

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        classes = np.zeros((self.max_boxes,), np.int32)
        valid = np.zeros((self.max_boxes,), bool)
        n_def = min(int(rng.integers(self.min_defects, self.max_defects + 1)),
                    self.max_boxes)
        yy, xx = np.mgrid[:s, :s]
        for i in range(n_def):
            cls = int(rng.integers(0, self.num_classes))
            cx, cy = rng.integers(s // 8, s - s // 8, 2)
            if cls == 0:  # crack: jagged dark polyline
                length = int(rng.integers(s // 8, s // 3))
                x, y = cx, cy
                xs, ys = [x], [y]
                for _ in range(length // 4):
                    x = np.clip(x + rng.integers(-6, 7), 0, s - 1)
                    y = np.clip(y + rng.integers(2, 6), 0, s - 1)
                    xs.append(x), ys.append(y)
                for px, py in zip(xs, ys):
                    img[max(py - 1, 0):py + 2, max(px - 1, 0):px + 2] *= 0.3
                x1, y1, x2, y2 = min(xs), min(ys), max(xs) + 2, max(ys) + 2
            elif cls == 1:  # scratch: straight thin line
                length = int(rng.integers(s // 6, s // 2))
                ang = rng.uniform(0, np.pi)
                dx, dy = np.cos(ang), np.sin(ang)
                pts = [(int(cx + t * dx), int(cy + t * dy))
                       for t in range(-length // 2, length // 2)]
                pts = [(x, y) for x, y in pts if 0 <= x < s and 0 <= y < s]
                if not pts:
                    continue
                for px, py in pts:
                    img[py, px] *= 0.35
                xs_, ys_ = zip(*pts)
                x1, y1, x2, y2 = min(xs_), min(ys_), max(xs_) + 1, max(ys_) + 1
            elif cls == 2:  # dent: dark ellipse
                rx, ry = rng.integers(s // 20, s // 8, 2)
                sel = ((xx - cx) / max(rx, 1)) ** 2 + ((yy - cy) / max(ry, 1)) ** 2 <= 1
                img[sel] *= 0.55
                x1, y1, x2, y2 = cx - rx, cy - ry, cx + rx, cy + ry
            elif cls == 3:  # discoloration: tinted patch
                rx, ry = rng.integers(s // 12, s // 6, 2)
                sel = ((xx - cx) / max(rx, 1)) ** 2 + ((yy - cy) / max(ry, 1)) ** 2 <= 1
                tint = rng.uniform(0.6, 1.4, 3)
                img[sel] = np.clip(img[sel] * tint, 0, 255)
                x1, y1, x2, y2 = cx - rx, cy - ry, cx + rx, cy + ry
            else:  # contamination: bright blob
                r = int(rng.integers(s // 24, s // 10))
                sel = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
                img[sel] = np.clip(img[sel] + rng.integers(60, 90), 0, 255)
                x1, y1, x2, y2 = cx - r, cy - r, cx + r, cy + r
            x1, y1 = max(0, int(x1)), max(0, int(y1))
            x2, y2 = min(s, int(x2)), min(s, int(y2))
            if x2 - x1 < 3 or y2 - y1 < 3:
                continue
            boxes[i] = [x1, y1, x2, y2]
            classes[i] = cls
            valid[i] = True
        return np.clip(img, 0, 255).astype(np.uint8), boxes, classes, valid
