"""Detection datasets and the host loader (numpy only; no external data).

- ``SyntheticDefectDataset``: procedural defect images with exact labels,
  the corpus of ``train_yolo --synthetic`` and of int8 calibration. Defect
  renderers per class: crack = dark polyline, scratch = thin dark line,
  dent = dark ellipse, discoloration = colour patch, contamination = bright
  blob. Image ``i`` of a dataset with seed ``s`` is a function of ``s`` and
  ``i`` alone: the same bytes as the JAX package's.
- ``YoloDataset``: images/<split>/*.jpg|png with labels/<split>/*.txt
  lines ``class cx cy w h`` (normalized), padded to ``max_boxes``. Images
  decode with ``runtime/codec.py`` (JPEG, 8-bit PNG) and resize with the
  Pillow-exact bicubic of ``data/resize.py``.
- ``mosaic4`` and ``mixup``: the host collage (Pillow-exact bilinear) and
  blend; ``DetectionLoader``: batches with a producer thread.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from iqc_tpu_torch.data.resize import resize_bicubic, resize_bilinear

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


class YoloDataset:
    """Images + YOLO txt labels; samples padded to ``max_boxes``."""

    def __init__(self, images_dir: str, labels_dir: Optional[str] = None,
                 image_size: int = 640, max_boxes: int = 64):
        self.images_dir = images_dir
        self.labels_dir = labels_dir or images_dir.replace("images", "labels")
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.files = [f for f in sorted(os.listdir(images_dir))
                      if f.lower().endswith(IMAGE_EXTENSIONS)]

    def __len__(self) -> int:
        return len(self.files)

    def _label_path(self, image_file: str) -> str:
        stem = os.path.splitext(image_file)[0]
        return os.path.join(self.labels_dir, stem + ".txt")

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """-> image [S,S,3] uint8, boxes [max,4] xyxy pixels, classes [max],
        valid [max]. An image that does not decode raises ValueError."""
        from iqc_tpu_torch.runtime.codec import decode_image

        s = self.image_size
        path = os.path.join(self.images_dir, self.files[index])
        with open(path, "rb") as f:
            decoded = decode_image(f.read())
        if decoded is None:
            raise ValueError(f"{path}: could not decode (JPEG and 8-bit PNG are read)")
        image = resize_bicubic(decoded, (s, s))

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        classes = np.zeros((self.max_boxes,), np.int32)
        valid = np.zeros((self.max_boxes,), bool)
        lp = self._label_path(self.files[index])
        if os.path.exists(lp):
            rows = []
            with open(lp) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 5:
                        rows.append([float(v) for v in parts[:5]])
            for i, (cls, cx, cy, w, h) in enumerate(rows[:self.max_boxes]):
                boxes[i] = [(cx - w / 2) * s, (cy - h / 2) * s,
                            (cx + w / 2) * s, (cy + h / 2) * s]
                classes[i] = int(cls)
                valid[i] = True
        return image, boxes, classes, valid


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


def mosaic4(samples, out_size: int, max_boxes: int, rng: np.random.Generator):
    """4-image mosaic collage on a grey (114) canvas; each source resized
    into its quadrant with the bilinear filter."""
    cx = int(rng.uniform(0.3, 0.7) * out_size)
    cy = int(rng.uniform(0.3, 0.7) * out_size)
    canvas = np.full((out_size, out_size, 3), 114, np.uint8)
    all_boxes, all_classes = [], []
    quads = [(0, 0, cx, cy), (cx, 0, out_size, cy),
             (0, cy, cx, out_size), (cx, cy, out_size, out_size)]
    for (qx1, qy1, qx2, qy2), (img, boxes, classes, valid) in zip(quads, samples):
        qw, qh = qx2 - qx1, qy2 - qy1
        if qw <= 0 or qh <= 0:
            continue
        ih, iw = img.shape[:2]
        sx, sy = qw / iw, qh / ih
        canvas[qy1:qy2, qx1:qx2] = resize_bilinear(img, (qw, qh))
        for b, c, v in zip(boxes, classes, valid):
            if not v:
                continue
            all_boxes.append([b[0] * sx + qx1, b[1] * sy + qy1,
                              b[2] * sx + qx1, b[3] * sy + qy1])
            all_classes.append(c)

    boxes = np.zeros((max_boxes, 4), np.float32)
    classes = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)
    for i, (b, c) in enumerate(zip(all_boxes[:max_boxes], all_classes[:max_boxes])):
        boxes[i], classes[i], valid[i] = b, c, True
    return canvas, boxes, classes, valid


def mixup(sample_a, sample_b, rng: np.random.Generator, alpha: float = 32.0):
    """Image-level mixup; both label sets kept (its own first)."""
    lam = float(rng.beta(alpha, alpha))
    img = (sample_a[0].astype(np.float32) * lam
           + sample_b[0].astype(np.float32) * (1 - lam)).astype(np.uint8)
    max_boxes = sample_a[1].shape[0]
    boxes = np.concatenate([sample_a[1], sample_b[1]])[:max_boxes]
    classes = np.concatenate([sample_a[2], sample_b[2]])[:max_boxes]
    valid = np.concatenate([sample_a[3], sample_b[3]])[:max_boxes]
    return img, boxes, classes, valid


class DetectionLoader:
    """Batches of a dataset with host mosaic/mixup probabilities. Without
    augmentation each epoch enumerates the dataset once (shuffled unless
    ``shuffle`` is False), the tail wrapped to a full batch."""

    def __init__(self, dataset, batch_size: int, mosaic_prob: float = 1.0,
                 mixup_prob: float = 0.0, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return max(len(self.ds) // self.batch_size, 1)

    def _sample(self, index: int, idx_pool: np.ndarray,
                rng: Optional[np.random.Generator] = None):
        """One sample anchored at dataset ``index``; mosaic/mixup companions
        come from ``idx_pool``."""
        rng = self._rng if rng is None else rng
        if self.mosaic_prob > 0 and rng.uniform() < self.mosaic_prob:
            picks = [index] + [int(i) for i in rng.choice(idx_pool, 3)]
            sample = mosaic4([self.ds.load(int(i)) for i in picks],
                             self.ds.image_size, self.ds.max_boxes, rng)
        else:
            sample = self.ds.load(int(index))
        if self.mixup_prob > 0 and rng.uniform() < self.mixup_prob:
            other = self.ds.load(int(rng.choice(idx_pool)))
            sample = mixup(sample, other, rng)
        return sample

    def _make_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            anchors = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(anchors) < self.batch_size:  # wrap the tail (fixed capacity)
                anchors = np.concatenate([anchors, idx[:self.batch_size - len(anchors)]])
            samples = [self._sample(int(a), idx) for a in anchors]
            imgs, boxes, classes, valid = zip(*samples)
            yield {"images": np.stack(imgs), "boxes": np.stack(boxes),
                   "classes": np.stack(classes), "valid": np.stack(valid)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """A producer thread builds the batches ahead (``prefetch`` deep),
        so host work overlaps the device's; its exception re-raises here."""
        if self.prefetch <= 0:
            yield from self._make_batches()
            return
        import queue as _q
        import threading

        q: _q.Queue = _q.Queue(self.prefetch)
        end = object()
        errors = []

        def producer():
            try:
                for batch in self._make_batches():
                    q.put(batch)
            except BaseException as e:  # handed to the consumer, which re-raises it
                errors.append(e)
            finally:
                q.put(end)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        if errors:
            raise errors[0]
