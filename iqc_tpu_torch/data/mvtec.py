"""MVTec-AD-format dataset importer (the JAX package's ``data/mvtec.py``,
reading images through ``runtime/codec.py``).

Real industrial defect datasets (MVTec AD and its layout-compatible
derivatives) ship as::

    <category>/
      train/good/*.png
      test/good/*.png
      test/<defect_type>/*.png
      ground_truth/<defect_type>/<stem>_mask.png

This importer derives both task formats:

- ``MVTecClassificationDataset``: defect-type folders -> class labels
  (ImageFolder-equivalent for the ResNet trainer).
- ``MVTecDetectionDataset``: bounding boxes extracted from the ground-truth
  masks via connected components -> YoloDataset-compatible samples for the
  native YOLO trainer.

Images resize with Pillow's bicubic filter (``data/resize.py``), so every
sample has the bytes that Pillow's ``convert``, ``crop`` and ``resize``
give.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from iqc_tpu_torch.data.pipeline import IMAGE_EXTENSIONS, load_resized
from iqc_tpu_torch.data.resize import resize_bicubic
from iqc_tpu_torch.runtime.codec import read_image


def _list_images(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return [
        os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if f.lower().endswith(IMAGE_EXTENSIONS)
    ]


def mask_to_boxes(mask: np.ndarray, min_area: int = 16) -> List[Tuple[int, int, int, int]]:
    """Ground-truth mask -> xyxy boxes, one per connected defect region."""
    from scipy import ndimage as ndi

    labels, count = ndi.label(np.asarray(mask) > 0)
    boxes = []
    for sl in ndi.find_objects(labels):
        if sl is None:
            continue
        y, x = sl
        if (y.stop - y.start) * (x.stop - x.start) < min_area:
            continue
        boxes.append((x.start, y.start, x.stop, y.stop))
    return boxes


class MVTecDetectionDataset:
    """test/<defect_type> images + ground_truth masks -> detection samples.

    YoloDataset-compatible: ``load(i) -> (image uint8 [S,S,3],
    boxes [max,4] xyxy px, classes [max], valid [max])``.
    """

    def __init__(
        self,
        category_dir: str,
        image_size: int = 640,
        max_boxes: int = 16,
        include_good: bool = True,
        class_names: Optional[Sequence[str]] = None,
    ):
        self.category_dir = category_dir
        self.image_size = image_size
        self.max_boxes = max_boxes
        test_dir = os.path.join(category_dir, "test")
        gt_dir = os.path.join(category_dir, "ground_truth")
        if not os.path.isdir(test_dir):
            raise FileNotFoundError(f"no test/ split under {category_dir}")

        defect_types = sorted(
            d for d in os.listdir(test_dir)
            if os.path.isdir(os.path.join(test_dir, d)) and d != "good"
        )
        self.class_names = list(class_names or defect_types)
        self.samples: List[Tuple[str, Optional[str], int]] = []
        for dt in defect_types:
            cls = self.class_names.index(dt) if dt in self.class_names else 0
            for img_path in _list_images(os.path.join(test_dir, dt)):
                stem = os.path.splitext(os.path.basename(img_path))[0]
                mask_path = os.path.join(gt_dir, dt, f"{stem}_mask.png")
                self.samples.append(
                    (img_path, mask_path if os.path.exists(mask_path) else None, cls)
                )
        if include_good:
            for img_path in _list_images(os.path.join(test_dir, "good")):
                self.samples.append((img_path, None, -1))

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int):
        img_path, mask_path, cls = self.samples[index]
        s = self.image_size
        rgb = read_image(img_path)
        orig_h, orig_w = rgb.shape[:2]
        image = resize_bicubic(rgb, (s, s))

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        classes = np.zeros((self.max_boxes,), np.int32)
        valid = np.zeros((self.max_boxes,), bool)
        if mask_path is not None:
            mask = read_image(mask_path, "L")
            sx, sy = s / orig_w, s / orig_h
            for i, (x1, y1, x2, y2) in enumerate(mask_to_boxes(mask)[: self.max_boxes]):
                boxes[i] = (x1 * sx, y1 * sy, x2 * sx, y2 * sy)
                classes[i] = max(cls, 0)
                valid[i] = True
        return image, boxes, classes, valid


class SubsetDataset:
    """Index-subset view over any load()/len dataset (MVTec puts every
    defect image under test/, so supervised training splits that pool into
    train/val deterministically)."""

    def __init__(self, ds, indices: Sequence[int]):
        self.ds = ds
        self.indices = list(int(i) for i in indices)
        for attr in ("image_size", "max_boxes", "class_names"):
            if hasattr(ds, attr):
                setattr(self, attr, getattr(ds, attr))
        if hasattr(ds, "labels"):
            self.labels = np.asarray(ds.labels)[self.indices]

    def __len__(self) -> int:
        return len(self.indices)

    def load(self, index: int):
        return self.ds.load(self.indices[index])

    def class_counts(self) -> np.ndarray:
        if not hasattr(self, "labels"):
            raise AttributeError("underlying dataset has no labels")
        n = len(getattr(self.ds, "class_names", [])) or int(self.labels.max()) + 1
        return np.bincount(self.labels, minlength=n)


class ConcatDataset:
    """Concatenation of load()/len datasets with the same sample schema —
    lets a training split grow with extra rendered corpora while the
    held-out val split stays byte-identical (train_mvtec.py EXTRA_N)."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        first = self.datasets[0]
        for attr in ("image_size", "max_boxes", "class_names"):
            if hasattr(first, attr):
                setattr(self, attr, getattr(first, attr))
        if all(hasattr(d, "labels") for d in self.datasets):
            self.labels = np.concatenate(
                [np.asarray(d.labels) for d in self.datasets])
        if all(hasattr(d, "groups") for d in self.datasets):
            self.groups = [g for d in self.datasets for g in d.groups]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def load(self, index: int):
        k = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[k].load(index - int(self._offsets[k]))

    def class_counts(self) -> np.ndarray:
        if not hasattr(self, "labels"):
            raise AttributeError("underlying datasets have no labels")
        n = len(getattr(self, "class_names", [])) or int(self.labels.max()) + 1
        return np.bincount(self.labels, minlength=n)


def split_indices(n: int, val_fraction: float = 0.25, seed: int = 0
                  ) -> Tuple[List[int], List[int]]:
    """Deterministic shuffled train/val index split."""
    idx = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(round(n * val_fraction)))
    return sorted(idx[n_val:].tolist()), sorted(idx[:n_val].tolist())


def split_indices_grouped(groups: Sequence, val_fraction: float = 0.25,
                          seed: int = 0) -> Tuple[List[int], List[int]]:
    """Train/val split along GROUP boundaries (e.g. source image path):
    all samples of a group land on the same side. Per-sample splitting of
    per-region crop datasets leaks near-duplicate crops of one source
    image into both splits and inflates val accuracy."""
    uniq = sorted(set(groups))
    perm = np.random.default_rng(seed).permutation(len(uniq))
    n_val = max(1, int(round(len(uniq) * val_fraction)))
    val_groups = {uniq[i] for i in perm[:n_val]}
    train_idx = [i for i, g in enumerate(groups) if g not in val_groups]
    val_idx = [i for i, g in enumerate(groups) if g in val_groups]
    return train_idx, val_idx


class MVTecClassificationDataset:
    """test/ defect-type folders as class labels (ImageFolder-equivalent;
    plugs into the ResNet trainer's DataLoader).

    good_label: include test/good as its own class when not None.
    """

    def __init__(
        self,
        category_dir: str,
        image_size: Tuple[int, int] = (224, 224),
        good_label: Optional[str] = "good",
    ):
        test_dir = os.path.join(category_dir, "test")
        if not os.path.isdir(test_dir):
            raise FileNotFoundError(f"no test/ split under {category_dir}")
        self.image_size = tuple(image_size)
        dirs = sorted(
            d for d in os.listdir(test_dir) if os.path.isdir(os.path.join(test_dir, d))
        )
        if good_label is None:
            dirs = [d for d in dirs if d != "good"]
        self.class_names = dirs
        self.samples: List[Tuple[str, int]] = []
        for idx, d in enumerate(dirs):
            for p in _list_images(os.path.join(test_dir, d)):
                self.samples.append((p, idx))
        self.labels = np.asarray([l for _, l in self.samples], dtype=np.int32)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int):
        path, label = self.samples[index]
        return load_resized(path, self.image_size), label

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=len(self.class_names))


class MVTecCropClassificationDataset:
    """Defect-region crops (from ground-truth mask boxes) as classification
    samples — the distribution the serving ensemble actually feeds the
    per-crop ResNet (models/ensemble.py crop path), unlike whole resized
    images where a small defect vanishes at 224px.

    One sample per connected defect region: the mask bbox is padded by
    ``margin`` (fraction of the larger side, floor ``min_crop`` px) and
    resized to ``image_size``. Labels come from the defect-type folder.
    """

    def __init__(
        self,
        category_dir: str,
        image_size: Tuple[int, int] = (224, 224),
        margin: float = 0.35,
        min_crop: int = 64,
        class_names: Optional[Sequence[str]] = None,
    ):
        test_dir = os.path.join(category_dir, "test")
        gt_dir = os.path.join(category_dir, "ground_truth")
        if not os.path.isdir(test_dir):
            raise FileNotFoundError(f"no test/ split under {category_dir}")
        self.image_size = tuple(image_size)
        self.margin = margin
        self.min_crop = min_crop
        defect_types = sorted(
            d for d in os.listdir(test_dir)
            if os.path.isdir(os.path.join(test_dir, d)) and d != "good"
        )
        self.class_names = list(class_names or defect_types)
        unknown = [d for d in defect_types if d not in self.class_names]
        if unknown:
            # silently mapping unknown folders to label 0 would train on
            # 100% mislabeled data for those types
            raise ValueError(
                f"defect folders {unknown} not in class_names "
                f"{self.class_names}; pass class_names=None to derive "
                "labels from the folder names"
            )
        # samples: (img_path, xyxy box in original px, label)
        self.samples: List[Tuple[str, Tuple[int, int, int, int], int]] = []
        for dt in defect_types:
            label = self.class_names.index(dt)
            for img_path in _list_images(os.path.join(test_dir, dt)):
                stem = os.path.splitext(os.path.basename(img_path))[0]
                mask_path = os.path.join(gt_dir, dt, f"{stem}_mask.png")
                if not os.path.exists(mask_path):
                    continue
                mask = read_image(mask_path, "L")
                for box in mask_to_boxes(mask):
                    self.samples.append((img_path, box, label))
        self.labels = np.asarray([l for _, _, l in self.samples], np.int32)
        # group key per sample (source image) for leakage-free splitting
        self.groups = [p for p, _, _ in self.samples]

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int):
        path, (x1, y1, x2, y2), label = self.samples[index]
        im = read_image(path)
        h, w = im.shape[:2]
        pad = max(int(self.margin * max(x2 - x1, y2 - y1)),
                  (self.min_crop - min(x2 - x1, y2 - y1)) // 2, 0)
        cx1, cy1 = max(0, x1 - pad), max(0, y1 - pad)
        cx2, cy2 = min(w, x2 + pad), min(h, y2 + pad)
        crop = resize_bicubic(im[cy1:cy2, cx1:cx2], (self.image_size[1], self.image_size[0]))
        return crop, int(label)

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=len(self.class_names))
