"""Host input pipeline of the classifier trainer: an image-folder dataset,
balanced sampling, a batched loader with a background producer, and the
upload of batches to the device ahead of their use.

Images decode without PIL (``runtime/codec.py``: PNG, BMP, and JPEG where
the native libjpeg decoder builds) and resize with Pillow's bicubic filter
(``data/resize.py``), so that a file loads to the same bytes as through
``Image.open(path).convert("RGB").resize(size)``.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iqc_tpu_torch.data.resize import resize_bicubic
from iqc_tpu_torch.runtime.codec import read_image

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def load_resized(path: str, image_size: Tuple[int, int], mode: str = "RGB") -> np.ndarray:
    """The image at ``path`` converted to ``mode`` and resized to
    ``image_size`` = (height, width) with Pillow's bicubic filter."""
    return resize_bicubic(read_image(path, mode), (image_size[1], image_size[0]))


class ImageFolderDataset:
    """Directory-per-class image dataset (root/<class_name>/<image>).
    ``class_names`` orders the classes it names first, the rest after in
    sorted order."""

    def __init__(self, root: str, image_size: Tuple[int, int] = (224, 224),
                 class_names: Optional[Sequence[str]] = None):
        self.root = root
        self.image_size = tuple(image_size)
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if class_names is not None:
            classes = ([c for c in class_names if c in classes]
                       + [c for c in classes if c not in class_names])
        self.class_names = classes
        self.samples: List[Tuple[str, int]] = []
        for idx, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMAGE_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), idx))
        self.labels = np.asarray([lbl for _, lbl in self.samples], dtype=np.int32)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[index]
        return load_resized(path, self.image_size), label

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=len(self.class_names))


class ArrayDataset:
    """In-memory dataset of images [N,H,W,3] and labels [N]."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 class_names: Optional[Sequence[str]] = None):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = images
        self.labels = np.asarray(labels, dtype=np.int32)
        self.class_names = list(class_names or [str(i) for i in range(int(labels.max()) + 1)])

    def __len__(self) -> int:
        return len(self.images)

    def load(self, index: int) -> Tuple[np.ndarray, int]:
        return self.images[index], int(self.labels[index])

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=len(self.class_names))


def balanced_sample_indices(labels: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` indices drawn with replacement, each sample weighted by the
    inverse of its class's frequency (every class equally likely)."""
    counts = np.bincount(labels)
    weights = 1.0 / np.maximum(counts[labels], 1)
    probs = weights / weights.sum()
    return rng.choice(len(labels), size=n, replace=True, p=probs)


class DataLoader:
    """Batches {"images": uint8 [B,H,W,3], "labels": int32 [B]} of a
    dataset, shuffled or balanced from ``default_rng(seed)``, produced on a
    background thread ``prefetch`` batches ahead (0: in the caller's)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, balanced: bool = False,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.balanced = balanced
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.balanced:
            return balanced_sample_indices(self.dataset.labels, n, self._rng)
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _make_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(sel) == 0:
                break
            images, labels = zip(*(self.dataset.load(i) for i in sel))
            yield {"images": np.stack(images), "labels": np.asarray(labels, dtype=np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._make_batches()
            return
        q: queue.Queue = queue.Queue(self.prefetch)
        end = object()
        errors: List[BaseException] = []

        def producer():
            try:
                for batch in self._make_batches():
                    q.put(batch)
            except BaseException as e:  # raised in the consumer
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


def _upload(x, device: torch.device):
    t = torch.as_tensor(np.ascontiguousarray(x)) if not isinstance(x, torch.Tensor) else x
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator: Iterator, device="cuda", size: int = 2, leaves=None):
    """The batches of ``iterator`` (dicts of arrays) with their arrays on
    ``device``, ``size`` batches uploaded ahead of the one yielded. On a
    card each upload is a non-blocking copy from pinned memory, so it
    overlaps the work queued before it. ``leaves``: upload only these keys
    (the rest pass through). ``device`` may be a data-parallel mesh
    (``parallel.mesh.MeshSpec``), as the JAX version takes a sharding: each
    array is then cut to this rank's rows (``shard_batch``, a ragged batch
    padded with zero rows) and only those go to the mesh's device."""
    from iqc_tpu_torch.parallel.mesh import MeshSpec, shard_batch

    mesh = device if isinstance(device, MeshSpec) else None
    device = mesh.device if mesh is not None else torch.device(device)
    buf: collections.deque = collections.deque()

    def put(batch):
        keys = batch.keys() if leaves is None else leaves
        if mesh is not None:
            return {k: (shard_batch(mesh, v) if k in keys else v) for k, v in batch.items()}
        return {k: (_upload(v, device) if k in keys else v) for k, v in batch.items()}

    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        yield buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
