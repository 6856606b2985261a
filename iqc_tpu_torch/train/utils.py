"""Training utilities (numpy), a copy of the JAX package's
``train/utils.py``: global seeding, EarlyStopping, ReduceLROnPlateau,
MetricsTracker with JSON/CSV export, ROC/AUC, class weights, parameter
counts, a device-latency profiler, the training report, and plots (which
return False, or only the AUCs, where matplotlib is missing).
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def set_global_seed(seed: int = 42) -> torch.Generator:
    """Seed python and numpy; return a CPU ``torch.Generator`` seeded with
    ``seed`` (the trainer draws from explicit generators, never from
    torch's global one)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


class ReduceLROnPlateau:
    """Epoch-level plateau LR controller (``ReduceLROnPlateau(patience,
    factor)`` semantics). Call ``step(metric)`` once per validation; returns
    the (possibly reduced) learning rate."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, min_lr: float = 1e-7, min_delta: float = 1e-8):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.lr = float(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.counter = 0

    def step(self, value: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "max" and value > self.best + self.min_delta)
            or (self.mode == "min" and value < self.best - self.min_delta)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.counter = 0
        return self.lr


class EarlyStopping:
    """Patience-based early stopping (utils.py:47-85)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def step(self, value: float) -> bool:
        """Record a metric; returns True when training should stop."""
        improved = (
            self.best is None
            or (self.mode == "max" and value > self.best + self.min_delta)
            or (self.mode == "min" and value < self.best - self.min_delta)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop


class MetricsTracker:
    """Per-epoch metric history + JSON export (utils.py:87-176).
    Plotting is delegated to matplotlib only if available."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    def best(self, metric: str, mode: str = "max") -> Optional[float]:
        values = self.history.get(metric)
        if not values:
            return None
        return max(values) if mode == "max" else min(values)

    def export_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.history, f, indent=2)

    def export_csv(self, path: str) -> None:
        """Per-epoch scalar rows — the TensorBoard-scalar equivalent
        (reference logs loss/acc/P/R/F1/LR per epoch,
        train_resnet.py:457-465)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        keys = sorted(self.history)
        n = max((len(v) for v in self.history.values()), default=0)
        with open(path, "w") as f:
            f.write("epoch," + ",".join(keys) + "\n")
            for i in range(n):
                row = [
                    f"{self.history[k][i]:.6g}" if i < len(self.history[k]) else ""
                    for k in keys
                ]
                f.write(f"{i}," + ",".join(row) + "\n")

    def plot(self, path: str) -> bool:  # pragma: no cover - needs matplotlib
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return False
        keys = [k for k in ("loss", "val_loss", "accuracy", "val_accuracy") if k in self.history]
        if not keys:
            keys = list(self.history)[:4]
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        for ax, key in zip(axes.flat, keys):
            ax.plot(self.history[key])
            ax.set_title(key)
        for ax in axes.flat[len(keys):]:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return True


# --- evaluation curves & plots (reference train/utils.py:282-354,
# train_resnet.py:559-573) — numpy ROC/AUC instead of sklearn ----------------


def roc_curve(scores: np.ndarray, positives: np.ndarray):
    """One-vs-rest ROC points from raw scores. Returns (fpr, tpr) arrays
    starting at (0,0) — sklearn.metrics.roc_curve equivalent for the
    reference's plot path (utils.py:313-354)."""
    scores = np.asarray(scores, np.float64)
    positives = np.asarray(positives, bool)
    order = np.argsort(-scores, kind="stable")
    tps = np.cumsum(positives[order])
    fps = np.cumsum(~positives[order])
    # collapse threshold ties: keep the last point of each distinct score
    distinct = np.r_[np.diff(scores[order]) != 0, True]
    tps, fps = tps[distinct], fps[distinct]
    tpr = tps / max(tps[-1] if tps.size else 0, 1)
    fpr = fps / max(fps[-1] if fps.size else 0, 1)
    return np.r_[0.0, fpr], np.r_[0.0, tpr]


def auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    """Trapezoidal area under a curve (sklearn.metrics.auc equivalent)."""
    return float(np.trapezoid(tpr, fpr))


def multiclass_roc_auc(labels: np.ndarray, probs: np.ndarray) -> Dict[int, float]:
    """Per-class one-vs-rest AUC; classes absent from labels get nan."""
    out = {}
    labels = np.asarray(labels)
    for c in range(probs.shape[1]):
        pos = labels == c
        if pos.any() and (~pos).any():
            f, t = roc_curve(probs[:, c], pos)
            out[c] = auc(f, t)
        else:
            out[c] = float("nan")
    return out


def _plt():  # pragma: no cover - thin import shim
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_roc_curves(labels: np.ndarray, probs: np.ndarray,
                    class_names: List[str], path: str) -> Dict[int, float]:
    """Multi-class one-vs-rest ROC plot + per-class AUC
    (reference train/utils.py:313-354)."""
    aucs = multiclass_roc_auc(labels, probs)
    try:
        plt = _plt()
    except ImportError:  # pragma: no cover
        return aucs
    fig, ax = plt.subplots(figsize=(8, 6))
    for c, name in enumerate(class_names[: probs.shape[1]]):
        pos = np.asarray(labels) == c
        if pos.any() and (~pos).any():
            f, t = roc_curve(probs[:, c], pos)
            ax.plot(f, t, label=f"{name} (AUC={aucs[c]:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC curves (one-vs-rest)")
    ax.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return aucs


def plot_confusion_matrix(cm: np.ndarray, class_names: List[str], path: str) -> bool:
    """Confusion-matrix heatmap (reference's seaborn heatmap,
    train_resnet.py:559-573)."""
    try:
        plt = _plt()
    except ImportError:  # pragma: no cover
        return False
    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    n = len(class_names)
    ax.set_xticks(range(n), class_names, rotation=45, ha="right")
    ax.set_yticks(range(n), class_names)
    thresh = cm.max() / 2 if cm.size else 0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(int(cm[i, j])), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black", fontsize=8)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion matrix")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def plot_class_distribution(labels: np.ndarray, class_names: List[str], path: str) -> bool:
    """Dataset class-balance bar chart (reference train/utils.py:282-311)."""
    try:
        plt = _plt()
    except ImportError:  # pragma: no cover
        return False
    counts = np.bincount(np.asarray(labels), minlength=len(class_names))
    fig, ax = plt.subplots(figsize=(8, 5))
    bars = ax.bar(class_names, counts[: len(class_names)])
    for bar, count in zip(bars, counts):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(),
                str(int(count)), ha="center", va="bottom", fontsize=8)
    ax.set_title("Class Distribution")
    ax.set_xlabel("Classes")
    ax.set_ylabel("Number of Samples")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def compute_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Inverse-frequency class weights (utils.py:263-280)."""
    counts = np.bincount(np.asarray(labels), minlength=num_classes).astype(np.float64)
    total = counts.sum()
    weights = np.where(counts > 0, total / (num_classes * np.maximum(counts, 1)), 0.0)
    return weights.astype(np.float32)


def _leaves(tree) -> List:
    """The arrays of a module (its parameters), or of a nested dict / list."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def count_parameters(params) -> int:
    return sum(int(np.prod(tuple(p.shape))) for p in _leaves(params))


def model_size_mb(params) -> float:
    """Parameter footprint in MB, at each array's own dtype."""
    total_bytes = 0
    for p in _leaves(params):
        itemsize = p.element_size() if isinstance(p, torch.Tensor) else np.asarray(p).dtype.itemsize
        total_bytes += int(np.prod(tuple(p.shape))) * itemsize
    return total_bytes / (1024 * 1024)


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (CUDA tensors anywhere in it)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in _leaves(out)):
        torch.cuda.synchronize()


def profile_model(fn: Callable, *args, iterations: int = 50, warmup: int = 5) -> Dict:
    """Latency profile of a callable: mean/std/min/max/p95/FPS, each call
    timed up to the end of its device work."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    times_ms = np.asarray(times) * 1000
    return {
        "mean_ms": float(times_ms.mean()),
        "std_ms": float(times_ms.std()),
        "min_ms": float(times_ms.min()),
        "max_ms": float(times_ms.max()),
        "p95_ms": float(np.percentile(times_ms, 95)),
        "fps": float(1000.0 / times_ms.mean()),
        "iterations": iterations,
    }


def training_report(
    history: Dict[str, List[float]],
    targets: Optional[Dict[str, float]] = None,
    path: Optional[str] = None,
) -> Dict:
    """Summary report with target-met booleans (utils.py:356-406)."""
    targets = targets or {"accuracy": 0.942, "precision": 0.913, "recall": 0.89}
    finals = {k: (v[-1] if v else None) for k, v in history.items()}
    bests = {k: (max(v) if v else None) for k, v in history.items()}
    met = {}
    for name, target in targets.items():
        for key in (f"val_{name}", name):
            if history.get(key):
                met[name] = bool(max(history[key]) >= target)
                break
        else:
            met[name] = False
    report = {
        "epochs_trained": max((len(v) for v in history.values()), default=0),
        "final_metrics": finals,
        "best_metrics": bests,
        "targets": targets,
        "targets_met": met,
        "all_targets_met": all(met.values()) if met else False,
    }
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
    return report
