"""Anomaly detector: ``detect(results) -> anomaly_score``.

- An EWMA-tracked running mean/covariance over the per-image SPC metric
  vector (defect count, rate, confidence, severity counts, affected area).
- ``detect`` returns a score in [0, 1]: a squashed Mahalanobis distance of
  the current metric vector from the running distribution (diagonalized
  covariance: robust with few samples, no matrix inversion pathology).
- Cold start: returns 0.0 until ``min_samples`` observations arrive.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from iqc_tpu_torch.analytics.spc import SPCAnalyzer

_FEATURES = (
    "defect_count", "defect_rate", "avg_confidence",
    "critical_defects", "major_defects", "minor_defects",
    "total_area_affected",
)


class AnomalyDetector:
    """EWMA + diagonal-Mahalanobis anomaly scoring over QC metrics."""

    def __init__(self, alpha: float = 0.05, min_samples: int = 10):
        self.alpha = alpha
        self.min_samples = min_samples
        self.count = 0
        self.mean = np.zeros(len(_FEATURES))
        self.var = np.ones(len(_FEATURES))
        self.last_score = 0.0
        self.history: List[float] = []

    @staticmethod
    def _features(results: Dict) -> np.ndarray:
        metrics = SPCAnalyzer.extract_metrics(results)
        return np.asarray([float(metrics[f]) for f in _FEATURES])

    def detect(self, results: Dict) -> float:
        """Score the prediction results; updates the running distribution.

        Returns anomaly score in [0, 1] (0 = nominal).
        """
        x = self._features(results)
        if self.count < self.min_samples:
            # warm-up: learn the distribution, report nominal
            self._update(x, warmup=True)
            self.last_score = 0.0
        else:
            d2 = np.sum((x - self.mean) ** 2 / np.maximum(self.var, 1e-8))
            d = np.sqrt(d2 / len(_FEATURES))  # per-dimension sigma distance
            # squash: ~0 below 1 sigma, ->1 beyond ~4 sigma
            score = float(1.0 - np.exp(-max(d - 1.0, 0.0)))
            self.last_score = min(score, 1.0)
            self._update(x)
        self.count += 1
        self.history.append(self.last_score)
        if len(self.history) > 1000:
            self.history = self.history[-1000:]
        return self.last_score

    def _update(self, x: np.ndarray, warmup: bool = False) -> None:
        if self.count == 0:
            self.mean = x.copy()
            self.var = np.ones_like(x)
            return
        a = max(self.alpha, 1.0 / (self.count + 1)) if warmup else self.alpha
        delta = x - self.mean
        self.mean = self.mean + a * delta
        self.var = (1 - a) * (self.var + a * delta * delta)

    def is_anomalous(self, threshold: float = 0.5) -> bool:
        return self.last_score >= threshold

    def get_state(self) -> Dict:
        return {
            "samples_seen": self.count,
            "last_score": self.last_score,
            "feature_means": dict(zip(_FEATURES, self.mean.tolist())),
            "feature_stds": dict(zip(_FEATURES, np.sqrt(self.var).tolist())),
            "warmed_up": self.count >= self.min_samples,
        }

    def reset(self) -> None:
        self.__init__(alpha=self.alpha, min_samples=self.min_samples)
