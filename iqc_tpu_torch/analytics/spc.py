"""Statistical process control analyzer.

Rolling-window metric extraction, c-chart / u-chart / X-mR control limits,
Western-Electric-style run rules, Cp/Cpk/Cpm process capability, alerting,
trend analysis, recommendations, JSON report export and summary
statistics. Metric history is stored as flat numpy ring buffers
(vectorized rule checks); specification limits come from the typed config
(``SPCConfig``).

Host-side numpy: stateful, O(window) per update, and after the device
pipeline.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from iqc_tpu_torch.config import SPCConfig

logger = logging.getLogger(__name__)

SPC_RULES = {
    "rule1": "Point beyond control limits",
    "rule2": "9 consecutive points on same side of centerline",
    "rule3": "6 consecutive increasing or decreasing points",
    "rule4": "14 alternating up and down points",
    "rule5": "2 out of 3 consecutive points beyond 2-sigma",
    "rule6": "4 out of 5 consecutive points beyond 1-sigma",
    "rule7": "15 consecutive points within 1-sigma",
    "rule8": "8 consecutive points beyond 1-sigma",
}

_METRIC_FIELDS = (
    "defect_count", "defect_rate", "avg_confidence",
    "critical_defects", "major_defects", "minor_defects",
    "total_area_affected",
)


class _Ring:
    """Fixed-capacity float ring buffer with vectorized window reads."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._n = 0
        self._head = 0

    def push(self, value: float) -> None:
        self._buf[self._head] = value
        self._head = (self._head + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def values(self) -> np.ndarray:
        if self._n < self.capacity:
            return self._buf[: self._n].copy()
        return np.roll(self._buf, -self._head)

    def __len__(self) -> int:
        return self._n

    def clear(self) -> None:
        self._n = 0
        self._head = 0


class SPCAnalyzer:
    """API parity with the reference ``SPCAnalyzer``
    (``analytics/sec_analysis.py:20-588``)."""

    def __init__(
        self,
        window_size: int = 100,
        confidence_level: float = 0.95,
        config: Optional[SPCConfig] = None,
    ):
        self.config = config or SPCConfig(
            window_size=window_size, confidence_level=confidence_level
        )
        self.window_size = self.config.window_size
        self.confidence_level = self.config.confidence_level
        self.series: Dict[str, _Ring] = {
            f: _Ring(self.window_size) for f in _METRIC_FIELDS
        }
        self.timestamps: List[datetime] = []
        self.control_limits: Dict = {}
        self.process_capability: Dict = {}
        self.spc_rules = dict(SPC_RULES)

    # -- main entry (sec_analysis.py:55-103) --------------------------------------

    def analyze(self, prediction_results: Dict) -> Dict:
        metrics = self.extract_metrics(prediction_results)
        self._push(metrics)
        self.control_limits = self.compute_control_limits()
        status = self.control_status(metrics, self.control_limits)
        self.process_capability = self.compute_capability()
        alerts = self.generate_alerts(status, metrics)
        return {
            "timestamp": datetime.now().isoformat(),
            "current_metrics": metrics,
            "control_limits": self.control_limits,
            "control_status": status,
            "process_capability": self.process_capability,
            "alerts": alerts,
            "chart_data": self.chart_data(),
            "trend_analysis": self.analyze_trends(),
            "recommendations": self.recommendations(status, self.process_capability),
        }

    # -- metric extraction (sec_analysis.py:105-147) --------------------------------

    @staticmethod
    def extract_metrics(prediction_results: Dict) -> Dict:
        detections = prediction_results.get("detections", []) or []
        m = {
            "timestamp": datetime.now(),
            "defect_count": len(detections),
            "defect_rate": float(len(detections)),
            "avg_confidence": 0.0,
            "critical_defects": 0,
            "major_defects": 0,
            "minor_defects": 0,
            "total_area_affected": 0.0,
        }
        if detections:
            confs = [
                d.get("ensemble_confidence", d.get("confidence", 0.0)) for d in detections
            ]
            m["avg_confidence"] = float(np.mean(confs))
            for d in detections:
                sev = d.get("final_severity", d.get("severity", "minor"))
                key = f"{sev}_defects" if sev in ("critical", "major") else "minor_defects"
                m[key] += 1
                b = d.get("bbox", {})
                m["total_area_affected"] += b.get("width", 0) * b.get("height", 0)
        m["critical_rate"] = m["critical_defects"] / max(1, m["defect_count"])
        m["major_rate"] = m["major_defects"] / max(1, m["defect_count"])
        return m

    def _push(self, metrics: Dict) -> None:
        for f in _METRIC_FIELDS:
            self.series[f].push(float(metrics[f]))
        self.timestamps.append(metrics["timestamp"])
        if len(self.timestamps) > self.window_size:
            self.timestamps = self.timestamps[-self.window_size:]

    # -- control limits (sec_analysis.py:159-227) ------------------------------------

    def compute_control_limits(self, min_points: int = 10) -> Dict:
        if len(self.series["defect_count"]) < min_points:
            return {}
        counts = self.series["defect_count"].values()
        rates = self.series["defect_rate"].values()
        confs = self.series["avg_confidence"].values()
        return {
            "defect_count": self._attribute_limits(counts, "c-chart"),
            "defect_rate": self._attribute_limits(rates, "u-chart"),
            "confidence": self._xmr_limits(confs),
        }

    @staticmethod
    def _attribute_limits(data: np.ndarray, chart_type: str, n: float = 1.0) -> Dict:
        """Poisson-based limits: center +- k*sqrt(center/n); c-chart (n=1)
        and u-chart share the form (sec_analysis.py:183-212)."""
        center = float(np.mean(data))
        sigma = float(np.sqrt(max(center, 0.0) / n))
        return {
            "center_line": center,
            "upper_control_limit": center + 3 * sigma,
            "lower_control_limit": max(0.0, center - 3 * sigma),
            "upper_warning_limit": center + 2 * sigma,
            "lower_warning_limit": max(0.0, center - 2 * sigma),
            "chart_type": chart_type,
        }

    @staticmethod
    def _xmr_limits(data: np.ndarray) -> Dict:
        """Individuals / moving-range chart, d2=1.128
        (sec_analysis.py:214-227)."""
        center = float(np.mean(data))
        mr = np.abs(np.diff(data))
        mr_bar = float(np.mean(mr)) if mr.size else 0.0
        sigma = mr_bar / 1.128
        return {
            "center_line": center,
            "upper_control_limit": center + 3 * sigma,
            "lower_control_limit": center - 3 * sigma,
            "upper_warning_limit": center + 2 * sigma,
            "lower_warning_limit": center - 2 * sigma,
            "chart_type": "X-chart",
        }

    # -- control status + run rules (sec_analysis.py:229-313) --------------------------

    def control_status(self, metrics: Dict, limits: Dict) -> Dict:
        status = {"in_control": True, "violations": [], "warnings": []}
        key_map = {"defect_count": "defect_count", "defect_rate": "defect_rate",
                   "confidence": "avg_confidence"}
        for name, lim in limits.items():
            value = metrics.get(key_map.get(name, name))
            if value is None:
                continue
            # tolerance guards the degenerate zero-sigma case (constant
            # series): mean(0.9 x20) is 1 ulp below 0.9 in float64
            eps = 1e-9 * max(abs(lim["center_line"]), 1.0)
            if (
                value > lim["upper_control_limit"] + eps
                or value < lim["lower_control_limit"] - eps
            ):
                status["in_control"] = False
                status["violations"].append(
                    {
                        "metric": name, "value": value,
                        "limit_violated": "upper" if value > lim["upper_control_limit"] else "lower",
                        "severity": "critical",
                    }
                )
            elif (
                value > lim["upper_warning_limit"] + eps
                or value < lim["lower_warning_limit"] - eps
            ):
                status["warnings"].append(
                    {
                        "metric": name, "value": value,
                        "limit_violated": "upper" if value > lim["upper_warning_limit"] else "lower",
                        "severity": "warning",
                    }
                )
        rule_violations = self.check_run_rules()
        status["rule_violations"] = rule_violations
        if rule_violations:
            status["in_control"] = False
        return status

    def check_run_rules(self, lookback: int = 20) -> List[Dict]:
        """Vectorized Western-Electric run rules over the last N defect
        counts. The reference implements rules 2 & 3 of its declared 8
        (sec_analysis.py:273-313); all 8 declared rules are implemented
        here."""
        n = len(self.series["defect_count"])
        if n < 9:
            return []
        data = self.series["defect_count"].values()[-lookback:]
        center = float(np.mean(data))
        sigma = float(np.std(data))
        # sigma-based rules (5-8) are meaningless on (near-)constant data:
        # a perfectly stable process must not flag "stratification"
        sigma_ok = sigma > 1e-6
        found: List[Dict] = []

        def windows(arr: np.ndarray, k: int) -> np.ndarray:
            if len(arr) < k:
                return np.empty((0, k))
            return np.lib.stride_tricks.sliding_window_view(arr, k)

        # rule 2: 9 consecutive same side of centerline
        w = windows(data, 9)
        if w.size and (np.all(w > center, axis=1) | np.all(w < center, axis=1)).any():
            found.append({"rule": "rule2", "description": SPC_RULES["rule2"], "severity": "major"})
        # rule 3: 6 consecutive monotonic
        d = np.diff(data)
        wd = windows(d, 5)
        if wd.size and (np.all(wd > 0, axis=1) | np.all(wd < 0, axis=1)).any():
            found.append({"rule": "rule3", "description": SPC_RULES["rule3"], "severity": "major"})
        # rule 4: 14 alternating up/down
        wd14 = windows(np.sign(d), 13)
        if wd14.size:
            alternating = np.all(wd14[:, 1:] * wd14[:, :-1] < 0, axis=1)
            if alternating.any():
                found.append({"rule": "rule4", "description": SPC_RULES["rule4"], "severity": "minor"})
        if not sigma_ok:
            return found
        # rule 5: 2 of 3 consecutive beyond 2-sigma (same side)
        w3 = windows(data, 3)
        if w3.size:
            hi = (w3 > center + 2 * sigma).sum(axis=1) >= 2
            lo = (w3 < center - 2 * sigma).sum(axis=1) >= 2
            if (hi | lo).any():
                found.append({"rule": "rule5", "description": SPC_RULES["rule5"], "severity": "major"})
        # rule 6: 4 of 5 consecutive beyond 1-sigma (same side)
        w5 = windows(data, 5)
        if w5.size:
            hi = (w5 > center + sigma).sum(axis=1) >= 4
            lo = (w5 < center - sigma).sum(axis=1) >= 4
            if (hi | lo).any():
                found.append({"rule": "rule6", "description": SPC_RULES["rule6"], "severity": "major"})
        # rule 7: 15 consecutive within 1-sigma (stratification)
        w15 = windows(data, 15)
        if w15.size and np.all(np.abs(w15 - center) < sigma, axis=1).any():
            found.append({"rule": "rule7", "description": SPC_RULES["rule7"], "severity": "minor"})
        # rule 8: 8 consecutive beyond 1-sigma (either side, mixture)
        w8 = windows(data, 8)
        if w8.size and np.all(np.abs(w8 - center) > sigma, axis=1).any():
            found.append({"rule": "rule8", "description": SPC_RULES["rule8"], "severity": "major"})
        return found

    # -- capability (sec_analysis.py:315-380) --------------------------------------------

    def compute_capability(self, min_points: int = 30) -> Dict:
        if len(self.series["defect_rate"]) < min_points:
            return {"insufficient_data": True}
        rates = self.series["defect_rate"].values()
        mean = float(np.mean(rates))
        std = float(np.std(rates, ddof=1))
        lim = self.config.defect_rate_limits
        usl, lsl, target = lim.upper, lim.lower, lim.target
        if std <= 0:
            return {"insufficient_data": True}
        cp = (usl - lsl) / (6 * std)
        cpu = (usl - mean) / (3 * std)
        cpl = (mean - lsl) / (3 * std)
        cpk = min(cpu, cpl)
        cpm = (usl - lsl) / (6 * np.sqrt(std**2 + (mean - target) ** 2))
        return {
            "cp": cp, "cpk": cpk, "cpm": cpm, "cpu": cpu, "cpl": cpl,
            "mean": mean, "std": std, "target": target,
            "specification_limits": {"upper": usl, "lower": lsl},
            "interpretation": self.interpret_capability(cpk),
        }

    @staticmethod
    def interpret_capability(cpk: float) -> str:
        bands = [
            (2.0, "Excellent - 6 sigma process"),
            (1.67, "Very Good - 5 sigma process"),
            (1.33, "Good - 4 sigma process"),
            (1.0, "Adequate - 3 sigma process"),
            (0.67, "Poor - Process improvement needed"),
        ]
        for lo, text in bands:
            if cpk >= lo:
                return text
        return "Unacceptable - Immediate action required"

    # -- alerts (sec_analysis.py:382-426) ---------------------------------------------

    def generate_alerts(self, status: Dict, metrics: Dict) -> List[Dict]:
        now = datetime.now().isoformat()
        alerts = []
        for v in status.get("violations", []):
            alerts.append(
                {
                    "type": "control_violation", "severity": "critical",
                    "metric": v["metric"],
                    "message": f"Control limit violation: {v['metric']} = {v['value']:.2f}",
                    "timestamp": now, "action_required": True,
                }
            )
        for w in status.get("warnings", []):
            alerts.append(
                {
                    "type": "warning_limit", "severity": "warning",
                    "metric": w["metric"],
                    "message": f"Warning limit exceeded: {w['metric']} = {w['value']:.2f}",
                    "timestamp": now, "action_required": False,
                }
            )
        if metrics["defect_rate"] > self.config.high_defect_rate_alert:
            alerts.append(
                {
                    "type": "high_defect_rate", "severity": "major",
                    "message": f"High defect rate detected: {metrics['defect_rate']:.2f}",
                    "timestamp": now, "action_required": True,
                }
            )
        if metrics["critical_defects"] > 0:
            alerts.append(
                {
                    "type": "critical_defects", "severity": "critical",
                    "message": f"Critical defects detected: {metrics['critical_defects']}",
                    "timestamp": now, "action_required": True,
                }
            )
        return alerts

    # -- chart/trends/recs (sec_analysis.py:428-500) ------------------------------------

    def chart_data(self) -> Dict:
        if not self.timestamps:
            return {}
        data = {
            "timestamps": [t.isoformat() for t in self.timestamps],
            "defect_counts": self.series["defect_count"].values().tolist(),
            "defect_rates": self.series["defect_rate"].values().tolist(),
            "confidence_scores": self.series["avg_confidence"].values().tolist(),
        }
        if self.control_limits:
            data["control_limits"] = self.control_limits
        return data

    def analyze_trends(self, lookback: int = 20) -> Dict:
        n = len(self.series["defect_count"])
        if n < 10:
            return {"insufficient_data": True}
        recent = self.series["defect_count"].values()[-lookback:]
        if len(recent) < 5:
            return {}
        slope, _ = np.polyfit(np.arange(len(recent)), recent, 1)
        direction = "increasing" if slope > 0.1 else "decreasing" if slope < -0.1 else "stable"
        return {
            "trend_direction": direction,
            "slope": float(slope),
            "recent_average": float(np.mean(recent[-5:])),
            "overall_average": float(np.mean(recent)),
            "volatility": float(np.std(recent)),
        }

    def recommendations(self, status: Dict, capability: Dict) -> List[str]:
        recs = []
        if not status.get("in_control", True):
            recs.append("Process is out of control - investigate special causes")
            recs.append("Review recent process changes or environmental factors")
        if not capability.get("insufficient_data", False):
            cpk = capability.get("cpk", 0.0)
            if cpk < 1.0:
                recs.append("Process capability is inadequate - consider process improvement")
            elif cpk < 1.33:
                recs.append("Process capability is marginal - monitor closely")
        rates = self.series["defect_rate"].values()
        if len(rates) >= 5 and float(np.mean(rates[-5:])) > 2.0:
            recs.append("High defect rate detected - review quality procedures")
            recs.append("Consider additional operator training or equipment maintenance")
        if self.analyze_trends().get("trend_direction") == "increasing":
            recs.append("Increasing defect trend detected - preventive action recommended")
        return recs

    # -- export / reset / summary (sec_analysis.py:502-588) -------------------------------

    def export_spc_report(self, filepath: str) -> bool:
        if not self.timestamps:
            logger.warning("no data for SPC report")
            return False
        counts = self.series["defect_count"].values()
        rates = self.series["defect_rate"].values()
        confs = self.series["avg_confidence"].values()
        k = min(50, len(counts))
        report = {
            "report_timestamp": datetime.now().isoformat(),
            "data_summary": {
                "total_samples": len(counts),
                "time_period": {
                    "start": self.timestamps[0].isoformat(),
                    "end": self.timestamps[-1].isoformat(),
                },
            },
            "control_limits": self.control_limits,
            "process_capability": self.process_capability,
            "recent_data": [
                {
                    "timestamp": self.timestamps[len(self.timestamps) - k + i].isoformat(),
                    "defect_count": counts[len(counts) - k + i],
                    "defect_rate": rates[len(rates) - k + i],
                    "avg_confidence": confs[len(confs) - k + i],
                }
                for i in range(k)
            ],
        }
        with open(filepath, "w") as f:
            json.dump(report, f, indent=2, default=float)
        return True

    def reset_data(self) -> None:
        for ring in self.series.values():
            ring.clear()
        self.timestamps.clear()
        self.control_limits = {}
        self.process_capability = {}

    def get_summary_statistics(self) -> Dict:
        if not self.timestamps:
            return {"no_data": True}

        def stats(arr: np.ndarray) -> Dict:
            return {
                "mean": float(np.mean(arr)), "median": float(np.median(arr)),
                "std": float(np.std(arr)), "min": float(np.min(arr)),
                "max": float(np.max(arr)),
            }

        span = (self.timestamps[-1] - self.timestamps[0]).total_seconds() / 3600
        return {
            "sample_count": len(self.series["defect_count"]),
            "time_span_hours": span,
            "defect_count_stats": stats(self.series["defect_count"].values()),
            "defect_rate_stats": stats(self.series["defect_rate"].values()),
            "confidence_stats": stats(self.series["avg_confidence"].values()),
        }
