"""SPC and anomaly analytics of the port against the JAX package's.

The same sequence of prediction results goes through both packages'
``SPCAnalyzer`` and ``AnomalyDetector`` (each built from its own package's
``SPCConfig`` with the same values). Every output is EQUAL: the per-result
analyses, the control limits, run rules, capability, trends, summary
statistics, chart data, the exported report and the anomaly scores and
state, with the wall-clock timestamps (and the time span between the first
and the last) removed.
"""

import json

import numpy as np
import pytest

from iqc_tpu.analytics import AnomalyDetector as JaxAnomaly
from iqc_tpu.analytics import SPCAnalyzer as JaxSPC
from iqc_tpu.config import SPCConfig as JaxSPCConfig
from iqc_tpu.config import SpecLimit as JaxSpecLimit
from iqc_tpu_torch.analytics import AnomalyDetector, SPCAnalyzer
from iqc_tpu_torch.config import SPCConfig, SpecLimit

SEVERITIES = ("minor", "major", "critical")


def _results(seed, n):
    """Prediction results of a line that drifts: defect counts rise after
    the first half, with a burst of critical defects near the end."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.poisson(1.0 if i < n // 2 else 3.5)) + (6 if n - 8 <= i < n - 5 else 0)
        out.append({"detections": [
            {"ensemble_confidence": float(rng.uniform(0.5, 0.99)),
             "final_severity": SEVERITIES[int(rng.integers(0, 3))] if i < n - 8 else "critical",
             "bbox": {"width": int(rng.integers(5, 80)), "height": int(rng.integers(5, 80))}}
            for _ in range(k)]})
    return out


def _untimed(x):
    """``x`` without wall-clock timestamps and the time spans between them."""
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items()
                if "timestamp" not in k and k not in ("start", "end", "time_span_hours")}
    if isinstance(x, (list, tuple)):
        return [_untimed(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _pair(window, limits=(5.0, 0.0, 0.5), alert=3.0):
    upper, lower, target = limits
    want = JaxSPC(window_size=window, config=JaxSPCConfig(
        window_size=window, defect_rate_limits=JaxSpecLimit(upper, lower, target),
        high_defect_rate_alert=alert))
    got = SPCAnalyzer(window_size=window, config=SPCConfig(
        window_size=window, defect_rate_limits=SpecLimit(upper, lower, target),
        high_defect_rate_alert=alert))
    return got, want


@pytest.mark.parametrize("window,n,limits", [
    (100, 60, (5.0, 0.0, 0.5)),   # the shipped profile
    (20, 60, (2.0, 0.0, 0.3)),    # a window that overflows, tighter limits
])
def test_spc_equal_outputs(window, n, limits, tmp_path):
    got, want = _pair(window, limits)
    for r in _results(window, n):
        assert _untimed(got.analyze(r)) == _untimed(want.analyze(r))
    for method in ("compute_control_limits", "check_run_rules", "compute_capability",
                   "analyze_trends", "get_summary_statistics", "chart_data"):
        assert _untimed(getattr(got, method)()) == _untimed(getattr(want, method)()), method
    paths = tmp_path / "port.json", tmp_path / "jax.json"
    assert got.export_spc_report(str(paths[0])) and want.export_spc_report(str(paths[1]))
    g, w = (json.loads(p.read_text()) for p in paths)
    assert _untimed(g) == _untimed(w)
    got.reset_data()
    want.reset_data()
    assert _untimed(got.get_summary_statistics()) == _untimed(want.get_summary_statistics())


def test_spc_static_helpers_equal():
    for r in _results(3, 10):
        assert _untimed(SPCAnalyzer.extract_metrics(r)) == _untimed(JaxSPC.extract_metrics(r))
    for cpk in (-0.5, 0.5, 1.0, 1.2, 1.4, 1.7, 2.5):
        assert SPCAnalyzer.interpret_capability(cpk) == JaxSPC.interpret_capability(cpk)


def test_anomaly_equal_outputs():
    got, want = AnomalyDetector(), JaxAnomaly()
    scores = []
    for r in _results(5, 80):
        s = got.detect(r)
        assert s == want.detect(r)
        scores.append(s)
        assert got.is_anomalous() == want.is_anomalous()
        assert got.is_anomalous(0.9) == want.is_anomalous(0.9)
    assert max(scores) > 0.5  # the burst of critical defects scores high
    assert _untimed(got.get_state()) == _untimed(want.get_state())
    got.reset()
    want.reset()
    assert _untimed(got.get_state()) == _untimed(want.get_state())
