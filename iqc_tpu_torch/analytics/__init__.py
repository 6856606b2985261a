"""Analytics: statistical process control and anomaly scoring."""

from iqc_tpu_torch.analytics.spc import SPCAnalyzer  # noqa: F401
from iqc_tpu_torch.analytics.anomaly import AnomalyDetector  # noqa: F401
