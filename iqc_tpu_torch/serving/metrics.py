"""Prometheus metrics exporter.

Serves the Prometheus text exposition format (``monitoring.metrics_port``,
9090 by default) from a standard-library HTTP server: no client library.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_START_TIME = time.time()


def render_metrics(system) -> str:
    """Prometheus text format for the QC system's live counters."""
    lines = []

    def metric(name, mtype, help_text, value, labels=""):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{labels} {value}")

    stats = system.get_performance_stats() or {}
    metric("iqc_uptime_seconds", "gauge", "Process uptime", round(time.time() - _START_TIME, 1))
    metric("iqc_models_loaded", "gauge", "1 if models initialized", int(system.detector is not None))
    metric("iqc_predictions_total", "counter", "Total predictions served",
           stats.get("total_predictions", 0))
    metric("iqc_prediction_seconds_total", "counter", "Total prediction wall time",
           round(stats.get("total_time", 0.0), 6))
    metric("iqc_prediction_avg_ms", "gauge", "Average prediction latency (ms)",
           round(stats.get("average_time", 0.0) * 1000, 3))
    metric("iqc_throughput_images_per_second", "gauge", "Current throughput",
           round(stats.get("throughput_images_per_second", 0.0), 3))
    metric("iqc_queue_depth", "gauge", "Processing queue depth",
           system.processing_queue.qsize())
    metric("iqc_worker_instances", "gauge",
           "Queue-draining worker pool size (production.scaling)",
           getattr(system, "worker_count", 0))
    scaler = getattr(system, "autoscaler", None)
    if scaler is not None:
        metric("iqc_host_cpu_percent", "gauge",
               "Host CPU utilization (autoscaler sample)",
               scaler.stats.get("cpu_percent", 0.0))
        metric("iqc_host_memory_percent", "gauge",
               "Host memory utilization (autoscaler sample)",
               scaler.stats.get("memory_percent", 0.0))
        for key, help_text in (
            ("scale_ups", "Worker pool scale-up events"),
            ("scale_downs", "Worker pool scale-down events"),
        ):
            metric(f"iqc_autoscaler_{key}_total", "counter", help_text,
                   int(scaler.stats.get(key, 0)))

    fwd = getattr(system, "integrations", None)
    if fwd is not None and fwd.enabled:
        for key, help_text in (
            ("submitted", "Results offered to MES/ERP/QMS forwarding"),
            ("sent", "Integration posts delivered"),
            ("failed", "Integration posts that exhausted retries"),
            ("dropped", "Results dropped by a full integration queue"),
        ):
            metric(f"iqc_integration_{key}_total", "counter", help_text,
                   fwd.stats.get(key, 0))

    dispatcher = getattr(system, "alert_dispatcher", None)
    if dispatcher is not None:
        for key, help_text in (
            ("submitted", "Alerts offered to the webhook dispatcher"),
            ("suppressed", "Alerts dropped by the per-rule cooldown"),
            ("sent", "Alerts delivered to a webhook sink"),
            ("failed", "Alerts that exhausted webhook retries"),
            ("dropped", "Alerts dropped by a full dispatch queue"),
            ("email_sent", "Alerts delivered over SMTP"),
            ("email_failed", "Alerts that exhausted SMTP retries"),
            ("sms_sent", "Alerts delivered to the SMS gateway"),
            ("sms_failed", "Alerts that exhausted SMS-gateway retries"),
        ):
            metric(f"iqc_alerts_{key}_total", "counter", help_text,
                   dispatcher.stats.get(key, 0))

    ens = getattr(system.detector, "ensemble_predictor", None)
    if ens is not None:
        # capacity signal: detections past the max_classified crop slots use
        # the reference's conf*1.1 mock rule instead of real crop ResNet —
        # a rising counter means max_classified should be raised
        metric("iqc_crop_classified_total", "counter",
               "Detections classified by the real crop ResNet",
               getattr(ens, "crop_classified_total", 0))
        metric("iqc_mock_tail_detections_total", "counter",
               "Detections past max_classified that fell back to the mock "
               "conf*1.1 rule", getattr(ens, "mock_tail_total", 0))

    if system.spc_analyzer is not None:
        counts = system.spc_analyzer.series["defect_count"]
        if len(counts):
            vals = counts.values()
            metric("iqc_spc_defect_count_mean", "gauge",
                   "Rolling mean defect count", round(float(vals.mean()), 4))
            metric("iqc_spc_samples", "gauge", "SPC window fill", len(counts))
    if system.anomaly_detector is not None:
        metric("iqc_anomaly_score", "gauge", "Last anomaly score",
               round(system.anomaly_detector.last_score, 4))
    return "\n".join(lines) + "\n"


def start_metrics_server(system, port: int = 9090, host: str = "0.0.0.0"):
    """Serve /metrics on a daemon thread; returns the server."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = render_metrics(system).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # pragma: no cover
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="metrics-exporter").start()
    return server
