"""Factory-system integrations: MES / ERP / QMS result forwarding.

Configured by the ``integrations`` block (kept in ``SystemConfig.extra``):
MES endpoint and API key, ERP endpoint and basic-auth credentials, QMS
endpoint with a real-time or batch mode. Every processed result posts a
compact inspection record to each enabled system from a background thread
(bounded queue, retries, per-system auth style), so a stuck MES cannot
stall the inference path.

Record schema (stable contract for downstream systems):
``{source, timestamp, quality_grade, pass_fail, total_defects,
severity_breakdown, quality_score, anomaly_score}``.

QMS ``integration_type: batch`` accumulates records and flushes every
``batch_size`` (or on ``flush()``); ``real_time`` posts per result.
Delivery counters surface on the Prometheus exporter.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

Sender = Callable[[str, bytes, Dict[str, str], float], int]


def _default_sender(url: str, body: bytes, headers: Dict[str, str],
                    timeout: float) -> int:
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
        return int(resp.status)


def inspection_record(result: Dict) -> Dict:
    """Compact inspection record from a processed prediction result."""
    qa = result.get("quality_assessment") or {}
    return {
        "source": "iqc_tpu",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
        "quality_grade": qa.get("quality_grade"),
        "pass_fail": qa.get("pass_fail_status"),
        "total_defects": int(qa.get("total_defects", 0) or 0),
        "severity_breakdown": qa.get("severity_breakdown") or {},
        "quality_score": qa.get("quality_score"),
        "anomaly_score": result.get("anomaly_score", 0.0),
    }


class IntegrationForwarder:
    """Posts inspection records to enabled MES/ERP/QMS endpoints.

    ``config`` is the reference-shaped integrations dict (the typed config
    keeps it in ``extra`` passthrough — the shapes differ per system, so a
    dict mirrors the reference contract exactly).
    """

    def __init__(self, config: Optional[Dict], sender: Optional[Sender] = None,
                 timeout: float = 3.0, retries: int = 1,
                 max_queue: int = 512):
        self.systems: List[Dict] = []
        for name in ("mes", "erp", "qms"):
            sys_cfg = dict((config or {}).get(name) or {})
            if not (sys_cfg.get("enabled") and sys_cfg.get("endpoint")):
                continue
            headers = {"Content-Type": "application/json"}
            if sys_cfg.get("api_key"):  # MES style
                headers["X-API-Key"] = str(sys_cfg["api_key"])
            if sys_cfg.get("username"):  # ERP style: HTTP basic auth
                cred = f"{sys_cfg['username']}:{sys_cfg.get('password', '')}"
                headers["Authorization"] = (
                    "Basic " + base64.b64encode(cred.encode()).decode())
            self.systems.append({
                "name": name,
                "endpoint": str(sys_cfg["endpoint"]),
                "headers": headers,
                "batch": (name == "qms"
                          and sys_cfg.get("integration_type") == "batch"),
                "batch_size": int(sys_cfg.get("batch_size", 16)),
                "pending": [],
            })
        self._sender = sender or _default_sender
        self.timeout = timeout
        self.retries = retries
        self._queue: queue.Queue = queue.Queue(max_queue)
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "sent": 0, "failed": 0, "dropped": 0}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def enabled(self) -> bool:
        return bool(self.systems)

    def submit(self, result: Dict) -> bool:
        """Queue one processed result for forwarding."""
        if not self.enabled:
            return False
        with self._lock:
            self.stats["submitted"] += 1
        try:
            self._queue.put_nowait(inspection_record(result))
        except queue.Full:
            with self._lock:
                self.stats["dropped"] += 1
            return False
        self._ensure_worker()
        return True

    # -- delivery ----------------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="iqc-integrations")
            self._worker.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                record = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            for system in self.systems:
                if system["batch"]:
                    system["pending"].append(record)
                    if len(system["pending"]) >= system["batch_size"]:
                        self._post(system, {"records": system["pending"]})
                        system["pending"] = []
                else:
                    self._post(system, record)
            self._queue.task_done()

    def _post(self, system: Dict, payload: Dict) -> None:
        body = json.dumps(payload, default=str).encode()
        ok = False
        for attempt in range(self.retries + 1):
            try:
                status = self._sender(system["endpoint"], body,
                                      system["headers"], self.timeout)
                if 200 <= status < 300:
                    ok = True
                    break
                logger.warning("%s integration returned %d (attempt %d)",
                               system["name"], status, attempt + 1)
            except Exception as e:
                logger.warning("%s integration failed: %s (attempt %d)",
                               system["name"], e, attempt + 1)
        with self._lock:
            self.stats["sent" if ok else "failed"] += 1

    # -- lifecycle ---------------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Drain the queue and post partial QMS batches (shutdown/tests)."""
        deadline = time.monotonic() + timeout
        while not self._queue.empty():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        time.sleep(0.05)
        for system in self.systems:
            if system["batch"] and system["pending"]:
                self._post(system, {"records": system["pending"]})
                system["pending"] = []
        return True

    def close(self) -> None:
        self._stop.set()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout=2.0)
