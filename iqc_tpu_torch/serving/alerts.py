"""Alert delivery: webhook, email and SMS notifications, and per-image
threshold rules.

- :func:`threshold_alerts` evaluates the ``alerts.thresholds`` rules
  (critical_defects / major_defects / low_confidence per image,
  high_defect_rate over the SPC window) against a prediction result.
- :class:`AlertDispatcher` delivers alerts to the configured webhook URLs,
  over SMTP when ``email_notifications`` is on (standard-library
  ``smtplib``; ``alerts.email``: smtp_server/smtp_port/username/
  recipients), and to an HTTP SMS gateway when ``sms_notifications`` is on
  (one JSON POST per recipient; ``alerts.sms``:
  gateway_url/api_key/from/recipients), all from a background thread
  (bounded retries, timeout), with a per-rule cooldown shared across
  transports so a stuck production line cannot flood the sinks.

Counters (submitted/suppressed/sent/failed/email_sent/email_failed/
sms_sent/sms_failed) surface on the Prometheus exporter
(``serving/metrics.py``).
"""

from __future__ import annotations

import json
import logging
import queue
import smtplib
import threading
import time
import urllib.request
from email.message import EmailMessage
from typing import Callable, Dict, List, Optional

from iqc_tpu_torch.config import AlertsConfig, AlertThresholds

logger = logging.getLogger(__name__)

Sender = Callable[[str, bytes, Dict[str, str], float], int]
# email transport: (settings dict, subject, body, timeout) -> None (raises
# on delivery failure)
EmailSender = Callable[[Dict, str, str, float], None]


def send_email_smtp(settings: Dict, subject: str, body: str,
                    timeout: float) -> None:
    """Default SMTP transport for the reference ``alerts.email`` block
    (config.yaml:89-95: smtp_server, smtp_port, username, recipients;
    extensions: ``password`` triggers LOGIN auth, ``use_tls`` STARTTLS,
    ``from`` overrides the sender address)."""
    msg = EmailMessage()
    msg["Subject"] = subject
    msg["From"] = str(settings.get("from") or settings.get("username")
                      or "iqc-tpu@localhost")
    recipients = [str(r) for r in settings.get("recipients") or ()]
    msg["To"] = ", ".join(recipients)
    msg.set_content(body)
    with smtplib.SMTP(str(settings["smtp_server"]),
                      int(settings.get("smtp_port", 587)),
                      timeout=timeout) as smtp:
        if settings.get("use_tls"):
            smtp.starttls()
        if settings.get("password"):
            smtp.login(str(settings.get("username", "")),
                       str(settings["password"]))
        smtp.send_message(msg)


def email_settings_ok(settings: Dict) -> bool:
    """True when the email block names a server and at least one recipient."""
    return bool(settings and settings.get("smtp_server")
                and settings.get("recipients"))


def send_sms_http(settings: Dict, message: str, timeout: float,
                  post: Optional[Sender] = None) -> None:
    """Default SMS transport: one JSON POST per recipient to the configured
    HTTP gateway (``alerts.sms.gateway_url``). Body shape follows the
    common gateway convention (Twilio-compatible keys): ``{"from": ...,
    "to": ..., "body": ...}``; ``api_key`` is sent as a Bearer token.
    Raises on the FIRST failed recipient so the dispatcher's retry loop
    re-sends the alert (gateways dedup on content + recipient).
    """
    url = str(settings["gateway_url"])
    sender = post or _default_sender
    headers = {"Content-Type": "application/json"}
    if settings.get("api_key"):
        headers["Authorization"] = f"Bearer {settings['api_key']}"
    src = str(settings.get("from") or "IQC-TPU")
    for to in settings.get("recipients") or ():
        body = json.dumps({"from": src, "to": str(to),
                           "body": message}).encode()
        status = sender(url, body, headers, timeout)
        if not 200 <= status < 300:
            raise RuntimeError(f"sms gateway returned {status} for {to}")


def sms_settings_ok(settings: Dict) -> bool:
    """True when the sms block names a gateway and at least one recipient."""
    return bool(settings and settings.get("gateway_url")
                and settings.get("recipients"))


def _default_sender(url: str, body: bytes, headers: Dict[str, str],
                    timeout: float) -> int:
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
        return int(resp.status)


def threshold_alerts(result: Dict, thresholds: AlertThresholds,
                     defect_rate: Optional[float] = None) -> List[Dict]:
    """Reference ``alerts.thresholds`` rules (config.yaml:82-87) evaluated
    against one prediction result (post ``PostProcessor``).

    ``defect_rate``: rolling defects-per-image mean from the SPC window
    (``SPCAnalyzer``); the per-image rules come from the result itself.
    """
    qa = result.get("quality_assessment") or {}
    breakdown = qa.get("severity_breakdown") or {}
    out: List[Dict] = []

    n_crit = int(breakdown.get("critical", 0))
    if n_crit >= max(int(thresholds.critical_defects), 1):
        out.append({
            "type": "threshold", "rule": "critical_defects",
            "severity": "critical",
            "message": f"{n_crit} critical defect(s) detected "
                       f"(threshold {thresholds.critical_defects})",
            "value": n_crit, "threshold": thresholds.critical_defects,
        })
    n_major = int(breakdown.get("major", 0))
    if n_major >= max(int(thresholds.major_defects), 1):
        out.append({
            "type": "threshold", "rule": "major_defects",
            "severity": "major",
            "message": f"{n_major} major defect(s) detected "
                       f"(threshold {thresholds.major_defects})",
            "value": n_major, "threshold": thresholds.major_defects,
        })
    conf = qa.get("average_confidence")
    if (conf is not None and qa.get("total_defects", 0) > 0
            and float(conf) < float(thresholds.low_confidence)):
        out.append({
            "type": "threshold", "rule": "low_confidence",
            "severity": "minor",
            "message": f"mean detection confidence {float(conf):.2f} below "
                       f"{thresholds.low_confidence}",
            "value": round(float(conf), 4),
            "threshold": thresholds.low_confidence,
        })
    if (defect_rate is not None
            and float(defect_rate) > float(thresholds.high_defect_rate)):
        out.append({
            "type": "threshold", "rule": "high_defect_rate",
            "severity": "major",
            "message": f"rolling defect rate {float(defect_rate):.2f}/image "
                       f"above {thresholds.high_defect_rate}",
            "value": round(float(defect_rate), 4),
            "threshold": thresholds.high_defect_rate,
        })
    return out


class AlertDispatcher:
    """Background webhook delivery with per-rule cooldown.

    ``submit`` never blocks the inference path: alerts enter a bounded
    queue drained by a daemon thread; a full queue drops (and counts) the
    alert rather than stalling ``process_image``.
    """

    def __init__(self, config: AlertsConfig, sender: Optional[Sender] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: int = 256,
                 email_sender: Optional[EmailSender] = None,
                 sms_post: Optional[Sender] = None):
        self.config = config
        self._sender = sender or _default_sender
        self._email_sender = email_sender or send_email_smtp
        self._sms_post = sms_post  # None -> alerts._default_sender
        self._clock = clock
        self._queue: queue.Queue = queue.Queue(max_queue)
        self._last_sent: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "suppressed": 0, "sent": 0,
                      "failed": 0, "dropped": 0,
                      "email_sent": 0, "email_failed": 0,
                      "sms_sent": 0, "sms_failed": 0}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def webhooks_enabled(self) -> bool:
        return bool(self.config.webhook_notifications and self.config.urls())

    @property
    def email_enabled(self) -> bool:
        return bool(self.config.email_notifications
                    and email_settings_ok(self.config.email))

    @property
    def sms_enabled(self) -> bool:
        return bool(getattr(self.config, "sms_notifications", False)
                    and sms_settings_ok(getattr(self.config, "sms", None)))

    @property
    def enabled(self) -> bool:
        return self.webhooks_enabled or self.email_enabled or self.sms_enabled

    # -- intake -----------------------------------------------------------------

    def submit(self, alert: Dict) -> bool:
        """Queue one alert for delivery. Returns True if accepted."""
        if not self.enabled:
            return False
        # per-rule cooldown key: SPC alerts carry `metric` (which chart
        # series violated), threshold alerts carry `rule` — without them
        # distinct alerts of one type would suppress each other
        key = f"{alert.get('type', 'alert')}:{alert.get('rule', alert.get('metric', ''))}"
        now = self._clock()
        with self._lock:
            self.stats["submitted"] += 1
            last = self._last_sent.get(key)
            if last is not None and now - last < self.config.cooldown_seconds:
                self.stats["suppressed"] += 1
                return False
        try:
            self._queue.put_nowait(dict(alert))
        except queue.Full:
            # a dropped alert must NOT start the cooldown — the next
            # occurrence should enqueue once capacity frees
            with self._lock:
                self.stats["dropped"] += 1
            return False
        with self._lock:
            self._last_sent[key] = now
        self._ensure_worker()
        return True

    def submit_all(self, alerts: List[Dict]) -> int:
        return sum(1 for a in alerts if self.submit(a))

    # -- delivery ---------------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="iqc-alert-dispatch")
            self._worker.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                alert = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self._deliver(alert)
            self._queue.task_done()

    def _deliver(self, alert: Dict) -> None:
        body = json.dumps({"source": "iqc_tpu", "alert": alert},
                          default=str).encode()
        headers = {"Content-Type": "application/json"}
        if self.webhooks_enabled:
            for url in self.config.urls():
                ok = False
                for attempt in range(self.config.retries + 1):
                    try:
                        status = self._sender(url, body, headers,
                                              self.config.timeout_seconds)
                        if 200 <= status < 300:
                            ok = True
                            break
                        logger.warning("webhook %s returned %d (attempt %d)",
                                       url, status, attempt + 1)
                    except Exception as e:  # network errors must never propagate
                        logger.warning("webhook %s failed: %s (attempt %d)",
                                       url, e, attempt + 1)
                with self._lock:
                    self.stats["sent" if ok else "failed"] += 1
        if self.email_enabled:
            self._deliver_email(alert)
        if self.sms_enabled:
            self._deliver_sms(alert)

    def _deliver_email(self, alert: Dict) -> None:
        """SMTP delivery of one alert (reference alerts.email block)."""
        severity = str(alert.get("severity", "info")).upper()
        rule = alert.get("rule", alert.get("metric", "alert"))
        subject = f"[IQC {severity}] {rule}"
        body = (f"{alert.get('message', '')}\n\n"
                + json.dumps({"source": "iqc_tpu", "alert": alert},
                             default=str, indent=1))
        ok = False
        for attempt in range(self.config.retries + 1):
            try:
                self._email_sender(dict(self.config.email), subject, body,
                                   self.config.timeout_seconds)
                ok = True
                break
            except Exception as e:  # SMTP errors must never propagate
                logger.warning("email alert failed: %s (attempt %d)",
                               e, attempt + 1)
        with self._lock:
            self.stats["email_sent" if ok else "email_failed"] += 1

    def _deliver_sms(self, alert: Dict) -> None:
        """HTTP-gateway SMS delivery of one alert — SMS bodies stay short
        (one segment is 160 GSM-7 chars): severity, rule, message only."""
        severity = str(alert.get("severity", "info")).upper()
        rule = alert.get("rule", alert.get("metric", "alert"))
        message = f"[IQC {severity}] {rule}: {alert.get('message', '')}"[:160]
        ok = False
        for attempt in range(self.config.retries + 1):
            try:
                send_sms_http(dict(self.config.sms), message,
                              self.config.timeout_seconds,
                              post=self._sms_post)
                ok = True
                break
            except Exception as e:  # gateway errors must never propagate
                logger.warning("sms alert failed: %s (attempt %d)",
                               e, attempt + 1)
        with self._lock:
            self.stats["sms_sent" if ok else "sms_failed"] += 1

    # -- lifecycle ---------------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Best-effort wait for the queue to drain (tests/shutdown)."""
        deadline = time.monotonic() + timeout
        while not self._queue.empty():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        # one extra beat for the in-flight item past get()
        time.sleep(0.05)
        return True

    def close(self) -> None:
        self._stop.set()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout=2.0)
