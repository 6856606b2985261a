"""Serving application: the system orchestrator and the REST API.

``QualityControlSystem`` loads the configuration, builds the detector on its
device (the card unless the caller passes ``device="cpu"``; "demo mode" where
that fails), and chains detector -> SPC -> anomaly score -> alerts ->
storage -> events in ``process_image``. ``create_app`` puts the JAX
package's route map and JSON schemas on the standard-library WSGI framework
(``serving/wsgi.py``), with:

- a lock-guarded per-IP sliding-window rate limiter (native when the C++
  runtime builds);
- queue workers that block on a native coalescing queue and aggregate
  waiting requests into device batches;
- real-time events over a WebSocket at /ws and Server-Sent Events at
  /events.

Serve with ``python -m iqc_tpu_torch.serving.app --port 5000`` (add
``--device cpu`` to run without a card).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import queue
import threading
import time
import zipfile
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np

from iqc_tpu_torch import __version__
from iqc_tpu_torch.config import SystemConfig, load_config
from iqc_tpu_torch.serving.wsgi import App, Request, Response, html, jsonify

logger = logging.getLogger(__name__)

API_VERSION = "1.0.0"


def _now() -> str:
    return datetime.now().isoformat()


def _decode_image(data: bytes, target: int = 640) -> Optional[np.ndarray]:
    """JPEG through libjpeg with DCT-domain downscale toward ``target``, or
    an 8-bit PNG; None for anything else (``runtime/codec.py``)."""
    from iqc_tpu_torch.runtime.codec import decode_image

    return decode_image(data, target=target)


class RateLimiter:
    """Per-IP sliding-window limiter (routes.py:599-636), thread-safe."""

    def __init__(self, max_requests: int, window: float = 60.0):
        self.max_requests = max_requests
        self.window = window
        self._lock = threading.Lock()
        self._history: Dict[str, List[float]] = {}

    def allow(self, client_ip: str) -> bool:
        now = time.time()
        with self._lock:
            hist = [t for t in self._history.get(client_ip, []) if now - t < self.window]
            if len(hist) >= self.max_requests:
                self._history[client_ip] = hist
                return False
            hist.append(now)
            self._history[client_ip] = hist
            return True


class EventBroker:
    """Fan-out of detection_result/alert/status events to SSE subscribers
    (the Socket.IO event surface, app.py:238-261 / dashboard.html:395-418)."""

    def __init__(self, max_queue: int = 256):
        self._lock = threading.Lock()
        self._subscribers: List[queue.Queue] = []
        self.max_queue = max_queue

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(self.max_queue)
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def publish(self, event: str, data: Any) -> None:
        msg = (event, data)
        with self._lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(msg)
            except queue.Full:
                pass


class QualityControlSystem:
    """System orchestrator, parity with ``app.py:39-153``: config load,
    model init with demo-mode fallback, queue worker, and
    ``process_image`` chaining detector -> SPC -> anomaly score."""

    def __init__(self, config_path: Optional[str] = None,
                 config: Optional[SystemConfig] = None, device="cuda"):
        self.config = config or load_config(config_path)
        self.device = device
        self.detector = None
        self.spc_analyzer = None
        self.anomaly_detector = None
        self.is_processing = False
        self.processing_queue: queue.Queue = queue.Queue()
        self.results_queue: queue.Queue = queue.Queue()
        self.events = EventBroker()
        from iqc_tpu_torch.serving.alerts import AlertDispatcher

        # webhook / email / SMS alert delivery
        self.alert_dispatcher = AlertDispatcher(self.config.alerts)
        # result/image persistence (storage.py)
        self.result_store = None
        if self.config.storage.enabled:
            from iqc_tpu_torch.storage import ResultStore

            self.result_store = ResultStore(self.config.storage)
        # MES/ERP/QMS forwarding (integrations block of extra)
        from iqc_tpu_torch.serving.integrations import IntegrationForwarder

        self.integrations = IntegrationForwarder(
            (self.config.extra or {}).get("integrations")
        )
        self._workers: List[threading.Thread] = []
        self._worker_target = 0
        self._workers_lock = threading.Lock()
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # process-level autoscaling over the worker pool (serving/scaling.py)
        self.autoscaler = None

    # -- init (app.py:83-104) --------------------------------------------------

    def initialize_models(self) -> bool:
        try:
            from iqc_tpu_torch.analytics import AnomalyDetector, SPCAnalyzer
            from iqc_tpu_torch.inference.detector import QualityControlDetector

            self.detector = QualityControlDetector(config=self.config, device=self.device)
            self.spc_analyzer = SPCAnalyzer(
                window_size=self.config.spc.window_size,
                confidence_level=self.config.spc.confidence_level,
                config=self.config.spc,
            )
            self.anomaly_detector = AnomalyDetector()
            return True
        except Exception:
            # degraded "demo mode": the server starts, /health reports it
            logger.exception("model initialization failed; running in demo mode")
            self.detector = None
            return False

    # -- processing (app.py:123-153) --------------------------------------------

    def process_image(self, image: np.ndarray, metadata: Optional[Dict] = None) -> Dict:
        if self.detector is None:
            return {"error": "System not initialized (demo mode)"}
        if image.ndim == 1:
            decoded = _decode_image(image.tobytes())
            if decoded is None:
                return {"error": "Could not decode image"}
            image = decoded
        result = self.detector.predict(image)
        if "error" in result:
            return result
        if self.spc_analyzer is not None:
            result["spc_analysis"] = self.spc_analyzer.analyze(result)
            for alert in result["spc_analysis"].get("alerts", []):
                self.events.publish("alert", alert)
                self.alert_dispatcher.submit(alert)
        for alert in self._threshold_alerts(result):
            self.events.publish("alert", alert)
            self.alert_dispatcher.submit(alert)
        if self.anomaly_detector is not None:
            result["anomaly_score"] = self.anomaly_detector.detect(result)
        if metadata:
            result["metadata_in"] = metadata
        self._persist(result, image)
        self.events.publish(
            "detection_result",
            {
                "total_defects": len(result.get("detections", [])),
                "quality_grade": result.get("quality_assessment", {}).get("quality_grade"),
                "pass_fail": result.get("quality_assessment", {}).get("pass_fail_status"),
                "anomaly_score": result.get("anomaly_score", 0.0),
                "timestamp": _now(),
            },
        )
        return result

    def predict_batch(self, images: List[np.ndarray]) -> List[Dict]:
        if self.detector is None:
            return [{"error": "System not initialized (demo mode)"} for _ in images]
        results = self.detector.predict_batch(images)
        for r in results:
            if self.spc_analyzer is not None and "error" not in r:
                r["spc_analysis"] = self.spc_analyzer.analyze(r)
                for alert in r["spc_analysis"].get("alerts", []):
                    self.events.publish("alert", alert)
                    self.alert_dispatcher.submit(alert)
            if "error" not in r:
                for alert in self._threshold_alerts(r):
                    self.events.publish("alert", alert)
                    self.alert_dispatcher.submit(alert)
            if self.anomaly_detector is not None and "error" not in r:
                r["anomaly_score"] = self.anomaly_detector.detect(r)
            if "error" not in r:
                self._persist(r, None)
        return results

    def _persist(self, result: Dict, image) -> None:
        """Best-effort storage write + factory-system forwarding (never
        fails the inference path)."""
        if self.integrations.enabled:
            self.integrations.submit(result)
        if self.result_store is None:
            return
        try:
            self.result_store.save_result(result)
            if image is not None:
                failed = (result.get("quality_assessment", {})
                          .get("pass_fail_status") == "FAIL")
                self.result_store.save_image(image, failed)
        except Exception:
            logger.exception("result persistence failed")

    def _threshold_alerts(self, result: Dict) -> List[Dict]:
        """Reference alerts.thresholds rules (config.yaml:82-87) against one
        prediction; the rolling defect rate comes from the SPC window."""
        from iqc_tpu_torch.serving.alerts import threshold_alerts

        rate = None
        if self.spc_analyzer is not None:
            counts = self.spc_analyzer.series["defect_count"]
            if len(counts) >= 5:  # need some window before a rate alert
                rate = float(counts.values().mean())
        return threshold_alerts(result, self.config.alerts.thresholds,
                                defect_rate=rate)

    # -- worker: blocks on the id queue (the native C++ MPMC ring when
    # libiqc_runtime builds, a Python condition-variable queue otherwise) and
    # coalesces waiting requests into device batches ------------------------

    def start_processing_worker(self) -> None:
        if self._workers:
            return
        self._stop.clear()
        from iqc_tpu_torch.runtime import BatchQueue

        self._native_queue = BatchQueue(capacity=4096)
        self._pending: Dict[int, Dict] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0

        def pump():
            """Move requests from the public queue.Queue into the native
            coalescing queue (keeps the processing_queue API)."""
            while not self._stop.is_set():
                try:
                    item = self.processing_queue.get(timeout=0.25)
                except queue.Empty:
                    continue
                with self._pending_lock:
                    rid = self._next_id
                    self._next_id += 1
                    self._pending[rid] = item
                self._native_queue.push(rid)

        self._pump = threading.Thread(target=pump, daemon=True, name="qc-pump")
        self._pump.start()
        self.set_worker_count(max(1, self.config.scaling.min_instances
                                  if self.config.scaling.auto_scale else 1))
        if self.config.scaling.auto_scale:
            from iqc_tpu_torch.serving.scaling import AutoScaler

            self.autoscaler = AutoScaler(self.config.scaling,
                                         resize=self.set_worker_count,
                                         initial_instances=self.worker_count)
            self.autoscaler.start()

    def _worker_loop(self, idx: int) -> None:
        """One queue-draining worker. Several may run at once (the native
        queue's pop_batch is MPMC): while one worker's batch occupies the
        device program, the others overlap host-side decode/JSON/alert
        work. The worker retires itself when the pool shrinks below its
        index (set_worker_count)."""
        max_batch = self.config.processing.batch_size
        while not self._stop.is_set() and idx < self._worker_target:
            ids = self._native_queue.pop_batch(max_batch, timeout_ms=250.0)
            if not ids:
                continue
            with self._pending_lock:
                batch = [self._pending.pop(i) for i in ids]
            try:
                results = self.predict_batch([b["image"] for b in batch])
                for req, res in zip(batch, results):
                    res["request_id"] = req.get("request_id")
                    self.results_queue.put(res)
            except Exception as e:
                for req in batch:
                    self.results_queue.put(
                        {"error": str(e), "request_id": req.get("request_id")}
                    )

    @property
    def worker_count(self) -> int:
        with self._workers_lock:
            return sum(1 for t in self._workers if t.is_alive())

    def set_worker_count(self, n: int) -> int:
        """Resize the worker pool to ``n`` (the autoscaler's resize hook;
        also callable directly). Growing spawns threads immediately;
        shrinking retires the highest-index workers at their next queue
        poll (<= 250 ms). Returns the new target size."""
        n = max(1, int(n))
        with self._workers_lock:
            if self._stop.is_set():
                # a late autoscaler tick after stop_processing_worker must
                # not respawn workers against the closed queue
                return 0
            self._worker_target = n
            self._workers = [t for t in self._workers if t.is_alive()]
            for idx in range(len(self._workers), n):
                t = threading.Thread(target=self._worker_loop, args=(idx,),
                                     daemon=True, name=f"qc-worker-{idx}")
                self._workers.append(t)
                t.start()
        return n

    def stop_processing_worker(self) -> None:
        self._stop.set()
        if self.autoscaler is not None:
            self.autoscaler.close()
            self.autoscaler = None
        if getattr(self, "_native_queue", None) is not None:
            self._native_queue.close()
        with self._workers_lock:
            workers, self._workers = self._workers, []
            self._worker_target = 0
        for t in workers:
            t.join(timeout=2.0)
        if self._pump is not None:
            self._pump.join(timeout=2.0)
            self._pump = None

    def update_config(self, patch: Dict) -> None:
        self.config = self.config.update(patch)
        if self.detector is not None:
            self.detector.update_config(patch)
        # rebuild the subsystems that hold config by reference, else a
        # PUT /api/config touching alerts/storage/integrations is a
        # silent no-op on the running system
        if "alerts" in patch:
            self.alert_dispatcher.config = self.config.alerts
        if "storage" in patch:
            if self.config.storage.enabled and self.result_store is None:
                from iqc_tpu_torch.storage import ResultStore

                self.result_store = ResultStore(self.config.storage)
            elif not self.config.storage.enabled and self.result_store is not None:
                self.result_store.close()
                self.result_store = None
            elif self.result_store is not None:
                self.result_store.config = self.config.storage
        if "integrations" in patch:
            from iqc_tpu_torch.serving.integrations import IntegrationForwarder

            self.integrations.close()
            self.integrations = IntegrationForwarder(
                (self.config.extra or {}).get("integrations")
            )

    # passthroughs used by routes
    def get_system_info(self) -> Dict:
        return self.detector.get_system_info() if self.detector else {"detector_status": "demo_mode"}

    def get_performance_stats(self) -> Dict:
        return self.detector.get_performance_stats() if self.detector else {}

    def benchmark(self, images, iterations) -> Dict:
        return self.detector.benchmark(images, iterations) if self.detector else {"error": "demo mode"}

    @property
    def ensemble_predictor(self):
        return self.detector.ensemble_predictor if self.detector else None

    @property
    def segmentator(self):
        return self.detector.segmentator if self.detector else None

    @property
    def postprocessor(self):
        return self.detector.postprocessor if self.detector else None


# ---------------------------------------------------------------------------
# App factory
# ---------------------------------------------------------------------------


def create_app(qc_system: Optional[QualityControlSystem] = None,
               config_path: Optional[str] = None,
               initialize: bool = True, device="cuda") -> App:
    """The WSGI app over ``qc_system``, or over a new system from
    ``config_path`` on ``device``; with ``initialize`` the models are built
    and the queue workers started where the system has no detector yet."""
    system = qc_system or QualityControlSystem(config_path, device=device)
    if initialize and system.detector is None:
        system.initialize_models()
        system.start_processing_worker()

    app = App("iqc_tpu_torch")
    app.qc_system = system

    api_cfg = system.config.api
    # Rate limiting rides the C++ striped-lock limiter when the native
    # runtime builds (runtime/cpp/iqc_runtime.cc:96-117); NativeRateLimiter
    # degrades to the pure-Python RateLimiter automatically.
    from iqc_tpu_torch.runtime.native import NativeRateLimiter

    detect_limiter = NativeRateLimiter(50 if api_cfg.rate_limit_enabled else 10**9)
    batch_limiter = NativeRateLimiter(10 if api_cfg.rate_limit_enabled else 10**9)

    def limited(limiter, req: Request) -> Optional[Response]:
        if not limiter.allow(req.remote_addr or "local"):
            return jsonify(
                {
                    "error": "Rate limit exceeded",
                    "message": f"Maximum {limiter.max_requests} requests per {int(limiter.window)} seconds",
                    "api_version": API_VERSION,
                    "timestamp": _now(),
                },
                429,
            )
        return None

    if api_cfg.cors_enabled:
        # allow-origin headers on every response + OPTIONS preflight
        def cors_preflight(req: Request) -> Optional[Response]:
            if req.method == "OPTIONS":
                return Response(b"", status=204)
            return None

        def cors_headers(req: Request, resp: Response) -> None:
            resp.headers.extend(
                [
                    ("Access-Control-Allow-Origin", "*"),
                    ("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE, OPTIONS"),
                    ("Access-Control-Allow-Headers", "Content-Type, Authorization"),
                ]
            )

        app.before_request.append(cors_preflight)
        app.after_request.append(cors_headers)

    if api_cfg.auth_enabled:
        # Static API-key check. Keys ride the X-API-Key header or
        # "Authorization: Bearer <key>". /health stays open for container
        # healthchecks.
        valid_keys = frozenset(api_cfg.api_keys)

        # Only the dashboard page and healthchecks stay public: the control
        # surface (/realtime/*) and the event feed (/events) carry live
        # production data and must be behind the key too, not just /api/*.
        public_paths = frozenset(("/", "/health", "/api/health"))

        def require_api_key(req: Request) -> Optional[Response]:
            path = req.path or ""
            if req.method == "OPTIONS" or path in public_paths:
                return None
            key = req.header("X-API-Key")
            if not key:
                auth_hdr = req.header("Authorization")
                if auth_hdr.lower().startswith("bearer "):
                    key = auth_hdr[7:].strip()
            if not key:
                # EventSource/WebSocket clients cannot set headers
                key = req.query.get("api_key", "")
            if key and key in valid_keys:
                return None
            return jsonify(
                {"error": "Unauthorized", "message": "valid API key required",
                 "api_version": API_VERSION, "timestamp": _now()},
                401,
            )

        app.before_request.append(require_api_key)

        def ws_auth(headers, path: str) -> bool:
            # the /ws handshake is dispatched pre-WSGI (wsgi.py handle()),
            # so before_request never runs for it
            key = headers.get("X-API-Key") or ""
            if not key:
                ah = headers.get("Authorization", "")
                if ah.lower().startswith("bearer "):
                    key = ah[7:].strip()
            if not key:
                from urllib.parse import parse_qs, urlsplit

                key = (parse_qs(urlsplit(path).query).get("api_key")
                       or [""])[0]
            return key in valid_keys

        app.ws_auth = ws_auth

    # -- inline routes (app.py:164-236) ----------------------------------------

    @app.route("/")
    def index(req: Request):
        from iqc_tpu_torch.serving.dashboard import DASHBOARD_HTML

        return html(DASHBOARD_HTML)

    @app.route("/health")
    def health(req: Request):
        return jsonify(
            {
                "status": "healthy",
                "timestamp": _now(),
                "models_loaded": system.detector is not None,
            }
        )

    def _detect_from_files(req: Request):
        entry = req.file("image") or req.file("file")
        if entry is None:
            return jsonify({"error": "No image provided"}, 400)
        filename, data = entry
        if not filename:
            return jsonify({"error": "No file selected"}, 400)
        image = _decode_image(data)
        if image is None:
            return jsonify({"error": "Could not decode image"}, 400)
        result = system.process_image(image, {"filename": filename})
        status = 500 if "error" in result else 200
        return jsonify(result, status)

    @app.route("/api/detect", methods=("POST",))
    def detect_single(req: Request):
        early = limited(detect_limiter, req)
        if early:
            return early
        return _detect_from_files(req)

    @app.route("/api/batch_detect", methods=("POST",))
    @app.route("/api/detect/batch", methods=("POST",))
    def detect_batch(req: Request):
        early = limited(batch_limiter, req)
        if early:
            return early
        entries = req.files.get("images") or req.files.get("files") or []
        if not entries:
            return jsonify({"error": "No images provided"}, 400)
        images, names = [], []
        for filename, data in entries:
            img = _decode_image(data)
            if img is not None:
                images.append(img)
                names.append(filename)
        if not images:
            return jsonify({"error": "No valid images provided"}, 400)
        results = system.predict_batch(images)
        for name, r in zip(names, results):
            r["filename"] = name
        return jsonify({"batch_results": results, "total_processed": len(results)})

    @app.route("/api/stats")
    def stats(req: Request):
        return jsonify(
            {
                "system_status": "operational",
                "models_loaded": system.detector is not None,
                "queue_size": system.processing_queue.qsize(),
                "timestamp": _now(),
            }
        )

    @app.route("/api/results")
    def results_history(req: Request):
        """Prediction history from the storage layer."""
        if system.result_store is None:
            return jsonify({"error": "storage disabled",
                            "hint": "set storage.enabled: true"}, status=503)
        try:
            since = req.query.get("since")
            limit = int(req.query.get("limit", "100"))
            pf = req.query.get("pass_fail")
            if pf is not None and pf not in ("PASS", "FAIL", "CONDITIONAL"):
                return jsonify({"error": "pass_fail must be PASS/FAIL/"
                                "CONDITIONAL"}, status=400)
            rows = system.result_store.query(
                since=float(since) if since else None, limit=limit,
                pass_fail=pf,
            )
        except ValueError:
            return jsonify({"error": "invalid query parameter"}, status=400)
        return jsonify({"results": rows, "count": len(rows),
                        "timestamp": _now()})

    @app.route("/api/results/summary")
    def results_summary(req: Request):
        if system.result_store is None:
            return jsonify({"error": "storage disabled",
                            "hint": "set storage.enabled: true"}, status=503)
        return jsonify({**system.result_store.summary(),
                        "timestamp": _now()})

    # -- blueprint routes (api/routes.py) -----------------------------------------

    @app.route("/api/detect/zip", methods=("POST",))
    def detect_zip(req: Request):
        entry = req.file("zip_file")
        if entry is None:
            return jsonify({"error": "No ZIP file provided"}, 400)
        filename, data = entry
        if not filename:
            return jsonify({"error": "No file selected"}, 400)
        images, names = [], []
        try:
            with zipfile.ZipFile(io.BytesIO(data)) as zf:
                for info in zf.infolist():
                    if info.filename.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                        img = _decode_image(zf.read(info))
                        if img is not None:
                            images.append(img)
                            names.append(info.filename)
        except zipfile.BadZipFile:
            return jsonify({"error": "Invalid ZIP file"}, 400)
        if not images:
            return jsonify({"error": "No valid images found in ZIP file"}, 400)
        results = system.predict_batch(images)
        for name, r in zip(names, results):
            r["filename"] = name
        return jsonify(
            {
                "batch_results": results,
                "total_processed": len(results),
                "source_zip": filename,
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/detect/base64", methods=("POST",))
    def detect_base64(req: Request):
        data = req.json()
        if not data or "image" not in data:
            return jsonify({"error": "No base64 image data provided"}, 400)
        try:
            raw = base64.b64decode(data["image"])
        except Exception as e:
            return jsonify({"error": f"Invalid base64 image data: {e}"}, 400)
        image = _decode_image(raw)
        if image is None:
            return jsonify({"error": "Could not decode image"}, 400)
        result = system.process_image(image)
        result.update(
            {"api_version": API_VERSION, "timestamp": _now(), "input_format": "base64"}
        )
        return jsonify(result, 500 if "error" in result else 200)

    @app.route("/api/models/info")
    def models_info(req: Request):
        return jsonify(
            {
                "model_info": system.get_system_info(),
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/models/performance")
    def models_performance(req: Request):
        return jsonify(
            {
                "performance_stats": system.get_performance_stats(),
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/models/benchmark", methods=("POST",))
    def models_benchmark(req: Request):
        # rate-limited + clamped: unbounded num_images/image_size from an
        # unauthenticated POST would allocate arbitrary host memory and
        # monopolize the card
        early = limited(batch_limiter, req)
        if early:
            return early
        data = req.json() or {}
        try:
            cap = max(int(system.config.processing.batch_size), 1)
            num_images = max(1, min(int(data.get("num_images", 10)), cap, 16))
            iterations = max(1, min(int(data.get("iterations", 3)), 3))
            image_size = data.get(
                "image_size", list(system.config.processing.input_size)
            )
            if not isinstance(image_size, (list, tuple)) or len(image_size) != 2:
                raise ValueError("image_size must be [height, width]")
            image_size = [max(32, min(int(s), 1024)) for s in image_size]
        except (TypeError, ValueError) as e:
            return jsonify({"error": f"Invalid benchmark parameters: {e}"}, 400)
        rng = np.random.default_rng(0)
        test_images = [
            rng.integers(0, 255, (*image_size, 3), dtype=np.uint8)
            for _ in range(num_images)
        ]
        return jsonify(
            {
                "benchmark_results": system.benchmark(test_images, iterations),
                "test_parameters": {
                    "num_images": num_images,
                    "iterations": iterations,
                    "image_size": image_size,
                },
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/config", methods=("GET", "PUT"))
    def config_route(req: Request):
        if req.method == "GET":
            safe = system.config.to_dict()
            alerts = safe.get("alerts")
            if isinstance(alerts, dict) and "email" in alerts:
                alerts["email"] = {"enabled": True}  # hide credentials
            return jsonify(
                {"config": safe, "api_version": API_VERSION, "timestamp": _now()}
            )
        data = req.json()
        if not data:
            return jsonify({"error": "No configuration data provided"}, 400)
        try:
            system.update_config(data)
        except ValueError as e:
            return jsonify({"error": f"Invalid configuration: {e}"}, 400)
        return jsonify(
            {
                "message": "Configuration updated successfully",
                "updated_fields": list(data.keys()),
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/thresholds", methods=("GET", "PUT"))
    def thresholds_route(req: Request):
        ens = system.ensemble_predictor
        if req.method == "GET":
            return jsonify(
                {
                    "thresholds": {
                        "confidence_threshold": ens.confidence_threshold if ens else None,
                        "nms_threshold": ens.nms_threshold if ens else None,
                        "quality_thresholds": system.config.to_dict()["quality_control"]["thresholds"],
                    },
                    "api_version": API_VERSION,
                    "timestamp": _now(),
                }
            )
        data = req.json()
        if not data:
            return jsonify({"error": "No threshold data provided"}, 400)
        if ens is not None:
            if "confidence_threshold" in data:
                ens.confidence_threshold = float(data["confidence_threshold"])
            if "nms_threshold" in data:
                ens.nms_threshold = float(data["nms_threshold"])
        return jsonify(
            {
                "message": "Thresholds updated successfully",
                "updated_thresholds": data,
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/spc/analyze", methods=("POST",))
    def spc_analyze(req: Request):
        data = req.json()
        if not data or "detection_results" not in data:
            return jsonify({"error": "No detection results provided"}, 400)
        if system.spc_analyzer is None:
            return jsonify({"error": "SPC analyzer not available"}, 500)
        return jsonify(
            {
                "spc_analysis": system.spc_analyzer.analyze(data["detection_results"]),
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/spc/export", methods=("POST",))
    def spc_export(req: Request):
        data = req.json() or {}
        requested = data.get(
            "output_path",
            f"spc_report_{datetime.now().strftime('%Y%m%d_%H%M%S')}.json",
        )
        # Writes are confined to api.reports_dir.
        reports_dir = os.path.abspath(system.config.api.reports_dir or "reports")
        name = str(requested)
        if os.path.isabs(name) or ".." in name.replace("\\", "/").split("/"):
            return jsonify(
                {"error": "Invalid output_path",
                 "message": "output_path must be relative and inside the "
                            "configured reports directory"},
                400,
            )
        out_path = os.path.normpath(os.path.join(reports_dir, name))
        if not (out_path + os.sep).startswith(reports_dir + os.sep):
            return jsonify({"error": "Invalid output_path"}, 400)
        if system.spc_analyzer is None:
            return jsonify({"error": "SPC analyzer not available"}, 500)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        if system.spc_analyzer.export_spc_report(out_path):
            return jsonify(
                {
                    "message": "SPC report exported successfully",
                    "output_path": out_path,
                    "api_version": API_VERSION,
                    "timestamp": _now(),
                }
            )
        return jsonify({"error": "Failed to export SPC report"}, 500)

    @app.route("/api/quality/rules")
    def quality_rules(req: Request):
        return jsonify(
            {
                "quality_rules": system.config.to_dict()["quality_control"],
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/quality/assess", methods=("POST",))
    def quality_assess(req: Request):
        data = req.json()
        if not data or "detections" not in data:
            return jsonify({"error": "No detection data provided"}, 400)
        detections = data["detections"]
        counts = {"critical": 0, "major": 0, "minor": 0}
        for d in detections:
            counts[d.get("severity", "minor")] += 1
        if system.postprocessor is not None:
            grade, status_s, _risk = system.postprocessor.quality_rules(counts)
        else:
            grade, status_s = "A", "PASS"
        return jsonify(
            {
                "quality_assessment": {
                    "quality_grade": grade,
                    "pass_fail_status": status_s,
                    "total_defects": len(detections),
                    "severity_breakdown": counts,
                    "meets_requirements": status_s == "PASS",
                },
                "api_version": API_VERSION,
                "timestamp": _now(),
            }
        )

    @app.route("/api/health")
    def api_health(req: Request):
        components = {
            "ensemble_predictor": system.ensemble_predictor is not None,
            "segmentator": system.segmentator is not None,
            "postprocessor": system.postprocessor is not None,
        }
        healthy = all(components.values())
        ens = system.ensemble_predictor
        payload = {
            "status": "healthy" if healthy else "unhealthy",
            "components": components,
            "performance": system.get_performance_stats(),
            "timestamp": _now(),
            "api_version": API_VERSION,
        }
        if ens is not None:
            # never silently serve randomly-initialized weights
            payload["weights_source"] = dict(getattr(ens, "weights_source", {}))
            payload["untrained_weights"] = any(
                v != "checkpoint" for v in payload["weights_source"].values()
            )
        return jsonify(payload, 200 if healthy else 503)

    @app.route("/api/version")
    def version(req: Request):
        return jsonify(
            {
                "api_version": API_VERSION,
                "framework_version": __version__,
                "system_name": "Industrial Quality Control Computer Vision System (PyTorch/CUDA)",
                "description": "Multi-class defect detection, PyTorch pipeline with CUDA kernels",
                "features": [
                    "YOLOv8 object detection (PyTorch, CUDA NMS suppression kernel)",
                    "ResNet-50 classification (real per-crop ensemble)",
                    "Batched inference on an NVIDIA GPU",
                    "Statistical Process Control",
                    "CUDA morphology kernels for defect segmentation",
                    "Automated anomaly detection",
                ],
                "timestamp": _now(),
            }
        )

    # -- realtime (SSE replacement for Socket.IO, app.py:238-261) -------------------

    @app.route("/events")
    def events(req: Request):
        sub = system.events.subscribe()
        max_events = int(req.query.get("max", "100"))
        timeout = float(req.query.get("timeout", "30"))

        def stream():
            deadline = time.time() + timeout
            sent = 0
            yield b"event: status\ndata: {\"message\": \"Connected to QC System\"}\n\n"
            try:
                while sent < max_events and time.time() < deadline:
                    try:
                        event, data = sub.get(
                            timeout=min(1.0, max(deadline - time.time(), 0.001))
                        )
                    except queue.Empty:
                        # SSE comment keeps idle connections alive through
                        # proxies without emitting a client-visible event
                        yield b": keepalive\n\n"
                        continue
                    payload = json.dumps(data, default=str)
                    yield f"event: {event}\ndata: {payload}\n\n".encode()
                    sent += 1
            finally:
                system.events.unsubscribe(sub)

        # a live stream: events reach the client as they are published
        return Response(
            stream(),
            content_type="text/event-stream",
            headers=[("Cache-Control", "no-cache"), ("X-Accel-Buffering", "no")],
        )

    @app.websocket("/ws")
    def ws_feed(ws, req: Request):
        """Bidirectional realtime channel: the server
        pushes status/detection_result/alert events; the client emits
        start_realtime/stop_realtime (and ping) as JSON text frames.
        Unlike the bounded SSE stream, the connection is persistent."""
        sub = system.events.subscribe()
        forward = {"on": True}  # streams from the moment of connecting
        ws.send_json({"event": "status",
                      "data": {"message": "Connected to QC System"}})
        try:
            while ws.open:
                msg = ws.recv(timeout=0.25)
                if msg is not None and isinstance(msg, str):
                    try:
                        evt = json.loads(msg).get("event", "")
                    except ValueError:
                        evt = ""
                    if evt == "start_realtime":
                        forward["on"] = True
                        system.is_processing = True
                        ws.send_json({"event": "status",
                                      "data": {"message":
                                               "Real-time processing started"}})
                    elif evt == "stop_realtime":
                        forward["on"] = False
                        system.is_processing = False
                        ws.send_json({"event": "status",
                                      "data": {"message":
                                               "Real-time processing stopped"}})
                    elif evt == "ping":
                        ws.send_json({"event": "pong", "data": {"ts": _now()}})
                while True:  # drain pending broker events
                    try:
                        event, data = sub.get_nowait()
                    except queue.Empty:
                        break
                    if forward["on"]:
                        ws.send_json({"event": event, "data": data})
        finally:
            system.events.unsubscribe(sub)

    @app.route("/realtime/start", methods=("POST",))
    def realtime_start(req: Request):
        system.is_processing = True
        system.events.publish("status", {"message": "Real-time processing started"})
        return jsonify({"message": "Real-time processing started"})

    @app.route("/realtime/stop", methods=("POST",))
    def realtime_stop(req: Request):
        system.is_processing = False
        system.events.publish("status", {"message": "Real-time processing stopped"})
        return jsonify({"message": "Real-time processing stopped"})

    # -- error handlers (routes.py:568-593) ----------------------------------------

    @app.errorhandler(400)
    def bad_request(msg):
        return jsonify(
            {
                "error": "Bad request",
                "message": msg or "Invalid request format or parameters",
                "api_version": API_VERSION,
                "timestamp": _now(),
            },
            400,
        )

    @app.errorhandler(404)
    def not_found(msg):
        return jsonify(
            {
                "error": "Not found",
                "message": "API endpoint not found",
                "api_version": API_VERSION,
                "timestamp": _now(),
            },
            404,
        )

    @app.errorhandler(500)
    def internal(msg):
        return jsonify(
            {
                "error": "Internal server error",
                "message": msg or "An unexpected error occurred",
                "api_version": API_VERSION,
                "timestamp": _now(),
            },
            500,
        )

    return app


def _supervise_workers(args, workers: int) -> None:  # pragma: no cover
    """Preforked-worker supervisor: spawn N independent worker processes
    bound to the same port via SO_REUSEPORT, restart any that die. Each
    worker loads its own models. For CPU-only and demo deployments: on a
    card, one process serves (see serving/wsgi.py serve docstring)."""
    import signal
    import subprocess
    import sys

    base_metrics = args.metrics_port or 9090
    cmds = []
    for i in range(workers):
        cmd = [sys.executable, "-m", "iqc_tpu_torch.serving.app", "--workers", "1",
               "--reuse-port", "--metrics-port", str(base_metrics + i),
               "--device", args.device]
        if args.config:
            cmd += ["--config", args.config]
        if args.host:
            cmd += ["--host", args.host]
        if args.port:
            cmd += ["--port", str(args.port)]
        cmds.append(cmd)
    procs = [subprocess.Popen(c) for c in cmds]
    stopping = []

    def stop(signum, frame):
        stopping.append(True)
        for p in procs:
            p.terminate()

    signal.signal(signal.SIGTERM, stop)
    try:
        while not stopping:
            for i, p in enumerate(procs):
                code = p.poll()
                if code is not None and not stopping:
                    logger.warning("worker %d exited (%s); restarting", i, code)
                    procs[i] = subprocess.Popen(cmds[i])
            time.sleep(1.0)
    except KeyboardInterrupt:
        stop(None, None)
    for p in procs:
        p.wait()


def main() -> None:  # pragma: no cover
    import argparse

    parser = argparse.ArgumentParser(description="IQC serving app (PyTorch/CUDA port)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--metrics-port", type=int, default=None)
    parser.add_argument(
        "--workers", type=int, default=1,
        help="preforked SO_REUSEPORT worker processes (gunicorn-x4 parity). "
             "Keep 1 on a card: one process owns it; concurrency comes "
             "from the threaded server + batch-coalescing queue.",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the models (cuda, cuda:N or cpu)")
    parser.add_argument("--reuse-port", action="store_true",
                        help="bind with SO_REUSEPORT (set by the supervisor)")
    args = parser.parse_args()

    if args.workers > 1:
        _supervise_workers(args, args.workers)
        return

    system = QualityControlSystem(args.config, device=args.device)
    from iqc_tpu_torch.utils.logging_config import configure_from_config

    configure_from_config(system.config.extra)
    os.makedirs("logs", exist_ok=True)
    system.initialize_models()
    system.start_processing_worker()
    app = create_app(system, initialize=False)

    from iqc_tpu_torch.serving.metrics import start_metrics_server
    from iqc_tpu_torch.serving.wsgi import serve

    start_metrics_server(system, port=args.metrics_port or system.config.api.metrics_port)
    api_cfg = system.config.api
    serve(app, host=args.host or api_cfg.host,
          port=args.port or api_cfg.port,
          reuse_port=args.reuse_port,
          ssl_cert=api_cfg.ssl_cert if api_cfg.ssl_enabled else None,
          ssl_key=api_cfg.ssl_key if api_cfg.ssl_enabled else None)


if __name__ == "__main__":  # pragma: no cover
    main()
