"""The port's HTTP serving layer against the JAX package's.

Both apps wrap their package's ``QualityControlSystem``, built by
``initialize_models`` on the configuration of ``test_torch_slice.py``'s
detectors (the shipped YOLOv8n checkpoint at 128^2; the JAX package's tiny
ResNet weights carried into the port with ``load_into``; ``device="cpu"``).
One WSGI helper (a copy of ``tests/test_serving.py``'s) drives both through
the same requests: ``/health``, ``/api/detect`` (multipart JPEG and PNG),
``/api/detect/batch``, ``/api/detect/base64``, ``/api/detect/zip``,
``/api/config`` GET/PUT, ``/api/thresholds``, ``/api/spc/analyze``,
``/api/quality/assess``, ``/api/models/info`` and the 400/404/405 answers;
then demo mode, API-key auth and the rate limiter, and one frame over a real
socket to the port's own server.

The two apps give EQUAL status codes and equal bodies under
``test_torch_slice._compare_results`` (floats within 1e-4 relative; classes,
severities and grades EQUAL; pixel boxes within 1 px), with timings,
timestamps and device strings removed. One stated exception: the
``segmentation_confidence`` of a detection segmented by the watershed method
(class "dent") within 1e-3 absolute. That confidence is
0.5 / (1 + |markers - 3|) + 0.5 * coverage score, where a marker is a pixel
of the blurred ROI within 1e-7 of its 3x3 minimum; the port's blur rounds
differently from XLA's, so one marker can flip. Measured: 7.2e-5 on one
detection of the zip request (one marker), masks equal on 100% of pixels. Where a body holds the configuration
or the model report, the port's keys are compared (the JAX package's
configuration has more fields), with the precision fields aside: the port
serves float32.
"""

import base64
import copy
import io
import json
import urllib.request
import zipfile

import pytest
from PIL import Image
from test_torch_slice import THRESHOLD, YOLO_CKPT, SIZE, _compare_results, _host, _images

from iqc_tpu.serving.app import QualityControlSystem as JaxSystem
from iqc_tpu.serving.app import create_app as jax_create_app
from iqc_tpu_torch.config import DEFECT_CLASSES, SystemConfig
from iqc_tpu_torch.ops.segmentation import CLASS_TO_METHOD
from iqc_tpu_torch.serving.app import QualityControlSystem, create_app
from iqc_tpu_torch.serving.wsgi import serve
from iqc_tpu_torch.weights import load_into

# keys whose values are wall-clock times or device names (and every key
# that names a timestamp)
VOLATILE = {"total_inference_time_ms", "stage_times_ms", "batch_statistics",
            "time_span_hours", "devices", "device", "total_time",
            "average_time", "average_time_ms", "total_time_minutes",
            "throughput_images_per_second", "latency_percentiles_ms"}
PRECISION = {("edge", "precision"), ("serving_precision",), ("precision_report",)}
WATERSHED_CLASSES = {c for c, m in zip(DEFECT_CLASSES, CLASS_TO_METHOD) if m == 2}
WATERSHED_CONF_ATOL = 1e-3


def wsgi_call(app, method, path, body=b"", content_type="", query="", headers=None):
    """Drive the WSGI app directly (no socket); returns (status, json)."""
    environ = {
        "REQUEST_METHOD": method,
        "PATH_INFO": path,
        "QUERY_STRING": query,
        "CONTENT_TYPE": content_type,
        "CONTENT_LENGTH": str(len(body)),
        "REMOTE_ADDR": "127.0.0.1",
        "wsgi.input": io.BytesIO(body),
    }
    environ.update(headers or {})
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])
        captured["headers"] = headers

    chunks = app(environ, start_response)
    raw = b"".join(chunks)
    try:
        data = json.loads(raw)
    except ValueError:
        data = raw
    return captured["status"], data


def multipart(fields):
    """fields: list of (name, filename_or_None, bytes_or_str)."""
    boundary = "testboundary123"
    out = io.BytesIO()
    for name, filename, content in fields:
        out.write(f"--{boundary}\r\n".encode())
        if filename:
            out.write(f'Content-Disposition: form-data; name="{name}"; '
                      f'filename="{filename}"\r\n\r\n'.encode())
        else:
            out.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
        out.write(content if isinstance(content, bytes) else content.encode())
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def encoded(seed, fmt="JPEG"):
    buf = io.BytesIO()
    Image.fromarray(_images(seed, 1)[0]).save(buf, fmt)
    return buf.getvalue()


def _volatile(key):
    return key in VOLATILE or "timestamp" in key


def _scrub(x):
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if not _volatile(k)}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    return x


def _watershed_aligned(got, want):
    """``got`` with the segmentation_confidence of each watershed detection
    replaced by ``want``'s, once it is within WATERSHED_CONF_ATOL of it."""
    if isinstance(want, dict) and isinstance(got, dict):
        got = {k: _watershed_aligned(got[k], want[k]) if k in want else v
               for k, v in got.items()}
        if want.get("class") in WATERSHED_CLASSES and "segmentation_confidence" in want:
            g, w = got.get("segmentation_confidence"), want["segmentation_confidence"]
            assert abs(g - w) <= WATERSHED_CONF_ATOL, (g, w)
            got["segmentation_confidence"] = w
        return got
    if isinstance(want, list) and isinstance(got, list) and len(got) == len(want):
        return [_watershed_aligned(g, w) for g, w in zip(got, want)]
    return got


def _port_keys_equal(got, want, path=()):
    """Every key of ``got`` is in ``want`` with an equal value (the
    precision fields aside)."""
    for k, v in got.items():
        key = path + (k,)
        if key in PRECISION or key[-1:] in PRECISION or _volatile(k):
            continue
        assert k in want, key
        if isinstance(v, dict) and isinstance(want[k], dict):
            _port_keys_equal(v, want[k], key)
        else:
            assert v == want[k], (key, v, want[k])


def _same(apps, method, path, body=b"", ctype="", **kw):
    """Send one request to both apps; assert equal status and body."""
    japp, tapp = apps
    ws, wd = wsgi_call(japp, method, path, body, ctype, **kw)
    gs, gd = wsgi_call(tapp, method, path, body, ctype, **kw)
    assert gs == ws, (path, gs, ws, gd, wd)
    if isinstance(wd, dict):
        _compare_results(_watershed_aligned(_scrub(gd), _scrub(wd)), _scrub(wd))
    else:
        assert gd == wd
    return gs, gd, wd


@pytest.fixture(scope="module")
def systems(tiny_config):
    raw = tiny_config.to_dict()
    raw["model"].update(yolo_weights=YOLO_CKPT, width_mult=0.25, confidence_threshold=THRESHOLD)
    raw["processing"].update(input_size=[SIZE, SIZE], preprocessing={"resize": [SIZE, SIZE]})
    raw["quality_control"]["thresholds"].update(confidence_threshold=0.0,
                                                area_threshold_percent=1000.0)
    js = JaxSystem(config=type(tiny_config).from_dict(copy.deepcopy(raw)))
    assert js.initialize_models()
    # the JAX block's edge fields (max_batch_size, the int8 walk flags) with
    # the precision the port serves here
    raw["edge"] = dict(raw["edge"], precision="fp32")
    ts = QualityControlSystem(config=SystemConfig.from_dict(raw), device="cpu")
    assert ts.device == "cpu" and ts.initialize_models()
    assert ts.detector.device.type == "cpu"
    load_into(ts.detector.ensemble_predictor.resnet,
              _host(js.detector.ensemble_predictor.resnet_vars))
    yield js, ts
    for s in (js, ts):
        s.stop_processing_worker()


def _fresh(system, cls):
    """A new system of ``cls`` on ``system``'s models with fresh SPC and
    anomaly state, so that every test starts both apps from the same state."""
    s = cls(config=system.config, **({"device": "cpu"} if cls is QualityControlSystem else {}))
    s.detector = system.detector
    s.spc_analyzer = type(system.spc_analyzer)(
        window_size=s.config.spc.window_size, confidence_level=s.config.spc.confidence_level,
        config=s.config.spc)
    s.anomaly_detector = type(system.anomaly_detector)()
    return s


@pytest.fixture
def apps(systems):
    js, ts = systems
    return (jax_create_app(_fresh(js, JaxSystem), initialize=False),
            create_app(_fresh(ts, QualityControlSystem), initialize=False))


def test_health_and_single_detect(apps):
    _, body, _ = _same(apps, "GET", "/health")
    assert body["models_loaded"] is True
    for seed, fmt, name in ((1, "JPEG", "a.jpg"), (2, "PNG", "b.png"), (1, "JPEG", "a.jpg")):
        payload, ctype = multipart([("image", name, encoded(seed, fmt))])
        status, body, _ = _same(apps, "POST", "/api/detect", payload, ctype)
        assert status == 200 and body["detections"]
        assert body["metadata_in"] == {"filename": name}
        assert {"spc_analysis", "anomaly_score", "quality_assessment"} <= set(body)


def test_batch_zip_and_base64(apps):
    payload, ctype = multipart([("images", "a.jpg", encoded(3)), ("images", "b.png", encoded(4, "PNG")),
                                ("images", "c.txt", b"not an image")])
    _, body, _ = _same(apps, "POST", "/api/detect/batch", payload, ctype)
    assert body["total_processed"] == 2
    assert [r["filename"] for r in body["batch_results"]] == ["a.jpg", "b.png"]
    zbuf = io.BytesIO()
    with zipfile.ZipFile(zbuf, "w") as zf:
        zf.writestr("one.jpg", encoded(5))
        zf.writestr("two.png", encoded(6, "PNG"))
        zf.writestr("skip.txt", b"not an image")
    payload, ctype = multipart([("zip_file", "imgs.zip", zbuf.getvalue())])
    _, body, _ = _same(apps, "POST", "/api/detect/zip", payload, ctype)
    assert body["total_processed"] == 2 and body["source_zip"] == "imgs.zip"
    payload = json.dumps({"image": base64.b64encode(encoded(7)).decode()}).encode()
    _, body, _ = _same(apps, "POST", "/api/detect/base64", payload, "application/json")
    assert body["input_format"] == "base64" and body["detections"]


def test_bad_requests(apps):
    answers = []
    for method, path, payload, ctype in (
        ("POST", "/api/detect", b"", ""),
        ("POST", "/api/detect", *multipart([("image", "x.jpg", b"not an image")])),
        ("POST", "/api/detect", *multipart([("image", "", encoded(1))])),
        ("POST", "/api/detect/batch", b"", ""),
        ("POST", "/api/detect/batch", *multipart([("images", "x.jpg", b"garbage")])),
        ("POST", "/api/detect/zip", *multipart([("zip_file", "z.zip", b"not a zip")])),
        ("POST", "/api/detect/base64", b"{}", "application/json"),
        ("POST", "/api/detect/base64", b'{"image": "!!!"}', "application/json"),
        ("POST", "/api/detect/base64", json.dumps({"image": base64.b64encode(b"x").decode()}).encode(),
         "application/json"),
        ("PUT", "/api/config", b"", "application/json"),
        ("PUT", "/api/config", b'{"model": {"confidence_threshold": 7}}', "application/json"),
        ("PUT", "/api/config", b'{"qc_specific": {"class_weights": {"crack": -1.0}}}',
         "application/json"),
        ("POST", "/api/spc/analyze", b"{}", "application/json"),
        ("POST", "/api/quality/assess", b"{}", "application/json"),
        ("GET", "/api/nonexistent", b"", ""),
        ("GET", "/api/detect", b"", ""),
        ("DELETE", "/api/config", b"", ""),
    ):
        status, _, _ = _same(apps, method, path, payload, ctype)
        answers.append(status)
    assert answers == [400] * 14 + [404, 405, 405]


def test_config_and_thresholds(apps, systems):
    japp, tapp = apps
    (ws, wd), (gs, gd) = (wsgi_call(a, "GET", "/api/config") for a in apps)
    assert gs == ws == 200
    _port_keys_equal(gd["config"], wd["config"])
    _port_keys_equal(wd["config"], gd["config"])  # and every key of the reference in the port
    frame = multipart([("image", "a.jpg", encoded(8))])
    try:
        patch = json.dumps({"model": {"confidence_threshold": 0.3},
                            "quality_control": {"thresholds": {"minor_defect_limit": 1}}})
        _, body, _ = _same(apps, "PUT", "/api/config", patch.encode(), "application/json")
        assert body["updated_fields"] == ["model", "quality_control"]
        for app in apps:
            assert app.qc_system.ensemble_predictor.confidence_threshold == 0.3
        (_, wd), (_, gd) = (wsgi_call(a, "GET", "/api/config") for a in apps)
        _port_keys_equal(gd["config"], wd["config"])
        _same(apps, "POST", "/api/detect", *frame)
        _, body, _ = _same(apps, "GET", "/api/thresholds")
        assert body["thresholds"]["confidence_threshold"] == 0.3
        patch = json.dumps({"confidence_threshold": 0.1, "nms_threshold": 0.45}).encode()
        _same(apps, "PUT", "/api/thresholds", patch, "application/json")
        assert tapp.qc_system.ensemble_predictor.nms_threshold == 0.45
        _, body, _ = _same(apps, "POST", "/api/detect", *frame)
        assert body["detections"]
    finally:
        restore = {"model": {"confidence_threshold": THRESHOLD, "nms_threshold": 0.5},
                   "quality_control": {"thresholds": {"minor_defect_limit": 3}}}
        for s in systems:
            s.update_config(copy.deepcopy(restore))


def test_spc_quality_and_models_info(apps):
    payload, ctype = multipart([("image", "a.jpg", encoded(9))])
    _, body, _ = _same(apps, "POST", "/api/detect", payload, ctype)
    for _ in range(3):
        payload = json.dumps({"detection_results": {"detections": body["detections"]}}).encode()
        _, spc, _ = _same(apps, "POST", "/api/spc/analyze", payload, "application/json")
        assert spc["spc_analysis"]["current_metrics"]["defect_count"] == len(body["detections"])
    detections = [{"severity": d["final_severity"]} for d in body["detections"]]
    for dets in (detections, [{"severity": "critical"}, {"severity": "minor"}], []):
        payload = json.dumps({"detections": dets}).encode()
        _same(apps, "POST", "/api/quality/assess", payload, "application/json")
    _same(apps, "GET", "/api/quality/rules")
    _same(apps, "GET", "/api/stats")
    _same(apps, "GET", "/api/health")
    (ws, wd), (gs, gd) = (wsgi_call(a, "GET", "/api/models/info") for a in apps)
    assert gs == ws == 200
    got, want = gd["model_info"], wd["model_info"]
    assert set(got) == set(want)
    assert got["detector_status"] == "operational"
    assert got["components_loaded"] == want["components_loaded"]
    _port_keys_equal(got["configuration"], want["configuration"])
    _port_keys_equal(got["ensemble_info"], want["ensemble_info"])
    assert got["ensemble_info"]["device"] == "cpu" and got["devices"] == ["cpu"]


def test_demo_mode(systems):
    js, ts = systems
    apps = (jax_create_app(JaxSystem(config=js.config), initialize=False),
            create_app(QualityControlSystem(config=ts.config, device="cpu"), initialize=False))
    _, body, _ = _same(apps, "GET", "/health")
    assert body["models_loaded"] is False
    status, _, _ = _same(apps, "GET", "/api/health")
    assert status == 503
    status, body, _ = _same(apps, "POST", "/api/detect", *multipart([("image", "t.jpg", encoded(1))]))
    assert status == 500 and "demo mode" in body["error"]
    _same(apps, "GET", "/api/models/info")


def test_demo_mode_when_the_models_fail(systems):
    """A detector that cannot be built leaves the port serving in demo mode,
    as the JAX package does."""
    _, ts = systems
    raw = ts.config.to_dict()
    raw["model"]["yolo_weights"] = __file__  # not a checkpoint
    s = QualityControlSystem(config=SystemConfig.from_dict(raw), device="cpu")
    assert s.initialize_models() is False and s.detector is None
    status, body = wsgi_call(create_app(s, initialize=False), "GET", "/health")
    assert status == 200 and body["models_loaded"] is False


def test_api_key_auth(systems):
    js, ts = systems
    apps = []
    for cls, create, base in ((JaxSystem, jax_create_app, js), (QualityControlSystem, create_app, ts)):
        s = _fresh(base, cls)
        s.config = copy.deepcopy(base.config)
        s.config.api.auth_enabled, s.config.api.api_keys = True, ("secret-key-1",)
        apps.append(create(s, initialize=False))
    key = {"HTTP_X_API_KEY": "secret-key-1"}
    statuses = []
    for method, path, headers, query in (
        ("GET", "/health", None, ""), ("GET", "/api/version", None, ""),
        ("GET", "/api/health", None, ""), ("GET", "/api/stats", key, ""),
        ("GET", "/api/stats", {"HTTP_AUTHORIZATION": "Bearer secret-key-1"}, ""),
        ("GET", "/api/stats", {"HTTP_X_API_KEY": "wrong"}, ""),
        ("POST", "/realtime/start", None, ""), ("POST", "/realtime/start", key, ""),
        ("POST", "/realtime/stop", key, ""), ("GET", "/events", None, "timeout=0&max=1"),
        ("GET", "/api/thresholds", None, "api_key=secret-key-1"),
    ):
        status, _, _ = _same(apps, method, path, headers=headers, query=query)
        statuses.append(status)
    assert statuses == [200, 401, 200, 200, 200, 401, 401, 200, 200, 401, 200]


def test_rate_limiter(systems):
    js, ts = systems
    apps = (jax_create_app(JaxSystem(config=js.config), initialize=False),
            create_app(QualityControlSystem(config=ts.config, device="cpu"), initialize=False))
    payload, ctype = multipart([("images", "a.jpg", encoded(1))])
    statuses = [_same(apps, "POST", "/api/detect/batch", payload, ctype)[0] for _ in range(11)]
    assert statuses == [200] * 10 + [429]


def test_port_server_over_a_socket(apps):
    """The port's threaded server on an ephemeral localhost port answers one
    frame posted over a real socket as the JAX app answers the same request."""
    japp, tapp = apps
    payload, ctype = multipart([("image", "s.png", encoded(10, "PNG"))])
    server = serve(tapp, host="127.0.0.1", port=0, background=True)
    try:
        port = server.server_address[1]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/detect", data=payload,
                                     headers={"Content-Type": ctype}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, got = resp.status, json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    ws, want = wsgi_call(japp, "POST", "/api/detect", payload, ctype)
    assert status == ws == 200 and want["detections"]
    _compare_results(_scrub(got), _scrub(want))


def test_queue_workers(systems):
    """Requests put on the processing queue come back, coalesced into device
    batches by the port's workers, equal to a direct batch."""
    _, ts = systems
    s = _fresh(ts, QualityControlSystem)
    frames = list(_images(21, 3))
    s.start_processing_worker()
    try:
        for i, img in enumerate(frames):
            s.processing_queue.put({"image": img, "request_id": i})
        results = {r["request_id"]: r for r in (s.results_queue.get(timeout=60) for _ in frames)}
    finally:
        s.stop_processing_worker()
    assert sorted(results) == [0, 1, 2] and s.worker_count == 0
    for i, img in enumerate(frames):
        want = _scrub(ts.detector.predict(img))
        got = _scrub(results[i])
        assert [d["class"] for d in got["detections"]] == [d["class"] for d in want["detections"]]
        assert got["quality_assessment"]["quality_grade"] == want["quality_assessment"]["quality_grade"]
