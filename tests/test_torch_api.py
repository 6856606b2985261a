"""The rest of the detector and predictor API of the port against the JAX
package, on the detectors of ``test_torch_slice.py`` (the shipped YOLOv8n
checkpoint at 128^2, the same tiny ResNet in both packages, ``device="cpu"``).

Covered: ``predict(include_segmentation=False)``; ``predict`` from many
threads at once (the bodies run on the detector's one device thread); ``EnsemblePredictor``'s
``predict``, ``batch_predict``, ``run`` and ``run_host``; ``predict_stream``
one by one, in micro-batches and with a callback; ``update_config`` and
``update_ensemble_weights`` (results change as in the JAX package and the
forward module is not rebuilt); ``reset_performance_stats``,
``get_system_info`` and ``benchmark``; and 1-D encoded JPEG and PNG buffers
through ``predict``.

Tolerances are ``test_torch_slice._compare_results``'s: floats within 1e-4
relative; booleans, classes, severities and grades EQUAL; pixel boxes within
1 px; masks equal on at least 99.9% of pixels. The port decodes JPEG with
libjpeg's fast integer DCT and plain upsampling (``runtime/codec.py``), PIL
with its accurate defaults: on these frames at PIL's default quality (75)
they differ by at most 5 grey levels (measured on six seeded frames), so the
JPEG case holds the port against the JAX package on the port's decoded
pixels, and each package's buffer path against its own decoded array.
"""

import copy
import io
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_slice import (  # noqa: F401  (detectors is a fixture)
    THRESHOLD, _compare_outputs, _compare_results, _images, _strip, detectors)

from iqc_tpu_torch.runtime import codec

JPEG_PIXEL_TOLERANCE = 5


def _plain(result):
    """``_strip`` plus the stream's wall-clock timestamp."""
    r = _strip(result)
    r.pop("timestamp", None)
    return r


def test_predict_without_segmentation(detectors):
    jd, td = detectors
    img = _images(11, 1)[0]
    want, got = jd.predict(img, include_segmentation=False), td.predict(img, include_segmentation=False)
    assert "error" not in got and want["detections"]
    assert set(got["stage_times_ms"]) == set(want["stage_times_ms"]) == {
        "preprocess", "ensemble", "postprocess"}
    _compare_results(_strip(got), _strip(want))


def test_predictor_api(detectors):
    jd, td = detectors
    jp, tp = jd.ensemble_predictor, td.ensemble_predictor
    imgs = list(_images(12, 2))
    want, got = jp.predict(imgs[0]), tp.predict(imgs[0])
    assert want["detections"]
    _compare_results(_strip(got), _strip(want))
    want, got = jp.batch_predict(imgs), tp.batch_predict(imgs)
    assert [r["batch_index"] for r in got] == [0, 1]
    for g, w in zip(got, want):
        _compare_results(_strip(g), _strip(w))
    host = tp.run_host(np.stack(imgs))
    _compare_outputs(host, jp.run_host(np.stack(imgs)))
    dev = tp.run(np.stack(imgs))
    assert isinstance(dev.boxes, torch.Tensor) and dev.boxes.device == tp.device
    for a, b in zip(host, dev):
        np.testing.assert_array_equal(a, b.cpu().numpy().astype(a.dtype))


@pytest.mark.parametrize("micro_batch", [1, 3])
def test_predict_stream(detectors, micro_batch):
    jd, td = detectors
    frames = list(_images(13, 4))
    want = list(jd.predict_stream(iter(frames), micro_batch=micro_batch))
    got = list(td.predict_stream(iter(frames), micro_batch=micro_batch))
    assert [r["stream_index"] for r in got] == [0, 1, 2, 3]
    assert all(isinstance(r["timestamp"], float) for r in got)
    for g, w in zip(got, want):
        _compare_results(_plain(g), _plain(w))
    seen = []
    assert td.predict_stream(iter(frames), callback=seen.append, micro_batch=micro_batch) is None
    assert [r["stream_index"] for r in seen] == [0, 1, 2, 3]
    for g, w in zip(seen, want):
        _compare_results(_plain(g), _plain(w))


def test_predict_stream_callback_reports_a_failing_stream(detectors):
    _, td = detectors

    def frames():
        yield _images(14, 1)[0]
        raise OSError("camera disconnected")

    seen = []
    td.predict_stream(frames(), callback=seen.append)
    assert seen[0]["stream_index"] == 0 and "error" not in seen[0]
    assert seen[1] == {"error": "camera disconnected"}


def test_update_config_without_rebuild(detectors):
    """A new detection floor and new ensemble weights reach the next request
    as in the JAX package; the forward module stays the same object."""
    jd, td = detectors
    img = _images(15, 1)[0]
    forward = td.ensemble_predictor._forward_full
    before = td.predict(img, include_segmentation=False)
    confs = sorted(d["confidence"] for d in before["detections"])
    assert len(confs) >= 2 and confs[0] < confs[-1]
    floor = round((confs[0] + confs[-1]) / 2, 4)  # drops the weakest detection
    patch = {"model": {"confidence_threshold": floor,
                       "ensemble_weights": {"yolo": 0.25, "resnet": 0.75}}}
    try:
        jd.update_config(copy.deepcopy(patch))
        td.update_config(copy.deepcopy(patch))
        tp = td.ensemble_predictor
        assert tp._forward_full is forward
        assert (tp.confidence_threshold, tp.ensemble_weights) == \
            (floor, {"yolo": 0.25, "resnet": 0.75})
        assert td.config.model.confidence_threshold == floor and tp.config is td.config
        for include_segmentation in (False, True):
            want = jd.predict(img, include_segmentation=include_segmentation)
            got = td.predict(img, include_segmentation=include_segmentation)
            _compare_results(_strip(got), _strip(want))
            assert 0 < len(got["detections"]) < len(before["detections"])
    finally:
        restore = {"model": {"confidence_threshold": THRESHOLD,
                             "ensemble_weights": {"yolo": 0.6, "resnet": 0.4}}}
        jd.update_config(copy.deepcopy(restore))
        td.update_config(copy.deepcopy(restore))


def test_update_ensemble_weights(detectors):
    jd, td = detectors
    img = _images(16, 1)[0]
    try:
        jd.ensemble_predictor.update_ensemble_weights(3.0, 1.0)
        td.ensemble_predictor.update_ensemble_weights(3.0, 1.0)
        assert td.ensemble_predictor.ensemble_weights == \
            jd.ensemble_predictor.ensemble_weights == {"yolo": 0.75, "resnet": 0.25}
        want = jd.predict(img, include_segmentation=False)
        got = td.predict(img, include_segmentation=False)
        _compare_results(_strip(got), _strip(want))
    finally:
        jd.ensemble_predictor.update_ensemble_weights(0.6, 0.4)
        td.ensemble_predictor.update_ensemble_weights(0.6, 0.4)


def _keys(tree):
    """The nested key structure of a dict."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_stats_system_info_and_benchmark(detectors):
    jd, td = detectors
    for d in (jd, td):
        d.reset_performance_stats()
    assert td.get_performance_stats() == jd.get_performance_stats() == {
        "total_predictions": 0, "total_time": 0.0, "average_time": 0.0}
    imgs = list(_images(17, 2))
    want, got = jd.benchmark(imgs, iterations=1), td.benchmark(imgs, iterations=1)
    assert _keys(got) == _keys(want)
    for k in ("total_images", "iterations"):
        assert got[k] == want[k]
    gm, wm = got["accuracy_metrics"], want["accuracy_metrics"]
    assert gm["success_rate"] == wm["success_rate"] == 1.0
    assert gm["average_detections_per_image"] == wm["average_detections_per_image"] > 0
    np.testing.assert_allclose(gm["average_confidence"], wm["average_confidence"], rtol=1e-4)
    got = td.benchmark(imgs[:1], iterations=2, batched=False)
    assert got["total_images"] == 2 and got["accuracy_metrics"]["success_rate"] == 1.0
    stats = td.get_performance_stats()
    assert stats["total_predictions"] == 4 and stats["latency_percentiles_ms"]["p50"] > 0
    info, want_info = td.get_system_info(), jd.get_system_info()
    assert set(info) == set(want_info)
    assert info["components_loaded"] == want_info["components_loaded"]
    # the port's model info also names its torch device
    assert set(info["ensemble_info"]) == set(want_info["ensemble_info"]) | {"device"}
    assert info["devices"] == ["cpu"] and info["detector_status"] == "operational"
    assert info["configuration"] == td.config.to_dict()


def _encoded(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return np.frombuffer(buf.getvalue(), np.uint8)


def test_predict_png_buffer(detectors):
    jd, td = detectors
    img = _images(18, 1)[0]
    buf = _encoded(img, "PNG")
    want, got = jd.predict(buf), td.predict(buf)
    assert want["detections"] and want["image_metadata"]["original_shape"] == buf.shape
    _compare_results(_strip(got), _strip(want))
    _compare_results(_strip(got)["detections"], _strip(td.predict(img))["detections"])


def test_predict_jpeg_buffer(detectors):
    jd, td = detectors
    buf = _encoded(_images(19, 1)[0], "JPEG")
    port_pixels = codec.decode_image(buf.tobytes())
    pil_pixels = np.asarray(Image.open(io.BytesIO(buf.tobytes())).convert("RGB"))
    assert np.abs(port_pixels.astype(int) - pil_pixels).max() <= JPEG_PIXEL_TOLERANCE
    got = _strip(td.predict(buf))
    assert got["image_metadata"] == {"original_shape": buf.shape, "channels": 1,
                                     "dtype": "uint8", "size_bytes": buf.nbytes}
    for r in (got, want_same := _strip(td.predict(port_pixels)),
              want := _strip(jd.predict(port_pixels)),
              jax_buf := _strip(jd.predict(buf)), jax_own := _strip(jd.predict(pil_pixels))):
        r.pop("image_metadata")
    assert got["detections"]
    _compare_results(got, want_same)
    _compare_results(got, want)
    _compare_results(jax_buf, jax_own)


def test_predict_refuses_undecodable_buffers(detectors):
    jd, td = detectors
    for data in (b"not an image at all", _encoded(_images(20, 1)[0], "BMP").tobytes()):
        buf = np.frombuffer(data, np.uint8)
        assert td.predict(buf) == {"error": "Invalid image input"}
    assert jd.predict(np.frombuffer(b"not an image at all", np.uint8)) == \
        {"error": "Invalid image input"}


def test_predict_from_many_threads(detectors):
    """Eight callers at once, with a short switch interval: every body runs
    on the detector's one device thread, each answer equals the one-caller
    answer, and the stats count every request (a lost update would not)."""
    _, td = detectors
    imgs = list(_images(22, 2))
    want = [_strip(td.predict(im)) for im in imgs]
    td.reset_performance_stats()
    out = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: out.update({i: td.predict(imgs[i % 2])}))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(out) == list(range(8))
    for i, r in out.items():
        assert _strip(r) == want[i % 2]
    assert td.get_performance_stats()["total_predictions"] == 8
    assert len(td._device_thread._threads) == 1


def test_predict_batch_with_an_invalid_image_runs_inline(detectors):
    """predict_batch falls back to predict per image when one is invalid;
    on the device thread that predict runs inline instead of waiting for
    itself."""
    jd, td = detectors
    img, bad = _images(23, 1)[0], np.frombuffer(b"not an image", np.uint8)
    out = []
    t = threading.Thread(target=lambda: out.append(td.predict_batch([img, bad])))
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    got, want = out[0], jd.predict_batch([img, bad])
    assert got[1] == want[1] == {"error": "Invalid image input", "batch_index": 1}
    _compare_results(_strip(got[0]), _strip(want[0]))
