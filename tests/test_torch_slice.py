"""The serving slice of the port against the JAX package on the same
weights: the shipped YOLOv8n checkpoint (each package reads it with its own
reader) and a tiny randomly initialised ResNet (JAX init, carried across by
``weights.load_into``), at a 128^2 input. A trained detector is used because
a random one scores every anchor within ~1e-8 of the others, so which
candidates fill the NMS capacity would be decided by float rounding. Covered:
the full forward (dense and pooled), output packing, result assembly,
post-processing, segmentation assembly, and ``QualityControlDetector``'s
``predict`` and ``predict_batch`` end to end.

Tolerances: validity, classes, severities, counts, grades, pass/fail and
methods EQUAL; float32 scores and confidences within 1e-4 relative; boxes
within 1e-2 px (the result dicts' integer pixel boxes, truncated from those
floats, within 1 px); end-to-end masks equal on at least 99.9% of pixels
(measured on these inputs: 100%).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqc_tpu.inference.detector import QualityControlDetector as JaxDetector
from iqc_tpu.inference.postprocess import PostProcessor as JaxPost
from iqc_tpu.inference.segmentation import ImageSegmentator as JaxSeg
from iqc_tpu.models import ensemble as jens
from iqc_tpu.models.resnet import ResNet50 as JaxResNet
from iqc_tpu.models.yolo import STRIDES, YOLOv8 as JaxYOLO, feature_shapes
from iqc_tpu.ops.nms import make_anchors
from iqc_tpu_torch.config import SystemConfig, resolve_path
from iqc_tpu_torch.inference.detector import QualityControlDetector
from iqc_tpu_torch.inference.postprocess import PostProcessor
from iqc_tpu_torch.inference.segmentation import ImageSegmentator
from iqc_tpu_torch.models import ensemble as tens
from iqc_tpu_torch.models.resnet import ResNet50
from iqc_tpu_torch.models.yolo import YOLOv8
from iqc_tpu_torch.weights import load_into, read_checkpoint

torch.set_num_threads(2)

MASK_AGREEMENT = 0.999
THRESHOLD = 0.05


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _compare_outputs(got: tens.EnsembleOutputs, want: jens.EnsembleOutputs):
    """Per-slot fields are compared on the valid slots: an invalid slot holds a
    suppressed candidate, and which one depends on ties among near-equal
    scores of suppressed anchors."""
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    for f in ("classes", "yolo_severity", "crop_class", "crop_severity",
              "crop_classified", "final_severity"):
        np.testing.assert_array_equal(getattr(got, f)[v], getattr(want, f)[v], err_msg=f)
    np.testing.assert_array_equal(got.severity_counts, want.severity_counts)
    np.testing.assert_allclose(got.boxes[v], want.boxes[v], atol=1e-2)
    for f in ("yolo_scores", "areas", "crop_conf", "ensemble_conf"):
        np.testing.assert_allclose(getattr(got, f)[v], getattr(want, f)[v], rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    for f in ("global_probs", "image_confidence"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-6,
                                   err_msg=f)


def _compare_seg(got_masks, want_masks, got_stats, want_stats):
    agree = float(np.mean(got_masks == want_masks))
    assert agree >= MASK_AGREEMENT, agree
    np.testing.assert_array_equal(got_stats[..., 4], want_stats[..., 4])
    if agree == 1.0:
        np.testing.assert_allclose(got_stats[..., :3], want_stats[..., :3], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got_stats[..., 3], want_stats[..., 3], rtol=1e-4, atol=1e-6)


# -- the full forward ----------------------------------------------------------------


YOLO_CKPT = resolve_path("models/yolov8n_qc_synthetic.msgpack")
SIZE = 128


def _images(seed, n):
    """Synthetic parts: a grey textured surface with a dark scratch-like bar
    and a bright blob."""
    rng = np.random.default_rng(seed)
    imgs = np.clip(170 + rng.normal(0, 6, (n, SIZE, SIZE, 3)), 0, 255).astype(np.uint8)
    for i in range(n):
        y, x = rng.integers(10, 70, 2)
        imgs[i, y:y + 8, x:x + 50] = 30
        y, x = rng.integers(20, 90, 2)
        imgs[i, y:y + 22, x:x + 26] = 240
    return imgs


@pytest.fixture(scope="module")
def forward_setup():
    yolo = JaxYOLO(num_classes=5, width_mult=0.25, depth_mult=0.334, dtype=jnp.float32)
    resnet = JaxResNet(num_classes=5, stage_sizes=(1, 1, 1, 1), dtype=jnp.float32)
    yv = read_checkpoint(YOLO_CKPT)
    rv = jax.jit(lambda k, x: resnet.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    anc, strd = make_anchors(feature_shapes((SIZE, SIZE)), STRIDES)
    imgs = _images(7, 2)
    ty = YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334).eval()
    tr = ResNet50(num_classes=5, stage_sizes=(1, 1, 1, 1)).eval()
    load_into(ty, yv)
    load_into(tr, _host(rv))
    results = {}

    def run(pool, qc=False):
        """qc: per-class confidence floors and severity-rule thresholds."""
        if (pool, qc) in results:
            return results[(pool, qc)]
        conf = np.asarray([0.05, 0.2, 0.04, 0.1, 0.06], np.float32) if qc else THRESHOLD
        rules = np.asarray([[0.3, 0.01, 0.5], [0.6, 0.05, 0.7]], np.float32) if qc else None
        fwd = jax.jit(jens.build_full_forward(
            yolo, resnet, (SIZE, SIZE), 16, 4, classifier_input=32, max_segmented=4,
            roi_size=32, crop_pool=pool, seg_pool=pool))
        extra = (jnp.asarray(rules),) if qc else ()
        det, img, masks, stats = fwd(yv, rv, jnp.asarray(imgs), jnp.asarray(conf, jnp.float32),
                                     jnp.float32(0.45), jnp.float32(0.6), jnp.float32(0.4),
                                     anc, strd, *extra)
        want = (jens.unpack_outputs(np.asarray(det), np.asarray(img)), np.asarray(masks),
                np.asarray(stats))
        port = tens.FullForward(ty, tr, (SIZE, SIZE), 16, 4, classifier_input=32,
                                max_segmented=4, roi_size=32, crop_pool=pool,
                                seg_pool=pool).eval()
        with torch.inference_mode():
            det, img, masks, stats = port(
                torch.from_numpy(imgs), torch.from_numpy(conf) if qc else conf, 0.45, 0.6, 0.4,
                torch.from_numpy(rules) if qc else None)
        got = (tens.unpack_outputs(det.numpy(), img.numpy()), masks.numpy(), stats.numpy())
        results[(pool, qc)] = (got, want)
        return got, want

    return run


@pytest.mark.parametrize("pool,qc", [(0, False), (3, False), (0, True)])
def test_full_forward(forward_setup, pool, qc):
    """pool 0 = every capacity slot classified and segmented; pool 3 < B*4 =
    the batch-wide crop and segmentation pools with overflow; qc = per-class
    confidence floors and severity-rule thresholds."""
    (got, got_masks, got_stats), (want, want_masks, want_stats) = forward_setup(pool, qc)
    assert want.valid.sum() > 3  # more real survivors than the pool holds
    _compare_outputs(got, want)
    _compare_seg(got_masks, want_masks, got_stats, want_stats)
    if pool:
        assert not got.crop_classified[got.valid].all()


def test_pack_unpack_roundtrip(forward_setup):
    (got, _, _), _ = forward_setup(0)
    t = tens.EnsembleOutputs(*(torch.from_numpy(np.asarray(a)) for a in got))
    det, img = tens.pack_outputs(t)
    again = tens.unpack_outputs(det.numpy(), img.numpy())
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a, b)


def test_assess_overall_quality_table():
    for mi in range(6):
        for ma in range(5):
            for cr in range(3):
                assert tens.assess_overall_quality(mi, ma, cr) == \
                    jens.assess_overall_quality(mi, ma, cr)


# -- detector end to end ----------------------------------------------------------


@pytest.fixture(scope="module")
def detectors(tiny_config):
    """Both detectors on tiny_config with the YOLOv8n checkpoint at 128^2,
    a 0.05 detection floor, and the post-processing confidence and area
    filters opened so that every detection reaches the final result."""
    raw = tiny_config.to_dict()
    raw["model"].update(yolo_weights=YOLO_CKPT, width_mult=0.25, confidence_threshold=THRESHOLD)
    raw["processing"].update(input_size=[SIZE, SIZE], preprocessing={"resize": [SIZE, SIZE]})
    raw["quality_control"]["thresholds"].update(confidence_threshold=0.0,
                                                area_threshold_percent=1000.0)
    jd = JaxDetector(config=type(tiny_config).from_dict(copy.deepcopy(raw)))
    raw["edge"] = {"precision": "fp32"}
    td = QualityControlDetector(config=SystemConfig.from_dict(raw), device="cpu")
    assert td.ensemble_predictor.weights_source == {"yolo": "checkpoint", "resnet": "initialized"}
    load_into(td.ensemble_predictor.resnet, _host(jd.ensemble_predictor.resnet_vars))
    return jd, td


def _strip(result):
    r = copy.deepcopy(result)
    for k in ("total_inference_time_ms", "stage_times_ms", "batch_statistics"):
        r.pop(k, None)
    r.get("metadata", {}).pop("processing_timestamp", None)
    return r


def _compare_results(got, want, path="result"):
    """Equal structure and values; floats within 1e-4 relative, pixel
    boxes (ints) within 1 px, mask arrays on >= 99.9% of pixels."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _compare_results(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not (want and isinstance(want[0], np.ndarray)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_results(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or (isinstance(want, list) and want):
        if path.endswith("contours"):
            assert len(got) == len(want), path
            return
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        assert float(np.mean(g == w)) >= MASK_AGREEMENT, path
    elif isinstance(want, bool) or isinstance(want, str) or want is None:
        assert got == want, (path, got, want)
    elif isinstance(want, int):
        assert abs(got - want) <= (1 if ".bbox." in path or path.endswith(".area") else 0), \
            (path, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=path)


def test_predict_end_to_end(detectors):
    jd, td = detectors
    img = _images(1, 1)[0]
    want, got = jd.predict(img), td.predict(img)
    assert "error" not in got and "error" not in want
    assert len(want["detections"]) > 0
    assert set(got["stage_times_ms"]) == set(want["stage_times_ms"])
    _compare_results(_strip(got), _strip(want))


def test_predict_batch_end_to_end(detectors):
    jd, td = detectors
    imgs = list(_images(2, 3))
    want, got = jd.predict_batch(imgs), td.predict_batch(imgs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert "error" not in g
        _compare_results(_strip(g), _strip(w))


def test_predict_grayscale_and_invalid(detectors):
    """The stats count this test's own two predictions (grey and RGB), from
    a reset, whichever tests ran before it on the same detector."""
    jd, td = detectors
    td.reset_performance_stats()
    gray = _images(3, 1)[0, ..., 0]
    _compare_results(_strip(td.predict(gray)), _strip(jd.predict(gray)))
    assert "error" not in td.predict(_images(3, 1)[0])
    assert td.predict(None) == jd.predict(None) == {"error": "Invalid image input"}
    assert td.predict(np.zeros((0, 0, 3), np.uint8)) == {"error": "Invalid image input"}
    stats = td.get_performance_stats()
    assert stats["total_predictions"] >= 2 and stats["latency_percentiles_ms"]["p50"] > 0


def test_weights_source_reports_missing_checkpoint(tiny_config):
    raw = tiny_config.to_dict()
    raw["edge"] = {"precision": "fp32"}
    raw["model"]["yolo_weights"] = "models/does_not_exist.msgpack"
    td = QualityControlDetector(config=SystemConfig.from_dict(raw), device="cpu")
    info = td.ensemble_predictor.get_model_info()
    assert info["weights_source"] == {"yolo": "initialized", "resnet": "initialized"}
    assert info["untrained_weights"]


# -- host-side assembly -------------------------------------------------------------


def test_postprocess_and_segmentation_assembly(detectors):
    """PostProcessor and the segmentation assembly on the same host inputs."""
    jd, td = detectors
    img = _images(4, 1)
    out, masks, stats = jd.ensemble_predictor.run_full_host(img)
    ens = jd.ensemble_predictor.build_result(out, 0, (SIZE, SIZE, 3))
    assert ens["detections"]
    s = masks.shape[1]
    args = (ens["detections"][:s], JaxSeg._unpack(masks[0], stats[0]), out.boxes[0][:s], (SIZE, SIZE))
    want_seg = JaxSeg(jd.config)._assemble_result(*args)
    targs = (ens["detections"][:s], ImageSegmentator._unpack(masks[0], stats[0]),
             out.boxes[0][:s], (SIZE, SIZE))
    got_seg = ImageSegmentator()._assemble_result(*targs)
    _compare_results(got_seg, want_seg)
    want = JaxPost(jd.config).process_results(ens, want_seg, (SIZE, SIZE, 3))
    got = PostProcessor(td.config).process_results(ens, got_seg, (SIZE, SIZE, 3))
    _compare_results(_strip(got), _strip(want))


@pytest.mark.parametrize("box", [(10.4, 20.6, 50.2, 70.9), (-5, -3, 30, 200), (90, 90, 95, 91)])
def test_reconstruct_mask_and_contours(box):
    roi = np.random.default_rng(5).random((32, 32)) < 0.5
    got = ImageSegmentator.reconstruct_mask(roi, box, (96, 96))
    np.testing.assert_array_equal(got, JaxSeg.reconstruct_mask(roi, box, (96, 96)))
    g, w = ImageSegmentator.mask_contours(got), JaxSeg.mask_contours(got)
    assert len(g) == len(w) and all(np.array_equal(a, b) for a, b in zip(g, w))
