"""The port's standalone entry points against ``iqc_tpu`` on the same numpy
inputs: ``YOLODetector``, ``ResNetClassifier``, ``ImageSegmentator``
(``segment_defects`` and ``segment_batch``), ``inference/visualize.py``,
``EnsemblePredictor.visualize_ensemble_results`` and
``EnsembleOptimizer``.

The JAX classes initialise Flax weights from a seed, which the port cannot
reproduce, so every pair here runs the same checkpoint: the shipped
YOLOv8n at 128^2, the shipped ResNet-50 at the classifier's 224 px, and for
the predictor a tiny JAX-initialised ResNet carried across as a msgpack
file. The JAX sides build their Flax initialisation under ``jax.jit``
(op by op it is many times slower on the CPU).

Tolerances (measured in brackets):
- detections, classes, severities, predicted classes, segmentation methods
  and the optimizer's best weights EQUAL; pixel boxes within 1 px (0);
- detector confidences within 1e-5 absolute; classifier probabilities
  within 1e-5 absolute; pooled features within 1e-4 of their largest
  magnitude;
- segmentation masks EQUAL; area, perimeter and compactness within 1e-4
  relative (equal here); the methods' confidences within 1e-3 relative
  (1.4e-4: the threshold method's separation score sums float32 statistics
  of the ROI in another order);
- the optimizer's scores within 1e-5 absolute;
- drawings pixel-equal.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import SIZE, YOLO_CKPT, _images

from iqc_tpu.config import SystemConfig as JaxConfig
from iqc_tpu.inference import segmentation as jseg
from iqc_tpu.inference import visualize as jvis
from iqc_tpu.models import ResNetClassifier as JaxClassifier
from iqc_tpu.models import YOLODetector as JaxYOLODetector
from iqc_tpu.models import ensemble as jens
from iqc_tpu.train.checkpoint import save_variables as jax_save
from iqc_tpu.train.checkpoint import try_load_variables
from iqc_tpu_torch.config import SystemConfig, resolve_path
from iqc_tpu_torch.inference import segmentation as tseg
from iqc_tpu_torch.inference import visualize as tvis
from iqc_tpu_torch.models import (EnsembleOptimizer, EnsemblePredictor, ResNetClassifier,
                                  YOLODetector)

torch.set_num_threads(2)

RESNET_CKPT = resolve_path("models/resnet50_qc_128.msgpack")
SCORE_ATOL = 1e-5
PROB_ATOL = 1e-5
FEATURE_REL = 1e-4
STAT_REL = 1e-4
CONF_REL = 1e-3


@contextlib.contextmanager
def _jitted_init(cls, name="_load_or_init", input_shape=None):
    """The JAX class's own load-or-init rule with its Flax init compiled."""
    def load_or_init(self, seed):
        dummy = jnp.zeros(input_shape(self), jnp.float32)
        init = jax.jit(lambda k, x: self.module.init(k, x, train=False))(
            jax.random.PRNGKey(seed), dummy)
        loaded = try_load_variables(self.model_path, init) if self.model_path else None
        return loaded if loaded is not None else init

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, name, load_or_init)
        yield


def _frames(n=3, seed=31):
    return _images(seed, n)


# -- YOLODetector -----------------------------------------------------------------------


def _compare_detections(got, want, path):
    assert len(got) == len(want), (path, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["class"] == w["class"] and g["severity"] == w["severity"], (path, i)
        assert g["id"] == w["id"]
        for k in ("x1", "y1", "x2", "y2"):
            assert abs(g["bbox"][k] - w["bbox"][k]) <= 1, (path, i, k)
        assert abs(g["confidence"] - w["confidence"]) <= SCORE_ATOL, (path, i)


@pytest.fixture(scope="module")
def yolo_pair():
    kw = dict(model_path=YOLO_CKPT, confidence_threshold=0.05, input_size=(SIZE, SIZE))
    with _jitted_init(JaxYOLODetector, input_shape=lambda s: (1, *s.input_size, 3)):
        want = JaxYOLODetector(**kw)
    return YOLODetector(**kw, device="cpu"), want


def test_yolo_detector_predict_matches_jax(yolo_pair):
    got_det, want_det = yolo_pair
    frames = _frames()
    n = 0
    for i, f in enumerate(frames):
        got, want = got_det.predict(f), want_det.predict(f)
        assert got["image_shape"] == want["image_shape"]
        assert got["total_detections"] == want["total_detections"] == len(got["detections"])
        _compare_detections(got["detections"], want["detections"], f"frame {i}")
        n += len(want["detections"])
    assert n > 0
    # an off-size input is resized to the model input; boxes come back in its pixels
    big = np.repeat(np.repeat(frames[0], 2, axis=0), 3, axis=1)[:200, :300]
    got, want = got_det.predict(big), want_det.predict(big)
    assert got["image_shape"] == want["image_shape"] == (200, 300)
    _compare_detections(got["detections"], want["detections"], "off-size")
    got_b, want_b = got_det.batch_predict(list(frames[:2])), want_det.batch_predict(list(frames[:2]))
    for i, (g, w) in enumerate(zip(got_b, want_b)):
        assert g["batch_index"] == w["batch_index"] == i
        _compare_detections(g["detections"], w["detections"], f"batch {i}")
    info = got_det.get_model_info()
    want_info = want_det.get_model_info()
    assert info["weights_source"] == "checkpoint" and info["device"] == "cpu"
    for k in ("model_path", "confidence_threshold", "nms_threshold", "class_names",
              "input_size", "max_detections"):
        assert info[k] == want_info[k], k


def test_yolo_detector_thresholds_and_rules_match_jax():
    """Per-class floors, severity rules and update_thresholds (a dict of
    floors, a new IoU threshold), on a detector without box voting."""
    kw = dict(model_path=YOLO_CKPT, confidence_threshold=0.05, input_size=(SIZE, SIZE),
              box_voting=False, class_conf_thresholds=[0.05, 0.3, 0.05, 0.2, 0.05],
              severity_rules=[[0.3, 0.001], [0.6, 0.01]])
    with _jitted_init(JaxYOLODetector, input_shape=lambda s: (1, *s.input_size, 3)):
        want_det = JaxYOLODetector(**kw)
    got_det = YOLODetector(**kw, device="cpu")
    frames = _frames(2, seed=32)
    for step in range(2):
        for i, f in enumerate(frames):
            _compare_detections(got_det.predict(f)["detections"],
                                want_det.predict(f)["detections"], f"step {step} frame {i}")
        for d in (got_det, want_det):
            d.update_thresholds(confidence={"crack": 0.02, "dent": 0.4}, nms=0.3)
    assert got_det.class_conf_thresholds == want_det.class_conf_thresholds
    for d in (got_det, want_det):
        d.update_thresholds(confidence=0.1)
    assert got_det.class_conf_thresholds is want_det.class_conf_thresholds is None
    _compare_detections(got_det.predict(frames[0])["detections"],
                        want_det.predict(frames[0])["detections"], "scalar floor")


def test_yolo_detector_without_weights_reports_it():
    det = YOLODetector(input_size=(64, 64), device="cpu")
    assert det.get_model_info()["weights_source"] == "initialized"
    assert det.predict(_frames(1)[0][:64, :64])["image_shape"] == (64, 64)


# -- ResNetClassifier ---------------------------------------------------------------------


def test_resnet_classifier_matches_jax():
    with _jitted_init(JaxClassifier, input_shape=lambda s: (1, 224, 224, 3)):
        want_clf = JaxClassifier(model_path=RESNET_CKPT)
    got_clf = ResNetClassifier(model_path=RESNET_CKPT, device="cpu")
    frames = _frames(2, seed=33)

    def same(g, w, path):
        assert g["predicted_class"] == w["predicted_class"] and g["severity"] == w["severity"]
        assert abs(g["confidence"] - w["confidence"]) <= PROB_ATOL, path
        for k, p in w["class_probabilities"].items():
            assert abs(g["class_probabilities"][k] - p) <= PROB_ATOL, (path, k)

    same(got_clf.predict(frames[0]), want_clf.predict(frames[0]), "predict")
    for i, (g, w) in enumerate(zip(got_clf.predict_batch(list(frames)),
                                   want_clf.predict_batch(list(frames)))):
        assert g["batch_index"] == w["batch_index"] == i
        same(g, w, f"batch {i}")
    got_f, want_f = got_clf.extract_features(frames[1]), want_clf.extract_features(frames[1])
    assert got_f.shape == want_f.shape == (2048,) and got_f.dtype == np.float32
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=FEATURE_REL * np.abs(want_f).max())
    info, want_info = got_clf.get_model_info(), want_clf.get_model_info()
    assert info["weights_source"] == "checkpoint"
    for k in ("model_path", "num_classes", "class_names", "input_size"):
        assert info[k] == want_info[k], k


# -- ImageSegmentator ------------------------------------------------------------------------


def _detections(seed, n):
    """Detection records over a frame: boxes around its bar and blob and
    random ones, every class once and an unknown class (threshold method)."""
    rng = np.random.default_rng(seed)
    names = ["crack", "scratch", "dent", "discoloration", "contamination", "burr"]
    out = []
    for j in range(n):
        x1, y1 = (int(v) for v in rng.integers(0, SIZE - 40, 2))
        w, h = (int(v) for v in rng.integers(12, 40, 2))
        out.append({"class": names[j % len(names)], "confidence": 0.5,
                    "bbox": {"x1": x1, "y1": y1, "x2": x1 + w, "y2": y1 + h}})
    return out


def _compare_segmentation(got, want, path):
    assert set(got) == set(want)
    assert got["total_defect_area"] == pytest.approx(want["total_defect_area"], rel=STAT_REL)
    assert len(got["segmented_regions"]) == len(want["segmented_regions"]), path
    for i, (g, w) in enumerate(zip(got["segmented_regions"], want["segmented_regions"])):
        assert g["segmentation_method"] == w["segmentation_method"], (path, i)
        np.testing.assert_array_equal(g["local_mask"], w["local_mask"], err_msg=f"{path} {i}")
        np.testing.assert_array_equal(g["mask"], w["mask"])
        for k in ("area_pixels", "perimeter", "compactness"):
            assert g[k] == pytest.approx(w[k], rel=STAT_REL, abs=1e-6), (path, i, k)
        assert g["confidence_score"] == pytest.approx(w["confidence_score"], rel=CONF_REL,
                                                      abs=1e-6), (path, i)
        assert len(g["contours"]) == len(w["contours"])
    assert got["area_analysis"].keys() == want["area_analysis"].keys()


@pytest.fixture(scope="module")
def segmentators():
    return tseg.ImageSegmentator(capacity=8, roi_size=64, device="cpu"), \
        jseg.ImageSegmentator(capacity=8, roi_size=64)


def test_segment_defects_and_batch_match_jax(segmentators):
    got_seg, want_seg = segmentators
    frames = _frames(2, seed=34)
    dets = [_detections(40, 7), _detections(41, 10)]  # the second beyond the capacity of 8
    for i in range(2):
        _compare_segmentation(got_seg.segment_defects(frames[i], dets[i]),
                              want_seg.segment_defects(frames[i], dets[i]), f"image {i}")
    got_b = got_seg.segment_batch(frames, dets)
    want_b = want_seg.segment_batch(frames, dets)
    assert len(got_b) == 2 and len(got_b[1]["segmented_regions"]) == 8
    for i, (g, w) in enumerate(zip(got_b, want_b)):
        _compare_segmentation(g, w, f"batch {i}")
    assert got_seg.segment_defects(frames[0], []) == want_seg.segment_defects(frames[0], [])
    assert got_seg.segment_batch(frames, [[], []]) == want_seg.segment_batch(frames, [[], []])
    vis_g = got_seg.visualize_segmentation(frames[0], got_b[0])
    vis_w = want_seg.visualize_segmentation(frames[0], want_b[0])
    np.testing.assert_array_equal(vis_g, vis_w)


# -- drawing -----------------------------------------------------------------------------------


def test_visualize_pixel_equal():
    img = np.random.default_rng(8).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    dets = [{"class": c, "bbox": {"x1": x, "y1": y, "x2": x + 30, "y2": y + 20}, "severity": s}
            for c, x, y, s in (("crack", 5, 12, "minor"), ("dent", 60, 50, "critical"),
                               ("burr", 100, 80, "major"), ("scratch", -5, 0, "major"))]
    dets[1]["final_severity"] = "major"
    np.testing.assert_array_equal(tvis.draw_detections(img, dets), jvis.draw_detections(img, dets))
    for qa in ({"pass_fail": "PASS", "quality_grade": "A"},
               {"pass_fail_status": "FAIL", "quality_grade": "F"}, {"quality_grade": ""}):
        np.testing.assert_array_equal(tvis.draw_quality_overlay(img, qa),
                                      jvis.draw_quality_overlay(img, qa))
    masks = [np.random.default_rng(i).random((90, 120)) > 0.7 for i in range(7)]
    np.testing.assert_array_equal(tvis.draw_segmentation(img, masks),
                                  jvis.draw_segmentation(img, masks))
    result = {"detections": dets, "quality_assessment": {"pass_fail": "FAIL",
                                                         "quality_grade": "D"}}
    # the method reads nothing of its predictor
    np.testing.assert_array_equal(
        EnsemblePredictor.visualize_ensemble_results(None, img, result),
        jens.EnsemblePredictor.visualize_ensemble_results(None, img, result))
    np.testing.assert_array_equal(
        EnsemblePredictor.visualize_ensemble_results(None, img, {"detections": dets}),
        jvis.draw_detections(img, dets))


# -- EnsembleOptimizer --------------------------------------------------------------------------


def test_ensemble_optimizer_matches_jax(tmp_path):
    raw = {"model": {"yolo_weights": YOLO_CKPT, "resnet_weights": "", "width_mult": 0.25,
                     "depth_mult": 0.334, "max_detections": 16, "max_classified": 4,
                     "confidence_threshold": 0.05, "compute_dtype": "float32",
                     "classifier_input": 64, "resnet_stages": [1, 1, 1, 1]},
           "processing": {"batch_size": 2, "input_size": [SIZE, SIZE],
                          "preprocessing": {"resize": [SIZE, SIZE]}},
           "edge": {"precision": "fp32"}}

    def init_or_load(module, dummy_shape, path):
        init = jax.jit(lambda k, x: module.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros(dummy_shape, jnp.float32))
        loaded = try_load_variables(path, init) if path else None
        return (loaded, "checkpoint") if loaded is not None else (init, "initialized")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jens.EnsemblePredictor, "_init_or_load", staticmethod(init_or_load))
        want_ens = jens.EnsemblePredictor(config=JaxConfig.from_dict(raw))
    resnet_path = str(tmp_path / "resnet_tiny.msgpack")
    jax_save(resnet_path, want_ens.resnet_vars)
    got_ens = EnsemblePredictor(resnet_weights=resnet_path, config=SystemConfig.from_dict(raw),
                                device="cpu")
    assert got_ens.weights_source == {"yolo": "checkpoint", "resnet": "checkpoint"}
    frames = _frames(4, seed=35)
    wide = np.repeat(frames[:2], 2, axis=2)  # another image shape: another batch
    data = [(frames[0], {"pass": True}), (frames[1], {"class": 1}),
            (wide[0], {"class": "crack", "defect_count": 2}),
            (frames[2], {"PASS": False, "defect_count": 0}), (wide[1], {}),
            (frames[3], {"pass": False, "class": "dent"})]
    got = EnsembleOptimizer(got_ens).optimize_weights(data, steps=5)
    want = jens.EnsembleOptimizer(want_ens).optimize_weights(data, steps=5)
    assert got["best_weights"] == want["best_weights"]
    assert got_ens.ensemble_weights == want_ens.ensemble_weights == want["best_weights"]
    assert abs(got["best_score"] - want["best_score"]) <= SCORE_ATOL
    assert len(got["history"]) == len(want["history"]) == 5
    for g, w in zip(got["history"], want["history"]):
        assert g["weights"] == w["weights"]
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL
    assert EnsembleOptimizer(got_ens)._evaluate([]) == 0.0
    bench = EnsembleOptimizer(got_ens).benchmark_performance(list(frames[:2]))
    assert bench["total_images"] == 2 and len(bench["results"]) == 2
    assert bench["throughput_images_per_second"] > 0
    assert bench["results"][0]["detections"] == got_ens.predict(frames[0])["detections"]
