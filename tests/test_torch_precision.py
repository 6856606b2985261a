"""The port's serving precisions against the JAX package: the bfloat16 float
networks, ``crop_and_resize`` in bfloat16, and the whole int8 slice.

The int8 slice: ``QualityControlDetector`` at ``edge.precision: int8``
(both streaming walks, bfloat16 compute) on the YOLOv8n checkpoint at 128^2
and a tiny ResNet, against the JAX detector on the same frames, with the
JAX detector's quantized trees and scales carried into the port
(``weights.install_int8_state``). The JAX detector runs in a child process
with ``XLA_FLAGS=--xla_allow_excess_precision=false``: with XLA's default
on the CPU, a jitted bfloat16 chain is kept in float32, and the JAX
detector's confidences move by up to 2% (measured on the eight frames
``_images(seed, 1)``, seeds 0-7, of test_torch_slice.py with that
detector's state carried across: on seed 3 the contamination scores 0.81319 in JAX and
0.79556 in the port, so its severity flips at the 0.8 major threshold and
the grade with it). With every op rounded, as a TPU computes, the two
detectors agree as follows.

Tolerances (measured on these frames in brackets):
- detections, classes, severities, classification sources, grade and
  pass/fail EQUAL; pixel boxes within 1 px (0);
- detector scores within 1e-5 absolute (1.2e-7); crop-classifier and
  ensemble confidences and class probabilities within 1e-3 absolute
  (6.0e-8 here; 9.0e-5 on the eight frames above); other floats, the
  segmentation statistics among them, within 1e-4 relative (area 5e-5);
- masks, where a result holds them, equal on at least 99.9% of pixels;
- the port's own YOLO calibration against the JAX detector's: scales within
  1% relative (0.76%; 46 of 52 slots equal, the rest one or two bfloat16
  steps of the absmax, from convolution sum order).

bfloat16 float networks (Flax ``dtype=bfloat16``): rounding differences of
single ops (a float32 sum order, an ulp of ``rsqrt``) flip one bfloat16
step in a few values of a layer and spread with depth (0.03% of the values
after the second conv of YOLOv8n, 40% after ``c2f_5``, each within two
steps). YOLOv8n at 128^2 against the jitted Flax forward: logits within 2%
of their largest magnitude (1.05%; 1.0% against the op-by-op forward).
ResNet-50 against the op-by-op Flax forward: within 1e-3 (3.9e-4 on the
checkpoint, 2.6e-7 tiny; the jitted forward is 2.3e-3 from both, by excess
precision); top-1 EQUAL. ``crop_and_resize`` in bfloat16: EQUAL (0).
"""

import copy
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import SIZE, YOLO_CKPT, _images

from iqc_tpu.models import resnet as jresnet
from iqc_tpu.models import yolo as jyolo
from iqc_tpu.ops import image as jimg
from iqc_tpu_torch.config import REPO_ROOT, SystemConfig, resolve_path
from iqc_tpu_torch.inference.detector import QualityControlDetector
from iqc_tpu_torch.models import resnet as tresnet
from iqc_tpu_torch.models import yolo as tyolo
from iqc_tpu_torch.ops import image as timg
from iqc_tpu_torch.weights import install_int8_state, load_into, read_checkpoint

torch.set_num_threads(2)

FRAMES = 4
YOLO_BF16_REL = 2e-2
RESNET_BF16_REL = 1e-3
SCORE_ATOL = 1e-5
CLASSIFIER_ATOL = 1e-3
SCALE_REL = 1e-2
MASK_AGREEMENT = 0.999


def _raw_config():
    """tiny_config's shape (ResNet (1,1,1,1) on 64^2 crops, 16 detections,
    4 classified) with the YOLOv8n checkpoint at 128^2, bfloat16 compute and
    int8 serving; post-processing filters opened so every detection reaches
    the result."""
    return {
        "model": {"yolo_weights": YOLO_CKPT, "resnet_weights": "", "width_mult": 0.25,
                  "depth_mult": 0.334, "max_detections": 16, "max_classified": 4,
                  "confidence_threshold": 0.05, "compute_dtype": "bfloat16",
                  "classifier_input": 64, "resnet_stages": [1, 1, 1, 1]},
        "processing": {"batch_size": 2, "input_size": [SIZE, SIZE],
                       "preprocessing": {"resize": [SIZE, SIZE]}},
        "quality_control": {"thresholds": {"confidence_threshold": 0.0,
                                           "area_threshold_percent": 1000.0}},
        "edge": {"precision": "int8"},
    }


def _jax_reference(out_path):
    """The child process: the JAX int8 detector, its quantized state and its
    answers on the test frames."""
    jax.config.update("jax_platforms", "cpu")
    from iqc_tpu.config import SystemConfig as JaxConfig
    from iqc_tpu.inference.detector import QualityControlDetector as JaxDetector

    from iqc_tpu.models import ensemble as jens
    from iqc_tpu.train.checkpoint import try_load_variables

    def init_or_load(module, dummy_shape, path):
        """The predictor's own rule with the Flax init compiled, which takes
        seconds where the op-by-op init takes about a minute on the CPU."""
        init = jax.jit(lambda k, x: module.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros(dummy_shape, jnp.float32))
        loaded = try_load_variables(path, init) if path else None
        return (loaded, "checkpoint") if loaded is not None else (init, "initialized")

    jens.EnsemblePredictor._init_or_load = staticmethod(init_or_load)
    det = JaxDetector(config=JaxConfig.from_dict(copy.deepcopy(_raw_config())))
    ens = det.ensemble_predictor
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    frames = _images(11, FRAMES)
    out = {"yolo_vars": host(ens.yolo_vars), "resnet_vars": host(ens.resnet_vars),
           "model_info": ens.get_model_info(),
           "predict": [det.predict(f) for f in frames],
           # a batch of 2, the stream's micro-batch: one compiled program
           "predict_batch": det.predict_batch(list(frames[2:4])),
           "detection_only": [det.predict(f, include_segmentation=False) for f in frames[:2]],
           "stream": list(det.predict_stream(iter(frames[:2]), micro_batch=2))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the JAX reference child at once; ``reference()`` waits for it."""
    out = str(tmp_path_factory.mktemp("int8_reference") / "reference.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join([REPO_ROOT, os.path.dirname(__file__)]))
    proc = subprocess.Popen([sys.executable, __file__, out], env=env, cwd=REPO_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cache = {}

    def wait():
        if "data" not in cache:
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-4000:]
            with open(out, "rb") as f:
                cache["data"] = pickle.load(f)
        return cache["data"]

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def int8_detector():
    det = QualityControlDetector(config=SystemConfig.from_dict(_raw_config()), device="cpu")
    own = {"yolo": det.ensemble_predictor.yolo_vars["scales"].copy()}
    return det, own


# -- bfloat16 float networks -----------------------------------------------------------


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_bf16_yolo_matches_flax():
    v = read_checkpoint(YOLO_CKPT)
    x = np.random.default_rng(1).random((1, SIZE, SIZE, 3), dtype=np.float32)
    jm = jyolo.YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334, dtype=jnp.bfloat16)
    want_d, want_c = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, jnp.asarray(x))
    tm = tyolo.YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334,
                      dtype=torch.bfloat16).eval()
    load_into(tm, v)
    with torch.inference_mode():
        got_d, got_c = tm(torch.from_numpy(x))
    assert got_d.dtype == got_c.dtype == torch.bfloat16
    _close(got_d.float().numpy(), want_d.astype(jnp.float32), YOLO_BF16_REL)
    _close(got_c.float().numpy(), want_c.astype(jnp.float32), YOLO_BF16_REL)


@pytest.mark.parametrize("weights", ["tiny", "checkpoint"])
def test_bf16_resnet_matches_flax(weights):
    if weights == "tiny":
        stages, size = (1, 1, 1, 1), 64
        jm = jresnet.ResNet50(num_classes=5, stage_sizes=stages, dtype=jnp.bfloat16)
        v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
        rng = np.random.default_rng(3)
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
            v["batch_stats"])
    else:
        stages, size = (3, 4, 6, 3), SIZE
        jm = jresnet.ResNet50(num_classes=5, stage_sizes=stages, dtype=jnp.bfloat16)
        v = read_checkpoint(resolve_path("models/resnet50_qc_128.msgpack"))
    x = np.random.default_rng(4).standard_normal((1, size, size, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))  # op by op
    tm = tresnet.ResNet50(num_classes=5, stage_sizes=stages, dtype=torch.bfloat16).eval()
    load_into(tm, v)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the pooled features and the head stay float32
    _close(got.numpy(), want, RESNET_BF16_REL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_crop_and_resize_bf16_equals_jax():
    img = np.random.default_rng(5).random((2, 96, 96, 3), dtype=np.float32)
    boxes = np.asarray([[[3.3, 4.1, 50.7, 60.2], [10, 10, 11, 12], [-5, 20, 120, 90]],
                        [[0, 0, 96, 96], [40.5, 2.25, 41, 95], [60, 60, 20, 20]]], np.float32)
    want = jax.vmap(lambda im, bx: jimg.crop_and_resize(
        im, bx, (32, 32), compute_dtype=jnp.bfloat16))(jnp.asarray(img), jnp.asarray(boxes))
    got = timg.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), (32, 32),
                               torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f32 = timg.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), (32, 32))
    assert not torch.equal(f32, got)


def test_bf16_detector_serves():
    """``edge.precision: bf16`` (the JAX package's default) serves the
    bfloat16 float networks: no int8 state, no precision report."""
    raw = _raw_config()
    raw["edge"] = {"precision": "bf16"}
    det = QualityControlDetector(config=SystemConfig.from_dict(raw), device="cpu")
    ens = det.ensemble_predictor
    assert ens.precision_report is None and ens.yolo_vars is None
    assert ens.yolo.compute_dtype == ens.resnet.compute_dtype == torch.bfloat16
    r = det.predict(_images(11, 1)[0])
    assert "error" not in r and r["detections"]
    assert ens.get_model_info()["serving_precision"] == "bf16"


# -- the int8 slice ------------------------------------------------------------------


def test_int8_calibration_close_to_jax(reference, int8_detector):
    ref = reference()
    det, own = int8_detector
    want = ref["yolo_vars"]["scales"]
    assert own["yolo"].shape == want.shape and own["yolo"].dtype == np.float32
    np.testing.assert_allclose(own["yolo"], want, rtol=SCALE_REL)
    info = det.ensemble_predictor.get_model_info()
    assert det.ensemble_predictor.calibration_seconds > 0
    # the port's own ResNet is another random init than JAX's: only the
    # report's wording and sizes are compared
    assert info["serving_precision"] == ref["model_info"]["serving_precision"] == "int8"
    assert info["precision_report"] == ref["model_info"]["precision_report"]


def _compare(got, want, path="result"):
    """Equal structure, strings, booleans and integers (pixel boxes within
    1 px); floats within the module's tolerances; masks on >= 99.9% of
    pixels."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _compare(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray) or (isinstance(want, list) and want
                                          and isinstance(want[0], np.ndarray)):
        if path.endswith("contours"):
            assert len(got) == len(want), path
            return
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        assert float(np.mean(g == w)) >= MASK_AGREEMENT, path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, (path, got, want)
    elif isinstance(want, int):
        tol = 1 if ".bbox." in path or path.endswith(".area") else 0
        assert abs(got - want) <= tol, (path, got, want)
    elif path.endswith((".confidence", ".yolo_confidence")) and "classification" not in path \
            and "global" not in path:
        assert abs(got - want) <= SCORE_ATOL, (path, got, want)
    elif any(k in path for k in ("ensemble_confidence", "resnet_confidence", "classification",
                                 "average_confidence", "mean_confidence", "overall_confidence")):
        assert abs(got - want) <= CLASSIFIER_ATOL, (path, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=path)


def _strip(result):
    r = copy.deepcopy(result)
    for k in ("total_inference_time_ms", "stage_times_ms", "batch_statistics"):
        r.pop(k, None)
    r.get("metadata", {}).pop("processing_timestamp", None)
    return r


@pytest.fixture(scope="module")
def carried(reference, int8_detector):
    ref = reference()
    det, _ = int8_detector
    install_int8_state(det.ensemble_predictor, ref["yolo_vars"], ref["resnet_vars"])
    return det, ref


def test_int8_predict_matches_jax(carried):
    det, ref = carried
    for i, (frame, want) in enumerate(zip(_images(11, FRAMES), ref["predict"])):
        got = det.predict(frame)
        assert "error" not in got and "error" not in want
        assert want["detections"], f"frame {i}"
        _compare(_strip(got), _strip(want), f"frame {i}")
    np.testing.assert_array_equal(det.ensemble_predictor.yolo_vars["scales"],
                                  ref["yolo_vars"]["scales"])


def test_int8_predict_batch_matches_jax(carried):
    det, ref = carried
    got = det.predict_batch(list(_images(11, FRAMES)[2:4]))
    assert len(got) == len(ref["predict_batch"]) == 2
    for i, (g, w) in enumerate(zip(got, ref["predict_batch"])):
        _compare(_strip(g), _strip(w), f"batch frame {i}")


def test_int8_detection_only_and_stream_match_jax(carried):
    """``predict(include_segmentation=False)`` and ``predict_stream`` run
    the int8 networks too."""
    det, ref = carried
    frames = _images(11, FRAMES)[:2]
    for i, (f, want) in enumerate(zip(frames, ref["detection_only"])):
        got = det.predict(f, include_segmentation=False)
        assert "error" not in got and want["detections"]
        _compare(_strip(got), _strip(want), f"detection-only frame {i}")
    stream = list(det.predict_stream(iter(frames), micro_batch=2))
    assert [r["stream_index"] for r in stream] == [0, 1]
    for i, (got, want) in enumerate(zip(stream, ref["stream"])):
        got, want = _strip(got), _strip(want)
        got.pop("timestamp", None), want.pop("timestamp", None)
        _compare(got, want, f"stream frame {i}")


def test_int8_model_info_and_walk_overrides(carried, monkeypatch):
    det, ref = carried
    info = det.get_system_info()["ensemble_info"]
    assert info["serving_precision"] == "int8"
    assert info["precision_report"] == ref["model_info"]["precision_report"]
    assert info["precision_report"]["resnet"].endswith("(streaming v2)")
    raw = _raw_config()
    monkeypatch.setenv("IQC_RESNET_INT8_STREAM", "0")
    v1 = QualityControlDetector(config=SystemConfig.from_dict(raw), device="cpu")
    assert v1.ensemble_predictor.precision_report["resnet"] == \
        "true-int8 MXU (static calibrated activations)"
    assert "error" not in v1.predict(_images(11, 1)[0])
    monkeypatch.setenv("IQC_YOLO_INT8_STREAM", "0")
    both_v1 = QualityControlDetector(config=SystemConfig.from_dict(raw), device="cpu")
    report = both_v1.ensemble_predictor.precision_report
    assert report["yolo"] == report["resnet"] == "true-int8 MXU (static calibrated activations)"
    assert len(both_v1.ensemble_predictor.yolo_vars["scales"]) == 57
    assert "error" not in both_v1.predict(_images(11, 1)[0])


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
