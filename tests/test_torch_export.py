"""The port's export (``iqc_tpu_torch/models/export.py``) on the CPU: the
four cases of tests/test_export.py on the port, the port's reloaded
artifact against the JAX package's on the same weights and frames, and the
suppression op at run-time IoU thresholds against the Pallas kernel.

Tolerances: against the live port, valid slots and classes EQUAL, boxes
within 1e-4 px, confidences within 1e-5 relative (the program runs the
same operations). Against the JAX package's artifact (the ``detectors``
pairing of tests/test_torch_slice.py: the YOLOv8n checkpoint at 128^2, a
tiny ResNet carried across), valid, classes and severity counts EQUAL,
boxes within 1e-3 px, ensemble confidences within 1e-5. Keep masks EQUAL.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqc_tpu.models.export import export_ensemble as jax_export
from iqc_tpu.models.export import load_exported as jax_load
from iqc_tpu.ops.pallas_nms import pallas_suppression
from iqc_tpu_torch.config import SystemConfig
from iqc_tpu_torch.models.ensemble import EnsemblePredictor
from iqc_tpu_torch.models.export import export_ensemble, load_exported
from iqc_tpu_torch.ops import nms_kernel
from test_torch_kernels import _cases
from test_torch_slice import _images, detectors  # noqa: F401  (detectors is a fixture)

torch.set_num_threads(2)


def _config(tiny_config, precision="fp32"):
    raw = copy.deepcopy(tiny_config.to_dict())
    raw["edge"] = {"precision": precision}
    return SystemConfig.from_dict(raw)


@pytest.fixture(scope="module")
def predictor(tiny_config):
    return EnsemblePredictor(config=_config(tiny_config), device="cpu")


@pytest.fixture(scope="module")
def engine_b1(predictor, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "ensemble_b1.iqc")
    export_ensemble(predictor, path, batch_size=1)
    return load_exported(path, device="cpu")


def _assert_same_detections(out, live):
    np.testing.assert_array_equal(np.asarray(live.valid), out.valid)
    np.testing.assert_array_equal(np.asarray(live.classes), out.classes)
    v = out.valid
    np.testing.assert_allclose(np.asarray(live.boxes)[v], out.boxes[v], rtol=1e-5, atol=1e-4)


def test_export_reload_detection_equality(predictor, rng, tmp_path):
    path = str(tmp_path / "ensemble.iqc")
    meta = export_ensemble(predictor, path, batch_size=2)
    assert meta["kind"] == "iqc_tpu_torch.fused_ensemble"
    assert meta["batch_size"] == 2 and meta["device"] == "cpu"

    engine = load_exported(path, device="cpu")
    assert engine.meta["class_names"] == predictor.class_names
    assert "iqc.suppress" in str(engine.program.graph)
    assert engine.yolo_vars.keys() == {"params", "batch_stats"}

    images = rng.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8)
    live = predictor.run_host(images)
    out = engine.outputs(images)
    _assert_same_detections(out, live)
    np.testing.assert_allclose(live.ensemble_conf, out.ensemble_conf, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(live.global_probs, out.global_probs, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(live.severity_counts, out.severity_counts)


def _crowded_frame():
    """A frame of many small overlapping bright squares, which the tiny
    detector scores as many close candidates."""
    img = np.full((1, 96, 96, 3), 90, np.uint8)
    for i in range(6):
        for j in range(6):
            img[0, 8 + 13 * i:20 + 13 * i, 8 + 13 * j:20 + 13 * j] = 200 + 8 * ((i + j) % 3)
    return img


def test_export_threshold_is_runtime_arg(engine_b1, rng):
    """Thresholds are inputs of the program: changing them at call time
    needs no new export. A looser IoU threshold keeps more boxes on a
    crowded frame."""
    images = rng.integers(0, 255, (1, 96, 96, 3), dtype=np.uint8)
    strict = engine_b1.outputs(images, confidence_threshold=0.99)
    loose = engine_b1.outputs(images, confidence_threshold=0.001)
    assert strict.valid.sum() <= loose.valid.sum()
    crowded = _crowded_frame()
    keep = [int(engine_b1.outputs(crowded, confidence_threshold=0.001,
                                  nms_threshold=t).valid.sum()) for t in (0.05, 0.99)]
    assert keep[0] < keep[1], keep


def test_export_batch_mismatch_raises(engine_b1, rng):
    with pytest.raises(ValueError, match="batch"):
        engine_b1(rng.integers(0, 255, (3, 96, 96, 3), dtype=np.uint8))


def test_export_reload_int8_mode(tiny_config, rng, tmp_path):
    """The int8 serving profile exports and reloads to detection-identical
    outputs; its int8 state rides the artifact as the msgpack variables."""
    pred = EnsemblePredictor(config=_config(tiny_config, "int8"), device="cpu")
    assert pred.precision_report["yolo"].startswith("true-int8")

    path = str(tmp_path / "ensemble_int8.iqc")
    meta = export_ensemble(pred, path, batch_size=1)
    assert meta["precision"] == "int8"
    engine = load_exported(path, device="cpu")
    assert engine.resnet_vars.keys() == {"q", "scales"}
    np.testing.assert_array_equal(engine.resnet_vars["scales"], pred.resnet_vars["scales"])

    images = rng.integers(0, 255, (1, 96, 96, 3), dtype=np.uint8)
    _assert_same_detections(engine.outputs(images), pred.run_host(images))


def test_export_equals_the_jax_artifact(detectors, tmp_path):
    """The port's reloaded artifact and the JAX package's, on the same
    weights and seeded frames."""
    jd, td = detectors
    jax_path, port_path = str(tmp_path / "jax.iqc"), str(tmp_path / "port.iqc")
    jax_export(jd.ensemble_predictor, jax_path, batch_size=2)
    export_ensemble(td.ensemble_predictor, port_path, batch_size=2)
    want = jax_load(jax_path).outputs(_images(21, 2))
    got = load_exported(port_path, device="cpu").outputs(_images(21, 2))
    assert want.valid.sum() > 0
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    np.testing.assert_array_equal(got.classes[v], want.classes[v])
    np.testing.assert_array_equal(got.severity_counts, want.severity_counts)
    np.testing.assert_allclose(got.boxes[v], want.boxes[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.ensemble_conf[v], want.ensemble_conf[v], rtol=0, atol=1e-5)


@pytest.mark.parametrize("threshold", [0.3, 0.45, 0.7])
def test_suppress_at_a_runtime_threshold_equals_pallas(threshold):
    """The op takes its IoU threshold as a 0-d tensor, the TPU kernel as an
    SMEM operand: equal keep masks on every case of test_torch_kernels."""
    for name, boxes in sorted(_cases().items()):
        want = np.asarray(pallas_suppression(jnp.asarray(boxes), jnp.float32(threshold),
                                             interpret=True))
        got = nms_kernel.suppress(torch.from_numpy(boxes)[None],
                                  torch.tensor(threshold, dtype=torch.float32))[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
