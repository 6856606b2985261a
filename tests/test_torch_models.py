"""YOLOv8, ResNet-50, the severity rules and decode + NMS of the port against
the JAX package on the same inputs and the same weights (Flax variables
carried across by ``weights.load_into``).

Tolerances: float32 logits within 1e-4 relative to their largest magnitude
(measured: 1e-6 on the YOLOv8n checkpoint at 128^2, 5e-7 on ResNet-50);
NMS keep sets, classes and severities EQUAL; scores within 1e-4 relative;
boxes within 1e-2 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqc_tpu.models import resnet as jresnet
from iqc_tpu.models import yolo as jyolo
from iqc_tpu.ops import nms as jnms
from iqc_tpu_torch.config import resolve_path
from iqc_tpu_torch.models import resnet as tresnet
from iqc_tpu_torch.models import yolo as tyolo
from iqc_tpu_torch.ops import nms as tnms
from iqc_tpu_torch.weights import load_into, read_checkpoint

torch.set_num_threads(2)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-6))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, x):
    """Flax variables of ``module`` from PRNGKey(0), as numpy."""
    init = jax.jit(lambda key, v: module.init(key, v, train=False))
    return _host(init(jax.random.PRNGKey(0), jnp.asarray(x)))


def _apply(module, variables, x):
    return jax.jit(lambda v, xx: module.apply(v, xx, train=False))(variables, jnp.asarray(x))


@pytest.mark.parametrize("stem", ["conv", "s2d"])
def test_yolo_tiny_forward(stem):
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    jm = jyolo.YOLOv8(num_classes=5, width_mult=0.125, depth_mult=0.334, stem_mode=stem)
    variables = _init(jm, x)
    want_d, want_c = _apply(jm, variables, x)
    tm = tyolo.YOLOv8(num_classes=5, width_mult=0.125, depth_mult=0.334, stem_mode=stem).eval()
    load_into(tm, variables)
    with torch.no_grad():
        got_d, got_c = tm(torch.from_numpy(x))
    _close(got_d.numpy(), want_d)
    _close(got_c.numpy(), want_c)


def test_yolov8n_checkpoint_forward_128():
    """The shipped YOLOv8n checkpoint at full width on a 128^2 input."""
    variables = read_checkpoint(resolve_path("models/yolov8n_qc_synthetic.msgpack"))
    x = np.random.default_rng(1).random((1, 128, 128, 3), dtype=np.float32)
    jm = jyolo.YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334)
    want_d, want_c = _apply(jm, variables, x)
    tm = tyolo.YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334).eval()
    load_into(tm, variables)
    with torch.no_grad():
        got_d, got_c = tm(torch.from_numpy(x))
    assert got_d.shape == (1, 336, 64) and got_c.shape == (1, 336, 5)
    _close(got_d.numpy(), want_d)
    _close(got_c.numpy(), want_c)


@pytest.mark.parametrize("size", [64, 72])
def test_resnet_tiny_forward(size):
    """Stage sizes (1,1,1,1); 72 px gives odd feature maps, where Flax's SAME
    padding of the stride-2 convs is symmetric again."""
    x = np.random.default_rng(2).standard_normal((2, size, size, 3)).astype(np.float32)
    jm = jresnet.ResNet50(num_classes=5, stage_sizes=(1, 1, 1, 1))
    variables = _init(jm, x)
    # non-trivial BatchNorm statistics and scales
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), variables)
    want = _apply(jm, variables, x)
    tm = tresnet.ResNet50(num_classes=5, stage_sizes=(1, 1, 1, 1)).eval()
    load_into(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_load_into_checks_structure():
    tm = tresnet.ResNet50(num_classes=5, stage_sizes=(1, 1, 1, 1))
    variables = read_checkpoint(resolve_path("models/resnet50_qc_128.msgpack"))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_into(tm, variables)
    small = tresnet.ResNet50(num_classes=3, stage_sizes=(3, 4, 6, 3))
    with pytest.raises(ValueError, match="shape"):
        load_into(small, variables)


def test_preprocess_for_classifier():
    x = np.random.default_rng(4).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    want = jresnet.preprocess_for_classifier(jnp.asarray(x), 64)
    got = tresnet.preprocess_for_classifier(torch.from_numpy(x), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_severity_rules():
    rng = np.random.default_rng(5)
    conf = rng.uniform(0, 1, 200).astype(np.float32)
    conf[:4] = [0.6, 0.8, 0.9, 0.7]  # on the thresholds
    areas = rng.uniform(0, 0.2 * 1024 * 1024, 200).astype(np.float32)
    cls = rng.integers(0, 5, 200).astype(np.int32)
    rules = np.asarray([[0.7, 0.03, 0.5], [0.85, 0.08, 0.75]], np.float32)
    for r in (None, rules):
        jr = None if r is None else jnp.asarray(r)
        tr = None if r is None else torch.from_numpy(r)
        np.testing.assert_array_equal(
            tyolo.detection_severity(torch.from_numpy(conf), torch.from_numpy(areas), tr).numpy(),
            np.asarray(jyolo.detection_severity(jnp.asarray(conf), jnp.asarray(areas), jr)))
        np.testing.assert_array_equal(
            tresnet.classifier_severity(torch.from_numpy(cls), torch.from_numpy(conf), tr).numpy(),
            np.asarray(jresnet.classifier_severity(jnp.asarray(cls), jnp.asarray(conf), jr)))


def test_anchors_and_dfl():
    shapes = tyolo.feature_shapes((96, 64))
    assert shapes == jyolo.feature_shapes((96, 64))
    pa, sa = tnms.make_anchors(shapes, tyolo.STRIDES)
    pj, sj = jnms.make_anchors(shapes, jyolo.STRIDES)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(sj))
    logits = np.random.default_rng(6).normal(0, 3, (2, 50, 64)).astype(np.float32)
    np.testing.assert_allclose(tnms.dfl_decode(torch.from_numpy(logits), 16).numpy(),
                               np.asarray(jnms.dfl_decode(jnp.asarray(logits), 16)), atol=1e-5)


@pytest.mark.parametrize("per_class", [False, True])
def test_decode_and_nms(per_class):
    """Random head outputs through decode, sigmoid, class-aware merge-NMS."""
    rng = np.random.default_rng(7)
    shapes = tyolo.feature_shapes((128, 128))
    pts, strides = tnms.make_anchors(shapes, tyolo.STRIDES)
    a = pts.shape[0]
    dist = rng.normal(0, 2, (2, a, 64)).astype(np.float32)
    cls = rng.normal(-1, 2, (2, a, 5)).astype(np.float32)
    thr = np.asarray([0.3, 0.5, 0.4, 0.6, 0.35], np.float32) if per_class else 0.4
    want = jnms.decode_and_nms(
        jnp.asarray(dist), jnp.asarray(cls), jnp.asarray(pts.numpy()), jnp.asarray(strides.numpy()),
        reg_max=16, max_detections=100, iou_threshold=jnp.float32(0.5),
        score_threshold=jnp.asarray(thr, jnp.float32), box_voting=True)
    got = tnms.decode_and_nms(
        torch.from_numpy(dist), torch.from_numpy(cls), pts, strides, reg_max=16,
        max_detections=100, iou_threshold=0.5,
        score_threshold=torch.from_numpy(thr) if per_class else thr, box_voting=True)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)
    v = got.valid.numpy()
    assert v.sum() > 20
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=1e-2)


def test_nms_capacity_padding():
    """Fewer anchors than the capacity: outputs pad back to max_detections."""
    rng = np.random.default_rng(8)
    boxes = np.sort(rng.uniform(0, 60, (1, 30, 4)), axis=-1).astype(np.float32)
    boxes = boxes[..., [0, 1, 2, 3]]
    scores = rng.uniform(0, 1, (1, 30, 3)).astype(np.float32)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 48, 0.5, 0.2,
                            box_voting=True)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 48, 0.5, 0.2,
                           box_voting=True)
    assert got.valid.shape == (1, 48)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-2)
