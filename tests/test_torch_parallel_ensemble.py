"""``EnsemblePredictor.run_sharded`` and the sharded full forward of the port
on four gloo ranks, against the JAX package's ``run_sharded`` and its full
forward on 4 of the 8 virtual CPU devices that conftest sets up, and
against the port's own single-device ``run`` and ``run_full_host``.

The predictor: the shipped YOLOv8n checkpoint (each package reads it with
its own reader: a fresh YOLOv8 ties its scores, so rounding would decide
which candidates survive) and a tiny ResNet of the JAX package's seeded
init carried across, float32, 96^2 input, 16 detections, 4 crops an image,
a crop pool of 6 and a seg pool of 6 (2 ROIs an image), on 8 frames of
which the first four are plain and the last four carry defects: the
survivors are spread unevenly over the ranks, so a pool chosen per rank
would differ from the whole batch's. Once as configured, once with
qc_specific's per-class confidence floors and severity rules.

Tolerances: validity, classes, severities, ``crop_classified``, severity
counts and masks EQUAL; against the same mesh of the other package, scores
and confidences within 1e-4 relative and boxes within 1e-2 px (the
single-device slice's bounds, ``tests/test_torch_slice.py``); the port's
mesh against its one device within the JAX package's own
sharded-vs-single spread (``tests/test_parallel.py``): confidences and
probabilities rtol 2e-4 / atol 2e-5, boxes rtol 1e-3 / atol 0.1; the four
ranks' outputs bitwise equal.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from iqc_tpu.config import MeshConfig, SystemConfig as JaxSystemConfig
from iqc_tpu.models.ensemble import EnsemblePredictor as JaxPredictor
from iqc_tpu.models.ensemble import unpack_outputs as jax_unpack
from iqc_tpu.parallel.mesh import create_mesh, data_parallel_sharding
from iqc_tpu_torch.config import SystemConfig, resolve_path
from iqc_tpu_torch.models.ensemble import EnsemblePredictor
from iqc_tpu_torch.weights import load_into

import torch_parallel_ranks as ranks

torch.set_num_threads(2)

WORLD, SIZE = 4, 96
CFG = {
    "model": {"yolo_weights": resolve_path("models/yolov8n_qc_synthetic.msgpack"),
              "resnet_weights": "", "width_mult": 0.25, "depth_mult": 0.334,
              "max_detections": 16, "max_classified": 4, "max_classified_pool": 6,
              "max_segmented": 2, "max_segmented_pool": 6, "seg_roi_size": 32,
              "confidence_threshold": 0.05, "compute_dtype": "float32",
              "classifier_input": 32, "resnet_stages": [1, 1, 1, 1]},
    "processing": {"batch_size": 8, "input_size": [SIZE, SIZE],
                   "preprocessing": {"resize": [SIZE, SIZE]}},
    "edge": {"precision": "fp32"},
}
QC = {"qc_specific": {
    "confidence_thresholds": {"crack": 0.05, "scratch": 0.2, "dent": 0.04,
                              "discoloration": 0.1, "contamination": 0.06},
    "severity_rules": {"major": {"min_confidence": 0.3, "min_area_ratio": 0.01},
                       "critical": {"min_confidence": 0.6, "min_area_ratio": 0.05}}}}
DECISIONS = ("valid", "classes", "yolo_severity", "crop_class", "crop_severity",
             "crop_classified", "final_severity")


def _images():
    """Four plain grey parts, then four with a dark bar and a bright blob."""
    rng = np.random.default_rng(11)
    imgs = np.clip(170 + rng.normal(0, 6, (8, SIZE, SIZE, 3)), 0, 255).astype(np.uint8)
    for i in range(4, 8):
        y, x = rng.integers(8, 50, 2)
        imgs[i, y:y + 7, x:x + 40] = 30
        y, x = rng.integers(15, 65, 2)
        imgs[i, y:y + 18, x:x + 20] = 240
    return imgs


def _np_out(out):
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _jax_full_sharded(jp, images, spec):
    """The JAX predictor's full forward with the batch placed sharded over
    ``spec`` (its weights are replicated there by ``run_sharded``)."""
    args = list(jp._args(images))
    args[2] = jax.device_put(images, data_parallel_sharding(spec, 4))
    det, img, masks, stats = jax.device_get(jp._forward_full(*args))
    return jax_unpack(det, img)._asdict(), masks, stats


def _config(name):
    cfg = copy.deepcopy(CFG)
    if name == "qc":
        cfg.update(copy.deepcopy(QC))
    return cfg


def _references(jp, cfg, resnet_vars, images):
    """The JAX package's outputs (one device and its mesh of 4) and the
    port's one device."""
    want = {"run": _np_out(jp.run(images))}
    spec = create_mesh(MeshConfig(data_parallel=WORLD, model_parallel=1))
    want["run_sharded"] = _np_out(jp.run_sharded(images, spec))
    if "qc_specific" not in cfg:
        full = jp.run_full_host(images)  # also builds the full forward
        want["full"] = (full[0]._asdict(), full[1], full[2])
        want["full_sharded"] = _jax_full_sharded(jp, images, spec)

    pp = EnsemblePredictor(config=SystemConfig.from_dict(copy.deepcopy(cfg)), device="cpu")
    load_into(pp.resnet, resnet_vars)
    single = {"run": _np_out(pp.run(images))}
    full = pp.run_full_host(images)
    single["full"] = (full[0]._asdict(), full[1], full[2])
    return want, single


@pytest.fixture(scope="module")
def all_runs():
    """Both configurations; one launch of four ranks runs both while the
    references are computed here."""
    images = _images()
    names = ("pooled", "qc")
    cfgs = [_config(name) for name in names]
    jps = [JaxPredictor(config=JaxSystemConfig.from_dict(copy.deepcopy(cfg))) for cfg in cfgs]
    resnet_vars = [jax.tree_util.tree_map(np.asarray, jp.resnet_vars) for jp in jps]
    with ranks.start(ranks.predictor_run_sharded, WORLD, list(zip(cfgs, resnet_vars)), images,
                     timeout_s=180) as job:
        refs = [_references(*a, images) for a in zip(jps, cfgs, resnet_vars)]
    return {name: (name, want, single, [o[i] for o in job.outs])
            for i, (name, (want, single)) in enumerate(zip(names, refs))}


@pytest.fixture(params=["pooled", "qc"])
def runs(request, all_runs):
    return all_runs[request.param]


def _check(got, want, score_rtol, score_atol, box_rtol, box_atol):
    for f in DECISIONS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(got["severity_counts"], want["severity_counts"])
    v = want["valid"]
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=box_rtol, atol=box_atol)
    for f in ("yolo_scores", "crop_conf", "ensemble_conf"):
        np.testing.assert_allclose(got[f][v], want[f][v], rtol=score_rtol, atol=score_atol,
                                   err_msg=f)
    for f in ("global_probs", "image_confidence"):
        np.testing.assert_allclose(got[f], want[f], rtol=score_rtol, atol=score_atol, err_msg=f)


def test_run_sharded_matches_the_jax_mesh(runs):
    _, want, _, outs = runs
    _check(outs[0]["run"], want["run_sharded"], 1e-4, 1e-6, 0, 1e-2)


def test_run_sharded_matches_one_device(runs):
    """The port's four ranks against its own ``run``: the pool of the whole
    batch, spread unevenly over the ranks."""
    _, want, single, outs = runs
    got = outs[0]["run"]
    _check(got, single["run"], 2e-4, 2e-5, 1e-3, 0.1)
    classified = got["crop_classified"]
    assert 0 < classified.sum() <= 6
    per_rank = classified.reshape(WORLD, -1).sum(1)
    assert per_rank.min() < per_rank.max(), per_rank  # the pool is not split evenly
    # the JAX package's own mesh gives the same decisions as its one device
    for f in DECISIONS:
        np.testing.assert_array_equal(want["run_sharded"][f], want["run"][f], err_msg=f)


def test_run_sharded_ranks_bitwise_equal(runs):
    outs = runs[3]
    for out in outs[1:]:
        for f, v in outs[0]["run"].items():
            np.testing.assert_array_equal(out["run"][f], v, err_msg=f)
        for a, b in zip(out["full"][1:], outs[0]["full"][1:]):
            np.testing.assert_array_equal(a, b)


def test_seg_pooled_full_forward_sharded(runs):
    """``run_full_sharded``: both pools over the whole batch; masks and
    statistics' methods equal to the port's one device and to the JAX
    package's mesh."""
    name, want, single, outs = runs
    got_out, got_masks, got_stats = outs[0]["full"]
    one_out, one_masks, one_stats = single["full"]
    _check(got_out, one_out, 2e-4, 2e-5, 1e-3, 0.1)
    np.testing.assert_array_equal(got_masks, one_masks)
    np.testing.assert_array_equal(got_stats[..., 4], one_stats[..., 4])
    np.testing.assert_allclose(got_stats, one_stats, rtol=2e-4, atol=2e-5)
    assert got_masks.any()
    if name != "pooled":
        return
    j_out, j_masks, j_stats = want["full_sharded"]
    _check(got_out, j_out, 1e-4, 1e-6, 0, 1e-2)
    np.testing.assert_array_equal(got_masks, j_masks)
    np.testing.assert_array_equal(got_stats[..., 4], j_stats[..., 4])
    np.testing.assert_allclose(got_stats[..., :3], j_stats[..., :3], rtol=1e-5, atol=1e-4)
    # and the JAX package's mesh its one device
    np.testing.assert_array_equal(j_masks, want["full"][1])
