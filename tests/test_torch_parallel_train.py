"""Data-parallel training of the port on four gloo ranks against the JAX
package's sharded step on 4 of the 8 virtual CPU devices that conftest sets up
(``MeshConfig(data_parallel=4)``) and against the port's own single-device
step, all from the JAX trainer's initial state carried across
(``weights.train_state_from_flax``), on the same global batch; then each
trainer's ``main`` on two gloo ranks.

Tolerances are the JAX package's own sharded-vs-single spread
(``tests/test_parallel.py``), never looser:
- YOLO (``_tiny_yolo_cfg``, ``_first_batch``: 64 px, width 0.125, batch 8,
  2 images a rank): the loss within 1e-4 relative; parameters, EMA and
  BatchNorm statistics within rtol 2e-4 / atol 2e-5. The loss parts: of the
  same mesh (port against JAX) within 1e-4 relative; across meshes (4
  ranks against one device) within 5e-4, the JAX package's own spread on
  these inputs being 2.2e-4 (box) and 3.4e-4 (DFL) from its single device
  to its mesh of 4 (the batch statistics' fast variance magnifies the
  order of their sums);
- the classifier (ResNet stages [1,1,1,1], 32 px, batch 8, Adam with decayed
  weights, the JAX step's dropout masks fed in): the loss within 1e-5
  relative, the accuracy equal; parameters within rtol 2e-4 / atol 4e-3
  (Adam moves a parameter with a near-zero gradient by about the learning
  rate, so a rounding difference can swing it by that much) and BatchNorm
  statistics within 2e-4 / 2e-5;
- the four ranks' states after the step: bitwise equal.
Every launch of ranks has its own deadline (``torch_parallel_ranks``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from iqc_tpu.config import MeshConfig
from iqc_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from iqc_tpu.train.train_resnet import ResNetTrainer as JaxResNetTrainer
from iqc_tpu.train.train_yolo import YOLOTrainer as JaxYOLOTrainer
from iqc_tpu_torch import weights
from iqc_tpu_torch.data.pipeline import ArrayDataset
from iqc_tpu_torch.train.train_resnet import ResNetTrainer
from iqc_tpu_torch.train.train_yolo import YOLOTrainer

import torch_parallel_ranks as ranks
from test_parallel import _first_batch, _tiny_yolo_cfg
from test_torch_classifier_trainer import jax_dropout_masks

torch.set_num_threads(2)

WORLD = 4
MESH4 = MeshConfig(data_parallel=WORLD, model_parallel=1)


def _host(state):
    """A converted state with numpy leaves (what the ranks are sent)."""
    return {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) and v
                and isinstance(next(iter(v.values())), torch.Tensor) else v)
            for k, v in state.items()}


def _close(got, want, rtol, atol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _bitwise_equal(outs, keys):
    for out in outs[1:]:
        for key in keys:
            for name, v in outs[0][key].items():
                np.testing.assert_array_equal(out[key][name], v, err_msg=f"{key} {name}")


# -- YOLO ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    cfg = {**_tiny_yolo_cfg(), "checkpoint_dir": str(tmp_path_factory.mktemp("yolo"))}
    jt = JaxYOLOTrainer(cfg, mesh_config=MESH4)
    assert jt.mesh.mesh.size == WORLD
    jt.build(steps_per_epoch=2)
    s0 = weights.train_state_from_flax(jax.device_get(jt.state), jax.device_get(jt.ema_params))
    batch = _first_batch()
    args = (batch["images"], batch["boxes"], batch["classes"], batch["valid"])
    with ranks.start(ranks.yolo_step, WORLD, cfg, _host(s0), batch, timeout_s=150) as job:
        st, ema, parts = jt._train_step(jt.state, jt.ema_params, *args)
        want = weights.train_state_from_flax(jax.device_get(st), jax.device_get(ema))
        jax_out = {"parts": {k: float(v) for k, v in parts.items()}, "params": want["params"],
                   "ema": want["ema"], "batch_stats": want["batch_stats"]}

        pt = YOLOTrainer(cfg, device="cpu")
        pt.build(steps_per_epoch=2)
        pt.load_state(s0)
        single = {"parts": {k: float(v) for k, v in pt.train_step(*args).items()},
                  **ranks._yolo_state(pt)}
    return jax_out, single, job.outs


def _check_yolo(got, want, parts_rtol):
    np.testing.assert_allclose(got["parts"]["loss"], want["parts"]["loss"], rtol=1e-4)
    for k in ("box_loss", "cls_loss", "dfl_loss", "num_fg"):
        np.testing.assert_allclose(got["parts"][k], want["parts"][k], rtol=parts_rtol, err_msg=k)
    for key in ("params", "ema", "batch_stats"):
        _close(got[key], want[key], 2e-4, 2e-5, key)


def test_sharded_yolo_step_matches_the_jax_mesh(yolo):
    jax_out, _, outs = yolo
    assert all(o["mesh"] == WORLD for o in outs)
    _check_yolo(outs[0], jax_out, 1e-4)


def test_sharded_yolo_step_matches_one_device(yolo):
    jax_out, single, outs = yolo
    _check_yolo(outs[0], single, 5e-4)
    _check_yolo(single, jax_out, 5e-4)  # and the port's single step the JAX mesh's


def test_sharded_yolo_ranks_bitwise_equal(yolo):
    outs = yolo[2]
    _bitwise_equal(outs, ("params", "ema", "batch_stats", "trace"))
    assert all(o["parts"] == outs[0]["parts"] for o in outs)


# -- the classifier -----------------------------------------------------------------------


CLS_CFG = {"image_size": 32, "batch_size": 8, "stage_sizes": [1, 1, 1, 1], "epochs": 1,
           "compute_dtype": "float32", "optimizer": "adam"}


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(8) % 5).astype(np.int32)
    cfg = {**CLS_CFG, "checkpoint_dir": str(tmp_path_factory.mktemp("cls"))}
    jt = JaxResNetTrainer(cfg, mesh_config=MESH4)
    assert jt.mesh.mesh.size == WORLD
    jt.setup_data(JaxArrayDataset(images, labels))
    jt.build(steps_per_epoch=1)
    s0_jax = jax.device_get(jt.state)
    s0 = weights.train_state_from_flax(s0_jax)
    key = jax.random.PRNGKey(3)
    masks = jax_dropout_masks(jt.module, {"params": s0_jax.params,
                                          "batch_stats": s0_jax.batch_stats}, key, 8)
    with ranks.start(ranks.classifier_step, WORLD, cfg, _host(s0), images, labels,
                     tuple(x.numpy() for x in masks), timeout_s=150) as job:
        st, m = jt._train_step(jt.state, images, labels, key, jt._class_weights)
        want = weights.train_state_from_flax(jax.device_get(st))
        jax_out = {"metrics": {k: float(v) for k, v in m.items()}, "params": want["params"],
                   "batch_stats": want["batch_stats"]}

        pt = ResNetTrainer(cfg, device="cpu")
        pt.setup_data(ArrayDataset(images, labels))
        pt.build(steps_per_epoch=1)
        pt.load_state(s0)
        pt.draw_hook = lambda step, b: (None, masks)
        single = {"metrics": {k: float(v) for k, v in pt.train_step(images, labels).items()},
                  "params": ranks._np(pt.state.params),
                  "batch_stats": ranks._np(pt.state.batch_stats)}
    return jax_out, single, job.outs


def _check_classifier(got, want):
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    assert got["metrics"]["accuracy"] == want["metrics"]["accuracy"]
    _close(got["params"], want["params"], 2e-4, 4e-3, "params")
    _close(got["batch_stats"], want["batch_stats"], 2e-4, 2e-5, "batch_stats")


def test_sharded_classifier_step_matches_the_jax_mesh(classifier):
    jax_out, _, outs = classifier
    assert all(o["mesh"] == WORLD for o in outs)
    _check_classifier(outs[0], jax_out)


def test_sharded_classifier_step_matches_one_device(classifier):
    jax_out, single, outs = classifier
    _check_classifier(outs[0], single)
    _check_classifier(single, jax_out)


def test_sharded_classifier_ranks_bitwise_equal(classifier):
    outs = classifier[2]
    _bitwise_equal(outs, ("params", "batch_stats", "mu", "nu"))
    assert all(o["metrics"] == outs[0]["metrics"] for o in outs)


# -- the entry points on two ranks ----------------------------------------------------------


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Both trainers' ``main`` on the same two gloo ranks, one after the
    other: train_yolo on the synthetic corpus, then train_resnet on a 32 px
    image-folder tree. Their directories and each rank's (rank, world,
    printed) of each."""
    from iqc_tpu_torch.data.mvtec_synth import MVTecStyleRenderer
    from iqc_tpu_torch.runtime.codec import write_png

    ydir = tmp_path_factory.mktemp("yolo_main")
    profile = {"training": {**_tiny_yolo_cfg(), "batch_size": 16, "mosaic": 1.0,
                            "checkpoint_dir": str(ydir)}}
    (ydir / "profile.json").write_text(json.dumps(profile))

    rdir = tmp_path_factory.mktemp("resnet_main")
    r = MVTecStyleRenderer(size=40, seed=2)
    names = ("crack", "scratch", "dent", "discoloration", "contamination")
    i = 0
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        for c in names:
            os.makedirs(rdir / "data" / split / c)
            for k in range(n):
                write_png(str(rdir / "data" / split / c / f"{k}.png"), r.render(c, i)[0])
                i += 1
    profile = {"training": {**CLS_CFG, "checkpoint_dir": str(rdir / "ckpt")}}
    (rdir / "profile.json").write_text(json.dumps(profile))

    jobs = [("iqc_tpu_torch.train.train_yolo",
             ["--synthetic", "--config", str(ydir / "profile.json"), "--device", "cpu"]),
            ("iqc_tpu_torch.train.train_resnet",
             ["--data-dir", str(rdir / "data"), "--config", str(rdir / "profile.json"),
              "--device", "cpu"])]
    outs = ranks.launch(ranks.train_mains, 2, jobs, str(tmp_path_factory.mktemp("stores")),
                        timeout_s=300)
    return ydir, rdir, [[o[j] for o in outs] for j in range(len(jobs))]


def test_yolo_main_on_two_ranks(mains):
    """``train_yolo.main`` on two gloo ranks: one epoch of the synthetic
    corpus at 64 px (host mosaic, streaming batches, sharded validation),
    rank 0 alone prints the report and writes the checkpoint."""
    ydir, _, (outs, _) = mains
    assert [o[:2] for o in outs] == [(0, 2), (1, 2)]
    report = json.loads(outs[0][2])
    assert outs[1][2] == ""
    assert np.isfinite(report["final"]["train_loss"]) and "val_mAP50" in report["final"]
    assert os.path.exists(ydir / "yolov8_qc.msgpack")


def test_resnet_main_on_two_ranks(mains):
    """``train_resnet.main`` on two gloo ranks over a 32 px image-folder tree:
    one epoch, evaluation of a ragged split (5 images: 3 rows a rank, one
    of them padding), the report printed by rank 0 alone."""
    _, rdir, (_, outs) = mains
    assert [o[:2] for o in outs] == [(0, 2), (1, 2)]
    assert outs[1][2] == ""
    out = json.loads(outs[0][2].strip().splitlines()[-1])
    assert out["train"]["epochs_trained"] == 1
    assert sum(map(sum, out["test"]["confusion_matrix"])) == 5
    assert os.path.exists(rdir / "ckpt" / "final_model.msgpack")
