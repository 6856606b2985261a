"""The port's YOLOTrainer against the JAX package's on the CPU, at a tiny
size (64 px, width 0.125, depth 0.334, reg_max 8, max_boxes 8, batch 4,
float32, mosaic 0, no augmentation): both start from the JAX trainer's
initial state, carried across (``weights.train_state_from_flax``), and
train 3 steps on the same batches on each data tier (streaming, staged
host epoch, device corpus); then validation, checkpoints both ways, and
hyperparameter evolution.

Step tolerances: the batch statistics' fast variance (mean(x^2) - mean^2)
cancels on these flat synthetic images, so rounding differences of the
backward grow by three orders of magnitude once the first real update
(step 2, learning rate 0.01) has moved the weights. The JAX trainer run
op by op, against its own jitted step, differs by 1.5e-6 / 1.5e-5 /
1.7e-3 (box loss, steps 1-3), as the port does from the jitted step
(1.1e-6 / 1.3e-5 / 1.4e-3). Steps 1-2 are held within 1e-4 relative,
step 3 within 3e-3, each part also passing within 1e-6 of the step's
total loss."""

import os

import jax
import numpy as np
import pytest
import torch

from iqc_tpu.config import MeshConfig
from iqc_tpu.data.yolo_dataset import DetectionLoader, SyntheticDefectDataset
from iqc_tpu.train.train_yolo import YOLOTrainer as JaxTrainer
from iqc_tpu_torch import weights
from iqc_tpu_torch.train.train_yolo import YOLOTrainer

CFG = {"image_size": 64, "batch_size": 4, "max_boxes": 8, "epochs": 1, "width_mult": 0.125,
       "depth_mult": 0.334, "reg_max": 8, "compute_dtype": "float32", "warmup_epochs": 0,
       "mosaic": 0.0, "mixup": 0.0, "ema_decay": 0.9}
STEP_RTOL = (1e-4, 1e-4, 3e-3)
PARTS = ("box_loss", "cls_loss", "dfl_loss", "loss", "num_fg")
# after 3 steps (measured: 1.6e-4, 4.2e-5, 1.2e-4, 1.7e-2 in absolute value)
STATE_ATOL = {"params": 5e-4, "batch_stats": 2e-4, "ema": 5e-4, "trace": 5e-2}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer built for 3 steps an epoch, its initial state (numpy)
    and the 3 training batches (uint8, no augmentation)."""
    cfg = {**CFG, "checkpoint_dir": str(tmp_path_factory.mktemp("jax_ckpt"))}
    jt = JaxTrainer(cfg, mesh_config=MeshConfig(data_parallel=1, model_parallel=1))
    jt.build(steps_per_epoch=3)
    s0, e0 = jax.device_get(jt.state), jax.device_get(jt.ema_params)
    ds = SyntheticDefectDataset(12, 64, 8, seed=0)
    loader = DetectionLoader(ds, 4, mosaic_prob=0.0, mixup_prob=0.0, shuffle=False)
    return jt, s0, e0, list(loader), ds


@pytest.fixture(scope="module")
def jax_streamed(jax_run):
    """3 streaming steps of the JAX trainer: per-step parts and the state."""
    jt, s0, e0, batches, _ = jax_run
    st, ema, parts = s0, e0, []
    for b in batches:
        st, ema, p = jt._train_step(st, ema, b["images"], b["boxes"], b["classes"], b["valid"])
        parts.append({k: float(v) for k, v in p.items()})
    return parts, jax.device_get(st), jax.device_get(ema)


def port_trainer(jax_run, tmp_path=None, **overrides):
    _, s0, e0, _, _ = jax_run
    cfg = {**CFG, **overrides}
    if tmp_path is not None:
        cfg["checkpoint_dir"] = str(tmp_path)
    pt = YOLOTrainer(cfg, device="cpu")
    pt.build(steps_per_epoch=3)
    pt.load_flax_state(s0, e0)
    return pt


def check_steps(got, want):
    """Each part within STEP_RTOL of itself, or within 1e-6 of the step's
    total loss (a part of a few thousandths, as the box loss of a batch
    whose assigned anchors score low, carries the rounding of the total)."""
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        for k in PARTS:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=STEP_RTOL[i],
                                       atol=1e-6 * abs(float(w["loss"])),
                                       err_msg=f"step {i + 1} {k}")


def check_state(pt, state, ema):
    want = weights.train_state_from_flax(state, ema)
    got = {"params": pt.state.params, "batch_stats": pt.state.batch_stats, "ema": pt.ema_params,
           "trace": pt.state.opt_state.trace}
    assert pt.state.step == want["step"] and pt.state.opt_state.count == want["count"]
    for part, atol in STATE_ATOL.items():
        assert set(got[part]) == set(want[part])
        err = max(float((got[part][k].detach() - want[part][k]).abs().max()) for k in got[part])
        assert err <= atol, f"{part} differs by {err}"


def test_streaming_tier(jax_run, jax_streamed):
    """Streaming: each step's loss parts (STEP_RTOL), then the state
    (STATE_ATOL) and the step and schedule count equal."""
    _, _, _, batches, _ = jax_run
    want, state, ema = jax_streamed
    pt = port_trainer(jax_run)
    got = [pt.train_step(b["images"], b["boxes"], b["classes"], b["valid"]) for b in batches]
    check_steps(got, want)
    check_state(pt, state, ema)


def test_staged_tier(jax_run):
    """A staged host epoch (the JAX package's one scanned dispatch; the
    port's one upload): per-step parts and the state as streaming."""
    jt, s0, e0, batches, _ = jax_run
    st, ema, parts_t = jt._staged_run(s0, e0, batches)
    want = [{k: float(v[i]) for k, v in parts_t.items()} for i in range(3)]
    pt = port_trainer(jax_run)
    assert pt._maybe_stage_epoch(
        DetectionLoader(SyntheticDefectDataset(12, 64, 8, seed=0), 4, mosaic_prob=0.0,
                        mixup_prob=0.0, shuffle=False)) is not None
    check_steps(pt._staged_epoch(batches), want)
    check_state(pt, jax.device_get(st), jax.device_get(ema))


def test_device_corpus_tier(jax_run):
    """The device-resident corpus at mosaic 0 (batches gathered by index
    rows drawn from default_rng(seed), as ``train`` draws them): per-step
    parts and the state as streaming; both trainers take the tier."""
    jt, s0, e0, batches, ds = jax_run
    loader = DetectionLoader(ds, 4, mosaic_prob=0.0, mixup_prob=0.0)
    corpus_j = jt._maybe_device_corpus(loader)
    pt = port_trainer(jax_run)
    corpus_t = pt._maybe_device_corpus(loader)
    assert corpus_j is not None and corpus_t is not None
    idx = np.random.default_rng(CFG.get("seed", 42)).integers(0, 12, (3, 4)).astype(np.int32)
    st, ema, parts_t = jt._epoch_fn(s0, e0, *corpus_j, idx, jt._anchors_r, jt._strides_r,
                                    jt._cls_w_r)
    want = [{k: float(v[i]) for k, v in parts_t.items()} for i in range(3)]
    check_steps(pt._corpus_epoch(corpus_t, idx), want)
    check_state(pt, jax.device_get(st), jax.device_get(ema))


def same_detections(got, want):
    """Per image the same detections, order aside: count and classes
    equal, scores within 1e-5, boxes within 1e-4 px."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["classes"]) == len(w["classes"])
        og = np.lexsort((g["boxes"][:, 0], g["classes"]))
        ow = np.lexsort((w["boxes"][:, 0], w["classes"]))
        np.testing.assert_array_equal(g["classes"][og], w["classes"][ow])
        np.testing.assert_allclose(g["boxes"][og], w["boxes"][ow], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["scores"][og], w["scores"][ow], rtol=0, atol=1e-5)


def test_validate_same_detections_and_map(jax_run, jax_streamed):
    """validate on the same EMA weights and statistics (the JAX trainer's
    after its 3 streaming steps): the same detections at K = 84 (all 84
    anchors of 64 px), mAP50 and mAP50-95 within 1e-6, on the
    device-resident and the streaming validation path, and against ground
    truths built from the JAX detections (so that the mAP is not 0)."""
    from iqc_tpu.train.detection_metrics import evaluate_detections as jeval
    from iqc_tpu_torch.train.detection_metrics import evaluate_detections

    jt, _, _, _, _ = jax_run
    _, state, ema = jax_streamed
    jt.state, jt.ema_params = state, ema
    pt = port_trainer(jax_run)
    pt.load_flax_state(state, ema)
    val_ds = SyntheticDefectDataset(8, 64, 8, seed=1)
    for shuffle in (False, True):
        mk = lambda: DetectionLoader(val_ds, 4, mosaic_prob=0.0, mixup_prob=0.0,
                                     shuffle=shuffle, seed=3)
        want, got = jt.validate(mk()), pt.validate(mk())
        for k in ("mAP50", "mAP50_95", "precision", "recall"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    images = np.stack([val_ds.load(i)[0] for i in range(4)])
    det = jt._predict(jt.ema_params, jt.state.batch_stats, images, np.float32(0.001),
                      np.float32(0.6))
    d = [np.asarray(x) for x in jax.device_get((det.boxes, det.scores, det.classes, det.valid))]
    want = [{"boxes": d[0][i][d[3][i]], "scores": d[1][i][d[3][i]],
             "classes": d[2][i][d[3][i]]} for i in range(4)]
    got = pt.predict_batches([images])
    same_detections(got, want)
    assert sum(len(w["classes"]) for w in want) > 0
    gts = [{"boxes": w["boxes"][:3] + 1.5, "classes": w["classes"][:3]} for w in want]
    a, b = evaluate_detections(got, gts, 5), jeval(want, gts, 5)
    assert b["mAP50"] > 0
    for k in ("mAP50", "mAP50_95"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)


def test_checkpoints_cross_both_ways(jax_run, jax_streamed, tmp_path):
    """A model checkpoint the port's save writes loads in the JAX package's
    load_variables (and its values are the port's EMA), one the JAX
    trainer writes loads in the port's; a train-state checkpoint of the
    port loads in the JAX package's load_train_state."""
    from iqc_tpu.train.checkpoint import load_train_state, load_variables
    from iqc_tpu_torch.train import checkpoint as tck

    jt, s0, e0, _, _ = jax_run
    _, state, ema = jax_streamed
    pt = port_trainer(jax_run, tmp_path)
    pt.load_flax_state(state, ema)
    template = {"params": s0.params, "batch_stats": s0.batch_stats}
    pt.save(str(tmp_path / "port.msgpack"))
    loaded = load_variables(str(tmp_path / "port.msgpack"), template)
    want = pt.variables()
    for k, v in weights.flatten(want).items():
        node = loaded
        for part in k:
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), v)
    assert tck.load_metadata(str(tmp_path / "port.msgpack"))["config"]["image_size"] == 64

    jt.state, jt.ema_params = state, ema
    jt.save(str(tmp_path / "jax.msgpack"))
    raw = tck.load_variables(str(tmp_path / "jax.msgpack"), pt.variables())
    for k, v in weights.flatten(raw).items():
        np.testing.assert_array_equal(v, weights.flatten(pt.variables())[k])
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.load_variables(str(tmp_path / "jax.msgpack"), {"params": {}})

    tck.save_train_state(str(tmp_path / "state.msgpack"), pt.module, pt.state)
    restored = load_train_state(str(tmp_path / "state.msgpack"), jax.device_get(jt.state))
    back = weights.train_state_from_flax(jax.device_get(restored))
    assert back["step"] == 3 and back["count"] == 3
    for k, v in pt.state.opt_state.trace.items():
        np.testing.assert_array_equal(back["trace"][k].numpy(), v.numpy())
    fresh = port_trainer(jax_run)
    fresh.state = tck.load_train_state(str(tmp_path / "state.msgpack"), fresh.module, fresh.state)
    assert fresh.state.step == 3
    for k, v in pt.state.params.items():
        assert torch.equal(fresh.state.params[k], v)


def test_evolve_same_history():
    """evolve_hyperparameters with an analytic fitness and the same seed
    gives the JAX package's history (generations, fitness, genes) exactly."""
    from iqc_tpu.train.evolve import evolve_hyperparameters as jevolve
    from iqc_tpu_torch.train.evolve import evolve_hyperparameters

    def fitness(c):
        return -((np.log10(c["learning_rate"]) + 2.3) ** 2) - (c["momentum"] - 0.9) ** 2 \
            + 0.1 * c["mosaic"]

    kw = dict(generations=4, population_size=3, mutation_probability=0.7, sigma=0.3,
              fitness_fn=fitness, seed=11)
    want = jevolve({"learning_rate": 0.02}, **kw)
    got = evolve_hyperparameters({"learning_rate": 0.02}, **kw)
    assert got["best_fitness"] == want["best_fitness"]
    assert got["best_config"] == want["best_config"]
    for g, w in zip(got["history"], want["history"]):
        assert g["genes"] == w["genes"] and g["fitness"] == w["fitness"]


def test_multi_device_mesh_refused():
    """A mesh of two devices in a process that no launcher started raises
    (the mesh asks for more ranks than the group has); one device is
    accepted."""
    with pytest.raises(ValueError, match="more ranks than the group has"):
        YOLOTrainer(CFG, mesh_config=MeshConfig(data_parallel=2, model_parallel=1), device="cpu")
    YOLOTrainer(CFG, mesh_config=MeshConfig(data_parallel=1, model_parallel=1), device="cpu")


def test_main_trains_and_saves(tmp_path):
    """``main`` on the CPU with a JSON profile: one epoch on the synthetic
    corpus at 64 px writes a checkpoint that the port's YOLODetector loads."""
    import json

    from iqc_tpu_torch.models.yolo import YOLODetector
    from iqc_tpu_torch.train import train_yolo

    profile = {"training": {**CFG, "epochs": 1, "batch_size": 32, "reg_max": 16,
                            "checkpoint_dir": str(tmp_path)},
               "augmentation": {"fliplr": 0.5, "mosaic": 1.0},
               "qc_specific": {"class_weights": {"dent": 1.5}}}
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(profile))
    train_yolo.main(["--synthetic", "--config", str(path), "--device", "cpu"])
    ckpt = tmp_path / "yolov8_qc.msgpack"
    assert ckpt.exists() and os.path.exists(str(ckpt) + ".json")
    det = YOLODetector(model_path=str(ckpt), input_size=(64, 64), width_mult=0.125,
                       device="cpu", confidence_threshold=0.001)
    assert det.get_model_info()["weights_source"] == "checkpoint"


def _spread():
    """Prints each step's relative difference of the loss parts, for 3
    streaming steps at CFG: the JAX trainer run op by op against its own
    jitted step, and the port against the jitted step (the basis of
    STEP_RTOL). About 3 minutes on the CPU."""
    import tempfile

    class Factory:
        def mktemp(self, name):
            return tempfile.mkdtemp(prefix=name)

    run = jax_run.__wrapped__(Factory())
    jt, s0, e0, batches, _ = run
    jitted = jax_streamed.__wrapped__(run)[0]
    st, ema, eager = s0, e0, []
    with jax.disable_jit():
        for b in batches:
            st, ema, p = jt._train_step(st, ema, b["images"], b["boxes"], b["classes"],
                                        b["valid"])
            eager.append({k: float(v) for k, v in p.items()})
    pt = port_trainer(run)
    port = [{k: float(v) for k, v in pt.train_step(b["images"], b["boxes"], b["classes"],
                                                   b["valid"]).items()} for b in batches]
    for name, got in (("JAX op by op", eager), ("port", port)):
        for i, (g, w) in enumerate(zip(got, jitted)):
            print(f"{name} vs jitted JAX, step {i + 1}: " + ", ".join(
                f"{k} {abs(g[k] - w[k]) / abs(w[k]):.3g}" for k in PARTS if w[k]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _spread()
