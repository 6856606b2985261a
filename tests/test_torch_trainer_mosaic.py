"""The port's YOLOTrainer on the shipped training path against the JAX
package's on the CPU: the device-resident corpus with mosaic 1.0 and the
augmentation block of config/yolo_config.yaml (the separable bfloat16
affine, flips, HSV), class weights, and freeze_layers 10, at the tiny size
of test_torch_trainer.py. The port is fed the JAX package's random draws,
rebuilt from its keys (fold_in(PRNGKey(seed), step) for mosaic,
fold_in(PRNGKey(seed + 7919), step) for the augmentation). Tolerances as
in test_torch_trainer.py (steps 1-2 within 1e-4 relative, step 3 within
3e-3; the reference's own spread between its jitted and op-by-op step)."""

import jax
import numpy as np
import pytest
import torch

from iqc_tpu.config import MeshConfig
from iqc_tpu.data.yolo_dataset import DetectionLoader, SyntheticDefectDataset
from iqc_tpu.train.train_yolo import YOLOTrainer as JaxTrainer
from iqc_tpu_torch import weights
from iqc_tpu_torch.config import YOLO_TRAINING_PROFILE
from iqc_tpu_torch.train.train_yolo import YOLOTrainer
from test_torch_train_data import jax_aug_draws, jax_mosaic_draws
from test_torch_trainer import CFG, check_state, check_steps

AUG = {k: v for k, v in YOLO_TRAINING_PROFILE["augmentation"].items()
       if k not in ("mosaic", "mixup")}
MOSAIC_CFG = {**CFG, "mosaic": 1.0, "freeze_layers": 10, "augmentation": AUG,
              "class_weights": YOLO_TRAINING_PROFILE["qc_specific"]["class_weights"]}


@pytest.fixture(scope="module")
def run():
    """JAX: 3 corpus steps with device mosaic and augmentation from the
    initial state; the port the same, fed JAX's draws."""
    from iqc_tpu.data.augmentation import YoloAugHyp

    jt = JaxTrainer(MOSAIC_CFG, mesh_config=MeshConfig(data_parallel=1, model_parallel=1))
    ds = SyntheticDefectDataset(12, 64, 8, seed=0)
    loader = DetectionLoader(ds, 4, mosaic_prob=0.0, mixup_prob=0.0)
    jt.build(steps_per_epoch=3)
    s0, e0 = jax.device_get(jt.state), jax.device_get(jt.ema_params)
    corpus = jt._maybe_device_corpus(loader)
    idx = np.random.default_rng(42).integers(0, 12, (3, 4)).astype(np.int32)
    st, ema, parts_t = jt._epoch_fn(s0, e0, *corpus, idx, jt._anchors_r, jt._strides_r,
                                    jt._cls_w_r)
    want = [{k: float(v[i]) for k, v in parts_t.items()} for i in range(3)]

    pt = YOLOTrainer(MOSAIC_CFG, device="cpu")
    pt.build(steps_per_epoch=3)
    pt.load_flax_state(s0, e0)
    hyp = YoloAugHyp(**AUG)
    seed = MOSAIC_CFG.get("seed", 42)

    def draw_mosaic(step, batch, n):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        km, _ = jax.random.split(key)
        return jax_mosaic_draws(km, batch, n, 64, 1.0), None

    pt._draw_mosaic = draw_mosaic
    pt._draw_augment = lambda step, b, h, w: jax_aug_draws(
        jax.random.fold_in(jax.random.PRNGKey(seed + 7919), step), b, h, w, hyp)
    got = pt._corpus_epoch(pt._maybe_device_corpus(loader), idx)
    return pt, got, want, s0, jax.device_get(st), jax.device_get(ema)


def test_corpus_mosaic_augmented_steps(run):
    """Per-step loss parts, then params, statistics, EMA and trace."""
    pt, got, want, _, state, ema = run
    assert pt.use_dev_mosaic and pt.aug_hyp is not None
    check_steps(got, want)
    check_state(pt, state, ema)


def test_freeze_layers_leaves_backbone_bitwise(run):
    """freeze_layers 10: every backbone parameter bitwise unchanged after 3
    steps in both packages (weight decay and momentum included), every head
    parameter moved, and the mask stage's state equal."""
    from iqc_tpu_torch.models.yolo import BACKBONE_KEYS

    pt, _, _, s0, state, _ = run
    start = weights.flax_named(s0.params)
    after_jax = weights.flax_named(state.params)
    frozen = [k for k in start if k.split(".")[0] in BACKBONE_KEYS]
    assert frozen and len(frozen) < len(start)
    for k in start:
        if k in frozen:
            assert torch.equal(after_jax[k], start[k]), k
            assert torch.equal(pt.state.params[k].detach(), start[k]), k
        elif k.startswith("head_p3.box_out"):
            assert not torch.equal(pt.state.params[k].detach(), start[k]), k
    want_mask = weights.train_state_from_flax(state)["mask"]
    assert pt.state.opt_state.mask == want_mask
    assert sorted(k for k, v in want_mask.items() if v == 0.0) == sorted(frozen)
