"""YOLOv8 detection trainer, on one device or data-parallel over a mesh.

The JAX package's ``train/train_yolo.py`` on PyTorch: YOLOv8 in training
mode, the task-aligned loss (``train/yolo_loss.py``), SGD with Nesterov
momentum, weight decay and a warmup-cosine schedule (``train/steps.py``),
an EMA of the weights with a warmup ramp, device mosaic, mixup and the
Ultralytics augmentation chain, and mAP50 / mAP50-95 validation of the EMA
weights through DFL decode and NMS (the suppression kernel), captured as a
CUDA graph per batch shape (``ops/jit_utils.py``).

``train`` feeds the step from one of three tiers, chosen as the JAX package
chooses them: the device-resident corpus (the whole dataset uploaded once,
each batch a mosaic of corpus images; the ``--synthetic`` run's tier), a
staged host epoch (one epoch of host-built batches uploaded as one tensor),
or streaming (a batch uploaded per step). Random choices are drawn on the
CPU from generators seeded by (seed, step), so a run on the card and one
on the CPU train on the same batches, and a resumed run draws the same.

The trainer runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; there is no fallback from one to the other. Under a
launcher (``python -m torch.distributed.run --nproc-per-node N``) it trains
data-parallel over the mesh of ``mesh_config`` (None: every rank of the
job; ``parallel/mesh.py``), one rank per device, as the JAX package does
on a mesh: every rank reads the same global batches and draws, keeps its
rows, and runs the step on them with the BatchNorm statistics and the
loss's normaliser taken over the global batch and the gradients summed
over the ranks; the parameters, statistics and EMA stay equal on every
rank. On a mesh of more than one rank device mosaic is off (host mosaic
and mixup run in the loader), batches stream (no corpus or staged tier),
validation shards each batch and gathers the detections, and rank 0 writes
the checkpoints.

Run: ``python -m iqc_tpu_torch.train.train_yolo --synthetic --epochs 1``
(``--config`` a JSON file of the training profile, or YAML where PyYAML is
installed); on N cards ``python -m torch.distributed.run --nproc-per-node N
-m iqc_tpu_torch.train.train_yolo ...``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from iqc_tpu_torch.data.yolo_dataset import DetectionLoader
from iqc_tpu_torch.models.layers import exact_float32, set_mesh
from iqc_tpu_torch.models.yolo import (BACKBONE_KEYS, MODULE_ORDER, STRIDES, YOLOv8,
                                       feature_shapes, init_weights)
from iqc_tpu_torch.ops.jit_utils import hoisted_jit
from iqc_tpu_torch.ops.nms import make_anchors
from iqc_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce_sum, create_mesh,
                                         distributed_init, padded_rows, replicate, shard_batch)
from iqc_tpu_torch.train import steps
from iqc_tpu_torch.train.detection_metrics import evaluate_detections
from iqc_tpu_torch.train.utils import EarlyStopping, MetricsTracker, set_global_seed
from iqc_tpu_torch.train.yolo_loss import YoloLossConfig, yolo_loss

logger = logging.getLogger(__name__)

DEFAULT_CONFIG: Dict[str, Any] = {
    "num_classes": 5,
    "image_size": 640,
    "batch_size": 16,
    "epochs": 100,
    "learning_rate": 0.01,
    "final_lr_fraction": 0.01,
    "warmup_epochs": 3,
    "weight_decay": 5e-4,
    "momentum": 0.937,
    "box_gain": 7.5,
    "cls_gain": 0.5,
    "dfl_gain": 1.5,
    # per-class BCE weights ({class name: w} or a [C] list; None unweighted)
    "class_weights": None,
    "mosaic": 1.0,
    "mixup": 0.0,
    "device_mosaic": True,   # mosaic/mixup on the device (ops/mosaic.py)
    "mosaic_antialias": False,
    # YoloAugHyp fields (hsv_h/s/v, degrees, translate, scale, shear,
    # flipud, fliplr) applied on the device after mosaic; None = off
    "augmentation": None,
    "ema_decay": 0.9999,
    "width_mult": 0.25,
    "depth_mult": 0.334,
    "stem_mode": "conv",
    "reg_max": 16,
    "max_boxes": 64,
    "val_conf": 0.001,
    "val_iou": 0.6,
    "box_voting": True,
    # freeze the first N modules (10 = the backbone) through the mask stage
    "freeze_layers": 0,
    # upload a whole host-built epoch at once when it fits IQC_STAGED_EPOCH_MB
    "staged_host_epochs": True,
    "patience": 50,
    "checkpoint_dir": "checkpoints/yolo",
    "compute_dtype": "bfloat16",
    "seed": 42,
}

AUG_SEED_OFFSET = 7919  # the augmentation's generators: seed + 7919


def frozen_modules(param_keys, freeze_n: int) -> set:
    """Module names frozen by ``freeze_layers=N`` (Ultralytics' ``freeze:
    N``): the first N modules in ``MODULE_ORDER``; N >= 10 freezes the
    whole backbone (9 modules with the s2d stem) and N - 10 neck modules."""
    present = [k for k in MODULE_ORDER if k in param_keys]
    backbone = [k for k in present if k in BACKBONE_KEYS]
    rest = [k for k in present if k not in BACKBONE_KEYS]
    if freeze_n >= 10:
        return set(backbone + rest[:freeze_n - 10])
    return set(backbone[:freeze_n])


def config_from_profile(raw: Dict[str, Any]) -> Dict[str, Any]:
    """A trainer config from a profile shaped like config/yolo_config.yaml:
    its ``training`` block (or the whole dict), ``qc_specific.class_weights``
    as the class weights, and the ``augmentation`` block with mosaic and
    mixup routed to the mosaic tiers (copy_paste dropped)."""
    config = dict(raw.get("training", raw))
    qc = raw.get("qc_specific") or {}
    if qc.get("class_weights") and not config.get("class_weights"):
        config["class_weights"] = qc["class_weights"]
    aug = dict(raw.get("augmentation") or {})
    if aug:
        if "mosaic" in aug and "mosaic" not in config:
            config["mosaic"] = float(aug.pop("mosaic"))
        if "mixup" in aug and "mixup" not in config:
            config["mixup"] = float(aug.pop("mixup"))
        aug.pop("copy_paste", None)
        if "augmentation" not in config:
            config["augmentation"] = aug
    return config


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for one step's draws, seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _as_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches scale to [0,1] on the device (as x * (1/255), the
    product XLA makes of the JAX package's division)."""
    if images.dtype.is_floating_point:
        return images
    return images.to(torch.float32) * (1.0 / 255.0)


class YOLOTrainer:
    """``train``, ``validate`` and ``save`` of a YOLOv8 detector on one
    device or on this rank's device of a data-parallel mesh. ``step_parts``
    holds the loss parts of each step of the last epoch (host floats)."""

    def __init__(self, config: Optional[Dict] = None, mesh_config=None, device="cuda"):
        self.config = {**DEFAULT_CONFIG, **(config or {})}
        c = self.config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to train on "
                               "the CPU")
        # None: every rank of the launched job (one process: a mesh of 1)
        self.mesh = create_mesh(mesh_config, device=self.device)
        exact_float32(self.device)
        set_global_seed(c["seed"])  # python's and numpy's global generators
        # device mosaic picks sources across the whole batch: one device only
        self.uses_device_mosaic = bool(c.get("device_mosaic", True)) and self.mesh.size == 1
        dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
        kw = dict(num_classes=c["num_classes"], width_mult=c["width_mult"],
                  depth_mult=c["depth_mult"], reg_max=c["reg_max"], dtype=dtype,
                  stem_mode=c.get("stem_mode", "conv"))
        self.module = YOLOv8(**kw)
        # the EMA weights with the live BatchNorm statistics, for validation
        self.eval_module = YOLOv8(**kw)
        s = c["image_size"]
        self.anchors, self.strides = make_anchors(feature_shapes((s, s)), STRIDES,
                                                  device=self.device)
        self.metrics = MetricsTracker()
        self.state: Optional[steps.TrainState] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        self.step_parts: List[Dict[str, float]] = []
        self._pending_batches = None
        self._val_cache: Dict[int, Any] = {}
        self._staged_logged = False

    # -- set-up ------------------------------------------------------------------

    def build(self, steps_per_epoch: int) -> None:
        c = self.config
        total_steps = max(c["epochs"] * steps_per_epoch, 1)
        warmup = max(int(c["warmup_epochs"] * steps_per_epoch), 1)
        self.schedule = steps.warmup_cosine_schedule(c["learning_rate"], warmup, total_steps,
                                                     c["final_lr_fraction"])
        init_weights(self.module, c["seed"])
        self.module.to(self.device).train()
        self.eval_module.to(self.device).eval()
        set_mesh(self.module, self.mesh)
        replicate(self.mesh, list(self.module.state_dict().values()))
        freeze_n = int(c.get("freeze_layers", 0) or 0)
        params = dict(self.module.named_parameters())
        opt = steps.sgd_init(params, masked=bool(freeze_n))
        if freeze_n:
            frozen = frozen_modules({k.split(".")[0] for k in params}, freeze_n)
            opt = steps.set_update_mask(
                opt, {k: 0.0 if k.split(".")[0] in frozen else 1.0 for k in params})
            logger.info("freeze_layers=%d: frozen modules = %s", freeze_n,
                        ", ".join(sorted(frozen)))
        self.state = steps.module_state(self.module, opt)
        self.ema_params = {k: p.detach().clone() for k, p in params.items()}
        self.loss_cfg = YoloLossConfig(box_gain=c["box_gain"], cls_gain=c["cls_gain"],
                                       dfl_gain=c["dfl_gain"])

        cw = c.get("class_weights")
        if isinstance(cw, dict):
            from iqc_tpu_torch.config import DEFECT_CLASSES

            names = list(DEFECT_CLASSES)[:c["num_classes"]]
            cw = [float(cw.get(n, 1.0)) for n in names]
        weights = (np.ones(c["num_classes"], np.float32) if cw is None
                   else np.asarray(cw, np.float32))
        if weights.shape != (c["num_classes"],):
            raise ValueError(f"class_weights must have {c['num_classes']} entries, got "
                             f"{weights.shape}")
        self._class_weights = torch.from_numpy(weights).to(self.device)

        self.use_dev_mosaic = self.uses_device_mosaic and (c["mosaic"] > 0 or c["mixup"] > 0)
        aug_raw = c.get("augmentation")
        self.aug_hyp = None
        if aug_raw:
            from iqc_tpu_torch.data.augmentation import YoloAugHyp

            hyp = YoloAugHyp.from_dict(aug_raw if isinstance(aug_raw, dict) else {})
            self.aug_hyp = hyp if hyp.active() else None

        reg_max = c["reg_max"]
        capacity = min(100, int(self.anchors.shape[0]))
        box_voting = bool(c.get("box_voting", False))

        def predict_core(images, conf_t, iou_t):
            from iqc_tpu_torch.ops.nms import decode_and_nms

            dist, cls = self.eval_module(_as_float(images))
            det = decode_and_nms(dist, cls, self.anchors, self.strides, reg_max,
                                 max_detections=capacity, iou_threshold=iou_t,
                                 score_threshold=conf_t, box_voting=box_voting)
            return det.boxes, det.scores, det.classes, det.valid

        self._predict = hoisted_jit(predict_core)

    def load_flax_state(self, state, ema_params=None) -> None:
        """Take the JAX trainer's state (its ``TrainState`` with optax's
        state, as device or numpy arrays) and EMA into this trainer, which
        ``build`` has set up for the same model and optimizer."""
        from iqc_tpu_torch import weights

        self.load_state(weights.train_state_from_flax(state, ema_params))

    def load_state(self, s: Dict[str, Any]) -> None:
        """Take a state in the form ``weights.train_state_from_flax``
        returns into this trainer."""
        with torch.no_grad():
            for name, t in self.state.params.items():
                t.copy_(s["params"][name])
            for name, t in self.state.batch_stats.items():
                t.copy_(s["batch_stats"][name])
            for name, t in self.state.opt_state.trace.items():
                t.copy_(s["trace"][name])
            if s["ema"] is not None:
                for name, t in self.ema_params.items():
                    t.copy_(s["ema"][name])
        if (s["mask"] is None) != (self.state.opt_state.mask is None):
            raise ValueError("the state's optimizer and this trainer's differ in the mask stage")
        self.state.step = s["step"]
        self.state.opt_state = steps.SGDState(trace=self.state.opt_state.trace,
                                              count=s["count"], mask=s["mask"])

    # -- the step ------------------------------------------------------------------

    def _draw_mosaic(self, step: int, batch: int, n_sources: int):
        """The mosaic and mixup draws of update ``step`` (CPU generators
        seeded from (seed, step))."""
        from iqc_tpu_torch.ops.mosaic import draw_mixup, draw_mosaic

        c = self.config
        gen = _generator(c["seed"], step)
        size = c["image_size"]
        return (draw_mosaic(gen, batch, size, n_sources, c["mosaic"]),
                draw_mixup(gen, np.random.default_rng([c["seed"], step]), batch, c["mixup"]))

    def _draw_augment(self, step: int, batch: int, height: int, width: int):
        """The augmentation draws of update ``step`` (seed + 7919, step)."""
        from iqc_tpu_torch.data.augmentation import draw_yolo_augment

        return draw_yolo_augment(_generator(self.config["seed"] + AUG_SEED_OFFSET, step),
                                 batch, height, width, self.aug_hyp)

    def _augment(self, images, boxes, classes, valid, step: int, global_b: int):
        """The augmentation of this rank's rows: the global batch's draws,
        cut to the rows."""
        from iqc_tpu_torch.data.augmentation import yolo_train_augment_batch

        h, w = images.shape[1:3]
        draws = shard_batch(self.mesh, self._draw_augment(step, global_b, h, w), upload=False)
        return yolo_train_augment_batch(images, boxes, classes, valid, draws, self.aug_hyp)

    def _inbatch_mosaic(self, images, boxes, classes, valid, step: int):
        from iqc_tpu_torch.ops.mosaic import mixup_batch, mosaic_batch

        b = images.shape[0]
        m_draws, x_draws = self._draw_mosaic(step, b, b)
        batch = mosaic_batch(images, boxes, classes, valid, m_draws,
                             bool(self.config.get("mosaic_antialias", False)))
        return mixup_batch(*batch, x_draws)

    def _step(self, images, boxes, classes, valid, inbatch_mosaic: bool,
              global_b: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One update of ``self.state`` and the EMA from a batch on the
        device: on a mesh, this rank's rows of a global batch of
        ``global_b`` rows (padded; the batch itself by default). Returns the
        global batch's loss parts."""
        st = self.state
        global_b = global_b or images.shape[0]
        images = _as_float(images)
        if inbatch_mosaic and self.use_dev_mosaic:
            images, boxes, classes, valid = self._inbatch_mosaic(images, boxes, classes, valid,
                                                                 st.step)
        if self.aug_hyp is not None:
            images, boxes, classes, valid = self._augment(images, boxes, classes, valid, st.step,
                                                          global_b)
        c = self.config
        names = list(st.params)
        dist, cls = self.module(images)
        total, parts = yolo_loss(dist, cls, self.anchors, self.strides, boxes.to(torch.float32),
                                 classes, valid, c["reg_max"], self.loss_cfg,
                                 class_weights=self._class_weights, mesh=self.mesh)
        grads = steps.all_reduce_grads(self.mesh, torch.autograd.grad(
            total, [st.params[k] for k in names]))
        st.opt_state = steps.sgd_update(st.params, dict(zip(names, grads)), st.opt_state,
                                        self.schedule, c["momentum"], c["weight_decay"])
        steps.ema_update(self.ema_params, st.params, steps.ema_decay_at(st.step, c["ema_decay"]))
        st.step += 1
        out = {k: v.detach() for k, v in parts.items()}
        out["loss"] = total.detach()
        if self.mesh.distributed:  # this rank's shares -> the global batch's
            keys = list(out)
            totals = all_reduce_sum(self.mesh, torch.stack([out[k] for k in keys]))
            out = dict(zip(keys, totals))
        return out

    def train_step(self, images, boxes, classes, valid) -> Dict[str, torch.Tensor]:
        """One streaming step (in-batch device mosaic where active) from a
        host or device batch (on a mesh the global batch, of which this rank
        takes its rows); returns the global batch's loss parts as 0-d
        tensors."""
        self.module.train()
        n = len(images)
        rows = shard_batch(self.mesh, (images, boxes, classes, valid))
        return self._step(*rows, inbatch_mosaic=True, global_b=padded_rows(self.mesh, n))

    def _finish_epoch(self, parts: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
        if not parts:
            self.step_parts = []
            return {}
        stacked = {k: torch.stack([p[k] for p in parts]).cpu() for k in parts[0]}
        self.step_parts = [{k: float(v[i]) for k, v in stacked.items()} for i in range(len(parts))]
        return {k: float(v.mean()) for k, v in stacked.items()}

    # -- data tiers ----------------------------------------------------------------

    def _maybe_device_corpus(self, loader):
        """The whole dataset on the device, when it fits: device mosaic owns
        augmentation (the loader augments nothing), the dataset has load()
        and a length, and its images fit IQC_DEVICE_CORPUS_MB (default 2048).
        Returns (images, boxes, classes, valid) on the device, or None."""
        if not self.uses_device_mosaic:
            return None
        if getattr(loader, "mosaic_prob", 1.0) or getattr(loader, "mixup_prob", 0.0):
            return None
        ds = getattr(loader, "ds", None)
        if ds is None or not hasattr(ds, "load"):
            return None
        n = len(ds)
        size = self.config["image_size"]
        cap_mb = float(os.environ.get("IQC_DEVICE_CORPUS_MB", "2048"))
        if n == 0 or n * size * size * 3 / 2**20 > cap_mb:
            return None
        m = ds.load(0)[1].shape[0]
        imgs = np.zeros((n, size, size, 3), np.uint8)
        bxs = np.zeros((n, m, 4), np.float32)
        cls_ = np.zeros((n, m), np.int32)
        vld = np.zeros((n, m), bool)
        for i in range(n):
            im, bx, cl, vl = ds.load(i)
            if im.shape[0] != size:
                return None  # size mismatch: stream instead
            imgs[i], bxs[i], cls_[i], vld[i] = im, bx, cl, vl
        logger.info("device-resident corpus: %d images (%.0f MB) uploaded once",
                    n, imgs.nbytes / 2**20)
        return tuple(torch.from_numpy(x).to(self.device) for x in (imgs, bxs, cls_, vld))

    def _corpus_epoch(self, corpus, idx: np.ndarray) -> List[Dict[str, torch.Tensor]]:
        from iqc_tpu_torch.ops.mosaic import mixup_batch, mosaic_from_corpus, upload

        imgs, bxs, cls_, vld = corpus
        parts = []
        for row in idx:
            idx_row = torch.from_numpy(row).long()
            if self.use_dev_mosaic:
                m_draws, x_draws = self._draw_mosaic(self.state.step, len(row), imgs.shape[0])
                b_i, b_b, b_c, b_v = mosaic_from_corpus(
                    imgs, bxs, cls_, vld, idx_row, m_draws,
                    bool(self.config.get("mosaic_antialias", False)))
                b_i = b_i * (1.0 / 255.0)  # the corpus is uint8-scaled
                batch = mixup_batch(b_i, b_b, b_c, b_v, x_draws)
            else:
                i = upload(idx_row, self.device)
                batch = (imgs[i], bxs[i], cls_[i], vld[i])
            parts.append(self._step(*batch, inbatch_mosaic=False))
        return parts

    def _maybe_stage_epoch(self, loader):
        """One epoch of host-built batches, when staging applies
        (``staged_host_epochs`` on, uniform batch shapes, the epoch under
        IQC_STAGED_EPOCH_MB, default 1024), else None; batches built but
        ineligible are parked in ``_pending_batches`` for streaming."""
        if self.mesh.size > 1 or not self.config.get("staged_host_epochs", True):
            return None
        cap_mb = float(os.environ.get("IQC_STAGED_EPOCH_MB", "1024"))
        it = iter(loader)
        first = next(it, None)
        if first is None:
            return None
        per_batch_mb = sum(v.nbytes for v in first.values()) / 2**20
        if per_batch_mb * len(loader) > cap_mb:
            import itertools

            self._pending_batches = itertools.chain([first], it)
            return None
        batches = [first] + list(it)
        shape0 = {k: v.shape for k, v in first.items()}
        if any({k: v.shape for k, v in b.items()} != shape0 for b in batches[1:]):
            self._pending_batches = batches
            return None
        if not self._staged_logged:
            logger.info("staged host epoch: %d batches (%.0f MB) uploaded as one tensor each",
                        len(batches), per_batch_mb * len(batches))
            self._staged_logged = True
        return batches

    def _staged_epoch(self, batches) -> List[Dict[str, torch.Tensor]]:
        keys = ("images", "boxes", "classes", "valid")
        staged = [torch.from_numpy(np.stack([b[k] for b in batches])).to(self.device)
                  for k in keys]
        return [self._step(*(t[i] for t in staged), inbatch_mosaic=True)
                for i in range(len(batches))]

    def _stream_epoch(self, loader) -> List[Dict[str, torch.Tensor]]:
        parts = []
        for batch in self._pending_batches or loader:
            parts.append(self.train_step(batch["images"], batch["boxes"], batch["classes"],
                                         batch["valid"]))
        self._pending_batches = None
        return parts

    def train(self, train_loader: DetectionLoader, val_loader: Optional[DetectionLoader] = None,
              epochs: Optional[int] = None) -> Dict:
        c = self.config
        epochs = epochs or c["epochs"]
        if self.state is None:
            self.build(steps_per_epoch=len(train_loader))
        self.module.train()
        stopper = EarlyStopping(patience=c["patience"], mode="max")
        best_map = 0.0
        if self.uses_device_mosaic:
            # device mosaic owns augmentation: a loader still applying its own
            # would make mosaics of mosaics
            for attr in ("mosaic_prob", "mixup_prob"):
                if getattr(train_loader, attr, 0.0):
                    logger.warning("device_mosaic active: zeroing train_loader.%s to avoid "
                                   "double augmentation", attr)
                    setattr(train_loader, attr, 0.0)
        corpus = self._maybe_device_corpus(train_loader)
        steps_per_epoch = len(train_loader)
        batch_size = train_loader.batch_size
        idx_rng = np.random.default_rng(c["seed"])
        for epoch in range(epochs):
            t0 = time.time()
            if corpus is not None:
                # with-replacement index draws, as the streaming loader's sampling
                idx = idx_rng.integers(0, corpus[0].shape[0],
                                       (steps_per_epoch, batch_size)).astype(np.int32)
                parts = self._corpus_epoch(corpus, idx)
            else:
                staged = self._maybe_stage_epoch(train_loader)
                parts = (self._staged_epoch(staged) if staged is not None
                         else self._stream_epoch(train_loader))
            mean = self._finish_epoch(parts)
            row = {f"train_{k}": v for k, v in mean.items()}
            if val_loader is not None:
                val = self.validate(val_loader)
                row.update({f"val_{k}": v for k, v in val.items() if isinstance(v, (int, float))})
                if val["mAP50"] > best_map:
                    self.save(os.path.join(c["checkpoint_dir"], "best_model.msgpack"))
                best_map = max(best_map, val["mAP50"])
                if stopper.step(val["mAP50"]):
                    self.metrics.update(row)
                    logger.info("early stopping at epoch %d", epoch)
                    break
            self.metrics.update(row)
            logger.info("epoch %d: %s (%.1fs)", epoch, mean, time.time() - t0)
        return {
            "epochs_trained": len(self.metrics.history.get("train_loss", [])),
            "best_mAP50": best_map,
            "final": {k: v[-1] for k, v in self.metrics.history.items() if v},
        }

    # -- validation ----------------------------------------------------------------

    def _sync_eval_module(self) -> None:
        """The EMA weights and the live statistics into the eval module (in
        place, so captured graphs read them)."""
        with torch.no_grad():
            for name, p in self.eval_module.named_parameters():
                p.copy_(self.ema_params[name])
            for name, b in self.eval_module.named_buffers():
                b.copy_(self.state.batch_stats[name])

    def _maybe_device_val(self, loader) -> Optional[Tuple[torch.Tensor, List[Dict]]]:
        """A deterministic val set on the device, uploaded once: (images
        [E,B,H,W,3], host ground truths), or None to stream (augmented,
        shuffled, ragged or over IQC_DEVICE_VAL_MB, default 512)."""
        if (self.mesh.size > 1 or getattr(loader, "mosaic_prob", 0)
                or getattr(loader, "mixup_prob", 0) or getattr(loader, "shuffle", True)):
            return None
        cached = self._val_cache.get(id(loader))
        if cached is not None and cached[0] is loader:
            return cached[1], cached[2]
        batches = list(loader)
        if not batches:
            return None
        shape0 = batches[0]["images"].shape
        if any(b["images"].shape != shape0 for b in batches[1:]):
            return None
        imgs = np.stack([b["images"] for b in batches])
        if imgs.nbytes / 2**20 > float(os.environ.get("IQC_DEVICE_VAL_MB", "512")):
            return None
        gts = []
        for b in batches:
            for i in range(len(b["images"])):
                gv = b["valid"][i]
                gts.append({"boxes": b["boxes"][i][gv], "classes": b["classes"][i][gv]})
        imgs_dev = torch.from_numpy(imgs).to(self.device)
        self._val_cache[id(loader)] = (loader, imgs_dev, gts)
        return imgs_dev, gts

    def predict_batches(self, batches) -> List[Dict[str, np.ndarray]]:
        """Detections of the EMA model on each [B,H,W,3] batch (device
        tensors or host arrays), one host transfer at the end. Each rank
        predicts its rows of the batch and the detections of every rank are
        gathered: every rank returns the whole batch's."""
        c = self.config
        self._sync_eval_module()
        outs = []
        with torch.no_grad():
            for images in batches:
                det = self._predict(shard_batch(self.mesh, images), float(c["val_conf"]),
                                    float(c["val_iou"]))
                outs.append(tuple(all_gather_rows(self.mesh, t)[:len(images)] for t in det))
        host = [tuple(t.cpu().numpy() for t in o) for o in outs]
        preds = []
        for boxes, scores, classes, valid in host:
            for i in range(valid.shape[0]):
                v = valid[i]
                preds.append({"boxes": boxes[i][v], "scores": scores[i][v],
                              "classes": classes[i][v]})
        return preds

    def validate(self, loader: DetectionLoader) -> Dict:
        c = self.config
        resident = self._maybe_device_val(loader)
        if resident is not None:
            imgs_dev, gts = resident
            preds = self.predict_batches(list(imgs_dev))
            return evaluate_detections(preds, gts, c["num_classes"])
        batches = list(loader)
        preds = self.predict_batches([b["images"] for b in batches])
        gts = []
        for b in batches:
            for i in range(len(b["images"])):
                gv = b["valid"][i]
                gts.append({"boxes": b["boxes"][i][gv], "classes": b["classes"][i][gv]})
        return evaluate_detections(preds, gts, c["num_classes"])

    def variables(self) -> Dict[str, Any]:
        """The EMA weights with the current BatchNorm statistics, as a Flax
        variables tree (numpy)."""
        from iqc_tpu_torch import weights

        flax = weights.to_flax(self.module)
        return {"params": weights.to_flax(self.module, self.ema_params)["params"],
                "batch_stats": flax["batch_stats"]}

    def save(self, path: str) -> None:
        """The EMA weights and current statistics as a Flax msgpack
        checkpoint (``YOLODetector(model_path=...)`` of either package
        loads it), the config beside it; on a mesh rank 0 writes and every
        rank waits for it."""
        from iqc_tpu_torch.train.checkpoint import save_variables

        if self.mesh.is_main:
            save_variables(path, self.variables(), {"config": self.config})
        self.mesh.barrier()


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Train the YOLOv8 defect detector")
    parser.add_argument("--config", default=None,
                        help="training profile, JSON (or YAML with PyYAML), shaped like "
                             "config/yolo_config.yaml")
    parser.add_argument("--data-dir", default=None,
                        help="dir with images/{train,val} + labels/{train,val}")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the procedural defect corpus")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--evolve", action="store_true",
                        help="run hyperparameter evolution instead of one training")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from iqc_tpu_torch.config import read_config_file

    config = config_from_profile(read_config_file(args.config)) if args.config else {}
    if args.epochs:
        config["epochs"] = args.epochs

    evo_cfg = dict(config.pop("evolution", {}) or {})
    if args.evolve or evo_cfg.get("enabled"):
        from iqc_tpu_torch.train.evolve import evolve_hyperparameters

        result = evolve_hyperparameters(
            config,
            generations=int(evo_cfg.get("generations", 10)),
            population_size=int(evo_cfg.get("population_size", 5)),
            mutation_probability=float(evo_cfg.get("mutation_probability", 0.8)),
            sigma=float(evo_cfg.get("sigma", 0.2)),
            seed=int(config.get("seed", 42)),
            out_dir=config.get("checkpoint_dir", DEFAULT_CONFIG["checkpoint_dir"]),
            device=args.device,
        )
        print(json.dumps({"best_fitness": result["best_fitness"],
                          "best_config": {k: result["best_config"][k]
                                          for k in result["history"][0]["genes"]}}, indent=2))
        return

    # under a launcher: this rank's device and the job's process group
    trainer = YOLOTrainer(config, device=distributed_init(args.device))
    c = trainer.config
    if args.synthetic or not args.data_dir:
        from iqc_tpu_torch.data.yolo_dataset import SyntheticDefectDataset

        train_ds = SyntheticDefectDataset(256, c["image_size"], c["max_boxes"])
        val_ds = SyntheticDefectDataset(64, c["image_size"], c["max_boxes"], seed=1)
    else:
        from iqc_tpu_torch.data.yolo_dataset import YoloDataset

        train_ds = YoloDataset(os.path.join(args.data_dir, "images/train"),
                               os.path.join(args.data_dir, "labels/train"),
                               c["image_size"], c["max_boxes"])
        val_ds = YoloDataset(os.path.join(args.data_dir, "images/val"),
                             os.path.join(args.data_dir, "labels/val"),
                             c["image_size"], c["max_boxes"])
    host_mosaic = 0.0 if trainer.uses_device_mosaic else c["mosaic"]
    host_mixup = 0.0 if trainer.uses_device_mosaic else c["mixup"]
    train_loader = DetectionLoader(train_ds, c["batch_size"], mosaic_prob=host_mosaic,
                                   mixup_prob=host_mixup)
    val_loader = DetectionLoader(val_ds, c["batch_size"], mosaic_prob=0, mixup_prob=0,
                                 shuffle=False)
    report = trainer.train(train_loader, val_loader)
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    # the kernels this run launched (validation's suppression)
    report["kernel_launches"] = {**nms_kernel.LAUNCHES, **morph_kernel.LAUNCHES}
    if trainer.mesh.is_main:
        print(json.dumps(report, indent=2))
    trainer.save(os.path.join(c["checkpoint_dir"], "yolov8_qc.msgpack"))
    if trainer.mesh.distributed:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
