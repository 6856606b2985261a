"""ResNet-50 defect-classifier trainer, on one device or data-parallel over
a mesh.

The JAX package's ``train/train_resnet.py`` on PyTorch: ResNet-50 (or -101)
in training mode with the head's dropout, class-weighted cross-entropy with
label smoothing, balanced sampling, Adam with decayed weights, AdamW or
Nesterov SGD under a cosine, staircase, constant or plateau schedule
(``train/steps.py``), exact freezing with gradual unfreezing, the
``augmentation.train`` chain on the device (``data/augmentation.py``),
validation with precision / recall / F1, checkpoints of the best and every
tenth epoch, early stopping, the held-out test with a confusion matrix and
ROC-AUC, and full train-state checkpoints that resume in either package.

``train`` feeds the step from one of two tiers, chosen as the JAX package
chooses them: the device-resident corpus (the whole training set uploaded
once when it fits ``IQC_DEVICE_CORPUS_MB``, default 2048; each epoch's
balanced indices from ``default_rng(seed + epoch)``), or streaming (a batch
of the loader uploaded per step, ahead of its use). Each step's dropout
masks and augmentation draws come from CPU generators seeded by (seed,
step), so a run on the card and one on the CPU train on the same draws;
``draw_hook`` replaces them (the tests feed the JAX trainer's).

The trainer runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; there is no fallback from one to the other. Under a
launcher (``python -m torch.distributed.run --nproc-per-node N``) it trains
data-parallel over the mesh of ``mesh_config`` (None: every rank of the
job; ``parallel/mesh.py``), one rank per device, as the JAX package does
on a mesh: the batch size must divide by the data-parallel size, every
rank reads the same global batches, draws (augmentation and dropout masks
for the global batch) and keeps its rows; the step
(``steps.shard_train_step``) sums the gradients of each rank's share of the
loss over the ranks. On a mesh of more than one rank batches stream (no
device corpus), ``evaluate`` and ``test`` shard each batch and gather the
logits, so every rank returns the same metrics, and rank 0 writes the
checkpoints.

Run: ``python -m iqc_tpu_torch.train.train_resnet --data-dir D`` where D
holds ``train/`` (and optionally ``val/``, ``test/``) with a folder per
class (``--config`` a JSON file shaped like ``config/resnet_config.yaml``,
or YAML where PyYAML is installed); on N cards ``python -m
torch.distributed.run --nproc-per-node N -m iqc_tpu_torch.train.train_resnet
--data-dir D``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from iqc_tpu_torch.config import DEFECT_CLASSES
from iqc_tpu_torch.data.pipeline import (DataLoader, ImageFolderDataset, balanced_sample_indices,
                                         device_prefetch)
from iqc_tpu_torch.models.layers import exact_float32, set_mesh
from iqc_tpu_torch.models.resnet import RESNET50_STAGES, RESNET101_STAGES, ResNet50, init_weights
from iqc_tpu_torch.ops.mosaic import upload
from iqc_tpu_torch.parallel.mesh import (all_gather_rows, create_mesh, distributed_init,
                                         replicate, shard_batch)
from iqc_tpu_torch.train import steps
from iqc_tpu_torch.train.checkpoint import CheckpointManager, load_variables, save_variables
from iqc_tpu_torch.train.train_yolo import _generator
from iqc_tpu_torch.train.utils import (EarlyStopping, MetricsTracker, ReduceLROnPlateau,
                                       compute_class_weights, set_global_seed, training_report)

logger = logging.getLogger(__name__)

DEFAULT_CONFIG: Dict[str, Any] = {
    "num_classes": 5,
    "image_size": 224,
    "batch_size": 32,
    "epochs": 50,
    "learning_rate": 1e-3,
    "weight_decay": 1e-4,
    "optimizer": "adam",          # adam | sgd | adamw
    "scheduler": "cosine",        # step | cosine | plateau | none
    "step_size": 10,
    "gamma": 0.1,
    "plateau_patience": 10,       # ReduceLROnPlateau(patience, factor=gamma)
    "label_smoothing": 0.1,
    # transfer learning: freeze_backbone trains stage4 and the head only;
    # unfreeze_schedule [{"epoch": 10, "layers": ["layer4"]}, ...] adds
    # layers (layerN = stageN) from an epoch on. The head always trains.
    "freeze_backbone": False,
    "unfreeze_schedule": [],
    "use_class_weights": True,
    "balanced_sampling": True,
    # the augmentation.train block of config/resnet_config.yaml; None = off
    "augmentation": None,
    "val_frequency": 1,
    "early_stopping_patience": 10,
    "checkpoint_dir": "checkpoints/resnet",
    "stage_sizes": [3, 4, 6, 3],
    "compute_dtype": "bfloat16",
    "seed": 42,
}

AUG_SEED_OFFSET = 7919  # the augmentation's generators: seed + 7919

# A draw hook: (step, batch size) -> (augmentation draws or None, dropout keep masks)
DrawHook = Callable[[int, int], Tuple[Optional[Dict[str, torch.Tensor]],
                                      Tuple[torch.Tensor, torch.Tensor]]]


def precision_recall_f1(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> Dict:
    """Macro precision, recall and F1, and the per-class precision and recall."""
    p, r = [], []
    for c in range(num_classes):
        tp = int(np.sum((preds == c) & (labels == c)))
        fp = int(np.sum((preds == c) & (labels != c)))
        fn = int(np.sum((preds != c) & (labels == c)))
        p.append(tp / (tp + fp) if tp + fp else 0.0)
        r.append(tp / (tp + fn) if tp + fn else 0.0)
    p_arr, r_arr = np.asarray(p), np.asarray(r)
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.where(p_arr + r_arr > 0, 2 * p_arr * r_arr / (p_arr + r_arr), 0.0)
    return {
        "precision": float(p_arr.mean()),
        "recall": float(r_arr.mean()),
        "f1": float(f1.mean()),
        "per_class_precision": p_arr.tolist(),
        "per_class_recall": r_arr.tolist(),
    }


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """[true class, predicted class] counts."""
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def config_from_profile(raw: Dict[str, Any]) -> Dict[str, Any]:
    """A trainer config from a profile shaped like config/resnet_config.yaml:
    its ``training`` block (or the whole dict) with the ``augmentation``
    block's ``train`` sub-dict as the augmentation."""
    config = dict(raw.get("training", raw))
    aug = raw.get("augmentation") or {}
    if aug and "augmentation" not in config:
        config["augmentation"] = aug.get("train", aug)
    return config


class ResNetTrainer:
    """``train``, ``evaluate``, ``test``, ``save`` and ``resume`` of the
    ResNet defect classifier on one device or on this rank's device of a
    data-parallel mesh. ``step_metrics`` holds the loss and accuracy of each
    step of the last epoch (host floats)."""

    ARCHITECTURES = {"resnet50": RESNET50_STAGES, "resnet101": RESNET101_STAGES}

    def __init__(self, config: Optional[Dict] = None, mesh_config=None, device="cuda"):
        self.config = {**DEFAULT_CONFIG, **(config or {})}
        c = self.config
        arch = c.get("architecture")
        if arch is not None:
            if arch not in self.ARCHITECTURES:
                raise ValueError(f"Unsupported architecture: {arch}")
            c["stage_sizes"] = list(self.ARCHITECTURES[arch])
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to train on "
                               "the CPU")
        # None: every rank of the launched job (one process: a mesh of 1)
        self.mesh = create_mesh(mesh_config, device=self.device)
        exact_float32(self.device)
        set_global_seed(c["seed"])
        dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
        self.module = ResNet50(num_classes=c["num_classes"], stage_sizes=tuple(c["stage_sizes"]),
                               dtype=dtype)
        self.metrics = MetricsTracker()
        self.checkpoints = CheckpointManager(c["checkpoint_dir"], monitor="val_accuracy",
                                             mode="max", keep_best_only=False, save_frequency=10)
        self.state: Optional[steps.TrainState] = None
        self.optimizer: Optional[steps.Optimizer] = None
        self._train_step = None
        self._plateau: Optional[ReduceLROnPlateau] = None
        self._device_corpus = None
        self.draw_hook: Optional[DrawHook] = None
        self.step_metrics: List[Dict[str, float]] = []
        self.start_epoch = 0
        self.train_ds = self.val_ds = self.test_ds = None
        self.train_loader = self.val_loader = None

    # -- data --------------------------------------------------------------------------

    def setup_data(self, train_ds, val_ds=None, test_ds=None) -> None:
        self.train_ds, self.val_ds, self.test_ds = train_ds, val_ds, test_ds
        c = self.config
        if c["batch_size"] % self.mesh.data_size:
            raise ValueError(f"batch_size {c['batch_size']} must be divisible by data-parallel "
                             f"size {self.mesh.data_size}")
        self.train_loader = DataLoader(train_ds, c["batch_size"], shuffle=True,
                                       balanced=c["balanced_sampling"], seed=c["seed"])
        self.val_loader = (DataLoader(val_ds, c["batch_size"], shuffle=False, drop_last=False)
                           if val_ds else None)

    @classmethod
    def from_image_folders(cls, data_dir: str, config: Optional[Dict] = None, device="cuda"):
        """A trainer over ``data_dir``'s ``train/``, ``val/`` and ``test/``
        image folders (the last two optional), classes in DEFECT_CLASSES
        order."""
        trainer = cls(config, device=device)
        size = (trainer.config["image_size"],) * 2

        def split(name):
            path = os.path.join(data_dir, name)
            return ImageFolderDataset(path, size, DEFECT_CLASSES) if os.path.isdir(path) else None

        train_ds = split("train")
        if train_ds is None:
            raise FileNotFoundError(f"no train/ split under {data_dir}")
        trainer.setup_data(train_ds, split("val"), split("test"))
        return trainer

    # -- model and optimizer -------------------------------------------------------------

    def _make_optimizer(self, steps_per_epoch: int) -> Tuple[steps.Optimizer, Optional[float]]:
        """The optimizer and, for the plateau schedule, its initial rate."""
        c = self.config
        base, n = c["learning_rate"], max(steps_per_epoch, 1)
        wd = c["weight_decay"] if c["optimizer"] in ("adam", "adamw") else 0.0
        if c["scheduler"] == "plateau":
            return steps.Optimizer(c["optimizer"], None, wd), base
        if c["scheduler"] == "cosine":
            schedule = steps.cosine_decay_schedule(base, c["epochs"] * n)
        elif c["scheduler"] == "step":
            schedule = steps.exponential_decay(base, c["step_size"] * n, c["gamma"],
                                               staircase=True)
        else:
            return steps.Optimizer(c["optimizer"], steps.constant_schedule(base), wd,
                                   scheduled=False), None
        return steps.Optimizer(c["optimizer"], schedule, wd), None

    def build(self, steps_per_epoch: int = 100) -> None:
        c = self.config
        self.optimizer, plateau_lr = self._make_optimizer(steps_per_epoch)
        self._plateau = None
        if plateau_lr is not None:
            self._plateau = ReduceLROnPlateau(c["learning_rate"], mode="min", factor=c["gamma"],
                                              patience=c["plateau_patience"])
        self._uses_freeze = bool(c["freeze_backbone"] or c["unfreeze_schedule"])
        self._active_prefixes = None
        init_weights(self.module, c["seed"])
        self.module.to(self.device).train()
        set_mesh(self.module, self.mesh)
        replicate(self.mesh, list(self.module.state_dict().values()))
        params = dict(self.module.named_parameters())
        opt_state = self.optimizer.init(params, masked=self._uses_freeze, plateau_lr=plateau_lr)
        self.state = steps.module_state(self.module, opt_state)
        if c["use_class_weights"] and self.train_ds is not None:
            weights = compute_class_weights(self.train_ds.labels, c["num_classes"])
        else:
            weights = np.ones((c["num_classes"],), np.float32)
        self._class_weights = torch.from_numpy(np.asarray(weights, np.float32)).to(self.device)
        self._train_step = steps.shard_train_step(
            steps.make_classifier_train_step(self.module, self.optimizer, c["label_smoothing"]),
            self.mesh)
        aug_raw = c.get("augmentation")
        if isinstance(aug_raw, dict) and "train" in aug_raw:
            aug_raw = aug_raw["train"]
        from iqc_tpu_torch.data.augmentation import classifier_augment_config

        self._aug_cfg = classifier_augment_config(aug_raw)
        if self._aug_cfg is not None:
            logger.info("train-time augmentation active: %s", self._aug_cfg)
        self._device_corpus = None

    def load_flax_state(self, state) -> None:
        """Take the JAX trainer's state (its ``TrainState`` with optax's
        state, as device or numpy arrays) into this trainer, which ``build``
        has set up for the same model and optimizer."""
        from iqc_tpu_torch import weights

        self.load_state(weights.train_state_from_flax(state))

    def load_state(self, s: Dict[str, Any]) -> None:
        """Take a state in the form ``weights.train_state_from_flax``
        returns into this trainer."""
        opt = self.state.opt_state
        if (s["mask"] is None) != (opt.mask is None):
            raise ValueError("the state's optimizer and this trainer's differ in the mask stage")
        with torch.no_grad():
            for name, t in self.state.params.items():
                t.copy_(s["params"][name])
            for name, t in self.state.batch_stats.items():
                t.copy_(s["batch_stats"][name])
            for leaf in ("trace", "mu", "nu"):
                for name, t in (getattr(opt, leaf) or {}).items():
                    t.copy_(s[leaf][name])
        self.state.step = s["step"]
        opt.count, opt.mask = s["count"], s["mask"]
        if opt.learning_rate is not None:
            opt.learning_rate = s["learning_rate"]

    # -- the step ------------------------------------------------------------------------

    def _draws(self, step: int, batch: int, height: int, width: int):
        """Update ``step``'s augmentation draws (generator seeded from
        (seed + 7919, step)) and dropout keep masks ((seed, step))."""
        if self.draw_hook is not None:
            return self.draw_hook(step, batch)
        from iqc_tpu_torch.data.augmentation import draw_augment

        seed = self.config["seed"]
        aug = None
        if self._aug_cfg is not None:
            aug = draw_augment(_generator(seed + AUG_SEED_OFFSET, step), batch, height, width,
                               self._aug_cfg, self.device)
        masks = self.module.draw_dropout_masks(batch, _generator(seed, step))
        return aug, masks

    def _step(self, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update from a uint8 batch [B,S,S,3] and int labels [B] on the
        device: on a mesh, this rank's rows of a global batch of B times the
        data size (the draws are the global batch's, cut to the rows).
        Returns the global batch's loss and accuracy."""
        h, w = images.shape[1:3]
        b = images.shape[0] * self.mesh.data_size
        aug, masks = self._draws(self.state.step, b, h, w)
        masks, aug = shard_batch(self.mesh, (tuple(masks), aug), upload=False)
        masks = tuple(upload(m, self.device) for m in masks)
        if self._aug_cfg is not None:
            from iqc_tpu_torch.data.augmentation import augment_image_and_boxes
            from iqc_tpu_torch.ops.image import normalize_imagenet

            x = images.to(torch.float32) * (1.0 / 255.0)
            x = augment_image_and_boxes(x, None, aug, self._aug_cfg)[0]
            images = normalize_imagenet(x)
        return self._train_step(self.state, images, labels.long(), self._class_weights, masks)

    def _finish_epoch(self, outs: List[Dict[str, torch.Tensor]], t0: float) -> Dict[str, float]:
        if not outs:
            self.step_metrics = []
            return {"loss": 0.0, "accuracy": 0.0, "epoch_seconds": 0.0}
        stacked = {k: torch.stack([o[k] for o in outs]).cpu() for k in outs[0]}
        self.step_metrics = [{k: float(v[i]) for k, v in stacked.items()}
                             for i in range(len(outs))]
        return {"loss": float(stacked["loss"].mean()),
                "accuracy": float(stacked["accuracy"].mean()),
                "epoch_seconds": time.time() - t0}

    # -- data tiers --------------------------------------------------------------------

    def _maybe_device_corpus(self):
        """The training set on the device, uploaded once, when it loads
        (``load`` and ``labels``), is at the training size and fits
        IQC_DEVICE_CORPUS_MB (default 2048): (images uint8 [N,S,S,3],
        labels int64 [N]), else None (streaming)."""
        if self._device_corpus is not None:
            return self._device_corpus
        if self.mesh.size > 1:  # the JAX package streams on a mesh
            return None
        ds = self.train_ds
        if ds is None or not hasattr(ds, "load") or not hasattr(ds, "labels"):
            return None
        n = len(ds)
        size = self.config["image_size"]
        cap_mb = float(os.environ.get("IQC_DEVICE_CORPUS_MB", "2048"))
        if n == 0 or n * size * size * 3 / 2**20 > cap_mb:
            return None
        if ds.load(0)[0].shape[0] != size:
            return None
        imgs = np.zeros((n, size, size, 3), np.uint8)
        for i in range(n):
            imgs[i] = ds.load(i)[0]
        logger.info("device-resident corpus: %d images (%.0f MB) uploaded once",
                    n, imgs.nbytes / 2**20)
        self._device_corpus = (torch.from_numpy(imgs).to(self.device),
                               torch.from_numpy(np.asarray(ds.labels, np.int64)).to(self.device))
        return self._device_corpus

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The device-corpus tier's [steps, batch] sample indices of
        ``epoch``: balanced (or a tiled permutation) from
        ``default_rng(seed + epoch)``."""
        c = self.config
        n_steps, bs = max(len(self.train_loader), 1), c["batch_size"]
        rng = np.random.default_rng(c["seed"] + epoch)
        labels = np.asarray(self.train_ds.labels)
        if c["balanced_sampling"]:
            idx = balanced_sample_indices(labels, n_steps * bs, rng)
        else:
            idx = rng.permutation(len(labels))
            idx = np.tile(idx, int(np.ceil(n_steps * bs / max(len(idx), 1))))[:n_steps * bs]
        return idx.reshape(n_steps, bs)

    def _corpus_epoch(self, corpus, idx: np.ndarray) -> List[Dict[str, torch.Tensor]]:
        imgs, labels = corpus
        outs = []
        for row in idx:
            i = upload(torch.from_numpy(np.ascontiguousarray(row, np.int64)), self.device)
            outs.append(self._step(imgs[i], labels[i]))
        return outs

    def train_step(self, images, labels) -> Dict[str, torch.Tensor]:
        """One update from a host or device batch (on a mesh the global
        batch, of which this rank takes its rows)."""
        return self._step(*shard_batch(self.mesh, (images, labels)))

    def _stream_epoch(self) -> List[Dict[str, torch.Tensor]]:
        return [self._step(b["images"], b["labels"])
                for b in device_prefetch(self.train_loader, self.mesh)]

    # -- loops -------------------------------------------------------------------------

    def _trainable_prefixes(self, epoch: int) -> tuple:
        """Parameter-name prefixes trainable at ``epoch``: the head always,
        stage4 with ``freeze_backbone``, and the layers of the latest
        ``unfreeze_schedule`` entry at or before ``epoch`` (layerN = stageN)."""
        c = self.config
        trainable = {"head"}
        if c["freeze_backbone"]:
            trainable.add("stage4")
        active = None
        for entry in sorted(c["unfreeze_schedule"], key=lambda e: e["epoch"]):
            if epoch >= int(entry["epoch"]):
                active = entry
        if active:
            for layer in active.get("layers", ()):
                trainable.add(str(layer).replace("layer", "stage"))
        return tuple(sorted(trainable))

    def _apply_freeze(self, epoch: int) -> None:
        """Set the update mask for ``epoch`` (frozen parameters stay bitwise
        unchanged, weight decay included)."""
        if not self._uses_freeze:
            return
        prefixes = self._trainable_prefixes(epoch)
        if prefixes == self._active_prefixes:
            return
        self._active_prefixes = prefixes
        mask = {k: float(any(k.startswith(p) for p in prefixes)) for k in self.state.params}
        self.state.opt_state = steps.set_update_mask(self.state.opt_state, mask)
        logger.info("epoch %d: trainable param groups = %s", epoch, ", ".join(prefixes))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        t0 = time.time()
        self._apply_freeze(epoch)
        corpus = self._maybe_device_corpus()
        if corpus is not None:
            outs = self._corpus_epoch(corpus, self.epoch_indices(epoch))
        else:
            outs = self._stream_epoch()
        return self._finish_epoch(outs, t0)

    def _eval_batches(self, loader):
        outs = [self._eval_step(b["images"], torch.as_tensor(b["labels"]))
                for b in device_prefetch(loader, self.mesh, leaves=("images",))]
        if not outs:
            return None
        return {k: torch.cat([o[k].reshape(-1, *o[k].shape[1:]) for o in outs]).cpu().numpy()
                for k in outs[0]}

    def _eval_step(self, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The evaluation outputs (loss, preds, labels, probs) of a global
        batch: this rank's (padded) rows through the network in evaluation
        mode, every rank's logits gathered, and the outputs of the whole
        batch computed from them on every rank."""
        with torch.no_grad():
            self.module.eval()
            logits = self.module(steps.device_normalize(images))
            logits = all_gather_rows(self.mesh, logits)[:labels.shape[0]]
            return steps.classifier_eval_outputs(logits, labels.to(self.device).long())

    def evaluate(self, loader) -> Dict[str, float]:
        """Mean loss, accuracy and macro P/R/F1 of the model in evaluation
        mode over ``loader``'s batches."""
        out = self._eval_batches(loader)
        if out is None:
            return {"loss": 0.0, "accuracy": 0.0}
        preds, labels = out["preds"], out["labels"]
        metrics = {"loss": float(np.mean(out["loss"])), "accuracy": float(np.mean(preds == labels))}
        metrics.update(precision_recall_f1(preds, labels, self.config["num_classes"]))
        return metrics

    def train(self, epochs: Optional[int] = None) -> Dict:
        c = self.config
        epochs = epochs or c["epochs"]
        if self._train_step is None:
            self.build(steps_per_epoch=max(len(self.train_loader), 1))
        stopper = EarlyStopping(patience=c["early_stopping_patience"], mode="max")
        best_acc = 0.0
        for epoch in range(self.start_epoch, epochs):
            train_m = self.train_epoch(epoch)
            row = {"loss": train_m["loss"], "accuracy": train_m["accuracy"],
                   "learning_rate": self.current_learning_rate()}
            if self.val_loader is not None and (epoch + 1) % c["val_frequency"] == 0:
                val_m = self.evaluate(self.val_loader)
                row.update({f"val_{k}": v for k, v in val_m.items() if isinstance(v, (int, float))})
                acc = val_m["accuracy"]
                best_acc = max(best_acc, acc)
                if self.mesh.is_main:
                    self.checkpoints.step(epoch, row, self.variables())
                if self._plateau is not None:
                    new_lr = self._plateau.step(val_m["loss"])
                    if new_lr != row["learning_rate"]:
                        self.set_learning_rate(new_lr)
                        logger.info("plateau: lr -> %.3g", new_lr)
                if stopper.step(acc):
                    logger.info("early stopping at epoch %d", epoch)
                    self.metrics.update(row)
                    break
            self.metrics.update(row)
            logger.info("epoch %d: loss=%.4f acc=%.4f val_acc=%s (%.1fs)", epoch, row["loss"],
                        row["accuracy"], f"{row.get('val_accuracy', float('nan')):.4f}",
                        train_m["epoch_seconds"])
        art = c["checkpoint_dir"]
        if self.mesh.is_main:
            self.metrics.export_json(os.path.join(art, "history.json"))
            self.metrics.export_csv(os.path.join(art, "scalars.csv"))
            self.metrics.plot(os.path.join(art, "training_curves.png"))
        report = training_report(self.metrics.history,
                                 path=(os.path.join(art, "training_report.json")
                                       if self.mesh.is_main else None))
        report["best_val_accuracy"] = best_acc
        return report

    # -- learning rate (the plateau schedule) ---------------------------------------------

    def current_learning_rate(self) -> float:
        """The plateau schedule's injected rate; the configured base rate for
        the other schedules."""
        if self._plateau is not None:
            return float(self.state.opt_state.learning_rate)
        return float(self.config["learning_rate"])

    def set_learning_rate(self, lr: float) -> None:
        """Lower (or set) the plateau schedule's rate; the next step uses it."""
        self.state.opt_state = steps.set_learning_rate(self.state.opt_state, lr)

    def test(self, plot_dir: Optional[str] = None) -> Dict:
        """Held-out evaluation: accuracy, P/R/F1, the confusion matrix, and
        the per-class ROC-AUC (with ROC and confusion-matrix plots where
        matplotlib is installed)."""
        if self.test_ds is None:
            return {"error": "no test split"}
        c = self.config
        out = self._eval_batches(DataLoader(self.test_ds, c["batch_size"], shuffle=False,
                                            drop_last=False))
        preds, labels, probs = out["preds"], out["labels"], out["probs"]
        result = {"accuracy": float(np.mean(preds == labels))}
        result.update(precision_recall_f1(preds, labels, c["num_classes"]))
        cm = confusion_matrix(preds, labels, c["num_classes"])
        result["confusion_matrix"] = cm.tolist()
        from iqc_tpu_torch.train.utils import (multiclass_roc_auc, plot_confusion_matrix,
                                               plot_roc_curves)

        names = list(DEFECT_CLASSES)[:c["num_classes"]]
        plot_dir = plot_dir or c["checkpoint_dir"]
        aucs = multiclass_roc_auc(labels, probs)
        if self.mesh.is_main:  # rank 0 draws the plots
            try:
                plot_roc_curves(labels, probs, names, os.path.join(plot_dir, "roc_curves.png"))
                plot_confusion_matrix(cm, names, os.path.join(plot_dir, "confusion_matrix.png"))
            except Exception:  # plotting never fails the evaluation
                pass
        result["roc_auc"] = {names[k]: v for k, v in aucs.items() if k < len(names)}
        return result

    # -- checkpoints -------------------------------------------------------------------

    def variables(self) -> Dict[str, Any]:
        """The weights and statistics as a Flax variables tree (numpy)."""
        from iqc_tpu_torch import weights

        return weights.to_flax(self.module)

    def save(self, path: str, epoch: int = 0) -> None:
        """Weights-only Flax msgpack checkpoint (``ResNetClassifier(model_path
        =...)`` of either package loads it), the epoch and config beside it;
        on a mesh rank 0 writes and every rank waits for it."""
        if self.mesh.is_main:
            save_variables(path, self.variables(), {"epoch": epoch, "config": self.config})
        self.mesh.barrier()

    def save_full(self, path: str, epoch: int = 0) -> None:
        """The full train state (step, weights, statistics, optimizer state)
        in the JAX package's layout (rank 0 writes)."""
        from iqc_tpu_torch.train.checkpoint import save_train_state

        if self.mesh.is_main:
            save_train_state(path, self.module, self.state,
                             {"epoch": epoch, "config": self.config})
        self.mesh.barrier()

    def resume(self, path: str) -> None:
        """Restore a full train-state checkpoint, or, where the file holds
        weights only, the weights with a fresh optimizer state; the epoch
        from its sidecar."""
        if self._train_step is None:
            self.build(steps_per_epoch=max(len(self.train_loader or []), 1))
        from iqc_tpu_torch import weights
        from iqc_tpu_torch.train.checkpoint import load_train_state

        try:
            self.state = load_train_state(path, self.module, self.state)
        except ValueError:
            loaded = load_variables(path, self.variables())
            weights.load_into(self.module, loaded)
            self.module.to(self.device)
            params = dict(self.module.named_parameters())
            opt = self.state.opt_state
            fresh = self.optimizer.init(params, masked=opt.mask is not None,
                                        plateau_lr=(self.config["learning_rate"]
                                                    if opt.learning_rate is not None else None))
            self.state = steps.module_state(self.module, fresh, step=self.state.step)
        meta_path = path + ".json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.start_epoch = int(json.load(f).get("epoch", 0))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Train the ResNet-50 defect classifier")
    parser.add_argument("--config", default=None,
                        help="training profile, JSON (or YAML with PyYAML), shaped like "
                             "config/resnet_config.yaml")
    parser.add_argument("--data-dir", required=True,
                        help="dir with train/ (and val/, test/), a folder per class")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from iqc_tpu_torch.config import read_config_file

    config = config_from_profile(read_config_file(args.config)) if args.config else {}
    if args.epochs:
        config["epochs"] = args.epochs
    # under a launcher: this rank's device and the job's process group
    trainer = ResNetTrainer.from_image_folders(args.data_dir, config,
                                               device=distributed_init(args.device))
    trainer.build(steps_per_epoch=max(len(trainer.train_loader), 1))
    if args.resume:
        trainer.resume(args.resume)
    out = {"train": trainer.train()}
    if trainer.test_ds is not None:
        out["test"] = trainer.test()
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    # the kernels this run launched (the classifier's path has none)
    out["kernel_launches"] = {**nms_kernel.LAUNCHES, **morph_kernel.LAUNCHES}
    trainer.save(os.path.join(trainer.config["checkpoint_dir"], "final_model.msgpack"))
    if trainer.mesh.is_main:
        print(json.dumps(out))
    if trainer.mesh.distributed:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
