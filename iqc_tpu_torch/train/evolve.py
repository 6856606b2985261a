"""Hyperparameter evolution for the YOLO trainer (numpy over
``YOLOTrainer``), a copy of the JAX package's ``train/evolve.py``: a
(1+lambda) evolution strategy over the trainer's hyperparameters with
multiplicative log-normal mutation (mutate the best parent, clip to bounds,
keep the fittest). With the same ``numpy.random.Generator`` the genes equal
the JAX package's.

Fitness defaults to ``best_mAP50`` of a short ``YOLOTrainer`` run; callers
may pass an analytic one. Results land in ``<out_dir>/evolution.json``
(per-generation history and the best hyperparameters).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# gene -> (lower, upper). Multiplicative mutation keeps values positive;
# bounds mirror Ultralytics' evolve meta ranges for the hyperparams this
# trainer consumes (yolo_config.yaml:44-90 surface).
SEARCH_SPACE: Dict[str, Tuple[float, float]] = {
    "learning_rate": (1e-5, 1e-1),
    "final_lr_fraction": (0.01, 1.0),
    "momentum": (0.6, 0.98),
    "weight_decay": (0.0, 1e-3),
    "warmup_epochs": (0.0, 5.0),
    "box_gain": (0.02, 10.0),
    "cls_gain": (0.2, 4.0),
    "dfl_gain": (0.4, 6.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
}

INT_GENES = ()  # all evolved genes are floats for this trainer


def mutate(genes: Dict[str, float], rng: np.random.Generator,
           mutation_probability: float, sigma: float) -> Dict[str, float]:
    """Log-normal multiplicative mutation, clipped to SEARCH_SPACE bounds.

    Each gene mutates independently with ``mutation_probability``; at
    least one gene always mutates (a no-op child wastes a training run).
    """
    keys = list(genes)
    mask = rng.random(len(keys)) < mutation_probability
    if not mask.any():
        mask[rng.integers(len(keys))] = True
    out = dict(genes)
    for k, m in zip(keys, mask):
        if not m:
            continue
        lo, hi = SEARCH_SPACE[k]
        factor = float(np.exp(rng.normal(0.0, sigma)))
        base = out[k] if out[k] > 0 else (lo if lo > 0 else 1e-3)
        out[k] = float(np.clip(base * factor, lo, hi))
    return out


def evolve_hyperparameters(
    base_config: Dict,
    generations: int = 10,
    population_size: int = 5,
    mutation_probability: float = 0.8,
    sigma: float = 0.2,
    fitness_fn: Optional[Callable[[Dict], float]] = None,
    seed: int = 0,
    out_dir: Optional[str] = None,
    device="cuda",
) -> Dict:
    """(1+λ)-ES over SEARCH_SPACE genes seeded from ``base_config``.

    Each generation trains ``population_size`` mutated children of the
    best-so-far config and keeps the fittest. Returns
    ``{"best_config", "best_fitness", "history"}``; also written to
    ``out_dir/evolution.json`` when ``out_dir`` is set. ``device`` is
    where the default fitness trains.
    """
    rng = np.random.default_rng(seed)
    fitness_fn = fitness_fn or (lambda config: _default_fitness(config, device))
    # genes missing from base_config seed from the trainer's defaults
    # (the same values a plain training run would use), not mid-range
    from iqc_tpu_torch.train.train_yolo import DEFAULT_CONFIG

    seeded = {**DEFAULT_CONFIG, **base_config}
    parent = {k: float(seeded.get(k, (lo + hi) / 2))
              for k, (lo, hi) in SEARCH_SPACE.items()}
    parent = {k: float(np.clip(v, *SEARCH_SPACE[k]))
              for k, v in parent.items()}
    best_fit = fitness_fn({**base_config, **parent})
    history: List[Dict] = [{"generation": 0, "fitness": best_fit,
                            "genes": dict(parent)}]
    logger.info("evolution gen 0: fitness=%.4f (base config)", best_fit)

    for gen in range(1, generations + 1):
        t0 = time.time()
        children = [mutate(parent, rng, mutation_probability, sigma)
                    for _ in range(population_size)]
        fits = [fitness_fn({**base_config, **c}) for c in children]
        i = int(np.argmax(fits))
        if fits[i] > best_fit:
            best_fit, parent = fits[i], children[i]
        history.append({"generation": gen, "fitness": float(fits[i]),
                        "best_fitness": best_fit, "genes": dict(children[i]),
                        "wall_s": round(time.time() - t0, 1)})
        logger.info("evolution gen %d: best=%.4f gen-best=%.4f (%.1fs)",
                    gen, best_fit, fits[i], history[-1]["wall_s"])

    result = {"best_config": {**base_config, **parent},
              "best_fitness": best_fit, "history": history}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "evolution.json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def _default_fitness(config: Dict, device="cuda") -> float:
    """Short training run -> best mAP50 (the Ultralytics evolve metric)."""
    from iqc_tpu_torch.data.yolo_dataset import DetectionLoader, SyntheticDefectDataset
    from iqc_tpu_torch.train.train_yolo import YOLOTrainer

    c = dict(config)
    c.setdefault("epochs", 10)
    c.setdefault("patience", c["epochs"])
    trainer = YOLOTrainer(c, device=device)
    n = int(c.get("evolve_train_images", 256))
    size = trainer.config["image_size"]
    m = trainer.config["max_boxes"]
    train_ds = SyntheticDefectDataset(n, size, m, seed=0)
    val_ds = SyntheticDefectDataset(max(n // 4, 32), size, m, seed=1)
    # device mosaic owns augmentation when active; otherwise the evolved
    # mosaic AND mixup genes must flow to the host loader, else evolution
    # selects mixup on pure run noise
    host_p = 0.0 if trainer.uses_device_mosaic else trainer.config["mosaic"]
    host_m = 0.0 if trainer.uses_device_mosaic else trainer.config["mixup"]
    report = trainer.train(
        DetectionLoader(train_ds, trainer.config["batch_size"],
                        mosaic_prob=host_p, mixup_prob=host_m),
        DetectionLoader(val_ds, trainer.config["batch_size"], mosaic_prob=0,
                        mixup_prob=0, shuffle=False),
    )
    return float(report["best_mAP50"])
