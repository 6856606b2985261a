"""Checkpoints of model variables and of the training state.

The write side of the JAX package's ``train/checkpoint.py``: Flax msgpack
(``weights.save_variables``) with a JSON metadata sidecar, so that a model
checkpoint either package writes loads in the other. Variables trees are
Flax-shaped nested dicts (``weights.to_flax`` of a module).

``save_train_state`` writes the training state in the layout of the JAX
package's train-state checkpoint of the same optimizer, (step, params,
batch_stats, optax state) with the optax chain's leaves in their places
(the YOLO chain's trace, count and mask; the classifier chain's Adam
moments or Nesterov trace, counts, injected learning rate and mask);
``load_train_state`` restores it into a trainer's state.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from iqc_tpu_torch import weights
from iqc_tpu_torch.weights import save_variables

logger = logging.getLogger(__name__)

__all__ = ["save_variables", "load_variables", "try_load_variables", "load_metadata",
           "save_train_state", "load_train_state", "CheckpointManager"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {".".join(prefix): tree}


def load_variables(path: str, template) -> Dict[str, Any]:
    """The tree at ``path`` (numpy leaves), checked against ``template``
    (a nested dict): the same key paths and every leaf's shape, else
    ValueError. A missing file raises FileNotFoundError."""
    raw = weights.read_checkpoint(path)
    stored, target = _flat(raw), _flat(template)
    if set(stored) != set(target):
        extra = sorted(set(stored) - set(target))
        missing = sorted(set(target) - set(stored))
        raise ValueError(
            f"checkpoint structure mismatch: {len(extra)} key(s) not in model "
            f"(e.g. {extra[:5]}), {len(missing)} model key(s) absent (e.g. {missing[:5]})")
    for k, v in target.items():
        if tuple(np.shape(stored[k])) != tuple(np.shape(v)):
            raise ValueError(f"checkpoint leaf {k} has shape {np.shape(stored[k])}, "
                             f"model expects {np.shape(v)}")
    return raw


def try_load_variables(path: str, template) -> Optional[Dict[str, Any]]:
    """``load_variables``, or None where the file is missing (logged); a
    malformed or mismatched file raises ValueError."""
    try:
        return load_variables(path, template)
    except FileNotFoundError:
        logger.warning("checkpoint %s not found; using initialized weights", path)
        return None
    except Exception as e:  # malformed or incompatible: fail loudly
        raise ValueError(f"corrupt or incompatible checkpoint {path!r}: {e}") from e


def load_metadata(path: str) -> Dict:
    try:
        with open(path + ".json") as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def _classifier_opt_tree(module: torch.nn.Module, opt) -> Dict[str, Any]:
    """optax's state of the classifier's chain (``steps.ClassifierOptState``):
    add_decayed_weights -> adam, adamw, or sgd with Nesterov momentum, each
    with a schedule's count where it has one, under inject_hyperparams for
    the plateau schedule."""
    tree = lambda values: weights.to_flax(module, values)["params"]
    count = np.asarray(opt.count, np.int32)
    sched = {"count": count} if opt.scheduled and opt.learning_rate is None else {}
    if opt.kind == "sgd":
        inner = {"0": {"trace": tree(opt.trace)}, "1": sched}
    else:
        adam = {"count": count, "mu": tree(opt.mu), "nu": tree(opt.nu)}
        inner = ({"0": {}, "1": {"0": adam, "1": sched}} if opt.kind == "adam"
                 else {"0": adam, "1": {}, "2": sched})
    if opt.learning_rate is not None:
        inner = {"count": count,
                 "hyperparams": {"learning_rate": np.asarray(opt.learning_rate, np.float32)},
                 "hyperparams_states": {}, "inner_state": inner}
    return inner


def _train_state_tree(module: torch.nn.Module, state) -> Dict[str, Any]:
    """(step, params, batch_stats, optax state) as the JAX package's
    ``save_train_state`` lays it out: for ``steps.SGDState``
    add_decayed_weights -> sgd with momentum, for
    ``steps.ClassifierOptState`` the classifier's chain (-> the mask
    stage)."""
    from iqc_tpu_torch.train.steps import ClassifierOptState

    flax = weights.to_flax(module)
    opt = state.opt_state
    if isinstance(opt, ClassifierOptState):
        chain = _classifier_opt_tree(module, opt)
    else:
        chain = {"0": {}, "1": {"0": {"trace": weights.to_flax(module, opt.trace)["params"]},
                                "1": {"count": np.asarray(opt.count, np.int32)}}}
    if opt.mask is not None:
        chain = {"0": chain, "1": {"mask": weights.to_flax(module, opt.mask)["params"]}}
    return {"0": np.asarray(state.step, np.int32), "1": flax["params"],
            "2": flax["batch_stats"], "3": chain}


def save_train_state(path: str, module: torch.nn.Module, state,
                     metadata: Optional[Dict] = None) -> None:
    """Write the full training state of ``module`` (a ``steps.TrainState``
    over it): step, parameters, statistics and the optimizer's state."""
    save_variables(path, _train_state_tree(module, state), metadata)


def load_train_state(path: str, module: torch.nn.Module, state):
    """Restore a file of ``save_train_state`` (of either package, for the
    same model and optimizer) into ``module`` and ``state``; returns the
    state with its step and optimizer state (trace or moments, count,
    mask, injected rate) from the file."""
    import dataclasses

    raw = load_variables(path, _train_state_tree(module, state))
    loaded = weights.train_state_from_flax(raw)
    opt = state.opt_state
    with torch.no_grad():
        for name, t in {**state.params, **state.batch_stats}.items():
            t.copy_(loaded["params"].get(name, loaded["batch_stats"].get(name)))
        for leaf in ("trace", "mu", "nu"):
            for name, t in (getattr(opt, leaf, None) or {}).items():
                t.copy_(loaded[leaf][name])
    changes = {"count": loaded["count"],
               "mask": loaded["mask"] if opt.mask is not None else None}
    if getattr(opt, "learning_rate", None) is not None:
        changes["learning_rate"] = loaded["learning_rate"]
    return dataclasses.replace(state, step=loaded["step"],
                               opt_state=dataclasses.replace(opt, **changes))


class CheckpointManager:
    """Monitor/mode/save-frequency checkpoint policy over msgpack weights."""

    def __init__(self, directory: str, monitor: str = "val_accuracy", mode: str = "max",
                 save_frequency: int = 1, keep_best_only: bool = True):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.save_frequency = save_frequency
        self.keep_best_only = keep_best_only
        self.best: Optional[float] = None
        os.makedirs(directory, exist_ok=True)

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value > self.best if self.mode == "max" else value < self.best

    def step(self, epoch: int, metrics: Dict[str, float], variables) -> Dict[str, Any]:
        """Record an epoch; save the best and/or periodic checkpoints."""
        saved = {}
        value = float(metrics.get(self.monitor, float("nan")))
        meta = {"epoch": epoch, "metrics": metrics, "monitor": self.monitor}
        if not np.isnan(value) and self._improved(value):
            self.best = value
            best_path = os.path.join(self.directory, "best_model.msgpack")
            save_variables(best_path, variables, meta)
            saved["best"] = best_path
        if not self.keep_best_only and self.save_frequency and epoch % self.save_frequency == 0:
            path = os.path.join(self.directory, f"checkpoint_epoch_{epoch}.msgpack")
            save_variables(path, variables, meta)
            saved["periodic"] = path
        return saved
