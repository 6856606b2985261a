"""Checkpoints of model variables and of the training state.

The write side of the JAX package's ``train/checkpoint.py``: Flax msgpack
(``weights.save_variables``) with a JSON metadata sidecar, so that a model
checkpoint either package writes loads in the other. Variables trees are
Flax-shaped nested dicts (``weights.to_flax`` of a module).

``save_train_state`` writes the training state in the layout of the JAX
package's train-state checkpoint of the same optimizer, (step, params,
batch_stats, optax state) with the optax chain's trace, count and mask in
their places; ``load_train_state`` restores it into a trainer's state.
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


def _train_state_tree(module: torch.nn.Module, state) -> Dict[str, Any]:
    """(step, params, batch_stats, optax state) as the JAX package's
    ``save_train_state`` lays it out for add_decayed_weights -> sgd with
    momentum (-> the mask stage)."""
    flax = weights.to_flax(module)
    opt = state.opt_state
    sgd = {"0": {}, "1": {"0": {"trace": weights.to_flax(module, opt.trace)["params"]},
                          "1": {"count": np.asarray(opt.count, np.int32)}}}
    if opt.mask is not None:
        sgd = {"0": sgd, "1": {"mask": weights.to_flax(module, opt.mask)["params"]}}
    return {"0": np.asarray(state.step, np.int32), "1": flax["params"],
            "2": flax["batch_stats"], "3": sgd}


def save_train_state(path: str, module: torch.nn.Module, state,
                     metadata: Optional[Dict] = None) -> None:
    """Write the full training state of ``module`` (a ``steps.TrainState``
    over it): step, parameters, statistics and the optimizer's state."""
    save_variables(path, _train_state_tree(module, state), metadata)


def load_train_state(path: str, module: torch.nn.Module, state):
    """Restore a file of ``save_train_state`` (of either package, for the
    same model and optimizer) into ``module`` and ``state``; returns the
    state with its step, trace, count and mask from the file."""
    import dataclasses

    raw = load_variables(path, _train_state_tree(module, state))
    loaded = weights.train_state_from_flax(raw)
    with torch.no_grad():
        for name, t in {**state.params, **state.batch_stats}.items():
            t.copy_(loaded["params"].get(name, loaded["batch_stats"].get(name)))
        for name, t in state.opt_state.trace.items():
            t.copy_(loaded["trace"][name])
    opt = dataclasses.replace(state.opt_state, count=loaded["count"],
                              mask=loaded["mask"] if state.opt_state.mask is not None else None)
    return dataclasses.replace(state, step=loaded["step"], opt_state=opt)


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
