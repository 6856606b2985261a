"""Rank bodies of the port's multi-rank tests on the CPU, and their launcher.

``launch`` starts one spawned process per rank, each joined to a gloo group
through a file store in a temporary directory (no port to collide under
pytest-xdist), runs one of the bodies below with the same arguments on
every rank and returns each rank's result; ``start`` returns at once, so
that the parent computes its references while the ranks run. Every launch
has a deadline: a hung collective ends the processes and raises, and each
group's own timeout makes a waiting collective raise before that.

This module imports neither JAX nor pytest, so that the ranks start in
about a second; the tests hand them numpy inputs and weights.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60.0


def _entry(rank, world, store, call_path, out_path, threads):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(threads)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        from iqc_tpu_torch.parallel.mesh import distributed_init

        distributed_init("cpu", timeout_s=COLLECTIVE_TIMEOUT_S, init_method=f"file://{store}")
        result = ("ok", fn(*args))
        if torch.distributed.is_initialized():  # a trainer's main ends its group itself
            torch.distributed.destroy_process_group()
    except BaseException:  # the parent reports the rank's traceback
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


class Launch:
    """Ranks started by ``start``, running while the parent works. As a
    context manager it collects their results on leaving (``outs``, in rank
    order), or ends every rank if the block raised."""

    def __init__(self, fn, world: int, args, timeout_s: float, threads: int):
        ctx = multiprocessing.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="iqc_ranks_")
        tmp = self._tmp.name
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        self._outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        self._procs = [ctx.Process(target=_entry, args=(r, world, os.path.join(tmp, "store"),
                                                        call_path, self._outs[r], threads))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self.timeout_s = timeout_s
        self._deadline = time.monotonic() + timeout_s
        self.outs = None

    def _end(self):
        hung = [r for r, p in enumerate(self._procs) if p.is_alive()]
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        return hung

    def results(self):
        """Wait for the ranks until the deadline; their results in rank
        order. Raises with a rank's traceback if one failed, and
        TimeoutError (after ending every rank) past the deadline."""
        try:
            for p in self._procs:
                p.join(max(self._deadline - time.monotonic(), 0.0))
            hung = self._end()
            if hung:
                raise TimeoutError(f"ranks {hung} still ran after {self.timeout_s:.0f} s")
            results = []
            for r, path in enumerate(self._outs):
                if not os.path.exists(path):
                    raise RuntimeError(f"rank {r} exited {self._procs[r].exitcode} "
                                       "without a result")
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
                if status != "ok":
                    raise RuntimeError(f"rank {r} failed:\n{value}")
                results.append(value)
            return results
        finally:
            self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.outs = self.results()
        else:
            self._end()
            self._tmp.cleanup()
        return False


def start(fn, world: int, *args, timeout_s: float = 120.0, threads: int = 1) -> Launch:
    """Start ``fn(*args)`` on ``world`` gloo ranks and return at once; the
    deadline counts from here. The call reaches the ranks through a file: a
    process's start waits until its child has read what goes through the
    pipe, so large arguments there would start the ranks one after
    another."""
    return Launch(fn, world, args, timeout_s, threads)


def launch(fn, world: int, *args, timeout_s: float = 120.0, threads: int = 1):
    """``fn(*args)`` on ``world`` gloo ranks: the list of their results in
    rank order (``Launch.results``)."""
    return start(fn, world, *args, timeout_s=timeout_s, threads=threads).results()


def _torch(tree):
    """numpy leaves of a state (``weights.train_state_from_flax``'s form,
    sent as numpy) back to tensors."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# -- the mesh helpers, global batch statistics, the loss's normaliser -------------------


def mesh_helpers(x_bn, loss_inputs):
    """Mesh sizes, shard_batch, replicate, cross_replica_mean; a train-mode
    BatchNorm on this rank's rows of ``x_bn`` (its outputs, statistics and
    gradients); the YOLO loss on this rank's rows of ``loss_inputs``."""
    from iqc_tpu_torch.config import MeshConfig
    from iqc_tpu_torch.models.layers import BatchNorm, set_mesh
    from iqc_tpu_torch.parallel import mesh as pm
    from iqc_tpu_torch.train.yolo_loss import yolo_loss

    rank = torch.distributed.get_rank()
    out = {}
    spec = pm.create_mesh(MeshConfig())
    out["every_rank"] = (spec.data_size, spec.model_size, spec.data_index, spec.model_index)
    mp2 = pm.create_mesh(MeshConfig(model_parallel=2))
    out["model_parallel_2"] = (mp2.data_size, mp2.model_size, mp2.data_index, mp2.model_index)
    # the data axis of a 2 x 2 mesh: the ranks of this model index
    out["model_parallel_2_mean"] = float(pm.cross_replica_mean(
        mp2, torch.tensor([float(rank)]))[0])
    for name, cfg in (("too_large", {"data_parallel": 8}), ("too_small", {"data_parallel": 2}),
                      ("model_not_dividing", {"model_parallel": 3})):
        try:
            pm.create_mesh(cfg)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    even = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    ragged = {"x": np.arange(10 * 2, dtype=np.int32).reshape(10, 2),
              "m": np.ones(10, bool)}
    out["shard_even"] = _np(pm.shard_batch(spec, even))
    out["shard_ragged"] = _np(pm.shard_batch(spec, ragged))
    out["rows_of_10"] = pm.data_parallel_sharding(spec, 10)
    out["replicate"] = _np(pm.replicate(spec, {"w": torch.full((2, 2), float(rank + 1)),
                                               "b": np.full(3, rank, np.int64)}))
    out["mean"] = _np(pm.cross_replica_mean(spec, [torch.full((3,), float(rank)),
                                                  torch.arange(4.0) * rank]))
    out["gather"] = _np(pm.all_gather_rows(spec, torch.tensor([[rank, rank]])))

    # BatchNorm: statistics and gradients of the global batch
    bn = BatchNorm(x_bn.shape[1], eps=1e-3).train()
    set_mesh(bn, spec)
    x = pm.shard_batch(spec, torch.from_numpy(x_bn)).requires_grad_(True)
    y = bn(x)
    w = torch.linspace(-1.0, 1.0, y[0].numel()).reshape(y.shape[1:])
    (y * w).sum().backward()
    out["bn"] = {"y": _np(y), "dx": _np(x.grad),
                 "dweight": _np(pm.all_reduce_sum(spec, bn.weight.grad)),
                 "dbias": _np(pm.all_reduce_sum(spec, bn.bias.grad)),
                 "running_mean": _np(bn.running_mean), "running_var": _np(bn.running_var)}

    # the loss's normaliser
    dist_l, cls_l, anchors, strides, gt_b, gt_c, gt_v, reg_max = loss_inputs
    rows = pm.shard_batch(spec, [torch.from_numpy(a) for a in (dist_l, cls_l, gt_b, gt_c, gt_v)])
    total, parts = yolo_loss(rows[0], rows[1], torch.from_numpy(anchors),
                             torch.from_numpy(strides), rows[2], rows[3], rows[4], reg_max,
                             mesh=spec)
    out["loss_share"] = float(total)
    out["loss_parts"] = {k: float(v) for k, v in parts.items()}
    local, _ = yolo_loss(rows[0], rows[1], torch.from_numpy(anchors), torch.from_numpy(strides),
                         rows[2], rows[3], rows[4], reg_max)
    out["loss_local"] = float(local)
    return out


# -- training steps ----------------------------------------------------------------------


def _yolo_state(tr):
    return {"params": _np(tr.state.params), "batch_stats": _np(tr.state.batch_stats),
            "ema": _np(tr.ema_params), "trace": _np(tr.state.opt_state.trace)}


def yolo_step(config, state, batch):
    """One step of the port's YOLOTrainer on this rank's rows of ``batch``
    (the global batch), from ``state`` (``weights.train_state_from_flax``'s
    form): the global loss parts and the state after it."""
    from iqc_tpu_torch.train.train_yolo import YOLOTrainer

    tr = YOLOTrainer(config, device="cpu")
    tr.build(steps_per_epoch=2)
    tr.load_state(_torch(state))
    parts = tr.train_step(batch["images"], batch["boxes"], batch["classes"], batch["valid"])
    return {"mesh": tr.mesh.data_size, "parts": {k: float(v) for k, v in parts.items()},
            **_yolo_state(tr)}


def classifier_step(config, state, images, labels, masks):
    """One step of the port's ResNetTrainer on this rank's rows of the
    global batch, the dropout keep ``masks`` of the global batch fed
    through ``draw_hook``: the global loss and accuracy and the state."""
    from iqc_tpu_torch.data.pipeline import ArrayDataset
    from iqc_tpu_torch.train.train_resnet import ResNetTrainer

    tr = ResNetTrainer(config, device="cpu")
    tr.setup_data(ArrayDataset(images, labels))
    tr.build(steps_per_epoch=1)
    tr.load_state(_torch(state))
    tr.draw_hook = lambda step, b: (None, tuple(torch.from_numpy(m) for m in masks))
    m = tr.train_step(images, labels)
    opt = tr.state.opt_state
    return {"mesh": tr.mesh.data_size, "metrics": {k: float(v) for k, v in m.items()},
            "params": _np(tr.state.params), "batch_stats": _np(tr.state.batch_stats),
            "mu": _np(opt.mu), "nu": _np(opt.nu)}


def train_mains(jobs, store_dir):
    """``main`` of each trainer's entry point in ``jobs`` ((module, argv)
    pairs), one after the other on this rank: (its rank, the mesh's size,
    what it printed) of each. A ``main`` ends its group, so each later one
    joins a new group through a file store in ``store_dir``."""
    import contextlib
    import importlib
    import io

    from iqc_tpu_torch.parallel.mesh import distributed_init

    results = []
    for i, (module, argv) in enumerate(jobs):
        if not torch.distributed.is_initialized():
            distributed_init("cpu", timeout_s=COLLECTIVE_TIMEOUT_S,
                             init_method=f"file://{os.path.join(store_dir, f'store{i}')}")
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            importlib.import_module(module).main(argv)
        results.append((rank, world, printed.getvalue()))
    return results


# -- the ensemble ------------------------------------------------------------------------


def predictor_run_sharded(jobs, images):
    """For each (config, resnet_vars) of ``jobs``: the port's
    EnsemblePredictor of ``config`` (its ResNet's weights from
    ``resnet_vars``), ``run_sharded`` on the global batch ``images`` and
    ``run_full_sharded``: numpy, the whole batch's."""
    from iqc_tpu_torch.config import SystemConfig
    from iqc_tpu_torch.models.ensemble import EnsemblePredictor
    from iqc_tpu_torch.weights import load_into

    results = []
    for config, resnet_vars in jobs:
        pred = EnsemblePredictor(config=SystemConfig.from_dict(config), device="cpu")
        load_into(pred.resnet, resnet_vars)
        out = pred.run_sharded(images)
        full = pred.run_full_sharded(images)
        results.append({"run": {k: _np(v) for k, v in out._asdict().items()},
                        "full": (full[0]._asdict(), full[1], full[2])})
    return results
