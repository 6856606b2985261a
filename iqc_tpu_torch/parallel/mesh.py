"""The data-parallel mesh on ``torch.distributed``: the port's counterpart of
the JAX package's ``parallel/mesh.py``.

The JAX package runs one process over every device: a ``jax.sharding.Mesh``
splits a global batch over the data axis, and GSPMD inserts the collectives
(the gradient all-reduce, the batch statistics' sums, the batch-wide pools'
gathers). The port runs one process per rank, launched by
``python -m torch.distributed.run`` (torchrun), each rank on its own device
(``cuda:LOCAL_RANK``, or the CPU), and writes those collectives out. The
mapping:

- every rank is handed the same global host batch and the same seed;
  ``shard_batch`` takes this rank's rows (``data_parallel_sharding``),
  padding a ragged batch with zero rows to a multiple of the data size;
- the ranks form a (data, model) grid in rank order: rank r has data index
  ``r // model_size`` and model index ``r % model_size``; the data axis's
  collectives run over the ranks that share a model index (``group``);
- ``replicate`` broadcasts from rank 0, ``cross_replica_mean`` all-reduces a
  sum and scales it by 1/n, ``all_reduce_sum`` (differentiable: its
  backward all-reduces the gradient) and ``all_gather_rows`` are the
  collectives the sharded paths use;
- every rank returns global results, as a JAX global array is: sharded
  forwards gather their outputs, sharded steps reduce their metrics.

The backend follows the device: NCCL on the card, gloo on the CPU. A failed
NCCL initialisation raises; nothing falls back to gloo or to the CPU. A
single process that no launcher started is a mesh of 1 with no group, and
every collective is then the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """This rank's place in a (data, model) grid of ranks. ``group`` is the
    process group of the data axis (the ranks that share this model index),
    None for a single process; ``device`` the rank's device."""

    data_size: int
    model_size: int
    data_index: int
    model_index: int
    device: torch.device
    data_axis: str = "data"
    model_axis: str = "model"
    group: Any = None

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    @property
    def distributed(self) -> bool:
        """True where collectives run (a launched job, also of one rank)."""
        return self.group is not None

    @property
    def is_main(self) -> bool:
        """The rank that writes files and prints reports (rank 0)."""
        return self.data_index == 0 and self.model_index == 0

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def distributed_init(device="cuda", timeout_s: float = 300.0,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group of a job started by a launcher and return
    this rank's device: ``cuda:LOCAL_RANK`` (made current) for a CUDA
    ``device``, else the CPU. The backend follows the device: NCCL on the
    card, gloo on the CPU. Without ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` in the environment (no launcher; ``init_method``, such
    as ``file://...``, stands in for ``MASTER_ADDR``) this is a no-op that
    returns ``device``, as the JAX version is without a coordinator. A
    collective that waits longer than ``timeout_s`` raises."""
    device = torch.device(device)
    env = os.environ
    if any(k not in env for k in _LAUNCH_VARS[:2]) or (
            init_method is None and "MASTER_ADDR" not in env):
        return device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for an NCCL rank; pass a CPU "
                               "device to train over gloo")
        device = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    kw = dict(init_method=init_method or "env://", rank=int(env["RANK"]),
              world_size=int(env["WORLD_SIZE"]),
              timeout=datetime.timedelta(seconds=timeout_s))
    if device.type == "cuda":
        # device_id makes NCCL build its communicator now, so that a failed
        # initialisation raises here
        dist.init_process_group("nccl", device_id=device, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return device


def _get(cfg, key: str, default):
    if cfg is None:
        return default
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def create_mesh(cfg=None, device=None) -> MeshSpec:
    """This rank's mesh from a ``MeshConfig`` (or a dict, or any object with
    its fields; None: every rank). ``data_parallel=-1`` takes every rank of
    the group not claimed by ``model_parallel``; a single process is a mesh
    of 1. Raises ValueError when ``model_parallel`` does not divide the
    group or the mesh asks for another number of ranks than the group has
    (a rank outside the mesh would have nothing to do). ``device``: the
    rank's device (default: the current card under NCCL, else the CPU)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mp = max(1, int(_get(cfg, "model_parallel", 1)))
    if world % mp:
        raise ValueError(f"{world} ranks not divisible by model_parallel={mp}")
    dp = int(_get(cfg, "data_parallel", -1))
    dp = dp if dp > 0 else world // mp
    if dp * mp > world:
        raise ValueError(f"the mesh asks for {dp} x {mp} ranks, more ranks than the group "
                         f"has ({world}); launch one process per rank with "
                         "python -m torch.distributed.run")
    if dp * mp < world:
        raise ValueError(f"the mesh of {dp} x {mp} ranks leaves ranks of the group of {world} "
                         "without work; launch as many ranks as the mesh has")
    if device is None:
        on_card = dist.is_initialized() and dist.get_backend() == "nccl"
        device = "cuda" if on_card else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = None
    if dist.is_initialized():
        if mp == 1:
            group = dist.group.WORLD
        else:
            # every rank creates every group, in the same order
            for m in range(mp):
                g = dist.new_group([d * mp + m for d in range(dp)])
                if m == rank % mp:
                    group = g
    return MeshSpec(data_size=dp, model_size=mp, data_index=rank // mp, model_index=rank % mp,
                    device=device, data_axis=_get(cfg, "data_axis", "data"),
                    model_axis=_get(cfg, "model_axis", "model"), group=group)


def padded_rows(spec: MeshSpec, n: int) -> int:
    """``n`` rounded up to a multiple of the data size."""
    return -(-n // spec.data_size) * spec.data_size


def data_parallel_sharding(spec: MeshSpec, n: int) -> slice:
    """The rows of a batch of ``n`` rows (padded as ``shard_batch`` pads
    it) that this rank holds."""
    per = padded_rows(spec, n) // spec.data_size
    return slice(spec.data_index * per, (spec.data_index + 1) * per)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree)


def _rows(spec: MeshSpec, x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    n = t.shape[0]
    pad = padded_rows(spec, n) - n
    rows = data_parallel_sharding(spec, n)
    if pad:
        t = torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                                      device=t.device)])
    t = t[rows]
    if device is None:
        return t
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_batch(spec: MeshSpec, batch, upload: bool = True):
    """This rank's rows of a global batch (a tree of arrays or tensors),
    each leaf padded with zero rows to a multiple of the data size, on the
    mesh's device (``upload=False`` leaves them where they are)."""
    device = spec.device if upload else None
    return _map(lambda x: _rows(spec, x, device), batch)


def replicate(spec: MeshSpec, tree):
    """Rank 0's values of a tree of tensors or arrays on every rank, on the
    mesh's device: a broadcast over the whole group. Tensors already on the
    device are overwritten in place (so the parameters of a module stay
    its own)."""
    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.device != spec.device:
            t = t.to(spec.device)
        if spec.distributed:
            with torch.no_grad():
                dist.broadcast(t.data, src=0)
        return t

    return _map(put, tree)


def cross_replica_mean(spec: MeshSpec, tree):
    """The mean of a tree of float tensors over the data axis: an all-reduce
    of the sum, times 1/n. New tensors; a mesh of 1 returns copies."""
    def mean(t):
        out = t.detach().clone()
        if spec.distributed:
            dist.all_reduce(out, group=spec.group)
        return out * (1.0 / spec.data_size)

    return _map(mean, tree)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the data axis; the backward sums the incoming gradient over
    the same ranks (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(spec: Optional[MeshSpec], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis (differentiable); ``x`` itself
    without a group."""
    if spec is None or not spec.distributed:
        return x
    return _AllReduceSum.apply(x, spec.group)


def all_gather_rows(spec: Optional[MeshSpec], x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in data-index order (the
    global rows of a sharded result); ``x`` itself without a group."""
    if spec is None or not spec.distributed:
        return x
    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(spec.data_size)]
    dist.all_gather(parts, src, group=spec.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out
