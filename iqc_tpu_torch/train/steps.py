"""The training step's pieces: learning-rate schedules, optimizers, EMA, and
the classifier's loss and steps.

The JAX package trains YOLO with the optax chain ``add_decayed_weights(wd)`` ->
``sgd(schedule, momentum, nesterov=True)`` -> (with frozen modules) a
per-leaf mask on the final update. ``SGDState`` holds what optax's state
holds, leaf for leaf: the momentum trace of every parameter, the schedule's
update count and the mask. ``sgd_update`` applies the chain in place:

- weight decay reaches every parameter, BatchNorm scale and bias included:
  ``u = g + wd * p``;
- the trace: ``t = u + momentum * t``, the Nesterov update
  ``u + momentum * t``, scaled by ``-schedule(count)``; update n runs at
  ``schedule(n)``, so the first at a learning rate of 0 while its trace
  already accumulates;
- the mask scales that final update; a frozen parameter's trace keeps
  accumulating and the parameter stays bitwise unchanged.

The classifier trains with one of three optax chains (``Optimizer``), each
with ``ClassifierOptState`` holding optax's state leaf for leaf:

- ``adam``: ``add_decayed_weights(wd)`` -> ``adam(lr)``: ``u = g + wd * p``,
  ``mu = (1 - b1) * u + b1 * mu``, ``nu = (1 - b2) * u^2 + b2 * nu``, then
  ``mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps)`` with the count n
  incremented before the bias corrections (the first update uses 1);
- ``adamw``: the same Adam update of ``g``, then ``+ wd * p``;
- ``sgd``: the Nesterov trace at momentum 0.9, no weight decay;

each scaled by ``-lr`` and, where parameters are frozen, by the per-leaf
mask. The learning rate comes from a schedule of the update count (cosine,
a staircase exponential, a constant) or, for the plateau schedule, from a
float32 leaf of the state that ``set_learning_rate`` lowers between epochs
(optax's ``inject_hyperparams``).

On a data-parallel mesh (``shard_train_step``) each rank runs the step on
its rows of the global batch: its loss is its share of the global loss (a
local sum over the global count), the gradients of the shares are summed
over the ranks (JAX's psum, not a mean of locally normalised losses), and
every rank applies the same update to the same state, so the replicated
state stays bitwise equal on every rank.

The schedules and the EMA decay are scalars of the step number, computed
on the host in float32 with the rounding that XLA gives the JAX package's
expressions (it folds constants, turns a division by a constant into a
multiplication by its reciprocal and contracts the last multiply-add); the
transcendental functions are taken in float64 and rounded.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.parallel.mesh import all_reduce_sum

f32 = np.float32


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           end_fraction: float = 0.01) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``base_lr * end_fraction`` at ``total_steps``; a function of
    the step number returning the float32 learning rate as a float."""
    end_lr = base_lr * end_fraction
    w = max(warmup_steps, 1)
    span = max(total_steps - w, 1)
    slope = f32(f32(base_lr) * f32(f32(1) / f32(w)))
    inv_span = f32(f32(1) / f32(span))
    amp = np.float64(f32((base_lr - end_lr) * 0.5))

    def schedule(step: int) -> float:
        s = f32(step)
        if s < w:
            return float(f32(slope * s))
        progress = min(max(f32((s - f32(w)) * inv_span), f32(0)), f32(1))
        c = f32(math.cos(float(f32(f32(math.pi) * progress))))
        return float(f32(np.float64(f32(end_lr)) + amp * np.float64(f32(f32(1) + c))))

    return schedule


def ema_decay_at(step: int, decay: float) -> float:
    """The EMA's decay at (0-based) update ``step``: ``decay * (1 -
    exp(-(step + 1) / tau))`` with ``tau = min(2000, 1 / (1 - decay))``, a
    ramp that keeps short trainings from averaging in their random init."""
    tau = min(2000.0, 1.0 / max(1.0 - decay, 1e-6))
    x = f32(-f32(f32(step) + f32(1)) * f32(1.0 / tau))
    return float(f32(f32(decay) * f32(f32(1) - f32(math.exp(float(x))))))


@dataclasses.dataclass
class SGDState:
    """optax's state of the chain: the momentum trace per parameter, the
    schedule's update count, and the per-parameter 0/1 mask (None where no
    module is frozen; optax then has no mask stage)."""

    trace: Dict[str, torch.Tensor]
    count: int = 0
    mask: Optional[Dict[str, float]] = None


def sgd_init(params: Dict[str, torch.Tensor], masked: bool = False) -> SGDState:
    return SGDState(trace={k: torch.zeros_like(p) for k, p in params.items()}, count=0,
                    mask={k: 1.0 for k in params} if masked else None)


def set_update_mask(state, mask: Dict[str, float]):
    """The state (``SGDState`` or ``ClassifierOptState``) with ``mask``
    (parameter name -> 0.0 or 1.0) in place of its mask: frozen parameters
    get 0. Everything else stays."""
    if state.mask is None:
        raise ValueError("this optimizer has no mask stage (build it with masked=True)")
    if set(mask) != set(state.mask):
        raise ValueError("the mask must name every parameter")
    return dataclasses.replace(state, mask={k: float(v) for k, v in mask.items()})


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add
    gives it (XLA contracts each multiply-add of the JAX package's chain
    into one): the float64 product of two float32 values is exact."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    return (a * (b.double() if isinstance(b, torch.Tensor) else b) + c.double()).float()


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in tensors])


def _scatter(flat: torch.Tensor, dst: List[torch.Tensor]) -> None:
    torch._foreach_copy_(dst, [v.view_as(x) for v, x in
                               zip(flat.split([x.numel() for x in dst]), dst)])


def all_reduce_grads(mesh, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients summed over the data axis of ``mesh``, in one
    all-reduce of their concatenation; unchanged without a group."""
    if mesh is None or not mesh.distributed:
        return list(grads)
    flat = all_reduce_sum(mesh, _flat(grads))
    return [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]


@torch.no_grad()
def sgd_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: SGDState, schedule: Callable[[int], float], momentum: float,
               weight_decay: float) -> SGDState:
    """One update of the chain, in place on ``params`` and ``state.trace``
    (over all parameters at once, flattened); returns the state with its
    count advanced."""
    names = list(params)
    p_list = [params[k] for k in names]
    t_list = [state.trace[k] for k in names]
    p, t = _flat(p_list), _flat(t_list)
    u = _fma(f32(weight_decay), p, _flat([grads[k] for k in names]))   # g + wd * p
    t = _fma(f32(momentum), t, u)                                     # u + m * t
    step = _fma(f32(momentum), t, u)                                  # u + m * t'
    lr = f32(-schedule(state.count))
    if state.mask is None:
        p = _fma(step, lr, p)
    else:
        mask = torch.cat([torch.full((x.numel(),), state.mask[k], dtype=torch.float32,
                                     device=x.device) for k, x in zip(names, p_list)])
        p = _fma((step * float(lr)), mask, p)
    _scatter(t, t_list)
    _scatter(p, p_list)
    return dataclasses.replace(state, count=state.count + 1)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], d: float) -> None:
    """``ema = d * ema + (1 - d) * params`` in place (``1 - d`` rounded to
    float32 and the sum fused, as XLA computes the JAX package's)."""
    names = list(ema)
    e_list = [ema[k] for k in names]
    p = _flat([params[k] for k in names])
    e = _fma(f32(d), _flat(e_list), p * float(f32(f32(1) - f32(d))))
    _scatter(e, e_list)


@dataclasses.dataclass
class TrainState:
    """step (updates taken), the module's parameters and BatchNorm
    statistics (its own tensors, by state-dict name) and the optimizer's
    state."""

    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: SGDState


def module_state(module: torch.nn.Module, opt_state: SGDState, step: int = 0) -> TrainState:
    params = dict(module.named_parameters())
    stats = {k: v for k, v in module.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return TrainState(step=step, params=params, batch_stats=stats, opt_state=opt_state)


# -- the classifier ------------------------------------------------------------


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """``init_value * 0.5 * (1 + cos(pi * min(n, T) / T))`` in float32 (optax's
    ``cosine_decay_schedule`` at alpha 0)."""
    t = f32(decay_steps)
    inv_t = f32(f32(1) / t)
    base = f32(init_value)

    def schedule(count: int) -> float:
        c = min(f32(count), t)
        cosv = f32(math.cos(float(f32(f32(f32(math.pi) * c) * inv_t))))
        return float(f32(base * f32(f32(0.5) * f32(f32(1) + cosv))))

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = True) -> Callable[[int], float]:
    """``init_value * decay_rate ** (n / transition_steps)``, the exponent
    floored with ``staircase``, in float32 (optax's ``exponential_decay``)."""
    base = f32(init_value)
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(base)
    inv = f32(f32(1) / f32(transition_steps))

    def schedule(count: int) -> float:
        if count <= 0:
            return float(base)
        e = f32(f32(count) * inv)
        if staircase:
            e = f32(math.floor(e))
        return float(f32(base * f32(float(f32(decay_rate)) ** float(e))))

    return schedule


def constant_schedule(value: float) -> Callable[[int], float]:
    v = float(f32(value))
    return lambda count: v


@dataclasses.dataclass
class ClassifierOptState:
    """optax's state of the classifier's chain: the optimizer's ``kind``,
    whether the chain holds a schedule's count, the update count (Adam's,
    the schedule's and ``inject_hyperparams``' count move together), Adam's
    moments ``mu``/``nu`` or SGD's Nesterov ``trace`` (by state-dict name),
    the per-parameter 0/1 mask (None without a mask stage), and the
    injected float32 learning rate of the plateau schedule (None with a
    schedule)."""

    kind: str = "adam"
    scheduled: bool = True   # the chain counts its schedule's steps (not a constant rate)
    count: int = 0
    mu: Optional[Dict[str, torch.Tensor]] = None
    nu: Optional[Dict[str, torch.Tensor]] = None
    trace: Optional[Dict[str, torch.Tensor]] = None
    mask: Optional[Dict[str, float]] = None
    learning_rate: Optional[float] = None


OPTIMIZERS = ("adam", "adamw", "sgd")


class Optimizer:
    """One of the classifier's optimizers (``kind`` in ``OPTIMIZERS``) with a
    learning-rate ``schedule`` of the update count, or ``schedule=None`` for
    the plateau schedule's injected rate (``init(plateau_lr=...)``)."""

    B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9

    def __init__(self, kind: str, schedule: Optional[Callable[[int], float]],
                 weight_decay: float = 0.0, scheduled: bool = True):
        if kind not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {kind!r} (one of {', '.join(OPTIMIZERS)})")
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        # optax keeps a count for a schedule, none for a constant rate
        self.scheduled = scheduled and schedule is not None

    def init(self, params: Dict[str, torch.Tensor], masked: bool = False,
             plateau_lr: Optional[float] = None) -> ClassifierOptState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        if (plateau_lr is None) == (self.schedule is None):
            raise ValueError("give a schedule or a plateau learning rate, not both or neither")
        st = ClassifierOptState(kind=self.kind, scheduled=self.scheduled,
                                mask={k: 1.0 for k in params} if masked else None,
                                learning_rate=None if plateau_lr is None
                                else float(f32(plateau_lr)))
        if self.kind == "sgd":
            st.trace = zeros()
        else:
            st.mu, st.nu = zeros(), zeros()
        return st

    def learning_rate(self, state: ClassifierOptState) -> float:
        """The rate of the next update."""
        if state.learning_rate is not None:
            return state.learning_rate
        return self.schedule(state.count)

    def _adam(self, u: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int):
        # the moments' (1 - b) is folded in float64, the bias corrections'
        # 1 - b^n taken in float32
        b1, b2 = f32(self.B1), f32(self.B2)
        mu = _fma(f32(1 - self.B1), u, mu * float(b1))
        nu = _fma(f32(1 - self.B2), u * u, nu * float(b2))
        bc1 = float(f32(f32(1) - f32(float(b1) ** count)))
        bc2 = float(f32(f32(1) - f32(float(b2) ** count)))
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + float(f32(self.EPS)))
        return upd, mu, nu

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: ClassifierOptState) -> ClassifierOptState:
        """One update, in place on ``params`` and the state's moments or
        trace (over all parameters at once, flattened); returns the state
        with its count advanced."""
        names = list(params)
        p_list = [params[k] for k in names]
        p = _flat(p_list)
        g = _flat([grads[k] for k in names])
        wd = f32(self.weight_decay)
        lr = f32(-self.learning_rate(state))
        count = state.count + 1
        if self.kind == "sgd":
            t_list = [state.trace[k] for k in names]
            t = _fma(f32(self.MOMENTUM), _flat(t_list), g)          # g + m * t
            upd = _fma(f32(self.MOMENTUM), t, g)                    # g + m * t'
            _scatter(t, t_list)
        else:
            mu_list = [state.mu[k] for k in names]
            nu_list = [state.nu[k] for k in names]
            u = _fma(wd, p, g) if self.kind == "adam" else g        # g + wd * p
            upd, mu, nu = self._adam(u, _flat(mu_list), _flat(nu_list), count)
            if self.kind == "adamw":
                upd = _fma(wd, p, upd)                              # + wd * p
            _scatter(mu, mu_list)
            _scatter(nu, nu_list)
        if state.mask is None:
            p = _fma(upd, lr, p)
        else:
            mask = torch.cat([torch.full((x.numel(),), state.mask[k], dtype=torch.float32,
                                         device=x.device) for k, x in zip(names, p_list)])
            if state.scheduled or state.learning_rate is not None:
                p = _fma(upd * float(lr), mask, p)
            else:  # XLA folds a constant rate into the mask: one rounding
                p = _fma(upd, mask * float(lr), p)
        _scatter(p, p_list)
        return dataclasses.replace(state, count=count)


def set_learning_rate(state: ClassifierOptState, lr: float) -> ClassifierOptState:
    """The plateau schedule's state with its injected rate set to ``lr``
    (rounded to float32)."""
    if state.learning_rate is None:
        raise ValueError("this optimizer runs a schedule; only the plateau schedule's rate is set")
    return dataclasses.replace(state, learning_rate=float(f32(lr)))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          class_weights: Optional[torch.Tensor] = None,
                          mesh=None) -> torch.Tensor:
    """Mean over the batch of the cross-entropy against one-hot labels,
    smoothed to ``onehot * (1 - s) + s / C``, each sample's loss scaled by
    its class's weight (the plain mean, not a weighted one). With a
    ``mesh``: this rank's share of the global batch's mean (its rows' sum
    over the global count)."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
    if label_smoothing > 0:
        onehot = onehot * f32(1 - label_smoothing) + f32(label_smoothing / num_classes)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -torch.sum(onehot * logp, dim=-1)
    if class_weights is not None:
        loss = loss * class_weights[labels.long()]
    if mesh is not None and mesh.distributed:
        return torch.sum(loss) / (loss.shape[0] * mesh.data_size)
    return torch.mean(loss)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches -> ImageNet-normalised float32 on their device, as
    ``(x * (1/255) - mean) / std``; float batches pass through (taken as
    normalised already)."""
    if images.dtype.is_floating_point:
        return images
    from iqc_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
    from iqc_tpu_torch.ops.jit_utils import device_constant

    x = images.to(torch.float32) * float(f32(f32(1) / f32(255)))
    mean = device_constant(np.float32(IMAGENET_MEAN), images.device)
    std = device_constant(np.float32(IMAGENET_STD), images.device)
    return (x - mean) / std


def make_classifier_train_step(module: torch.nn.Module, optimizer: Optimizer,
                               label_smoothing: float = 0.0):
    """step(state, images, labels, class_weights, dropout_masks=None,
    mesh=None) -> {"loss", "accuracy"} (0-d tensors): one update of
    ``state`` (a ``TrainState`` over ``module``, in place) from a batch on
    the device. Integer images are normalised there (``device_normalize``);
    ``dropout_masks`` are the head's keep masks (None: the module draws).
    With a ``mesh`` (``shard_train_step``) the batch is this rank's rows:
    the gradients of the rank's share of the loss are summed over the
    ranks, and the returned loss and accuracy are the global batch's."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             class_weights: torch.Tensor, dropout_masks=None,
             mesh=None) -> Dict[str, torch.Tensor]:
        module.train()
        names = list(state.params)
        logits = module(device_normalize(images), dropout_masks=dropout_masks)
        loss = softmax_cross_entropy(logits, labels, label_smoothing, class_weights, mesh)
        grads = all_reduce_grads(mesh, torch.autograd.grad(loss, [state.params[k]
                                                                  for k in names]))
        state.opt_state = optimizer.update(state.params, dict(zip(names, grads)),
                                           state.opt_state)
        state.step += 1
        correct = (torch.argmax(logits.detach(), -1) == labels).to(torch.float32)
        if mesh is None or not mesh.distributed:
            return {"loss": loss.detach(), "accuracy": torch.mean(correct)}
        totals = all_reduce_sum(mesh, torch.stack([loss.detach(), torch.sum(correct)]))
        return {"loss": totals[0], "accuracy": totals[1] / (labels.shape[0] * mesh.data_size)}

    return step


def shard_train_step(step_fn: Callable, spec) -> Callable:
    """``step_fn`` (a ``make_classifier_train_step`` step) on the data axis
    of ``spec``: called with this rank's rows of the global batch (and of
    the dropout masks), it sums the gradients over the ranks and applies the
    same update on every rank. A mesh without a group (a single process)
    takes the plain step, as the JAX package takes plain jit at size 1."""
    if spec is None or not spec.distributed:
        return step_fn
    return functools.partial(step_fn, mesh=spec)


def classifier_eval_outputs(logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The evaluation outputs (loss unweighted and unsmoothed, preds, labels,
    probs) of a batch's logits."""
    return {"loss": softmax_cross_entropy(logits, labels),
            "preds": torch.argmax(logits, -1), "labels": labels,
            "probs": torch.softmax(logits.to(torch.float32), dim=-1)}


# -- one host buffer per batch ---------------------------------------------------------
#
# The JAX package uploads a single-device batch as one uint8 buffer and
# bitcasts it back on the device (one transfer in place of one per array).
# The port's trainers upload arrays directly; these are the same helpers.


def pack_batch_host(arrays) -> np.ndarray:
    """Host arrays concatenated into one uint8 buffer (their C-order bytes)."""
    return np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                           for a in arrays])


def batch_specs(arrays) -> List[Tuple[Tuple[int, ...], np.dtype]]:
    """[(shape, dtype), ...] of the arrays, for ``unpack_batch_device``."""
    return [(tuple(a.shape), np.dtype(a.dtype)) for a in arrays]


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64, np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def unpack_batch_device(buf: torch.Tensor, specs) -> List[torch.Tensor]:
    """The inverse of ``pack_batch_host`` on a uint8 tensor (on any device):
    each segment reinterpreted as its dtype and shape; bool arrays come back
    as ``uint8 != 0``."""
    out, off = [], 0
    for shape, dtype in specs:
        dt = np.dtype(dtype)
        work = np.dtype(np.uint8) if dt == np.bool_ else dt
        n = int(np.prod(shape, dtype=np.int64)) * work.itemsize
        seg = buf[off:off + n]
        if off % work.itemsize:  # a view as a wider type needs an aligned start
            seg = seg.clone()
        off += n
        arr = seg.view(_TORCH_DTYPES[work]).reshape(shape)
        out.append(arr != 0 if dt == np.bool_ else arr)
    return out
