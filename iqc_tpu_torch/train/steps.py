"""The training step's pieces: learning-rate schedule, optimizer, EMA.

The JAX package trains with the optax chain ``add_decayed_weights(wd)`` ->
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

The schedule and the EMA decay are scalars of the step number, computed on
the host in float32 with the rounding that XLA gives the JAX package's
expressions (it folds constants, turns a division by a constant into a
multiplication by its reciprocal and contracts the last multiply-add); the
transcendental functions are taken in float64 and rounded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

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


def set_update_mask(state: SGDState, mask: Dict[str, float]) -> SGDState:
    """The state with ``mask`` (parameter name -> 0.0 or 1.0) in place of
    its mask: frozen parameters get 0. The trace and count stay."""
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
