"""Precision-lowered and pruned model variants, and the engine build.

The counterpart of the JAX package's ``models/optimizer.py``, on the Flax
variables tree (nested dicts of numpy arrays in Flax's layout: HWIO conv
kernels, [in, out] dense kernels), so that every rule sees the shapes the
JAX package sees. Prune and quantize that tree before it is loaded into the
port's modules (``weights.load_into``), never the modules' OIHW tensors.

- ``to_bf16``: float leaves to bfloat16 (torch tensors: numpy has no
  bfloat16); ``quantize_int8`` / ``dequantize_int8``: per-tensor symmetric
  weight-only int8 of every float leaf, BatchNorm statistics included;
- ``prune_magnitude``: magnitude pruning, unstructured or by output channel;
- ``aot_compile``: the engine build on ``jit_utils.HoistedJit``: a CUDA
  graph of the function captured at the sample's shapes on the card (eager
  on the CPU), with its build seconds and its floating-point operations
  (``torch.utils.flop_counter``);
- ``EngineOptimizer``: the JAX package's ``XLAOptimizer`` facade.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from iqc_tpu_torch.models.resnet_int8 import tree_size_bytes
from iqc_tpu_torch.ops.jit_utils import HoistedJit
from iqc_tpu_torch.weights import save_variables

PRECISIONS = ("fp32", "bf16", "int8")


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts / lists (dict keys of the
    first tree), zipped with same-shaped trees ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _float32(x) -> Optional[np.ndarray]:
    """x as a float32 array where it is a float leaf (as JAX takes float
    leaves with 64-bit types off), else None."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() else None
    a = np.asarray(x)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else None


def to_bf16(params: Any) -> Any:
    """Float leaves -> bfloat16 CPU tensors (round to nearest even);
    integer and bool leaves unchanged."""
    def cast(x):
        a = _float32(x)
        return x if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    return _map(cast, params)


def quantize_int8(params: Any) -> Tuple[Any, Any]:
    """Per-tensor symmetric weight-only int8 of every float leaf:
    scale = max(|x|max, 1e-8) / 127, codes round(x / scale) clipped to
    [-127, 127]. Returns (int8 tree, scales tree of float32 scalars); empty
    and non-float leaves pass through with scale 0."""
    def q(x):
        a = _float32(x)
        if a is None or a.size == 0:
            return np.asarray(x), np.float32(0)
        scale = np.maximum(np.max(np.abs(a)), np.float32(1e-8)) / np.float32(127.0)
        codes = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        return codes, np.float32(scale)

    pairs = _map(q, params)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(pairs: Any, i: int) -> Any:
    """Element ``i`` of each (codes, scale) leaf of ``pairs``."""
    if isinstance(pairs, dict):
        return {k: _pick(v, i) for k, v in pairs.items()}
    if isinstance(pairs, list):
        return [_pick(v, i) for v in pairs]
    return pairs[i]


def dequantize_int8(values: Any, scales: Any) -> Any:
    """int8 leaves -> float32 codes x scale; other leaves unchanged."""
    def dq(v, s):
        a = np.asarray(v)
        if a.dtype == np.int8:
            return a.astype(np.float32) * np.float32(s)
        return v

    return _map(dq, values, scales)


def prune_magnitude(params: Any, sparsity: float, structured: bool = False,
                    min_size: int = 256) -> Tuple[Any, Dict[str, Any]]:
    """Magnitude pruning of the float leaves with ndim >= 2 and at least
    ``min_size`` entries (biases, BatchNorm and scale vectors stay):

    - unstructured: exactly floor(sparsity x size) entries of smallest |w|
      per tensor become zero (a stable sort decides ties, lowest index first);
    - structured: exactly floor(sparsity x C) whole output channels (the
      last axis: HWIO convs, [in, out] dense) of smallest L2 norm; tensors
      with fewer than 32 outputs (the detection and class heads) are left
      whole.

    Returns (pruned tree, report with the achieved zero fraction)."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1): {sparsity}")
    counts = {"zeroed": 0, "total": 0}

    def p(x):
        a = _float32(x)
        if a is None or a.ndim < 2 or a.size < min_size:
            return x
        if structured and a.shape[-1] < 32:
            return x
        counts["total"] += int(a.size)
        if sparsity == 0.0:
            return x
        if structured:
            flat = torch.from_numpy(np.ascontiguousarray(a.reshape(-1, a.shape[-1])))
            norms = torch.linalg.vector_norm(flat, dim=0)
            k = int(np.floor(sparsity * a.shape[-1]))
            if k == 0:
                return x
            drop = torch.argsort(norms, stable=True)[:k].numpy()
            mask = np.ones((a.shape[-1],), np.float32)
            mask[drop] = 0
            counts["zeroed"] += int(a.size // a.shape[-1]) * k
            return a * mask
        k = int(np.floor(sparsity * a.size))
        if k == 0:
            return x
        drop = torch.argsort(torch.from_numpy(np.abs(a).reshape(-1)), stable=True)[:k].numpy()
        mask = np.ones((a.size,), np.float32)
        mask[drop] = 0
        counts["zeroed"] += k
        return a * mask.reshape(a.shape)

    out = _map(p, params)
    report = {
        "requested_sparsity": sparsity,
        "structured": structured,
        "pruned_weight_fraction": counts["zeroed"] / max(counts["total"], 1),
        "prunable_params": counts["total"],
    }
    return out, report


@dataclasses.dataclass
class CompiledModel:
    """A function built for fixed input shapes (``aot_compile``). On the card
    ``__call__`` replays the CUDA graph captured for the sample's tensor
    arguments (``jit_utils.HoistedJit``): it copies the tensor arguments in
    and returns copies of the outputs, and raises ValueError on other
    shapes; the graph keeps what the function read from its other arguments
    at capture. On the CPU it calls the function."""

    fn: Callable
    compile_seconds: float
    flops: Optional[float]
    bytes_accessed: Optional[float]
    graph: Any = None
    replay: Optional[Callable] = None

    def __call__(self, *args):
        if self.replay is None:
            return self.fn(*args)
        return self.replay(*(a for a in args if isinstance(a, torch.Tensor)))


def aot_compile(fn: Callable, *sample_args) -> CompiledModel:
    """Build ``fn`` for the shapes of ``sample_args`` through
    ``jit_utils.HoistedJit.aot_compile`` over its tensor arguments: on the
    card, a warm-up call on a side stream and a CUDA graph of one call; on
    the CPU, nothing. Counts the floating-point operations of one call
    either way (2 per multiply-add of convolutions and matrix products)."""
    t0 = time.perf_counter()
    positions = [i for i, a in enumerate(sample_args) if isinstance(a, torch.Tensor)]

    def with_tensors(*tensors):
        args = list(sample_args)
        for i, t in zip(positions, tensors):
            args[i] = t
        return fn(*args)

    jitted = HoistedJit(with_tensors)
    replay, cost = jitted.aot_compile(*(sample_args[i] for i in positions))
    captured = jitted.captures()
    return CompiledModel(fn=fn, compile_seconds=time.perf_counter() - t0,
                         flops=cost["flops"] or None, bytes_accessed=None,
                         graph=captured[0].graph if captured else None,
                         replay=replay if captured else None)


class EngineOptimizer:
    """The engine builder: the counterpart of the JAX package's
    ``XLAOptimizer`` (``models/optimizer.py``), with a CUDA graph in place of
    XLA's ahead-of-time compile."""

    def __init__(self, precision: str = "bf16", max_batch_size: int = 8,
                 sparsity: float = 0.0, structured_pruning: bool = False):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        self.max_batch_size = max_batch_size
        self.sparsity = sparsity
        self.structured_pruning = structured_pruning
        self.report: Dict[str, Any] = {}
        self._int8 = None
        self._stored = None

    def optimize_variables(self, variables: Any):
        """Lower a variables tree to the configured precision (magnitude
        pruning first when ``sparsity`` > 0). int8 returns the dequantized
        float32 tree (weight-only storage, served in float). Returns
        (optimized variables, report)."""
        original_bytes = tree_size_bytes(variables)
        prune_report: Dict[str, Any] = {}
        if self.sparsity > 0.0:
            variables, prune_report = prune_magnitude(variables, self.sparsity,
                                                      self.structured_pruning)
        if self.precision == "fp32":
            out = stored = variables
        elif self.precision == "bf16":
            out = stored = to_bf16(variables)
        else:
            self._int8 = quantize_int8(variables)
            out = dequantize_int8(*self._int8)
            stored = self._int8[0]
        self._stored = stored
        new_bytes = tree_size_bytes(stored)
        self.report = {
            "precision": self.precision,
            "original_size_mb": original_bytes / 2**20,
            "optimized_size_mb": new_bytes / 2**20,
            "size_reduction_percent": 100.0 * (1 - new_bytes / max(original_bytes, 1)),
            **prune_report,
        }
        return out, self.report

    def build_engine(self, apply_fn: Callable, variables: Any,
                     sample_input: torch.Tensor) -> CompiledModel:
        """``apply_fn(optimized variables, batch)`` built at
        ``max_batch_size`` on ``sample_input``'s device and dtype."""
        opt_vars, _ = self.optimize_variables(variables)
        batch = torch.zeros((self.max_batch_size, *sample_input.shape[1:]),
                            dtype=sample_input.dtype, device=sample_input.device)
        compiled = aot_compile(apply_fn, opt_vars, batch)
        self.report.update({
            "compile_seconds": compiled.compile_seconds,
            "flops": compiled.flops,
            "bytes_accessed": compiled.bytes_accessed,
            "max_batch_size": self.max_batch_size,
        })
        return compiled

    def export(self, path: str) -> None:
        """Write the optimized weights as a Flax msgpack checkpoint with the
        report beside it: int8 as {"values", "scales"}, bf16 and fp32 as the
        cast variables (the JAX package's ``load_variables`` reads both)."""
        if self.precision == "int8" and self._int8 is not None:
            values, scales = self._int8
            save_variables(path, {"values": values, "scales": scales}, self.report)
        elif self._stored is not None:
            save_variables(path, self._stored, self.report)
        else:
            raise RuntimeError("run optimize_variables or build_engine first")
