"""Captured CUDA-graph forwards: the port's counterpart of the JAX package's
``ops/jit_utils.py`` (``HoistedJit``, ``hoisted_jit``, ``aot_compile``).

JAX runs each device entry point as one compiled program per input
signature, with its constants placed on the device once. Here, a wrapped
function runs on the card as one CUDA graph per input signature:

- the signature is the structure of the arguments, each tensor's shape,
  dtype and device, and the value of every other argument except Python
  floats (ints, bools, strings, None, tuples of them: static, so hashable).
  A Python float is a runtime input, as JAX traces it: on the card the
  function receives it as a 0-d float32 tensor, refilled at every call;
- the first call of a signature runs the function once on a side stream
  (its result is the call's), then captures one call into a
  ``torch.cuda.CUDAGraph`` (``capture_error_mode="thread_local"``: other
  threads may use the card meanwhile). Kernel launches counted through
  ``count_launch`` during the capture are recorded with the graph;
- every later call copies the tensor arguments into the graph's inputs,
  replays it, adds the recorded launches to their counters and returns
  clones of the graph's outputs.

A captured graph holds no collective. The sharded forward
(``FullForward.sharded``) is captured as four stages, one graph each, and
its all-gathers run eagerly between the replays: every rank must enter the
same collectives in the same order, a graph that held an NCCL call would
have to be captured and replayed by every rank in lockstep, and gloo (the
CPU's backend) cannot be captured at all; bracketed, the stages stay
rank-local, and the process group's timeout watches each collective.

A lock per wrapper serializes capture and replay. A capture that fails
raises: nothing falls back to eager on the card. Arguments without a CUDA
tensor run the function directly (the CPU). The cache is unbounded, as
JAX's is. Constants the function builds from host data go through
``device_constant``, which places each on the device once, so that the
warm-up call materializes them before the capture (a graph cannot capture
a copy from pageable host memory).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_local = threading.local()


def count_launch(table: Dict[str, int], lock: threading.Lock, key: str) -> None:
    """One launch of kernel ``key``: added to ``table[key]`` under ``lock``,
    or, while this thread captures a graph, recorded with the graph (its
    replays add it)."""
    recorded = getattr(_local, "launches", None)
    if recorded is not None:
        recorded.append((table, lock, key))
        return
    with lock:
        table[key] += 1


@contextlib.contextmanager
def eager():
    """Within it, on this thread, every wrapper calls its function directly:
    the eager baseline that captured replays are held against."""
    before = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = before


_constants: Dict[Tuple, torch.Tensor] = {}
_constants_lock = threading.Lock()


def device_constant(values, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``values`` (array-like) as a tensor on ``device``, built once per
    (values, dtype, device) and shared: callers must not write to it. Under
    a tracer (``torch.export``), which makes its own tensors, nothing is kept."""
    a = np.ascontiguousarray(values)
    key = (a.tobytes(), a.dtype.str, a.shape, str(dtype), str(torch.device(device)))
    t = _constants.get(key)
    if t is None:
        with _constants_lock:
            t = _constants.get(key)
            if t is None:
                t = torch.as_tensor(a, device=device)
                if dtype is not None:
                    t = t.to(dtype)
                if type(t) is torch.Tensor:
                    _constants[key] = t
    return t


def _flatten(x: Any, leaves: List[Any]) -> Any:
    """Append the runtime leaves of ``x`` (tensors and Python floats) to
    ``leaves``; return the hashable signature of ``x``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, float):
        leaves.append(x)
        return ("float",)
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(x[k], leaves)) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    return ("static", type(x), x)


def _rebuild(x: Any, leaves) -> Any:
    """``x`` with its runtime leaves taken in order from iterator ``leaves``."""
    if isinstance(x, (torch.Tensor, float)):
        return next(leaves)
    if isinstance(x, dict):
        return {k: _rebuild(x[k], leaves) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        items = [_rebuild(v, leaves) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def _map_tensors(fn: Callable, x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        items = [_map_tensors(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


class _Captured:
    """One signature's graph: its input slots, outputs and recorded launches."""

    def __init__(self, graph, slots, out, launches, seconds: float):
        self.graph = graph
        self.slots = slots
        self.out = out
        self.launches = launches
        self.seconds = seconds

    def replay(self, leaves) -> Any:
        for slot, value in zip(self.slots, leaves):
            if isinstance(value, torch.Tensor):
                slot.copy_(value)
            else:
                slot.fill_(value)
        self.graph.replay()
        for table, lock, key in self.launches:
            with lock:
                table[key] += 1
        return _map_tensors(torch.clone, self.out)


class HoistedJit:
    """Callable wrapper: ``fn`` replayed as one CUDA graph per signature on
    the card, called directly on the CPU. ``_cache`` maps each signature
    seen to its ``_Captured`` graph (None for a call without a CUDA tensor)."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._cache: Dict[Any, Optional[_Captured]] = {}
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn, updated=())

    def __call__(self, *args, **kwargs):
        leaves: List[Any] = []
        key = _flatten((args, kwargs), leaves)
        device = next((x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda),
                      None)
        if device is None or getattr(_local, "eager", False):
            if device is None:
                self._cache.setdefault(key, None)
            return self._fn(*args, **kwargs)
        with self._lock, torch.inference_mode(), torch.cuda.device(device):
            entry = self._cache.get(key)
            if entry is None:
                out, self._cache[key] = self._capture((args, kwargs), leaves, device)
                return out
            return entry.replay(leaves)

    def _capture(self, structure, leaves, device) -> Tuple[Any, _Captured]:
        t0 = time.perf_counter()
        slots = [x.clone() if isinstance(x, torch.Tensor)
                 else torch.full((), x, dtype=torch.float32, device=device) for x in leaves]
        args, kwargs = _rebuild(structure, iter(slots))
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._fn(*args, **kwargs)
        current.wait_stream(side)
        _map_tensors(lambda t: t.record_stream(current), out)
        graph = torch.cuda.CUDAGraph()
        launches: List[Tuple] = []
        _local.launches = launches
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self._fn(*args, **kwargs)
        finally:
            _local.launches = None
        torch.cuda.synchronize(device)
        return out, _Captured(graph, slots, static_out, launches, time.perf_counter() - t0)

    def captures(self) -> List[_Captured]:
        """The graphs captured so far."""
        return [e for e in self._cache.values() if e is not None]

    def clear(self) -> None:
        """Drop every captured graph (after the function's weights changed)."""
        with self._lock:
            self._cache.clear()

    def aot_compile(self, *args, **kwargs) -> Tuple[Callable, Dict[str, float]]:
        """Build for these example arguments: capture on the card (nothing on
        the CPU). Returns (a callable taking arguments of the same
        signature, which raises ValueError on another, and a cost dict: the
        floating-point operations of one call from FlopCounterMode, 2 per
        multiply-add of convolutions and matrix products, and the build's
        seconds)."""
        from torch.utils.flop_counter import FlopCounterMode

        t0 = time.perf_counter()
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            self._fn(*args, **kwargs)
        leaves: List[Any] = []
        key = _flatten((args, kwargs), leaves)
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            self(*args, **kwargs)
        cost = {"flops": float(counter.get_total_flops()),
                "seconds": time.perf_counter() - t0}

        def call(*a, **k):
            if _flatten((a, k), []) != key:
                raise ValueError("built for another signature of arguments")
            return self(*a, **k)

        return call, cost


def hoisted_jit(fn: Optional[Callable] = None) -> Callable:
    """Wrap ``fn`` in a ``HoistedJit``; also usable as a bare decorator."""
    if fn is None:
        return HoistedJit
    return HoistedJit(fn)
