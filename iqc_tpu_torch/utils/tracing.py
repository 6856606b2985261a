"""Per-stage wall-clock timers for the result dict, and a profiler trace.

PyTorch returns before the card finishes, so on a CUDA device each stage
ends with ``torch.cuda.synchronize``: the recorded time is the stage's
device work plus its host work, not its enqueue time.

``profile_trace(log_dir)`` records ``torch.profiler`` (CPU, and CUDA where
a card is present) around its block and writes a Chrome trace into
``log_dir`` (``trace.json``, loadable in chrome://tracing or Perfetto); a
falsy ``log_dir`` makes it a no-op, so callers can gate it on a flag.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


class StageTimes:
    """Accumulates named stage durations (ms)."""

    def __init__(self) -> None:
        self.times_ms: Dict[str, float] = {}

    def record(self, name: str, seconds: float) -> None:
        self.times_ms[name] = self.times_ms.get(name, 0.0) + seconds * 1000.0

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self.times_ms.items()}


@contextlib.contextmanager
def stage_timer(stages: StageTimes, name: str,
                device: Optional[torch.device] = None) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        stages.record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the block with ``torch.profiler`` and write
    ``<log_dir>/trace.json``; yields the profiler (None when ``log_dir`` is
    falsy and nothing is recorded)."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
