"""Per-stage wall-clock timers for the result dict.

PyTorch returns before the card finishes, so on a CUDA device each stage
ends with ``torch.cuda.synchronize``: the recorded time is the stage's
device work plus its host work, not its enqueue time.
"""

from __future__ import annotations

import contextlib
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
