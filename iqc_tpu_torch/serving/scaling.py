"""Process-level auto-scaling for the serving worker pool.

Driven by the ``production.scaling`` block (``ScalingConfig``):

- :func:`host_utilization` samples host CPU%% (delta over /proc/stat) and
  memory%% (MemAvailable vs MemTotal from /proc/meminfo) with no
  dependencies.
- :class:`AutoScaler` runs a sampling thread on the configured cadence and
  resizes a worker pool between ``min_instances`` and ``max_instances``:
  up by one as soon as either utilization crosses its threshold, down by
  one only after ``scale_down_samples`` consecutive samples below half the
  thresholds (hysteresis, so the pool does not flap at the boundary).

The resize target is injected as a callback; in serving it is
``QualityControlSystem.set_worker_count`` (queue-draining workers that
overlap host-side decode/JSON work while device work runs). The pool size
and the last utilization sample surface on the Prometheus exporter
(``iqc_worker_instances``, ``iqc_host_cpu_percent``,
``iqc_host_memory_percent``; ``serving/metrics.py``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from iqc_tpu_torch.config import ScalingConfig

logger = logging.getLogger(__name__)

SampleFn = Callable[[], Tuple[float, float]]  # -> (cpu_pct, mem_pct)


def _read_proc_stat() -> Tuple[int, int]:
    """(busy, total) jiffies from the aggregate cpu line of /proc/stat."""
    with open("/proc/stat") as f:
        parts = f.readline().split()
    vals = [int(v) for v in parts[1:]]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)  # idle + iowait
    total = sum(vals)
    return total - idle, total


def host_utilization(interval: float = 0.1) -> Tuple[float, float]:
    """(cpu_percent, memory_percent) for the host, stdlib-only.

    CPU is the busy share of jiffies over ``interval``; memory is
    1 - MemAvailable/MemTotal (the kernel's own availability estimate).
    """
    b0, t0 = _read_proc_stat()
    time.sleep(interval)
    b1, t1 = _read_proc_stat()
    dt = max(t1 - t0, 1)
    cpu = 100.0 * (b1 - b0) / dt

    total = avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1])
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1])
            if total is not None and avail is not None:
                break
    mem = 0.0 if not total else 100.0 * (1.0 - (avail or 0) / total)
    return cpu, mem


class AutoScaler:
    """Threshold scaler over an injected worker pool (see module docstring).

    ``resize``: called with the new desired size (only on change). It may
    clamp further; its return value (if not None) becomes the recorded
    current size, so the scaler never drifts from the pool's reality.
    ``sample_fn``/``clock``/``sleep`` are injectable for deterministic
    tests; production uses :func:`host_utilization` on a daemon thread.
    """

    def __init__(self, config: ScalingConfig,
                 resize: Callable[[int], Optional[int]],
                 sample_fn: Optional[SampleFn] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 initial_instances: Optional[int] = None):
        config.validate()
        self.config = config
        self._resize = resize
        self._sample = sample_fn or host_utilization
        self._sleep = sleep
        self._instances = min(max(initial_instances or config.min_instances,
                                  config.min_instances),
                              config.max_instances)
        self._cool = 0  # consecutive below-half-threshold samples
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "samples": 0, "scale_ups": 0, "scale_downs": 0,
            "cpu_percent": 0.0, "memory_percent": 0.0,
        }

    @property
    def instances(self) -> int:
        return self._instances

    # -- decision ---------------------------------------------------------------

    def step(self) -> int:
        """One sample + scaling decision; returns the current pool size.

        Called by the background loop; callable directly in tests.
        """
        cpu, mem = self._sample()
        c = self.config
        with self._lock:
            self.stats["samples"] += 1
            self.stats["cpu_percent"] = round(float(cpu), 2)
            self.stats["memory_percent"] = round(float(mem), 2)
            desired = self._instances
            if cpu >= c.cpu_threshold or mem >= c.memory_threshold:
                self._cool = 0
                desired = min(self._instances + 1, c.max_instances)
            elif cpu < c.cpu_threshold / 2 and mem < c.memory_threshold / 2:
                self._cool += 1
                if self._cool >= c.scale_down_samples:
                    self._cool = 0
                    desired = max(self._instances - 1, c.min_instances)
            else:
                self._cool = 0
            if desired != self._instances:
                key = "scale_ups" if desired > self._instances else "scale_downs"
                try:
                    actual = self._resize(desired)
                except Exception:  # a failed resize must not kill the loop
                    logger.exception("worker pool resize to %d failed", desired)
                    return self._instances
                self.stats[key] += 1
                self._instances = desired if actual is None else int(actual)
                logger.info("autoscaler: %d workers (cpu %.0f%%, mem %.0f%%)",
                            self._instances, cpu, mem)
            return self._instances

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        if not self.config.auto_scale:
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            # sleep-first: the pool just started at its configured size;
            # the first decision waits one interval of real utilization
            while not self._stop.is_set():
                self._sleep(self.config.interval_seconds)
                if not self._stop.is_set():
                    self.step()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="iqc-autoscaler")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        self._thread = None
