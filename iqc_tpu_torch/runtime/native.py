"""ctypes bindings for the C++ serving runtime, with Python fallbacks.

Two shared libraries, each built on first use by one ``g++`` call into
``build/runtime/`` under the repository root (never into the source tree),
named by a hash of their sources and flags so that a change rebuilds them:

- ``libiqc_runtime``: the request-coalescing ``BatchQueue``, the striped-lock
  ``NativeRateLimiter`` and the lock-free ``LatencyHistogram``
  (``cpp/iqc_runtime.cc``). Where it cannot be built or loaded, each class
  runs a pure-Python implementation of the same behaviour.
- ``libiqc_jpeg``: ``decode_jpeg`` over libjpeg (``cpp/jpeg_decode.cc``).
  Where libjpeg is missing only JPEG decoding is lost: ``decode_jpeg``
  returns None.

``native_available()`` and ``jpeg_available()`` say which are in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from collections import deque
from typing import Dict, List

import numpy as np

from iqc_tpu_torch.config import REPO_ROOT

logger = logging.getLogger(__name__)

CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "runtime")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
BUILD_TIMEOUT_S = 120
# name -> (sources, link flags)
LIBRARIES = {
    "runtime": (("iqc_runtime.cc",), ()),
    "jpeg": (("jpeg_decode.cc",), ("-ljpeg",)),
}

_c = ctypes
_u8p = ctypes.POINTER(ctypes.c_uint8)
_ip = ctypes.POINTER(ctypes.c_int)
# entry point -> (restype, argtypes)
_SIGNATURES = {
    "runtime": {
        "bq_create": (_c.c_void_p, [_c.c_size_t]),
        "bq_destroy": (None, [_c.c_void_p]),
        "bq_push": (_c.c_int, [_c.c_void_p, _c.c_int64]),
        "bq_pop_batch": (_c.c_int, [_c.c_void_p, _c.POINTER(_c.c_int64), _c.c_int,
                                    _c.c_double]),
        "bq_size": (_c.c_size_t, [_c.c_void_p]),
        "bq_close": (None, [_c.c_void_p]),
        "rl_create": (_c.c_void_p, [_c.c_int, _c.c_double]),
        "rl_destroy": (None, [_c.c_void_p]),
        "rl_allow": (_c.c_int, [_c.c_void_p, _c.c_char_p]),
        "lh_create": (_c.c_void_p, []),
        "lh_destroy": (None, [_c.c_void_p]),
        "lh_record": (None, [_c.c_void_p, _c.c_double]),
        "lh_percentile": (_c.c_double, [_c.c_void_p, _c.c_double]),
        "lh_count": (_c.c_uint64, [_c.c_void_p]),
        "lh_mean": (_c.c_double, [_c.c_void_p]),
    },
    "jpeg": {
        "iqc_jpeg_info": (_c.c_int, [_u8p, _c.c_size_t, _ip, _ip]),
        "iqc_jpeg_decode": (_c.c_int, [_u8p, _c.c_size_t, _c.c_int, _u8p, _c.c_size_t,
                                       _ip, _ip, _ip]),
    },
}

_libs: Dict[str, object] = {}
_lib_lock = threading.Lock()


def library_path(name: str) -> str:
    sources, link = LIBRARIES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + link).encode())
    for src in sources:
        with open(os.path.join(CPP_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libiqc_{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile library ``name`` unless it exists; returns its path. Raises
    where g++ is missing or the compile fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources, link = LIBRARIES[name]
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(os.path.join(CPP_DIR, s) for s in sources), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)
    return out


def _load_library(name: str = "runtime"):
    """The loaded library ``name``, or False where it cannot be built or
    loaded (logged once)."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL(build(name))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native %s library unavailable (%s); %s", name, e,
                           "using the Python fallback" if name == "runtime"
                           else "JPEG decoding is off")
            lib = False
        _libs[name] = lib
        return lib


def native_available() -> bool:
    return bool(_load_library("runtime"))


def jpeg_available() -> bool:
    return bool(_load_library("jpeg"))


class BatchQueue:
    """Request-coalescing queue: push int ids, pop aggregated batches.
    Native condvar MPMC ring when built; threading fallback otherwise."""

    def __init__(self, capacity: int = 4096):
        lib = _load_library()
        self._native = bool(lib)
        if self._native:
            self._lib = lib
            self._ptr = lib.bq_create(capacity)
        else:
            self._items: deque = deque()
            self._capacity = capacity
            self._mu = threading.Lock()
            self._cv = threading.Condition(self._mu)
            self._closed = False

    def push(self, request_id: int) -> bool:
        if self._native:
            return bool(self._lib.bq_push(self._ptr, request_id))
        with self._cv:
            if self._closed or len(self._items) >= self._capacity:
                return False
            self._items.append(request_id)
            self._cv.notify()
            return True

    def pop_batch(self, max_batch: int, timeout_ms: float = 100.0) -> List[int]:
        if self._native:
            buf = (ctypes.c_int64 * max_batch)()
            n = self._lib.bq_pop_batch(self._ptr, buf, max_batch, timeout_ms)
            return [buf[i] for i in range(n)]
        with self._cv:
            if not self._items:
                self._cv.wait_for(lambda: self._items or self._closed,
                                  timeout=timeout_ms / 1000.0)
            out = []
            while self._items and len(out) < max_batch:
                out.append(self._items.popleft())
            return out

    def qsize(self) -> int:
        if self._native:
            return int(self._lib.bq_size(self._ptr))
        with self._mu:
            return len(self._items)

    def close(self) -> None:
        if self._native:
            self._lib.bq_close(self._ptr)
        else:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def __del__(self):
        if getattr(self, "_native", False):
            self._lib.bq_destroy(self._ptr)


class NativeRateLimiter:
    """Per-key sliding-window limiter backed by the C++ striped-lock
    implementation, or by ``serving.app.RateLimiter`` where it is not built."""

    def __init__(self, max_requests: int, window_s: float = 60.0):
        lib = _load_library()
        self._native = bool(lib)
        self.max_requests = max_requests
        self.window = window_s
        if self._native:
            self._lib = lib
            self._ptr = lib.rl_create(max_requests, window_s)
        else:
            from iqc_tpu_torch.serving.app import RateLimiter

            self._py = RateLimiter(max_requests, window_s)

    def allow(self, key: str) -> bool:
        if self._native:
            return bool(self._lib.rl_allow(self._ptr, key.encode()))
        return self._py.allow(key)

    def __del__(self):
        if getattr(self, "_native", False):
            self._lib.rl_destroy(self._ptr)


class LatencyHistogram:
    """Lock-free latency recording with percentile queries (native) or a
    numpy reservoir fallback."""

    def __init__(self):
        lib = _load_library()
        self._native = bool(lib)
        if self._native:
            self._lib = lib
            self._ptr = lib.lh_create()
        else:
            self._samples: List[float] = []
            self._mu = threading.Lock()

    def record(self, ms: float) -> None:
        if self._native:
            self._lib.lh_record(self._ptr, float(ms))
        else:
            with self._mu:
                self._samples.append(float(ms))
                if len(self._samples) > 100_000:
                    self._samples = self._samples[-50_000:]

    def percentile(self, p: float) -> float:
        if self._native:
            return float(self._lib.lh_percentile(self._ptr, p))
        with self._mu:
            if not self._samples:
                return 0.0
            return float(np.percentile(self._samples, p))

    def count(self) -> int:
        if self._native:
            return int(self._lib.lh_count(self._ptr))
        with self._mu:
            return len(self._samples)

    def mean(self) -> float:
        if self._native:
            return float(self._lib.lh_mean(self._ptr))
        with self._mu:
            return float(np.mean(self._samples)) if self._samples else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count(),
            "mean_ms": self.mean(),
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
        }

    def __del__(self):
        if getattr(self, "_native", False):
            self._lib.lh_destroy(self._ptr)


def decode_jpeg(data: bytes, target: int = 0):
    """libjpeg decode -> RGB uint8 [H,W,3], or None (not a JPEG, a file
    libjpeg refuses, or no libjpeg).

    ``target``: the largest model dimension the caller will resize to. Where
    the source is larger, DCT-domain scale_denom 2/4/8 decodes directly at
    reduced resolution, keeping the decoded image at least ``target`` on its
    shorter side."""
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        return None
    lib = _load_library("jpeg")
    if not lib:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.iqc_jpeg_info(buf, len(data), ctypes.byref(w), ctypes.byref(h)):
        return None
    scale = 1
    if target > 0:
        while scale < 8 and min(w.value, h.value) // (scale * 2) >= target:
            scale *= 2
    ow = (w.value + scale - 1) // scale
    oh = (h.value + scale - 1) // scale
    out = np.empty(((oh + 1) * (ow + 1) * 3,), np.uint8)
    c = ctypes.c_int()
    rc = lib.iqc_jpeg_decode(
        buf, len(data), scale, out.ctypes.data_as(_u8p), out.nbytes,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if rc or c.value != 3:
        return None
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()
