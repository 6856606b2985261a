"""Builds the CUDA kernels of ``csrc/`` into one shared library and loads it.

One ``nvcc`` call compiles every source for Hopper (``sm_90a``) into a shared
library with a plain C interface, bound with ``ctypes``: no PyTorch headers,
no ``ninja``, a build of seconds. ``--fmad=false`` keeps every multiply and
add separately rounded and division stays IEEE (no fast math), so float32
results round exactly as the plain PyTorch versions do.

The library lands in ``build/kernels/`` under the repository root, named by a
hash of the sources and flags, so it is rebuilt only when they change. The
build runs on first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from iqc_tpu_torch.config import REPO_ROOT

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("suppress.cu", "morph.cu")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 300  # below chip_smoke.py's build deadline, so nvcc is stopped first

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # boxes, threshold (a device pointer), keep, batch, k, iterations, stream
    "iqc_suppress": (_P, _P, _P, _I, _I, _I, _P),
    # seeds, allow, out, n, r, grow_iterations, fill_iterations, stream
    "iqc_grow_clean": (_P, _P, _P, _I, _I, _I, _I, _P),
    # mask, out, n, r, fill_iterations, stream
    "iqc_clean": (_P, _P, _I, _I, _I, _P),
}


class Library:
    """The loaded kernel library and how long its build took. ``fns`` maps
    each entry point's name to its ctypes function, resolved once here."""

    def __init__(self, path: str, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self.cdll = ctypes.CDLL(path)
        self.fns = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            self.fns[name] = fn


def launch(fn, device: torch.device, *args) -> None:
    """Call entry point ``fn`` with ``args`` and the current stream of
    ``device``, a tensor's CUDA device (so it carries its index), making the
    device current only where it is not; raise on a CUDA error code."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(fn, device, *args)
    # the raw handle of the current stream, without building a torch.cuda.Stream
    # (which enters a device context on every call)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libiqc_kernels_{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the library unless it exists; returns the seconds spent."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


_library: Optional[Library] = None
_library_lock = threading.Lock()


def library() -> Library:
    """The kernel library, built and loaded on first call (from any thread)."""
    global _library
    if _library is None:
        with _library_lock:
            if _library is None:
                seconds = build()
                _library = Library(library_path(), seconds)
    return _library
