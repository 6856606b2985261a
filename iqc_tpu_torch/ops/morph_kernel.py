"""ROI morphology tails: the plain PyTorch versions and the CUDA kernels, as
the custom ops ``iqc::grow_clean`` and ``iqc::clean``.

``grow_clean`` is the port of ``iqc_tpu/ops/pallas_morph.py::_grow_clean_kernel``
and ``clean`` of ``_clean_kernel``; both launch ``csrc/morph.cu``. Each op's
CPU implementation is the plain version and its CUDA implementation
launches the kernel, so dispatch picks one by the masks' device; the
iteration counts are static ints. Each launch adds one to ``LAUNCHES``
(under ``LAUNCHES_LOCK``, as requests run from several threads), or, during
a graph capture, to each replay of the graph (``jit_utils.count_launch``).
"""

from __future__ import annotations

import threading

import torch

from iqc_tpu_torch import build
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops.jit_utils import count_launch

LAUNCHES = {"grow_clean": 0, "clean": 0}
LAUNCHES_LOCK = threading.Lock()
MAX_SIDE = 256  # csrc/morph.cu holds a ROI's rows bit-packed in registers


def clean_plain(mask: torch.Tensor, fill_iterations: int = 16) -> torch.Tensor:
    """Mask cleanup of [N,R,R] bool: open(1), bounded hole fill from each
    ROI's border ring, close(2), open(2)."""
    m = imops.binary_open(mask, 1)
    m = imops.fill_holes(m, fill_iterations)
    m = imops.binary_close(m, 2)
    return imops.binary_open(m, 2)


def grow_clean_plain(seeds: torch.Tensor, allow: torch.Tensor, grow_iterations: int = 24,
                     fill_iterations: int = 16) -> torch.Tensor:
    """Geodesic growth of ``seeds`` inside ``allow`` ([N,R,R] bool), then the
    cleanup (skipped when ``fill_iterations`` is 0)."""
    m = seeds.bool()
    for _ in range(grow_iterations):
        m = imops.binary_dilate(m, 1) & allow
    return clean_plain(m, fill_iterations) if fill_iterations else m


def _check(*masks: torch.Tensor) -> None:
    shape = masks[0].shape
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"masks must be [N,R,R], got {tuple(shape)}")
    for m in masks:
        if m.shape != shape or m.device != masks[0].device:
            raise ValueError("masks differ in shape or device")
    if masks[0].device.type == "cpu":
        return
    if masks[0].device.type != "cuda":
        raise ValueError(f"no morphology kernel for device {masks[0].device}")
    r = shape[1]
    if r % 32 or not 32 <= r <= MAX_SIDE:
        raise ValueError(f"morphology kernel takes R a multiple of 32 in [32, {MAX_SIDE}], got {r}")


def _prepared(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` as the kernel reads it: bool, contiguous, 16-byte aligned."""
    if mask.dtype != torch.bool:
        mask = mask.bool()
    if not mask.is_contiguous() or mask.data_ptr() % 16:
        mask = mask.clone(memory_format=torch.contiguous_format)
    return mask


def _launch(name: str, inputs, *ints: int) -> torch.Tensor:
    inputs = [_prepared(x) for x in inputs]
    out = torch.empty_like(inputs[0], memory_format=torch.contiguous_format)
    if out.shape[0] == 0:
        return out
    build.launch(build.library().fns[name], out.device, *(x.data_ptr() for x in inputs),
                 out.data_ptr(), out.shape[0], out.shape[1], *ints)
    count_launch(LAUNCHES, LAUNCHES_LOCK, name[4:])
    return out


@torch.library.custom_op("iqc::grow_clean", mutates_args=(), device_types="cpu")
def grow_clean_op(seeds: torch.Tensor, allow: torch.Tensor, grow_iterations: int,
                  fill_iterations: int) -> torch.Tensor:
    """[N,R,R] bool seeds and allow -> [N,R,R] bool: the plain version on the
    CPU, the kernel on the card."""
    out = grow_clean_plain(seeds.bool(), allow.bool(), grow_iterations, fill_iterations)
    return out.clone() if out is seeds else out  # an op's output aliases no input


@grow_clean_op.register_kernel("cuda")
def _grow_clean_cuda(seeds, allow, grow_iterations, fill_iterations):
    return _launch("iqc_grow_clean", (seeds, allow), int(grow_iterations),
                   int(fill_iterations))


@grow_clean_op.register_fake
def _grow_clean_fake(seeds, allow, grow_iterations, fill_iterations):
    return seeds.new_empty(seeds.shape, dtype=torch.bool)


@torch.library.custom_op("iqc::clean", mutates_args=(), device_types="cpu")
def clean_op(mask: torch.Tensor, fill_iterations: int) -> torch.Tensor:
    """[N,R,R] bool -> cleaned [N,R,R] bool: the plain version on the CPU,
    the kernel on the card."""
    return clean_plain(mask.bool(), fill_iterations)


@clean_op.register_kernel("cuda")
def _clean_cuda(mask, fill_iterations):
    return _launch("iqc_clean", (mask,), int(fill_iterations))


@clean_op.register_fake
def _clean_fake(mask, fill_iterations):
    return mask.new_empty(mask.shape, dtype=torch.bool)


def grow_clean(seeds: torch.Tensor, allow: torch.Tensor, grow_iterations: int = 24,
               fill_iterations: int = 16) -> torch.Tensor:
    """[N,R,R] bool seeds and allow -> [N,R,R] bool mask."""
    _check(seeds, allow)
    return grow_clean_op(seeds, allow, int(grow_iterations), int(fill_iterations))


def clean(mask: torch.Tensor, fill_iterations: int = 16) -> torch.Tensor:
    """[N,R,R] bool -> cleaned [N,R,R] bool."""
    _check(mask)
    return clean_op(mask, int(fill_iterations))
