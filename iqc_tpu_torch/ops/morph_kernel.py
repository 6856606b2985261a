"""ROI morphology tails: the plain PyTorch versions and the CUDA kernels'
wrappers.

``grow_clean`` is the port of ``iqc_tpu/ops/pallas_morph.py::_grow_clean_kernel``
and ``clean`` of ``_clean_kernel``; both launch ``csrc/morph.cu``. For a CPU
tensor they run the plain versions; for a CUDA tensor they launch the kernel
(or raise), and add one to ``LAUNCHES`` per launch.
"""

from __future__ import annotations

import torch

from iqc_tpu_torch.ops import image as imops

LAUNCHES = {"grow_clean": 0, "clean": 0}
MAX_SIDE = 256  # csrc/morph.cu holds a ROI bit-packed in shared memory


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


def _launch(name: str, inputs, out: torch.Tensor, *ints: int) -> torch.Tensor:
    from iqc_tpu_torch.build import library

    lib = library()
    if out.shape[0] == 0:
        return out
    with torch.cuda.device(out.device):
        lib.call(name, *(x.data_ptr() for x in inputs), out.data_ptr(), out.shape[0],
                 out.shape[1], *ints, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name[4:]] += 1
    return out


def grow_clean(seeds: torch.Tensor, allow: torch.Tensor, grow_iterations: int = 24,
               fill_iterations: int = 16) -> torch.Tensor:
    """[N,R,R] bool seeds and allow -> [N,R,R] bool mask."""
    _check(seeds, allow)
    if seeds.device.type == "cpu":
        return grow_clean_plain(seeds.bool(), allow.bool(), grow_iterations, fill_iterations)
    s = seeds.bool().contiguous()
    a = allow.bool().contiguous()
    return _launch("iqc_grow_clean", (s, a), torch.empty_like(s),
                   int(grow_iterations), int(fill_iterations))


def clean(mask: torch.Tensor, fill_iterations: int = 16) -> torch.Tensor:
    """[N,R,R] bool -> cleaned [N,R,R] bool."""
    _check(mask)
    if mask.device.type == "cpu":
        return clean_plain(mask.bool(), fill_iterations)
    m = mask.bool().contiguous()
    return _launch("iqc_clean", (m,), torch.empty_like(m), int(fill_iterations))
