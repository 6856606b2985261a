"""NMS suppression: the plain PyTorch version and the CUDA kernel, as the
custom op ``iqc::suppress``.

``suppress`` is the port of the TPU kernel
``iqc_tpu/ops/pallas_nms.py::_suppress_kernel``; its CUDA source is
``csrc/suppress.cu``. The op's CPU implementation is ``suppress_plain`` and
its CUDA implementation launches the kernel, so dispatch picks one by the
boxes' device; ``register_fake`` gives its output shape to ``torch.export``
and other tracers. The IoU threshold is a 0-d float32 tensor on the boxes'
device, which the kernel reads at run time (the TPU kernel reads it from
SMEM), so a captured graph or an exported program takes a new threshold at
every call. Each launch adds one to ``LAUNCHES["suppress"]`` (under
``LAUNCHES_LOCK``, as requests run from several threads), or, during a
graph capture, to each replay of the graph (``jit_utils.count_launch``).
"""

from __future__ import annotations

import threading
from typing import Union

import torch

from iqc_tpu_torch import build
from iqc_tpu_torch.ops.boxes import iou_matrix
from iqc_tpu_torch.ops.jit_utils import count_launch

LAUNCHES = {"suppress": 0}
LAUNCHES_LOCK = threading.Lock()
MAX_BOXES = 512  # csrc/suppress.cu keeps an image's K boxes in shared memory


def suppress_plain(boxes: torch.Tensor, iou_threshold: Union[float, torch.Tensor],
                   iterations: int = 16) -> torch.Tensor:
    """Greedy-NMS keep mask [B,K] for score-sorted boxes [B,K,4], by
    ``iterations`` synchronous rounds of
    keep[j] = not any_{i<j} (iou[i,j] > t and keep[i]) from all-ones."""
    t = torch.as_tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    iou = iou_matrix(boxes, boxes)
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    overlap = (iou > t) & (idx[:, None] < idx[None, :])  # i suppresses j
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    for _ in range(iterations):
        keep = ~torch.any(overlap & keep[..., :, None], dim=-2)
    return keep


@torch.library.custom_op("iqc::suppress", mutates_args=(), device_types="cpu")
def suppress_op(boxes: torch.Tensor, threshold: torch.Tensor, iterations: int) -> torch.Tensor:
    """Keep mask [B,K] bool of score-sorted boxes [B,K,4] at the 0-d IoU
    threshold: ``suppress_plain`` on the CPU, the kernel on the card."""
    return suppress_plain(boxes.to(torch.float32), threshold, iterations)


@suppress_op.register_kernel("cuda")
def _suppress_cuda(boxes: torch.Tensor, threshold: torch.Tensor,
                   iterations: int) -> torch.Tensor:
    b, k, _ = boxes.shape
    if k > MAX_BOXES:
        raise ValueError(f"suppression kernel takes at most {MAX_BOXES} boxes, got {k}")
    if threshold.numel() != 1 or threshold.device != boxes.device:
        raise ValueError("the threshold must be one value on the boxes' device")
    x = boxes
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    t = threshold.to(torch.float32).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=x.device)
    if b == 0 or k == 0:
        return keep
    build.launch(build.library().fns["iqc_suppress"], x.device, x.data_ptr(), t.data_ptr(),
                 keep.data_ptr(), b, k, int(iterations))
    count_launch(LAUNCHES, LAUNCHES_LOCK, "suppress")
    return keep


@suppress_op.register_fake
def _suppress_fake(boxes: torch.Tensor, threshold: torch.Tensor,
                   iterations: int) -> torch.Tensor:
    return boxes.new_empty(boxes.shape[:-1], dtype=torch.bool)


def suppress(boxes: torch.Tensor, iou_threshold: Union[float, torch.Tensor],
             iterations: int = 16) -> torch.Tensor:
    """Keep mask [B,K] bool for score-sorted, class-offset boxes [B,K,4]; the
    threshold a float or a 0-d float32 tensor on the boxes' device."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B,K,4], got {tuple(boxes.shape)}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no suppression kernel for device {boxes.device}")
    if not isinstance(iou_threshold, torch.Tensor):
        iou_threshold = torch.full((), float(iou_threshold), dtype=torch.float32,
                                   device=boxes.device)
    return suppress_op(boxes, iou_threshold, int(iterations))
