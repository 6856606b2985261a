"""NMS suppression: the plain PyTorch version and the CUDA kernel's wrapper.

``suppress`` is the port of the TPU kernel
``iqc_tpu/ops/pallas_nms.py::_suppress_kernel``; its CUDA source is
``csrc/suppress.cu``. For a CPU tensor it runs ``suppress_plain``; for a
CUDA tensor it launches the kernel (or raises), and adds one to
``LAUNCHES["suppress"]`` per launch (under ``LAUNCHES_LOCK``, as requests
run from several threads).
"""

from __future__ import annotations

import threading

import torch

from iqc_tpu_torch import build
from iqc_tpu_torch.ops.boxes import iou_matrix

LAUNCHES = {"suppress": 0}
LAUNCHES_LOCK = threading.Lock()
MAX_BOXES = 512  # csrc/suppress.cu keeps an image's K boxes in shared memory


def suppress_plain(boxes: torch.Tensor, iou_threshold: float,
                   iterations: int = 16) -> torch.Tensor:
    """Greedy-NMS keep mask [B,K] for score-sorted boxes [B,K,4], by
    ``iterations`` synchronous rounds of
    keep[j] = not any_{i<j} (iou[i,j] > t and keep[i]) from all-ones."""
    t = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    iou = iou_matrix(boxes, boxes)
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    overlap = (iou > t) & (idx[:, None] < idx[None, :])  # i suppresses j
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    for _ in range(iterations):
        keep = ~torch.any(overlap & keep[..., :, None], dim=-2)
    return keep


def suppress(boxes: torch.Tensor, iou_threshold: float, iterations: int = 16) -> torch.Tensor:
    """Keep mask [B,K] bool for score-sorted, class-offset boxes [B,K,4]."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B,K,4], got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return suppress_plain(boxes.to(torch.float32), iou_threshold, iterations)
    if boxes.device.type != "cuda":
        raise ValueError(f"no suppression kernel for device {boxes.device}")
    b, k, _ = boxes.shape
    if k > MAX_BOXES:
        raise ValueError(f"suppression kernel takes at most {MAX_BOXES} boxes, got {k}")
    x = boxes
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=x.device)
    if b == 0 or k == 0:
        return keep
    build.launch(build.library().fns["iqc_suppress"], x.device, x.data_ptr(), keep.data_ptr(),
                 b, k, float(iou_threshold), int(iterations))
    with LAUNCHES_LOCK:
        LAUNCHES["suppress"] += 1
    return keep
