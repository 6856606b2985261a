"""Counts of the int8 YOLOv8: the number of quantized convolutions, which
sizes the scale vectors of the int8 walks (the JAX package's
``models/yolo_int8.py::n_convs``)."""

from __future__ import annotations

from iqc_tpu_torch.models.yolo import _depth


def n_convs(depth_mult: float = 0.334, stem_mode: str = "conv") -> int:
    """Number of quantized ConvBN layers in forward call order."""
    n = _depth(3, depth_mult)      # c2f_2, c2f_5 and neck blocks' inner count
    n6 = _depth(6, depth_mult)     # c2f_3, c2f_4
    c2f = lambda k: 2 + 2 * k
    total = 1 if stem_mode == "s2d" else 2
    total += c2f(n) + 1 + c2f(n6) + 1 + c2f(n6) + 1 + c2f(n)  # backbone and downs
    total += 2                      # sppf in/out
    total += c2f(n) * 4             # 4 neck C2f blocks
    total += 2                      # neck downsamples
    total += 4 * 3                  # 3 heads x 4 ConvBN
    return total
