"""Bicubic and bilinear resize of uint8 images, byte-equal to Pillow's
``Image.resize(size)`` (its default BICUBIC filter) and
``Image.resize(size, Image.BILINEAR)``, without Pillow.

Pillow's ``Resample.c``: a separable convolution with the filter's kernel
(bicubic a = -0.5 with support 2, or the triangle with support 1), widened
by the scale factor when shrinking; each
output sample's taps are normalised to sum to one and turned into 22-bit
fixed point (rounded half away from zero); a horizontal pass writes a uint8
intermediate over the rows the vertical pass reads, then the vertical pass
writes the output; each accumulator starts at half a unit and is shifted
down and clipped to [0, 255]. A pass whose size does not change is skipped.

The integer accumulations run as float64 matrix products: every term and
partial sum is an integer below 2**53, so they are exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    return 1.0 - x if x < 1.0 else 0.0


# filter -> (kernel, support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def _coefficients(in_size: int, out_size: int, kernel=_bicubic,
                  support: float = 2.0) -> Tuple[int, np.ndarray]:
    """(first input index used, [out_size, n_used] fixed-point weights as
    float64) for one axis."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        fixed = [int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                 else int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
        rows.append((xmin, fixed))
    lo = min(x for x, _ in rows)
    hi = max(x + len(f) for x, f in rows)
    mat = np.zeros((out_size, hi - lo), np.float64)
    for i, (xmin, fixed) in enumerate(rows):
        mat[i, xmin - lo:xmin - lo + len(fixed)] = fixed
    return lo, mat


def _clip8(acc: np.ndarray) -> np.ndarray:
    v = np.floor((acc + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS))
    return np.clip(v, 0, 255).astype(np.uint8)


def resize_bicubic(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] -> uint8 resized to ``size`` = (width, height),
    the argument order of ``Image.resize``."""
    return resize(image, size, "bicubic")


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``resize_bicubic`` with Pillow's bilinear filter."""
    return resize(image, size, "bilinear")


def resize(image: np.ndarray, size: Tuple[int, int], resample: str = "bicubic") -> np.ndarray:
    """uint8 [H,W] or [H,W,C] resized to ``size`` = (width, height) with
    Pillow's ``resample`` filter, "bicubic" or "bilinear"."""
    kernel, support = _FILTERS[resample]
    coefficients = lambda n_in, n_out: _coefficients(n_in, n_out, kernel, support)
    out_w, out_h = size
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8 pixels, got {img.dtype}")
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    in_h, in_w = x.shape[:2]
    if in_w != out_w:
        lo_y, kv = (0, None) if in_h == out_h else coefficients(in_h, out_h)
        # only the rows the vertical pass reads
        rows = x if kv is None else x[lo_y:lo_y + kv.shape[1]]
        lo_x, kh = coefficients(in_w, out_w)
        src = rows[:, lo_x:lo_x + kh.shape[1]].astype(np.float64)
        x = _clip8(np.tensordot(src, kh, axes=([1], [1])).transpose(0, 2, 1))
        if kv is not None:
            x = _clip8(np.tensordot(kv, x.astype(np.float64), axes=([1], [0])))
    elif in_h != out_h:
        lo_y, kv = coefficients(in_h, out_h)
        src = x[lo_y:lo_y + kv.shape[1]].astype(np.float64)
        x = _clip8(np.tensordot(kv, src, axes=([1], [0])))
    else:
        x = x.copy()
    return x[..., 0] if squeeze else x
