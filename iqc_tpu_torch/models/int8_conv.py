"""int8 x int8 -> int32 convolution on NHWC codes, by im2col and
``torch._int_mm``.

The counterpart of ``lax.conv_general_dilated(int8, int8,
preferred_element_type=int32)`` with HWIO weights: the codes are padded
with zeros (JAX "SAME", asymmetric at stride 2, or explicit pairs), the
patches of every output pixel are gathered into the rows of an int8 matrix
in (kh, kw, cin) order, the weight's order, and one integer matrix product
gives the exact int32 accumulators.

``torch._int_mm`` on CUDA takes M > 16 rows and K and N that are multiples
of 8 (cuBLASLt int8 GEMM). Rows, taps and output channels are padded with
zeros to those limits, which leaves every product unchanged; the padding is
the same on every device, so the CPU runs the same matrices. A shape that
the product still refuses raises: no path falls back to float.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from iqc_tpu_torch.models.resnet import _same_pad

MIN_ROWS = 17   # _int_mm on CUDA: M > 16
ALIGN = 8       # _int_mm on CUDA: K and N multiples of 8

Padding = Union[str, Sequence[Tuple[int, int]]]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def check_int_mm(m: int, k: int, n: int) -> None:
    """Raise where ``torch._int_mm`` on CUDA refuses [m,k] x [k,n]."""
    if m < MIN_ROWS or k < 1 or n < 1 or k % ALIGN or n % ALIGN:
        raise ValueError(f"torch._int_mm on CUDA refuses [{m},{k}] x [{k},{n}]: it takes "
                         f"M > 16 and K, N positive multiples of {ALIGN}")


def int_mm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a [M,K] int8 x bt.T, for bt [N,K] int8 -> [M,N] int32; K and N already
    padded to multiples of 8 (``prepare_weight``), M padded here."""
    m = a.shape[0]
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    check_int_mm(a.shape[0], a.shape[1], bt.shape[0])
    out = torch._int_mm(a, bt.t())
    return out[:m] if m < MIN_ROWS else out


class ConvWeight(NamedTuple):
    """An HWIO int8 kernel as the [N_pad, K_pad] matrix that ``int_mm`` takes."""

    mat: torch.Tensor  # [N_pad, K_pad] int8, contiguous
    kh: int
    kw: int
    cin: int
    cout: int


def prepare_weight(w_hwio: torch.Tensor) -> ConvWeight:
    kh, kw, cin, cout = w_hwio.shape
    k = kh * kw * cin
    mat = w_hwio.reshape(k, cout).t()
    mat = F.pad(mat, (0, _round_up(k, ALIGN) - k, 0, _round_up(cout, ALIGN) - cout))
    return ConvWeight(mat.contiguous(), kh, kw, cin, cout)


def _pads(padding: Padding, h: int, w: int, kh: int, kw: int, stride: int):
    if isinstance(padding, str):
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return _same_pad(h, kh, stride), _same_pad(w, kw, stride)
    (t, b), (l, r) = padding
    return (t, b), (l, r)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: Padding,
           k_pad: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC codes -> ([B*Ho*Wo, k_pad] patches in (kh, kw, cin) order, zero
    beyond kh*kw*cin; (B, Ho, Wo))."""
    b, h, w, c = x.shape
    (t, bo), (l, r) = _pads(padding, h, w, kh, kw, stride)
    k = kh * kw * c
    if kh == kw == 1 and not (t or bo or l or r):
        x = x[:, ::stride, ::stride]
        ho, wo = x.shape[1], x.shape[2]
        cols = x.reshape(b * ho * wo, c)
    else:
        if t or bo or l or r:
            x = F.pad(x, (0, 0, l, r, t, bo))
        ho = (x.shape[1] - kh) // stride + 1
        wo = (x.shape[2] - kw) // stride + 1
        # [B,Ho,Wo,C,kh,kw] -> [B,Ho,Wo,kh,kw,C]
        patches = x.unfold(1, kh, stride).unfold(2, kw, stride)
        cols = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, k)
    if k_pad != k:
        cols = F.pad(cols, (0, k_pad - k))
    return cols.contiguous(), (b, ho, wo)


def conv_int8(x: torch.Tensor, weight: ConvWeight, stride: int = 1,
              padding: Padding = "SAME") -> torch.Tensor:
    """int8 NHWC codes [B,H,W,Cin] -> int32 NHWC accumulators [B,Ho,Wo,Cout]."""
    if x.dtype != torch.int8 or weight.mat.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x.dtype} and {weight.mat.dtype}")
    if x.shape[-1] != weight.cin:
        raise ValueError(f"input has {x.shape[-1]} channels, the kernel takes {weight.cin}")
    cols, (b, ho, wo) = im2col(x, weight.kh, weight.kw, stride, padding, weight.mat.shape[1])
    acc = int_mm(cols, weight.mat)
    if weight.mat.shape[0] != weight.cout:
        acc = acc[:, :weight.cout]
    return acc.reshape(b, ho, wo, weight.cout)
