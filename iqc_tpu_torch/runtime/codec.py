"""Decoding of encoded image bytes without PIL.

- JPEG: libjpeg through ``native.decode_jpeg`` (DCT-domain downscale toward
  ``target``).
- PNG: 8-bit, non-interlaced grey, RGB and RGBA, read here with the
  standard library's ``zlib``; alpha is dropped, grey is repeated to RGB.

Any other format or variant decodes to None, which the callers answer as
"could not decode".
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from iqc_tpu_torch.runtime.native import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit variants read here
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> Optional[np.ndarray]:
    """Undo the per-row PNG filters; [height, stride] uint8, or None."""
    if len(raw) < height * (stride + 1):
        return None
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each channel along the row
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.uint32), axis=0) & 0xFF)
            cur = cur.astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: a chain along the row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            return None
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """An 8-bit non-interlaced grey, RGB or RGBA PNG -> RGB uint8 [H,W,3];
    None for anything else or a damaged file."""
    if not data.startswith(PNG_SIGNATURE):
        return None
    pos, header, idat = len(PNG_SIGNATURE), None, []
    try:
        while pos + 8 <= len(data):
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            if len(body) != length:
                return None
            pos += 12 + length
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
        if header is None:
            return None
        width, height, depth, color, _, _, interlace = header
        channels = _PNG_CHANNELS.get(color)
        if depth != 8 or channels is None or interlace != 0 or width == 0 or height == 0:
            return None
        raw = zlib.decompress(b"".join(idat))
    except (struct.error, zlib.error):
        return None
    pixels = _unfilter(raw, height, width * channels, channels)
    if pixels is None:
        return None
    img = pixels.reshape(height, width, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def decode_image(data: bytes, target: int = 0) -> Optional[np.ndarray]:
    """JPEG or PNG bytes -> RGB uint8 [H,W,3], or None. ``target`` > 0 lets
    a large JPEG decode at a reduced scale no smaller than ``target``."""
    decoded = decode_jpeg(data, target=target)
    if decoded is not None:
        return decoded
    return decode_png(data)
