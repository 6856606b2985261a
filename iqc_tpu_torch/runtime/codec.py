"""Decoding and encoding of image files without PIL.

- JPEG: libjpeg through ``native.decode_jpeg`` (DCT-domain downscale toward
  ``target``).
- PNG: 8-bit, non-interlaced grey, grey with alpha, RGB and RGBA, read here
  with the standard library's ``zlib``; alpha is dropped, grey is repeated
  to RGB. ``encode_png`` / ``write_png`` write 8-bit grey and RGB.
- BMP: uncompressed 24- and 32-bit (the fourth byte of a 32-bit pixel is
  ignored, as Pillow reads it).

``decode_image`` (the request path: JPEG and PNG) answers any other format
or variant with None, which the callers answer as "could not decode";
``read_image`` (datasets: JPEG, PNG and BMP) raises, naming it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from iqc_tpu_torch.runtime.native import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit variants read here
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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
    """An 8-bit non-interlaced grey, grey-alpha, RGB or RGBA PNG -> RGB
    uint8 [H,W,3]; None for anything else or a damaged file."""
    img = _decode_png_channels(data)
    if img is None:
        return None
    if img.shape[-1] <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _decode_png_channels(data: bytes) -> Optional[np.ndarray]:
    """The PNG's pixels with their own channels [H,W,1|2|3|4], or None."""
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
    return pixels.reshape(height, width, channels)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 grey [H,W] (or [H,W,1]) or RGB [H,W,3] -> PNG bytes (8-bit,
    no interlace, every row unfiltered, zlib level 6)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"PNG writes grey [H,W] or RGB [H,W,3] images, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def decode_bmp(data: bytes) -> Optional[np.ndarray]:
    """An uncompressed 24- or 32-bit BMP -> RGB uint8 [H,W,3]; None when
    ``data`` is not a BMP file. Any other BMP variant (palette, 16-bit,
    run-length or bit-field compression) raises ValueError, naming it."""
    if not data.startswith(b"BM") or len(data) < 26:
        return None
    offset, dib = struct.unpack("<II", data[10:18])
    if dib < 40 or len(data) < 14 + 40:
        raise ValueError(f"unsupported BMP: {dib}-byte header (a BITMAPINFOHEADER or later "
                         "is read)")
    width, height, _, bpp, compression = struct.unpack("<iiHHI", data[18:34])
    if bpp not in (24, 32) or compression != 0:
        raise ValueError(f"unsupported BMP: {bpp}-bit, compression {compression} (uncompressed "
                         "24- and 32-bit BMP are read)")
    if width <= 0 or height == 0:
        raise ValueError(f"unsupported BMP: {width}x{height}")
    h, step = abs(height), bpp // 8
    stride = (width * step + 3) & ~3
    if len(data) < offset + stride * h:
        raise ValueError("damaged BMP: the pixel array is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    px = rows[:, :width * step].reshape(h, width, step)[..., 2::-1]  # BGR(X) -> RGB
    if height > 0:  # stored bottom-up
        px = px[::-1]
    return np.ascontiguousarray(px)


def decode_image(data: bytes, target: int = 0) -> Optional[np.ndarray]:
    """JPEG or PNG bytes (the formats the request path reads) -> RGB uint8
    [H,W,3], or None. ``target`` > 0 lets a large JPEG decode at a reduced
    scale no smaller than ``target``."""
    decoded = decode_jpeg(data, target=target)
    if decoded is not None:
        return decoded
    return decode_png(data)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L conversion: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    x = rgb.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """The image file at ``path`` as uint8 RGB [H,W,3] (``mode="RGB"``) or
    grey [H,W] (``mode="L"``), converted as Pillow's ``convert`` converts:
    grey is repeated to RGB, alpha is dropped with no compositing, RGB
    becomes grey by Pillow's luma. JPEG (where libjpeg is built), PNG and
    BMP are read; anything else raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if mode not in ("RGB", "L"):
        raise ValueError(f"unknown mode {mode!r} (RGB or L)")
    channels = _decode_png_channels(data)
    if channels is not None:
        if channels.shape[-1] <= 2:
            grey = channels[..., 0]
            return grey.copy() if mode == "L" else np.repeat(grey[..., None], 3, axis=-1)
        rgb = np.ascontiguousarray(channels[..., :3])
    elif data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: unsupported PNG (8-bit, non-interlaced grey, grey-alpha, "
                         "RGB and RGBA are read)")
    else:
        rgb = decode_jpeg(data)
        if rgb is None:
            rgb = decode_bmp(data)
        if rgb is None:
            raise ValueError(f"{path}: could not decode (JPEG, PNG and BMP are read; JPEG "
                             "needs the native libjpeg decoder)")
    return _luma(rgb) if mode == "L" else rgb
