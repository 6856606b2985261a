"""The port's native serving runtime and image decoding against the JAX
package's.

- ``BatchQueue``, ``NativeRateLimiter`` and ``LatencyHistogram``: the port's
  C++ build, the JAX package's C++ build, and both packages' Python
  fallbacks give EQUAL answers to the same calls (the histogram's fallback
  keeps raw samples, so there the native answer is the lower edge of the
  log bin that holds numpy's "lower" percentile: within a factor of
  (1e7)^(1/255) = 1.0653 below it).
- ``decode_jpeg`` at target 0 and 640: EQUAL to the JAX package's native
  decoder (the same source and the same libjpeg).
- The JPEG of frame 0 that ``chip_smoke.py`` posts (``tests/data``): EQUAL
  through both packages' native decoders, and within a mean of 6 grey levels
  of the seeded frame it encodes (measured: 4.62).
- The PNG reader: EQUAL to PIL for 8-bit grey, RGB and RGBA, with every
  filter type; None for what it does not read.
- The libraries land under ``build/runtime/``, never in the source tree.
"""

import io
import os
import struct
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from iqc_tpu.runtime import native as jnative
from iqc_tpu_torch.config import REPO_ROOT
from iqc_tpu_torch.runtime import codec
from iqc_tpu_torch.runtime import native

BIN_RATIO = 1e7 ** (1 / 255)


def _make(monkeypatch, label, mod, name, *args):
    with monkeypatch.context() as m:
        if label.endswith("-py"):
            m.setattr(mod, "_load_library", lambda *a: False)
        obj = getattr(mod, name)(*args)
    assert obj._native == (not label.endswith("-py"))
    return obj


IMPLS = [("port", native), ("jax", jnative), ("port-py", native), ("jax-py", jnative)]


def test_native_libraries_build_under_build_dir():
    assert native.native_available() and native.jpeg_available()
    for name in native.LIBRARIES:
        path = native.library_path(name)
        assert os.path.exists(path)
        assert os.path.dirname(path) == os.path.join(REPO_ROOT, "build", "runtime")
    built = [f for f in os.listdir(native.CPP_DIR) if not f.endswith(".cc")]
    assert built == [], built


def _queue_trace(q):
    trace = [q.push(i) for i in range(5)]
    trace += [q.qsize(), q.pop_batch(3, timeout_ms=10), q.pop_batch(8, timeout_ms=10),
              q.pop_batch(2, timeout_ms=10), q.qsize()]
    trace += [q.push(7), q.push(8), q.push(9), q.push(10), q.qsize()]
    q.close()
    trace += [q.push(11), q.pop_batch(8, timeout_ms=10), q.pop_batch(8, timeout_ms=10)]
    return trace


def test_batch_queue_equal_across_implementations(monkeypatch):
    traces = {label: _queue_trace(_make(monkeypatch, label, mod, "BatchQueue", 3))
              for label, mod in IMPLS}
    assert traces["port"] == [True, True, True, False, False, 3, [0, 1, 2], [], [], 0,
                              True, True, True, False, 3, False, [7, 8, 9], []]
    for label, trace in traces.items():
        assert trace == traces["port"], label


def test_batch_queue_concurrent_producers(monkeypatch):
    for label, mod in IMPLS[::2]:
        q = _make(monkeypatch, label, mod, "BatchQueue", 4096)
        threads = [threading.Thread(target=lambda b=b: [q.push(b * 1000 + i) for i in range(100)])
                   for b in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        got = []
        while batch := q.pop_batch(64, timeout_ms=20):
            got += batch
        assert sorted(got) == sorted(b * 1000 + i for b in range(8) for i in range(100)), label


def test_rate_limiter_equal_across_implementations(monkeypatch):
    keys = ["10.0.0.1"] * 4 + ["10.0.0.2"] * 2 + ["10.0.0.1", "10.0.0.3"] * 3
    answers = {}
    for label, mod in IMPLS:
        rl = _make(monkeypatch, label, mod, "NativeRateLimiter", 3, 60.0)
        assert (rl.max_requests, rl.window) == (3, 60.0)
        answers[label] = [rl.allow(k) for k in keys]
    assert answers["port"] == [True] * 3 + [False] + [True] * 2 + [False, True] * 3
    for label, got in answers.items():
        assert got == answers["port"], label


def test_latency_histogram_equal_across_implementations(monkeypatch):
    samples = np.random.default_rng(3).lognormal(2.0, 1.0, 1000)
    summaries = {}
    for label, mod in IMPLS:
        h = _make(monkeypatch, label, mod, "LatencyHistogram")
        assert h.summary()["count"] == 0 and h.percentile(50) == 0.0
        for v in samples:
            h.record(v)
        summaries[label] = h.summary()
    assert summaries["port"] == summaries["jax"]
    assert summaries["port-py"] == summaries["jax-py"]
    assert summaries["port"]["count"] == summaries["port-py"]["count"] == 1000
    np.testing.assert_allclose(summaries["port"]["mean_ms"], samples.mean(), rtol=1e-12)
    for p in (50, 95, 99):
        x = float(np.percentile(samples, p, method="lower"))
        got = summaries["port"][f"p{p}_ms"]
        assert x / BIN_RATIO <= got <= x * (1 + 1e-12), (p, got, x)


# -- decoding ------------------------------------------------------------------------


def _part(seed, h=480, w=720):
    """A grey textured part with a dark scratch and a bright spot."""
    rng = np.random.default_rng(seed)
    img = np.clip(160 + rng.normal(0, 5, (h, w, 3)), 0, 255)
    img[100:112, 80:400] = 30
    yy, xx = np.ogrid[:h, :w]
    img[(yy - 300) ** 2 + (xx - 500) ** 2 <= 40 ** 2] = 240
    return img.astype(np.uint8)


def _encode(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("target", [0, 640, 200])
def test_decode_jpeg_equals_jax_native(target):
    data = _encode(_part(1, 1400, 1900), "JPEG", quality=90)
    got, want = native.decode_jpeg(data, target), jnative.decode_jpeg(data, target)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    if target:
        assert min(got.shape[:2]) >= target and min(got.shape[:2]) < 2 * target
    np.testing.assert_array_equal(codec.decode_image(data, target), got)


def test_smoke_jpeg_frame():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(smoke.JPEG_FRAME, "rb") as f:
        data = f.read()
    for target in (0, 640):
        got = native.decode_jpeg(data, target)
        np.testing.assert_array_equal(got, jnative.decode_jpeg(data, target))
    seeded = smoke.defect_image(0)
    assert got.shape == seeded.shape
    assert np.abs(got.astype(np.int32) - seeded).mean() < 6


def test_decode_jpeg_refuses_what_is_not_jpeg():
    assert native.decode_jpeg(b"not a jpeg") is None
    assert native.decode_jpeg(b"\xff\xd8\xff\xe0garbage" * 10) is None
    assert codec.decode_image(b"GIF89a....") is None


def _png(img, color, filt):
    """A PNG written with one filter type on every row (PIL chooses its own)."""
    h, w = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    rows = img.reshape(h, w * ch).astype(np.int32)
    prior = np.zeros_like(rows[0])
    raw = b""
    for r in rows:
        left = np.concatenate([np.zeros(ch, np.int32), r[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prior[:-ch]])
        if filt == 0:
            f = r
        elif filt == 1:
            f = r - left
        elif filt == 2:
            f = r - prior
        elif filt == 3:
            f = r - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            f = r - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw += bytes([filt]) + (f & 0xFF).astype(np.uint8).tobytes()
        prior = r

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (codec.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,color", [("L", 0), ("RGB", 2), ("RGBA", 6)])
def test_png_reader_equals_pil(mode, color):
    rng = np.random.default_rng(color)
    img = _part(color, 37, 53)
    if mode == "L":
        img = img[..., 0]
    elif mode == "RGBA":
        img = np.concatenate([img, rng.integers(0, 255, (37, 53, 1), dtype=np.uint8)], -1)
    datas = [_encode(img, "PNG")] + [_png(img, color, f) for f in range(5)]
    for data in datas:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(codec.decode_png(data), want)
        np.testing.assert_array_equal(codec.decode_image(data, 640), want)


def test_png_reader_refuses_other_variants():
    img = _part(4, 16, 16)
    assert codec.decode_png(_encode(img, "PNG")[:40]) is None          # truncated
    assert codec.decode_png(_encode(img[..., 0].astype(np.uint16) * 200, "PNG")) is None  # 16-bit
    assert codec.decode_png(_encode(img, "PNG", optimize=False).replace(b"IHDR", b"IHDX")) is None
    pal = Image.fromarray(img).convert("P")
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    assert codec.decode_png(buf.getvalue()) is None                     # palette
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "BMP")
    assert codec.decode_image(buf.getvalue()) is None                   # other formats
