"""Image ops, box geometry and ROI segmentation of the port against the JAX
package on the same inputs (CPU, float32).

Tolerances: booleans (masks, morphology) and integer outputs EQUAL; float
images within 1e-6 absolute on [0,1] data (the antialiased bilinear resize
measured 1.8e-7 against ``jax.image.resize``, the separable blur 1.2e-7);
Sobel magnitudes within 1e-5; segmentation statistics from equal masks
exact, confidences within 1e-4 relative.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqc_tpu.ops import boxes as jboxes
from iqc_tpu.ops import image as jimg
from iqc_tpu.ops import segmentation as jseg
from iqc_tpu_torch.ops import boxes as tboxes
from iqc_tpu_torch.ops import image as timg
from iqc_tpu_torch.ops import segmentation as tseg

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((2, 96, 96, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def gray():
    return np.random.default_rng(1).random((4, 64, 64), dtype=np.float32)


def test_to_float_normalize_gray(images):
    u8 = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timg.to_float(_t(u8)).numpy(),
                                  np.asarray(jimg.to_float(jnp.asarray(u8))))
    np.testing.assert_allclose(timg.normalize_imagenet(_t(images)).numpy(),
                               np.asarray(jimg.normalize_imagenet(jnp.asarray(images))),
                               atol=1e-6)
    np.testing.assert_allclose(timg.rgb_to_gray(_t(images)).numpy(),
                               np.asarray(jimg.rgb_to_gray(jnp.asarray(images))), atol=1e-6)


@pytest.mark.parametrize("size", [(128, 128), (64, 64), (32, 32), (100, 60), (96, 96)])
def test_resize_bilinear_antialias(images, size):
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(images), size))
    got = timg.resize_bilinear(_t(images), size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_resize_640_to_128():
    """The global classifier branch's downscale."""
    x = np.random.default_rng(3).random((1, 640, 640, 3), dtype=np.float32)
    want = np.asarray(jimg.resize_bilinear(jnp.asarray(x), (128, 128)))
    np.testing.assert_allclose(timg.resize_bilinear(_t(x), (128, 128)).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (2.3, 6)])
def test_gaussian_blur(gray, sigma, radius):
    want = np.stack([np.asarray(jimg.gaussian_blur(jnp.asarray(g), sigma, radius)) for g in gray])
    np.testing.assert_allclose(timg.gaussian_blur(_t(gray), sigma, radius).numpy(), want, atol=1e-6)


def test_otsu_adaptive_sobel(gray):
    want = np.stack([np.asarray(jimg.otsu_threshold(jnp.asarray(g))) for g in gray])
    np.testing.assert_allclose(timg.otsu_threshold(_t(gray)).numpy(), want, rtol=1e-6)
    want = np.stack([np.asarray(jimg.adaptive_local_mean(jnp.asarray(g), 13)) for g in gray])
    np.testing.assert_allclose(timg.adaptive_local_mean(_t(gray), 13).numpy(), want, atol=1e-6)
    want = np.stack([np.asarray(jimg.sobel_magnitude(jnp.asarray(g))) for g in gray])
    np.testing.assert_allclose(timg.sobel_magnitude(_t(gray)).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("op", ["binary_dilate", "binary_erode", "binary_open", "binary_close"])
@pytest.mark.parametrize("radius", [1, 2])
def test_binary_morphology(op, radius):
    m = np.random.default_rng(radius).random((3, 32, 32)) < 0.5
    want = np.asarray(getattr(jimg, op)(jnp.asarray(m), radius))
    np.testing.assert_array_equal(getattr(timg, op)(_t(m), radius).numpy(), want)


def test_fill_holes():
    m = np.random.default_rng(9).random((3, 32, 32)) < 0.55
    want = np.asarray(jimg.fill_holes(jnp.asarray(m), 16))
    np.testing.assert_array_equal(timg.fill_holes(_t(m), 16).numpy(), want)


def test_crop_and_resize(images):
    boxes = np.asarray([[10, 10, 50, 40], [0, 0, 96, 96], [-5, -5, 20, 20],
                        [30, 30, 30, 30], [80, 70, 120, 130]], np.float32)
    got = timg.crop_and_resize(_t(images), _t(np.stack([boxes, boxes[::-1].copy()])), (32, 24))
    for b in range(2):
        bx = boxes if b == 0 else boxes[::-1]
        want = np.asarray(jimg.crop_and_resize(jnp.asarray(images[b]), jnp.asarray(bx), (32, 24)))
        np.testing.assert_allclose(got[b].numpy(), want, atol=1e-6)


def test_box_area_and_iou():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 100, (20, 2))
    wh = rng.uniform(-5, 40, (20, 2))  # some negative extents
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    np.testing.assert_allclose(tboxes.box_area(_t(boxes)).numpy(),
                               np.asarray(jboxes.box_area(jnp.asarray(boxes))), rtol=1e-6)
    want = np.asarray(jboxes.iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes)))
    np.testing.assert_allclose(tboxes.iou_matrix(_t(boxes), _t(boxes)).numpy(), want,
                               rtol=1e-6, atol=1e-7)


# -- segmentation ----------------------------------------------------------------


def _blob_rois(seed, n=10, r=64):
    rng = np.random.default_rng(seed)
    rois = np.full((n, r, r), 0.7, np.float32) + rng.normal(0, 0.02, (n, r, r))
    yy, xx = np.mgrid[:r, :r]
    for i in range(n):
        cx, cy = rng.integers(r // 3, 2 * r // 3, 2)
        rad = rng.integers(r // 10, r // 4)
        rois[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2] = 0.25 if i % 2 == 0 else 0.95
    return np.clip(rois, 0, 1).astype(np.float32), (np.arange(n) % 5).astype(np.int32)


@pytest.mark.parametrize("seed,r", [(7, 64), (1, 128), (3, 64), ("noise", 64)])
def test_segment_rois(seed, r):
    if seed == "noise":
        rois = np.random.default_rng(5).random((10, r, r)).astype(np.float32)
        cls = (np.arange(10) % 5).astype(np.int32)
    else:
        rois, cls = _blob_rois(seed, 10, r)
    valid = np.ones(10, bool)
    valid[-1] = False
    sx = np.linspace(0.5, 2, 10).astype(np.float32)
    sy = np.linspace(2, 0.7, 10).astype(np.float32)
    want = jseg.segment_rois(*(jnp.asarray(v) for v in (rois, cls, valid, sx, sy)))
    got = tseg.segment_rois(*(_t(v) for v in (rois, cls, valid, sx, sy)))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.method.numpy(), np.asarray(want.method))
    for f in ("area", "perimeter", "compactness"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence),
                               rtol=1e-4, atol=1e-6)


def test_mask_stats_and_table_lookup():
    m = np.random.default_rng(6).random((5, 32, 32)) < 0.6
    area, perim = tseg.mask_stats(_t(m))
    for i in range(5):
        a, p = jseg.mask_stats(jnp.asarray(m[i]))
        assert float(area[i]) == float(a) and float(perim[i]) == float(p)
    ids = np.asarray([0, 1, 2, 3, 4, 4, 0], np.int32)
    for table in (jseg.CLASS_TO_METHOD, jseg.CLASS_THRESH_ADJUST, jseg.CLASS_IS_DARK):
        np.testing.assert_array_equal(tseg.table_lookup(table, _t(ids)).numpy(),
                                      np.asarray(jseg.table_lookup(table, jnp.asarray(ids))))


def test_segmentation_golden_through_port():
    """tests/golden/segmentation_kernels.json on the port, with the golden
    test's own tolerances."""
    rng = np.random.default_rng(7)
    n, r = 8, 64
    rois = np.full((n, r, r), 0.7, np.float32) + rng.normal(0, 0.02, (n, r, r))
    yy, xx = np.mgrid[:r, :r]
    for i in range(n):
        cx, cy = rng.integers(20, 44, 2)
        rad = rng.integers(6, 14)
        rois[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2] = 0.25 if i % 2 == 0 else 0.95
    rois = np.clip(rois, 0, 1).astype(np.float32)
    classes = (np.arange(n) % 5).astype(np.int32)
    out = tseg.segment_rois(_t(rois), _t(classes), torch.ones(n, dtype=torch.bool),
                            torch.ones(n), torch.ones(n))
    want = json.load(open(os.path.join(GOLDEN_DIR, "segmentation_kernels.json")))
    assert out.method.tolist() == want["method"]
    np.testing.assert_allclose(out.area.numpy(), want["area"], rtol=0.02, atol=2.0)
    np.testing.assert_allclose(out.masks.sum(dim=(1, 2)).numpy(), want["mask_sums"],
                               rtol=0.02, atol=4.0)
    np.testing.assert_allclose(out.perimeter.numpy(), want["perimeter"], rtol=0.05, atol=4.0)
    np.testing.assert_allclose(out.compactness.numpy(), want["compactness"], rtol=0.05, atol=0.02)
    np.testing.assert_allclose(out.confidence.numpy(), want["confidence"], rtol=0.02, atol=0.01)
