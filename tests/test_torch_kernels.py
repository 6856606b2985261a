"""The port's three kernels (NMS suppression, grow+clean, clean): their plain
PyTorch versions against the JAX package's Pallas kernels run in interpret
mode. The CUDA kernels against the plain versions: tests/test_torch_cuda.py.

Tolerance: keep masks and morphology masks are booleans and must be EQUAL.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from iqc_tpu.ops import image as jimops
from iqc_tpu.ops.pallas_morph import pallas_clean, pallas_grow_clean
from iqc_tpu.ops.pallas_nms import pallas_suppression
from iqc_tpu.ops.segmentation import _clean_mask
from iqc_tpu_torch.ops import morph_kernel, nms_kernel
from iqc_tpu_torch.ops.nms import nms_single

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


# -- K1: suppression ----------------------------------------------------------


def _sorted_problem(seed, n=64):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(20, 180, n)
    cy = rng.uniform(20, 180, n)
    w = rng.uniform(5, 60, n)
    h = rng.uniform(5, 60, n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def _chain(n=40):
    """Box i overlaps i+1 (IoU 2/3) but not i+2 (IoU 3/7): greedy NMS needs
    n rounds to settle, so 16 rounds leave the tail unsettled."""
    x = np.arange(n, dtype=np.float32) * 2.0
    return np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], -1).astype(np.float32)


def _boundary_and_classes():
    """IoU exactly 0.5 (kept at t=0.5), just above it (suppressed), the same
    box in another class (offset by 1e5, kept) and zero-area pads."""
    boxes = [
        [0, 0, 10, 10],
        [0, 0, 10, 5],        # IoU 0.5 with box 0
        [0, 0, 10, 5.2],      # IoU 0.52 with box 0
        [1e5, 0, 1e5 + 10, 10],  # box 0 in class 1
        [1e5, 0, 1e5 + 10, 10],  # duplicate in class 1
        [0, 0, 0, 0],
        [0, 0, 0, 0],
        [5, 5, 5, 5],
    ]
    return np.asarray(boxes, np.float32)


def _cases():
    cases = {f"random{s}": _sorted_problem(s) for s in (0, 1, 2)}
    cases["odd37"] = _sorted_problem(3, n=37)
    cases["chain40"] = _chain()
    cases["boundary_classes_pads"] = _boundary_and_classes()
    cases["disjoint"] = np.asarray([[i * 100, 0, i * 100 + 50, 50] for i in range(8)], np.float32)
    cases["duplicates"] = np.tile(np.asarray([[0, 0, 50, 50]], np.float32), (8, 1))
    return cases


@pytest.mark.parametrize("name", sorted(_cases()))
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_suppress_plain_equals_pallas(name, threshold):
    boxes = _cases()[name]
    want = np.asarray(pallas_suppression(jnp.asarray(boxes), jnp.float32(threshold),
                                         interpret=True))
    got = nms_kernel.suppress(torch.from_numpy(boxes)[None], threshold)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_chain_is_deeper_than_the_rounds():
    """The chain case really is unsettled after 16 rounds: the bounded
    result differs from exact greedy NMS, and the port follows the bound."""
    boxes = torch.from_numpy(_chain())[None]
    bounded = nms_kernel.suppress_plain(boxes, 0.5, iterations=16)[0].numpy()
    settled = nms_kernel.suppress_plain(boxes, 0.5, iterations=64)[0].numpy()
    greedy = np.arange(40) % 2 == 0
    np.testing.assert_array_equal(settled, greedy)
    assert (bounded != greedy).any()


def test_boundary_semantics():
    keep = nms_kernel.suppress(torch.from_numpy(_boundary_and_classes())[None], 0.5)[0]
    assert keep.tolist() == [True, True, False, True, False, True, True, True]


def test_suppress_batches_images_independently():
    cases = [_sorted_problem(s) for s in (0, 1, 2)]
    batch = nms_kernel.suppress(torch.from_numpy(np.stack(cases)), 0.5)
    for i, boxes in enumerate(cases):
        single = nms_kernel.suppress(torch.from_numpy(boxes)[None], 0.5)[0]
        assert torch.equal(batch[i], single)


def _nms_problem():
    rng = np.random.default_rng(42)
    n = 200
    centres = rng.uniform(60, 580, (20, 2))
    cx = np.repeat(centres[:, 0], 10) + rng.normal(0, 8, n)
    cy = np.repeat(centres[:, 1], 10) + rng.normal(0, 8, n)
    w = rng.uniform(20, 60, n)
    h = rng.uniform(20, 60, n)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    scores = rng.uniform(0.05, 1.0, n)
    classes = rng.integers(0, 5, n)
    return boxes.astype(np.float32), scores.astype(np.float32), classes.astype(np.int32)


# "exact" is recorded with sequential greedy NMS; on this problem the 16-round
# bound has settled, so the port's fixed-round result must match it too.
@pytest.mark.parametrize("label,class_aware", [
    ("fixed_point", True), ("exact", True), ("class_agnostic", False)])
def test_nms_golden_through_port(label, class_aware):
    want = json.load(open(os.path.join(GOLDEN_DIR, "nms_kernels.json")))[label]
    boxes, scores, classes = (torch.from_numpy(a) for a in _nms_problem())
    det = nms_single(boxes, scores, classes, torch.ones(len(scores), dtype=torch.bool),
                     max_detections=64, iou_threshold=0.5, score_threshold=0.1,
                     class_aware=class_aware)
    v = det.valid.numpy()
    assert int(v.sum()) == want["n_kept"]
    assert det.classes.numpy()[v].tolist() == want["classes"]
    np.testing.assert_allclose(det.scores.numpy()[v], want["scores"], rtol=1e-4)
    np.testing.assert_allclose(det.boxes.numpy()[v], want["boxes"], rtol=1e-3, atol=0.5)


# -- K2 / K3: morphology tails --------------------------------------------------


def _xla_grow_clean(seeds, allow, iterations):
    def body(_, m):
        return jimops.binary_dilate(m, 1) & allow

    return _clean_mask(lax.fori_loop(0, iterations, body, seeds))


def _border_masks(r=64):
    """Regions touching the border, a hole touching the border ring's
    neighbour row, a hole open to the border, a closed interior hole."""
    m = np.zeros((4, r, r), bool)
    m[0, :20, :20] = True                 # corner block
    m[0, 1:5, 1:5] = False                # hole one pixel in from the border
    m[1, 10:50, 0:30] = True              # block on the left edge
    m[1, 20:30, 0:8] = False              # notch open to the border
    m[2, 8:56, 8:56] = True
    m[2, 24:40, 24:40] = False            # closed hole, filled
    m[3, :, 30:34] = True                 # bar spanning the ROI
    m[3, 0, :] = True                     # full top row
    return m


def _mask_cases():
    rng = np.random.default_rng(11)
    return {
        "random0": np.random.default_rng(0).random((4, 64, 64)) < 0.3,
        "random1": np.random.default_rng(1).random((4, 64, 64)) < 0.3,
        "random2": np.random.default_rng(2).random((4, 64, 64)) < 0.3,
        "border": _border_masks(),
        "dense128": rng.random((2, 128, 128)) < 0.6,
    }


@pytest.mark.parametrize("name", sorted(_mask_cases()))
def test_clean_plain_equals_pallas(name):
    masks = _mask_cases()[name]
    want = np.asarray(pallas_clean(jnp.asarray(masks), fill_iterations=16, interpret=True))
    got = morph_kernel.clean(torch.from_numpy(masks), 16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("iterations", [8, 24])
def test_grow_clean_plain_equals_pallas(seed, iterations):
    rng = np.random.default_rng(seed)
    seeds = rng.random((3, 64, 64)) < 0.01
    allow = rng.random((3, 64, 64)) < 0.7
    want = np.asarray(pallas_grow_clean(jnp.asarray(seeds), jnp.asarray(allow),
                                        grow_iterations=iterations, fill_iterations=16,
                                        interpret=True))
    got = morph_kernel.grow_clean(torch.from_numpy(seeds), torch.from_numpy(allow),
                                  iterations, 16).numpy()
    np.testing.assert_array_equal(got, want)


def test_grow_clean_border_rois_equal_xla():
    """Seeds and allowed regions that touch every edge of the ROI."""
    allow = _border_masks() | (np.random.default_rng(4).random((4, 64, 64)) < 0.5)
    seeds = np.zeros_like(allow)
    seeds[:, 0, 0] = seeds[:, -1, -1] = seeds[:, 0, -1] = seeds[:, 32, 0] = True
    want = np.asarray(_xla_grow_clean(jnp.asarray(seeds), jnp.asarray(allow), 24))
    got = morph_kernel.grow_clean(torch.from_numpy(seeds), torch.from_numpy(allow)).numpy()
    np.testing.assert_array_equal(got, want)


def test_grow_without_clean_respects_barrier():
    """fill_iterations=0 skips the cleanup; growth never crosses a forbidden line."""
    seeds = np.zeros((1, 64, 64), bool)
    seeds[0, 16, 16] = True
    allow = np.ones((1, 64, 64), bool)
    allow[0, :, 32] = False
    want = np.asarray(pallas_grow_clean(jnp.asarray(seeds), jnp.asarray(allow),
                                        grow_iterations=40, fill_iterations=0, interpret=True))
    got = morph_kernel.grow_clean(torch.from_numpy(seeds), torch.from_numpy(allow), 40, 0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 16, 20] and not got[0, :, 33:].any()


# -- wrappers -----------------------------------------------------------------------


def test_wrappers_take_no_other_device():
    """A tensor on neither the CPU nor a card is refused, never computed."""
    boxes = torch.zeros((1, 8, 4), device="meta")
    masks = torch.zeros((1, 64, 64), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        nms_kernel.suppress(boxes, 0.5)
    with pytest.raises(ValueError):
        morph_kernel.clean(masks)
    with pytest.raises(ValueError):
        morph_kernel.grow_clean(masks, masks)


def test_plain_path_counts_no_launch():
    before = (dict(nms_kernel.LAUNCHES), dict(morph_kernel.LAUNCHES))
    nms_kernel.suppress(torch.from_numpy(_sorted_problem(0))[None], 0.5)
    morph_kernel.clean(torch.from_numpy(_border_masks()))
    assert (nms_kernel.LAUNCHES, morph_kernel.LAUNCHES) == before
