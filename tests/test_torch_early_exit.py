"""The early exits of the port's kernels, and the wrappers' input preparation.

The CUDA kernels stop NMS suppression, geodesic growth and the hole fill at
the first round that changes nothing. That is exact because a round that
changes nothing has reached a fixed point, which every later round keeps.
Here, on the CPU, that property is checked on the plain versions: stopped at
the first such round, they equal their full round counts. The full counts
are also checked against the JAX package's Pallas kernels, run in interpret
mode. The same checks run on the card in tests/test_torch_cuda.py.

Tolerance: keep masks and morphology masks are booleans and must be EQUAL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqc_tpu.ops.pallas_morph import pallas_grow_clean
from iqc_tpu.ops.pallas_nms import pallas_suppression
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops import morph_kernel, nms_kernel

torch.set_num_threads(2)


def _first_fixed_round(rounds, limit):
    """The first n <= limit at which rounds(n) equals rounds(n - 1), else None."""
    prev = rounds(0)
    for n in range(1, limit + 1):
        cur = rounds(n)
        if torch.equal(cur, prev):
            return n
        prev = cur
    return None


def _boxes(case, k=64, seed=0):
    rng = np.random.default_rng(seed)
    if case == "random":
        c = rng.uniform(20, 180, (k, 2))
        wh = rng.uniform(5, 60, (k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    elif case == "pairs":  # disjoint pairs of equal boxes
        i = np.arange(k) // 2
        x, y = (i % 8) * 30.0, (i // 8) * 30.0
        boxes = np.stack([x, y, x + 20, y + 20], -1)
    elif case == "staircase":  # a chain of 5, which settles after 5 rounds
        x = np.arange(5) * 2.0
        boxes = np.stack([x, np.zeros(5), x + 10, np.full(5, 10.0)], -1)
    else:  # chain: 40 boxes, each overlapping the next, never settled in 16 rounds
        x = np.arange(40) * 2.0
        boxes = np.stack([x, np.zeros(40), x + 10, np.full(40, 10.0)], -1)
    return boxes.astype(np.float32)


@pytest.mark.parametrize("case,settles", [("random", None), ("pairs", 2), ("staircase", 5),
                                          ("chain", None)])
def test_suppress_stopped_at_a_fixed_point_equals_all_rounds(case, settles):
    boxes = torch.from_numpy(_boxes(case))[None]
    n = _first_fixed_round(lambda it: nms_kernel.suppress_plain(boxes, 0.5, it), 16)
    if case == "chain":
        assert n is None  # every one of the 16 rounds changes the keep mask
        return
    assert n is not None and (settles is None or n == settles)
    full = nms_kernel.suppress_plain(boxes, 0.5, 16)
    assert torch.equal(nms_kernel.suppress_plain(boxes, 0.5, n), full)
    assert torch.equal(nms_kernel.suppress_plain(boxes, 0.5, 40), full)
    want = np.asarray(pallas_suppression(jnp.asarray(boxes[0].numpy()), jnp.float32(0.5),
                                         interpret=True)) > 0.5
    assert np.array_equal(full[0].numpy(), want)


def _rois(r=32):
    """ROI 0: one seed in a 9 x 9 allowed square (growth stops after 8
    rounds); ROI 1: all ones; ROI 2: a random field of seeds."""
    rng = np.random.default_rng(5)
    seeds = np.zeros((3, r, r), bool)
    allow = np.zeros((3, r, r), bool)
    c = r // 2
    allow[0, c - 4:c + 5, c - 4:c + 5] = True
    seeds[0, c, c] = True
    seeds[1] = allow[1] = True
    seeds[2] = rng.random((r, r)) < 0.02
    allow[2] = rng.random((r, r)) < 0.8
    return torch.from_numpy(seeds), torch.from_numpy(allow)


@pytest.mark.parametrize("roi,settles", [(0, 9), (1, 1), (2, None)])
def test_growth_stopped_at_a_fixed_point_equals_all_rounds(roi, settles):
    seeds, allow = (x[roi:roi + 1] for x in _rois())
    n = _first_fixed_round(lambda it: morph_kernel.grow_clean_plain(seeds, allow, it, 0), 24)
    assert n is not None and (settles is None or n == settles)
    for fill in (0, 16):
        full = morph_kernel.grow_clean_plain(seeds, allow, 24, fill)
        assert torch.equal(morph_kernel.grow_clean_plain(seeds, allow, n, fill), full)
    want = np.asarray(pallas_grow_clean(jnp.asarray(seeds.numpy()), jnp.asarray(allow.numpy()),
                                        24, 16, interpret=True))
    assert np.array_equal(full.numpy(), want)


@pytest.mark.parametrize("case", ["ring", "full", "random"])
def test_hole_fill_stopped_at_a_fixed_point_equals_all_rounds(case):
    r = 32
    m = torch.zeros((1, r, r), dtype=torch.bool)
    if case == "ring":  # a closed ring around a hole, in a small ROI the flood crosses
        m[0, 8:24, 8:24] = True
        m[0, 11:21, 11:21] = False
    elif case == "full":
        m[:] = True
    else:
        m = torch.from_numpy(np.random.default_rng(2).random((1, r, r)) < 0.3)
    n = _first_fixed_round(lambda it: imops.fill_holes(m, it), 40)
    assert n is not None
    assert torch.equal(imops.fill_holes(m, n), imops.fill_holes(m, 40))


@pytest.mark.parametrize("case", ["bool", "uint8", "strided", "unaligned"])
def test_morph_inputs_are_prepared_as_the_kernel_reads_them(case):
    """Bool, contiguous and 16-byte aligned; a mask that already is passes
    through as it is."""
    rng = np.random.default_rng(1)
    m = torch.from_numpy(rng.random((3, 32, 32)) < 0.5)
    if case == "uint8":
        x = m.to(torch.uint8) * 3
    elif case == "strided":
        x = m.transpose(1, 2)
    elif case == "unaligned":
        flat = torch.zeros(1 + m.numel(), dtype=torch.bool)
        flat[1:] = m.flatten()
        x = flat[1:].view(m.shape)
        assert x.data_ptr() % 16
    else:
        x = m
    got = morph_kernel._prepared(x)
    assert got.dtype == torch.bool and got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, x.bool())
    if case == "bool":
        assert got is x
