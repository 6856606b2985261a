"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. This file imports neither JAX nor the JAX
package, so that it runs on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerance: keep masks and morphology masks are booleans and must be EQUAL.
"""

import numpy as np
import pytest
import torch

from iqc_tpu_torch.ops import morph_kernel, nms_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _boxes(batch, k, seed):
    """Score-sorted boxes with a 40-deep overlap chain, ties at IoU 0.5 and
    zero-area pads, offset per class by 1e5."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(20, 620, (batch, k)), rng.uniform(20, 620, (batch, k))
    w, h = rng.uniform(8, 90, (batch, k)), rng.uniform(8, 90, (batch, k))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    x = np.arange(40) * 2.0
    boxes[:, :40] = np.stack([x, np.zeros(40), x + 10, np.full(40, 10.0)], -1)
    boxes[:, 40:42] = [[0, 300, 10, 310], [0, 300, 10, 305]]
    boxes[:, -4:] = 0.0
    cls = rng.integers(0, 5, (batch, k))
    cls[:, :42] = 0
    return torch.tensor(boxes + cls[..., None] * 1e5, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k", [(8, 300), (1, 300), (3, 64), (2, 512)])
def test_suppress_kernel_equals_plain(cuda, batch, k):
    boxes = _boxes(batch, k, seed=k)
    before = nms_kernel.LAUNCHES["suppress"]
    got = nms_kernel.suppress(boxes.to(cuda), 0.5)
    assert nms_kernel.LAUNCHES["suppress"] == before + 1
    assert torch.equal(got.cpu(), nms_kernel.suppress_plain(boxes, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(65, 128), (17, 128), (4, 64), (2, 256)])
def test_morph_kernels_equal_plain(cuda, n, r):
    rng = np.random.default_rng(n)
    masks = torch.from_numpy(rng.random((n, r, r)) < 0.5)
    masks[0] = True  # the all-ones ROI of the watershed method
    seeds = torch.from_numpy(rng.random((n, r, r)) < 0.01)
    allow = torch.from_numpy(rng.random((n, r, r)) < 0.7)
    assert torch.equal(morph_kernel.clean(masks.to(cuda)).cpu(), morph_kernel.clean_plain(masks))
    for fill in (16, 0):
        got = morph_kernel.grow_clean(seeds.to(cuda), allow.to(cuda), 24, fill).cpu()
        assert torch.equal(got, morph_kernel.grow_clean_plain(seeds, allow, 24, fill))
