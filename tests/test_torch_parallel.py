"""The port's mesh (``iqc_tpu_torch/parallel/mesh.py``) on the CPU: a single
process, and four gloo ranks (``torch_parallel_ranks.launch``, one spawned
process per rank, a deadline per launch).

Checked exactly: the mesh's sizes with every rank, with model_parallel=2
and with a mesh that asks for more or fewer ranks than the group has
(refused); ``shard_batch``'s rows and the zero padding of a ragged batch;
``replicate`` (rank 0's values); ``cross_replica_mean``; the row gather.

Global statistics: a batch whose halves differ (four flat images, four
textured ones) goes through a train-mode BatchNorm, two images a rank.
The ranks' outputs, running statistics and gradients are the single-device
BatchNorm's on the whole batch, not those of any rank's own rows: outputs
and statistics within 1e-6 (four partial sums added in another order);
the input gradients within 1e-6 (measured 7.2e-7); the scale's and bias's
gradients within 1e-4 (measured 3.8e-5): each sums 200 products of up to
~4 in magnitude that cancel to ~1e-2, so float32 rounding in two orders
of summation differs at that size. The YOLO loss's
normaliser is global too: the ranks' shares sum to the single-device loss
(within 1e-6 relative), and a rank's share is not its rows' own loss.
"""

import numpy as np
import pytest
import torch

from iqc_tpu.config import MeshConfig as JaxMeshConfig
from iqc_tpu_torch.config import MeshConfig
from iqc_tpu_torch.models.layers import BatchNorm
from iqc_tpu_torch.parallel import mesh as pm
from iqc_tpu_torch.train.yolo_loss import yolo_loss

import torch_parallel_ranks as ranks

torch.set_num_threads(2)

WORLD = 4


def _bn_batch():
    rng = np.random.default_rng(0)
    x = np.empty((8, 6, 5, 5), np.float32)
    x[:4] = 0.7 + rng.normal(0, 1e-3, (4, 6, 1, 1)).astype(np.float32)  # flat
    x[4:] = rng.normal(0.2, 1.5, (4, 6, 5, 5)).astype(np.float32)        # textured
    return x


def _loss_inputs():
    """Random head outputs and ground truths of 8 images at 64^2 (reg_max
    8); the foreground is uneven: images 0-1 hold no box."""
    from iqc_tpu_torch.models.yolo import STRIDES, feature_shapes
    from iqc_tpu_torch.ops.nms import make_anchors

    anchors, strides = make_anchors(feature_shapes((64, 64)), STRIDES)
    a = anchors.shape[0]
    rng = np.random.default_rng(1)
    dist = rng.normal(0, 1, (8, a, 32)).astype(np.float32)
    cls = rng.normal(-2, 1, (8, a, 5)).astype(np.float32)
    xy = rng.uniform(4, 40, (8, 3, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(8, 20, (8, 3, 2)).astype(np.float32)], -1)
    classes = rng.integers(0, 5, (8, 3)).astype(np.int64)
    valid = np.ones((8, 3), bool)
    valid[:2] = False
    valid[5, 2] = False
    return dist, cls, anchors.numpy(), strides.numpy(), boxes, classes, valid, 8


@pytest.fixture(scope="module")
def four_ranks():
    return ranks.launch(ranks.mesh_helpers, WORLD, _bn_batch(), _loss_inputs(), timeout_s=120)


def test_single_process_is_a_mesh_of_one():
    """No launcher: every rank is this process; a mesh of two asks for more
    ranks than the group has; a JAX MeshConfig or a dict is read as well."""
    for cfg in (None, MeshConfig(), JaxMeshConfig(), {"data_parallel": -1}):
        spec = pm.create_mesh(cfg)
        assert (spec.size, spec.data_size, spec.model_size, spec.data_index) == (1, 1, 1, 0)
        assert not spec.distributed and spec.is_main
    for cfg in (MeshConfig(data_parallel=2), {"model_parallel": 2}):
        with pytest.raises(ValueError):
            pm.create_mesh(cfg)
    spec = pm.create_mesh()
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(pm.shard_batch(spec, x).numpy(), x)
    t = torch.ones(2)
    assert pm.all_reduce_sum(spec, t) is t and pm.all_gather_rows(spec, t) is t
    np.testing.assert_array_equal(pm.cross_replica_mean(spec, t).numpy(), t.numpy())
    assert pm.distributed_init("cpu") == torch.device("cpu")  # no launcher: a no-op


def test_mesh_sizes(four_ranks):
    for r, out in enumerate(four_ranks):
        assert out["every_rank"] == (4, 1, r, 0)
        assert out["model_parallel_2"] == (2, 2, r // 2, r % 2)
        # the data axis of model index m holds ranks m and m + 2
        assert out["model_parallel_2_mean"] == (r % 2) + 1.0
        assert "more ranks than the group has" in out["too_large"]
        assert "without work" in out["too_small"]
        assert "not divisible by model_parallel=3" in out["model_not_dividing"]


def test_shard_batch_rows_and_padding(four_ranks):
    even = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    x = np.arange(10 * 2, dtype=np.int32).reshape(10, 2)
    padded = np.concatenate([x, np.zeros((2, 2), np.int32)])
    for r, out in enumerate(four_ranks):
        np.testing.assert_array_equal(out["shard_even"], even[2 * r:2 * r + 2])
        assert out["rows_of_10"] == slice(3 * r, 3 * r + 3)
        np.testing.assert_array_equal(out["shard_ragged"]["x"], padded[3 * r:3 * r + 3])
        want_m = [True] * 3 if r < 3 else [True, False, False]
        assert out["shard_ragged"]["m"].tolist() == want_m
    assert sum(int(o["shard_ragged"]["m"].sum()) for o in four_ranks) == 10


def test_replicate_and_cross_replica_mean(four_ranks):
    for r, out in enumerate(four_ranks):
        np.testing.assert_array_equal(out["replicate"]["w"], np.ones((2, 2), np.float32))
        np.testing.assert_array_equal(out["replicate"]["b"], np.zeros(3, np.int64))
        np.testing.assert_array_equal(out["mean"][0], np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(out["mean"][1], np.arange(4.0, dtype=np.float32) * 1.5)
        np.testing.assert_array_equal(out["gather"], np.repeat(np.arange(4), 2).reshape(4, 2))


def _bn_single(x_np, rows=slice(None)):
    bn = BatchNorm(x_np.shape[1], eps=1e-3).train()
    x = torch.from_numpy(x_np[rows]).requires_grad_(True)
    y = bn(x)
    w = torch.linspace(-1.0, 1.0, y[0].numel()).reshape(y.shape[1:])
    (y * w).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def test_batchnorm_statistics_are_global(four_ranks):
    """Flat and textured halves on different ranks give the whole batch's
    statistics and gradients, not any rank's own."""
    x = _bn_batch()
    want = _bn_single(x)
    for r, out in enumerate(four_ranks):
        got = out["bn"]
        rows = slice(2 * r, 2 * r + 2)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        for k in ("dweight", "dbias"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["y"], want["y"][rows], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["dx"], want["dx"][rows], rtol=0, atol=1e-6)
        own = _bn_single(x, rows)
        assert np.abs(own["running_var"] - got["running_var"]).max() > 1e-3
    # every rank holds the same statistics, to the bit
    for out in four_ranks[1:]:
        for k in ("running_mean", "running_var", "dweight", "dbias"):
            np.testing.assert_array_equal(out["bn"][k], four_ranks[0]["bn"][k])


def test_loss_normaliser_is_global(four_ranks):
    inputs = _loss_inputs()
    dist, cls, anchors, strides, boxes, classes, valid, reg_max = inputs
    t = torch.from_numpy
    total, parts = yolo_loss(t(dist), t(cls), t(anchors), t(strides), t(boxes), t(classes),
                             t(valid), reg_max)
    shares = [o["loss_share"] for o in four_ranks]
    np.testing.assert_allclose(sum(shares), float(total), rtol=1e-6)
    for k in ("box_loss", "cls_loss", "dfl_loss", "num_fg"):
        np.testing.assert_allclose(sum(o["loss_parts"][k] for o in four_ranks), float(parts[k]),
                                   rtol=1e-6, err_msg=k)
    # a rank's own normaliser would give another loss
    assert all(abs(o["loss_local"] - o["loss_share"]) > 1e-3 * abs(o["loss_local"])
               for o in four_ranks)


def test_batch_packing_matches_the_jax_package():
    """``steps.pack_batch_host`` writes the JAX package's bytes, and
    ``unpack_batch_device`` returns every array (bool included) exactly,
    from an unaligned offset too."""
    from iqc_tpu.train import steps as jsteps
    from iqc_tpu_torch.train import steps

    rng = np.random.default_rng(2)
    arrays = [rng.integers(0, 255, (3, 5, 5, 3), dtype=np.uint8),
              rng.normal(0, 1, (3, 4, 4)).astype(np.float32),
              rng.integers(0, 5, (3, 4)).astype(np.int32), rng.random((3, 4)) < 0.5]
    buf = steps.pack_batch_host(arrays)
    np.testing.assert_array_equal(buf, jsteps.pack_batch_host(arrays))
    specs = steps.batch_specs(arrays)
    assert specs == jsteps.batch_specs(arrays)
    for got, want in zip(steps.unpack_batch_device(torch.from_numpy(buf), specs), arrays):
        assert got.dtype == (torch.bool if want.dtype == bool else torch.from_numpy(want).dtype)
        np.testing.assert_array_equal(got.numpy(), want)
