"""The port's int8 networks against the JAX package: quantization, the int8
convolution, the counts, the calibration inputs and both streaming
forwards, on the same weights, codes and scales.

EXACT: the int8 trees and multipliers (``quantize_resnet``,
``yolo_int8_stream.quantize``, given the same scales), the int32
accumulators of the int8 convolution against ``lax.conv_general_dilated``
for every padding and shape class of the two networks (K = 27, K = 147 and
M = 16 included), the scale-slot counts, the rendered calibration frames and
crops (the port's bicubic resize against PIL's), and the commutation of
pooling, upsampling and slicing with quantization.

With tolerances (measured on these inputs):
- The streaming forwards, on carried-across trees and scales, against the
  JAX functions run op by op (each op rounded to its dtype, as a TPU
  computes): every int8 code of every YOLOv8n tensor EQUAL (measured: all
  52 tensors equal); logits within 1e-5 relative to their largest magnitude
  (measured: 1.3e-7 YOLOv8n at 128^2, 3.2e-7 ResNet); ResNet top-1 EQUAL.
- Under ``jax.jit`` XLA on the CPU keeps bfloat16 chains in float32 (excess
  precision), so the jitted JAX forward is not the op-by-op one: against it
  the YOLOv8n logits differ by up to 3.5% of their largest magnitude and the
  codes of deep tensors by up to 13 steps. That is a difference of XLA's CPU
  backend, not of the port; it is measured in ``test_yolo_stream_vs_jit``
  and not held to a tolerance beyond the detector's decisions
  (``test_torch_precision.py``).
- The port's own calibration (op by op) against JAX's (jitted): YOLOv8n
  scales within 2% relative (measured 1.65%; 47 of 52 slots equal against
  the op-by-op JAX calibration, the rest one or two bfloat16 steps of the
  absmax, from convolution sum order), ResNet scales within 1e-5 (measured
  1.2e-7).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from iqc_tpu.data.yolo_dataset import SyntheticDefectDataset as JaxDataset
from iqc_tpu.models import ensemble as jens
from iqc_tpu.models import resnet_int8 as jr8
from iqc_tpu.models import resnet_int8_stream as jrs
from iqc_tpu.models import yolo_int8 as jy8
from iqc_tpu.models import yolo_int8_stream as jys
from iqc_tpu.models.resnet import ResNet50 as JaxResNet
from iqc_tpu.models.yolo import YOLOv8 as JaxYOLO
from iqc_tpu_torch.config import resolve_path
from iqc_tpu_torch.data.resize import resize_bicubic
from iqc_tpu_torch.data.yolo_dataset import SyntheticDefectDataset
from iqc_tpu_torch.models import ensemble as tens
from iqc_tpu_torch.models import int8_conv
from iqc_tpu_torch.models import resnet_int8 as tr8
from iqc_tpu_torch.models import resnet_int8_stream as trs
from iqc_tpu_torch.models import yolo_int8 as ty8
from iqc_tpu_torch.models import yolo_int8_stream as tys
from iqc_tpu_torch.weights import read_checkpoint

torch.set_num_threads(2)

STAGES = (1, 1, 1, 1)
LOGIT_REL = 1e-5
YOLO_SCALE_REL = 2e-2
RESNET_SCALE_REL = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_host(want))
    assert len(gl) == len(wl) and len(gl) > 0
    for g, w in zip(gl, wl):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _resnet_vars(seed=0):
    """ResNet-50 (1,1,1,1) from Flax's init with perturbed BatchNorm
    statistics and scales."""
    module = JaxResNet(num_classes=5, stage_sizes=STAGES)
    v = _host(jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(seed + 1)
    noisy = lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    flat = jax.tree_util.tree_map_with_path(
        lambda p, a: (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if p[-1].key == "scale" else a, v["params"])
    return {"params": flat, "batch_stats": jax.tree_util.tree_map(noisy, v["batch_stats"])}


@pytest.fixture(scope="module")
def yolo_ckpt():
    return read_checkpoint(resolve_path("models/yolov8n_qc_synthetic.msgpack"))


def _yolo_tiny():
    module = JaxYOLO(num_classes=5, width_mult=0.125, depth_mult=0.334)
    return _host(jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


# -- quantized trees -------------------------------------------------------------


@pytest.mark.parametrize("weights", ["tiny", "checkpoint"])
def test_quantize_resnet_equals_jax(weights):
    if weights == "tiny":
        v, stages = _resnet_vars(), STAGES
    else:
        v, stages = read_checkpoint(resolve_path("models/resnet50_qc_128.msgpack")), (3, 4, 6, 3)
    got = tr8.quantize_resnet(v, stages)
    _assert_trees_equal(got, jr8.quantize_resnet(v, stages))
    assert tr8.tree_size_bytes(got) == jr8.tree_size_bytes(jr8.quantize_resnet(v, stages))


@pytest.mark.parametrize("weights", ["tiny", "checkpoint"])
def test_yolo_stream_quantize_equals_jax(weights, yolo_ckpt):
    v = _yolo_tiny() if weights == "tiny" else yolo_ckpt
    scales = np.random.default_rng(4).uniform(0.002, 0.08, tys.n_tensors()).astype(np.float32)
    got = tys.quantize(v, scales)
    want = jys.quantize(v, jnp.asarray(scales))
    _assert_trees_equal(got, want)
    assert tr8.tree_size_bytes(got) == jys.tree_size_bytes(want)
    _assert_trees_equal(tys.fold_fp(v), jys.fold_fp(v))
    with pytest.raises(ValueError, match="slots"):
        tys.quantize(v, scales[:-1])


@pytest.mark.parametrize("depth,stem", [(0.334, "conv"), (0.334, "s2d"), (0.67, "conv"),
                                        (1.0, "conv"), (4.0, "s2d")])
def test_counts_equal(depth, stem):
    assert ty8.n_convs(depth, stem) == jy8.n_convs(depth, stem)
    assert tys.n_tensors(depth, stem) == jys.n_tensors(depth, stem)
    for stages in ((3, 4, 6, 3), STAGES, (2, 2, 2, 2)):
        assert tr8.n_convs(stages) == jr8.n_convs(stages)


# -- the int8 convolution ------------------------------------------------------------

# (label, NHWC input, HWIO kernel, stride, padding)
CONV_CASES = [
    ("yolo_stem_k27", (2, 32, 32, 3), (3, 3, 3, 16), 2, [(1, 1), (1, 1)]),
    ("resnet_stem_k147", (2, 32, 32, 3), (7, 7, 3, 64), 2, [(3, 3), (3, 3)]),
    ("global_stage4_m16_1x1", (1, 4, 4, 128), (1, 1, 128, 64), 1, "SAME"),
    ("global_stage4_m16_3x3", (1, 4, 4, 64), (3, 3, 64, 64), 1, "SAME"),
    ("same_s2_even_asymmetric", (2, 16, 16, 8), (3, 3, 8, 24), 2, "SAME"),
    ("same_s2_odd", (1, 9, 9, 8), (3, 3, 8, 8), 2, "SAME"),
    ("same_s2_1x1", (2, 16, 16, 16), (1, 1, 16, 32), 2, "SAME"),
    ("same_s1_3x3", (1, 9, 9, 24), (3, 3, 24, 8), 1, "SAME"),
    ("yolo_k2_s1", (1, 10, 10, 40), (3, 3, 40, 40), 1, [(1, 1), (1, 1)]),
    ("yolo_k2_s2", (2, 12, 12, 32), (3, 3, 32, 64), 2, [(1, 1), (1, 1)]),
    ("yolo_1x1_concat", (1, 8, 8, 48), (1, 1, 48, 32), 1, [(0, 0), (0, 0)]),
    ("n_unaligned", (2, 8, 8, 16), (1, 1, 16, 5), 1, "SAME"),
    ("k_unaligned", (2, 8, 8, 12), (1, 1, 12, 16), 1, "SAME"),
    ("m4_s2", (1, 4, 4, 8), (3, 3, 8, 8), 2, "SAME"),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_equals_lax(case):
    _, xs, ws, stride, padding = case
    rng = np.random.default_rng(len(xs) * 31 + ws[-1])
    x = rng.integers(-127, 128, xs).astype(np.int8)
    w = rng.integers(-127, 128, ws).astype(np.int8)
    x[0, 0, 0, :] = 127  # extremes of the code range
    w[..., 0] = -127
    dn = lax.conv_dimension_numbers(xs, ws, ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), padding, dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    weight = int8_conv.prepare_weight(torch.from_numpy(w))
    assert weight.mat.shape[0] % 8 == 0 and weight.mat.shape[1] % 8 == 0
    got = int8_conv.conv_int8(torch.from_numpy(x), weight, stride, padding)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_mm_limits():
    """The limits of torch._int_mm on CUDA are checked before the call; the
    wrapper pads M, prepare_weight pads K and N."""
    for m, k, n in ((16, 8, 8), (17, 27, 8), (17, 8, 5), (17, 0, 8)):
        with pytest.raises(ValueError):
            int8_conv.check_int_mm(m, k, n)
    int8_conv.check_int_mm(17, 152, 64)
    a = torch.randint(-127, 128, (3, 16), dtype=torch.int8)
    bt = torch.randint(-127, 128, (8, 16), dtype=torch.int8)
    np.testing.assert_array_equal(int8_conv.int_mm(a, bt).numpy(),
                                  a.int().numpy() @ bt.int().numpy().T)
    with pytest.raises(TypeError):
        int8_conv.conv_int8(torch.zeros((1, 4, 4, 8)),
                            int8_conv.prepare_weight(torch.zeros((1, 1, 8, 8), dtype=torch.int8)))


# -- calibration inputs --------------------------------------------------------------


def test_renderer_equals_jax():
    for seed, size in ((123, 320), (321, 320), (0, 96)):
        want, got = JaxDataset(6, size, 8, seed=seed), SyntheticDefectDataset(6, size, 8, seed=seed)
        for i in range(6):
            for a, b in zip(got.load(i), want.load(i)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_calibration_frames_and_crops_byte_equal_pil():
    """The calibration batches of both predictors (the port's bicubic resize,
    the JAX package's PIL): 8 frames 320 -> 640 and 24 crop patches -> 128."""
    stub = types.SimpleNamespace(input_size=(640, 640))
    want = np.asarray(next(jens.EnsemblePredictor._yolo_calibration_batches(stub)))
    got = next(tens.EnsemblePredictor._yolo_calibration_batches(stub))
    assert got.shape == (8, 640, 640, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    want = np.asarray(next(jens.EnsemblePredictor._calibration_batches(None, 128)))
    got = next(tens.EnsemblePredictor._calibration_batches(None, 128))
    assert got.shape == (24, 128, 128, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((320, 320), (640, 640)), ((57, 91), (128, 128)),
                                     ((300, 41), (128, 128)), ((128, 128), (128, 128)),
                                     ((40, 40), (13, 200)), ((5, 700), (64, 64))])
def test_resize_equals_pil(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    img = np.clip(rng.normal(128, 70, (*src, 3)), 0, 255).astype(np.uint8)
    for a in (img, img[..., 0]):
        want = np.asarray(Image.fromarray(a).resize(dst))
        np.testing.assert_array_equal(resize_bicubic(a, dst), want)


# -- quantization commutes with pooling, upsampling and slicing ------------------------------


def test_pool_upsample_slice_commute_with_quantization():
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(0, 2, (2, 9, 10, 12)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.tensor(0.031, dtype=torch.float32)
    q = lambda v: tr8.quantize_codes(v, scale)
    for op in (lambda v: tys._qpool5((v, [(0, 12)]))[0],
               lambda v: tys._qup2((v, [(0, 12)]))[0],
               lambda v: tys._qslice((v, [(0, 5), (1, 7)]), 3, 9)[0],
               tr8.nn_max_pool):
        got, want = op(q(vals)), q(op(vals))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tys._qslice((None, [(0, 5), (1, 7)]), 3, 9)[1] == [(0, 2), (1, 4)]


# -- the streaming forwards ----------------------------------------------------------


def _record_codes(monkeypatch, module, sink):
    emit = module._emit

    def recording(ctx, y, channels):
        out = emit(ctx, y, channels)
        sink.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(module, "_emit", recording)


@pytest.fixture(scope="module")
def yolo_stream(yolo_ckpt):
    """JAX's scales from its calibration on one seeded 128^2 batch, the JAX
    int8 tree, and the same tree on the port's CPU device."""
    cal = np.random.default_rng(0).random((4, 128, 128, 3), dtype=np.float32)
    scales = np.array(jys.calibrate(jys.fold_fp(yolo_ckpt), [jnp.asarray(cal)]))
    q = jys.quantize(yolo_ckpt, jnp.asarray(scales))
    return cal, scales, q, tys.device_tree(_host(q), "cpu")


def test_yolo_stream_forward_equals_jax_op_by_op(yolo_stream, monkeypatch):
    _, scales, q, qd = yolo_stream
    x = np.random.default_rng(1).random((1, 128, 128, 3), dtype=np.float32)
    want_codes, got_codes = [], []
    _record_codes(monkeypatch, jys, want_codes)
    _record_codes(monkeypatch, tys, got_codes)
    want_d, want_c = jys.apply(q, jnp.asarray(x), jnp.asarray(scales))
    with torch.inference_mode():
        got_d, got_c = tys.apply(qd, torch.from_numpy(x), torch.from_numpy(scales))
    assert len(got_codes) == len(want_codes) == tys.n_tensors() - 1
    for i, (g, w) in enumerate(zip(got_codes, want_codes)):
        assert g.dtype == np.int8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w, err_msg=f"tensor {i + 1}")
    for g, w in ((got_d, want_d), (got_c, want_c)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LOGIT_REL * np.abs(w).max())


def test_yolo_stream_vs_jit(yolo_stream):
    """The jitted JAX forward (what the JAX detector runs on the CPU)
    differs from the op-by-op one by XLA's excess precision; the port's
    differs from it by the same amount. Recorded, held only to sanity: the
    same shapes and finite logits within 10% of their largest magnitude."""
    _, scales, q, qd = yolo_stream
    x = np.random.default_rng(1).random((1, 128, 128, 3), dtype=np.float32)
    want_d, want_c = jax.jit(lambda qq, xx, s: jys.apply(qq, xx, s))(
        q, jnp.asarray(x), jnp.asarray(scales))
    with torch.inference_mode():
        got_d, got_c = tys.apply(qd, torch.from_numpy(x), torch.from_numpy(scales))
    for g, w in ((got_d, want_d), (got_c, want_c)):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=0.1 * np.abs(w).max())


def test_yolo_calibration_close_to_jax(yolo_stream, yolo_ckpt):
    cal, scales, _, _ = yolo_stream
    fp = tys.device_tree(tys.fold_fp(yolo_ckpt), "cpu")
    got = tys.calibrate(fp, [torch.from_numpy(cal)]).numpy()
    assert got.shape == scales.shape == (tys.n_tensors(),) and got.dtype == np.float32
    np.testing.assert_allclose(got, scales, rtol=YOLO_SCALE_REL)


@pytest.mark.parametrize("walk", ["v1", "stream"])
def test_resnet_forward_equals_jax(walk):
    v = _resnet_vars()
    q = jr8.quantize_resnet(v, STAGES)
    cal = np.random.default_rng(9).standard_normal((8, 64, 64, 3)).astype(np.float32)
    scales = np.array(jr8.calibrate_activation_scales(q, [jnp.asarray(cal)], STAGES))
    qd = tr8.device_tree(tr8.quantize_resnet(v, STAGES), "cpu")
    got_scales = tr8.calibrate_activation_scales(qd, [torch.from_numpy(cal)], STAGES).numpy()
    np.testing.assert_allclose(got_scales, scales, rtol=RESNET_SCALE_REL)

    x = np.random.default_rng(2).standard_normal((8, 64, 64, 3)).astype(np.float32)
    s = torch.from_numpy(scales)
    with torch.inference_mode():
        if walk == "v1":
            want = jr8.apply(q, jnp.asarray(x), STAGES, act_scales=jnp.asarray(scales))
            got = tr8.apply(qd, torch.from_numpy(x), STAGES, act_scales=s)
        else:
            want = jrs.apply(q, jnp.asarray(x), jnp.asarray(scales), STAGES)
            got = trs.apply(qd, torch.from_numpy(x), s, STAGES)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    with pytest.raises(ValueError):
        trs.apply(qd, torch.from_numpy(x), None, STAGES)


@pytest.mark.parametrize("net", ["yolo", "resnet"])
def test_to_flax_inverts_load_into(net, yolo_ckpt):
    """The predictor quantizes ``to_flax`` of its loaded float module: the
    checkpoint's tree, leaf for leaf, and the bytes the size report counts."""
    from iqc_tpu_torch.models.resnet import ResNet50
    from iqc_tpu_torch.models.yolo import YOLOv8
    from iqc_tpu_torch.weights import load_into, to_flax

    if net == "yolo":
        v, module = yolo_ckpt, YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334)
    else:
        v, module = read_checkpoint(resolve_path("models/resnet50_qc_128.msgpack")), ResNet50()
    load_into(module, v)
    _assert_trees_equal(to_flax(module), v)
    assert tr8.tree_size_bytes(to_flax(module)) == jens._tree_bytes(v)
