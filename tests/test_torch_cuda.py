"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. This file imports neither JAX nor the JAX
package, so that it runs on a machine without them:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerance: keep masks and morphology masks are booleans and must be EQUAL;
the int8 convolution's int32 accumulators on the card EQUAL the CPU's.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from iqc_tpu_torch import build
from iqc_tpu_torch.models import int8_conv
from iqc_tpu_torch.ops import morph_kernel, nms_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _boxes(batch, k, seed):
    """Score-sorted boxes offset per class by 1e5; where K allows, a 40-deep
    overlap chain (which never settles in 16 rounds), ties at IoU 0.5 and
    zero-area pads."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(20, 620, (batch, k)), rng.uniform(20, 620, (batch, k))
    w, h = rng.uniform(8, 90, (batch, k)), rng.uniform(8, 90, (batch, k))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    cls = rng.integers(0, 5, (batch, k))
    if k >= 46:
        x = np.arange(40) * 2.0
        boxes[:, :40] = np.stack([x, np.zeros(40), x + 10, np.full(40, 10.0)], -1)
        boxes[:, 40:42] = [[0, 300, 10, 310], [0, 300, 10, 305]]
        boxes[:, -4:] = 0.0
        cls[:, :42] = 0
    return torch.tensor(boxes + cls[..., None] * 1e5, dtype=torch.float32)


def _pairs(batch, k):
    """Disjoint pairs of equal boxes: the keep mask settles in 2 rounds."""
    i = np.arange(k) // 2
    x, y = (i % 20) * 30.0, (i // 20) * 30.0
    boxes = np.stack([x, y, x + 20, y + 20], -1)
    return torch.tensor(np.broadcast_to(boxes, (batch, k, 4)).copy(), dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k", [(8, 300), (1, 300), (3, 64), (2, 512), (1, 20), (3, 20),
                                     (8, 20), (3, 300), (1, 512), (8, 512), (3, 33)])
def test_suppress_kernel_equals_plain(cuda, batch, k):
    boxes = _boxes(batch, k, seed=k)
    before = nms_kernel.LAUNCHES["suppress"]
    got = nms_kernel.suppress(boxes.to(cuda), 0.5)
    assert nms_kernel.LAUNCHES["suppress"] == before + 1
    assert torch.equal(got.cpu(), nms_kernel.suppress_plain(boxes, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pairs", "chain"])
@pytest.mark.parametrize("iterations", [0, 1, 2, 3, 16, 40])
def test_suppress_kernel_early_exit_equals_plain(cuda, case, iterations):
    """Settling in 2 rounds ends the rounds early; the 40-deep chain runs
    every round up to `iterations`, also beyond 16."""
    boxes = _pairs(3, 300) if case == "pairs" else _boxes(3, 300, seed=1)
    got = nms_kernel.suppress(boxes.to(cuda), 0.5, iterations)
    assert torch.equal(got.cpu(), nms_kernel.suppress_plain(boxes, 0.5, iterations))


def _masks(n, r, seed):
    rng = np.random.default_rng(seed)
    masks = torch.from_numpy(rng.random((n, r, r)) < 0.5)
    masks[0] = True  # the all-ones ROI of the watershed method
    seeds = torch.from_numpy(rng.random((n, r, r)) < 0.01)
    allow = torch.from_numpy(rng.random((n, r, r)) < 0.7)
    return masks, seeds, allow


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(65, 128), (17, 128), (4, 64), (2, 256)]
                         + [(n, r) for r in (32, 128, 256) for n in (1, 16, 17, 64, 65)
                            if (n, r) not in ((65, 128), (17, 128))])
def test_morph_kernels_equal_plain(cuda, n, r):
    masks, seeds, allow = _masks(n, r, seed=n)
    assert torch.equal(morph_kernel.clean(masks.to(cuda)).cpu(), morph_kernel.clean_plain(masks))
    for fill in (16, 0):
        got = morph_kernel.grow_clean(seeds.to(cuda), allow.to(cuda), 24, fill).cpu()
        assert torch.equal(got, morph_kernel.grow_clean_plain(seeds, allow, 24, fill))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [32, 128, 256])
@pytest.mark.parametrize("grow,fill", [(24, 16), (3, 2), (40, 40), (0, 16), (24, 0)])
def test_morph_kernels_early_exit_equal_plain(cuda, r, grow, fill):
    """ROI 0 grows from one seed inside a 9 x 9 square and stops after 8
    rounds; ROI 1 is all ones, so no round changes it; ROI 2 is empty."""
    seeds = torch.zeros((3, r, r), dtype=torch.bool)
    allow = torch.zeros_like(seeds)
    c = r // 2
    allow[0, c - 4:c + 5, c - 4:c + 5] = True
    seeds[0, c, c] = True
    seeds[1] = allow[1] = True
    got = morph_kernel.grow_clean(seeds.to(cuda), allow.to(cuda), grow, fill).cpu()
    assert torch.equal(got, morph_kernel.grow_clean_plain(seeds, allow, grow, fill))
    got = morph_kernel.clean(allow.to(cuda), fill).cpu()
    assert torch.equal(got, morph_kernel.clean_plain(allow, fill))


@pytest.mark.cuda
def test_morph_kernels_take_unaligned_and_byte_masks(cuda):
    """A view that starts one byte into its storage, and uint8 masks."""
    masks, seeds, allow = _masks(5, 64, seed=3)
    flat = torch.zeros(1 + masks.numel(), dtype=torch.bool, device=cuda)
    flat[1:] = masks.flatten().to(cuda)
    shifted = flat[1:].view(masks.shape)
    assert shifted.data_ptr() % 16
    assert torch.equal(morph_kernel.clean(shifted).cpu(), morph_kernel.clean_plain(masks))
    got = morph_kernel.grow_clean(seeds.to(cuda).to(torch.uint8), allow.to(cuda).to(torch.uint8))
    assert torch.equal(got.cpu(), morph_kernel.grow_clean_plain(seeds, allow))


GUARD = 4096  # bytes of sentinel on each side of a guarded output
SENTINEL = 0xA5


def _guarded(shape, device):
    """A uint8 output of `shape` between two guard regions of SENTINEL."""
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * GUARD,), SENTINEL, dtype=torch.uint8, device=device)
    return buf, buf[GUARD:GUARD + n].view(shape)


def _in_graph_replays(launch, per_graph=10, replays=20):
    """`per_graph` launches captured in a CUDA graph, replayed `replays` times."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            launch()
    for _ in range(replays):
        graph.replay()
    torch.cuda.synchronize()


def _guards_intact(buf):
    return bool((buf[:GUARD] == SENTINEL).all()) and bool((buf[-GUARD:] == SENTINEL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,iterations", [(1, 300, 16), (8, 300, 16), (1, 300, 0),
                                                (3, 512, 40), (8, 20, 16), (2, 1, 16)])
def test_suppress_entry_point_writes_only_its_output(cuda, batch, k, iterations):
    """The raw entry point, launched directly and from CUDA-graph replays as
    the kernel timing does, writes its keep mask and no byte beside it."""
    boxes = _boxes(batch, k, seed=k).to(cuda)
    buf, keep = _guarded((batch, k), cuda)
    threshold = torch.tensor(0.5, device=cuda)
    fn = build.library().fns["iqc_suppress"]

    def launch():
        build.launch(fn, boxes.device, boxes.data_ptr(), threshold.data_ptr(), keep.data_ptr(),
                     batch, k, iterations)

    launch()
    _in_graph_replays(launch)
    assert _guards_intact(buf)
    want = nms_kernel.suppress_plain(boxes.cpu(), 0.5, iterations)
    assert torch.equal(keep.cpu().bool(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(16, 128), (17, 128), (64, 128), (65, 128), (1, 32), (3, 256)])
def test_morph_entry_points_write_only_their_outputs(cuda, n, r):
    """As above, for both morphology entry points."""
    masks, seeds, allow = _masks(n, r, seed=n)
    masks, seeds, allow = (x.to(cuda) for x in (masks, seeds, allow))
    lib = build.library()
    buf_g, out_g = _guarded((n, r, r), cuda)
    buf_c, out_c = _guarded((n, r, r), cuda)

    def launch():
        build.launch(lib.fns["iqc_grow_clean"], seeds.device, seeds.data_ptr(), allow.data_ptr(),
                     out_g.data_ptr(), n, r, 24, 16)
        build.launch(lib.fns["iqc_clean"], masks.device, masks.data_ptr(), out_c.data_ptr(), n, r,
                     16)

    launch()
    _in_graph_replays(launch)
    assert _guards_intact(buf_g) and _guards_intact(buf_c)
    want = morph_kernel.grow_clean_plain(seeds.cpu(), allow.cpu(), 24, 16)
    assert torch.equal(out_g.cpu().bool(), want)
    assert torch.equal(out_c.cpu().bool(), morph_kernel.clean_plain(masks.cpu(), 16))


# (label, NHWC input, HWIO kernel, stride, padding): the padded shape classes
# of the int8 networks at the shapes of a request
INT8_CONV_CASES = [
    ("yolo_stem_640_k27", (1, 640, 640, 3), (3, 3, 3, 16), 2, [(1, 1), (1, 1)]),
    ("resnet_stem_128_k147", (32, 128, 128, 3), (7, 7, 3, 64), 2, [(3, 3), (3, 3)]),
    ("global_stage4_m16", (1, 4, 4, 2048), (1, 1, 2048, 512), 1, "SAME"),
    ("global_stage4_m16_3x3", (1, 4, 4, 512), (3, 3, 512, 512), 1, "SAME"),
    ("resnet_s2_asymmetric", (4, 32, 32, 128), (3, 3, 128, 128), 2, "SAME"),
    ("resnet_down_1x1_s2", (4, 32, 32, 256), (1, 1, 256, 512), 2, "SAME"),
    ("yolo_head_cls5", (1, 20, 20, 64), (1, 1, 64, 5), 1, [(0, 0), (0, 0)]),
    ("yolo_k3_s1", (2, 80, 80, 32), (3, 3, 32, 32), 1, [(1, 1), (1, 1)]),
    ("m4", (1, 4, 4, 8), (3, 3, 8, 8), 2, "SAME"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CONV_CASES, ids=[c[0] for c in INT8_CONV_CASES])
def test_int8_conv_on_the_card_equals_the_cpu(cuda, case):
    _, xs, ws, stride, padding = case
    g = torch.Generator().manual_seed(xs[-1] * 7 + ws[-1])
    x = torch.randint(-127, 128, xs, dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, ws, dtype=torch.int8, generator=g)
    want = int8_conv.conv_int8(x, int8_conv.prepare_weight(w), stride, padding)
    got = int8_conv.conv_int8(x.to(cuda), int8_conv.prepare_weight(w.to(cuda)), stride, padding)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_int8_matmul_refuses_what_int_mm_refuses_on_the_card(cuda):
    """torch._int_mm on the card refuses K = 27 and M = 16; the wrapper
    raises before the call, and pads M itself."""
    a = torch.randint(-127, 128, (32, 27), dtype=torch.int8, device=cuda)
    bt = torch.randint(-127, 128, (16, 27), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError):
        torch._int_mm(a, bt.t())
    with pytest.raises(ValueError):
        int8_conv.int_mm(a, bt)
    a16 = torch.randint(-127, 128, (16, 32), dtype=torch.int8, device=cuda)
    b16 = torch.randint(-127, 128, (8, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError):
        torch._int_mm(a16, b16.t())
    got = int8_conv.int_mm(a16, b16)
    assert torch.equal(got.cpu(), a16.cpu().int() @ b16.cpu().int().t())


# -- the standalone entry points and the serving options ------------------------------------

YOLO_CKPT = "models/yolov8n_qc_synthetic.msgpack"
RESNET_CKPT = "models/resnet50_qc_128.msgpack"


def _frames(n, size=128, seed=0):
    """Grey parts with a dark bar and a bright blob."""
    rng = np.random.default_rng(seed)
    imgs = np.clip(170 + rng.normal(0, 6, (n, size, size, 3)), 0, 255).astype(np.uint8)
    for i in range(n):
        y, x = rng.integers(10, size - 58, 2)
        imgs[i, y:y + 8, x:x + 50] = 30
        y, x = rng.integers(20, size - 38, 2)
        imgs[i, y:y + 22, x:x + 26] = 240
    return imgs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 33, 256, 257])
def test_morph_kernels_at_the_standalone_shapes_equal_plain(cuda, n):
    """ImageSegmentator's ROI batches: 32 ROIs an image, 8 images (K3 takes
    one more, the all-ones ROI)."""
    masks, seeds, allow = _masks(n, 128, seed=n)
    assert torch.equal(morph_kernel.clean(masks.to(cuda)).cpu(), morph_kernel.clean_plain(masks))
    got = morph_kernel.grow_clean(seeds.to(cuda), allow.to(cuda), 24, 16).cpu()
    assert torch.equal(got, morph_kernel.grow_clean_plain(seeds, allow, 24, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 96, 80, 3), (2, 64, 64, 3)])
def test_denoise_and_contrast_on_the_card_equal_the_cpu(cuda, shape):
    from iqc_tpu_torch.ops import image as imops

    x = torch.from_numpy(np.random.default_rng(1).random(shape, dtype=np.float32))
    for fn in (imops.bilateral_filter, imops.enhance_contrast_rgb):
        got = fn(x.to(cuda)).cpu()
        assert torch.allclose(got, fn(x), rtol=0, atol=1e-5), fn.__name__


def _option_config(extra):
    from iqc_tpu_torch.config import SystemConfig

    raw = {"model": {"yolo_weights": YOLO_CKPT, "resnet_weights": "", "max_detections": 16,
                     "max_classified": 4, "confidence_threshold": 0.05,
                     "classifier_input": 64, "resnet_stages": [1, 1, 1, 1]},
           "processing": {"batch_size": 2, "input_size": [128, 128],
                          "preprocessing": {"resize": [128, 128]}},
           "quality_control": {"thresholds": {"confidence_threshold": 0.0,
                                              "area_threshold_percent": 1000.0}},
           "edge": {"precision": "int8"}}
    for section, values in extra.items():
        for k, v in values.items():
            raw.setdefault(section, {})[k] = v
    return SystemConfig.from_dict(raw)


OPTIONS = {
    "denoise_contrast": {"processing": {"preprocessing": {"resize": [128, 128], "denoise": True,
                                                          "enhance_contrast": True}}},
    "yolo_v1_walk": {"edge": {"precision": "int8", "yolo_int8_stream": False}},
    "yolo_weight_only": {"edge": {"precision": "int8", "yolo_int8": False}},
    "pruned": {"edge": {"precision": "int8", "sparsity": 0.05, "structured_pruning": True}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("option", list(OPTIONS))
def test_detector_option_on_the_card_equals_the_cpu(cuda, option):
    """The card's quantized networks served on the CPU too, on the same
    preprocessed frames: decisions equal, boxes within 1 px, scores within
    1e-3. The preprocessing alone: CLAHE bins its input, so a pixel whose
    filtered luma sits on a bin edge can take the next bin's mapping on one
    side: at most 0.1% of the values beyond 1e-5, each within 0.05."""
    from iqc_tpu_torch.inference.detector import QualityControlDetector

    cfg = _option_config(OPTIONS[option])
    gpu = QualityControlDetector(config=cfg, device="cuda")
    ens = gpu.ensemble_predictor
    state = {"yolo": ens.yolo_vars, "resnet": ens.resnet_vars}
    cpu = QualityControlDetector(config=cfg, device="cpu", int8_state=state)
    assert cpu.ensemble_predictor.precision_report == ens.precision_report
    frames = torch.from_numpy(_frames(2, seed=3))
    x = gpu._preprocess(frames.to(cuda))
    err = (x.cpu() - cpu._preprocess(frames)).abs()
    assert float((err > 1e-5).float().mean()) <= 1e-3 and float(err.max()) <= 0.05
    g_out, _, _ = ens.run_full_host(x)
    c_out, _, _ = cpu.ensemble_predictor.run_full_host(x.cpu())
    v = c_out.valid
    assert np.array_equal(g_out.valid, v) and v.any()
    for f in ("classes", "final_severity", "crop_class"):
        assert np.array_equal(getattr(g_out, f)[v], getattr(c_out, f)[v]), f
    assert np.abs(g_out.boxes[v] - c_out.boxes[v]).max() <= 1.0
    assert np.abs(g_out.yolo_scores[v] - c_out.yolo_scores[v]).max() <= 1e-3


@pytest.mark.cuda
def test_entry_points_on_the_card_equal_the_cpu(cuda):
    from iqc_tpu_torch.inference.segmentation import ImageSegmentator
    from iqc_tpu_torch.models import ResNetClassifier, YOLODetector

    frames = _frames(4, seed=4)
    kw = dict(model_path=YOLO_CKPT, confidence_threshold=0.05, input_size=(128, 128))
    yg, yc = YOLODetector(**kw, device="cuda"), YOLODetector(**kw, device="cpu")
    before = nms_kernel.LAUNCHES["suppress"]
    dg = yg.batch_predict(list(frames))
    assert nms_kernel.LAUNCHES["suppress"] == before + 1
    for g, c in zip(dg, yc.batch_predict(list(frames))):
        assert [d["class"] for d in g["detections"]] == [d["class"] for d in c["detections"]]
        for a, b in zip(g["detections"], c["detections"]):
            assert abs(a["confidence"] - b["confidence"]) <= 1e-4
    cg, cc = (ResNetClassifier(model_path=RESNET_CKPT, device=d) for d in ("cuda", "cpu"))
    g, c = cg.predict(frames[0]), cc.predict(frames[0])
    assert g["predicted_class"] == c["predicted_class"]
    assert abs(g["confidence"] - c["confidence"]) <= 1e-4
    assert np.allclose(cg.extract_features(frames[1]), cc.extract_features(frames[1]),
                       rtol=1e-4, atol=1e-5)
    sg, sc = (ImageSegmentator(device=d) for d in ("cuda", "cpu"))
    dets = [r["detections"] for r in dg]
    before = dict(morph_kernel.LAUNCHES)
    got = sg.segment_batch(frames, dets)
    assert all(morph_kernel.LAUNCHES[k] == before[k] + 1 for k in before)
    for g, c in zip(got, sc.segment_batch(frames, dets)):
        for rg, rc in zip(g["segmented_regions"], c["segmented_regions"]):
            assert np.mean(rg["local_mask"] == rc["local_mask"]) >= 0.999
            assert rg["segmentation_method"] == rc["segmentation_method"]


@pytest.mark.cuda
def test_engine_graph_replay_equals_eager(cuda):
    """build_engine on the card captures a CUDA graph at max_batch_size; its
    replay equals the eager forward."""
    from iqc_tpu_torch.models.optimizer import EngineOptimizer
    from iqc_tpu_torch.models.yolo import YOLOv8
    from iqc_tpu_torch.weights import load_into, read_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    net = YOLOv8().to(cuda).eval()

    def apply_fn(variables, batch):
        return net(batch)

    variables = read_checkpoint(YOLO_CKPT)
    opt = EngineOptimizer(precision="int8", max_batch_size=4)
    weights, _ = opt.optimize_variables(variables)
    load_into(net, weights)
    net.to(cuda)
    engine = opt.build_engine(apply_fn, variables, torch.zeros(1, 128, 128, 3, device=cuda))
    assert engine.graph is not None and engine.flops > 0 and opt.report["compile_seconds"] > 0
    x = torch.rand(4, 128, 128, 3, device=cuda)
    got = engine(weights, x)
    with torch.inference_mode():
        want = net(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- captured forwards, run-time thresholds and export --------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("batch,k,iterations", [(1, 300, 16), (8, 300, 16), (3, 512, 40),
                                                (2, 1, 16)])
def test_suppress_reads_its_threshold_at_run_time(cuda, threshold, batch, k, iterations):
    """The raw entry point captured in a CUDA graph at threshold 0.5, its
    threshold tensor then set to `threshold`: the replays equal the plain
    version at `threshold` and write no byte beside the keep mask."""
    boxes = _boxes(batch, k, seed=k + 1).to(cuda)
    buf, keep = _guarded((batch, k), cuda)
    t = torch.tensor(0.5, device=cuda)
    fn = build.library().fns["iqc_suppress"]

    def launch():
        build.launch(fn, boxes.device, boxes.data_ptr(), t.data_ptr(), keep.data_ptr(), batch, k,
                     iterations)

    launch()
    torch.cuda.synchronize()
    assert torch.equal(keep.cpu().bool(), nms_kernel.suppress_plain(boxes.cpu(), 0.5, iterations))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    t.fill_(threshold)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert _guards_intact(buf)
    want = nms_kernel.suppress_plain(boxes.cpu(), threshold, iterations)
    assert torch.equal(keep.cpu().bool(), want)
    got = nms_kernel.suppress(boxes, torch.tensor(threshold, device=cuda), iterations)
    assert torch.equal(got.cpu(), want)


def _eager_and_captured(det, frames):
    """(captured first call, captured replay, eager) run_full_host outputs
    of the detector's preprocessed frames."""
    from iqc_tpu_torch.ops import jit_utils

    ens = det.ensemble_predictor
    x = det._preprocess(frames)
    first, again = ens.run_full_host(x), ens.run_full_host(x)
    with jit_utils.eager():
        want = ens.run_full_host(x)
    return first, again, want


def _assert_close(got, want, box_tol, score_tol):
    (g, gm, gs), (w, wm, ws) = got, want
    v = w.valid
    assert np.array_equal(g.valid, v) and v.any()
    for f in ("classes", "final_severity", "crop_class"):
        assert np.array_equal(getattr(g, f)[v], getattr(w, f)[v]), f
    assert np.array_equal(g.severity_counts, w.severity_counts)
    assert np.abs(g.boxes[v] - w.boxes[v]).max() <= box_tol
    assert np.abs(g.yolo_scores[v] - w.yolo_scores[v]).max() <= score_tol
    assert np.abs(g.ensemble_conf[v] - w.ensemble_conf[v]).max() <= score_tol
    assert float(np.mean(gm == wm)) >= 0.999
    assert np.array_equal(gs[..., 4], ws[..., 4])


FP32 = {"edge": {"precision": "fp32"}, "model": {"compute_dtype": "float32"}}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "fp32"])
def test_captured_forward_equals_eager(cuda, precision):
    """The full forward replayed from its CUDA graph (the first call, which
    captures, and a replay) against the same forward run eagerly: int8
    decisions equal, boxes within 1 px, scores within 1e-3; float32 boxes
    within 1e-2 px, scores within 1e-4; masks on 99.9% of pixels."""
    from iqc_tpu_torch.inference.detector import QualityControlDetector

    det = QualityControlDetector(config=_option_config(FP32 if precision == "fp32" else {}),
                                 device="cuda")
    frames = torch.from_numpy(_frames(2, seed=5)).to(cuda)
    first, again, want = _eager_and_captured(det, frames)
    tol = (1.0, 1e-3) if precision == "int8" else (1e-2, 1e-4)
    _assert_close(first, want, *tol)
    _assert_close(again, want, *tol)
    assert len(det.ensemble_predictor._forward_full.captures()) == 1


@pytest.mark.cuda
def test_update_config_between_replays_needs_no_capture(cuda):
    """New thresholds and fusion weights reach the next replay: it equals
    eager at the new values, and no graph is captured anew."""
    from iqc_tpu_torch.inference.detector import QualityControlDetector

    det = QualityControlDetector(config=_option_config({}), device="cuda")
    fwd = det.ensemble_predictor._forward_full
    frames = torch.from_numpy(_frames(2, seed=6)).to(cuda)
    _eager_and_captured(det, frames)
    graphs = len(fwd.captures())
    det.update_config({"model": {"confidence_threshold": 0.1, "nms_threshold": 0.3,
                                 "ensemble_weights": {"yolo": 0.3, "resnet": 0.7}}})
    _, again, want = _eager_and_captured(det, frames)
    _assert_close(again, want, 1.0, 1e-3)
    assert len(fwd.captures()) == graphs


@pytest.mark.cuda
def test_replays_count_the_kernels_they_launch(cuda):
    """K1-K3 counted through a capture and replays: one eager call's counts
    times the number of calls."""
    from iqc_tpu_torch.inference.detector import QualityControlDetector
    from iqc_tpu_torch.ops import jit_utils

    def counts():
        return {**nms_kernel.LAUNCHES, **morph_kernel.LAUNCHES}

    det = QualityControlDetector(config=_option_config({}), device="cuda")
    ens = det.ensemble_predictor
    x = det._preprocess(torch.from_numpy(_frames(2, seed=7)).to(cuda))
    before = counts()
    with jit_utils.eager():
        ens.run_full_host(x)
    one = {k: v - before[k] for k, v in counts().items()}
    assert all(v > 0 for v in one.values())
    before = counts()
    for _ in range(4):
        ens.run_full_host(x)
    assert {k: v - before[k] for k, v in counts().items()} == {k: 4 * v for k, v in one.items()}


@pytest.mark.cuda
def test_export_and_reload_on_the_card(cuda, tmp_path):
    """The int8 predictor exported at batch 1 on the card and reloaded: the
    program holds iqc.suppress, launches K1 once a call and equals live
    ``run``."""
    from iqc_tpu_torch.inference.detector import QualityControlDetector
    from iqc_tpu_torch.models.export import export_ensemble, load_exported

    ens = QualityControlDetector(config=_option_config({}), device="cuda").ensemble_predictor
    path = str(tmp_path / "ensemble.iqc")
    meta = export_ensemble(ens, path, batch_size=1)
    assert meta["device"].startswith("cuda") and meta["precision"] == "int8"
    engine = load_exported(path, device="cuda")
    assert "iqc.suppress" in str(engine.program.graph)
    frame = _frames(1, seed=8)
    before = nms_kernel.LAUNCHES["suppress"]
    out = engine.outputs(frame)
    assert nms_kernel.LAUNCHES["suppress"] == before + 1
    live = ens.run_host(frame)
    assert np.array_equal(out.valid, live.valid) and live.valid.any()
    v = live.valid
    assert np.array_equal(out.classes[v], live.classes[v])
    assert np.abs(out.boxes[v] - live.boxes[v]).max() <= 1.0


# -- training: K1 at validation's shapes, a train step and validate, card vs CPU -------


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k", [(16, 100), (4, 84)])
def test_suppress_at_training_validation_shapes(cuda, batch, k):
    """K1 at the trainer's validation shapes (capacity 100 at 640^2, 84
    anchors at 64 px) and IoU threshold 0.6: the raw launch writes no byte
    beside its keep mask, and it and the wrapper equal the plain version."""
    boxes = _boxes(batch, k, seed=k + 7).to(cuda)
    buf, keep = _guarded((batch, k), cuda)
    t = torch.tensor(0.6, device=cuda)
    build.launch(build.library().fns["iqc_suppress"], boxes.device, boxes.data_ptr(),
                 t.data_ptr(), keep.data_ptr(), batch, k, 16)
    torch.cuda.synchronize()
    assert _guards_intact(buf)
    want = nms_kernel.suppress_plain(boxes.cpu(), 0.6)
    assert torch.equal(keep.cpu().bool(), want)
    assert torch.equal(nms_kernel.suppress(boxes, t).cpu(), want)


TRAIN_CFG = {"image_size": 64, "batch_size": 4, "max_boxes": 8, "epochs": 1,
             "width_mult": 0.125, "reg_max": 8, "compute_dtype": "float32",
             "warmup_epochs": 0, "ema_decay": 0.9,
             "augmentation": {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "translate": 0.1,
                              "scale": 0.5, "fliplr": 0.5}}


def _torch_order_sum(x):
    return x.sum([d for d in range(x.dim()) if d != 1])


def _trained_pair(cuda, steps):
    """The same trainer on the card and on the CPU (the same seeded init,
    the same CPU-drawn mosaic and augmentation), ``steps`` corpus steps
    each: (card trainer, CPU trainer, card parts, CPU parts). The cls_out
    kernels are scaled by 5 at the start, so that anchors' scores lie
    apart: a fresh network scores every anchor within ~1e-8, and which of
    near-equal anchors the assignment's top-k and the NMS capacity take
    then follows each device's rounding."""
    from iqc_tpu_torch.data.yolo_dataset import DetectionLoader, SyntheticDefectDataset
    from iqc_tpu_torch.train.train_yolo import YOLOTrainer

    out = []
    idx = np.random.default_rng(0).integers(0, 12, (steps, 4)).astype(np.int32)
    for device in (cuda, "cpu"):
        tr = YOLOTrainer(TRAIN_CFG, device=device)
        tr.build(steps_per_epoch=3)
        with torch.no_grad():
            for k, p in tr.state.params.items():
                if "cls_out.weight" in k:
                    p.mul_(5.0)
                    tr.ema_params[k].copy_(p)
        tr.initial = {k: p.detach().cpu().clone() for k, p in tr.state.params.items()}
        loader = DetectionLoader(SyntheticDefectDataset(12, 64, 8, seed=0), 4, mosaic_prob=0.0,
                                 mixup_prob=0.0)
        corpus = tr._maybe_device_corpus(loader)
        out.append((tr, tr._corpus_epoch(corpus, idx)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.cuda
@pytest.mark.parametrize("cpu_stats", ["torch_order", "xla_order"])
def test_train_steps_on_the_card_equal_the_cpu(cuda, cpu_stats, monkeypatch):
    """Two float32 steps (mosaic 1.0, augmentation) on the card and on the
    CPU: loss parts within 1e-4 relative (or 1e-6 of the total loss) where
    the CPU sums the batch statistics with PyTorch's reduction, as the card
    does; within 1e-3 where it sums them in XLA's sequential order (the
    JAX package's; the fast variance mean(x^2) - mean^2 cancels on flat
    images, so the order moves the loss by ~2e-4). The statistics within
    1e-3 of each leaf's largest magnitude; the change of the parameters and of the EMA over the two steps within 5e-2
    of the largest change (the backward through those statistics carries
    the same magnification into the gradients, and the second update runs
    at the full learning rate)."""
    from iqc_tpu_torch.models import layers

    if cpu_stats == "torch_order":
        monkeypatch.setattr(layers, "channel_sum", _torch_order_sum)
    gpu, cpu, pg, pc = _trained_pair(cuda, 2)
    tol = 1e-4 if cpu_stats == "torch_order" else 1e-3
    for g, c in zip(pg, pc):
        for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg"):
            np.testing.assert_allclose(float(g[k]), float(c[k]), rtol=tol,
                                       atol=1e-6 * abs(float(c["loss"])), err_msg=k)
    for k, b in cpu.state.batch_stats.items():
        a = gpu.state.batch_stats[k].cpu()
        assert float((a - b).abs().max()) <= 1e-3 * max(1.0, float(b.abs().max())), k
    for a, b in ((gpu.state.params, cpu.state.params), (gpu.ema_params, cpu.ema_params)):
        moved = max(float((b[k].detach() - cpu.initial[k]).abs().max()) for k in b)
        err = max(float((a[k].detach().cpu() - b[k].detach()).abs().max()) for k in b)
        assert moved > 0 and err <= 5e-2 * moved, (err, moved)


@pytest.mark.cuda
def test_trainer_validate_on_the_card_equals_the_cpu(cuda):
    """validate and the EMA detections of the same trained state on the
    card (K1 inside a captured graph) and on the CPU: the same detections
    per image (classes equal, boxes within 1e-3 px, scores within 1e-5),
    mAP50 and mAP50-95 within 1e-6."""
    from iqc_tpu_torch.data.yolo_dataset import DetectionLoader, SyntheticDefectDataset

    gpu, cpu, _, _ = _trained_pair(cuda, 1)
    with torch.no_grad():
        for k, v in cpu.state.params.items():
            gpu.state.params[k].copy_(v)
        for src, dst in ((cpu.state.batch_stats, gpu.state.batch_stats),
                         (cpu.ema_params, gpu.ema_params)):
            for k, v in src.items():
                dst[k].copy_(v)
    val = SyntheticDefectDataset(8, 64, 8, seed=1)
    loader = lambda: DetectionLoader(val, 4, mosaic_prob=0.0, mixup_prob=0.0, shuffle=False)
    a, b = gpu.validate(loader()), cpu.validate(loader())
    for k in ("mAP50", "mAP50_95"):
        assert abs(a[k] - b[k]) <= 1e-6
    images = np.stack([val.load(i)[0] for i in range(4)])
    for g, c in zip(gpu.predict_batches([images]), cpu.predict_batches([images])):
        assert len(g["classes"]) == len(c["classes"])
        og = np.lexsort((g["boxes"][:, 0], g["classes"]))
        oc = np.lexsort((c["boxes"][:, 0], c["classes"]))
        np.testing.assert_array_equal(g["classes"][og], c["classes"][oc])
        np.testing.assert_allclose(g["boxes"][og], c["boxes"][oc], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"][og], c["scores"][oc], rtol=0, atol=1e-5)


# -- the classifier trainer ------------------------------------------------------------

CLS_CFG = {"image_size": 32, "batch_size": 8, "stage_sizes": [1, 1, 1, 1], "epochs": 3,
           "compute_dtype": "float32"}


def _classifier_pair(cuda, n_steps, tmp_path):
    """The same fresh classifier trained ``n_steps`` float32 steps on the
    card and on the CPU (the profile's augmentation, class weights and
    balanced sampling; the same CPU-drawn augmentation and dropout)."""
    from iqc_tpu_torch.config import RESNET_TRAINING_PROFILE
    from iqc_tpu_torch.data.mvtec_synth import MVTecStyleRenderer
    from iqc_tpu_torch.data.pipeline import ArrayDataset
    from iqc_tpu_torch.train.train_resnet import ResNetTrainer

    r = MVTecStyleRenderer(size=32, seed=5)
    names = ("crack", "scratch", "dent", "discoloration", "contamination")
    labels = np.repeat(np.arange(5), (8, 6, 4, 3, 3)).astype(np.int32)
    images = np.stack([r.render(names[c], i)[0] for i, c in enumerate(labels)])
    cfg = {**CLS_CFG, "augmentation": RESNET_TRAINING_PROFILE["augmentation"]["train"],
           "checkpoint_dir": str(tmp_path)}
    out = []
    for device in (cuda, "cpu"):
        tr = ResNetTrainer(cfg, device=device)
        tr.setup_data(ArrayDataset(images, labels), ArrayDataset(images[::-1], labels[::-1]))
        tr.build(steps_per_epoch=3)
        corpus = tr._maybe_device_corpus()
        out.append((tr, tr._corpus_epoch(corpus, tr.epoch_indices(0)[:n_steps])))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cpu_stats", ["torch_order", "xla_order"])
def test_classifier_steps_on_the_card_equal_the_cpu(cuda, cpu_stats, monkeypatch, tmp_path):
    """Two float32 classifier steps (Adam + cosine, the profile's
    augmentation) on the card and on the CPU: the first loss within 1e-4
    relative where the CPU sums the batch statistics with PyTorch's
    reduction (1e-3 in XLA's order), the second within 2e-3 (Adam moves a
    parameter whose gradient is near zero by about the learning rate, so
    rounding differences of the first backward reach it); the parameters
    within 5e-3 (five learning rates)."""
    from iqc_tpu_torch.models import layers

    if cpu_stats == "torch_order":
        monkeypatch.setattr(layers, "channel_sum", _torch_order_sum)
    (gpu, pg), (cpu, pc) = _classifier_pair(cuda, 2, tmp_path)
    tols = (1e-4 if cpu_stats == "torch_order" else 1e-3, 2e-3)
    for g, c, tol in zip(pg, pc, tols):
        np.testing.assert_allclose(float(g["loss"]), float(c["loss"]), rtol=tol)
    err = max(float((gpu.state.params[k].detach().cpu() - v.detach()).abs().max())
              for k, v in cpu.state.params.items())
    assert err <= 5e-3, err


@pytest.mark.cuda
def test_classifier_evaluate_on_the_card_equals_the_cpu(cuda, tmp_path):
    """evaluate and test of the same weights on the card and on the CPU:
    predictions and the confusion matrix equal, the loss within 1e-5."""
    (gpu, _), (cpu, _) = _classifier_pair(cuda, 1, tmp_path)
    with torch.no_grad():
        for k, v in cpu.module.state_dict().items():
            gpu.module.state_dict()[k].copy_(v)
    a, b = gpu.evaluate(gpu.val_loader), cpu.evaluate(cpu.val_loader)
    assert abs(a.pop("loss") - b.pop("loss")) <= 1e-5
    assert a == b
    gpu.test_ds, cpu.test_ds = gpu.val_ds, cpu.val_ds
    ta, tb = gpu.test(str(tmp_path)), cpu.test(str(tmp_path))
    assert ta["confusion_matrix"] == tb["confusion_matrix"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(16, 128), (40, 64)])
def test_clean_and_grow_clean_batch_on_the_card(cuda, n, r):
    """segmentation.clean_mask_batch and grow_clean_batch launch K3 and K2
    once each on the card and EQUAL their plain versions on the CPU."""
    from iqc_tpu_torch.ops import segmentation

    gen = torch.Generator().manual_seed(n)
    masks = torch.rand((n, r, r), generator=gen) < 0.45
    seeds = torch.rand((n, r, r), generator=gen) < 0.03
    allow = torch.rand((n, r, r), generator=gen) < 0.7
    before = dict(morph_kernel.LAUNCHES)
    got_c = segmentation.clean_mask_batch(masks.to(cuda)).cpu()
    got_g = segmentation.grow_clean_batch(seeds.to(cuda), allow.to(cuda)).cpu()
    assert morph_kernel.LAUNCHES["clean"] == before["clean"] + 1
    assert morph_kernel.LAUNCHES["grow_clean"] == before["grow_clean"] + 1
    assert torch.equal(got_c, morph_kernel.clean_plain(masks, 16))
    assert torch.equal(got_g, morph_kernel.grow_clean_plain(seeds, allow, 24, 16))


# -- the mesh over NCCL at world size 1 ------------------------------------------------


@contextlib.contextmanager
def _nccl_rank(tmp_path):
    """This process as the one rank of an NCCL group (a file store in
    ``tmp_path``), its mesh yielded; the group ends and the launcher's
    variables are restored after."""
    import torch.distributed as dist

    from iqc_tpu_torch.parallel.mesh import create_mesh, distributed_init

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        device = distributed_init("cuda", timeout_s=120,
                                  init_method=f"file://{tmp_path}/nccl_store")
        assert dist.get_backend() == "nccl"
        yield create_mesh(device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.cuda
def test_batchnorm_statistics_all_reduce_over_nccl(cuda, tmp_path):
    """A train-mode BatchNorm on a mesh of one NCCL rank (its channel sums
    all-reduced, its backward's too) equals the plain one on the card:
    outputs, running statistics and gradients within 1e-6."""
    from iqc_tpu_torch.models.layers import BatchNorm, set_mesh

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 6, 9, 9), generator=gen) * 1.5 + 0.3
    x[:4] = 0.7  # flat images
    w = torch.randn((6, 9, 9), generator=gen)

    def run(mesh):
        bn = BatchNorm(6, eps=1e-3).to(cuda).train()
        set_mesh(bn, mesh)
        xx = x.to(cuda).requires_grad_(True)
        y = bn(xx)
        (y * w.to(cuda)).sum().backward()
        return [t.detach().cpu() for t in (y, xx.grad, bn.weight.grad, bn.bias.grad,
                                           bn.running_mean, bn.running_var)]

    want = run(None)
    with _nccl_rank(tmp_path) as spec:
        assert spec.distributed and spec.data_size == 1
        got = run(spec)
    for g, c in zip(got, want):
        torch.testing.assert_close(g, c, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_run_sharded_equals_run_on_the_card(cuda, tmp_path):
    """``run_sharded`` and ``run_full_sharded`` on a mesh of one NCCL rank
    (captured stages, the pools' keys and the outputs gathered between
    them) against ``run`` and ``run_full_host`` on the card: decisions and
    masks equal, boxes within 1e-2 px, scores within 1e-5."""
    from iqc_tpu_torch.config import SystemConfig, resolve_path
    from iqc_tpu_torch.models.ensemble import EnsemblePredictor

    cfg = {"model": {"yolo_weights": resolve_path("models/yolov8n_qc_synthetic.msgpack"),
                     "resnet_weights": "", "width_mult": 0.25, "max_detections": 16,
                     "max_classified": 4, "max_classified_pool": 6, "max_segmented": 2,
                     "max_segmented_pool": 6, "seg_roi_size": 32,
                     "confidence_threshold": 0.05, "compute_dtype": "float32",
                     "classifier_input": 32, "resnet_stages": [1, 1, 1, 1]},
           "processing": {"input_size": [128, 128], "preprocessing": {"resize": [128, 128]}},
           "edge": {"precision": "fp32"}}
    pred = EnsemblePredictor(config=SystemConfig.from_dict(cfg), device=cuda)
    frames = _frames(8)
    want = pred.run(frames)
    want_full = pred.run_full_host(frames)
    with _nccl_rank(tmp_path) as spec:
        got = pred.run_sharded(frames, spec)
        got_full = pred.run_full_sharded(frames, spec)
    g, w = ({k: v.cpu().numpy() for k, v in o._asdict().items()} for o in (got, want))
    for f in ("valid", "classes", "crop_classified", "final_severity", "severity_counts"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    v = w["valid"]
    np.testing.assert_allclose(g["boxes"][v], w["boxes"][v], atol=1e-2)
    np.testing.assert_allclose(g["ensemble_conf"][v], w["ensemble_conf"][v], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got_full[1], want_full[1])
    np.testing.assert_array_equal(got_full[0].valid, want_full[0].valid)


@pytest.mark.cuda
def test_sharded_yolo_step_equals_the_plain_step_on_the_card(cuda, tmp_path):
    """One float32 YOLO step on a mesh of one NCCL rank (global batch
    statistics, the loss's normaliser and the gradients all-reduced)
    against the plain step on the card, from the same state and batch: the
    loss within 1e-4 relative, parameters, EMA and statistics within
    rtol 2e-4 / atol 2e-5 (the JAX package's sharded-vs-single bounds)."""
    from iqc_tpu_torch.data.yolo_dataset import DetectionLoader, SyntheticDefectDataset
    from iqc_tpu_torch.train.train_yolo import YOLOTrainer

    cfg = {"image_size": 64, "batch_size": 8, "max_boxes": 8, "width_mult": 0.125,
           "reg_max": 8, "compute_dtype": "float32", "warmup_epochs": 0, "mosaic": 0.0,
           "device_mosaic": False, "ema_decay": 0.9, "checkpoint_dir": str(tmp_path)}
    batch = next(iter(DetectionLoader(SyntheticDefectDataset(8, 64, 8, seed=3), 8,
                                      mosaic_prob=0.0, mixup_prob=0.0, shuffle=False)))
    args = (batch["images"], batch["boxes"], batch["classes"], batch["valid"])

    def step():
        tr = YOLOTrainer(cfg, device=cuda)
        tr.build(steps_per_epoch=2)
        parts = tr.train_step(*args)
        return tr, {k: float(v) for k, v in parts.items()}

    plain, want = step()
    with _nccl_rank(tmp_path) as spec:
        sharded, got = step()
        assert sharded.mesh.distributed and spec.data_size == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for name in ("params", "batch_stats"):
        for k, v in getattr(plain.state, name).items():
            torch.testing.assert_close(getattr(sharded.state, name)[k], v, rtol=2e-4, atol=2e-5)
    for k, v in plain.ema_params.items():
        torch.testing.assert_close(sharded.ema_params[k], v, rtol=2e-4, atol=2e-5)
