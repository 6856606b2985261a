#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each under a deadline and printed with its wall time:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: one nvcc call compiles iqc_tpu_torch/csrc/*.cu for sm_90a;
  3. kernels: each CUDA kernel against its plain PyTorch version on the card
     (must be exactly equal) at the shapes of one predict request (1 image,
     16 ROIs) and of predict_batch of 8 (8 images, 64 ROIs), with its device
     time (graph replay of the raw entry point), its wrapper's time, the
     plain version's time and its bound; then inputs that end the kernels'
     loops early or never;
  4. main path: the shipped serving profile (YOLOv8n 640^2, ResNet-50 on
     128^2 crops, crop pool 128, seg pool 64) at its shipped precision, int8
     with both streaming walks and bfloat16 compute, from the shipped
     checkpoints, its activation scales calibrated on the card at start-up;
     4 x predict and 1 x predict_batch of 8 on seeded synthetic 640^2 defect
     images, with every kernel's launch counter read around it;
  5. int8 cross-check: one request again on the CPU with the card's quantized
     networks and scales carried across, compared with the card's; then the
     int8 ResNet (streaming walk) on the crops of the card's boxes, card
     against CPU layer by layer (input codes, int32 accumulators, bfloat16
     affine outputs, block outputs, features, logits), on the same crops and
     on each device's own crops of the same boxes, with the first layer where
     the two part;
  6. fp32: the same profile in float32 (4 x predict, 1 x predict_batch of 8,
     launch counters read around it) and one request cross-checked against
     the CPU; then one predict at edge.precision bf16;
  7. serving: the port's HTTP server (QualityControlSystem on the card, the
     shipped int8 profile) on 127.0.0.1 in a thread; 4 frames one by one to
     /api/detect (the first a committed JPEG of frame 0 where libjpeg is
     present, the rest PNG), a batch of 8 to /api/detect/batch, one frame to
     /api/detect/base64 and the 4 frames again concurrently; every answer
     held equal to predict of the same decoded frame, the concurrent ones to
     the sequential ones; then predict(include_segmentation=False) and
     predict_stream(micro_batch=4) once each, with the kernels' launch
     counters read around each;
  8. networks: YOLOv8n at [1|8,640,640,3] and ResNet-50 at [32|128|1,128,128,3]
     in float32 (cuDNN, TF32 off), bfloat16 (cuDNN) and int8 (im2col and
     torch._int_mm), ms by CUDA events, and the kernels each int8 forward
     launches (torch.profiler);
  9. options and entry points, on the shipped checkpoints at 640^2: the int8
     detector with denoise and enhance_contrast, then with the v1 YOLO walk
     (yolo_int8_stream false), then with weight-only int8 YOLO (yolo_int8
     false), then pruned (sparsity 0.5, structured), each held against the
     same detector on the CPU serving the card's quantized networks;
     YOLODetector.predict and batch_predict of 8, ResNetClassifier.predict,
     predict_batch of 8 and extract_features, ImageSegmentator.segment_defects
     and segment_batch of 8, each against the CPU; the morphology kernels
     against their plain versions at the segmentator's ROI batches (32 and
     256 ROIs); the bilateral filter and CLAHE timed at [1|8,640,640,3];
     the kernels' launch counters read around every path;
 10. captured and exported: every device entry point runs as a CUDA graph per
     input signature (iqc_tpu_torch/ops/jit_utils.py), so every phase above
     already replayed graphs. Here predict and predict_batch of 8, replayed,
     against the same FullForward called eagerly on the same frames at int8,
     fp32 and bf16; thresholds and fusion weights changed by update_config
     between replays (no new capture); capture seconds per signature and the
     graphs cached; int8 predict wall ms and its torch.profiler kernels,
     device ms and idle share, captured and eager; K1-K3 launches through
     replays against one eager call's; the int8 predictor exported at batch
     1 on the card (torch.export, iqc_tpu_torch/models/export.py), reloaded
     and held against live run; K1's guard regions at run-time thresholds
     0.3, 0.45 and 0.7;
 11. training: `python -m iqc_tpu_torch.train.train_yolo --synthetic --epochs 1
     --config <the yolo_config.yaml profile as JSON>` in a process of its own
     (YOLOv8n 640^2, batch 16, bfloat16, device mosaic 1.0 and the
     augmentation block, class weights; 16 steps on the device corpus, then
     validation through K1 at [16,100,4]), its checkpoint in a temporary
     directory, served by YOLODetector card against CPU; train-step ms and
     images/s at bf16 and fp32 (median of 10 after 3), one profiled step
     (kernels, device ms, idle share), peak memory, validation ms per batch;
     two float32 steps and one bf16 step at batch 2 card against CPU from the
     same state and draws; K1 at [16,100,4] and [16,84,4], threshold 0.6,
     between guard regions, with its device, wrapper, plain and bound ms;
 12. classifier training: an image-folder tree (train/val/test, 48/16/16
     images per class) rendered at 256^2 by the port's MVTecStyleRenderer
     and written by its PNG writer into a temporary directory; `python -m
     iqc_tpu_torch.train.train_resnet --data-dir <tree> --epochs 1 --config
     <the resnet_config.yaml profile as JSON>` in a process of its own
     (ResNet-50 224^2, batch 32, bfloat16, Adam + cosine, the augmentation
     block, class weights, balanced sampling, the device-corpus tier), its
     final checkpoint served by ResNetClassifier card against CPU; train-step
     ms and images/s at bf16 and fp32 (median of 10 after 3), one profiled
     step (kernels, device ms, idle share), peak memory, evaluate ms per
     batch of 32; two float32 steps at batch 4 card against CPU from the
     same state and draws; K1-K3's launch counters around the phase (none).
 13. multi-device: `python -m torch.distributed.run --standalone
     --nproc-per-node N chip_smoke.py --multi-device-rank DIR` with N =
     min(cards, 4), under a deadline (its process group killed whole past
     it; each rank's NCCL group times out a hung collective). Each rank first runs the
     unsharded references on its card (no group yet: a mesh of 1), then joins
     the NCCL group and holds the sharded path against them: shard_batch,
     replicate, cross_replica_mean and the row gather exactly; a train-mode
     BatchNorm on flat and textured halves (global statistics and their
     gradient) and the YOLO loss's normaliser; two sharded YOLOv8n steps at
     640^2 (global batch 8, fp32, the shipped checkpoint, the profile's
     augmentation draws cut per rank) and one ResNet-50 step at 224^2 against
     the plain ones; sharded validation through K1; run_sharded and
     run_full_sharded of 8 frames at the shipped int8/bf16 profile against
     run and run_full_host (decisions equal, boxes within 1 px, scores 1e-3,
     masks on 99.9% of pixels); K1-K3's launch counters around the sharded
     work; the ranks' states bitwise equal; the sharded bf16 step's ms and
     images/s at global batch 16 against one card. Then K1-K3 at the
     per-rank shapes against their plain versions. `--only-multi-device`
     runs phases 1, 2 and 13 alone (a host with several cards).
Then one JSON line of kernel measurements, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits nonzero without that line.
Needs one CUDA device; exits nonzero at once without one.
"""

import base64
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))

# peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores; a 32-bit integer word
# operation is counted at the float32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# dense tensor-core peaks of the same card: bfloat16 FLOP/s and int8 OP/s
PEAK_OPS_PER_S = {"fp32": FP32_OPS_PER_S, "bf16": 989e12, "int8": 1979e12}

CONF_FALLBACKS = (0.7, 0.5, 0.3)
MASK_AGREEMENT = 0.999
# frame 0 (defect_image(0)) as a JPEG of quality 90, for the JPEG decode path
JPEG_FRAME = os.path.join(REPO, "tests", "data", "defect_frame_0.jpg")


class PhaseFailed(Exception):
    pass


class Phase:
    """Prints the phase's wall time; a watchdog ends the process when the
    phase outlives its deadline (also when stuck inside a CUDA call)."""

    def __init__(self, name: str, deadline_s: float):
        self.name, self.deadline_s = name, deadline_s

    def _expire(self):
        print(f"FAIL: phase {self.name} exceeded its {self.deadline_s:.0f} s deadline", flush=True)
        os._exit(3)

    def __enter__(self):
        print(f"== phase {self.name} (deadline {self.deadline_s:.0f} s)", flush=True)
        self.t0 = time.perf_counter()
        self.timer = threading.Timer(self.deadline_s, self._expire)
        self.timer.daemon = True
        self.timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.timer.cancel()
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        print(f"== phase {self.name}: {status}, {time.perf_counter() - self.t0:.2f} s wall",
              flush=True)
        return False


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def run_cmd(cmd, timeout):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    return (out.stdout + out.stderr).strip()


def cuda_time_ms(fn, warmup=5, iters=50):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- inputs --------------------------------------------------------------------


def defect_image(seed: int, size: int = 640):
    """A seeded synthetic 640^2 part: a textured grey surface with a few
    dark scratches, bright contamination spots and a discoloured patch."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(140, 200)
    img = base + rng.normal(0, 6, (size, size, 3))
    for _ in range(rng.integers(1, 4)):
        y, x = rng.integers(40, size - 160, 2)
        h, w = (rng.integers(6, 14), rng.integers(60, 150))
        if rng.random() < 0.5:
            h, w = w, h
        img[y:y + h, x:x + w] = rng.integers(10, 50)
    for _ in range(rng.integers(0, 3)):
        cy, cx = rng.integers(60, size - 60, 2)
        r = rng.integers(12, 35)
        yy, xx = np.ogrid[:size, :size]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(220, 255)
    if rng.random() < 0.5:
        y, x = rng.integers(40, size - 140, 2)
        img[y:y + 90, x:x + 90] *= 0.7
    return np.clip(img, 0, 255).astype(np.uint8)


def nms_inputs(torch, device, batch=8, k=300):
    """Score-sorted, class-offset boxes [batch,k,4]: random boxes, an
    overlap chain deeper than the 16 rounds, IoU-threshold ties, zero-area
    pads."""
    import numpy as np

    rng = np.random.default_rng(123)
    out = []
    for b in range(batch):
        cx, cy = rng.uniform(20, 620, k), rng.uniform(20, 620, k)
        w, h = rng.uniform(8, 90, k), rng.uniform(8, 90, k)
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        x = np.arange(40) * 2.0 + 10 * b              # chain: IoU 2/3 with the next
        boxes[:40] = np.stack([x, np.zeros(40), x + 10, np.full(40, 10.0)], -1)
        boxes[40:44] = [[0, 300, 10, 310], [0, 300, 10, 305],   # IoU exactly 0.5
                        [50, 300, 60, 310], [50, 300, 60, 305]]
        boxes[-8:] = 0.0                              # zero-area pads
        cls = rng.integers(0, 5, k)
        cls[:44] = 0
        out.append(boxes + cls[:, None] * 1e5)
    return torch.tensor(np.stack(out), dtype=torch.float32, device=device)


def morph_inputs(torch, device, n=64, r=128):
    """The segmentation pre-pass outputs for n synthetic ROIs: raw Otsu
    masks, region seeds and the growth predicate."""
    import numpy as np

    from iqc_tpu_torch.ops import image as imops
    from iqc_tpu_torch.ops import segmentation as seg

    rng = np.random.default_rng(7)
    rois = np.full((n, r, r), 0.7, np.float32) + rng.normal(0, 0.03, (n, r, r))
    yy, xx = np.mgrid[:r, :r]
    for i in range(n):
        cy, cx = rng.integers(r // 4, 3 * r // 4, 2)
        rad = rng.integers(r // 12, r // 3)
        rois[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad] = 0.25 if i % 2 else 0.95
    rois = torch.tensor(np.clip(rois, 0, 1), dtype=torch.float32, device=device)
    cid = torch.tensor(np.arange(n) % 5, device=device)
    dark = seg.table_lookup(seg.CLASS_IS_DARK, cid)
    adjust = seg.table_lookup(seg.CLASS_THRESH_ADJUST, cid)
    blurred = imops.gaussian_blur(rois, 1.0)
    m_raw = seg._threshold_pre(rois, adjust, dark, blurred)
    seeds, allow, _ = seg._region_pre(rois, dark, blurred)
    return m_raw.contiguous(), seeds.contiguous(), allow.contiguous()


# -- phases ----------------------------------------------------------------------


def n_regions(result) -> int:
    """Detections of a final result that carry a non-empty segmentation."""
    return sum(1 for d in result.get("detections", [])
               if d.get("has_segmentation") and d.get("area_pixels", 0) > 0)


def phase_environment(torch):
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, cudnn {torch.backends.cudnn.version()}")
    from iqc_tpu_torch.build import nvcc_path

    nvcc = nvcc_path()
    print(f"nvcc {nvcc}: {run_cmd([nvcc, '--version'], 60).splitlines()[-1]}")
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], 60)
    print(f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    return smi.splitlines()[0].strip()


def phase_build():
    from iqc_tpu_torch import build

    lib = build.library()
    print(f"built {os.path.relpath(lib.path, REPO)} in {lib.build_seconds:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")


# (label, images for K1, ROIs for K2; K3 cleans one more): one predict, and
# predict_batch of 8 on the seg pool of 64
SHAPES = (("request", 1, 16), ("batch", 8, 64))
THRESHOLD, ROUNDS, GROW, FILL = 0.5, 16, 24, 16


def graph_ms(torch, launch, iters=50, replays=5):
    """Device time of one launch with no host cost: `iters` launches captured
    in a CUDA graph, replayed between two events; the median of `replays`
    replays, over `iters`."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[replays // 2]


def profiler_ms(torch, fn, kernel, iters=20):
    """Per-launch device time of the CUDA kernels whose name holds `kernel`,
    from torch.profiler over `iters` calls of fn; None where the profiler
    records no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if kernel in e.key:
                total += getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                count += e.count
    except Exception as e:  # the profiler is an optional second opinion
        print(f"profiler: {type(e).__name__}: {e}")
        return None
    return total / count / 1e3 if count and total > 0 else None


def suppress_rounds(torch, boxes, iterations, threshold=THRESHOLD):
    """Rounds each image runs with the early exit: up to the first round that
    changes nothing, at most `iterations` (from the plain iteration)."""
    from iqc_tpu_torch.ops.boxes import iou_matrix

    k = boxes.shape[1]
    idx = torch.arange(k, device=boxes.device)
    t = torch.tensor(threshold, dtype=torch.float32, device=boxes.device)
    overlap = (iou_matrix(boxes, boxes) > t) & (idx[:, None] < idx[None, :])
    keep = torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    rounds = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
    done = torch.zeros(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    for _ in range(iterations):
        new = ~torch.any(overlap & keep[..., :, None], dim=-2)
        rounds += (~done).long()
        done |= (new == keep).all(-1)
        keep = new
    return rounds.tolist()


def kernel_cases(torch, dev, images, rois, cdll=None):
    """K1-K3 at one shape: for each, its wrapper call, a launch of its raw
    entry point (from `cdll`, by default the port's library) into the
    output `out` allocated beforehand, its plain version, and the bytes and
    operations of its bound."""
    from iqc_tpu_torch import build
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    cdll = cdll or build.library().cdll

    def raw(fn, *args):
        """A launch of entry point fn; tensors among args pass as their data
        pointers, and the launch keeps them alive."""
        values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

        def launch():
            err = fn(*values, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{fn.__name__} failed with CUDA error {err}")
        launch.tensors = args
        return launch

    boxes = nms_inputs(torch, dev, batch=images)
    b, k = boxes.shape[:2]
    words = (k + 31) // 32
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    # the IoU threshold as the forward gives it: a 0-d float32 tensor on the card
    thr = torch.tensor(THRESHOLD, dtype=torch.float32, device=dev)
    rounds = suppress_rounds(torch, boxes, ROUNDS)
    cases = [dict(
        name="suppress", kernel="suppress_kernel", shape=f"[{b},{k},4]",
        wrapper=lambda: nms_kernel.suppress(boxes, thr, ROUNDS),
        raw=raw(cdll.iqc_suppress, boxes, thr, keep, b, k, ROUNDS),
        out=keep,
        plain=lambda: nms_kernel.suppress_plain(boxes, thr, ROUNDS),
        # 14 float operations per pair; 2 word operations per candidate and
        # bitmask word in each round that this data runs
        n_bytes=boxes.numel() * 4 + 4 + b * k,
        n_ops=b * (k * (k - 1) // 2) * 14 + sum(rounds) * k * words * 2,
        note=f"rounds {rounds}")]

    m_raw, seeds, allow = morph_inputs(torch, dev, n=rois)
    seeds, allow = seeds.clone(), allow.clone()  # fresh, so 16-byte aligned for the raw launch
    n, r = seeds.shape[:2]
    out = torch.empty_like(seeds)
    # 10 word operations per 32-pixel word and step, counted for every
    # round; the early exits run fewer, but the byte time exceeds even this
    # count, so it is the bound either way
    cases.append(dict(
        name="grow_clean", kernel="morph_kernel", shape=f"[{n},{r},{r}]",
        wrapper=lambda: morph_kernel.grow_clean(seeds, allow, GROW, FILL),
        raw=raw(cdll.iqc_grow_clean, seeds, allow, out, n, r, GROW, FILL),
        out=out,
        plain=lambda: morph_kernel.grow_clean_plain(seeds, allow, GROW, FILL),
        n_bytes=3 * n * r * r, n_ops=n * r * r // 32 * (GROW + 27) * 10, note=""))
    # on the main path the all-ones ROI of the watershed method rides along
    masks = torch.cat([m_raw, torch.ones_like(m_raw[:1])])
    out1 = torch.empty_like(masks)
    cases.append(dict(
        name="clean", kernel="morph_kernel", shape=f"[{n + 1},{r},{r}]",
        wrapper=lambda: morph_kernel.clean(masks, FILL),
        raw=raw(cdll.iqc_clean, masks, out1, n + 1, r, FILL),
        out=out1,
        plain=lambda: morph_kernel.clean_plain(masks, FILL),
        n_bytes=2 * (n + 1) * r * r, n_ops=(n + 1) * r * r // 32 * 27 * 10, note=""))
    return cases


def max_err(torch, got, want):
    torch.cuda.synchronize()
    return (got.int() - want.int()).abs().max().item()


def early_exit_cases(torch, dev):
    """Equality on inputs that end the kernels' loops early or never: an
    image whose keep settles in 2 rounds (pairs of equal boxes), the 40-deep
    chain that still runs all 16 rounds, a ROI whose growth stops after 8
    rounds (one seed in a 9 x 9 square) and an all-ones ROI."""
    import numpy as np

    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    i = np.arange(300) // 2
    x, y = (i % 20) * 30.0, (i // 20) * 30.0
    pairs = torch.tensor(np.stack([x, y, x + 20, y + 20], -1)[None], dtype=torch.float32,
                         device=dev)
    chain = nms_inputs(torch, dev, batch=1)
    for name, boxes, want_rounds in (("pairs", pairs, 2), ("chain", chain, ROUNDS)):
        rounds = suppress_rounds(torch, boxes, ROUNDS)
        check(rounds == [want_rounds], f"{name}: the plain iteration settles in {rounds} rounds")
        err = max_err(torch, nms_kernel.suppress(boxes, THRESHOLD, ROUNDS),
                      nms_kernel.suppress_plain(boxes, THRESHOLD, ROUNDS))
        check(err == 0, f"suppress differs from its plain version on {name}")
        print(f"suppress on {name}: settles after {rounds[0]} rounds, equal to plain")

    seeds = torch.zeros((2, 128, 128), dtype=torch.bool, device=dev)
    allow = torch.zeros_like(seeds)
    allow[0, 60:69, 60:69] = True
    seeds[0, 64, 64] = True
    seeds[1] = allow[1] = True
    for fill in (FILL, 0):
        err = max_err(torch, morph_kernel.grow_clean(seeds, allow, GROW, fill),
                      morph_kernel.grow_clean_plain(seeds, allow, GROW, fill))
        check(err == 0, f"grow_clean (fill {fill}) differs from its plain version on the "
                        "square and all-ones ROIs")
    err = max_err(torch, morph_kernel.clean(allow, FILL), morph_kernel.clean_plain(allow, FILL))
    check(err == 0, "clean differs from its plain version on the square and all-ones ROIs")
    print("grow_clean and clean on a ROI whose growth stops after 8 rounds and an all-ones "
          "ROI: equal to plain")


def phase_kernels(torch):
    dev = torch.device("cuda")
    sources = {"suppress": ("iqc_tpu_torch/csrc/suppress.cu", "iqc_tpu/ops/pallas_nms.py:34"),
               "grow_clean": ("iqc_tpu_torch/csrc/morph.cu", "iqc_tpu/ops/pallas_morph.py:146"),
               "clean": ("iqc_tpu_torch/csrc/morph.cu", "iqc_tpu/ops/pallas_morph.py:162")}
    rows = {}
    for label, images, rois in SHAPES:
        for c in kernel_cases(torch, dev, images, rois):
            got, want = c["wrapper"](), c["plain"]()
            err = max_err(torch, got, want)
            check(err == 0, f"{c['name']} {c['shape']} differs from its plain version on "
                            f"{int((got != want).sum())} elements")
            device_ms = graph_ms(torch, c["raw"])
            wrapper_ms = cuda_time_ms(c["wrapper"])
            plain_ms = cuda_time_ms(c["plain"], warmup=2, iters=10)
            prof_ms = profiler_ms(torch, c["wrapper"], c["kernel"])
            bound_ms, bound_by = bound(c["n_bytes"], c["n_ops"])
            print(f"{c['name']} {c['shape']} ({label}): equal to plain; device {device_ms:.5f} ms "
                  f"(profiler {'not measured' if prof_ms is None else f'{prof_ms:.5f} ms'}), "
                  f"wrapper {wrapper_ms:.5f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.7f} ms "
                  f"({bound_by}: {c['n_bytes']} bytes, {c['n_ops']} ops) {c['note']}")
            m = {"shape": c["shape"], "ms": device_ms, "wrapper_ms": wrapper_ms,
                 "profiler_ms": prof_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "max_abs_err": err}
            if label == "request":
                src, replaces = sources[c["name"]]
                rows[c["name"]] = {"name": c["name"], "route": "cuda", "source": src,
                                   "replaces": replaces, "counter": c["name"], **m,
                                   "library_ms": None}
            else:
                rows[c["name"]]["batch"] = m
    early_exit_cases(torch, dev)
    print("no single PyTorch call computes any of the three kernels' functions")
    return list(rows.values())


STREAM_MODE = "true-int8 MXU, int8-resident activations (streaming v2)"
FP32 = {"edge": {"precision": "fp32"}, "model": {"compute_dtype": "float32"}}
BF16 = {"edge": {"precision": "bf16"}, "model": {"compute_dtype": "bfloat16"}}


def build_detector(torch, overrides=None, label="int8", yolo_mode=STREAM_MODE):
    """QualityControlDetector on the card at the shipped profile with
    ``overrides``; checks the weights' source, the device and, at int8, the
    precision report (the ResNet streaming, the YOLO as ``yolo_mode``)."""
    from iqc_tpu_torch.config import SystemConfig
    from iqc_tpu_torch.inference.detector import QualityControlDetector

    t0 = time.perf_counter()
    config = SystemConfig.from_dict(overrides) if overrides else None
    det = QualityControlDetector(config=config, device="cuda")
    torch.cuda.synchronize()
    ens = det.ensemble_predictor
    src = ens.weights_source
    print(f"{label} detector built in {time.perf_counter() - t0:.2f} s, weights {src}")
    check(src == {"yolo": "checkpoint", "resnet": "checkpoint"}, f"weights not from checkpoints: {src}")
    check(det.device.type == "cuda" and ens.device.type == "cuda",
          f"the detector runs on {det.device}, not the card")
    m = det.config.model
    print(f"profile: input {det.config.processing.input_size}, YOLOv8 width {m.width_mult} "
          f"depth {m.depth_mult}, ResNet stages {m.resnet_stages} on {m.classifier_input}^2 crops, "
          f"max_detections {m.max_detections}, max_classified {m.max_classified}, crop pool "
          f"{m.max_classified_pool}, seg pool {m.max_segmented_pool}, roi {m.seg_roi_size}, "
          f"compute {m.compute_dtype}, precision {det.config.edge.precision}")
    report = ens.precision_report
    if det.config.edge.precision == "int8":
        check(report is not None and report["precision"] == "int8",
              f"int8 profile without an int8 report: {report}")
        check(report["yolo"] == yolo_mode and report["resnet"] == STREAM_MODE,
              f"not the expected walks: {report}")
        check(ens.calibration_seconds is not None and ens.calibration_seconds > 0,
              "no calibration ran")
        print(f"calibration (quantize + calibrate both networks on the card): "
              f"{ens.calibration_seconds:.3f} s; precision report {report}")
    else:
        check(report is None, f"{label}: unexpected precision report {report}")
    return det


def request_profile(torch, det, image, predict=None):
    """One predict (``predict``, by default ``det.predict``, also
    ``predict_batch`` of a list) under torch.profiler: (wall ms, device
    kernels, their summed device ms). The device is idle for the rest of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        r = (predict or det.predict)(image)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    check("error" not in (r[0] if isinstance(r, list) else r), "the profiled call failed")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return wall, len(kernels), busy


def phase_main_path(torch, images, det):
    m = det.config.model
    label = det.config.edge.precision

    reset_launches()
    results = []
    conf_used = m.confidence_threshold
    for i, img in enumerate(images[:4]):
        t = time.perf_counter()
        r = det.predict(img)
        print(f"predict {i}: {(time.perf_counter() - t) * 1e3:.1f} ms, "
              f"{len(r.get('detections', []))} detections, {n_regions(r)} segmented, "
              f"grade {r.get('quality_assessment', {}).get('quality_grade')}, "
              f"stages {r.get('stage_times_ms')}")
        results.append(r)
    t = time.perf_counter()
    batch = det.predict_batch(images[:8])
    print(f"predict_batch 8: {(time.perf_counter() - t) * 1e3:.1f} ms, detections "
          f"{[len(r.get('detections', [])) for r in batch]}")
    results += batch

    if not any(n_regions(r) for r in results):
        for conf in CONF_FALLBACKS[1:]:
            det.ensemble_predictor.confidence_threshold = conf
            conf_used = conf
            r = det.predict(images[0])
            print(f"confidence_threshold lowered to {conf} for one request: "
                  f"{len(r.get('detections', []))} detections")
            results.append(r)
            if n_regions(r):
                break
    launches = read_launches()
    print(f"launches on the {label} main path: {launches}")
    errors = [r["error"] for r in results if "error" in r]
    check(not errors, f"requests failed: {errors[:3]}")
    check(any(n_regions(r) for r in results), "no request produced detections with regions")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    print(f"performance: {det.get_performance_stats()}")
    wall, n, busy = request_profile(torch, det, images[1])
    print(f"{label} predict under torch.profiler: {wall:.2f} ms wall, {n} kernels, "
          f"{busy:.3f} ms of device time, device idle {100 * (1 - busy / wall):.1f}% of it")
    return det, launches, conf_used


def phase_cross_check(torch, det_gpu, image, conf):
    import numpy as np

    from iqc_tpu_torch.inference.detector import QualityControlDetector

    det_cpu = QualityControlDetector(config=det_gpu.config, device="cpu")
    outs = []
    for det in (det_gpu, det_cpu):
        det.ensemble_predictor.confidence_threshold = conf
        x = det._preprocess(det._upload(image)[None])
        outs.append(det.ensemble_predictor.run_full_host(x))
    (g, gm, gs), (c, cm, cs) = outs
    check(np.array_equal(g.valid, c.valid), "valid slots differ between card and CPU")
    v = c.valid
    for f in ("classes", "yolo_severity", "crop_class", "crop_severity", "final_severity"):
        check(np.array_equal(getattr(g, f)[v], getattr(c, f)[v]), f"{f} differs")
    check(np.array_equal(g.severity_counts, c.severity_counts), "severity counts differ")
    box_err = float(np.abs(g.boxes[v] - c.boxes[v]).max()) if v.any() else 0.0
    check(box_err <= 1e-2, f"boxes differ by {box_err} px")
    for f in ("yolo_scores", "crop_conf", "ensemble_conf"):
        a, b = getattr(g, f)[v], getattr(c, f)[v]
        check(np.allclose(a, b, rtol=1e-4, atol=1e-6), f"{f} differs: {np.abs(a - b).max()}")
    check(np.allclose(g.global_probs, c.global_probs, rtol=1e-4, atol=1e-6), "global probs differ")
    agree = float(np.mean(gm == cm))
    check(agree >= MASK_AGREEMENT, f"masks agree on {agree:.6f} of pixels")
    check(np.array_equal(gs[..., 4], cs[..., 4]), "segmentation methods differ")
    rg = det_gpu.predict(image)
    rc = det_cpu.predict(image)
    for r in (rg, rc):
        check("error" not in r, f"request failed: {r.get('error')}")
    qa_g, qa_c = rg["quality_assessment"], rc["quality_assessment"]
    check(qa_g["quality_grade"] == qa_c["quality_grade"]
          and qa_g["pass_fail_status"] == qa_c["pass_fail_status"], "grades differ")
    check([d["class"] for d in rg["detections"]] == [d["class"] for d in rc["detections"]],
          "detected classes differ")
    print(f"card vs CPU at confidence {conf}: {int(v.sum())} detections, boxes within "
          f"{box_err:.2e} px, masks agree on {agree * 100:.4f}% of pixels, grade "
          f"{qa_g['quality_grade']} on both")


def check_preprocessing(torch, det_gpu, det_cpu, image, label):
    """The denoise and contrast steps on the card against the CPU: CLAHE
    bins its input, so a pixel whose filtered luma sits on a bin edge can
    take the next bin's mapping on one side. At most 0.1% of the values
    beyond 1e-5, each within 0.05. Returns the card's preprocessed frame."""
    x = det_gpu._preprocess(det_gpu._upload(image)[None])
    err = (x.cpu() - det_cpu._preprocess(det_cpu._upload(image)[None])).abs()
    share = float((err > 1e-5).float().mean())
    print(f"{label} preprocessing card vs CPU: {share * 100:.4f}% of values beyond 1e-5, "
          f"largest difference {float(err.max()):.3e}")
    check(share <= 1e-3 and float(err.max()) <= 0.05,
          f"{label}: preprocessing differs on {share} of values, by up to {float(err.max())}")
    return x


def phase_cross_check_int8(torch, det_gpu, image, conf, label="int8"):
    """One request on the card and on the CPU, the CPU serving the card's
    quantized networks and scales (no calibration there). With the denoise
    or contrast step on, both forwards take the card's preprocessed frame,
    and the preprocessing is held against the CPU's on its own."""
    import numpy as np

    from iqc_tpu_torch.inference.detector import QualityControlDetector

    ens = det_gpu.ensemble_predictor
    state = {"yolo": ens.yolo_vars, "resnet": ens.resnet_vars}
    det_cpu = QualityControlDetector(config=det_gpu.config, device="cpu", int8_state=state)
    check(det_cpu.ensemble_predictor.precision_report == ens.precision_report,
          "the CPU detector reports another precision")
    pre = det_gpu.config.processing.preprocessing
    shared = (check_preprocessing(torch, det_gpu, det_cpu, image, label)
              if pre.denoise or pre.enhance_contrast else None)
    outs = []
    for det in (det_gpu, det_cpu):
        det.ensemble_predictor.confidence_threshold = conf
        x = det._preprocess(det._upload(image)[None]) if shared is None else shared.to(det.device)
        outs.append(det.ensemble_predictor.run_full_host(x))
    (g, gm, gs), (c, cm, cs) = outs
    vg, vc = g.valid, c.valid
    print(f"{label} card vs CPU at confidence {conf}: {int(vg.sum())} detections on the card, "
          f"{int(vc.sum())} on the CPU")
    check(np.array_equal(vg, vc), "valid slots differ between card and CPU")
    v = vc
    box_err = float(np.abs(g.boxes[v] - c.boxes[v]).max()) if v.any() else 0.0
    score_err = float(np.abs(g.yolo_scores[v] - c.yolo_scores[v]).max()) if v.any() else 0.0
    conf_err = float(np.abs(g.crop_conf[v] - c.crop_conf[v]).max()) if v.any() else 0.0
    ens_err = float(np.abs(g.ensemble_conf[v] - c.ensemble_conf[v]).max()) if v.any() else 0.0
    prob_err = float(np.abs(g.global_probs - c.global_probs).max())
    agree = float(np.mean(gm == cm))
    print(f"{label} card vs CPU: boxes within {box_err:.3e} px, detector scores within "
          f"{score_err:.3e}, crop confidences within {conf_err:.3e}, ensemble confidences "
          f"within {ens_err:.3e}, global probabilities within {prob_err:.3e}, masks agree on "
          f"{agree * 100:.4f}% of pixels")
    for f in ("classes", "yolo_severity", "crop_class", "crop_severity", "final_severity"):
        check(np.array_equal(getattr(g, f)[v], getattr(c, f)[v]), f"int8 {f} differs")
    check(box_err <= 1.0, f"int8 boxes differ by {box_err} px")
    check(score_err <= 1e-3 and conf_err <= 1e-2 and ens_err <= 1e-2 and prob_err <= 1e-2,
          "int8 confidences differ beyond 1e-3 (scores) / 1e-2 (classifier)")
    check(agree >= 0.99, f"int8 masks agree on {agree:.6f} of pixels")
    rg, rc = det_gpu.predict(image), det_cpu.predict(image)
    for r in (rg, rc):
        check("error" not in r, f"request failed: {r.get('error')}")
    qa_g, qa_c = rg["quality_assessment"], rc["quality_assessment"]
    check(qa_g["quality_grade"] == qa_c["quality_grade"]
          and qa_g["pass_fail_status"] == qa_c["pass_fail_status"], "int8 grades differ")
    print(f"{label} grade {qa_g['quality_grade']} / {qa_g['pass_fail_status']} on both")
    if label == "int8":
        x = det_gpu._preprocess(det_gpu._upload(image)[None])
        return int8_resnet_layer_diff(torch, ens, det_cpu.ensemble_predictor, x, g.boxes[0],
                                      c.boxes[0])
    return None


def _layer_rows(torch, got, want):
    """Per traced layer: elements that differ and the largest difference
    (codes and accumulators as integers), card against CPU."""
    rows = []
    for (name, a), (name_b, b) in zip(got, want):
        check(name == name_b and a.shape == b.shape, f"traces part at {name} / {name_b}")
        a = a.detach().cpu()
        if a.dtype in (torch.int8, torch.int32):
            d = (a.long() - b.long()).abs()
        else:
            d = (a.float() - b.float()).abs()
        rows.append({"layer": name, "dtype": str(a.dtype).replace("torch.", ""),
                     "n_diff": int((d > 0).sum()), "n": a.numel(), "max_diff": float(d.max()),
                     "max_abs": float(b.float().abs().max())})
    return rows


def int8_resnet_layer_diff(torch, ens_g, ens_c, x_g, boxes_g, boxes_c):
    """The int8 ResNet (streaming walk) on crops of the request's boxes, card
    against CPU layer by layer: on the same crops (the card's), on each
    device's crops of the card's boxes, and on each device's crops of its
    own boxes (the served path). Prints and returns, for each, the first
    layer where the two part and by how much."""
    from iqc_tpu_torch.models import resnet_int8_stream
    from iqc_tpu_torch.ops import image as imops

    fwd_g, fwd_c = ens_g.full_forward, ens_c.full_forward
    check(getattr(fwd_g.resnet, "stream", False), "the int8 ResNet is not the streaming walk")
    kc, ci = fwd_g.max_classified, fwd_g.classifier_input
    x_c = x_g.cpu()

    def crops(fwd, x, boxes):
        b = torch.as_tensor(boxes[:kc])[None].to(x.device)
        c = imops.crop_and_resize(x, b, (ci, ci), fwd.compute_dtype)
        return imops.normalize_imagenet(c.reshape(kc, ci, ci, 3))

    def walk(fwd, crops_):
        trace = []
        r = fwd.resnet
        resnet_int8_stream.apply(r.q, crops_, r.scales, r.stage_sizes, trace=trace)
        return [(n, t.cpu()) for n, t in trace]

    with torch.inference_mode():
        card_crops = crops(fwd_g, x_g, boxes_g)
        card = walk(fwd_g, card_crops)
        inputs = {"same_crops": card_crops.cpu(), "same_boxes": crops(fwd_c, x_c, boxes_g),
                  "own_boxes": crops(fwd_c, x_c, boxes_c)}
        rows = {k: _layer_rows(torch, card, walk(fwd_c, v)) for k, v in inputs.items()}
    box_err = float(abs(boxes_g[:kc] - boxes_c[:kc]).max())
    out = {"crops": kc, "boxes_max_abs_err_px": box_err}
    for key, r in rows.items():
        first = next((row for row in r if row["n_diff"]), None)
        out[key] = {"crops_max_abs_err": float((inputs[key] - card_crops.cpu()).abs().max()),
                    "first_diff": first, "logits_max_abs_err": r[-1]["max_diff"],
                    "layers_differing": sum(1 for row in r if row["n_diff"]),
                    "layers": len(r)}
        where = ("no layer differs" if first is None else
                 f"first differs at {first['layer']} ({first['dtype']}): {first['n_diff']} of "
                 f"{first['n']} elements, by up to {first['max_diff']:.4g} (values up to "
                 f"{first['max_abs']:.4g})")
        print(f"int8 ResNet card vs CPU, {key.replace('_', ' ')} ({kc} crops; crops within "
              f"{out[key]['crops_max_abs_err']:.3e}): {where}; "
              f"{out[key]['layers_differing']} of {len(r)} traced tensors differ; logits "
              f"within {r[-1]['max_diff']:.3e}")
    print(f"the request's boxes, card vs CPU: within {box_err:.3e} px")
    return out


def phase_fp32_bf16(torch, images, conf):
    """The float32 profile: its main path, launches and the card-vs-CPU
    cross-check; then one predict at edge.precision bf16."""
    det = build_detector(torch, FP32, "fp32")
    _, launches, conf32 = phase_main_path(torch, images, det)
    phase_cross_check(torch, det, images[0], conf32)
    det16 = build_detector(torch, BF16, "bf16")
    check(det16.ensemble_predictor.yolo.compute_dtype == torch.bfloat16, "bf16 YOLO is not bf16")
    det16.ensemble_predictor.confidence_threshold = conf
    r = det16.predict(images[0])
    check("error" not in r, f"bf16 predict failed: {r.get('error')}")
    r = det16.predict(images[1])
    print(f"bf16 predict: {r['total_inference_time_ms']:.1f} ms (second call), "
          f"{len(r['detections'])} detections, grade {r['quality_assessment']['quality_grade']}")
    return det, det16, launches


def png_bytes(img) -> bytes:
    """An 8-bit RGB PNG of ``img`` (filter type 0 on every row)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def multipart(name, files):
    """A multipart/form-data body of (filename, bytes) files under ``name``."""
    boundary = "iqcsmokeboundary"
    parts = []
    for filename, data in files:
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                     f'filename="{filename}"\r\n\r\n'.encode() + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def http_post(port, path, body, content_type):
    """POST to the local server; (wall ms, status, parsed JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": content_type}, method="POST")
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return (time.perf_counter() - t) * 1e3, status, json.loads(raw)


def summary(result):
    """What an answer must share with predict of the same frame."""
    qa = result.get("quality_assessment", {})
    return {"detections": [(d["class"], d["final_severity"], d["bbox"]["x1"], d["bbox"]["y1"],
                            d["bbox"]["x2"], d["bbox"]["y2"]) for d in result["detections"]],
            "confidences": [d["ensemble_confidence"] for d in result["detections"]],
            "grade": (qa.get("quality_grade"), qa.get("pass_fail_status"))}


def check_same(got, want, what):
    g, w = summary(got), summary(want)
    check(g["detections"] == w["detections"] and g["grade"] == w["grade"],
          f"{what}: {g['detections'][:3]} {g['grade']} differ from {w['detections'][:3]} {w['grade']}")
    for a, b in zip(g["confidences"], w["confidences"]):
        check(abs(a - b) <= 1e-5 * max(abs(b), 1e-6), f"{what}: confidence {a} differs from {b}")


def reset_launches():
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    for d in (nms_kernel.LAUNCHES, morph_kernel.LAUNCHES):
        for key in d:
            d[key] = 0


def read_launches():
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    return {**nms_kernel.LAUNCHES, **morph_kernel.LAUNCHES}


def thread_split(det, image, n=3):
    """predict's ms when its body runs on the calling thread (the main
    thread; a fresh thread per call, as a threaded HTTP server calls) and
    when predict hands it to the detector's long-lived thread from a fresh
    thread per call."""
    def timed(fn, out):
        r = fn(image, True)
        out.append((r["total_inference_time_ms"], r["stage_times_ms"]))

    def fresh(fn):
        out = []
        for _ in range(n):
            th = threading.Thread(target=timed, args=(fn, out))
            th.start()
            th.join(timeout=120)
            check(not th.is_alive(), "predict in a fresh thread did not finish")
        return out

    main = []
    for _ in range(n):
        timed(det._predict, main)
    for label, runs in (("the body on the main thread", main),
                        ("the body on a fresh thread per call", fresh(det._predict)),
                        ("predict from a fresh thread per call", fresh(det.predict))):
        print(f"{label}: " + "; ".join(f"{ms:.2f} ms {st}" for ms, st in runs))


def phase_serving(torch, images, conf):
    import numpy as np

    from iqc_tpu_torch.runtime import codec, native
    from iqc_tpu_torch.serving.app import QualityControlSystem, _decode_image, create_app
    from iqc_tpu_torch.serving.wsgi import serve

    def tool(*cmd):
        found = shutil.which(cmd[0]) or (os.path.exists(f"/sbin/{cmd[0]}") and f"/sbin/{cmd[0]}")
        return run_cmd([found, *cmd[1:]], 60) if found else f"{cmd[0]} not found"

    libjpeg = [ln.split(" => ")[-1] for ln in tool("ldconfig", "-p").splitlines()
               if "libjpeg.so" in ln]
    print(f"jpeglib.h: {os.path.exists('/usr/include/jpeglib.h')}; libjpeg in ldconfig: "
          f"{libjpeg}; g++: {tool('g++', '--version').splitlines()[0]}")
    print(f"native runtime: {native.native_available()}, native JPEG decoder: "
          f"{native.jpeg_available()}")

    t0 = time.perf_counter()
    system = QualityControlSystem(device="cuda")
    check(system.initialize_models(), "initialize_models failed: the system is in demo mode")
    det = system.detector
    check(det.device.type == "cuda", f"the detector runs on {det.device}, not the card")
    report = det.ensemble_predictor.precision_report
    check(det.config.edge.precision == "int8" and report is not None
          and report["yolo"] == report["resnet"] == STREAM_MODE,
          f"the server does not serve the shipped int8 profile: {report}")
    det.update_config({"model": {"confidence_threshold": conf}})
    print(f"QualityControlSystem on {det.device} in {time.perf_counter() - t0:.2f} s, "
          f"confidence threshold {conf}")

    pngs = [png_bytes(img) for img in images]
    first = ("frame0.png", pngs[0])
    if native.jpeg_available():
        with open(JPEG_FRAME, "rb") as f:
            first = ("frame0.jpg", f.read())
        jpeg = codec.decode_image(first[1], 640)
        err = float(np.abs(jpeg.astype(np.int32) - images[0]).mean())
        check(jpeg.shape == images[0].shape and err < 6, f"the JPEG of frame 0 decodes {err} off")
        print(f"JPEG of frame 0: {len(first[1])} bytes, decoded {jpeg.shape}, mean |diff| to "
              f"the seeded frame {err:.3f}")
    singles = [first] + [(f"frame{i}.png", pngs[i]) for i in (1, 2, 3)]
    decoded = [_decode_image(data) for _, data in singles]
    check(all(d is not None for d in decoded), "a payload did not decode")
    decode_ms = []
    for _, data in singles:
        t = time.perf_counter()
        _decode_image(data)
        decode_ms.append((time.perf_counter() - t) * 1e3)
    # the answers each HTTP request must give, computed before the counted run
    direct = [det.predict(img) for img in decoded]
    want_batch = det.predict_batch(images[:8])
    want_b64 = det.predict(images[4])
    for r in direct + want_batch + [want_b64]:
        check("error" not in r, f"predict failed: {r.get('error')}")
    thread_split(det, decoded[1])

    app = create_app(system, initialize=False)
    server = serve(app, host="127.0.0.1", port=0, background=True)
    port = server.server_address[1]
    print(f"serving on 127.0.0.1:{port}")
    try:
        reset_launches()
        sequential, splits = [], []
        for i, (name, data) in enumerate(singles):
            body, ctype = multipart("image", [(name, data)])
            wall, status, r = http_post(port, "/api/detect", body, ctype)
            check(status == 200, f"/api/detect {name}: {status} {r.get('error')}")
            check_same(r, direct[i], f"/api/detect {name}")
            pred = r["total_inference_time_ms"]
            splits.append((wall, decode_ms[i], pred, wall - decode_ms[i] - pred,
                           r["stage_times_ms"]))
            sequential.append(r)
        per_request = {k: v / len(singles) for k, v in read_launches().items()}
        for (wall, dec, pred, rest, stages), (name, data) in zip(splits, singles):
            print(f"/api/detect {name} ({len(data)} bytes): {wall:.2f} ms wall = decode "
                  f"{dec:.2f} + predict {pred:.2f} + rest {rest:.2f}; predict stages {stages}")
        print(f"launches per /api/detect request: {per_request}")

        before = read_launches()
        body, ctype = multipart("images", [(f"b{i}.png", p) for i, p in enumerate(pngs[:8])])
        wall, status, r = http_post(port, "/api/detect/batch", body, ctype)
        batch_launches = {k: v - before[k] for k, v in read_launches().items()}
        check(status == 200 and r["total_processed"] == 8, f"/api/detect/batch: {status}")
        for i, (res, w) in enumerate(zip(r["batch_results"], want_batch)):
            check("error" not in res, f"batch result {i}: {res.get('error')}")
            check_same(res, w, f"/api/detect/batch frame {i}")
        print(f"/api/detect/batch of 8: {wall:.2f} ms wall, launches {batch_launches}, detections "
              f"{[len(x['detections']) for x in r['batch_results']]}")

        body = json.dumps({"image": base64.b64encode(pngs[4]).decode()}).encode()
        wall, status, r = http_post(port, "/api/detect/base64", body, "application/json")
        check(status == 200 and r.get("input_format") == "base64", f"/api/detect/base64: {status}")
        check_same(r, want_b64, "/api/detect/base64")
        print(f"/api/detect/base64: {wall:.2f} ms wall, predict {r['total_inference_time_ms']:.2f}")

        answers = [None] * len(singles)

        def post(i):
            body, ctype = multipart("image", [singles[i]])
            answers[i] = http_post(port, "/api/detect", body, ctype)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(singles))]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            check(not th.is_alive(), "a concurrent request did not finish")
        wall_all = (time.perf_counter() - t) * 1e3
        for i, ans in enumerate(answers):
            check(ans is not None and ans[1] == 200, f"concurrent request {i} failed: {ans}")
            check_same(ans[2], sequential[i], f"concurrent request {i}")
        print(f"4 concurrent /api/detect: {wall_all:.2f} ms for all, each "
              f"{[round(a[0], 2) for a in answers]} ms wall; equal to the sequential answers")
        launches = read_launches()
    finally:
        server.shutdown()
        server.server_close()
    print(f"launches in the serving run (4 + 1 batch + 1 base64 + 4 concurrent requests): "
          f"{launches}")
    check(all(v == 10 for v in launches.values()), f"kernel launches {launches}, not 10 each")

    reset_launches()
    r = det.predict(images[0], include_segmentation=False)
    check("error" not in r, f"predict without segmentation failed: {r.get('error')}")
    detection_only = read_launches()
    print(f"predict(include_segmentation=False): {len(r['detections'])} detections, stages "
          f"{r['stage_times_ms']}, launches {detection_only}")
    check(detection_only["suppress"] == 1 and detection_only["grow_clean"] == 0
          and detection_only["clean"] == 0, f"detection-only launches {detection_only}")
    reset_launches()
    stream = list(det.predict_stream(iter(images[:4]), micro_batch=4))
    check([x.get("stream_index") for x in stream] == [0, 1, 2, 3]
          and not any("error" in x for x in stream), "predict_stream failed")
    print(f"predict_stream(micro_batch=4): detections {[len(x['detections']) for x in stream]}, "
          f"launches {read_launches()}")
    return launches, per_request, detection_only


# (network, input shape): one request's YOLO, a batch of 8's; the crop pool
# of one request (dense: 32 >= 1 x 32 crops), the batch pool and the global
# branch of one request
NETWORK_SHAPES = (("yolo", (1, 640, 640, 3)), ("yolo", (8, 640, 640, 3)),
                  ("resnet", (32, 128, 128, 3)), ("resnet", (128, 128, 128, 3)),
                  ("resnet", (1, 128, 128, 3)))


def device_events_per_call(torch, fn):
    """(kernels, all device events) one call of fn puts on the card, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), len(events)


def forward_flops(torch, module, x):
    """Floating-point operations of one forward of a float module (2 per
    multiply-add of its convolutions and matrix products), counted by
    torch.utils.flop_counter."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        module(x)
    return counter.get_total_flops()


def phase_networks(torch, det8, det32, det16):
    """Each network alone in float32 (cuDNN, TF32 off), bfloat16 (cuDNN) and
    int8 (im2col + torch._int_mm): eager ms by CUDA events over 20 calls
    after 3 warm-up calls, device ms by replaying a CUDA graph of 3 calls
    (the median of 5 replays, over 3), the device kernels of one call, and
    the operations bound at each precision's peak rate (the float32
    forward's operation count, which the other two compute as well)."""
    dev = torch.device("cuda")
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on")
    nets = {"fp32": det32.ensemble_predictor, "bf16": det16.ensemble_predictor,
            "int8": det8.ensemble_predictor}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    with torch.inference_mode():
        for net, shape in NETWORK_SHAPES:
            if net == "yolo":
                x = torch.rand(shape, device=dev, generator=gen)
            else:
                x = torch.randn(shape, device=dev, generator=gen)
            flops = forward_flops(torch, getattr(nets["fp32"], net), x)
            row = {"network": net, "shape": list(shape), "gflop": flops / 1e9}
            for prec, ens in nets.items():
                module = getattr(ens, net)
                fn = lambda module=module: module(x)
                out = fn()
                outs = out if isinstance(out, tuple) else (out,)
                check(all(bool(torch.isfinite(o.float()).all()) for o in outs),
                      f"{net} {prec} {shape}: non-finite output")
                row[f"{prec}_ms"] = cuda_time_ms(fn, warmup=3, iters=20)
                row[f"{prec}_device_ms"] = graph_ms(torch, fn, iters=3, replays=5)
                row[f"{prec}_bound_ms"] = flops / PEAK_OPS_PER_S[prec] * 1e3
                row[f"{prec}_kernels"], row[f"{prec}_device_events"] = \
                    device_events_per_call(torch, fn)
            print(f"{net} {shape}, {row['gflop']:.2f} GFLOP: " + "; ".join(
                f"{p} {row[p + '_ms']:.3f} ms eager, {row[p + '_device_ms']:.3f} ms device, "
                f"bound {row[p + '_bound_ms']:.4f} ms, {row[p + '_kernels']} kernels"
                for p in nets))
            rows.append(row)
    return rows


# the serving options of phase 9: (label, config overrides, expected YOLO mode)
V1_MODE = "true-int8 MXU (static calibrated activations)"
OPTIONS = (
    ("denoise+contrast", {"processing": {"preprocessing": {"denoise": True,
                                                           "enhance_contrast": True}}},
     STREAM_MODE),
    ("v1 YOLO walk", {"edge": {"yolo_int8_stream": False}}, V1_MODE),
    ("weight-only int8 YOLO", {"edge": {"yolo_int8": False}}, "weight-only int8 storage"),
    ("pruned 0.5 structured", {"edge": {"sparsity": 0.5, "structured_pruning": True}},
     STREAM_MODE),
)
YOLO_CKPT = "models/yolov8n_qc_synthetic.msgpack"
RESNET_CKPT = "models/resnet50_qc_128.msgpack"


def same_detections(got, want, what, score_atol):
    """Classes and severities equal, pixel boxes within 1 px, confidences
    within ``score_atol``."""
    check([(d["class"], d["severity"]) for d in got] == [(d["class"], d["severity"]) for d in want],
          f"{what}: {[d['class'] for d in got]} differ from {[d['class'] for d in want]}")
    for a, b in zip(got, want):
        check(all(abs(a["bbox"][k] - b["bbox"][k]) <= 1 for k in ("x1", "y1", "x2", "y2")),
              f"{what}: boxes {a['bbox']} and {b['bbox']} differ")
        check(abs(a["confidence"] - b["confidence"]) <= score_atol,
              f"{what}: confidence {a['confidence']} and {b['confidence']} differ")


def preprocessing_times(torch):
    """Eager ms (CUDA events) and device ms (CUDA graph) of the bilateral
    filter and of CLAHE's contrast step, at one frame and a batch of 8."""
    from iqc_tpu_torch.ops import image as imops

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b in (1, 8):
        x = torch.rand((b, 640, 640, 3), device="cuda", generator=gen)
        for name, fn in (("bilateral_filter", imops.bilateral_filter),
                         ("enhance_contrast_rgb", imops.enhance_contrast_rgb)):
            call = lambda fn=fn: fn(x)
            check(bool(torch.isfinite(call()).all()), f"{name}: non-finite output")
            eager = cuda_time_ms(call, warmup=2, iters=10)
            device = graph_ms(torch, call, iters=2, replays=5)
            kernels, _ = device_events_per_call(torch, call)
            rows.append({"op": name, "shape": [b, 640, 640, 3], "eager_ms": eager,
                         "device_ms": device, "kernels": kernels})
            print(f"{name} [{b},640,640,3]: eager {eager:.3f} ms, device {device:.3f} ms, "
                  f"{kernels} kernels a call")
    return rows


def standalone_kernel_rows(torch):
    """K2 and K3 against their plain versions at the segmentator's ROI
    batches: one image (32 ROIs) and 8 images (256); K3 cleans one more."""
    dev = torch.device("cuda")
    rows = {}
    for rois in (32, 256):
        for c in kernel_cases(torch, dev, 1, rois)[1:]:
            got, want = c["wrapper"](), c["plain"]()
            err = max_err(torch, got, want)
            check(err == 0, f"{c['name']} {c['shape']} differs from its plain version")
            bound_ms, bound_by = bound(c["n_bytes"], c["n_ops"])
            m = {"shape": c["shape"], "ms": graph_ms(torch, c["raw"]),
                 "wrapper_ms": cuda_time_ms(c["wrapper"]),
                 "plain_ms": cuda_time_ms(c["plain"], warmup=2, iters=5),
                 "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
            print(f"{c['name']} {c['shape']} (segmentator): equal to plain; device "
                  f"{m['ms']:.5f} ms, wrapper {m['wrapper_ms']:.5f} ms, plain "
                  f"{m['plain_ms']:.4f} ms, bound {bound_ms:.7f} ms ({bound_by})")
            rows.setdefault(c["name"], []).append(m)
    return rows


def phase_options(torch, images, conf):
    """The int8 detector under each serving option, card against CPU."""
    launches = {}
    for label, overrides, yolo_mode in OPTIONS:
        det = build_detector(torch, overrides, label, yolo_mode)
        det.ensemble_predictor.confidence_threshold = conf
        reset_launches()
        times = []
        for img in images[:3]:
            t = time.perf_counter()
            r = det.predict(img)
            times.append((time.perf_counter() - t) * 1e3)
            check("error" not in r, f"{label}: predict failed: {r.get('error')}")
        launches[label] = read_launches()
        print(f"{label}: predict {', '.join(f'{ms:.1f}' for ms in times)} ms, "
              f"{len(r['detections'])} detections on the last, pruning "
              f"{det.ensemble_predictor.pruning_report}, launches {launches[label]}")
        check(all(v > 0 for v in launches[label].values()),
              f"{label}: a kernel was not launched: {launches[label]}")
        phase_cross_check_int8(torch, det, images[0], conf, label)
        del det
        torch.cuda.empty_cache()
    return launches


def phase_entry_points(torch, images):
    """YOLODetector, ResNetClassifier and ImageSegmentator on the card
    against the CPU, with the kernels' launches on each path."""
    import numpy as np

    from iqc_tpu_torch.inference.segmentation import ImageSegmentator
    from iqc_tpu_torch.models import ResNetClassifier, YOLODetector

    kw = dict(model_path=YOLO_CKPT, confidence_threshold=0.3)
    yg, yc = YOLODetector(**kw, device="cuda"), YOLODetector(**kw, device="cpu")
    check(yg.get_model_info()["weights_source"] == "checkpoint", "YOLODetector weights")
    yg.predict(images[0])
    reset_launches()
    t = time.perf_counter()
    singles = [yg.predict(img) for img in images[:4]]
    single_ms = (time.perf_counter() - t) * 1e3 / 4
    t = time.perf_counter()
    batch = yg.batch_predict(images[:8])
    batch_ms = (time.perf_counter() - t) * 1e3
    yolo_launches = read_launches()
    for i, r in enumerate(singles):
        same_detections(r["detections"], yc.predict(images[i])["detections"],
                        f"YOLODetector.predict frame {i}", 1e-4)
    for i, (g, c) in enumerate(zip(batch, yc.batch_predict(images[:8]))):
        same_detections(g["detections"], c["detections"], f"YOLODetector.batch_predict {i}", 1e-4)
    print(f"YOLODetector on the card: predict {single_ms:.2f} ms, batch_predict of 8 "
          f"{batch_ms:.2f} ms, detections {[r['total_detections'] for r in batch]}, launches "
          f"{yolo_launches}; equal to the CPU's")
    check(yolo_launches["suppress"] == 5, f"YOLODetector launched K1 {yolo_launches}")

    cg = ResNetClassifier(model_path=RESNET_CKPT, device="cuda")
    cc = ResNetClassifier(model_path=RESNET_CKPT, device="cpu")
    pairs = [(cg.predict(images[0]), cc.predict(images[0]))]
    pairs += list(zip(cg.predict_batch(images[:8]), cc.predict_batch(images[:8])))
    prob_err = max(abs(g["class_probabilities"][k] - c["class_probabilities"][k])
                   for g, c in pairs for k in c["class_probabilities"])
    check(all(g["predicted_class"] == c["predicted_class"] and g["severity"] == c["severity"]
              for g, c in pairs), "ResNetClassifier classes differ between card and CPU")
    check(prob_err <= 1e-4, f"ResNetClassifier probabilities differ by {prob_err}")
    fg, fc = cg.extract_features(images[1]), cc.extract_features(images[1])
    feat_err = float(np.abs(fg - fc).max() / np.abs(fc).max())
    check(fg.shape == (2048,) and feat_err <= 1e-4, f"features differ by {feat_err}")
    print(f"ResNetClassifier on the card: {pairs[0][0]['predicted_class']} "
          f"({pairs[0][0]['confidence']:.4f}), probabilities within {prob_err:.2e}, "
          f"features within {feat_err:.2e} of their largest magnitude")

    dets = [r["detections"] for r in batch]
    if not any(dets):  # boxes over each frame's centre where the detector found nothing
        dets = [[{"class": "crack", "confidence": 0.5,
                  "bbox": {"x1": 200, "y1": 200, "x2": 300, "y2": 260}}] for _ in images[:8]]
    sg, sc = ImageSegmentator(device="cuda"), ImageSegmentator(device="cpu")
    first = next(i for i, d in enumerate(dets) if d)
    sg.segment_defects(images[first], dets[first])
    reset_launches()
    one = sg.segment_defects(images[first], dets[first])
    t = time.perf_counter()
    many = sg.segment_batch(np.stack(images[:8]), dets)
    seg_ms = (time.perf_counter() - t) * 1e3
    seg_launches = read_launches()
    agree = []
    for g, c in [(one, sc.segment_defects(images[first], dets[first]))] + list(
            zip(many, sc.segment_batch(np.stack(images[:8]), dets))):
        check(len(g["segmented_regions"]) == len(c["segmented_regions"]), "region counts differ")
        for rg, rc in zip(g["segmented_regions"], c["segmented_regions"]):
            check(rg["segmentation_method"] == rc["segmentation_method"], "methods differ")
            agree.append(float(np.mean(rg["local_mask"] == rc["local_mask"])))
    check(agree and min(agree) >= MASK_AGREEMENT, f"segmentation masks agree on {min(agree)}")
    print(f"ImageSegmentator on the card: segment_batch of 8 {seg_ms:.2f} ms, "
          f"{sum(len(d) for d in dets)} boxes, masks agree on at least {min(agree) * 100:.4f}% "
          f"of pixels, launches {seg_launches}")
    check(seg_launches["grow_clean"] == seg_launches["clean"] == 2 and
          seg_launches["suppress"] == 0, f"ImageSegmentator launches {seg_launches}")
    return yolo_launches, seg_launches


# -- phase 10: captured and exported ----------------------------------------------------


def jitted(det):
    """The detector's captured entry points: (name, HoistedJit)."""
    from iqc_tpu_torch.inference import detector

    ens = det.ensemble_predictor
    return (("preprocess", detector._preprocess_frames), ("detection", ens._forward),
            ("detection packed", ens._forward_packed), ("full", ens._forward_full))


def n_graphs(det) -> int:
    return sum(len(j.captures()) for _, j in jitted(det))


def eager_full(torch, ens, x):
    """The predictor's FullForward called directly (eager) on ``x``: numpy
    (EnsembleOutputs, masks, seg_stats), as run_full_host returns them."""
    from iqc_tpu_torch.models.ensemble import unpack_outputs

    with torch.inference_mode():
        det, img, masks, stats = ens.full_forward(x, *ens._args())
        torch.cuda.synchronize()
        return (unpack_outputs(det.cpu().numpy(), img.cpu().numpy()), masks.cpu().numpy(),
                stats.cpu().numpy())


def compare_full(got, want, what, box_tol, score_tol, relative):
    """Decisions equal, boxes within ``box_tol`` px, detector scores and
    ensemble confidences within ``score_tol`` (relative to the eager value
    when ``relative``), masks on MASK_AGREEMENT of pixels and segmentation
    methods equal. Returns (box error, score error, mask agreement)."""
    import numpy as np

    (g, gm, gs), (w, wm, ws) = got, want
    v = w.valid
    check(np.array_equal(g.valid, v), f"{what}: valid slots differ")
    for f in ("classes", "yolo_severity", "crop_class", "crop_severity", "final_severity"):
        check(np.array_equal(getattr(g, f)[v], getattr(w, f)[v]), f"{what}: {f} differs")
    check(np.array_equal(g.severity_counts, w.severity_counts), f"{what}: severity counts differ")
    box_err = float(np.abs(g.boxes[v] - w.boxes[v]).max()) if v.any() else 0.0
    score_err = 0.0
    for f in ("yolo_scores", "ensemble_conf"):
        a, b = getattr(g, f)[v], getattr(w, f)[v]
        d = np.abs(a - b) / (np.maximum(np.abs(b), 1e-6) if relative else 1.0)
        score_err = max(score_err, float(d.max()) if v.any() else 0.0)
    agree = float(np.mean(gm == wm))
    check(box_err <= box_tol, f"{what}: boxes differ by {box_err} px")
    check(score_err <= score_tol, f"{what}: scores differ by {score_err}")
    check(agree >= MASK_AGREEMENT, f"{what}: masks agree on {agree:.6f} of pixels")
    check(np.array_equal(gs[..., 4], ws[..., 4]), f"{what}: segmentation methods differ")
    return box_err, score_err, agree


def eager_on_device_thread(det, fn):
    """``fn`` with every captured entry point run eagerly, on the detector's
    device thread, where predict and predict_batch run."""
    from iqc_tpu_torch.ops import jit_utils

    def call(*args):
        def body():
            with jit_utils.eager():
                return fn(*args)
        return det._on_device_thread(body)
    return call


def suppress_guard_cases(torch, dev):
    """K1's raw entry point between two guard regions, captured in a CUDA
    graph at threshold 0.5 and replayed with its threshold tensor set to
    0.3, 0.45 and 0.7: each replay equals the plain version at that
    threshold and writes no byte beside its keep mask. Returns the cases run."""
    import numpy as np

    from iqc_tpu_torch import build
    from iqc_tpu_torch.ops import nms_kernel

    guard, sentinel = 4096, 0xA5
    fn = build.library().fns["iqc_suppress"]
    n = 0
    for batch, k, iterations in ((1, 300, 16), (8, 300, 16), (3, 512, 40), (2, 20, 16)):
        if k >= 48:
            boxes = nms_inputs(torch, dev, batch=batch, k=k)
        else:
            rng = np.random.default_rng(k)
            lo = rng.uniform(0, 100, (batch, k, 2))
            boxes = torch.tensor(np.concatenate([lo, lo + rng.uniform(5, 40, (batch, k, 2))], -1),
                                 dtype=torch.float32, device=dev)
        buf = torch.full((batch * k + 2 * guard,), sentinel, dtype=torch.uint8, device=dev)
        keep = buf[guard:guard + batch * k].view(batch, k)
        thr = torch.tensor(THRESHOLD, dtype=torch.float32, device=dev)

        def launch():
            build.launch(fn, boxes.device, boxes.data_ptr(), thr.data_ptr(), keep.data_ptr(),
                         batch, k, iterations)

        launch()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launch()
        for threshold in (0.3, 0.45, 0.7):
            thr.fill_(threshold)
            for _ in range(3):
                graph.replay()
            torch.cuda.synchronize()
            intact = bool((buf[:guard] == sentinel).all()) and bool((buf[-guard:] == sentinel).all())
            check(intact, f"K1 [{batch},{k},4] at {threshold}: a guard region was written")
            want = nms_kernel.suppress_plain(boxes, thr, iterations)
            check(torch.equal(keep.bool(), want),
                  f"K1 [{batch},{k},4] at run-time threshold {threshold} differs from plain")
            n += 1
    return n


CAPTURE_TOLERANCE = {"int8": (1.0, 1e-3, False), "bf16": (1.0, 1e-3, False),
                     "fp32": (1e-2, 1e-4, True)}


def phase_captured(torch, images, det8, det32, det16):
    """The captured forwards against eager, thresholds at run time, capture
    times, int8 predict timing and profile, replay launches, export."""
    import numpy as np

    from iqc_tpu_torch.models.export import export_ensemble, load_exported
    from iqc_tpu_torch.ops import jit_utils, nms_kernel

    out = {"capture_vs_eager": {}}
    for label, det in (("int8", det8), ("fp32", det32), ("bf16", det16)):
        ens = det.ensemble_predictor
        x1 = det._preprocess(det._upload(images[2])[None])
        x8 = det._preprocess(torch.stack([det._upload(im) for im in images[:8]]))
        for what, x in (("predict", x1), ("predict_batch 8", x8)):
            ens.run_full_host(x)
            got = ens.run_full_host(x)  # a replay
            errs = compare_full(got, eager_full(torch, ens, x), f"{label} {what} captured vs eager",
                                *CAPTURE_TOLERANCE[label])
            out["capture_vs_eager"][f"{label} {what}"] = errs
            print(f"{label} {what}: captured equals eager, {int(got[0].valid.sum())} detections, "
                  f"boxes within {errs[0]:.3e} px, scores within {errs[1]:.3e}"
                  f"{' relative' if label == 'fp32' else ''}, masks agree on "
                  f"{errs[2] * 100:.4f}% of pixels")

    # thresholds and weights at run time: no new capture (both forwards of a
    # request captured first)
    ens = det8.ensemble_predictor
    x1 = det8._preprocess(det8._upload(images[2])[None])
    before = ens.run_full_host(x1)
    det8.predict(images[2], include_segmentation=False)
    graphs = n_graphs(det8)
    m = det8.config.model
    saved = {"confidence_threshold": ens.confidence_threshold,
             "nms_threshold": m.nms_threshold, "ensemble_weights": dict(m.ensemble_weights)}
    det8.update_config({"model": {"confidence_threshold": 0.05, "nms_threshold": 0.3,
                                  "ensemble_weights": {"yolo": 0.35, "resnet": 0.65}}})
    try:
        after = ens.run_full_host(x1)
        errs = compare_full(after, eager_full(torch, ens, x1), "int8 after update_config",
                            *CAPTURE_TOLERANCE["int8"])
        r = det8.predict(images[2], include_segmentation=False)
        check("error" not in r, f"detection-only predict failed: {r.get('error')}")
    finally:
        det8.update_config({"model": saved})
    check(n_graphs(det8) == graphs, f"update_config made {n_graphs(det8) - graphs} new captures")
    print(f"update_config (confidence 0.05, NMS 0.3, weights 0.35/0.65) between replays: "
          f"{int(before[0].valid.sum())} -> {int(after[0].valid.sum())} detections, equal to "
          f"eager at the new values (boxes within {errs[0]:.3e} px), no new capture "
          f"({graphs} graphs)")

    # launches through replays
    reset_launches()
    with jit_utils.eager():
        ens.run_full_host(x1)
    one = read_launches()
    reset_launches()
    for _ in range(5):
        ens.run_full_host(x1)
    five = read_launches()
    check(all(v > 0 for v in one.values()) and five == {k: 5 * v for k, v in one.items()},
          f"launches through 5 replays {five}, one eager call {one}")
    print(f"launches: one eager full forward {one}; 5 replays {five}")
    out["launches_eager_call"], out["launches_5_replays"] = one, five

    # int8 predict and predict_batch of 8: captured against eager, wall
    # times after a first call and one call under the profiler
    times = {}
    calls = {"captured": (det8.predict, det8.predict_batch),
             "eager": (eager_on_device_thread(det8, lambda im: det8._predict(im, True)),
                       eager_on_device_thread(det8, det8._predict_batch))}
    for label, (predict, predict_batch) in calls.items():
        for what, fn, arg, n_calls in (("predict", predict, None, 10),
                                       ("predict_batch 8", predict_batch, images[:8], 3)):
            fn(arg if arg is not None else images[3])
            ms = []
            for i in range(n_calls):
                t = time.perf_counter()
                r = fn(arg if arg is not None else images[i % 8])
                ms.append((time.perf_counter() - t) * 1e3)
                check("error" not in (r[0] if isinstance(r, list) else r),
                      f"{label} {what} failed")
            wall, n, busy = request_profile(torch, det8, arg if arg is not None else images[1],
                                            fn)
            times[f"{label} {what}"] = {"wall_ms": ms, "profile": {
                "wall_ms": wall, "kernels": n, "device_ms": busy, "idle": 1 - busy / wall}}
            print(f"int8 {what} {label}: {', '.join(f'{v:.2f}' for v in ms)} ms (median "
                  f"{sorted(ms)[len(ms) // 2]:.2f}); under torch.profiler {wall:.2f} ms wall, "
                  f"{n} kernels, {busy:.3f} ms of device time, device idle "
                  f"{100 * (1 - busy / wall):.1f}% of it")
    out["int8_timing"] = times

    # export at batch 1 on the card, reload, against live run
    path = os.path.join(REPO, "build", "export", "ensemble_int8.iqc")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = time.perf_counter()
    meta = export_ensemble(ens, path, batch_size=1)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    engine = load_exported(path, device="cuda")
    load_s = time.perf_counter() - t
    check(meta["device"].startswith("cuda") and "iqc.suppress" in str(engine.program.graph),
          "the exported program holds no iqc.suppress node")
    frame = images[3][None]
    kw = dict(confidence_threshold=ens.confidence_threshold, nms_threshold=ens.nms_threshold,
              ensemble_weights=dict(ens.ensemble_weights))
    before = nms_kernel.LAUNCHES["suppress"]
    got = engine.outputs(frame, **kw)
    check(nms_kernel.LAUNCHES["suppress"] == before + 1, "the exported program did not launch K1")
    live = ens.run_host(frame)
    v = live.valid
    check(np.array_equal(got.valid, v) and np.array_equal(got.classes[v], live.classes[v]),
          "the exported program's detections differ from live run")
    box_err = float(np.abs(got.boxes[v] - live.boxes[v]).max()) if v.any() else 0.0
    check(box_err <= 1.0, f"exported boxes differ from live run by {box_err} px")
    x = torch.from_numpy(frame).cuda()
    scalars = [torch.tensor(float(s), device="cuda") for s in
               (kw["confidence_threshold"], kw["nms_threshold"], kw["ensemble_weights"]["yolo"],
                kw["ensemble_weights"]["resnet"])]
    with torch.no_grad():
        program_ms = cuda_time_ms(lambda: engine.module(x, *scalars), warmup=2, iters=10)
    size = os.path.getsize(path)
    print(f"export of the int8 predictor at batch 1: {export_s:.2f} s, {size} bytes; reload "
          f"{load_s:.2f} s; {int(v.sum())} detections equal to live run (boxes within "
          f"{box_err:.3e} px); the program {program_ms:.3f} ms a call, K1 launched")
    out["export"] = {"seconds": export_s, "bytes": size, "load_seconds": load_s,
                     "program_ms": program_ms, "box_err": box_err}

    n = suppress_guard_cases(torch, torch.device("cuda"))
    print(f"K1 guard regions at run-time thresholds 0.3, 0.45, 0.7: {n} cases intact and "
          f"equal to plain")

    seconds = {}
    for label, det in (("int8", det8), ("fp32", det32), ("bf16", det16)):
        for name, j in jitted(det):
            if name != "preprocess":
                seconds[f"{label} {name}"] = [round(c.seconds, 4) for c in j.captures()]
    from iqc_tpu_torch.inference import detector

    seconds["preprocess (shared)"] = [round(c.seconds, 4)
                                      for c in detector._preprocess_frames.captures()]
    total = sum(len(v) for v in seconds.values())
    print(f"capture seconds per signature: {seconds}; {total} graphs cached")
    out["capture_seconds"], out["graphs"] = seconds, total
    return out


# -- phase 11: training ------------------------------------------------------------


def _score_gap_threshold(scores, lo=5, hi=300):
    """A confidence threshold in the widest gap between consecutive sorted
    scores at ranks lo..hi, so that near-equal scores do not straddle it."""
    import numpy as np

    s = np.sort(scores.reshape(-1))[::-1][:hi + 1]
    i = lo + int(np.argmax(s[lo:hi] - s[lo + 1:hi + 1]))
    return float((s[i] + s[i + 1]) / 2), float(s[i] - s[i + 1])


def _same_raw_detections(got, want, what):
    """Per image the same detections, order aside (near-equal scores may
    swap): classes and severities equal, boxes within 1e-2 px, scores
    within 1e-4 relative (the float32 limits of PERF.md section 2)."""
    import numpy as np

    for i in range(want[3].shape[0]):
        g = [x[i][got[3][i]] for x in got[:3]] + [got[4][i][got[3][i]]]
        w = [x[i][want[3][i]] for x in want[:3]] + [want[4][i][want[3][i]]]
        check(len(g[2]) == len(w[2]), f"{what} image {i}: {len(g[2])} detections, CPU {len(w[2])}")
        og, ow = np.lexsort((g[0][:, 0], g[2])), np.lexsort((w[0][:, 0], w[2]))
        check(np.array_equal(g[2][og], w[2][ow]) and np.array_equal(g[3][og], w[3][ow]),
              f"{what} image {i}: classes or severities differ")
        box_err = float(np.abs(g[0][og] - w[0][ow]).max()) if len(og) else 0.0
        score_err = float((np.abs(g[1][og] - w[1][ow]) / np.abs(w[1][ow])).max()) if len(og) else 0.0
        check(box_err <= 1e-2 and score_err <= 1e-4,
              f"{what} image {i}: boxes within {box_err} px, scores {score_err} relative")


def _k1_training_shapes(torch, dev):
    """K1 at validation's shapes: [16,100,4] (YOLOv8n at 640^2: capacity 100)
    and [16,84,4] (84 anchors, the capacity at 64 px), IoU threshold 0.6,
    between guard regions, against the plain version; device ms (graph
    replay of the raw launch), wrapper, plain and bound at [16,100,4]."""
    import numpy as np

    from iqc_tpu_torch import build
    from iqc_tpu_torch.ops import nms_kernel

    guard, sentinel, threshold = 4096, 0xA5, 0.6
    fn = build.library().fns["iqc_suppress"]
    row = None
    for batch, k in ((16, 100), (16, 84)):
        boxes = nms_inputs(torch, dev, batch=batch, k=k)
        buf = torch.full((batch * k + 2 * guard,), sentinel, dtype=torch.uint8, device=dev)
        keep = buf[guard:guard + batch * k].view(batch, k)
        thr = torch.tensor(threshold, dtype=torch.float32, device=dev)

        def launch():
            build.launch(fn, boxes.device, boxes.data_ptr(), thr.data_ptr(), keep.data_ptr(),
                         batch, k, ROUNDS)

        launch()
        torch.cuda.synchronize()
        intact = bool((buf[:guard] == sentinel).all()) and bool((buf[-guard:] == sentinel).all())
        check(intact, f"K1 [{batch},{k},4] at {threshold}: a guard region was written")
        want = nms_kernel.suppress_plain(boxes, thr, ROUNDS)
        check(torch.equal(keep.bool(), want), f"K1 [{batch},{k},4] differs from its plain version")
        err = max_err(torch, nms_kernel.suppress(boxes, thr, ROUNDS), want)
        check(err == 0, f"K1's wrapper at [{batch},{k},4] differs from its plain version")
        if row is None:
            rounds = suppress_rounds(torch, boxes, ROUNDS, threshold)
            words = (k + 31) // 32
            n_bytes = boxes.numel() * 4 + 4 + batch * k
            n_ops = batch * (k * (k - 1) // 2) * 14 + sum(rounds) * k * words * 2
            bound_ms, bound_by = bound(n_bytes, n_ops)
            row = {"shape": f"[{batch},{k},4]", "threshold": threshold,
                   "ms": graph_ms(torch, launch),
                   "wrapper_ms": cuda_time_ms(lambda: nms_kernel.suppress(boxes, thr, ROUNDS)),
                   "plain_ms": cuda_time_ms(lambda: nms_kernel.suppress_plain(boxes, thr, ROUNDS),
                                            warmup=2, iters=10),
                   "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                   "rounds": rounds}
    print(f"K1 at validation's shapes [16,100,4] and [16,84,4], threshold 0.6: equal to plain, "
          f"guard regions intact; [16,100,4] device {row['ms']:.5f} ms, wrapper "
          f"{row['wrapper_ms']:.5f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.7f} ms ({row['bound_by']})")
    return row


def _profiled_ms(torch, fn):
    """fn under torch.profiler: (wall ms, device kernels, their summed
    device ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return wall, len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def _corpus(torch, n, size, max_boxes, device):
    """n synthetic training samples (images, boxes, classes, valid) on the device."""
    import numpy as np

    from iqc_tpu_torch.data.yolo_dataset import SyntheticDefectDataset

    ds = SyntheticDefectDataset(n, size, max_boxes, seed=3)
    items = [ds.load(i) for i in range(n)]
    return tuple(torch.from_numpy(np.stack([x[j] for x in items])).to(device) for j in range(4))


def _step_times(torch, config, corpus, steps=10, warmup=3):
    """Train-step wall ms on the device corpus at the profile's batch
    (median of ``steps`` after ``warmup``), one profiled step, the peak
    memory, and the trainer."""
    import numpy as np

    from iqc_tpu_torch.train.train_yolo import YOLOTrainer

    trainer = YOLOTrainer(config, device="cuda")
    b = config["batch_size"]
    trainer.build(steps_per_epoch=16)
    rows = np.random.default_rng(0).integers(0, corpus[0].shape[0], (warmup + steps + 1, b))
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i, row in enumerate(rows[:-1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        parts = trainer._corpus_epoch(corpus, row[None].astype(np.int32))
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t) * 1e3)
        check(all(bool(torch.isfinite(v)) for v in parts[0].values()), "a non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    wall, n, busy = _profiled_ms(torch, lambda: trainer._corpus_epoch(
        corpus, rows[-1][None].astype(np.int32)))
    med = sorted(ms)[len(ms) // 2]
    return trainer, {"step_ms": ms, "median_ms": med, "images_per_s": b / med * 1e3,
                     "profiled_step": {"wall_ms": wall, "kernels": n, "device_ms": busy,
                                       "idle": 1 - busy / wall},
                     "max_memory_allocated": peak}


def phase_training(torch):
    """Phase 11: the training entry point at full width, then step times,
    card against CPU, and K1 at validation's shapes."""
    import tempfile

    import numpy as np

    from iqc_tpu_torch.config import YOLO_TRAINING_PROFILE
    from iqc_tpu_torch.models import YOLODetector
    from iqc_tpu_torch.train.train_yolo import YOLOTrainer, config_from_profile

    out = {}
    dev = torch.device("cuda")
    # 1. the entry point in a process of its own, its checkpoint outside the checkout
    tmp = tempfile.mkdtemp(prefix="iqc_train_")
    profile = json.loads(json.dumps(YOLO_TRAINING_PROFILE))
    profile["training"]["checkpoint_dir"] = tmp
    path = os.path.join(tmp, "yolo_profile.json")
    with open(path, "w") as f:
        json.dump(profile, f)
    cmd = [sys.executable, "-m", "iqc_tpu_torch.train.train_yolo", "--synthetic", "--epochs",
           "1", "--config", path]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
    check(proc.returncode == 0, f"the training entry point exited {proc.returncode}")
    report = json.loads(proc.stdout)
    final = report["final"]
    losses = {k: v for k, v in final.items() if k.startswith("train_") and k.endswith("loss")}
    check(losses and all(np.isfinite(v) for v in losses.values()), f"losses {losses}")
    check("val_mAP50" in final and "val_mAP50_95" in final, "no mAP in the report")
    ckpt = os.path.join(tmp, "yolov8_qc.msgpack")
    check(os.path.exists(ckpt) and os.path.exists(ckpt + ".json"), "no checkpoint written")
    launches = report["kernel_launches"]
    check(launches["suppress"] == 4 and launches["grow_clean"] == 0 and launches["clean"] == 0,
          f"the training run's launches {launches} (4 validation batches of 16 expected)")
    out["entry_point"] = {"command": " ".join(cmd[1:]), "wall_s": wall, "report": report}
    print(f"python -m iqc_tpu_torch.train.train_yolo --synthetic --epochs 1 (the "
          f"yolo_config.yaml profile, YOLOv8n 640^2, batch 16, bf16, device mosaic and "
          f"augmentation, class weights): rc 0 in {wall:.2f} s, losses {losses}, mAP50 "
          f"{final['val_mAP50']:.5f}, launches {launches}, checkpoint written")

    # the trained checkpoint served by YOLODetector, card against CPU (float32)
    frames = np.stack([defect_image(s) for s in range(2)])
    dets = {d: YOLODetector(model_path=ckpt, device=d, confidence_threshold=0.5) for d in
            ("cuda", "cpu")}
    check(dets["cuda"].get_model_info()["weights_source"] == "checkpoint", "checkpoint not loaded")
    with torch.no_grad():
        _, cls = dets["cpu"].module(torch.from_numpy(frames).float() / 255.0)
    conf, gap = _score_gap_threshold(torch.sigmoid(cls.float()).amax(-1).numpy())
    raw = {}
    for d, det in dets.items():
        det.update_thresholds(confidence=conf)
        raw[d] = det._forward(det._upload(frames))
    _same_raw_detections(raw["cuda"], raw["cpu"], "the trained checkpoint")
    n_det = int(raw["cuda"][3].sum())
    out["served_checkpoint"] = {"confidence_threshold": conf, "score_gap": gap,
                                "detections": n_det}
    print(f"the trained checkpoint in YOLODetector at confidence {conf:.6f} (a score gap of "
          f"{gap:.2e}): {n_det} detections on 2 frames, card equal to the CPU")

    # 2. step times at batch 16, 640^2: bfloat16, float32 (TF32 off)
    corpus = _corpus(torch, 48, 640, 64, dev)
    base = config_from_profile(YOLO_TRAINING_PROFILE)
    times = {}
    for label, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        trainer, times[label] = _step_times(torch, {**base, "compute_dtype": dtype}, corpus)
        if label == "bf16":
            batch = corpus[0][:16]
            trainer.predict_batches([batch])
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                trainer.predict_batches([batch])
            times["validation_ms_per_batch_16"] = (time.perf_counter() - t) * 1e3 / 5
        del trainer
        torch.cuda.empty_cache()
        r = times[label]
        print(f"train step {label}: median {r['median_ms']:.2f} ms ({r['images_per_s']:.1f} "
              f"images/s) of {', '.join(f'{v:.2f}' for v in r['step_ms'])}; profiled step "
              f"{r['profiled_step']['wall_ms']:.2f} ms wall, {r['profiled_step']['kernels']} "
              f"kernels, {r['profiled_step']['device_ms']:.2f} ms device, idle "
              f"{100 * r['profiled_step']['idle']:.1f}%; peak memory "
              f"{r['max_memory_allocated'] / 2**20:.0f} MiB")
    print(f"validation (EMA predict + K1, captured) {times['validation_ms_per_batch_16']:.2f} ms "
          f"per batch of 16")
    out["step_times"] = times

    # 3. card against CPU: two float32 steps at batch 2 from the same state
    # (the shipped detector checkpoint: a fresh network scores every anchor
    # within ~1e-8, and which of near-equal anchors the assignment's top-k
    # takes then follows rounding) and the same CPU-drawn mosaic and
    # augmentation draws; then one bf16 step. On the CPU the batch
    # statistics are summed in XLA's sequential order (the JAX package's);
    # their fast variance cancels on these flat images, so the card's tree
    # reduction moves the loss by ~3e-4. The float32 steps are also held
    # against the CPU with PyTorch's own reduction (``layers.channel_sum``
    # replaced for that run), which the card's should match within 1e-4.
    from iqc_tpu_torch import weights
    from iqc_tpu_torch.models import layers

    shipped = weights.read_checkpoint(os.path.join(REPO, YOLO_CKPT))
    small = tuple(x[:8] for x in corpus)
    xla_order = layers.channel_sum

    def torch_order(x):
        return x.sum([d for d in range(x.dim()) if d != 1])

    def run(cfg, device, steps, stats):
        layers.channel_sum = stats
        try:
            tr = YOLOTrainer(cfg, device=device)
            tr.build(steps_per_epoch=16)
            weights.load_into(tr.module, shipped)
            with torch.no_grad():
                for k, p in tr.state.params.items():
                    tr.ema_params[k].copy_(p)
            c = small if device == "cuda" else tuple(x.cpu() for x in small)
            return tr, tr._corpus_epoch(c, np.array([[0, 5], [3, 6]], np.int32)[:steps])
        finally:
            layers.channel_sum = xla_order

    def compare(got, want, tol, what):
        errs = []
        for g, w in zip(got[1], want[1]):
            for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
                diff = abs(float(g[k]) - float(w[k]))
                errs.append(diff / abs(float(w[k])))
                check(errs[-1] <= tol or diff <= 1e-6 * abs(float(w["loss"])),
                      f"{what} step {k}: {float(g[k])} vs {float(w[k])}")
        p_err = max(float((got[0].state.params[k].detach().cpu()
                           - want[0].state.params[k].detach()).abs().max())
                    for k in want[0].state.params)
        return {"max_rel_loss_err": max(errs), "params_max_abs_err": p_err,
                "losses": [float(p["loss"]) for p in want[1]]}

    cross = {}
    fp32 = {**base, "batch_size": 2, "compute_dtype": "float32"}
    card = run(fp32, "cuda", 2, xla_order)
    cross["fp32_vs_cpu_torch_order"] = compare(card, run(fp32, "cpu", 2, torch_order), 1e-4,
                                               "fp32 card vs CPU (PyTorch's reduction)")
    cross["fp32_vs_cpu_xla_order"] = compare(card, run(fp32, "cpu", 2, xla_order), 1e-3,
                                             "fp32 card vs CPU (XLA's order)")
    for r in cross.values():
        check(r["params_max_abs_err"] <= 1e-3,
              f"float32 params after 2 steps differ by {r['params_max_abs_err']} card vs CPU")
    bf16 = {**base, "batch_size": 2, "compute_dtype": "bfloat16"}
    cross["bf16_vs_cpu_xla_order"] = compare(run(bf16, "cuda", 1, xla_order),
                                             run(bf16, "cpu", 1, xla_order), 2e-2,
                                             "bf16 card vs CPU")
    del card
    for label, r in cross.items():
        print(f"card vs CPU, {label}, batch 2, 640^2, from the shipped checkpoint and the same "
              f"draws: loss parts within {r['max_rel_loss_err']:.3e} relative, params within "
              f"{r['params_max_abs_err']:.3e}")
    out["card_vs_cpu"] = cross

    # 4. K1 at validation's shapes
    out["k1"] = _k1_training_shapes(torch, dev)
    out["launches"] = launches
    return out


def _write_classifier_tree(root, size=256, counts=(("train", 48), ("val", 16), ("test", 16))):
    """An image-folder tree (split/class/NNN.png) rendered by the port's
    MVTecStyleRenderer and written by its PNG writer."""
    from iqc_tpu_torch.config import DEFECT_CLASSES
    from iqc_tpu_torch.data.mvtec_synth import MVTecStyleRenderer
    from iqc_tpu_torch.runtime.codec import write_png

    r = MVTecStyleRenderer(size=size, seed=2024)
    i = 0
    for split, n in counts:
        for cls in DEFECT_CLASSES:
            os.makedirs(os.path.join(root, split, cls))
            for k in range(n):
                write_png(os.path.join(root, split, cls, f"{k:03d}.png"), r.render(cls, i)[0])
                i += 1
    return i


def _classifier_step_times(torch, config, train_ds, steps=10, warmup=3):
    """Classifier train-step wall ms on the device corpus at the profile's
    batch (median of ``steps`` after ``warmup``), one profiled step, the
    peak memory, and the trainer."""
    import numpy as np

    from iqc_tpu_torch.train.train_resnet import ResNetTrainer

    trainer = ResNetTrainer(config, device="cuda")
    trainer.setup_data(train_ds)
    trainer.build(steps_per_epoch=max(len(trainer.train_loader), 1))
    corpus = trainer._maybe_device_corpus()
    check(corpus is not None, "the training set did not take the device-corpus tier")
    b = config["batch_size"]
    rows = np.random.default_rng(0).integers(0, corpus[0].shape[0], (warmup + steps + 1, b))
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i, row in enumerate(rows[:-1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = trainer._corpus_epoch(corpus, row[None])
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(out[0]["loss"])), "a non-finite classifier loss")
    peak = torch.cuda.max_memory_allocated()
    wall, n, busy = _profiled_ms(torch, lambda: trainer._corpus_epoch(corpus, rows[-1][None]))
    med = sorted(ms)[len(ms) // 2]
    return trainer, {"step_ms": ms, "median_ms": med, "images_per_s": b / med * 1e3,
                     "profiled_step": {"wall_ms": wall, "kernels": n, "device_ms": busy,
                                       "idle": 1 - busy / wall},
                     "max_memory_allocated": peak}


def phase_classifier_training(torch):
    """Phase 12: the classifier trainer's entry point over an image-folder
    tree at full width, its checkpoint served card against CPU, then step
    times, evaluate, and two float32 steps card against CPU."""
    import tempfile

    import numpy as np

    from iqc_tpu_torch.config import RESNET_TRAINING_PROFILE
    from iqc_tpu_torch.data.pipeline import ImageFolderDataset
    from iqc_tpu_torch.models import ResNetClassifier
    from iqc_tpu_torch.models import layers
    from iqc_tpu_torch.train.train_resnet import ResNetTrainer, config_from_profile

    out = {}
    reset_launches()
    # 1. the tree, rendered at 256^2 (resized to 224^2 by the loader)
    tmp = tempfile.mkdtemp(prefix="iqc_cls_")
    data = os.path.join(tmp, "data")
    t = time.perf_counter()
    n_files = _write_classifier_tree(data)
    print(f"image-folder tree: {n_files} PNG files at 256^2 (48 train, 16 val, 16 test per "
          f"class) in {time.perf_counter() - t:.2f} s")
    # 2. the entry point in a process of its own
    profile = json.loads(json.dumps(RESNET_TRAINING_PROFILE))
    profile["training"]["checkpoint_dir"] = os.path.join(tmp, "ckpt")
    path = os.path.join(tmp, "resnet_profile.json")
    with open(path, "w") as f:
        json.dump(profile, f)
    cmd = [sys.executable, "-m", "iqc_tpu_torch.train.train_resnet", "--data-dir", data,
           "--epochs", "1", "--config", path]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
    check(proc.returncode == 0, f"the classifier training entry point exited {proc.returncode}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    final = report["train"]["final_metrics"]
    check(np.isfinite(final["loss"]) and np.isfinite(final["val_loss"]), f"losses {final}")
    cm = np.asarray(report["test"]["confusion_matrix"])
    check(cm.shape == (5, 5) and int(cm.sum()) == 80, f"test confusion matrix {cm.tolist()}")
    check(not any(report["kernel_launches"].values()),
          f"the classifier run launched {report['kernel_launches']} (none expected)")
    ckpt = os.path.join(tmp, "ckpt", "final_model.msgpack")
    check(os.path.exists(ckpt) and os.path.exists(ckpt + ".json"), "no checkpoint written")
    out["entry_point"] = {"command": " ".join(cmd[1:]), "wall_s": wall, "report": report}
    print(f"python -m iqc_tpu_torch.train.train_resnet --epochs 1 (the resnet_config.yaml "
          f"profile: ResNet-50 224^2, batch 32, bf16, Adam + cosine, the augmentation block, "
          f"class weights, balanced sampling): rc 0 in {wall:.2f} s, train loss "
          f"{final['loss']:.5f}, val loss {final['val_loss']:.5f}, val accuracy "
          f"{final['val_accuracy']:.4f}, test accuracy {report['test']['accuracy']:.4f}, "
          f"launches {report['kernel_launches']}, checkpoint written")

    # 3. the checkpoint served by ResNetClassifier, card against CPU (float32)
    test_ds = ImageFolderDataset(os.path.join(data, "test"), (224, 224))
    frames = [test_ds.load(i)[0] for i in range(0, 80, 10)]
    clfs = {d: ResNetClassifier(model_path=ckpt, device=d) for d in ("cuda", "cpu")}
    check(clfs["cuda"].get_model_info()["weights_source"] == "checkpoint", "checkpoint not loaded")
    res = {d: c.predict_batch(frames) for d, c in clfs.items()}
    prob_err = max(abs(a["class_probabilities"][k] - b["class_probabilities"][k])
                   for a, b in zip(res["cuda"], res["cpu"]) for k in a["class_probabilities"])
    check(all(a["predicted_class"] == b["predicted_class"] for a, b in zip(res["cuda"],
                                                                          res["cpu"])),
          "the served classes differ card vs CPU")
    check(prob_err <= 1e-4, f"served probabilities differ by {prob_err}")
    out["served_checkpoint"] = {"frames": len(frames), "probs_max_abs_err": prob_err}
    print(f"the trained checkpoint in ResNetClassifier (float32) on 8 test images: classes "
          f"equal, probabilities within {prob_err:.3e}, card vs CPU")
    del clfs

    # 4. step times at batch 32, 224^2: bfloat16, float32 (TF32 off); evaluate
    train_ds = ImageFolderDataset(os.path.join(data, "train"), (224, 224))
    base = {**config_from_profile(RESNET_TRAINING_PROFILE), "checkpoint_dir": tmp}
    times = {}
    for label, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        trainer, times[label] = _classifier_step_times(torch, {**base, "compute_dtype": dtype},
                                                       train_ds)
        if label == "bf16":
            from iqc_tpu_torch.data.pipeline import ArrayDataset, DataLoader

            imgs, labels = (t[:96].cpu().numpy() for t in trainer._device_corpus)
            loader = DataLoader(ArrayDataset(imgs, labels), 32, shuffle=False)
            trainer.evaluate(loader)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                trainer.evaluate(loader)
            times["evaluate_ms_per_batch_32"] = (time.perf_counter() - t) * 1e3 / 9
        del trainer
        torch.cuda.empty_cache()
        r = times[label]
        print(f"classifier train step {label}: median {r['median_ms']:.2f} ms "
              f"({r['images_per_s']:.1f} images/s) of {', '.join(f'{v:.2f}' for v in r['step_ms'])}"
              f"; profiled step {r['profiled_step']['wall_ms']:.2f} ms wall, "
              f"{r['profiled_step']['kernels']} kernels, {r['profiled_step']['device_ms']:.2f} ms "
              f"device, idle {100 * r['profiled_step']['idle']:.1f}%; peak memory "
              f"{r['max_memory_allocated'] / 2**20:.0f} MiB")
    print(f"classifier evaluate (bf16, host batches uploaded) "
          f"{times['evaluate_ms_per_batch_32']:.2f} ms per batch of 32")
    out["step_times"] = times

    # 5. card against CPU: two float32 steps at batch 4 from the same fresh
    # state and the same CPU-drawn augmentation and dropout; the CPU sums the
    # batch statistics in PyTorch's order (the card's), then in XLA's
    xla_order = layers.channel_sum

    def torch_order(x):
        return x.sum([d for d in range(x.dim()) if d != 1])

    small = ImageFolderDataset(os.path.join(data, "val"), (224, 224))
    idx = np.array([[0, 17, 35, 52], [70, 9, 44, 61]])

    def run(device, stats):
        layers.channel_sum = stats
        try:
            tr = ResNetTrainer({**base, "batch_size": 4, "compute_dtype": "float32"},
                               device=device)
            tr.setup_data(small)
            tr.build(steps_per_epoch=20)
            return tr, tr._corpus_epoch(tr._maybe_device_corpus(), idx)
        finally:
            layers.channel_sum = xla_order

    card = run("cuda", xla_order)
    cross = {}
    for label, stats, tol in (("fp32_vs_cpu_torch_order", torch_order, 1e-4),
                              ("fp32_vs_cpu_xla_order", xla_order, 1e-3)):
        cpu = run("cpu", stats)
        errs = [abs(float(g["loss"]) - float(c["loss"])) / abs(float(c["loss"]))
                for g, c in zip(card[1], cpu[1])]
        p_err = max(float((card[0].state.params[k].detach().cpu() - v.detach()).abs().max())
                    for k, v in cpu[0].state.params.items())
        check(errs[0] <= tol and errs[1] <= 2e-3,
              f"classifier {label}: losses differ by {errs} relative")
        check(p_err <= 5e-3, f"classifier {label}: params differ by {p_err}")
        cross[label] = {"rel_loss_err_per_step": errs, "params_max_abs_err": p_err,
                        "losses": [float(c["loss"]) for c in cpu[1]]}
        print(f"classifier card vs CPU, {label}, ResNet-50 224^2 batch 4, two steps from the "
              f"same state and draws: losses within {', '.join(f'{e:.3e}' for e in errs)} "
              f"relative, params within {p_err:.3e}")
    out["card_vs_cpu"] = cross
    del card
    torch.cuda.empty_cache()
    out["launches"] = read_launches()
    print(f"K1-K3 launches in this phase: {out['launches']} (in-process; the entry point's "
          f"own run reported {report['kernel_launches']})")
    check(not any(out["launches"].values()), "the classifier phase launched a kernel")
    return out


# -- phase 13: multi-device ------------------------------------------------------------

def _frames(size, seeds):
    """Seeded parts (``defect_image``) at ``size``^2, stacked."""
    import numpy as np

    return np.stack([defect_image(s, size) for s in seeds])


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _max_rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _yolo_rank_steps(torch, cfg, shipped, batches, sync, device):
    """Two YOLO steps from the shipped checkpoint on the global batches (this
    process's mesh decides the rows): the loss parts of each, the state
    after the first, the trainer."""
    from iqc_tpu_torch import weights
    from iqc_tpu_torch.train.train_yolo import YOLOTrainer

    tr = YOLOTrainer(cfg, device=device)
    tr.build(steps_per_epoch=16)
    weights.load_into(tr.module, shipped)
    with torch.no_grad():
        for k, p in tr.state.params.items():
            tr.ema_params[k].copy_(p)
    parts, first = [], None
    for b in batches:
        parts.append({k: float(v) for k, v in tr.train_step(*b).items()})
        if first is None:
            first = {name: {k: v.detach().clone() for k, v in d.items()} for name, d in
                     (("params", tr.state.params), ("batch_stats", tr.state.batch_stats),
                      ("ema", tr.ema_params))}
    sync()
    return tr, parts, first


def _classifier_rank_step(torch, cfg, images, labels, device):
    from iqc_tpu_torch.data.pipeline import ArrayDataset
    from iqc_tpu_torch.train.train_resnet import ResNetTrainer

    tr = ResNetTrainer(cfg, device=device)
    tr.setup_data(ArrayDataset(images, labels))
    tr.build(steps_per_epoch=2)
    m = tr.train_step(images[:8], labels[:8])
    return tr, {k: float(v) for k, v in m.items()}


def _bn_case(torch, device, mesh, pm):
    """A train-mode BatchNorm on the global batch (flat and textured halves)
    or, on a mesh, on this rank's rows: outputs, statistics, gradients."""
    import numpy as np

    from iqc_tpu_torch.models.layers import BatchNorm, set_mesh

    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 1.5, (8, 16, 20, 20)).astype(np.float32)
    x[:4] = 0.7 + rng.normal(0, 1e-3, (4, 16, 1, 1)).astype(np.float32)
    w = torch.from_numpy(rng.normal(0, 1, (16, 20, 20)).astype(np.float32)).to(device)
    bn = BatchNorm(16, eps=1e-3).to(device).train()
    xt = torch.from_numpy(x)
    if mesh is not None:
        set_mesh(bn, mesh)
        xt = pm.shard_batch(mesh, xt)
    xt = xt.to(device).requires_grad_(True)
    y = bn(xt)
    (y * w).sum().backward()
    dw, db = bn.weight.grad, bn.bias.grad
    if mesh is not None:
        dw, db = pm.all_reduce_sum(mesh, dw), pm.all_reduce_sum(mesh, db)
    return {k: v.detach().cpu() for k, v in (("y", y), ("dx", xt.grad), ("dweight", dw),
                                             ("dbias", db), ("mean", bn.running_mean),
                                             ("var", bn.running_var))}


def _loss_case(torch, device, mesh, pm):
    """The YOLO loss of random head outputs on 8 images at 64^2 of which two
    hold no box: the total (on a mesh, the shares summed) and num_fg."""
    import numpy as np

    from iqc_tpu_torch.models.yolo import STRIDES, feature_shapes
    from iqc_tpu_torch.ops.nms import make_anchors
    from iqc_tpu_torch.train.yolo_loss import yolo_loss

    anchors, strides = make_anchors(feature_shapes((64, 64)), STRIDES, device=device)
    a = anchors.shape[0]
    rng = np.random.default_rng(1)
    xy = rng.uniform(4, 40, (8, 3, 2)).astype(np.float32)
    valid = np.ones((8, 3), bool)
    valid[:2] = False
    arrays = [rng.normal(0, 1, (8, a, 32)).astype(np.float32),
              rng.normal(-2, 1, (8, a, 5)).astype(np.float32),
              np.concatenate([xy, xy + rng.uniform(8, 20, (8, 3, 2)).astype(np.float32)], -1),
              rng.integers(0, 5, (8, 3)).astype(np.int64), valid]
    t = [torch.from_numpy(v) for v in arrays]
    if mesh is not None:
        t = pm.shard_batch(mesh, t)
    t = [v.to(device) for v in t]
    total, parts = yolo_loss(t[0], t[1], anchors, strides, t[2], t[3], t[4], 8, mesh=mesh)
    if mesh is not None:
        total, fg = pm.all_reduce_sum(mesh, torch.stack([total, parts["num_fg"]]))
        return float(total), float(fg)
    return float(total), float(parts["num_fg"])


def _timed_steps(torch, tr, rows, global_b, steps=10, warmup=3):
    """Wall ms of train steps on batches already on the device (median of
    ``steps`` after ``warmup``)."""
    ms = []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr._step(*rows, inbatch_mosaic=False, global_b=global_b)
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t) * 1e3)
    return sorted(ms)[len(ms) // 2], ms


def _step_profile(torch, fn):
    """One call of fn under torch.profiler: wall ms, device kernels and
    their summed ms, the idle share, the c10d collectives called (count
    and host ms) and the NCCL kernels (count and device ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    c10d = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith("c10d::")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"wall_ms": wall, "kernels": len(kernels), "device_ms": busy, "idle": 1 - busy / wall,
            "collectives": len(c10d),
            "collective_host_ms": sum(e.time_range.elapsed_us() for e in c10d) / 1e3,
            "nccl_kernels": len(nccl),
            "nccl_device_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3}


def multi_device_rank(out_dir):
    """One rank of phase 13, started by torch.distributed.run: the plain
    references first, in a process that has not joined the group (a mesh
    of 1), then the group (NCCL on the card) and the same work sharded
    over it; writes rank<r>.json into ``out_dir``. Exits nonzero on the
    first check that fails."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from iqc_tpu_torch import weights
    from iqc_tpu_torch.config import RESNET_TRAINING_PROFILE, YOLO_TRAINING_PROFILE
    from iqc_tpu_torch.models.ensemble import EnsemblePredictor
    from iqc_tpu_torch.parallel import mesh as pm
    from iqc_tpu_torch.train import train_resnet, train_yolo

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        torch.cuda.synchronize(device)

    out = {"rank": rank, "world": world, "device": str(device)}
    tmp = os.path.join(out_dir, f"ckpt{rank}")

    # 1. the plain references (no group yet: every entry point takes its
    # single-device path)
    frames = _frames(640, range(8))
    pred = EnsemblePredictor(device=device)
    ref_run = {k: v.cpu().numpy() for k, v in pred.run(frames)._asdict().items()}
    ref_full = pred.run_full_host(frames)
    ycfg = {**train_yolo.config_from_profile(YOLO_TRAINING_PROFILE),
            "batch_size": 8, "compute_dtype": "float32", "device_mosaic": False,
            "mosaic": 0.0, "mixup": 0.0, "checkpoint_dir": tmp}
    shipped = weights.read_checkpoint(os.path.join(REPO, YOLO_CKPT))
    corpus = _corpus(torch, 16, ycfg["image_size"], ycfg["max_boxes"], "cpu")
    batches = [tuple(x[i:i + 8] for x in corpus) for i in (0, 8)]
    ref_tr, ref_parts, ref_first = _yolo_rank_steps(torch, ycfg, shipped, batches, sync, device)
    del ref_tr
    rcfg = {**train_resnet.config_from_profile(RESNET_TRAINING_PROFILE), "image_size": 224,
            "batch_size": 8, "compute_dtype": "float32", "checkpoint_dir": tmp}
    rs = rcfg["image_size"]
    cls_images = _frames(rs, range(100, 116))
    cls_labels = (np.arange(16) % 5).astype(np.int32)
    ref_cls, ref_cls_m = _classifier_rank_step(torch, rcfg, cls_images, cls_labels, device)
    ref_cls_params = {k: v.detach().clone() for k, v in ref_cls.state.params.items()}
    ref_cls_stats = {k: v.detach().clone() for k, v in ref_cls.state.batch_stats.items()}
    del ref_cls
    ref_bn = _bn_case(torch, device, None, pm)
    ref_loss = _loss_case(torch, device, None, pm)
    timing = {}
    bcfg = {**ycfg, "batch_size": 16, "compute_dtype": "bfloat16"}
    tr1 = train_yolo.YOLOTrainer(bcfg, device=device)
    tr1.build(steps_per_epoch=16)
    rows16 = tuple(x[:16].to(device) for x in _corpus(torch, 16, 640, 64, "cpu"))
    timing["one_card_ms"], timing["one_card_step_ms"] = _timed_steps(torch, tr1, rows16, 16)
    timing["one_card_profile"] = _step_profile(torch, lambda: tr1._step(
        *rows16, inbatch_mosaic=False, global_b=16))
    del tr1
    torch.cuda.empty_cache()
    sync()

    # 2. the group and its mesh
    t0 = time.perf_counter()
    dev = pm.distributed_init("cuda", timeout_s=120)
    spec = pm.create_mesh(device=dev)
    out["init_s"] = time.perf_counter() - t0
    check(spec.distributed and spec.data_size == world and spec.device == device,
          f"rank {rank}: mesh {spec}")
    backend = torch.distributed.get_backend()
    check(backend == "nccl", f"backend {backend}")
    out["backend"] = backend
    reset_launches()

    # collectives, exactly
    even = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    per = 8 // world
    check(np.array_equal(pm.shard_batch(spec, even).cpu().numpy(),
                         even[rank * per:(rank + 1) * per]), "shard_batch rows")
    ragged = pm.shard_batch(spec, np.ones((world + 1, 2), np.float32)).cpu().numpy()
    real = max(0, min(2, world + 1 - 2 * rank))  # rows of the 2 * world padded ones
    check(ragged.shape[0] == 2 and ragged.sum() == 2 * real,
          f"shard_batch padding {ragged.tolist()}")
    rep = pm.replicate(spec, {"w": torch.full((3,), float(rank + 1), device=device)})["w"]
    check(torch.equal(rep.cpu(), torch.ones(3)), "replicate: not rank 0's values")
    mean = pm.cross_replica_mean(spec, torch.full((4,), float(rank), device=device))
    check(torch.allclose(mean.cpu(), torch.full((4,), (world - 1) / 2)), "cross_replica_mean")
    got = pm.all_gather_rows(spec, torch.tensor([[rank]], device=device)).cpu().flatten()
    check(got.tolist() == list(range(world)), "all_gather_rows")

    # global batch statistics and their gradient, and the loss's normaliser
    bn = _bn_case(torch, device, spec, pm)
    rows = slice(rank * per, (rank + 1) * per)
    bn_err = {k: float((bn[k] - (ref_bn[k][rows] if k in ("y", "dx") else ref_bn[k])).abs().max())
              for k in bn}
    for k, tol in (("y", 1e-5), ("dx", 1e-5), ("mean", 1e-6), ("var", 1e-5), ("dweight", 1e-3),
                   ("dbias", 1e-3)):
        check(bn_err[k] <= tol * max(1.0, float(ref_bn[k].abs().max())),
              f"BatchNorm {k}: {bn_err[k]} from the single-device statistics")
    out["batchnorm_max_abs_err"] = bn_err
    loss = _loss_case(torch, device, spec, pm)
    check(_max_rel(loss[0], ref_loss[0]) <= 1e-5 and loss[1] == ref_loss[1],
          f"the loss's normaliser: {loss} against {ref_loss}")
    out["loss_normaliser"] = {"sharded": loss, "one_device": ref_loss}

    # the sharded YOLO and classifier steps against the plain ones
    tr, parts, first = _yolo_rank_steps(torch, ycfg, shipped, batches, sync, device)
    check(tr.mesh.distributed and tr.mesh.data_size == world, "the YOLO trainer's mesh")
    yerr = {"loss_rel": [_max_rel(p["loss"], r["loss"]) for p, r in zip(parts, ref_parts)]}
    check(yerr["loss_rel"][0] <= 1e-4, f"sharded YOLO step 1: loss {parts[0]} vs {ref_parts[0]}")
    check(yerr["loss_rel"][1] <= 1e-3, f"sharded YOLO step 2: loss {parts[1]} vs {ref_parts[1]}")
    for name in ("params", "batch_stats", "ema"):
        errs = [float(((first[name][k] - v).abs() - 2e-4 * v.abs()).max())
                for k, v in ref_first[name].items()]
        yerr[name] = max(errs)
        check(yerr[name] <= 2e-5, f"sharded YOLO step 1: {name} beyond rtol 2e-4 / atol 2e-5 "
                                  f"by {yerr[name]}")
    out["yolo_step"] = {"parts": parts, "one_device_parts": ref_parts, **yerr}
    out["hash_yolo"] = _digest(list(tr.state.params.values()) + list(tr.ema_params.values())
                               + list(tr.state.batch_stats.values()))
    # sharded validation: each rank predicts its rows, the detections gathered
    preds = tr.predict_batches([batches[0][0]])
    out["validation_detections"] = int(sum(len(p["scores"]) for p in preds))
    del tr
    ctr, m = _classifier_rank_step(torch, rcfg, cls_images, cls_labels, device)
    check(_max_rel(m["loss"], ref_cls_m["loss"]) <= 1e-5 and m["accuracy"] == ref_cls_m[
        "accuracy"], f"sharded classifier step: {m} vs {ref_cls_m}")
    p_err = max(float(((ctr.state.params[k].detach() - v).abs() - 2e-4 * v.abs()).max())
                for k, v in ref_cls_params.items())
    s_err = max(float(((ctr.state.batch_stats[k] - v).abs() - 2e-4 * v.abs()).max())
                for k, v in ref_cls_stats.items())
    check(p_err <= 4e-3 and s_err <= 2e-5, f"sharded classifier step: params {p_err}, "
                                           f"statistics {s_err} beyond the bounds")
    out["classifier_step"] = {"metrics": m, "one_device": ref_cls_m, "params_excess": p_err,
                              "stats_excess": s_err}
    out["hash_classifier"] = _digest(list(ctr.state.params.values())
                                     + list(ctr.state.batch_stats.values()))
    del ctr

    # run_sharded and the sharded full forward against run and run_full_host
    got = {k: v.cpu().numpy() for k, v in pred.run_sharded(frames, spec)._asdict().items()}
    full = pred.run_full_sharded(frames, spec)
    sync()
    for f in ("valid", "classes", "crop_classified", "final_severity", "severity_counts"):
        check(np.array_equal(got[f], ref_run[f]), f"run_sharded: {f} differs from run")
    v = ref_run["valid"]
    box_err = float(np.abs(got["boxes"][v] - ref_run["boxes"][v]).max()) if v.any() else 0.0
    score_err = float(np.abs(got["ensemble_conf"][v] - ref_run["ensemble_conf"][v]).max()) \
        if v.any() else 0.0
    check(box_err <= 1.0 and score_err <= 1e-3, f"run_sharded: boxes {box_err} px, "
                                                f"scores {score_err} from run")
    check(np.array_equal(full[0].valid, ref_full[0].valid), "run_full_sharded: valid differs")
    agree = float(np.mean(full[1] == ref_full[1]))
    check(agree >= MASK_AGREEMENT, f"run_full_sharded: masks agree on {agree:.6f} of pixels")
    out["run_sharded"] = {"detections": int(v.sum()), "classified": int(got["crop_classified"].sum()),
                          "box_max_abs_err_px": box_err, "score_max_abs_err": score_err,
                          "mask_agreement": agree, "masks_on": int(full[1].sum())}
    out["launches"] = read_launches()

    # 3. the sharded step's time at global batch 16 (bf16), against one card
    tr = train_yolo.YOLOTrainer(bcfg, device=device)
    tr.build(steps_per_epoch=16)
    rows16 = pm.shard_batch(spec, _corpus(torch, 16, 640, 64, "cpu"))
    timing["sharded_ms"], timing["sharded_step_ms"] = _timed_steps(torch, tr, rows16, 16)
    timing["sharded_profile"] = _step_profile(torch, lambda: tr._step(
        *rows16, inbatch_mosaic=False, global_b=16))
    timing["images_per_s"] = 16 / timing["sharded_ms"] * 1e3
    timing["one_card_images_per_s"] = 16 / timing["one_card_ms"] * 1e3
    out["timing"] = timing
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def _run_ranks(n, out_dir, timeout):
    """torch.distributed.run of this script's rank body on n ranks, in a
    process group of its own that is killed whole on a timeout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", os.path.join(REPO, "chip_smoke.py"), "--multi-device-rank",
           out_dir]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        log, _ = proc.communicate()
        print(log[-4000:])
        raise PhaseFailed(f"the ranks ran past {timeout} s (a hung collective?)")
    if proc.returncode != 0:
        print(log[-6000:])
    check(proc.returncode == 0, f"torch.distributed.run exited {proc.returncode}")
    return [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(n)]


def phase_multi_device(torch):
    """Phase 13: the multi-device path on min(cards, 4) NCCL ranks, each rank
    holding it against the unsharded path on its card; then K1-K3 at the
    per-rank shapes."""
    import tempfile

    n = min(torch.cuda.device_count(), 4)
    out_dir = tempfile.mkdtemp(prefix="iqc_multi_")
    t = time.perf_counter()
    ranks = _run_ranks(n, out_dir, timeout=420)
    wall = time.perf_counter() - t
    for key in ("hash_yolo", "hash_classifier"):
        check(len({r[key] for r in ranks}) == 1, f"ranks differ after the steps ({key})")
    r0 = ranks[0]
    print(f"{n} NCCL rank(s) (torch.distributed.run, {r0['backend']}) in {wall:.2f} s, group "
          f"joined in {r0['init_s']:.2f} s: shard_batch, replicate, cross_replica_mean, "
          f"all_gather exact; BatchNorm on flat and textured halves within "
          f"{max(r0['batchnorm_max_abs_err'].values()):.3e} of the one-device statistics and "
          f"gradients; the loss normaliser {r0['loss_normaliser']}")
    ys, cs, rs = r0["yolo_step"], r0["classifier_step"], r0["run_sharded"]
    print(f"sharded YOLOv8n step (640^2, global batch 8, fp32, from the shipped checkpoint): "
          f"losses within {ys['loss_rel']} of one device, params/EMA/statistics within the "
          f"bounds (excess {ys['params']:.2e}/{ys['ema']:.2e}/{ys['batch_stats']:.2e}); "
          f"classifier step loss {cs['metrics']['loss']:.6f} vs {cs['one_device']['loss']:.6f}; "
          f"ranks bitwise equal after the steps: {n} of {n}")
    print(f"run_sharded of 8 frames at the shipped profile: {rs['detections']} detections, "
          f"{rs['classified']} classified, boxes within {rs['box_max_abs_err_px']:.3e} px, "
          f"scores within {rs['score_max_abs_err']:.3e} of run; run_full_sharded masks agree "
          f"on {rs['mask_agreement']:.6f} of pixels ({rs['masks_on']} on); K1-K3 launches on "
          f"the sharded path {r0['launches']}")
    check(r0["launches"]["suppress"] >= 3 and r0["launches"]["grow_clean"] >= 1
          and r0["launches"]["clean"] >= 1, f"the sharded path's launches {r0['launches']}")
    tm = r0["timing"]
    print(f"YOLOv8n bf16 step at global batch 16: {tm['sharded_ms']:.2f} ms on {n} ranks "
          f"({tm['images_per_s']:.1f} images/s), {tm['one_card_ms']:.2f} ms on one card "
          f"({tm['one_card_images_per_s']:.1f} images/s); profiled step, sharded "
          f"{tm['sharded_profile']}, one card {tm['one_card_profile']}")
    # K1-K3 at the per-rank shapes of the sharded full forward
    dev = torch.device("cuda")
    per = 8 // n
    seg = min(64, per * 16)
    rows = {}
    for c in kernel_cases(torch, dev, per, seg):
        got, want = c["wrapper"](), c["plain"]()
        err = max_err(torch, got, want)
        check(err == 0, f"{c['name']} {c['shape']} differs from its plain version")
        bound_ms, bound_by = bound(c["n_bytes"], c["n_ops"])
        rows[c["name"]] = {"shape": c["shape"], "ms": graph_ms(torch, c["raw"]),
                           "wrapper_ms": cuda_time_ms(c["wrapper"]),
                           "plain_ms": cuda_time_ms(c["plain"], warmup=2, iters=10),
                           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
    print("K1-K3 at the per-rank shapes " + ", ".join(
        f"{k} {v['shape']} {v['ms']:.5f} ms" for k, v in rows.items()) + ": equal to plain")
    return {"ranks": n, "wall_s": wall, "rank0": r0, "launches": r0["launches"],
            "kernels": rows}


def main(only_multi_device: bool = False) -> int:
    """The smoke; ``only_multi_device`` runs the environment, the build and
    phase 13 alone (for a host with several cards)."""
    t_all = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available; this script runs on an NVIDIA GPU", flush=True)
        return 1
    if not os.path.isdir(os.path.join(REPO, "iqc_tpu_torch")):
        print("FAIL: iqc_tpu_torch/ not found beside chip_smoke.py; run from a checkout",
              flush=True)
        return 1
    sys.path.insert(0, REPO)
    try:
        with Phase("environment", 120):
            smi = phase_environment(torch)
        with Phase("build", 420):
            phase_build()
        if only_multi_device:
            with Phase("multi-device", 600):
                multi = phase_multi_device(torch)
            print(json.dumps({"multi_device": multi}))
            print(f"total wall time {time.perf_counter() - t_all:.2f} s")
            print(smi)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return 0
        with Phase("kernels", 180):
            kernels = phase_kernels(torch)
        images = [defect_image(s) for s in range(8)]
        with Phase("main path", 300):
            det = build_detector(torch)
            det, launches, conf = phase_main_path(torch, images, det)
        with Phase("int8 cross-check", 240):
            int8_layers = phase_cross_check_int8(torch, det, images[0], conf)
        with Phase("fp32 and bf16", 300):
            det32, det16, launches32 = phase_fp32_bf16(torch, images, conf)
        with Phase("serving", 300):
            serving, per_request, detection_only = phase_serving(torch, images, conf)
        with Phase("networks", 300):
            networks = phase_networks(torch, det, det32, det16)
        with Phase("captured and exported", 300):
            captured = phase_captured(torch, images, det, det32, det16)
        del det, det32, det16
        torch.cuda.empty_cache()
        with Phase("options and entry points", 480):
            option_launches = phase_options(torch, images, conf)
            yolo_launches, seg_launches = phase_entry_points(torch, images)
            standalone = standalone_kernel_rows(torch)
            preprocessing = preprocessing_times(torch)
        torch.cuda.empty_cache()
        with Phase("training", 300):
            training = phase_training(torch)
        torch.cuda.empty_cache()
        with Phase("classifier training", 300):
            classifier = phase_classifier_training(torch)
        torch.cuda.empty_cache()
        with Phase("multi-device", 600):
            multi = phase_multi_device(torch)
    except Exception as e:  # every phase failure ends the run without a result
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    for row in kernels:
        counter = row.pop("counter")
        row["launches"] = launches[counter]
        row["launches_fp32_main_path"] = launches32[counter]
        row["launches_serving"] = serving[counter]
        row["launches_per_http_request"] = per_request[counter]
        row["launches_per_detection_only_request"] = detection_only[counter]
        row["launches_options"] = {k: v[counter] for k, v in option_launches.items()}
        row["launches_yolo_detector"] = yolo_launches[counter]
        row["launches_image_segmentator"] = seg_launches[counter]
        row["launches_5_replays"] = captured["launches_5_replays"][counter]
        if counter in standalone:
            row["segmentator_shapes"] = standalone[counter]
        row["launches_training"] = training["launches"][counter]
        row["launches_classifier_training"] = classifier["launches"][counter]
        row["launches_multi_device"] = multi["launches"][counter]
        row["multi_device_shape"] = multi["kernels"][counter]
        if counter == "suppress":
            row["training_shape"] = training["k1"]
    print(json.dumps({"int8_resnet_layers": int8_layers}))
    print(json.dumps({"captured": captured}))
    print(json.dumps({"networks": networks}))
    print(json.dumps({"preprocessing": preprocessing}))
    for key in ("entry_point", "served_checkpoint", "step_times", "card_vs_cpu"):
        print(json.dumps({f"training_{key}": training[key]}))
    for key in ("entry_point", "served_checkpoint", "step_times", "card_vs_cpu"):
        print(json.dumps({f"classifier_{key}": classifier[key]}))
    print(json.dumps({"multi_device": {k: v for k, v in multi.items() if k != "kernels"}}))
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-device-rank"]:
        sys.exit(multi_device_rank(sys.argv[2]))
    sys.exit(main(only_multi_device=sys.argv[1:] == ["--only-multi-device"]))
