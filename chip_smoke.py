#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each under a deadline and printed with its wall time:
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: one nvcc call compiles iqc_tpu_torch/csrc/*.cu for sm_90a;
  3. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the main path's shapes (must be exactly equal), with its time, the
     plain version's time and its bound;
  4. main path: the shipped serving profile (YOLOv8n 640^2, ResNet-50 on
     128^2 crops, crop pool 128, seg pool 64, float32) from the shipped
     checkpoints; 4 x predict and 1 x predict_batch of 8 on seeded synthetic
     640^2 defect images, with every kernel's launch counter read around it;
  5. cross-check: one request again on the CPU, compared with the card's.
Then one JSON line of kernel measurements, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits nonzero without that line.
Needs one CUDA device; exits nonzero at once without one.
"""

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores; a 32-bit integer word
# operation is counted at the float32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

CONF_FALLBACKS = (0.7, 0.5, 0.3)
MASK_AGREEMENT = 0.999


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


def phase_kernels(torch):
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    dev = torch.device("cuda")
    rows = []

    boxes = nms_inputs(torch, dev)
    got = nms_kernel.suppress(boxes, 0.5, 16)
    want = nms_kernel.suppress_plain(boxes, 0.5, 16)
    torch.cuda.synchronize()
    err = (got.int() - want.int()).abs().max().item()
    check(err == 0, f"suppress differs from its plain version on {int((got != want).sum())} boxes")
    b, k = boxes.shape[:2]
    words = (k + 31) // 32
    n_bytes = boxes.numel() * 4 + b * k
    n_ops = b * (k * (k - 1) // 2) * 14 + 16 * b * k * words * 2
    rows.append(("suppress", "iqc_tpu_torch/csrc/suppress.cu", "iqc_tpu/ops/pallas_nms.py:34",
                 "suppress", lambda: nms_kernel.suppress(boxes, 0.5, 16),
                 lambda: nms_kernel.suppress_plain(boxes, 0.5, 16), err, n_bytes, n_ops))
    print(f"suppress [{b},{k},4]: equal to plain, kept {int(got.sum())} of {b * k}")

    m_raw, seeds, allow = morph_inputs(torch, dev)
    n, r = seeds.shape[:2]
    wpr = n * r * r // 32
    got = morph_kernel.grow_clean(seeds, allow, 24, 16)
    want = morph_kernel.grow_clean_plain(seeds, allow, 24, 16)
    torch.cuda.synchronize()
    err = (got.int() - want.int()).abs().max().item()
    check(err == 0, f"grow_clean differs from its plain version on {int((got != want).sum())} px")
    rows.append(("grow_clean", "iqc_tpu_torch/csrc/morph.cu", "iqc_tpu/ops/pallas_morph.py:146",
                 "grow_clean", lambda: morph_kernel.grow_clean(seeds, allow, 24, 16),
                 lambda: morph_kernel.grow_clean_plain(seeds, allow, 24, 16), err,
                 3 * n * r * r, wpr * (24 + 27) * 10))
    print(f"grow_clean [{n},{r},{r}]: equal to plain, {int(got.sum())} px set")

    # on the main path the all-ones ROI of the watershed method rides along
    m_raw = torch.cat([m_raw, torch.ones_like(m_raw[:1])])
    got = morph_kernel.clean(m_raw, 16)
    want = morph_kernel.clean_plain(m_raw, 16)
    torch.cuda.synchronize()
    err = (got.int() - want.int()).abs().max().item()
    check(err == 0, f"clean differs from its plain version on {int((got != want).sum())} px")
    rows.append(("clean", "iqc_tpu_torch/csrc/morph.cu", "iqc_tpu/ops/pallas_morph.py:162",
                 "clean", lambda: morph_kernel.clean(m_raw, 16),
                 lambda: morph_kernel.clean_plain(m_raw, 16), err, 2 * (n + 1) * r * r,
                 (n + 1) * r * r // 32 * 27 * 10))
    print(f"clean [{n + 1},{r},{r}]: equal to plain, {int(got.sum())} px set")

    measured = []
    for name, src, replaces, key, kern, plain, err, n_bytes, n_ops in rows:
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain, warmup=2, iters=10)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        print(f"{name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms "
              f"({bound_by}: {n_bytes} bytes, {n_ops} ops); no single PyTorch call computes it")
        measured.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "counter": key, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return measured


def phase_main_path(torch, images):
    from iqc_tpu_torch.inference.detector import QualityControlDetector
    from iqc_tpu_torch.ops import morph_kernel, nms_kernel

    t0 = time.perf_counter()
    det = QualityControlDetector(device="cuda")
    src = det.ensemble_predictor.weights_source
    print(f"detector built in {time.perf_counter() - t0:.2f} s, weights {src}")
    check(src == {"yolo": "checkpoint", "resnet": "checkpoint"}, f"weights not from checkpoints: {src}")
    m = det.config.model
    print(f"profile: input {det.config.processing.input_size}, YOLOv8 width {m.width_mult} "
          f"depth {m.depth_mult}, ResNet stages {m.resnet_stages} on {m.classifier_input}^2 crops, "
          f"max_detections {m.max_detections}, max_classified {m.max_classified}, crop pool "
          f"{m.max_classified_pool}, seg pool {m.max_segmented_pool}, roi {m.seg_roi_size}, "
          f"{m.compute_dtype}")

    for d in (nms_kernel.LAUNCHES, morph_kernel.LAUNCHES):
        for key in d:
            d[key] = 0
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
    launches = {**nms_kernel.LAUNCHES, **morph_kernel.LAUNCHES}
    print(f"launches on the main path: {launches}")
    errors = [r["error"] for r in results if "error" in r]
    check(not errors, f"requests failed: {errors[:3]}")
    check(any(n_regions(r) for r in results), "no request produced detections with regions")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    print(f"performance: {det.get_performance_stats()}")
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


def main() -> int:
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
        with Phase("kernels", 180):
            kernels = phase_kernels(torch)
        images = [defect_image(s) for s in range(8)]
        with Phase("main path", 240):
            det, launches, conf = phase_main_path(torch, images)
        with Phase("cross-check", 180):
            phase_cross_check(torch, det, images[0], conf)
    except Exception as e:  # every phase failure ends the run without a result
        print(f"FAIL: {type(e).__name__}: {e}", flush=True)
        return 1
    for row in kernels:
        row["launches"] = launches[row.pop("counter")]
    print(f"total wall time {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
