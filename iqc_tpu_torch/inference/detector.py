"""Quality-control detector: the request entry point.

validate -> preprocess (to float, resize to the model input, the optional
denoise and contrast steps) -> the full forward (detection, crop
classification, fusion, segmentation) -> result assembly ->
post-processing, on one device. ``predict`` serves one image
(with ``include_segmentation=False``, the detection-only forward),
``predict_batch`` stacks images into one device batch (padded to a power of
two, at most ``processing.batch_size``), ``predict_stream`` serves an
iterable of frames one by one or in micro-batches.

Images are numpy arrays: HxWx3 or HxW uint8, or a 1-D buffer of encoded
JPEG or PNG bytes (``runtime.codec.decode_image``, at full size). A failure
inside a request is returned as ``{"error": ...}``. Per-request latency goes
into a ``runtime.LatencyHistogram``.

``predict`` and ``predict_batch`` run on one long-lived thread of the
detector, whichever thread calls them. PyTorch keeps per-thread state for
the card (cuDNN's execution plans among it) that a new thread builds again on
its first forward, at 150-270 ms on an H100; a threaded HTTP server calls
from a new thread for every request. The card runs one forward at a time
either way.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from iqc_tpu_torch.config import SystemConfig
from iqc_tpu_torch.inference.postprocess import PostProcessor
from iqc_tpu_torch.inference.segmentation import ImageSegmentator
from iqc_tpu_torch.models.ensemble import EnsemblePredictor
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops.jit_utils import hoisted_jit
from iqc_tpu_torch.runtime import LatencyHistogram
from iqc_tpu_torch.runtime.codec import decode_image
from iqc_tpu_torch.utils.tracing import StageTimes, stage_timer

logger = logging.getLogger(__name__)

_thread_role = threading.local()


def _mark_device_thread() -> None:
    _thread_role.device = True


@hoisted_jit
def _preprocess_frames(images: torch.Tensor, resize, denoise: bool,
                       enhance_contrast: bool) -> torch.Tensor:
    """[B,H,W,3] uint8 -> float [0,1] at ``resize`` (None: as it is), then the
    bilateral denoise (d 9, sigmas 75) and the per-image CLAHE contrast step
    where asked. A pure function of its arguments, so one wrapper serves
    every detector: one CUDA graph per frame shape, device and flags."""
    x = imops.to_float(images)
    if resize is not None and tuple(x.shape[1:3]) != resize:
        x = imops.resize_bilinear(x, resize)
    if denoise:
        x = imops.bilateral_filter(x, d=9, sigma_color=75.0, sigma_space=75.0)
    if enhance_contrast:
        x = imops.enhance_contrast_rgb(x)
    return x


class QualityControlDetector:
    def __init__(self, yolo_weights: Optional[str] = None,
                 resnet_weights: Optional[str] = None,
                 config: Optional[SystemConfig] = None, device="cuda",
                 int8_state: Optional[Dict] = None):
        """``int8_state``: quantized networks to serve instead of calibrating
        anew (``EnsemblePredictor``)."""
        if isinstance(config, dict):
            config = SystemConfig.from_dict(config)
        self.config = config or SystemConfig()
        self.device = torch.device(device)
        self.ensemble_predictor = EnsemblePredictor(
            yolo_weights=yolo_weights, resnet_weights=resnet_weights,
            config=self.config, device=self.device, int8_state=int8_state)
        self.segmentator = ImageSegmentator(self.config, device=self.device)
        self.postprocessor = PostProcessor(self.config)
        self._stats_lock = threading.Lock()
        self.performance_stats = {"total_predictions": 0, "total_time": 0.0, "average_time": 0.0}
        self._latency = LatencyHistogram()
        self._device_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="qc-device",
                                                 initializer=_mark_device_thread)
        weakref.finalize(self, self._device_thread.shutdown, wait=False)

    def _on_device_thread(self, fn, *args):
        """``fn(*args)`` on the detector's long-lived thread (inline when
        already there)."""
        if getattr(_thread_role, "device", False):
            return fn(*args)
        return self._device_thread.submit(fn, *args).result()

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] uint8 on the device -> float [0,1] at the resize size,
        then the bilateral denoise (d 9, sigmas 75) and the per-image CLAHE
        contrast step where the config asks for them (``_preprocess_frames``,
        the config's flags as static arguments)."""
        pre = self.config.processing.preprocessing
        resize = tuple(int(v) for v in pre.resize) if pre.resize is not None else None
        with torch.inference_mode():
            return _preprocess_frames(images, resize, bool(pre.denoise),
                                      bool(pre.enhance_contrast))

    @staticmethod
    def _to_rgb_array(image) -> Optional[np.ndarray]:
        """RGB uint8 [H,W,3] of a valid input, else None (decodes a 1-D
        buffer once)."""
        if image is None or not isinstance(image, np.ndarray):
            return None
        if image.ndim == 1:
            return decode_image(image.tobytes())
        if image.ndim not in (2, 3) or image.size == 0:
            return None
        if image.ndim == 2:
            return np.repeat(image[..., None], 3, axis=-1)
        return image

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array)).to(self.device)

    def predict(self, image: np.ndarray, include_segmentation: bool = True) -> Dict:
        """The result of one image; without segmentation through the
        detection-only forward."""
        return self._on_device_thread(self._predict, image, include_segmentation)

    def _predict(self, image: np.ndarray, include_segmentation: bool) -> Dict:
        start = time.perf_counter()
        rgb = self._to_rgb_array(image)
        if rgb is None:
            return {"error": "Invalid image input"}
        try:
            stages = StageTimes()
            with stage_timer(stages, "preprocess", self.device):
                processed = self._preprocess(self._upload(rgb)[None])[0]
            shape = tuple(processed.shape)
            segmentation_results: Dict = {}
            if include_segmentation:
                with stage_timer(stages, "ensemble+segmentation", self.device):
                    out, masks, seg_stats = self.ensemble_predictor.run_full_host(processed[None])
                    ensemble_results = self.ensemble_predictor.build_result(out, 0, shape)
                    if ensemble_results.get("detections"):
                        s = masks.shape[1]
                        segmentation_results = self.segmentator._assemble_result(
                            ensemble_results["detections"][:s],
                            self.segmentator._unpack(masks[0], seg_stats[0]),
                            out.boxes[0][:s], shape[:2],
                        )
            else:
                with stage_timer(stages, "ensemble", self.device):
                    ensemble_results = self.ensemble_predictor.predict(processed)
            with stage_timer(stages, "postprocess"):
                final = self.postprocessor.process_results(
                    ensemble_results, segmentation_results, shape)
            elapsed = time.perf_counter() - start
            self._update_stats(elapsed)
            final.update({
                "total_inference_time_ms": elapsed * 1000,
                "stage_times_ms": stages.as_dict(),
                "ensemble_confidence": ensemble_results.get("ensemble_confidence", 0.0),
                "global_classification": ensemble_results.get("global_classification", {}),
                "processing_pipeline": "fused(yolo+nms+crop-resnet) + segmentation + postprocess",
                "image_metadata": {
                    "original_shape": tuple(image.shape),
                    "channels": image.shape[2] if image.ndim > 2 else 1,
                    "dtype": str(image.dtype),
                    "size_bytes": int(image.nbytes),
                },
            })
            return final
        except Exception as e:  # a request's failure boundary
            logger.exception("prediction failed")
            return {"error": str(e)}

    def predict_batch(self, images: List[np.ndarray],
                      max_workers: Optional[int] = None) -> List[Dict]:
        """One device batch for all images; ``max_workers`` is accepted for
        API compatibility and unused (no thread fan-out)."""
        return self._on_device_thread(self._predict_batch, images)

    def _predict_batch(self, images: List[np.ndarray]) -> List[Dict]:
        start = time.perf_counter()
        if not images:
            return []
        try:
            rgbs = [self._to_rgb_array(im) for im in images]
            if any(r is None for r in rgbs):
                return [{"error": "Invalid image input", "batch_index": i} if r is None
                        else self.predict(images[i]) for i, r in enumerate(rgbs)]
            size = tuple(self.config.processing.preprocessing.resize
                         or self.config.processing.input_size)
            frames = []
            for r in rgbs:
                t = self._upload(r)
                if tuple(r.shape[:2]) != size:
                    t = (imops.resize_bilinear(imops.to_float(t), size) * 255).to(torch.uint8)
                frames.append(t)
            stacked = torch.stack(frames)
            # pad to the next power of two (at most batch_size) with copies of
            # the last image, as the JAX package does: the padded rows take
            # part in the batch-wide crop and segmentation pools, so results
            # match it; they are dropped below
            n = len(images)
            cap = max(int(self.config.processing.batch_size), 1)
            bucket = 1
            while bucket < n and bucket < cap:
                bucket *= 2
            if n < bucket:
                stacked = torch.cat([stacked, stacked[-1:].expand(bucket - n, *stacked.shape[1:])])
            processed = self._preprocess(stacked)
            out, masks, seg_stats = self.ensemble_predictor.run_full_host(processed)
            shape = tuple(processed.shape[1:])
            ens_results = [self.ensemble_predictor.build_result(out, i, shape) for i in range(n)]
            s = masks.shape[1]
            results: List[Dict] = []
            for i, ens in enumerate(ens_results):
                seg = self.segmentator._assemble_result(
                    ens["detections"][:s], self.segmentator._unpack(masks[i], seg_stats[i]),
                    out.boxes[i][:s], shape[:2],
                ) if ens.get("detections") else {}
                final = self.postprocessor.process_results(ens, seg, shape)
                final["batch_index"] = i
                final["ensemble_confidence"] = ens.get("ensemble_confidence", 0.0)
                final["global_classification"] = ens.get("global_classification", {})
                results.append(final)
            total = time.perf_counter() - start
            self._update_stats(total, count=n)
            batch_stats = {
                "batch_size": n,
                "total_batch_time_ms": total * 1000,
                "average_time_per_image_ms": total * 1000 / n,
                "throughput_images_per_second": n / total,
            }
            for r in results:
                r["batch_statistics"] = batch_stats
            return results
        except Exception as e:  # a request's failure boundary
            logger.exception("batch prediction failed")
            return [{"error": str(e), "batch_index": i} for i in range(len(images))]

    def predict_stream(self, image_generator: Iterable[np.ndarray],
                       callback: Optional[Callable[[Dict], None]] = None,
                       micro_batch: int = 1):
        """Results of an iterable of frames, each with ``stream_index`` and
        ``timestamp``; with ``micro_batch`` > 1 consecutive frames go through
        ``predict_batch`` together. Returns a generator, or with ``callback``
        calls it for each result (and once with ``{"error": ...}`` if the
        stream fails) and returns None."""

        def produce():
            if micro_batch <= 1:
                for i, image in enumerate(image_generator):
                    result = self.predict(image)
                    result["stream_index"] = i
                    result["timestamp"] = time.time()
                    yield result
                return
            idx = 0
            it = iter(image_generator)
            while True:
                chunk = list(itertools.islice(it, micro_batch))
                if not chunk:
                    return
                for result in self.predict_batch(chunk):
                    result["stream_index"] = idx
                    result["timestamp"] = time.time()
                    idx += 1
                    yield result

        if callback is not None:
            try:
                for result in produce():
                    callback(result)
            except Exception as e:  # the stream's failure boundary, reported to the callback
                logger.exception("stream prediction failed")
                callback({"error": str(e)})
            return None
        return produce()

    def _update_stats(self, elapsed: float, count: int = 1) -> None:
        with self._stats_lock:
            s = self.performance_stats
            s["total_predictions"] += count
            s["total_time"] += elapsed
            s["average_time"] = s["total_time"] / s["total_predictions"]
        self._latency.record(elapsed * 1000 / max(count, 1))

    def get_performance_stats(self) -> Dict:
        with self._stats_lock:
            stats = dict(self.performance_stats)
        if stats["total_predictions"] > 0:
            stats.update({
                "average_time_ms": stats["average_time"] * 1000,
                "throughput_images_per_second": (
                    1.0 / stats["average_time"] if stats["average_time"] > 0 else 0.0),
                "total_time_minutes": stats["total_time"] / 60,
                "latency_percentiles_ms": {
                    f"p{p}": self._latency.percentile(p) for p in (50, 95, 99)},
            })
        return stats

    def reset_performance_stats(self) -> None:
        with self._stats_lock:
            self.performance_stats = {"total_predictions": 0, "total_time": 0.0,
                                      "average_time": 0.0}

    def get_system_info(self) -> Dict:
        if self.device.type == "cuda":
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        else:
            devices = [str(self.device)]
        return {
            "detector_status": "operational",
            "components_loaded": {
                "ensemble_predictor": self.ensemble_predictor is not None,
                "segmentator": self.segmentator is not None,
                "postprocessor": self.postprocessor is not None,
            },
            "performance_stats": self.get_performance_stats(),
            "configuration": self.config.to_dict(),
            "ensemble_info": self.ensemble_predictor.get_model_info(),
            "devices": devices,
        }

    def update_config(self, new_config: Dict) -> None:
        """Validated merge of a nested dict into the configuration. Thresholds,
        weights and qc_specific overrides reach the predictor at its next
        request; nothing is rebuilt."""
        self.config = self.config.update(new_config)
        self.postprocessor.update_config(self.config)
        m = self.config.model
        ens = self.ensemble_predictor
        with ens.params_lock:
            ens.confidence_threshold = m.confidence_threshold
            ens.nms_threshold = m.nms_threshold
            ens.ensemble_weights = dict(m.ensemble_weights)
            ens.config = self.config

    def benchmark(self, test_images: List[np.ndarray], iterations: int = 1,
                  batched: bool = True) -> Dict:
        """Wall time per image over ``iterations`` passes (one
        ``predict_batch`` per pass, or one ``predict`` per image), with
        throughput and success figures."""
        all_times: List[float] = []
        all_results: List[Dict] = []
        for _ in range(iterations):
            if batched:
                t0 = time.perf_counter()
                rs = self.predict_batch(test_images)
                per = (time.perf_counter() - t0) / max(len(test_images), 1)
                all_times.extend([per] * len(test_images))
                all_results.extend(rs)
            else:
                for image in test_images:
                    t0 = time.perf_counter()
                    all_results.append(self.predict(image))
                    all_times.append(time.perf_counter() - t0)
        times_ms = np.asarray(all_times) * 1000
        ok = [r for r in all_results if "error" not in r]
        n_det = sum(len(r.get("detections", [])) for r in ok)
        rate = len(all_times) / max(float(np.sum(all_times)), 1e-9)
        return {
            "total_images": len(test_images) * iterations,
            "iterations": iterations,
            "timing_statistics": {
                "mean_ms": float(np.mean(times_ms)),
                "median_ms": float(np.median(times_ms)),
                "min_ms": float(np.min(times_ms)),
                "max_ms": float(np.max(times_ms)),
                "std_ms": float(np.std(times_ms)),
                "p95_ms": float(np.percentile(times_ms, 95)),
                "p99_ms": float(np.percentile(times_ms, 99)),
            },
            "throughput": {"images_per_second": rate, "images_per_minute": rate * 60},
            "accuracy_metrics": {
                "success_rate": len(ok) / max(len(all_results), 1),
                "average_detections_per_image": n_det / max(len(ok), 1),
                "average_confidence": float(
                    np.mean([r.get("ensemble_confidence", 0.0) for r in ok])) if ok else 0.0,
            },
        }
