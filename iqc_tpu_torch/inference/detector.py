"""Quality-control detector: the request entry point.

validate -> preprocess (to float, resize to the model input) -> the full
forward (detection, crop classification, fusion, segmentation) -> result
assembly -> post-processing, on one device. ``predict`` serves one image,
``predict_batch`` stacks images into one device batch (padded to a power of
two, at most ``processing.batch_size``).

Images are numpy arrays (HxWx3 or HxW uint8); encoded image bytes are not
decoded here. A failure inside a request is returned as ``{"error": ...}``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from iqc_tpu_torch.config import SystemConfig
from iqc_tpu_torch.inference.postprocess import PostProcessor
from iqc_tpu_torch.inference.segmentation import ImageSegmentator
from iqc_tpu_torch.models.ensemble import EnsemblePredictor
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.utils.tracing import StageTimes, stage_timer

logger = logging.getLogger(__name__)


class QualityControlDetector:
    def __init__(self, yolo_weights: Optional[str] = None,
                 resnet_weights: Optional[str] = None,
                 config: Optional[SystemConfig] = None, device="cuda"):
        if isinstance(config, dict):
            config = SystemConfig.from_dict(config)
        self.config = config or SystemConfig()
        self.device = torch.device(device)
        self.ensemble_predictor = EnsemblePredictor(
            yolo_weights=yolo_weights, resnet_weights=resnet_weights,
            config=self.config, device=self.device)
        self.segmentator = ImageSegmentator(self.config)
        self.postprocessor = PostProcessor(self.config)
        self._stats_lock = threading.Lock()
        self.performance_stats = {"total_predictions": 0, "total_time": 0.0, "average_time": 0.0}
        self._latencies_ms: List[float] = []

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] uint8 on the device -> float [0,1] at the resize size."""
        x = imops.to_float(images)
        resize = self.config.processing.preprocessing.resize
        if resize is not None and tuple(x.shape[1:3]) != tuple(resize):
            x = imops.resize_bilinear(x, tuple(resize))
        return x

    @staticmethod
    def _validate_image(image) -> bool:
        if image is None or not isinstance(image, np.ndarray):
            return False
        return image.ndim in (2, 3) and image.size > 0

    @staticmethod
    def _to_rgb_array(image) -> Optional[np.ndarray]:
        if not QualityControlDetector._validate_image(image):
            return None
        if image.ndim == 2:
            return np.repeat(image[..., None], 3, axis=-1)
        return image

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array)).to(self.device)

    def predict(self, image: np.ndarray) -> Dict:
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

    def predict_batch(self, images: List[np.ndarray]) -> List[Dict]:
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

    def _update_stats(self, elapsed: float, count: int = 1) -> None:
        with self._stats_lock:
            s = self.performance_stats
            s["total_predictions"] += count
            s["total_time"] += elapsed
            s["average_time"] = s["total_time"] / s["total_predictions"]
            self._latencies_ms.append(elapsed * 1000 / max(count, 1))
            if len(self._latencies_ms) > 100_000:
                self._latencies_ms = self._latencies_ms[-50_000:]

    def get_performance_stats(self) -> Dict:
        with self._stats_lock:
            stats = dict(self.performance_stats)
            lat = list(self._latencies_ms)
        if stats["total_predictions"] > 0:
            stats.update({
                "average_time_ms": stats["average_time"] * 1000,
                "throughput_images_per_second": (
                    1.0 / stats["average_time"] if stats["average_time"] > 0 else 0.0),
                "total_time_minutes": stats["total_time"] / 60,
                "latency_percentiles_ms": {
                    f"p{p}": float(np.percentile(lat, p)) for p in (50, 95, 99)},
            })
        return stats
