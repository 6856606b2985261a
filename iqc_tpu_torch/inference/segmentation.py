"""Defect segmentation of detected boxes: the standalone entry point
(``segment_defects`` for one image, ``segment_batch`` for a batch, all of
whose boxes go to the device as one ROI batch), and the host-side assembly
of the segmentation part of a result: per-region records with
full-resolution masks, contours and area statistics, from ROI-grid masks
and statistics (also those of the full forward).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from iqc_tpu_torch.config import SystemConfig
from iqc_tpu_torch.ops import image as imops
from iqc_tpu_torch.ops.jit_utils import hoisted_jit
from iqc_tpu_torch.ops.segmentation import SegmentationOutputs, segment_detections

METHOD_NAMES = ("threshold", "adaptive", "watershed", "region_growing")
# unknown classes get the threshold method: class id 3 (discoloration) carries it
UNKNOWN_CLASS_ID = 3


def _segment_on_device(images: torch.Tensor, boxes: torch.Tensor, cids: torch.Tensor,
                       valid: torch.Tensor, roi_size: int):
    """``segment_detections`` of [B,H,W,3] images -> (masks [B,cap,R,R], stats
    [B,cap,5]: area, perimeter, compactness, confidence, method)."""
    out = segment_detections(imops.to_float(images), boxes, cids, valid, roi_size=roi_size)
    stats = torch.stack([out.area, out.perimeter, out.compactness, out.confidence,
                         out.method.to(torch.float32)], dim=-1)
    return out.masks, stats


class ImageSegmentator:
    """Segments up to ``capacity`` boxes an image on ``roi_size``^2 ROI grids,
    on ``device``, and assembles the result records."""

    def __init__(self, config: Optional[SystemConfig] = None, capacity: int = 32,
                 roi_size: int = 128, device="cuda"):
        if isinstance(config, dict):
            config = SystemConfig.from_dict(config)
        self.config = config or SystemConfig()
        self.capacity = capacity
        self.roi_size = roi_size
        self.device = torch.device(device)
        self.class_names = list(self.config.quality_control.defect_classes)
        # one CUDA graph per input signature on the card
        self._jit_segment = hoisted_jit(_segment_on_device)

    @staticmethod
    def _empty() -> Dict:
        return {"segmented_regions": [], "masks": [], "contours": [], "area_analysis": {},
                "total_defect_area": 0, "defect_density": 0.0}

    def _pack(self, batch_detections: List[List[Dict]]):
        """Detection records -> boxes [B,cap,4], class ids [B,cap] and valid
        [B,cap] (numpy), the first ``capacity`` boxes of each image."""
        b = len(batch_detections)
        boxes = np.zeros((b, self.capacity, 4), np.float32)
        cids = np.zeros((b, self.capacity), np.int32)
        valid = np.zeros((b, self.capacity), bool)
        for i, dets in enumerate(batch_detections):
            for j, det in enumerate(dets[:self.capacity]):
                bb = det["bbox"]
                boxes[i, j] = (bb["x1"], bb["y1"], bb["x2"], bb["y2"])
                cls = det.get("class", "")
                cids[i, j] = (self.class_names.index(cls) if cls in self.class_names
                              else UNKNOWN_CLASS_ID)
                valid[i, j] = True
        return boxes, cids, valid

    def _segment(self, images: np.ndarray, boxes, cids, valid):
        """[B,H,W,3] images and packed boxes -> host masks [B,cap,R,R] and
        stats [B,cap,5] (area, perimeter, compactness, confidence, method)."""
        up = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
        with torch.inference_mode():
            masks, stats = self._jit_segment(up(images), up(boxes), up(cids), up(valid),
                                             self.roi_size)
            return masks.cpu().numpy(), stats.cpu().numpy()

    def segment_defects(self, image: np.ndarray, detections: List[Dict]) -> Dict:
        """Segment the detections (records with a pixel ``bbox`` and a
        ``class``) of one [H,W,3] image."""
        if not detections:
            return self._empty()
        boxes, cids, valid = self._pack([detections])
        masks, stats = self._segment(np.asarray(image)[None], boxes, cids, valid)
        return self._assemble_result(detections, self._unpack(masks[0], stats[0]), boxes[0],
                                     image.shape[:2])

    def segment_batch(self, images: np.ndarray, batch_detections: List[List[Dict]]) -> List[Dict]:
        """Segment the detections of each image of [B,H,W,3] ``images``: the
        B x capacity ROIs as one batch on the device."""
        if not batch_detections:
            return []
        boxes, cids, valid = self._pack(batch_detections)
        if not valid.any():
            return [self._empty() for _ in batch_detections]
        masks, stats = self._segment(np.asarray(images), boxes, cids, valid)
        h, w = images.shape[1:3]
        return [self._assemble_result(dets, self._unpack(masks[i], stats[i]), boxes[i], (h, w))
                for i, dets in enumerate(batch_detections)]

    @staticmethod
    def _unpack(masks: np.ndarray, stats: np.ndarray) -> SegmentationOutputs:
        stats = np.asarray(stats)
        return SegmentationOutputs(
            masks=np.asarray(masks),
            area=stats[..., 0], perimeter=stats[..., 1],
            compactness=stats[..., 2], confidence=stats[..., 3],
            method=stats[..., 4].astype(np.int32),
        )

    def _assemble_result(self, detections, out_np, boxes, shape) -> Dict:
        """Shared host-side schema assembly for one image."""
        h, w = shape
        results = self._empty()
        total_image_area = float(h * w)
        total = 0.0
        for i in range(min(len(detections), len(out_np.masks), len(boxes))):
            det = detections[i]
            area = float(out_np.area[i])
            total += area
            global_mask = self.reconstruct_mask(out_np.masks[i], boxes[i], (h, w))
            region = {
                "detection_id": i,
                "defect_class": det.get("class", "unknown"),
                "confidence": det.get("confidence", 0.0),
                "bbox": det["bbox"],
                "mask": global_mask,
                "local_mask": out_np.masks[i],
                "contours": self.mask_contours(global_mask),
                "area_pixels": area,
                "area_percentage": area / total_image_area * 100.0,
                "perimeter": float(out_np.perimeter[i]),
                "compactness": float(out_np.compactness[i]),
                "segmentation_method": METHOD_NAMES[int(out_np.method[i])],
                "confidence_score": float(out_np.confidence[i]),
            }
            results["segmented_regions"].append(region)
            results["masks"].append(global_mask)
            results["contours"].extend(region["contours"])
        results["total_defect_area"] = total
        results["defect_density"] = total / total_image_area * 100.0
        results["area_analysis"] = self._analyze_defect_areas(
            results["segmented_regions"]
        )
        return results

    # -- host utilities --------------------------------------------------------

    @staticmethod
    def reconstruct_mask(roi_mask: np.ndarray, box: Sequence[float], image_shape) -> np.ndarray:
        """Paste an ROI-grid mask back into a full-resolution uint8 mask
        (the reference's global-coordinate mask, segmentation.py:90-94)."""
        h, w = image_shape
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(w, max(x2, x1 + 1)), min(h, max(y2, y1 + 1))
        bw, bh = x2 - x1, y2 - y1
        global_mask = np.zeros((h, w), np.uint8)
        if bw <= 0 or bh <= 0:
            return global_mask
        # nearest-neighbour upsample of the bool ROI grid to the box size
        r = roi_mask.shape[0]
        yi = (np.arange(bh) * r // max(bh, 1)).clip(0, r - 1)
        xi = (np.arange(bw) * r // max(bw, 1)).clip(0, r - 1)
        global_mask[y1:y2, x1:x2] = roi_mask[np.ix_(yi, xi)].astype(np.uint8) * 255
        return global_mask

    @staticmethod
    def mask_contours(mask: np.ndarray, min_area: int = 10) -> List[np.ndarray]:
        """Boundary-pixel polygons per connected component (host-side,
        cv2-free equivalent of findContours, segmentation.py:486-506).
        Returns [K, 1, 2] int arrays of (x, y) boundary points."""
        from scipy import ndimage as ndi

        labels, count = ndi.label(mask > 0)
        contours = []
        for lbl in range(1, count + 1):
            comp = labels == lbl
            if comp.sum() < min_area:
                continue
            inner = ndi.binary_erosion(comp)
            by, bx = np.nonzero(comp & ~inner)
            if len(bx) == 0:
                continue
            contours.append(np.stack([bx, by], axis=-1)[:, None, :].astype(np.int32))
        return contours

    @staticmethod
    def _analyze_defect_areas(regions: List[Dict]) -> Dict:
        """Area statistics + size buckets (segmentation.py:623-655)."""
        if not regions:
            return {}
        areas = [r["area_pixels"] for r in regions]
        pcts = [r["area_percentage"] for r in regions]
        return {
            "total_regions": len(regions),
            "total_area_pixels": float(sum(areas)),
            "total_area_percentage": float(sum(pcts)),
            "average_area_pixels": float(np.mean(areas)),
            "median_area_pixels": float(np.median(areas)),
            "max_area_pixels": float(max(areas)),
            "min_area_pixels": float(min(areas)),
            "area_std": float(np.std(areas)),
            "size_distribution": {
                "small_defects": sum(1 for a in areas if a < 100),
                "medium_defects": sum(1 for a in areas if 100 <= a < 1000),
                "large_defects": sum(1 for a in areas if a >= 1000),
            },
        }

    def visualize_segmentation(self, image: np.ndarray, segmentation_results: Dict,
                               save_path: Optional[str] = None) -> np.ndarray:
        """The result's full-resolution masks blended over ``image``; saved
        to ``save_path`` when given."""
        from iqc_tpu_torch.inference.visualize import draw_segmentation

        vis = draw_segmentation(image, segmentation_results.get("masks", []))
        if save_path:
            self.save_image(vis, save_path)
        return vis

    @staticmethod
    def save_image(image: np.ndarray, path: str) -> None:
        """Write ``image`` with PIL; without PIL, raise RuntimeError."""
        try:
            Image = importlib.import_module("PIL.Image")
        except ImportError as e:
            raise RuntimeError("saving an image needs PIL, which is not installed") from e
        Image.fromarray(np.asarray(image).astype(np.uint8)).save(path)
