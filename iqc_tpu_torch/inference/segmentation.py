"""Host-side assembly of the segmentation part of the result: per-region
records with full-resolution masks, contours and area statistics, from the
ROI-grid masks and statistics of the full forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from iqc_tpu_torch.config import SystemConfig
from iqc_tpu_torch.ops.segmentation import SegmentationOutputs

METHOD_NAMES = ("threshold", "adaptive", "watershed", "region_growing")


class ImageSegmentator:
    """Result assembly for the segmentation part of a request."""

    def __init__(self, config: Optional[SystemConfig] = None):
        if isinstance(config, dict):
            config = SystemConfig.from_dict(config)
        self.config = config or SystemConfig()

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
        results = {
            "segmented_regions": [], "masks": [], "contours": [],
            "area_analysis": {}, "total_defect_area": 0, "defect_density": 0.0,
        }
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
