"""Post-processing of the combined result: refinement, filtering, merging,
validation, grading, risk and recommendations. Host-side numpy, on the
result dicts (a copy of the JAX package's post-processor, which is numpy
only).
"""

from __future__ import annotations

import logging
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from iqc_tpu_torch.config import SystemConfig

logger = logging.getLogger(__name__)

_SEV_ORDER = {"minor": 1, "major": 2, "critical": 3}


def _boxes_array(detections: List[Dict]) -> np.ndarray:
    return np.asarray(
        [[d["bbox"]["x1"], d["bbox"]["y1"], d["bbox"]["x2"], d["bbox"]["y2"]] for d in detections],
        dtype=np.float32,
    )


def iou_matrix_np(boxes: np.ndarray) -> np.ndarray:
    """Dense pairwise IoU (postprocess.py:859-877 semantics, vectorized)."""
    a = boxes[:, None, :]
    b = boxes[None, :, :]
    x1 = np.maximum(a[..., 0], b[..., 0])
    y1 = np.maximum(a[..., 1], b[..., 1])
    x2 = np.minimum(a[..., 2], b[..., 2])
    y2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
    union = area[:, None] + area[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def connected_components(adj: np.ndarray) -> np.ndarray:
    """Union-find components of a boolean adjacency matrix -> labels [N]."""
    n = adj.shape[0]
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j]:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    roots = {}
    labels = np.zeros(n, dtype=np.int64)
    for i in range(n):
        r = find(i)
        labels[i] = roots.setdefault(r, len(roots))
    return labels


class PostProcessor:
    """API parity with the reference ``PostProcessor``
    (``inference/postprocess.py:18-883``)."""

    def __init__(self, config: Optional[SystemConfig] = None):
        if isinstance(config, dict):
            config = SystemConfig.from_dict(config)
        self.config = config or SystemConfig()
        self.thresholds = self.config.quality_control.thresholds

    def update_config(self, new_config) -> None:
        """Runtime config propagation (postprocess.py:879-883)."""
        if isinstance(new_config, dict):
            self.config = self.config.update(new_config)
        else:
            self.config = new_config
        self.thresholds = self.config.quality_control.thresholds

    # -- pipeline ---------------------------------------------------------------

    def process_results(
        self,
        ensemble_results: Dict,
        segmentation_results: Dict,
        image_shape: Tuple,
    ) -> Dict:
        """refine -> filter -> merge -> validate -> grade -> risk -> recommend
        (postprocess.py:32-109)."""
        out = {
            "detections": [],
            "quality_assessment": {},
            "risk_analysis": {},
            "recommendations": [],
            "metadata": {
                "processing_timestamp": datetime.now().isoformat(),
                "image_shape": tuple(image_shape),
                "post_processing_version": "tpu-1.0",
            },
        }
        raw = ensemble_results.get("detections", [])
        if not raw:
            out["quality_assessment"] = self.no_defect_assessment()
            out["risk_analysis"] = {
                "overall_risk_level": "low", "risk_score": 0.0,
                "risk_factors": [], "defect_clustering": {"has_clusters": False, "cluster_count": 0},
                "requires_immediate_action": False,
            }
            return out

        dets = self.refine(raw, segmentation_results, image_shape)
        dets = self.filter(dets)
        dets = self.merge_overlapping(dets)
        dets = self.validate(dets, image_shape)
        qa = self.assess_quality(dets, segmentation_results)
        risk = self.analyze_risks(dets, qa)
        out.update(
            {
                "detections": dets,
                "quality_assessment": qa,
                "risk_analysis": risk,
                "recommendations": self.recommend(dets, qa, risk),
            }
        )
        return out

    # -- refinement (postprocess.py:110-183, 764-857) ----------------------------

    def refine(self, detections: List[Dict], seg_results: Dict, image_shape) -> List[Dict]:
        regions = {
            r.get("detection_id"): r for r in seg_results.get("segmented_regions", [])
        }
        refined = []
        for i, det in enumerate(detections):
            d = dict(det)
            region = regions.get(i)
            if region is not None:
                d.update(
                    {
                        "segmentation_confidence": region.get("confidence_score", 0.0),
                        "area_pixels": region.get("area_pixels", 0),
                        "area_percentage": region.get("area_percentage", 0.0),
                        "perimeter": region.get("perimeter", 0.0),
                        "compactness": region.get("compactness", 0.0),
                        "contour_count": len(region.get("contours", [])),
                        "has_segmentation": True,
                    }
                )
                mask = region.get("mask")
                if mask is not None:
                    d["bbox"] = self.tighten_bbox(d["bbox"], mask, image_shape)
                d["final_severity"] = self.escalate_severity(d, region)
            else:
                d.update(
                    {
                        "segmentation_confidence": 0.0,
                        # bbox-fallback area assumes 60% fill (postprocess.py:842-844)
                        "area_pixels": int(d["bbox"]["width"] * d["bbox"]["height"] * 0.6),
                        "area_percentage": 0.0,
                        "perimeter": 0.0,
                        "compactness": 0.0,
                        "contour_count": 0,
                        "has_segmentation": False,
                    }
                )
                d["final_severity"] = d.get("final_severity", d.get("severity", "minor"))
            bbox = d["bbox"]
            d["aspect_ratio"] = bbox["width"] / max(bbox["height"], 1)
            d["bbox_area"] = bbox["width"] * bbox["height"]
            refined.append(d)
        return refined

    @staticmethod
    def tighten_bbox(bbox: Dict, mask: np.ndarray, image_shape, padding: int = 5) -> Dict:
        """Shrink bbox to the mask extent + padding (postprocess.py:764-812)."""
        ys, xs = np.nonzero(np.asarray(mask) > 0)
        if len(ys) == 0:
            return bbox
        y1 = max(0, int(ys.min()) - padding)
        x1 = max(0, int(xs.min()) - padding)
        y2 = min(int(image_shape[0]), int(ys.max()) + padding)
        x2 = min(int(image_shape[1]), int(xs.max()) + padding)
        return {
            "x1": x1, "y1": y1, "x2": x2, "y2": y2,
            "width": x2 - x1, "height": y2 - y1,
            "center_x": (x1 + x2) / 2, "center_y": (y1 + y2) / 2,
        }

    @staticmethod
    def escalate_severity(detection: Dict, region: Dict) -> str:
        """Severity escalation by segmented area / shape irregularity
        (postprocess.py:814-840)."""
        sev = detection.get("severity", "minor")
        area_pct = region.get("area_percentage", 0.0)
        compactness = region.get("compactness", 0.0)
        if area_pct > 5.0:
            if sev == "minor":
                return "major"
            if sev == "major":
                return "critical"
        if compactness < 0.3 and detection.get("class") in ("crack", "scratch") and sev == "minor":
            return "major"
        return sev

    # -- filtering (postprocess.py:186-231) ---------------------------------------

    def filter(self, detections: List[Dict]) -> List[Dict]:
        kept = []
        min_conf = self.thresholds.confidence_threshold
        max_area = self.thresholds.area_threshold_percent
        for d in detections:
            conf = d.get("ensemble_confidence", d.get("confidence", 0.0))
            if conf < min_conf:
                continue
            if d.get("area_percentage", 0.0) > max_area:
                continue
            bbox = d["bbox"]
            ar = bbox["width"] / bbox["height"] if bbox["height"] > 0 else float("inf")
            if ar > 10 or ar < 0.1:
                continue
            if bbox["width"] < 5 or bbox["height"] < 5:
                continue
            kept.append(d)
        return kept

    # -- merging (postprocess.py:233-358) ------------------------------------------

    def merge_overlapping(self, detections: List[Dict], overlap_threshold: float = 0.3) -> List[Dict]:
        """Same-class merge of IoU>0.3 groups. DBSCAN(metric=1-IoU,
        eps=1-0.3, min_samples=1) == connected components of the IoU>0.3
        graph, computed via union-find."""
        if len(detections) <= 1:
            return list(detections)
        by_class: Dict[str, List[Dict]] = {}
        for d in detections:
            by_class.setdefault(d["class"], []).append(d)

        merged: List[Dict] = []
        for dets in by_class.values():
            if len(dets) == 1:
                merged.extend(dets)
                continue
            iou = iou_matrix_np(_boxes_array(dets))
            labels = connected_components(iou > overlap_threshold)
            for lbl in np.unique(labels):
                group = [dets[i] for i in np.nonzero(labels == lbl)[0]]
                merged.append(group[0] if len(group) == 1 else self.merge_group(group))
        return merged

    @staticmethod
    def merge_group(group: List[Dict]) -> Dict:
        """Union bbox, mean confidence, max severity, summed area
        (postprocess.py:305-358)."""
        conf_of = lambda d: d.get("ensemble_confidence", d.get("confidence", 0.0))
        base = dict(max(group, key=conf_of))
        x1 = min(d["bbox"]["x1"] for d in group)
        y1 = min(d["bbox"]["y1"] for d in group)
        x2 = max(d["bbox"]["x2"] for d in group)
        y2 = max(d["bbox"]["y2"] for d in group)
        base["bbox"] = {
            "x1": x1, "y1": y1, "x2": x2, "y2": y2,
            "width": x2 - x1, "height": y2 - y1,
            "center_x": (x1 + x2) / 2, "center_y": (y1 + y2) / 2,
        }
        confs = [conf_of(d) for d in group]
        base["ensemble_confidence"] = float(np.mean(confs))
        base["confidence"] = float(np.mean(confs))
        sevs = [d.get("final_severity", d.get("severity", "minor")) for d in group]
        base["final_severity"] = max(sevs, key=lambda s: _SEV_ORDER.get(s, 0))
        areas = [d.get("area_pixels", 0) for d in group if d.get("area_pixels", 0) > 0]
        if areas:
            base["area_pixels"] = float(sum(areas))
        base["merged_from"] = len(group)
        base["original_confidences"] = confs
        return base

    # -- validation (postprocess.py:360-464) ----------------------------------------

    def validate(self, detections: List[Dict], image_shape, min_score: float = 0.3) -> List[Dict]:
        h, w = image_shape[:2]
        kept = []
        for d in detections:
            b = d["bbox"]
            x1 = max(0, min(b["x1"], w - 1))
            y1 = max(0, min(b["y1"], h - 1))
            x2 = max(x1 + 1, min(b["x2"], w))
            y2 = max(y1 + 1, min(b["y2"], h))
            d["bbox"] = {
                "x1": x1, "y1": y1, "x2": x2, "y2": y2,
                "width": x2 - x1, "height": y2 - y1,
                "center_x": (x1 + x2) / 2, "center_y": (y1 + y2) / 2,
            }
            bbox_area = d["bbox"]["width"] * d["bbox"]["height"]
            if d.get("area_pixels", bbox_area) > bbox_area * 2:
                d["area_pixels"] = bbox_area
                d["area_consistency_warning"] = True
            d["validation_score"] = self.validation_score(d, image_shape)
            if d["validation_score"] > min_score:
                kept.append(d)
        return kept

    @staticmethod
    def validation_score(detection: Dict, image_shape) -> float:
        """5-factor plausibility score: confidence 30%, size 20%, aspect
        20%, segmentation 20%, location 10% (postprocess.py:427-464)."""
        bbox = detection["bbox"]
        conf = detection.get("ensemble_confidence", detection.get("confidence", 0.0))
        conf_score = min(conf / 0.8, 1.0)
        area_ratio = (bbox["width"] * bbox["height"]) / (image_shape[0] * image_shape[1])
        size_score = 1.0 if 0.001 <= area_ratio <= 0.5 else 0.5
        aspect = bbox["width"] / max(bbox["height"], 1)
        aspect_score = 1.0 if 0.2 <= aspect <= 5.0 else 0.5
        if detection.get("has_segmentation", False):
            seg_score = min(detection.get("segmentation_confidence", 0.0) / 0.5, 1.0)
        else:
            seg_score = 0.7
        cx = bbox["center_x"] / image_shape[1]
        cy = bbox["center_y"] / image_shape[0]
        loc_score = min(min(cx, 1 - cx) / 0.05, min(cy, 1 - cy) / 0.05, 1.0)
        return (
            0.3 * conf_score + 0.2 * size_score + 0.2 * aspect_score
            + 0.2 * seg_score + 0.1 * max(loc_score, 0.0)
        )

    # -- quality (postprocess.py:466-599) ---------------------------------------------

    def no_defect_assessment(self) -> Dict:
        return {
            "quality_grade": "A", "pass_fail_status": "PASS", "risk_level": "low",
            "total_defects": 0,
            "severity_breakdown": {"critical": 0, "major": 0, "minor": 0},
            "total_defect_area_pixels": 0, "defect_density": 0.0,
            "average_confidence": 1.0, "quality_score": 100.0,
            "meets_requirements": True, "recommended_action": "accept",
        }

    def assess_quality(self, detections: List[Dict], seg_results: Dict) -> Dict:
        if not detections:
            return self.no_defect_assessment()
        counts = {"critical": 0, "major": 0, "minor": 0}
        for d in detections:
            counts[d.get("final_severity", "minor")] += 1
        grade, pass_fail, risk = self.quality_rules(counts)
        avg_conf = float(
            np.mean([d.get("ensemble_confidence", d.get("confidence", 0.0)) for d in detections])
        )
        return {
            "quality_grade": grade,
            "pass_fail_status": pass_fail,
            "risk_level": risk,
            "total_defects": len(detections),
            "severity_breakdown": counts,
            "total_defect_area_pixels": float(sum(d.get("area_pixels", 0) for d in detections)),
            "defect_density": seg_results.get("defect_density", 0.0),
            "average_confidence": avg_conf,
            "quality_score": self.quality_score(counts, avg_conf),
            "meets_requirements": pass_fail == "PASS",
            "recommended_action": self.recommended_action(pass_fail, risk),
        }

    def quality_rules(self, counts: Dict[str, int]) -> Tuple[str, str, str]:
        """Config-thresholded grade rules (postprocess.py:529-558)."""
        t = self.thresholds
        if counts["critical"] > t.critical_defect_limit:
            return "F", "FAIL", "high"
        if counts["major"] > t.major_defect_limit:
            return "D", "FAIL", "high"
        if counts["minor"] > t.minor_defect_limit:
            return "C", "CONDITIONAL", "medium"
        if counts["major"] > 0:
            return "B", "CONDITIONAL", "low"
        return "A", "PASS", "low"

    @staticmethod
    def quality_score(counts: Dict[str, int], avg_confidence: float) -> float:
        """0-100 score: 100 - 30c - 15m - 5n, scaled by confidence
        (postprocess.py:560-587)."""
        score = 100.0 - 30 * counts["critical"] - 15 * counts["major"] - 5 * counts["minor"]
        return max(0.0, score * min(avg_confidence / 0.8, 1.0))

    @staticmethod
    def recommended_action(pass_fail: str, risk: str) -> str:
        table = {
            ("PASS", "low"): "accept",
            ("CONDITIONAL", "low"): "accept_with_monitoring",
            ("CONDITIONAL", "medium"): "review_required",
            ("FAIL", "high"): "reject",
            ("FAIL", "medium"): "rework_required",
        }
        return table.get((pass_fail, risk), "manual_inspection")

    # -- risk (postprocess.py:601-682) ----------------------------------------------

    def analyze_risks(self, detections: List[Dict], quality: Dict) -> Dict:
        factors = []
        score = 0.0
        clustering = {"has_clusters": False, "cluster_count": 0}
        if detections:
            clustering = self.spatial_clustering(detections)
            if clustering["has_clusters"]:
                factors.append("Clustered defects detected - possible systematic issue")
                score += 0.3
            large = [d for d in detections if d.get("area_pixels", 0) > 1000]
            if large:
                factors.append(f"{len(large)} large defects detected")
                score += 0.2 * len(large)
            critical = [d for d in detections if d.get("final_severity") == "critical"]
            if critical:
                factors.append("Critical defects present - immediate attention required")
                score += 0.5 * len(critical)
        level = "high" if score >= 1.0 else "medium" if score >= 0.5 else "low"
        return {
            "overall_risk_level": level,
            "risk_score": min(score, 1.0),
            "risk_factors": factors,
            "defect_clustering": clustering,
            "requires_immediate_action": quality.get("pass_fail_status") == "FAIL",
        }

    @staticmethod
    def spatial_clustering(detections: List[Dict], eps: float = 100.0) -> Dict:
        """DBSCAN(eps=100, min_samples=2) over box centres ==
        connected components (size>=2) of the dist<eps graph
        (postprocess.py:651-682)."""
        if len(detections) < 3:
            return {"has_clusters": False, "cluster_count": 0}
        pts = np.asarray(
            [[d["bbox"]["center_x"], d["bbox"]["center_y"]] for d in detections]
        )
        dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
        adj = (dist <= eps) & ~np.eye(len(pts), dtype=bool)
        labels = connected_components(adj)
        sizes = np.bincount(labels)
        cluster_ids = np.nonzero(sizes >= 2)[0]
        clustered = int(np.isin(labels, cluster_ids).sum())
        return {
            "has_clusters": len(cluster_ids) > 0,
            "cluster_count": int(len(cluster_ids)),
            "clustered_defects": clustered,
            "isolated_defects": int(len(pts) - clustered),
        }

    # -- recommendations (postprocess.py:684-762) --------------------------------------

    DEFECT_ADVICE = {
        "crack": [
            "Check material stress levels and handling procedures",
            "Verify temperature control during manufacturing",
        ],
        "scratch": [
            "Review handling and packaging procedures",
            "Check for abrasive contact points in production line",
        ],
        "dent": [
            "Inspect handling equipment for damage",
            "Review impact protection during transport",
        ],
        "discoloration": [
            "Check chemical process parameters",
            "Verify environmental conditions (humidity, temperature)",
        ],
        "contamination": [
            "Review cleaning procedures and protocols",
            "Check for foreign material sources in production area",
        ],
    }

    def recommend(self, detections: List[Dict], quality: Dict, risk: Dict) -> List[str]:
        recs: List[str] = []
        status = quality["pass_fail_status"]
        breakdown = quality["severity_breakdown"]
        if status == "FAIL":
            recs.append("REJECT: Product does not meet quality standards")
            if breakdown["critical"] > 0:
                recs.append("Critical defects detected - investigate root cause immediately")
            if breakdown["major"] > 2:
                recs.append("Multiple major defects - review manufacturing process")
        elif status == "CONDITIONAL":
            recs.append("CONDITIONAL PASS: Monitor closely and consider rework")
            recs.append("Increase inspection frequency for similar products")
        if risk["overall_risk_level"] == "high":
            recs.append("High risk detected - implement immediate corrective actions")
        if risk["defect_clustering"].get("has_clusters"):
            recs.append("Defect clustering detected - check for systematic manufacturing issues")
        for defect_type in sorted({d["class"] for d in detections}):
            recs.extend(self.DEFECT_ADVICE.get(defect_type, []))
        if quality["average_confidence"] < 0.7:
            recs.append("Low detection confidence - consider additional inspection methods")
        if quality["defect_density"] > 5.0:
            recs.append("High defect density - review entire manufacturing process")
        return recs
