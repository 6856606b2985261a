"""Typed configuration of the serving slice.

Only the fields that the request path reads. Defaults are the shipped
serving profile (``config/config.yaml``) at float32: the port reads no YAML,
so the profile lives here as dataclass defaults, and ``SystemConfig.from_dict``
applies overrides given as a nested dict.

Relative weight paths resolve against the repository root (the parent of
this package), never against the working directory.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFECT_CLASSES = ("crack", "scratch", "dent", "discoloration", "contamination")
SEVERITY_LEVELS = ("minor", "major", "critical")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_path(path: str) -> str:
    """Absolute path of a weight file named relative to the repository root."""
    if not path or os.path.isabs(path):
        return path
    return os.path.join(REPO_ROOT, path)


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


@dataclass
class ModelConfig:
    yolo_weights: str = "models/yolov8n_qc_synthetic.msgpack"
    resnet_weights: str = "models/resnet50_qc_128.msgpack"
    confidence_threshold: float = 0.7
    nms_threshold: float = 0.5
    num_classes: int = 5
    ensemble_weights: Dict[str, float] = field(
        default_factory=lambda: {"yolo": 0.6, "resnet": 0.4}
    )
    compute_dtype: str = "float32"
    max_detections: int = 300
    max_classified: int = 32
    max_classified_pool: int = 128
    max_segmented: int = 16
    max_segmented_pool: int = 64
    seg_roi_size: int = 128
    reg_max: int = 16
    width_mult: float = 0.25
    depth_mult: float = 0.334
    classifier_input: int = 128
    resnet_stages: Tuple[int, ...] = (3, 4, 6, 3)
    yolo_stem: str = "conv"

    def validate(self) -> None:
        if self.compute_dtype != "float32":
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is not ported; float32 only")
        if self.yolo_stem not in ("conv", "s2d"):
            raise ValueError(f"unknown yolo_stem {self.yolo_stem!r}")
        if not 0.0 <= self.confidence_threshold <= 1.0:
            raise ValueError(f"confidence_threshold out of range: {self.confidence_threshold}")
        if not 0.0 <= self.nms_threshold <= 1.0:
            raise ValueError(f"nms_threshold out of range: {self.nms_threshold}")
        if self.num_classes < 1:
            raise ValueError("num_classes must be >= 1")
        if self.max_classified > self.max_detections:
            raise ValueError("max_classified cannot exceed max_detections")
        if self.max_classified_pool < 0 or self.max_segmented_pool < 0:
            raise ValueError("pool sizes must be >= 0")
        if sum(self.ensemble_weights.values()) <= 0:
            raise ValueError("ensemble weights must sum to a positive value")


@dataclass
class PreprocessingConfig:
    resize: Optional[Tuple[int, int]] = (640, 640)
    denoise: bool = False
    enhance_contrast: bool = False


@dataclass
class ProcessingConfig:
    batch_size: int = 32
    input_size: Tuple[int, int] = (640, 640)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)

    def validate(self) -> None:
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        h, w = self.input_size
        if h % 32 or w % 32:
            raise ValueError("input_size must be a multiple of the max stride (32)")
        pre = self.preprocessing
        if pre.denoise or pre.enhance_contrast:
            raise ValueError("denoise and enhance_contrast preprocessing are not ported")


@dataclass
class QualityThresholds:
    minor_defect_limit: int = 3
    major_defect_limit: int = 1
    critical_defect_limit: int = 0
    confidence_threshold: float = 0.5
    area_threshold_percent: float = 50.0


@dataclass
class QualityControlConfig:
    defect_classes: List[str] = field(default_factory=lambda: list(DEFECT_CLASSES))
    thresholds: QualityThresholds = field(default_factory=QualityThresholds)

    def validate(self) -> None:
        if not self.defect_classes:
            raise ValueError("defect_classes must not be empty")


@dataclass
class EdgeConfig:
    precision: str = "fp32"

    def validate(self) -> None:
        if self.precision != "fp32":
            raise ValueError(f"precision {self.precision!r} is not ported; fp32 only")


@dataclass
class QCSpecificConfig:
    """Per-class confidence floors, severity-rule thresholds and
    post-processing overrides (empty = the model block's values)."""

    confidence_thresholds: Dict[str, float] = field(default_factory=dict)
    nms_threshold: Optional[float] = None
    max_detections_per_image: Optional[int] = None
    severity_rules: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def validate(self) -> None:
        for name, v in self.confidence_thresholds.items():
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"confidence_thresholds[{name!r}] out of range: {v}")
        if self.nms_threshold is not None and not 0.0 <= self.nms_threshold <= 1.0:
            raise ValueError(f"qc_specific.nms_threshold out of range: {self.nms_threshold}")
        if self.max_detections_per_image is not None and self.max_detections_per_image < 1:
            raise ValueError("max_detections_per_image must be >= 1")
        for tier, rule in self.severity_rules.items():
            if tier not in SEVERITY_LEVELS:
                raise ValueError(f"unknown severity tier {tier!r}")
            for k in rule:
                if k not in ("min_confidence", "min_area_ratio", "classifier_min_confidence"):
                    raise ValueError(f"unknown severity rule key {k!r}")

    def conf_vector(self, defect_classes: Sequence[str], default: float) -> Optional[List[float]]:
        """[C] per-class floors, or None to keep the scalar threshold."""
        if not self.confidence_thresholds:
            return None
        return [float(self.confidence_thresholds.get(c, default)) for c in defect_classes]

    def severity_array(self) -> Optional[List[List[float]]]:
        """[[major_conf, major_area_ratio, cls_major_conf],
        [critical_conf, critical_area_ratio, cls_critical_conf]], or None
        for the built-in rule constants."""
        if not self.severity_rules:
            return None
        major = self.severity_rules.get("major", {})
        crit = self.severity_rules.get("critical", {})
        return [
            [float(major.get("min_confidence", 0.8)),
             float(major.get("min_area_ratio", 0.05)),
             float(major.get("classifier_min_confidence", 0.6))],
            [float(crit.get("min_confidence", 0.9)),
             float(crit.get("min_area_ratio", 0.1)),
             float(crit.get("classifier_min_confidence", 0.8))],
        ]


@dataclass
class SystemConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    quality_control: QualityControlConfig = field(default_factory=QualityControlConfig)
    edge: EdgeConfig = field(default_factory=EdgeConfig)
    qc_specific: QCSpecificConfig = field(default_factory=QCSpecificConfig)

    def validate(self) -> "SystemConfig":
        self.model.validate()
        self.processing.validate()
        self.quality_control.validate()
        self.edge.validate()
        self.qc_specific.validate()
        return self

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "SystemConfig":
        """Shipped profile overlaid with ``raw``; unknown keys are ignored."""
        raw = dict(raw or {})
        model_raw = dict(raw.get("model") or {})
        proc_raw = dict(raw.get("processing") or {})
        qc_raw = dict(raw.get("quality_control") or {})

        if "resnet_stages" in model_raw:
            model_raw["resnet_stages"] = tuple(model_raw["resnet_stages"])
        pre_raw = dict(proc_raw.pop("preprocessing", None) or {})
        if pre_raw.get("resize") is not None:
            pre_raw["resize"] = tuple(pre_raw["resize"])
        if "input_size" in proc_raw:
            proc_raw["input_size"] = tuple(proc_raw["input_size"])
        processing = _build(ProcessingConfig, proc_raw)
        processing.preprocessing = _build(PreprocessingConfig, pre_raw)
        thr_raw = dict(qc_raw.pop("thresholds", None) or {})
        qc = _build(QualityControlConfig, qc_raw)
        qc.thresholds = _build(QualityThresholds, thr_raw)
        return cls(
            model=_build(ModelConfig, model_raw),
            processing=processing,
            quality_control=qc,
            edge=_build(EdgeConfig, dict(raw.get("edge") or {})),
            qc_specific=_build(QCSpecificConfig, dict(raw.get("qc_specific") or {})),
        ).validate()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def update(self, patch: Dict[str, Any]) -> "SystemConfig":
        """Apply a nested dict patch and revalidate."""
        return SystemConfig.from_dict(_merge(self.to_dict(), patch))


def _build(cls, raw: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})
