"""Typed configuration of the port.

The fields that the request path and the serving layer read. Defaults are
the shipped serving profile (``config/config.yaml``): bfloat16 compute and
int8 serving with both streaming walks. The port needs no YAML reader, so
the profile lives here as dataclass defaults, and
``SystemConfig.from_dict`` applies overrides given as a nested dict (keys it
does not read are kept in ``extra``). ``load_config`` reads a JSON file, or a
YAML file where PyYAML is installed.

Relative weight paths resolve against the repository root (the parent of
this package), never against the working directory.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFECT_CLASSES = ("crack", "scratch", "dent", "discoloration", "contamination")
SEVERITY_LEVELS = ("minor", "major", "critical")

logger = logging.getLogger(__name__)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_path(path: str) -> str:
    """Absolute path of a weight file named relative to the repository root."""
    if not path or os.path.isabs(path):
        return path
    return os.path.join(REPO_ROOT, path)


# The YOLOv8 training profile of config/yolo_config.yaml (its training,
# augmentation and qc_specific.class_weights blocks), held as data because
# the card's machine has no YAML reader; tests hold it equal to the YAML.
YOLO_TRAINING_PROFILE: Dict[str, Any] = {
    "training": {
        "num_classes": 5, "image_size": 640, "batch_size": 16, "epochs": 100,
        "learning_rate": 0.01, "final_lr_fraction": 0.01, "warmup_epochs": 3,
        "weight_decay": 0.0005, "momentum": 0.937,
        "box_gain": 7.5, "cls_gain": 0.5, "dfl_gain": 1.5,
        "mosaic": 1.0, "mixup": 0.0, "ema_decay": 0.9999,
        "width_mult": 0.25, "depth_mult": 0.334, "reg_max": 16, "max_boxes": 64,
        "val_conf": 0.001, "val_iou": 0.6, "patience": 50,
        "checkpoint_dir": "checkpoints/yolo", "compute_dtype": "bfloat16", "seed": 42,
    },
    "augmentation": {
        "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1,
        "scale": 0.5, "shear": 0.0, "flipud": 0.0, "fliplr": 0.5,
        "mosaic": 1.0, "mixup": 0.0,
    },
    "qc_specific": {
        "class_weights": {"crack": 1.2, "scratch": 1.0, "dent": 1.5,
                          "discoloration": 0.8, "contamination": 1.1},
    },
}


# The ResNet-50 classifier's training profile of config/resnet_config.yaml
# (its training block and augmentation.train), held as data for the same
# reason; tests hold it equal to the YAML.
RESNET_TRAINING_PROFILE: Dict[str, Any] = {
    "training": {
        "num_classes": 5, "image_size": 224, "batch_size": 32, "epochs": 50,
        "learning_rate": 0.001, "weight_decay": 0.0001, "optimizer": "adam",
        "scheduler": "cosine", "step_size": 10, "gamma": 0.1, "label_smoothing": 0.1,
        "use_class_weights": True, "balanced_sampling": True, "val_frequency": 1,
        "early_stopping_patience": 10, "checkpoint_dir": "checkpoints/resnet",
        "stage_sizes": [3, 4, 6, 3], "compute_dtype": "bfloat16", "seed": 42,
    },
    "augmentation": {
        "train": {
            "random_resize_crop": {"size": 224, "scale": [0.8, 1.0], "ratio": [0.75, 1.33]},
            "random_horizontal_flip": {"probability": 0.5},
            "random_vertical_flip": {"probability": 0.1},
            "random_rotation": {"degrees": 15},
            "color_jitter": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2,
                             "hue": 0.1},
            "random_grayscale": {"probability": 0.1},
            "random_erasing": {"enabled": True, "probability": 0.25, "scale": [0.02, 0.33],
                               "ratio": [0.3, 3.3]},
            "gaussian_blur": {"enabled": True, "probability": 0.1, "kernel_size": 3},
        },
    },
}


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
    compute_dtype: str = "bfloat16"  # float32 | bfloat16
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
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
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
    normalize: bool = True
    denoise: bool = False
    enhance_contrast: bool = False


@dataclass
class ProcessingConfig:
    batch_size: int = 32
    max_workers: int = 4  # read by no path: the networks batch on the device
    input_size: Tuple[int, int] = (640, 640)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)

    def validate(self) -> None:
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        h, w = self.input_size
        if h % 32 or w % 32:
            raise ValueError("input_size must be a multiple of the max stride (32)")


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
    severity_levels: List[str] = field(default_factory=lambda: list(SEVERITY_LEVELS))
    thresholds: QualityThresholds = field(default_factory=QualityThresholds)

    def validate(self) -> None:
        if not self.defect_classes:
            raise ValueError("defect_classes must not be empty")


@dataclass
class EdgeConfig:
    """Serving precision. ``int8``: int8 convolutions with statically
    calibrated activation scales for both networks, walked with int8 codes
    between convolutions (``yolo_int8_stream``, ``resnet_int8_stream``) or
    with a quantize before every convolution (the v1 walks, flags false);
    the environment variables ``IQC_YOLO_INT8_STREAM`` and
    ``IQC_RESNET_INT8_STREAM`` (``1``/``0``) override the two walk flags.
    ``yolo_int8: false`` stores the YOLO weights as int8 and serves them
    dequantized through the float network. ``fp32`` and ``bf16`` serve the
    float networks in ``model.compute_dtype``. ``sparsity`` > 0 prunes both
    networks by magnitude before any precision lowering (whole output
    channels with ``structured_pruning``)."""

    precision: str = "int8"  # fp32 | bf16 | int8
    yolo_int8: bool = True
    yolo_int8_stream: bool = True
    resnet_int8_stream: bool = True
    max_batch_size: int = 32
    compilation_cache_dir: str = ".xla_cache"  # the JAX package's compile cache; unread here
    sparsity: float = 0.0
    structured_pruning: bool = False

    def validate(self) -> None:
        if self.precision not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if not 0.0 <= self.sparsity < 1.0:
            raise ValueError(f"sparsity out of range: {self.sparsity}")


@dataclass
class MeshConfig:
    """The data-parallel mesh of a job launched with one process per rank
    (``parallel/mesh.py``): ``data_parallel`` ranks along ``data_axis``
    (-1: every rank of the launched group not claimed by the model axis)
    times ``model_parallel`` along ``model_axis``. A single process is a
    mesh of 1."""

    enabled: bool = True
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1 = every rank of the group
    model_parallel: int = 1


@dataclass
class QCSpecificConfig:
    """Per-class confidence floors, per-class training-loss weights,
    severity-rule thresholds and post-processing overrides (empty = the
    model block's values)."""

    confidence_thresholds: Dict[str, float] = field(default_factory=dict)
    class_weights: Dict[str, float] = field(default_factory=dict)
    nms_threshold: Optional[float] = None
    max_detections_per_image: Optional[int] = None
    severity_rules: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def validate(self) -> None:
        for name, v in self.confidence_thresholds.items():
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"confidence_thresholds[{name!r}] out of range: {v}")
        for name, v in self.class_weights.items():
            if float(v) < 0.0:
                raise ValueError(f"class_weights[{name!r}] must be >= 0: {v}")
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

    def weight_vector(self, defect_classes: Sequence[str]) -> Optional[List[float]]:
        """[C] per-class loss weights (1.0 where a class is not named), or
        None when the block is empty."""
        if not self.class_weights:
            return None
        return [float(self.class_weights.get(c, 1.0)) for c in defect_classes]

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
class SpecLimit:
    upper: float = 5.0
    lower: float = 0.0
    target: float = 0.5


@dataclass
class SPCConfig:
    window_size: int = 100
    confidence_level: float = 0.95
    defect_rate_limits: SpecLimit = field(default_factory=SpecLimit)
    high_defect_rate_alert: float = 3.0


@dataclass
class ServingConfig:
    """The HTTP server: address, CORS, rate limit, static API keys, the
    directory SPC reports are confined to, and TLS."""

    host: str = "0.0.0.0"
    port: int = 5000
    debug: bool = False
    cors_enabled: bool = True
    rate_limit_enabled: bool = True
    requests_per_minute: int = 1000
    metrics_port: int = 9090
    auth_enabled: bool = False
    api_keys: Tuple[str, ...] = ()
    reports_dir: str = "reports"
    ssl_enabled: bool = False
    ssl_cert: str = ""
    ssl_key: str = ""


@dataclass
class StorageConfig:
    """The SQLite result store (``storage.py``); other database types are
    rejected when storage is enabled."""

    enabled: bool = False
    database_type: str = "sqlite"
    database_path: str = "data/qc_database.sqlite"
    save_detailed_results: bool = True
    save_processed_images: bool = False
    save_failed_images: bool = True
    image_storage_path: str = "data/images"
    retention_days: int = 30
    max_storage_gb: float = 100.0
    backup_enabled: bool = False
    backup_path: str = "backups"
    backup_frequency: str = "daily"  # hourly | daily | weekly
    backup_retention_days: int = 30

    def validate(self) -> None:
        if self.enabled and self.database_type != "sqlite":
            raise ValueError(
                f"database type {self.database_type!r} not implemented (sqlite only)")
        if self.retention_days < 1:
            raise ValueError("retention_days must be >= 1")
        if self.max_storage_gb <= 0:
            raise ValueError("max_storage_gb must be positive")
        if self.backup_frequency not in ("hourly", "daily", "weekly"):
            raise ValueError(f"unknown backup_frequency {self.backup_frequency!r}")


@dataclass
class AlertThresholds:
    critical_defects: int = 1     # per-image critical count that alerts
    major_defects: int = 2        # per-image major count that alerts
    high_defect_rate: float = 3.0  # defects per image over the SPC window
    low_confidence: float = 0.6   # per-image mean ensemble confidence floor


@dataclass
class AlertsConfig:
    """Alert delivery (``serving/alerts.py``): webhooks, SMTP email and an
    HTTP SMS gateway, with a per-rule cooldown."""

    email_notifications: bool = False
    sms_notifications: bool = False
    webhook_notifications: bool = False
    webhook_url: str = ""
    webhook_urls: Tuple[str, ...] = ()
    thresholds: AlertThresholds = field(default_factory=AlertThresholds)
    cooldown_seconds: float = 60.0
    timeout_seconds: float = 3.0
    retries: int = 2
    email: Dict[str, Any] = field(default_factory=lambda: {
        "smtp_server": "", "smtp_port": 587, "username": "", "recipients": []})
    sms: Dict[str, Any] = field(default_factory=lambda: {
        "gateway_url": "", "api_key": "", "from": "IQC-TPU", "recipients": []})

    def urls(self) -> Tuple[str, ...]:
        out = tuple(self.webhook_urls)
        if self.webhook_url and self.webhook_url not in out:
            out = (self.webhook_url,) + out
        return out

    def validate(self) -> None:
        if self.cooldown_seconds < 0 or self.timeout_seconds <= 0:
            raise ValueError("alert cooldown/timeout must be positive")
        if self.retries < 0:
            raise ValueError("alert retries must be >= 0")
        if self.email_notifications:
            if not self.email.get("smtp_server"):
                raise ValueError("email_notifications requires alerts.email.smtp_server")
            if not self.email.get("recipients"):
                raise ValueError("email_notifications requires alerts.email.recipients")
            try:
                int(self.email.get("smtp_port", 587))
            except (TypeError, ValueError):
                raise ValueError("alerts.email.smtp_port must be an integer")
        if self.sms_notifications:
            if not self.sms.get("gateway_url"):
                raise ValueError("sms_notifications requires alerts.sms.gateway_url")
            if not self.sms.get("recipients"):
                raise ValueError("sms_notifications requires alerts.sms.recipients")


@dataclass
class ScalingConfig:
    """The serving worker pool's autoscaler (``serving/scaling.py``)."""

    auto_scale: bool = False
    min_instances: int = 1
    max_instances: int = 4
    cpu_threshold: float = 80.0     # percent; scale up above this
    memory_threshold: float = 85.0  # percent; scale up above this
    interval_seconds: float = 10.0  # sampling period
    # scale down only after this many consecutive samples below half the
    # thresholds
    scale_down_samples: int = 3

    def validate(self) -> None:
        if self.min_instances < 1:
            raise ValueError("scaling.min_instances must be >= 1")
        if self.max_instances < self.min_instances:
            raise ValueError("scaling.max_instances must be >= min_instances")
        if not (0 < self.cpu_threshold <= 100 and 0 < self.memory_threshold <= 100):
            raise ValueError("scaling thresholds must be in (0, 100]")
        if self.interval_seconds <= 0 or self.scale_down_samples < 1:
            raise ValueError("scaling cadence knobs must be positive")


def _shipped_extra() -> Dict[str, Any]:
    """The shipped profile's blocks that no field reads."""
    return {
        "monitoring": {"targets": {
            "inference_time_ms": 20, "throughput_images_per_minute": 5000,
            "accuracy_percent": 94.2, "precision_percent": 91.3, "recall_percent": 89.0}},
        "production": {"scaling": {
            "auto_scale": False, "min_instances": 1, "max_instances": 4,
            "cpu_threshold": 80, "memory_threshold": 85}},
    }


@dataclass
class SystemConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    quality_control: QualityControlConfig = field(default_factory=QualityControlConfig)
    spc: SPCConfig = field(default_factory=SPCConfig)
    api: ServingConfig = field(default_factory=ServingConfig)
    edge: EdgeConfig = field(default_factory=EdgeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    alerts: AlertsConfig = field(default_factory=AlertsConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    qc_specific: QCSpecificConfig = field(default_factory=QCSpecificConfig)
    scaling: ScalingConfig = field(default_factory=ScalingConfig)
    # blocks that no field reads (integrations, logging, security, ...),
    # kept as given
    extra: Dict[str, Any] = field(default_factory=_shipped_extra)

    def validate(self) -> "SystemConfig":
        self.model.validate()
        self.processing.validate()
        self.quality_control.validate()
        self.edge.validate()
        self.alerts.validate()
        self.storage.validate()
        self.qc_specific.validate()
        self.scaling.validate()
        return self

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "SystemConfig":
        """Shipped profile overlaid with ``raw``. Nested blocks take both the
        flat layout of ``to_dict`` and the nested one of ``config.yaml``
        (``spc.specification_limits``, ``api.rate_limiting``,
        ``api.authentication``, ``security.ssl``, ``storage.database``,
        ``production.backup``, ``production.scaling``); unknown keys inside a
        block are ignored, unknown top-level blocks go to ``extra``."""
        raw = dict(raw or {})
        model_raw = dict(raw.pop("model", None) or {})
        proc_raw = dict(raw.pop("processing", None) or {})
        qc_raw = dict(raw.pop("quality_control", None) or {})
        spc_raw = dict(raw.pop("spc", None) or {})
        api_raw = dict(raw.pop("api", None) or {})
        edge_raw = dict(raw.pop("edge", None) or {})
        mesh_raw = dict(raw.pop("mesh", None) or {})
        alerts_raw = dict(raw.pop("alerts", None) or {})
        storage_raw = dict(raw.pop("storage", None) or {})
        qc_spec_raw = dict(raw.pop("qc_specific", None) or {})

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

        rate = dict((spc_raw.pop("specification_limits", None) or {}).get("defect_rate") or {})
        limits_raw = spc_raw.pop("defect_rate_limits", None)
        spc = _build(SPCConfig, spc_raw)
        if isinstance(limits_raw, dict):
            spc.defect_rate_limits = _build(SpecLimit, limits_raw)
        if rate:
            spc.defect_rate_limits = _build(SpecLimit, rate)

        rl = dict(api_raw.pop("rate_limiting", None) or {})
        auth = dict(api_raw.pop("authentication", None) or {})
        if "api_keys" in api_raw:
            api_raw["api_keys"] = tuple(api_raw["api_keys"] or ())
        api = _build(ServingConfig, api_raw)
        if rl:
            api.rate_limit_enabled = bool(rl.get("enabled", api.rate_limit_enabled))
            api.requests_per_minute = int(rl.get("requests_per_minute", api.requests_per_minute))
        if auth:
            api.auth_enabled = bool(auth.get("enabled", api.auth_enabled))
            keys = auth.get("api_keys")
            if keys:
                api.api_keys = tuple(str(k) for k in keys)
        ssl_raw = dict((raw.get("security") or {}).get("ssl") or {})
        if ssl_raw:
            api.ssl_enabled = bool(ssl_raw.get("enabled", api.ssl_enabled))
            api.ssl_cert = str(ssl_raw.get("cert_file", api.ssl_cert))
            api.ssl_key = str(ssl_raw.get("key_file", api.ssl_key))

        db_raw = dict(storage_raw.pop("database", None) or {})
        img_raw = dict(storage_raw.pop("image_storage", None) or {})
        res_raw = dict(storage_raw.pop("results_storage", None) or {})
        if "type" in db_raw:
            storage_raw.setdefault("database_type", db_raw["type"])
        if "name" in db_raw:
            storage_raw.setdefault("database_path", db_raw["name"])
        for src, dst in (("save_processed_images", "save_processed_images"),
                         ("save_failed_images", "save_failed_images"),
                         ("storage_path", "image_storage_path"),
                         ("retention_days", "retention_days"),
                         ("max_storage_gb", "max_storage_gb")):
            if src in img_raw:
                storage_raw.setdefault(dst, img_raw[src])
        if "save_detailed_results" in res_raw:
            storage_raw.setdefault("save_detailed_results", res_raw["save_detailed_results"])
        bk_raw = dict((raw.get("production") or {}).get("backup") or {})
        for src, dst in (("enabled", "backup_enabled"), ("frequency", "backup_frequency"),
                         ("retention_days", "backup_retention_days"),
                         ("backup_path", "backup_path")):
            if src in bk_raw:
                storage_raw.setdefault(dst, bk_raw[src])

        alert_thr_raw = dict(alerts_raw.pop("thresholds", None) or {})
        if "webhook_urls" in alerts_raw:
            alerts_raw["webhook_urls"] = tuple(alerts_raw["webhook_urls"] or ())
        alerts = _build(AlertsConfig, alerts_raw)
        if alert_thr_raw:
            alerts.thresholds = _build(AlertThresholds, alert_thr_raw)

        # production.scaling (the config.yaml layout) wins over the top-level
        # "scaling" that to_dict writes, so that a patch of either applies
        scaling_raw = dict(raw.pop("scaling", None) or {})
        scaling_raw.update((raw.get("production") or {}).get("scaling") or {})

        return cls(
            model=_build(ModelConfig, model_raw),
            processing=processing,
            quality_control=qc,
            spc=spc,
            api=api,
            edge=_build(EdgeConfig, edge_raw),
            mesh=_build(MeshConfig, mesh_raw),
            alerts=alerts,
            storage=_build(StorageConfig, storage_raw),
            qc_specific=_build(QCSpecificConfig, qc_spec_raw),
            scaling=_build(ScalingConfig, scaling_raw),
            extra=raw,
        ).validate()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    def update(self, patch: Dict[str, Any]) -> "SystemConfig":
        """Apply a nested dict patch and revalidate."""
        return SystemConfig.from_dict(_merge(self.to_dict(), patch))

    def json(self) -> str:
        return json.dumps(self.to_dict(), default=str)


def _build(cls, raw: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


def load_config(path: Optional[str] = None) -> SystemConfig:
    """The configuration in the file at ``path`` over the shipped profile.

    JSON is read with the standard library; ``.yaml`` / ``.yml`` needs PyYAML
    and raises where it is missing. No path gives the shipped profile; so does
    a path where no file exists (logged), as the JAX package does. A file that
    exists but cannot be read or validated raises."""
    if path is None:
        return SystemConfig().validate()
    if not os.path.exists(path):
        logger.warning("config file %s not found; using the shipped profile", path)
        return SystemConfig().validate()
    return SystemConfig.from_dict(read_config_file(path))


def read_config_file(path: str) -> Dict[str, Any]:
    """The dict in the JSON file at ``path`` (empty for an empty file), or
    in the YAML file where it ends in ``.yaml`` / ``.yml``, which needs
    PyYAML and raises where it is missing."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            yaml = importlib.import_module("yaml")
        except ImportError as e:
            raise RuntimeError(
                f"{path} is YAML, and reading YAML needs PyYAML, which is not "
                "installed; give the configuration as a JSON file instead") from e
        return yaml.safe_load(text) or {}
    return json.loads(text) if text.strip() else {}
