"""The models: ResNet-50 classifier, YOLOv8 detector and the fused ensemble
(the names the JAX package's ``iqc_tpu.models`` exports)."""

from iqc_tpu_torch.models.resnet import ResNet50, ResNetClassifier  # noqa: F401
from iqc_tpu_torch.models.yolo import YOLOv8, YOLODetector  # noqa: F401
from iqc_tpu_torch.models.ensemble import EnsemblePredictor, EnsembleOptimizer  # noqa: F401
