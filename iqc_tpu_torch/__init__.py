"""PyTorch/CUDA port of the industrial quality-control vision framework.

The serving path of the JAX package (``iqc_tpu``) on one NVIDIA GPU: the
detector and predictor API, SPC and anomaly analytics, and the HTTP serving
layer (``python -m iqc_tpu_torch.serving.app``), with hand-written CUDA
kernels for NMS suppression and the segmentation morphology (``csrc/``).
"""

__version__ = "0.1.0"
