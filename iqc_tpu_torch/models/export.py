"""Portable model export: the fused detection forward as a ``torch.export``
program, with the variables it was built from, in one zip artifact.

The counterpart of the JAX package's ``models/export.py``, which serializes
the same forward to StableHLO. ``export_ensemble`` traces the
detection-only fused forward (``FullForward.ensemble`` + ``pack_outputs``:
YOLOv8, decode and merge-NMS, crop classification, fusion) at a fixed batch
with ``torch.export.export``. Its inputs are ``images`` (uint8
[B,H,W,3]), ``conf_t``, ``iou_t``, ``w_yolo`` and ``w_resnet`` (0-d float32
tensors), so the thresholds and weights stay run-time arguments; the
networks' weights, the int8 trees included, are lifted into the program.
The suppression kernel is one node, the custom op ``iqc.suppress``, which
runs the CUDA kernel on the card and its plain version on the CPU.

The zip holds ``meta.json`` (every key of the JAX package's meta, ``kind``
``iqc_tpu_torch.fused_ensemble``, plus ``torch_version`` and ``device``),
``graph.pt2`` (``torch.export.save``), ``yolo_vars.msgpack`` and
``resnet_vars.msgpack`` (the variables the predictor was built from: the
int8 ``{"q", "scales"}`` state at int8, else the Flax-layout float trees;
``weights.write_msgpack``), and ``anchors.npy`` / ``strides.npy``. An
artifact is read by the torch version that wrote it.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

FORMAT_VERSION = 1
_GRAPH = "graph.pt2"
_META = "meta.json"
_YOLO = "yolo_vars.msgpack"
_RESNET = "resnet_vars.msgpack"
_ANCHORS = "anchors.npy"
_STRIDES = "strides.npy"


class _DetectionForward(nn.Module):
    """The packed detection-only forward of a ``FullForward``."""

    def __init__(self, full_forward: nn.Module):
        super().__init__()
        self.full_forward = full_forward

    def forward(self, images, conf_t, iou_t, w_yolo, w_resnet):
        from iqc_tpu_torch.models.ensemble import pack_outputs

        fwd = self.full_forward
        return pack_outputs(fwd.ensemble(fwd._input(images), conf_t, iou_t, w_yolo, w_resnet))


def _variables(predictor, name: str) -> Any:
    """The predictor's int8 state of network ``name`` where it serves one,
    else the network's Flax-layout variables."""
    from iqc_tpu_torch.weights import to_flax

    state = getattr(predictor, f"{name}_vars")
    return state if state is not None else to_flax(getattr(predictor, name))


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def export_ensemble(predictor, path: str, batch_size: int = 1) -> Dict:
    """Serialize ``predictor``'s fused detection forward and variables to
    ``path``, traced at ``batch_size`` on the predictor's device. Returns the
    manifest (also stored in the artifact as meta.json)."""
    from iqc_tpu_torch.weights import write_msgpack

    fwd = predictor.full_forward
    dev = predictor.device
    h, w = predictor.input_size
    scalar = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    example = (torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=dev),
               scalar(predictor.confidence_threshold), scalar(predictor.nms_threshold),
               scalar(predictor.ensemble_weights["yolo"]),
               scalar(predictor.ensemble_weights["resnet"]))
    with torch.no_grad():
        program = torch.export.export(_DetectionForward(fwd).eval(), example)
    m = predictor.config.model
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "iqc_tpu_torch.fused_ensemble",
        "batch_size": batch_size,
        "input_size": list(predictor.input_size),
        "max_detections": predictor.max_detections,
        "max_classified": predictor.max_classified,
        "num_classes": m.num_classes,
        "class_names": list(predictor.class_names),
        "precision": predictor.config.edge.precision,
        "defaults": {
            "confidence_threshold": float(predictor.confidence_threshold),
            "nms_threshold": float(predictor.nms_threshold),
            "ensemble_weights": dict(predictor.ensemble_weights),
        },
        "jax_version": None,
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "device": str(dev),
    }
    graph = io.BytesIO()
    torch.export.save(program, graph)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META, json.dumps(meta, indent=1))
        z.writestr(_GRAPH, graph.getvalue())
        z.writestr(_YOLO, write_msgpack(_variables(predictor, "yolo")))
        z.writestr(_RESNET, write_msgpack(_variables(predictor, "resnet")))
        z.writestr(_ANCHORS, _npy(fwd.anchors.cpu().numpy()))
        z.writestr(_STRIDES, _npy(fwd.strides.cpu().numpy()))
    return meta


class ExportedEnsemble:
    """A reloaded artifact: meta, variables and the callable program."""

    def __init__(self, meta: Dict, program, yolo_vars, resnet_vars,
                 anchors: np.ndarray, strides: np.ndarray, device):
        self.meta = meta
        self.program = program
        self.module = program.module()
        self.yolo_vars = yolo_vars
        self.resnet_vars = resnet_vars
        self.anchors = anchors
        self.strides = strides
        self.device = torch.device(device)

    def __call__(
        self,
        images: np.ndarray,
        confidence_threshold: Optional[float] = None,
        nms_threshold: Optional[float] = None,
        ensemble_weights: Optional[Dict[str, float]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Run the program; returns the packed (det [B,K,15], img [B,4+C])
        arrays (see ensemble.pack_outputs / unpack_outputs)."""
        d = self.meta["defaults"]
        conf = d["confidence_threshold"] if confidence_threshold is None else confidence_threshold
        iou = d["nms_threshold"] if nms_threshold is None else nms_threshold
        wts = ensemble_weights or d["ensemble_weights"]
        images = np.asarray(images, np.uint8)
        if images.shape[0] != self.meta["batch_size"]:
            raise ValueError(
                f"engine was exported for batch {self.meta['batch_size']}, "
                f"got {images.shape[0]}"
            )
        scalar = lambda v: torch.tensor(float(v), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            det, img = self.module(torch.from_numpy(np.ascontiguousarray(images)).to(self.device),
                                   scalar(conf), scalar(iou), scalar(wts["yolo"]),
                                   scalar(wts["resnet"]))
        return det.cpu().numpy(), img.cpu().numpy()

    def outputs(self, images: np.ndarray, **kw):
        """Run and unpack to EnsembleOutputs (numpy)."""
        from iqc_tpu_torch.models.ensemble import unpack_outputs

        det, img = self(images, **kw)
        return unpack_outputs(det, img)


def load_exported(path: str, device="cuda") -> ExportedEnsemble:
    """Reload an artifact written by export_ensemble, its program moved to
    ``device``."""
    # registers iqc::suppress, iqc::grow_clean and iqc::clean before the
    # program that calls them is read
    from torch.export.passes import move_to_device_pass

    from iqc_tpu_torch.ops import morph_kernel, nms_kernel  # noqa: F401
    from iqc_tpu_torch.weights import read_msgpack

    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read(_META))
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact version: {meta}")
        program = torch.export.load(io.BytesIO(z.read(_GRAPH)))
        yolo_vars = read_msgpack(z.read(_YOLO))
        resnet_vars = read_msgpack(z.read(_RESNET))
        anchors = np.load(io.BytesIO(z.read(_ANCHORS)))
        strides = np.load(io.BytesIO(z.read(_STRIDES)))
    program = move_to_device_pass(program, str(torch.device(device)))
    return ExportedEnsemble(meta, program, yolo_vars, resnet_vars, anchors, strides, device)
