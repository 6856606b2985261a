"""int8 YOLOv8 with a quantize before every convolution (the v1 walk), its
quantization, calibration and counts: the JAX package's
``models/yolo_int8.py``.

Scheme (as ``resnet_int8``): per-output-channel symmetric int8 weights with
the inference BatchNorm (epsilon 1e-3) folded into the dequant multiplier
and bias; per-tensor statically calibrated activation scales, one per
convolution in call order; int8 x int8 -> int32 convolutions
(``int8_conv``, symmetric k//2 padding at every stride); the epilogue
``acc * bf16(s_x * mult) + bias`` and SiLU in bfloat16, and bfloat16
activations between convolutions. The two 1x1 output projections of each
head stay float: bfloat16 operands, float32 sums (as float32 products of
bfloat16-rounded values; TF32 must be off on the card).

``quantize_yolo`` runs in numpy on the Flax variables (HWIO kernels) in the
JAX package's order of operations, so its tree equals the JAX one;
``device_tree`` puts such a tree on a device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.models.int8_conv import conv_int8, prepare_weight
from iqc_tpu_torch.models.layers import silu
from iqc_tpu_torch.models.resnet_int8 import (
    BF16,
    _dyn_scale,
    _fold_bn,
    _quant_conv_weights,
    dequant_affine,
    quantize_codes,
    tree_size_bytes,  # noqa: F401  (the size of a quantize_yolo tree)
)
from iqc_tpu_torch.models.yolo import _depth, space_to_depth


def _pack_convbn(tree_p: Dict, tree_s: Dict) -> Dict:
    """One ConvBN {Conv_0, BatchNorm_0} -> {w_q HWIO int8, mult, bias}."""
    w_q, w_scale = _quant_conv_weights(np.asarray(tree_p["Conv_0"]["kernel"]))
    a, b = _fold_bn(tree_p["BatchNorm_0"], tree_s["BatchNorm_0"], eps=1e-3)
    return {"w_q": w_q, "mult": w_scale * a, "bias": b}


def _pack_c2f(tree_p: Dict, tree_s: Dict) -> Dict:
    # numeric order: 'C2fBottleneck_10' sorts before 'C2fBottleneck_2'
    bn = sorted((k for k in tree_p if k.startswith("C2fBottleneck_")),
                key=lambda k: int(k.rsplit("_", 1)[1]))
    return {
        "in": _pack_convbn(tree_p["ConvBN_0"], tree_s["ConvBN_0"]),
        "bottlenecks": [
            {"conv1": _pack_convbn(tree_p[k]["ConvBN_0"], tree_s[k]["ConvBN_0"]),
             "conv2": _pack_convbn(tree_p[k]["ConvBN_1"], tree_s[k]["ConvBN_1"])}
            for k in bn
        ],
        "out": _pack_convbn(tree_p["ConvBN_1"], tree_s["ConvBN_1"]),
    }


def _pack_head(tree_p: Dict, tree_s: Dict) -> Dict:
    proj = lambda name: {k: np.asarray(tree_p[name][k], np.float32) for k in ("kernel", "bias")}
    return {
        "box1": _pack_convbn(tree_p["ConvBN_0"], tree_s["ConvBN_0"]),
        "box2": _pack_convbn(tree_p["ConvBN_1"], tree_s["ConvBN_1"]),
        "cls1": _pack_convbn(tree_p["ConvBN_2"], tree_s["ConvBN_2"]),
        "cls2": _pack_convbn(tree_p["ConvBN_3"], tree_s["ConvBN_3"]),
        "box_out": proj("box_out"),
        "cls_out": proj("cls_out"),
    }


def quantize_yolo(variables: Dict, stem_mode: str = "conv") -> Dict:
    """Flax YOLOv8 variables (numpy leaves) -> int8 tree of numpy arrays.
    The stem flavour is told by its keys (``stem_s2d`` or ``stem``/``down2``)."""
    p, s = variables["params"], variables["batch_stats"]
    q: Dict[str, Any] = {}
    if stem_mode == "s2d":
        q["stem_s2d"] = _pack_convbn(p["stem_s2d"], s["stem_s2d"])
    else:
        q["stem"] = _pack_convbn(p["stem"], s["stem"])
        q["down2"] = _pack_convbn(p["down2"], s["down2"])
    for name in ("down3", "down4", "down5", "neck_down4", "neck_down5"):
        q[name] = _pack_convbn(p[name], s[name])
    for name in ("c2f_2", "c2f_3", "c2f_4", "c2f_5",
                 "neck_td4", "neck_td3", "neck_bu4", "neck_bu5"):
        q[name] = _pack_c2f(p[name], s[name])
    q["sppf"] = {"in": _pack_convbn(p["sppf"]["ConvBN_0"], s["sppf"]["ConvBN_0"]),
                 "out": _pack_convbn(p["sppf"]["ConvBN_1"], s["sppf"]["ConvBN_1"])}
    for name in ("head_p3", "head_p4", "head_p5"):
        q[name] = _pack_head(p[name], s[name])
    return q


def device_tree(node, device) -> Any:
    """A numpy tree of ``quantize_yolo`` (of either package) -> the form
    ``apply`` takes on ``device``: conv {"w": ConvWeight, "mult" f32,
    "bias_bf16"}; output projection {"kernel": [Cin,Cout] f32 of the
    bfloat16-rounded kernel, "bias" f32}."""
    t = lambda a, dt=np.float32: torch.as_tensor(np.array(a, dt), device=device)
    if isinstance(node, dict):
        if "w_q" in node:
            return {"w": prepare_weight(t(node["w_q"], np.int8)), "mult": t(node["mult"]),
                    "bias_bf16": t(node["bias"]).to(BF16)}
        if "kernel" in node:
            k = t(node["kernel"])
            return {"kernel": k.reshape(k.shape[-2], k.shape[-1]).to(BF16).to(torch.float32),
                    "bias": t(node["bias"])}
        return {k: device_tree(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [device_tree(v, device) for v in node]
    return node


def _qconvbn(x: torch.Tensor, layer: Dict, ctx: Dict, stride: int = 1,
             kernel: int = 3) -> torch.Tensor:
    """int8 conv + folded BatchNorm + SiLU of NHWC x -> bfloat16 NHWC."""
    i = ctx["i"]
    ctx["i"] = i + 1
    s_x = ctx["scales"][i] if ctx.get("scales") is not None else _dyn_scale(x)
    if ctx.get("collect") is not None:
        ctx["collect"].append(_dyn_scale(x))
    p = kernel // 2
    acc = conv_int8(quantize_codes(x, s_x), layer["w"], stride, [(p, p), (p, p)])
    y = dequant_affine(acc, (s_x * layer["mult"]).to(BF16), layer["bias_bf16"])
    return silu(y)


def _bf16_conv1x1(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    """1x1 projection: bfloat16 operands, float32 sums, float32 bias."""
    return x.to(BF16).to(torch.float32) @ layer["kernel"] + layer["bias"]


def _c2f(x: torch.Tensor, block: Dict, ctx: Dict, shortcut: bool) -> torch.Tensor:
    y = _qconvbn(x, block["in"], ctx, kernel=1)
    c = y.shape[-1] // 2
    parts = [y[..., :c], y[..., c:]]
    for b in block["bottlenecks"]:
        z = _qconvbn(parts[-1], b["conv1"], ctx)
        z = _qconvbn(z, b["conv2"], ctx)
        if shortcut:
            z = parts[-1] + z
        parts.append(z)
    return _qconvbn(torch.cat(parts, dim=-1), block["out"], ctx, kernel=1)


def _pool5(x: torch.Tensor) -> torch.Tensor:
    """5x5/1 max pool of NHWC, padded with -inf (exact in bfloat16)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 5, 1, 2).permute(0, 2, 3, 1)


def _sppf(x: torch.Tensor, block: Dict, ctx: Dict) -> torch.Tensor:
    x = _qconvbn(x, block["in"], ctx, kernel=1)
    p1 = _pool5(x)
    p2 = _pool5(p1)
    p3 = _pool5(p2)
    return _qconvbn(torch.cat([x, p1, p2, p3], dim=-1), block["out"], ctx, kernel=1)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _head(x: torch.Tensor, block: Dict, ctx: Dict, reg_max: int, num_classes: int):
    b = _qconvbn(_qconvbn(x, block["box1"], ctx), block["box2"], ctx)
    dist = _bf16_conv1x1(b, block["box_out"])
    c = _qconvbn(_qconvbn(x, block["cls1"], ctx), block["cls2"], ctx)
    cls = _bf16_conv1x1(c, block["cls_out"])
    n, h, w, _ = dist.shape
    return dist.reshape(n, h * w, 4 * reg_max), cls.reshape(n, h * w, num_classes)


def apply(q: Dict, images: torch.Tensor, reg_max: int = 16, num_classes: int = 5,
          act_scales: Optional[torch.Tensor] = None,
          _collect: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 forward of a ``device_tree``: images float NHWC (as the float
    path takes them) -> (dist_logits [B,A,4*reg_max], cls_logits [B,A,C])
    float32. ``act_scales``: [n_convs] float32 on the images' device; None
    quantizes each input with its own absmax."""
    ctx = {"i": 0, "scales": act_scales, "collect": _collect}
    x = images.to(BF16)
    if "stem_s2d" in q:
        x = _qconvbn(space_to_depth(x, 4), q["stem_s2d"], ctx)
    else:
        x = _qconvbn(x, q["stem"], ctx, stride=2)
        x = _qconvbn(x, q["down2"], ctx, stride=2)
    x = _c2f(x, q["c2f_2"], ctx, True)
    x = _qconvbn(x, q["down3"], ctx, stride=2)
    p3 = _c2f(x, q["c2f_3"], ctx, True)
    x = _qconvbn(p3, q["down4"], ctx, stride=2)
    p4 = _c2f(x, q["c2f_4"], ctx, True)
    x = _qconvbn(p4, q["down5"], ctx, stride=2)
    x = _c2f(x, q["c2f_5"], ctx, True)
    p5 = _sppf(x, q["sppf"], ctx)

    n4 = _c2f(torch.cat([_upsample2x(p5), p4], dim=-1), q["neck_td4"], ctx, False)
    o3 = _c2f(torch.cat([_upsample2x(n4), p3], dim=-1), q["neck_td3"], ctx, False)
    d4 = _qconvbn(o3, q["neck_down4"], ctx, stride=2)
    o4 = _c2f(torch.cat([d4, n4], dim=-1), q["neck_bu4"], ctx, False)
    d5 = _qconvbn(o4, q["neck_down5"], ctx, stride=2)
    o5 = _c2f(torch.cat([d5, p5], dim=-1), q["neck_bu5"], ctx, False)

    dists, clss = [], []
    for feat, name in ((o3, "head_p3"), (o4, "head_p4"), (o5, "head_p5")):
        dist, cls = _head(feat, q[name], ctx, reg_max, num_classes)
        dists.append(dist)
        clss.append(cls)
    return (torch.cat(dists, dim=1).to(torch.float32),
            torch.cat(clss, dim=1).to(torch.float32))


def n_convs(depth_mult: float = 0.334, stem_mode: str = "conv") -> int:
    """Number of quantized ConvBN layers in forward call order."""
    n = _depth(3, depth_mult)      # c2f_2, c2f_5 and neck blocks' inner count
    n6 = _depth(6, depth_mult)     # c2f_3, c2f_4
    c2f = lambda k: 2 + 2 * k
    total = 1 if stem_mode == "s2d" else 2
    total += c2f(n) + 1 + c2f(n6) + 1 + c2f(n6) + 1 + c2f(n)  # backbone and downs
    total += 2                      # sppf in/out
    total += c2f(n) * 4             # 4 neck C2f blocks
    total += 2                      # neck downsamples
    total += 4 * 3                  # 3 heads x 4 ConvBN
    return total


def calibrate_activation_scales(q: Dict, sample_batches, reg_max: int = 16,
                                num_classes: int = 5) -> torch.Tensor:
    """Per-convolution input absmax / 127 over calibration batches (running
    max), on the tree's device. Returns [n_convs] float32."""
    scales = None
    with torch.inference_mode():
        for batch in sample_batches:
            collect: List = []
            apply(q, batch, reg_max, num_classes, act_scales=None, _collect=collect)
            s = torch.stack(collect)
            scales = s if scales is None else torch.maximum(scales, s)
    return scales
