"""Streaming (int8-resident) YOLOv8: every activation tensor has one static
scale and is quantized once, in its producer's epilogue, so convolutions
read and write int8 codes (the JAX package's ``models/yolo_int8_stream.py``).

- Concats, slices, 2x nearest upsampling and the SPPF 5x5 max pools run on
  the codes: quantization is monotonic and elementwise, so they commute
  with it exactly.
- Each convolution takes raw codes: the per-input-channel dequant scales
  are folded into the conv weights before weight quantization. A symbolic
  "plan" pass over the same forward recovers the scale composition of
  every convolution's input, mixed-scale concats included.
- C2f shortcuts add the not yet quantized SiLU output to the dequantized
  skip codes in bfloat16; the sum is quantized once.
- The head output projections (box_out, cls_out) stay float: bfloat16
  operands, float32 accumulation, on never-quantized inputs.

One body, ``_forward``, runs three modes with tensor ids assigned in call
order: "plan" (no values), "calib" (the BatchNorm-folded float forward,
recording each tensor's absmax / 127) and "quant" (the int8 forward).
The calib convolutions and the head projections are float32 products of
bfloat16-rounded operands: exact products, float32 sums, as a bfloat16
convolution with float32 accumulation computes them (TF32 must be off on
the card).

Host work (``fold_fp``, ``quantize``) runs in numpy in the JAX package's
order of operations, so the int8 tree equals the JAX one for the same
scales; ``device_tree`` puts an fp or int8 tree on a device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.models.int8_conv import conv_int8, prepare_weight
from iqc_tpu_torch.models.layers import silu
from iqc_tpu_torch.models.resnet_int8 import BF16, dequant_affine, quantize_codes
from iqc_tpu_torch.models.yolo import space_to_depth
from iqc_tpu_torch.models.yolo_int8 import n_convs

Comp = List[Tuple[int, int]]  # [(tensor_id, n_channels), ...] of a value
QT = Tuple[Optional[torch.Tensor], Comp]  # (codes | float | None, composition)

_NO_TID = -1  # composition marker of never-quantized (float) values


# --------------------------------------------------------------------------
# fp folding (host, once)
# --------------------------------------------------------------------------

def _fold_convbn_fp(tree_p: Dict, tree_s: Dict) -> Dict:
    """ConvBN {Conv_0, BatchNorm_0} -> {w_f: W * bn_slope (HWIO f32), bias}."""
    w = np.asarray(tree_p["Conv_0"]["kernel"], np.float32)
    gamma = np.asarray(tree_p["BatchNorm_0"]["scale"], np.float32)
    beta = np.asarray(tree_p["BatchNorm_0"]["bias"], np.float32)
    mean = np.asarray(tree_s["BatchNorm_0"]["mean"], np.float32)
    var = np.asarray(tree_s["BatchNorm_0"]["var"], np.float32)
    a = gamma / np.sqrt(var + 1e-3)  # ConvBN's BatchNorm epsilon
    return {"w_f": w * a[None, None, None, :], "bias": beta - mean * a}


def _fold_c2f_fp(tree_p: Dict, tree_s: Dict) -> Dict:
    # numeric order: 'C2fBottleneck_10' sorts before 'C2fBottleneck_2'
    bn = sorted((k for k in tree_p if k.startswith("C2fBottleneck_")),
                key=lambda k: int(k.rsplit("_", 1)[1]))
    return {
        "in": _fold_convbn_fp(tree_p["ConvBN_0"], tree_s["ConvBN_0"]),
        "bottlenecks": [
            {"conv1": _fold_convbn_fp(tree_p[k]["ConvBN_0"], tree_s[k]["ConvBN_0"]),
             "conv2": _fold_convbn_fp(tree_p[k]["ConvBN_1"], tree_s[k]["ConvBN_1"])}
            for k in bn
        ],
        "out": _fold_convbn_fp(tree_p["ConvBN_1"], tree_s["ConvBN_1"]),
    }


def _fold_head_fp(tree_p: Dict, tree_s: Dict) -> Dict:
    return {
        "box1": _fold_convbn_fp(tree_p["ConvBN_0"], tree_s["ConvBN_0"]),
        "box2": _fold_convbn_fp(tree_p["ConvBN_1"], tree_s["ConvBN_1"]),
        "cls1": _fold_convbn_fp(tree_p["ConvBN_2"], tree_s["ConvBN_2"]),
        "cls2": _fold_convbn_fp(tree_p["ConvBN_3"], tree_s["ConvBN_3"]),
        "box_out": {"kernel": np.asarray(tree_p["box_out"]["kernel"], np.float32),
                    "bias": np.asarray(tree_p["box_out"]["bias"], np.float32)},
        "cls_out": {"kernel": np.asarray(tree_p["cls_out"]["kernel"], np.float32),
                    "bias": np.asarray(tree_p["cls_out"]["bias"], np.float32)},
    }


def fold_fp(variables: Dict, stem_mode: str = "conv") -> Dict:
    """Flax YOLOv8 variables (numpy leaves) -> BatchNorm-folded float32 tree
    with {w_f, bias} conv leaves (the calibration form)."""
    p, s = variables["params"], variables["batch_stats"]
    fp: Dict[str, Any] = {}
    if stem_mode == "s2d":
        fp["stem_s2d"] = _fold_convbn_fp(p["stem_s2d"], s["stem_s2d"])
    else:
        fp["stem"] = _fold_convbn_fp(p["stem"], s["stem"])
        fp["down2"] = _fold_convbn_fp(p["down2"], s["down2"])
    for name in ("down3", "down4", "down5", "neck_down4", "neck_down5"):
        fp[name] = _fold_convbn_fp(p[name], s[name])
    for name in ("c2f_2", "c2f_3", "c2f_4", "c2f_5",
                 "neck_td4", "neck_td3", "neck_bu4", "neck_bu5"):
        fp[name] = _fold_c2f_fp(p[name], s[name])
    fp["sppf"] = {"in": _fold_convbn_fp(p["sppf"]["ConvBN_0"], s["sppf"]["ConvBN_0"]),
                  "out": _fold_convbn_fp(p["sppf"]["ConvBN_1"], s["sppf"]["ConvBN_1"])}
    for name in ("head_p3", "head_p4", "head_p5"):
        fp[name] = _fold_head_fp(p[name], s[name])
    return fp


def device_tree(node, device) -> Any:
    """An fp tree (``fold_fp``) or int8 tree (``quantize``) of numpy arrays
    -> the form the forward takes on ``device``:
    fp conv {"w_f", "bias"} -> {"w": OIHW f32 of the bf16-rounded kernel,
    "bias_bf16"}; int8 conv {"w_q", "mult", "bias"} -> {"w": ConvWeight,
    "mult_bf16", "bias_bf16"}; head projection {"kernel", "bias"} ->
    {"kernel": [Cin,Cout] f32 of the bf16-rounded kernel, "bias" f32}."""
    t = lambda a, dt=np.float32: torch.as_tensor(np.array(a, dt), device=device)
    if isinstance(node, dict):
        if "w_f" in node:
            w = t(node["w_f"]).to(BF16).to(torch.float32).permute(3, 2, 0, 1).contiguous()
            return {"w": w, "bias_bf16": t(node["bias"]).to(BF16), "cout": w.shape[0]}
        if "w_q" in node:
            w = prepare_weight(t(node["w_q"], np.int8))
            return {"w": w, "mult_bf16": t(node["mult"]).to(BF16),
                    "bias_bf16": t(node["bias"]).to(BF16), "cout": w.cout}
        if "kernel" in node:
            k = t(node["kernel"])
            return {"kernel": k.reshape(k.shape[-2], k.shape[-1]).to(BF16).to(torch.float32),
                    "bias": t(node["bias"])}
        return {k: device_tree(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [device_tree(v, device) for v in node]
    return node


# --------------------------------------------------------------------------
# the three-mode forward: "plan" (symbolic), "calib" (float), "quant" (int8)
# --------------------------------------------------------------------------

def _out_channels(layer: Dict) -> int:
    if "cout" in layer:
        return int(layer["cout"])
    key = "w_f" if "w_f" in layer else "w_q"
    return int(layer[key].shape[-1])


def _absmax_scale(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.amax(torch.abs(y.to(torch.float32))) / 127.0, min=1e-12)


def _emit(ctx: Dict, y, channels: int) -> QT:
    """Assign the next tensor id and quantize y with its static scale."""
    tid = ctx["t"]
    ctx["t"] = tid + 1
    if ctx["mode"] == "plan":
        return None, [(tid, channels)]
    if ctx["mode"] == "calib":
        ctx["collect"].append(_absmax_scale(y))
        return y, [(tid, channels)]
    return quantize_codes(y, ctx["scales"][tid]), [(tid, channels)]


def _deq(qt: QT, ctx: Dict):
    """Codes -> bfloat16 values (calib mode already carries bfloat16)."""
    val, comp = qt
    if ctx["mode"] == "calib":
        return val.to(BF16)
    (tid, _), = comp  # single-tensor values only (slices keep their tid)
    return val.to(BF16) * ctx["scales"][tid].to(BF16)


def _conv_nhwc_f32(x: torch.Tensor, w_oihw: torch.Tensor, stride: int, pad: int):
    y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32), w_oihw, None, stride, pad)
    return y.permute(0, 2, 3, 1)


def _qcb(qt: QT, layer: Dict, ctx: Dict, stride: int = 1, kernel: int = 3,
         emit: bool = True, add_qt: Optional[QT] = None) -> QT:
    """Quantized ConvBN + SiLU (+ the C2f shortcut add) -> next tensor.
    ``emit=False`` returns the bfloat16 SiLU output unquantized (head tails)."""
    x, comp = qt
    co = _out_channels(layer)
    if ctx["mode"] == "plan":
        ctx["plans"][id(layer)] = list(comp)
        if not emit:
            return None, [(_NO_TID, co)]
        return _emit(ctx, None, co)
    p = kernel // 2
    if ctx["mode"] == "calib":
        acc = _conv_nhwc_f32(x.to(BF16), layer["w"], stride, p)
        y = acc.to(BF16) + layer["bias_bf16"]
    else:
        acc = conv_int8(x, layer["w"], stride, [(p, p), (p, p)])
        y = dequant_affine(acc, layer["mult_bf16"], layer["bias_bf16"])
    y = silu(y)
    if add_qt is not None:
        y = y + _deq(add_qt, ctx)
    if not emit:
        return y, [(_NO_TID, co)]
    return _emit(ctx, y, co)


def _qconcat(qts: List[QT]) -> QT:
    comp: Comp = []
    for _, c in qts:
        comp.extend(c)
    vals = [v for v, _ in qts]
    if vals[0] is None:  # plan
        return None, comp
    return torch.cat(vals, dim=-1), comp


def _comp_slice(comp: Comp, lo: int, hi: int) -> Comp:
    out: Comp = []
    pos = 0
    for tid, n in comp:
        s, e = max(lo, pos), min(hi, pos + n)
        if e > s:
            out.append((tid, e - s))
        pos += n
    return out


def _qslice(qt: QT, lo: int, hi: int) -> QT:
    val, comp = qt
    return (None if val is None else val[..., lo:hi]), _comp_slice(comp, lo, hi)


def _qpool5(qt: QT) -> QT:
    """5x5/1 max pool (pad 2) on NHWC codes or values; int8 codes pool
    through a float32 cast, which is exact."""
    val, comp = qt
    if val is None:
        return None, comp
    y = val.to(torch.float32) if val.dtype == torch.int8 else val
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 5, 1, 2).permute(0, 2, 3, 1)
    return y.to(val.dtype), comp


def _qup2(qt: QT) -> QT:
    """2x nearest-neighbour upsample of NHWC, exact on codes."""
    val, comp = qt
    if val is None:
        return None, comp
    return val.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), comp


def _qs2d(qt: QT) -> QT:
    val, comp = qt
    (tid, n), = comp  # the s2d input is the quantized image alone
    comp2 = [(tid, 16 * n)]
    if val is None:
        return None, comp2
    return space_to_depth(val, 4), comp2


def _quant_input(images, ctx: Dict) -> QT:
    """The network input is tensor id 0."""
    tid = ctx["t"]
    ctx["t"] = tid + 1
    if ctx["mode"] == "plan":
        return None, [(tid, 3)]
    if ctx["mode"] == "calib":
        ctx["collect"].append(_absmax_scale(images))
        return images.to(BF16), [(tid, 3)]
    return quantize_codes(images, ctx["scales"][tid]), [(tid, 3)]


def _c2f(qt: QT, block: Dict, ctx: Dict, shortcut: bool) -> QT:
    y = _qcb(qt, block["in"], ctx, kernel=1)
    c = sum(n for _, n in y[1]) // 2
    parts = [_qslice(y, 0, c), _qslice(y, c, 2 * c)]
    for b in block["bottlenecks"]:
        z1 = _qcb(parts[-1], b["conv1"], ctx)
        z = _qcb(z1, b["conv2"], ctx, add_qt=parts[-1] if shortcut else None)
        parts.append(z)
    return _qcb(_qconcat(parts), block["out"], ctx, kernel=1)


def _sppf(qt: QT, block: Dict, ctx: Dict) -> QT:
    x = _qcb(qt, block["in"], ctx, kernel=1)
    p1 = _qpool5(x)
    p2 = _qpool5(p1)
    p3 = _qpool5(p2)
    return _qcb(_qconcat([x, p1, p2, p3]), block["out"], ctx, kernel=1)


def _bf16_conv1x1(x: torch.Tensor, layer: Dict) -> torch.Tensor:
    """1x1 projection: bfloat16 operands, float32 accumulation, float32 bias."""
    return x.to(BF16).to(torch.float32) @ layer["kernel"] + layer["bias"]


def _head(qt: QT, block: Dict, ctx: Dict, reg_max: int, num_classes: int):
    b1 = _qcb(qt, block["box1"], ctx)
    b2, _ = _qcb(b1, block["box2"], ctx, emit=False)
    c1 = _qcb(qt, block["cls1"], ctx)
    c2, _ = _qcb(c1, block["cls2"], ctx, emit=False)
    if ctx["mode"] == "plan":
        return None, None
    dist = _bf16_conv1x1(b2, block["box_out"])
    cls = _bf16_conv1x1(c2, block["cls_out"])
    n, h, w, _ = dist.shape
    return dist.reshape(n, h * w, 4 * reg_max), cls.reshape(n, h * w, num_classes)


def _forward(tree: Dict, images, ctx: Dict, reg_max: int, num_classes: int):
    """One body for all three modes; tensor ids are assigned in call order,
    so plan, calib and quant agree by construction."""
    qt = _quant_input(images, ctx)
    if "stem_s2d" in tree:
        qt = _qcb(_qs2d(qt), tree["stem_s2d"], ctx)
    else:
        qt = _qcb(qt, tree["stem"], ctx, stride=2)
        qt = _qcb(qt, tree["down2"], ctx, stride=2)
    qt = _c2f(qt, tree["c2f_2"], ctx, True)
    qt = _qcb(qt, tree["down3"], ctx, stride=2)
    p3 = _c2f(qt, tree["c2f_3"], ctx, True)
    qt = _qcb(p3, tree["down4"], ctx, stride=2)
    p4 = _c2f(qt, tree["c2f_4"], ctx, True)
    qt = _qcb(p4, tree["down5"], ctx, stride=2)
    qt = _c2f(qt, tree["c2f_5"], ctx, True)
    p5 = _sppf(qt, tree["sppf"], ctx)

    n4 = _c2f(_qconcat([_qup2(p5), p4]), tree["neck_td4"], ctx, False)
    o3 = _c2f(_qconcat([_qup2(n4), p3]), tree["neck_td3"], ctx, False)
    d4 = _qcb(o3, tree["neck_down4"], ctx, stride=2)
    o4 = _c2f(_qconcat([d4, n4]), tree["neck_bu4"], ctx, False)
    d5 = _qcb(o4, tree["neck_down5"], ctx, stride=2)
    o5 = _c2f(_qconcat([d5, p5]), tree["neck_bu5"], ctx, False)

    dists, clss = [], []
    for feat, name in ((o3, "head_p3"), (o4, "head_p4"), (o5, "head_p5")):
        dist, cls = _head(feat, tree[name], ctx, reg_max, num_classes)
        dists.append(dist)
        clss.append(cls)
    if ctx["mode"] == "plan":
        return None
    return (torch.cat(dists, dim=1).to(torch.float32),
            torch.cat(clss, dim=1).to(torch.float32))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def n_tensors(depth_mult: float = 0.334, stem_mode: str = "conv") -> int:
    """Number of quantized tensors (scale slots): the input and every ConvBN
    output except the 6 head tails; a shortcut add reuses its conv2's slot."""
    return 1 + n_convs(depth_mult, stem_mode) - 6


def calibrate(fp_tree: Dict, sample_batches, reg_max: int = 16,
              num_classes: int = 5) -> torch.Tensor:
    """Per-tensor running absmax / 127 over calibration batches on the
    BatchNorm-folded float forward. ``fp_tree``: a ``device_tree`` of
    ``fold_fp``; batches on its device. Returns [n_tensors] float32."""
    scales = None
    with torch.inference_mode():
        for batch in sample_batches:
            ctx = {"mode": "calib", "t": 0, "collect": []}
            _forward(fp_tree, batch, ctx, reg_max, num_classes)
            s = torch.stack(ctx["collect"])
            scales = s if scales is None else torch.maximum(scales, s)
    return scales


def quantize(variables: Dict, scales, stem_mode: str = "conv",
             reg_max: int = 16, num_classes: int = 5) -> Dict:
    """Flax variables + per-tensor scales -> int8 tree of numpy arrays with
    the input-side dequant folded into every conv's weights."""
    fp = fold_fp(variables, stem_mode)
    ctx = {"mode": "plan", "t": 0, "plans": {}}
    _forward(fp, None, ctx, reg_max, num_classes)
    n = ctx["t"]
    scales_np = np.asarray(scales, np.float32)
    if scales_np.shape[0] != n:
        raise ValueError(f"scales has {scales_np.shape[0]} slots, forward plans {n}")

    def walk(node):
        if isinstance(node, dict):
            if "w_f" in node:
                comp = ctx["plans"][id(node)]
                w = np.asarray(node["w_f"], np.float32)
                s_vec = np.concatenate([np.full(nc, scales_np[tid], np.float32)
                                        for tid, nc in comp])
                if s_vec.shape[0] != w.shape[2]:
                    raise ValueError(f"plan comp {comp} != kernel input dim {w.shape}")
                w_eff = w * s_vec[None, None, :, None]
                sc = np.maximum(np.max(np.abs(w_eff), axis=(0, 1, 2)) / 127.0, 1e-12)
                w_q = np.clip(np.round(w_eff / sc), -127, 127).astype(np.int8)
                return {"w_q": w_q, "mult": sc.astype(np.float32),
                        "bias": np.asarray(node["bias"], np.float32)}
            if "kernel" in node:  # bfloat16 head projection
                return {k: np.asarray(v, np.float32) for k, v in node.items()}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(fp)


def apply(q: Dict, images: torch.Tensor, scales: torch.Tensor, reg_max: int = 16,
          num_classes: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-resident forward of a ``device_tree`` of ``quantize``: images
    float NHWC -> (dist_logits [B,A,4*reg_max], cls_logits [B,A,C]) float32.
    ``scales`` on the images' device."""
    ctx = {"mode": "quant", "t": 0, "scales": scales}
    return _forward(q, images, ctx, reg_max, num_classes)
