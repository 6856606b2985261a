"""Train-time augmentation of detection batches on the device: the YOLO half
of the JAX package's ``data/augmentation.py``.

``yolo_train_augment_batch`` applies, after mosaic, the Ultralytics
hyperparameters the training profile carries (``YoloAugHyp``): horizontal
and vertical flips, a random affine (rotation, scale, translation, shear)
that moves the boxes with the pixels, then HSV (a hue rotation about the
achromatic axis, saturation and value gains). Boxes that the affine leaves
narrower or lower than 2 px lose their validity.

As in ``ops/mosaic.py``, the random choices are drawn first, on the CPU from
an explicit ``torch.Generator`` (``draw_yolo_augment``), and the transform
applied on the device from them. With rotation and shear at 0 (the shipped
profile) the affine is separable: two bilinear matrix products with
bfloat16-rounded operands and float32 sums; otherwise it samples the image
bilinearly through the inverse map (edge-clamped).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from iqc_tpu_torch.ops.image import rgb_to_gray
from iqc_tpu_torch.ops.mosaic import _bf16, upload


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probabilities and ranges of the geometric stages the YOLO chain uses
    (the JAX package's ``AugmentConfig``; its photometric, noise and weather
    stages belong to the classifier's chain)."""

    p_hflip: float = 0.5
    p_vflip: float = 0.2
    p_affine: float = 0.5
    max_rotate_deg: float = 15.0
    max_scale: float = 0.1
    max_translate: float = 0.0625
    max_shear_deg: float = 0.0


@dataclasses.dataclass(frozen=True)
class YoloAugHyp:
    """The Ultralytics augmentation hyperparameters of the training profile
    (``config/yolo_config.yaml`` ``augmentation``). Mosaic and mixup go to
    the mosaic tiers; perspective must be 0."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5

    def __post_init__(self):
        if self.perspective:
            raise ValueError("perspective augmentation is not implemented (the training "
                             "profile sets 0.0)")

    @classmethod
    def from_dict(cls, raw) -> "YoloAugHyp":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in (raw or {}).items() if k in names})

    def active(self) -> bool:
        return any((self.hsv_h, self.hsv_s, self.hsv_v, self.degrees, self.translate,
                    self.scale, self.shear, self.flipud, self.fliplr))

    def geometry(self) -> AugmentConfig:
        return AugmentConfig(
            p_hflip=self.fliplr, p_vflip=self.flipud,
            p_affine=1.0 if (self.degrees or self.translate or self.scale or self.shear) else 0.0,
            max_rotate_deg=self.degrees, max_scale=self.scale,
            max_translate=self.translate, max_shear_deg=self.shear)


# -- primitives (float [0,1] images [B,H,W,3]) ---------------------------------


def _bilinear_gather(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C] sampled at [B,H,W] coordinates, edge-clamped."""
    b, h, w = img.shape[:3]
    y0 = torch.clamp(torch.floor(sy), 0, h - 1)
    x0 = torch.clamp(torch.floor(sx), 0, w - 1)
    fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    y0, x0 = y0.long(), x0.long()
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    bi = torch.arange(b, device=img.device)[:, None, None]

    def g(yi, xi):
        return img[bi, yi, xi]

    return (g(y0, x0) * (1 - fy) * (1 - fx) + g(y0, x1) * (1 - fy) * fx
            + g(y1, x0) * fy * (1 - fx) + g(y1, x1) * fy * fx)


def affine_grid_sample(img: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Bilinear resample of [B,H,W,C] through inverse 2x3 affine matrices
    [B,2,3] (output -> input, about the centre), edge-clamped."""
    h, w = img.shape[1:3]
    ys = torch.arange(h, dtype=torch.float32, device=img.device) - (h - 1) / 2
    xs = torch.arange(w, dtype=torch.float32, device=img.device) - (w - 1) / 2
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = matrix[:, :, :, None, None]
    sx = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2] + (w - 1) / 2
    sy = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2] + (h - 1) / 2
    return _bilinear_gather(img, sy, sx)


def _axis_interp_matrix(scale: torch.Tensor, shift: torch.Tensor, size: int) -> torch.Tensor:
    """[B,out,in] bilinear sampling matrices of a 1-D scale and shift about
    the centre, src = (out - c - shift) / scale + c, edge-replicating."""
    dev = scale.device
    i = torch.arange(size, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(size, dtype=torch.float32, device=dev)[None, :]
    c = (size - 1) / 2.0
    src = torch.clamp((i - c - shift[:, None, None]) / torch.clamp(scale, min=1e-3)[:, None, None]
                      + c, 0.0, size - 1.0)
    return torch.clamp(1.0 - torch.abs(src - j), min=0.0)


def saturate(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend towards grey by ``factor`` [B]."""
    gray = rgb_to_gray(img)[..., None]
    return torch.clamp(gray + factor[:, None, None, None] * (img - gray), 0.0, 1.0)


def hue_rotate(img: torch.Tensor, fraction: torch.Tensor) -> torch.Tensor:
    """Hue shift by ``fraction`` [B] of the wheel as a rotation of RGB about
    the achromatic axis (Rodrigues' formula; channel rolls)."""
    a = (fraction * 2.0 * math.pi)[:, None, None, None]
    c, s = torch.cos(a), torch.sin(a)
    cross = (torch.roll(img, 1, dims=-1) - torch.roll(img, -1, dims=-1)) / math.sqrt(3.0)
    mean = img.mean(-1, keepdim=True)
    return torch.clamp(img * c + cross * s + mean * (1.0 - c), 0.0, 1.0)


# -- the YOLO chain --------------------------------------------------------------


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand((n,), generator=gen, dtype=torch.float32) * (hi - lo) + lo


def draw_yolo_augment(gen: torch.Generator, batch: int, height: int, width: int,
                      hyp: YoloAugHyp) -> Dict[str, torch.Tensor]:
    """The random choices of one batch, on the CPU: per image the flip
    gates ``hflip``/``vflip`` and ``affine``, the affine's ``angle``
    (radians), ``scale``, ``tx``/``ty`` (pixels), ``shx``/``shy`` (shear
    tangents), identity where the affine is off, and the HSV ``hue``
    fraction and ``sat``/``val`` factors. Stages at probability or gain 0
    draw nothing."""
    geo = hyp.geometry()
    off = torch.zeros(batch, dtype=torch.bool)
    ones = torch.ones(batch)
    zeros = torch.zeros(batch)
    d = {"hflip": off, "vflip": off, "affine": off, "angle": zeros, "scale": ones,
         "tx": zeros, "ty": zeros, "shx": zeros, "shy": zeros, "hue": zeros, "sat": ones,
         "val": ones}
    if geo.p_hflip > 0:
        d["hflip"] = torch.rand((batch,), generator=gen) < geo.p_hflip
    if geo.p_vflip > 0:
        d["vflip"] = torch.rand((batch,), generator=gen) < geo.p_vflip
    if geo.p_affine > 0:
        on = torch.rand((batch,), generator=gen) < geo.p_affine
        deg, sc, tr, sh = geo.max_rotate_deg, geo.max_scale, geo.max_translate, geo.max_shear_deg
        ang = _uniform(gen, batch, -deg, deg) * math.pi / 180.0
        scale = 1.0 + _uniform(gen, batch, -sc, sc)
        tx = _uniform(gen, batch, -tr, tr) * width
        ty = _uniform(gen, batch, -tr, tr) * height
        shx = torch.tan(_uniform(gen, batch, -sh, sh) * math.pi / 180.0)
        shy = torch.tan(_uniform(gen, batch, -sh, sh) * math.pi / 180.0)
        d.update(affine=on, angle=torch.where(on, ang, zeros), scale=torch.where(on, scale, ones),
                 tx=torch.where(on, tx, zeros), ty=torch.where(on, ty, zeros),
                 shx=torch.where(on, shx, zeros), shy=torch.where(on, shy, zeros))
    if hyp.hsv_h > 0:
        d["hue"] = _uniform(gen, batch, -hyp.hsv_h, hyp.hsv_h)
    if hyp.hsv_s > 0:
        d["sat"] = 1.0 + _uniform(gen, batch, -hyp.hsv_s, hyp.hsv_s)
    if hyp.hsv_v > 0:
        d["val"] = 1.0 + _uniform(gen, batch, -hyp.hsv_v, hyp.hsv_v)
    return d


def yolo_train_augment_batch(images: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
                             valid: torch.Tensor, draws: Dict[str, torch.Tensor],
                             hyp: YoloAugHyp) -> Tuple[torch.Tensor, ...]:
    """images [B,H,W,3] float [0,1], boxes [B,M,4] xyxy pixels, classes and
    valid [B,M] -> the augmented batch (classes unchanged)."""
    geo = hyp.geometry()
    dev = images.device
    d = {k: upload(v, dev) for k, v in draws.items()}
    b, h, w = images.shape[:3]
    img, bx = images, boxes
    if geo.p_hflip > 0:
        on = d["hflip"]
        img = torch.where(on[:, None, None, None], img.flip(2), img)
        fl = torch.stack([w - bx[..., 2], bx[..., 1], w - bx[..., 0], bx[..., 3]], dim=-1)
        bx = torch.where(on[:, None, None], fl, bx)
    if geo.p_vflip > 0:
        on = d["vflip"]
        img = torch.where(on[:, None, None, None], img.flip(1), img)
        fl = torch.stack([bx[..., 0], h - bx[..., 3], bx[..., 2], h - bx[..., 1]], dim=-1)
        bx = torch.where(on[:, None, None], fl, bx)
    if geo.p_affine > 0:
        ang, scale, tx, ty, shx, shy = (d[k] for k in ("angle", "scale", "tx", "ty", "shx", "shy"))
        # the forward linear map about the centre: shear after rotate-scale
        ca, sa = torch.cos(ang) * scale, torch.sin(ang) * scale
        f00 = ca + shx * sa
        f01 = -sa + shx * ca
        f10 = shy * ca + sa
        f11 = -shy * sa + ca
        if geo.max_rotate_deg == 0 and geo.max_shear_deg == 0:
            wy = _bf16(_axis_interp_matrix(scale, ty, h))                  # [B,H,H]
            wx = _bf16(_axis_interp_matrix(scale, tx, w))                  # [B,W,W]
            rows = _bf16(torch.bmm(wy, _bf16(img).reshape(b, h, w * 3)).reshape(b, h, w, 3))
            resampled = torch.einsum("bikc,blk->bilc", rows, wx)
            # the identity is kept bit-exact where the affine is off
            img = torch.where(d["affine"][:, None, None, None],
                              torch.clamp(resampled, 0.0, 1.0), img)
        else:
            det = f00 * f11 - f01 * f10
            det = torch.where(torch.abs(det) < 1e-6, torch.full_like(det, 1e-6), det)
            i00, i01 = f11 / det, -f01 / det
            i10, i11 = -f10 / det, f00 / det
            inv = torch.stack([torch.stack([i00, i01, -(i00 * tx + i01 * ty)], -1),
                               torch.stack([i10, i11, -(i10 * tx + i11 * ty)], -1)], 1)
            img = affine_grid_sample(img, inv)
        # forward-transform the 4 corners, take the enclosing box
        cx0, cy0 = (w - 1) / 2, (h - 1) / 2
        xs = torch.stack([bx[..., 0], bx[..., 2], bx[..., 0], bx[..., 2]], -1)  # [B,M,4]
        ys = torch.stack([bx[..., 1], bx[..., 1], bx[..., 3], bx[..., 3]], -1)
        relx, rely = xs - cx0, ys - cy0
        e = lambda v: v[:, None, None]
        xr = e(f00) * relx + e(f01) * rely + cx0 + e(tx)
        yr = e(f10) * relx + e(f11) * rely + cy0 + e(ty)
        bx = torch.stack([torch.clamp(xr.amin(-1), 0, w), torch.clamp(yr.amin(-1), 0, h),
                          torch.clamp(xr.amax(-1), 0, w), torch.clamp(yr.amax(-1), 0, h)], -1)
    if hyp.hsv_h > 0:
        img = hue_rotate(img, d["hue"])
    if hyp.hsv_s > 0:
        img = saturate(img, d["sat"])
    if hyp.hsv_v > 0:
        img = torch.clamp(img * d["val"][:, None, None, None], 0.0, 1.0)
    bw = bx[..., 2] - bx[..., 0]
    bh = bx[..., 3] - bx[..., 1]
    return img, bx, classes, valid & (bw > 2.0) & (bh > 2.0)
