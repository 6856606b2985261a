"""Train-time augmentation on the device: the JAX package's
``data/augmentation.py``.

``augment_image_and_boxes`` is the general chain on a batch of float [0,1]
images [B,H,W,3] with optional xyxy boxes [B,M,4]: geometric stages that
move the boxes with the pixels (flips, rot90, a rotate-scale-translate-shear
affine, elastic), photometric ones (brightness, contrast, gamma, saturation,
hue, grayscale), noise and blur (gaussian noise, gaussian and motion blur),
and weather, occlusion and surface stages (shadow, fog, cutout, edge
enhancement, spot light, texture grain). ``classifier_augment_config`` maps
the classifier trainer's ``augmentation.train`` block onto it;
``DEFECT_AUGMENT_CONFIGS`` and ``QualityControlAugmenter`` give the
per-defect pipelines and the augmentation analytics.

``yolo_train_augment_batch`` applies, after mosaic, the Ultralytics
hyperparameters the YOLO training profile carries (``YoloAugHyp``):
horizontal and vertical flips, a random affine (rotation, scale,
translation, shear) that moves the boxes with the pixels, then HSV (a hue
rotation about the achromatic axis, saturation and value gains). Boxes that
the affine leaves narrower or lower than 2 px lose their validity.

As in ``ops/mosaic.py``, the random choices are drawn first, on the CPU from
an explicit ``torch.Generator`` (``draw_augment``, ``draw_yolo_augment``),
and the transform applied on the device from them, batched over the images
(the JAX package maps a per-image function over the batch). Image-sized
gaussian noise is drawn on the images' device from a generator seeded by
the CPU one. With rotation and shear at 0 the affine is separable: two
bilinear matrix products with bfloat16-rounded operands and float32 sums;
otherwise it samples the image bilinearly through the inverse map
(edge-clamped).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.ops.image import gaussian_blur, rgb_to_gray, to_float
from iqc_tpu_torch.ops.mosaic import _bf16, upload


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probabilities and ranges of every stage (the JAX package's defaults)."""

    p_hflip: float = 0.5
    p_vflip: float = 0.2
    p_rot90: float = 0.3
    p_affine: float = 0.5
    max_rotate_deg: float = 15.0
    max_scale: float = 0.1
    max_translate: float = 0.0625
    max_shear_deg: float = 0.0
    p_brightness: float = 0.5
    brightness_range: float = 0.2
    p_contrast: float = 0.5
    contrast_range: float = 0.2
    p_gamma: float = 0.2
    p_saturation: float = 0.3
    saturation_range: float = 0.3
    p_hue: float = 0.0
    hue_range: float = 0.1       # fraction of the hue wheel
    p_grayscale: float = 0.0
    p_noise: float = 0.3
    noise_sigma: float = 0.05
    p_blur: float = 0.2
    p_motion_blur: float = 0.1
    p_shadow: float = 0.2
    p_fog: float = 0.1
    p_cutout: float = 0.2
    cutout_frac: float = 0.2
    p_elastic: float = 0.1
    elastic_alpha: float = 8.0
    p_edge_enhance: float = 0.0
    p_texture: float = 0.0
    p_spot: float = 0.0


# the non-geometric stages, all off: the YOLO chain's geometry
_NO_PHOTOMETRIC = dict(p_rot90=0.0, p_brightness=0.0, p_contrast=0.0, p_gamma=0.0,
                       p_saturation=0.0, p_noise=0.0, p_blur=0.0, p_motion_blur=0.0,
                       p_shadow=0.0, p_fog=0.0, p_cutout=0.0, p_elastic=0.0)


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
            max_translate=self.translate, max_shear_deg=self.shear, **_NO_PHOTOMETRIC)


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


def _affine(img: torch.Tensor, bx: Optional[torch.Tensor], d: Dict[str, torch.Tensor],
            geo: AugmentConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The rotate-scale-translate-shear affine of each image where
    ``d["affine"]`` is set (the identity elsewhere), and the boxes' enclosing
    boxes of their forward-mapped corners, clipped to the frame."""
    b, h, w = img.shape[:3]
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
    if bx is None:
        return img, None
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
    return img, bx


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
        d.update(_draw_affine(gen, batch, height, width, geo))
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
    d = {k: upload(v, images.device) for k, v in draws.items()}
    # the flips and the affine: the general chain with only those stages on
    img, bx = augment_image_and_boxes(images, boxes, d, hyp.geometry())
    if hyp.hsv_h > 0:
        img = hue_rotate(img, d["hue"])
    if hyp.hsv_s > 0:
        img = saturate(img, d["sat"])
    if hyp.hsv_v > 0:
        img = torch.clamp(img * d["val"][:, None, None, None], 0.0, 1.0)
    bw = bx[..., 2] - bx[..., 0]
    bh = bx[..., 3] - bx[..., 1]
    return img, bx, classes, valid & (bw > 2.0) & (bh > 2.0)


# -- the general chain -------------------------------------------------------------


def _draw_affine(gen: torch.Generator, batch: int, height: int, width: int,
                 geo: AugmentConfig) -> Dict[str, torch.Tensor]:
    """The affine's gate and parameters, identity where the gate is off."""
    on = torch.rand((batch,), generator=gen) < geo.p_affine
    deg, sc, tr, sh = geo.max_rotate_deg, geo.max_scale, geo.max_translate, geo.max_shear_deg
    ang = _uniform(gen, batch, -deg, deg) * math.pi / 180.0
    scale = 1.0 + _uniform(gen, batch, -sc, sc)
    tx = _uniform(gen, batch, -tr, tr) * width
    ty = _uniform(gen, batch, -tr, tr) * height
    shx = torch.tan(_uniform(gen, batch, -sh, sh) * math.pi / 180.0)
    shy = torch.tan(_uniform(gen, batch, -sh, sh) * math.pi / 180.0)
    zeros, ones = torch.zeros(batch), torch.ones(batch)
    return dict(affine=on, angle=torch.where(on, ang, zeros), scale=torch.where(on, scale, ones),
                tx=torch.where(on, tx, zeros), ty=torch.where(on, ty, zeros),
                shx=torch.where(on, shx, zeros), shy=torch.where(on, shy, zeros))


def draw_augment(gen: torch.Generator, batch: int, height: int, width: int,
                 cfg: AugmentConfig, device="cpu") -> Dict[str, torch.Tensor]:
    """The random choices of ``augment_image_and_boxes`` for one batch. Per
    image, for each stage whose probability is above 0: its gate (bool
    [B], named as the stage) and its values, where it has any: the affine's
    ``angle`` (radians), ``scale``, ``tx``/``ty`` (pixels) and ``shx``/
    ``shy`` (shear tangents), identity where its gate is off; the elastic
    displacement fields ``elastic_dy``/``elastic_dx`` (standard normal on an
    [H/8,W/8] grid); ``brightness`` (an offset, 0 where off), ``contrast``
    (a factor, 1 where off), ``gamma_value``, ``saturation_value``,
    ``hue_value`` (a fraction of the wheel); ``noise_value`` (standard normal
    [B,H,W,3], drawn on ``device``); ``motion_theta``; ``shadow_theta``,
    ``shadow_offset``, ``shadow_strength``; ``fog_field`` (uniform
    [H/16,W/16]) and ``fog_density``; ``cutout_y``/``cutout_x`` (the hole's
    corner); ``spot_y``, ``spot_x``, ``spot_gain``; ``texture_field``
    (standard normal [H/4,W/4]). Everything but the noise is drawn on the
    CPU from ``gen``; the noise from a generator on ``device`` seeded from
    it."""
    b, h, w = batch, height, width
    d: Dict[str, torch.Tensor] = {}

    def gate(name: str, p: float) -> bool:
        if p > 0:
            d[name] = torch.rand((b,), generator=gen) < p
        return p > 0

    gate("hflip", cfg.p_hflip)
    gate("vflip", cfg.p_vflip)
    if h == w:
        gate("rot90", cfg.p_rot90)
    if cfg.p_affine > 0:
        d.update(_draw_affine(gen, b, h, w, cfg))
    if gate("elastic", cfg.p_elastic):
        coarse = (b, max(h // 8, 1), max(w // 8, 1))
        d["elastic_dy"] = torch.randn(coarse, generator=gen)
        d["elastic_dx"] = torch.randn(coarse, generator=gen)
    if gate("brightness_on", cfg.p_brightness):
        r = cfg.brightness_range
        d["brightness"] = torch.where(d.pop("brightness_on"), _uniform(gen, b, -r, r),
                                      torch.zeros(b))
    if gate("contrast_on", cfg.p_contrast):
        r = cfg.contrast_range
        d["contrast"] = torch.where(d.pop("contrast_on"), 1.0 + _uniform(gen, b, -r, r),
                                    torch.ones(b))
    if gate("gamma", cfg.p_gamma):
        d["gamma_value"] = torch.exp(_uniform(gen, b, -0.3, 0.3))
    if gate("saturation", cfg.p_saturation):
        r = cfg.saturation_range
        d["saturation_value"] = 1.0 + _uniform(gen, b, -r, r)
    if gate("hue", cfg.p_hue):
        d["hue_value"] = _uniform(gen, b, -cfg.hue_range, cfg.hue_range)
    gate("grayscale", cfg.p_grayscale)
    if gate("noise", cfg.p_noise):
        seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        dg = torch.Generator(device=torch.device(device)).manual_seed(seed)
        d["noise_value"] = torch.randn((b, h, w, 3), generator=dg, device=torch.device(device))
    gate("blur", cfg.p_blur)
    if gate("motion_blur", cfg.p_motion_blur):
        d["motion_theta"] = _uniform(gen, b, 0.0, math.pi)
    if gate("shadow", cfg.p_shadow):
        d["shadow_theta"] = _uniform(gen, b, 0.0, 2 * math.pi)
        d["shadow_offset"] = _uniform(gen, b, -0.25, 0.25)
        d["shadow_strength"] = _uniform(gen, b, 0.3, 0.6)
    if gate("fog", cfg.p_fog):
        d["fog_field"] = torch.rand((b, max(h // 16, 1), max(w // 16, 1)), generator=gen)
        d["fog_density"] = _uniform(gen, b, 0.2, 0.45)
    if gate("cutout", cfg.p_cutout):
        ch, cw = max(int(h * cfg.cutout_frac), 1), max(int(w * cfg.cutout_frac), 1)
        d["cutout_y"] = torch.randint(0, h - ch + 1, (b,), generator=gen)
        d["cutout_x"] = torch.randint(0, w - cw + 1, (b,), generator=gen)
    gate("edge_enhance", cfg.p_edge_enhance)
    if gate("spot", cfg.p_spot):
        d["spot_y"] = _uniform(gen, b, 0.2, 0.8)
        d["spot_x"] = _uniform(gen, b, 0.2, 0.8)
        d["spot_gain"] = _uniform(gen, b, 0.15, 0.4)
    if gate("texture", cfg.p_texture):
        d["texture_field"] = torch.randn((b, max(h // 4, 1), max(w // 4, 1)), generator=gen)
    return d


def _upsample(field: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B,h',w'] -> [B,h,w] bilinear with half-pixel centres, edges clamped
    (``jax.image.resize(..., "bilinear")`` on an upscale)."""
    return F.interpolate(field[:, None], size=(h, w), mode="bilinear",
                         align_corners=False)[:, 0]


def _color_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of each channel of [B,H,W,3]."""
    return gaussian_blur(img.permute(0, 3, 1, 2), sigma).permute(0, 2, 3, 1)


def _where(on: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(on.view(-1, *([1] * (a.dim() - 1))), a, b)


def _motion_blur(img: torch.Tensor, theta: torch.Tensor, length: int = 7) -> torch.Tensor:
    """The mean of ``length`` copies of each image rolled (wrapping) by
    round(t * sin(theta)) rows and round(t * cos(theta)) columns, t from
    -length//2 on."""
    b, h, w = img.shape[:3]
    dev = img.device
    dy, dx = torch.sin(theta), torch.cos(theta)
    bi = torch.arange(b, device=dev)[:, None, None]
    ys = torch.arange(h, device=dev)[None, :]
    xs = torch.arange(w, device=dev)[None, :]
    acc = torch.zeros_like(img)
    for i in range(length):
        t = i - length // 2
        sy = torch.round(t * dy).long()[:, None]
        sx = torch.round(t * dx).long()[:, None]
        rows = torch.remainder(ys - sy, h)[:, :, None]
        cols = torch.remainder(xs - sx, w)[:, None, :]
        acc = acc + img[bi, rows, cols]
    return acc / length


def _grid(lo: float, hi: float, h: int, w: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    yy, xx = torch.meshgrid(torch.linspace(lo, hi, h, device=dev),
                            torch.linspace(lo, hi, w, device=dev), indexing="ij")
    return yy[None], xx[None]


def augment_image_and_boxes(images: torch.Tensor, boxes: Optional[torch.Tensor],
                            draws: Dict[str, torch.Tensor], cfg: AugmentConfig
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The whole chain on float [0,1] images [B,H,W,3] from ``draws``
    (``draw_augment``), in the JAX package's order. ``boxes`` [B,M,4] xyxy
    pixels, or None: the geometric stages move them; the others leave them
    as they are."""
    dev = images.device
    d = {k: upload(v, dev) for k, v in draws.items()}
    b, h, w = images.shape[:3]
    img, bx = images, boxes
    e = lambda v: v[:, None, None, None]

    # geometric
    if cfg.p_hflip > 0:
        img = _where(d["hflip"], img.flip(2), img)
        if bx is not None:
            fl = torch.stack([w - bx[..., 2], bx[..., 1], w - bx[..., 0], bx[..., 3]], -1)
            bx = _where(d["hflip"], fl, bx)
    if cfg.p_vflip > 0:
        img = _where(d["vflip"], img.flip(1), img)
        if bx is not None:
            fl = torch.stack([bx[..., 0], h - bx[..., 3], bx[..., 2], h - bx[..., 1]], -1)
            bx = _where(d["vflip"], fl, bx)
    if h == w and cfg.p_rot90 > 0:
        img = _where(d["rot90"], torch.rot90(img, 1, dims=(1, 2)), img)
        if bx is not None:
            rot = torch.stack([bx[..., 1], w - bx[..., 2], bx[..., 3], w - bx[..., 0]], -1)
            bx = _where(d["rot90"], rot, bx)
    if cfg.p_affine > 0:
        img, bx = _affine(img, bx, d, cfg)
    if cfg.p_elastic > 0:
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        dy = _upsample(d["elastic_dy"], h, w) * cfg.elastic_alpha
        dx = _upsample(d["elastic_dx"], h, w) * cfg.elastic_alpha
        img = _where(d["elastic"], _bilinear_gather(img, yy + dy, xx + dx), img)

    # photometric
    if cfg.p_brightness > 0:
        img = torch.clamp(img + e(d["brightness"]), 0, 1)
    if cfg.p_contrast > 0:
        img = torch.clamp((img - 0.5) * e(d["contrast"]) + 0.5, 0, 1)
    if cfg.p_gamma > 0:
        img = _where(d["gamma"], torch.pow(torch.clamp(img, 1e-6, 1), e(d["gamma_value"])), img)
    if cfg.p_saturation > 0:
        img = _where(d["saturation"], saturate(img, d["saturation_value"]), img)
    if cfg.p_hue > 0:
        img = _where(d["hue"], hue_rotate(img, d["hue_value"]), img)
    if cfg.p_grayscale > 0:
        img = _where(d["grayscale"], rgb_to_gray(img)[..., None].expand_as(img), img)

    # noise and blur
    if cfg.p_noise > 0:
        noise = d["noise_value"] * cfg.noise_sigma
        img = torch.clamp(img + _where(d["noise"], noise, torch.zeros_like(noise)), 0, 1)
    if cfg.p_blur > 0:
        img = _where(d["blur"], _color_blur(img, 1.2), img)
    if cfg.p_motion_blur > 0:
        img = _where(d["motion_blur"], _motion_blur(img, d["motion_theta"]), img)

    # weather, occlusion and surface
    if cfg.p_shadow > 0:
        yy, xx = _grid(-0.5, 0.5, h, w, dev)
        th = d["shadow_theta"][:, None, None]
        dist = xx * torch.cos(th) + yy * torch.sin(th) - d["shadow_offset"][:, None, None]
        shade = 1.0 - d["shadow_strength"][:, None, None] * torch.sigmoid(dist * 12.0)
        img = _where(d["shadow"], img * shade[..., None], img)
    if cfg.p_fog > 0:
        alpha = (_upsample(d["fog_field"], h, w) * d["fog_density"][:, None, None])[..., None]
        img = _where(d["fog"], img * (1 - alpha) + alpha, img)
    if cfg.p_cutout > 0:
        ch, cw = max(int(h * cfg.cutout_frac), 1), max(int(w * cfg.cutout_frac), 1)
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        cy, cx = d["cutout_y"][:, None, None], d["cutout_x"][:, None, None]
        hole = (ys >= cy) & (ys < cy + ch) & (xs >= cx) & (xs < cx + cw)
        cut = torch.where(hole[..., None], torch.zeros((), device=dev), img)
        img = _where(d["cutout"], cut, img)
    if cfg.p_edge_enhance > 0:
        sharp = torch.clamp(img + 0.5 * (img - _color_blur(img, 1.0)), 0.0, 1.0)
        img = _where(d["edge_enhance"], sharp, img)
    if cfg.p_spot > 0:
        yy, xx = _grid(0.0, 1.0, h, w, dev)
        r2 = (yy - d["spot_y"][:, None, None]) ** 2 + (xx - d["spot_x"][:, None, None]) ** 2
        light = 1.0 + d["spot_gain"][:, None, None] * torch.exp(-r2 / 0.05)
        img = _where(d["spot"], torch.clamp(img * light[..., None], 0.0, 1.0), img)
    if cfg.p_texture > 0:
        grain = _upsample(d["texture_field"], h, w)
        img = _where(d["texture"], torch.clamp(img * (1.0 + 0.05 * grain[..., None]), 0.0, 1.0),
                     img)
    return img, bx


def yolo_train_augment(image: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                       draws: Dict[str, torch.Tensor], hyp: YoloAugHyp
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One image's YOLO augmentation: image [H,W,3] float [0,1], boxes
    [M,4], valid [M], and ``draws`` of a batch of one (``draw_yolo_augment``)
    -> the image, boxes and validity after it."""
    img, bx, _, vl = yolo_train_augment_batch(image[None], boxes[None],
                                              torch.zeros_like(valid, dtype=torch.int32)[None],
                                              valid[None], draws, hyp)
    return img[0], bx[0], vl[0]


def classifier_augment_config(train_aug: Optional[Dict]) -> Optional[AugmentConfig]:
    """The classifier trainer's ``augmentation.train`` block
    (``config/resnet_config.yaml``: random_resize_crop, flips,
    random_rotation, color_jitter, random_grayscale, random_erasing,
    gaussian_blur) as an ``AugmentConfig``; None or empty gives None (no
    augmentation).

    RandomResizedCrop(scale=[lo,1]) becomes a centre zoom of up to
    1/sqrt(lo) with a translate jitter of 5%; RandomErasing's area-scale
    range becomes the cutout side fraction at the mean area."""
    if not train_aug:
        return None
    a = dict(train_aug)
    kw: Dict[str, float] = dict(
        p_hflip=0.0, p_vflip=0.0, p_rot90=0.0, p_affine=0.0,
        p_brightness=0.0, p_contrast=0.0, p_gamma=0.0, p_saturation=0.0,
        p_noise=0.0, p_blur=0.0, p_motion_blur=0.0, p_shadow=0.0,
        p_fog=0.0, p_cutout=0.0, p_elastic=0.0,
    )
    kw["p_hflip"] = float((a.get("random_horizontal_flip") or {}).get("probability", 0.0))
    kw["p_vflip"] = float((a.get("random_vertical_flip") or {}).get("probability", 0.0))
    degrees = float((a.get("random_rotation") or {}).get("degrees", 0.0))
    rrc = a.get("random_resize_crop") or {}
    zoom = 0.0
    if rrc:
        lo = float((rrc.get("scale") or [0.8, 1.0])[0])
        zoom = max(1.0 / max(lo, 1e-3) ** 0.5 - 1.0, 0.0)
    if degrees or zoom:
        kw["p_affine"] = 1.0
        kw["max_rotate_deg"] = degrees
        kw["max_scale"] = zoom
        kw["max_translate"] = 0.05 if rrc else 0.0
    cj = a.get("color_jitter") or {}
    for key, p_name, r_name in (("brightness", "p_brightness", "brightness_range"),
                                ("contrast", "p_contrast", "contrast_range"),
                                ("saturation", "p_saturation", "saturation_range"),
                                ("hue", "p_hue", "hue_range")):
        if cj.get(key):
            kw[p_name] = 1.0
            kw[r_name] = float(cj[key])
    kw["p_grayscale"] = float((a.get("random_grayscale") or {}).get("probability", 0.0))
    re = a.get("random_erasing") or {}
    if re.get("enabled"):
        kw["p_cutout"] = float(re.get("probability", 0.25))
        scale = re.get("scale") or [0.02, 0.33]
        mean_area = (float(scale[0]) + float(scale[1])) / 2.0
        kw["cutout_frac"] = max(mean_area ** 0.5, 0.05)
    gb = a.get("gaussian_blur") or {}
    if gb.get("enabled"):
        kw["p_blur"] = float(gb.get("probability", 0.1))
    return AugmentConfig(**kw)


# per-defect-class pipelines
DEFECT_AUGMENT_CONFIGS: Dict[str, AugmentConfig] = {
    "crack": AugmentConfig(p_elastic=0.3, p_contrast=0.7, max_rotate_deg=25.0,
                           p_edge_enhance=0.3),
    "scratch": AugmentConfig(p_affine=0.7, max_rotate_deg=30.0, p_motion_blur=0.25,
                             p_edge_enhance=0.2),
    "dent": AugmentConfig(p_shadow=0.4, p_spot=0.3, p_contrast=0.6),
    "discoloration": AugmentConfig(p_saturation=0.7, p_gamma=0.4, p_brightness=0.7),
    "contamination": AugmentConfig(p_texture=0.4, p_noise=0.5, p_fog=0.2),
}


def _to_uint8(x: torch.Tensor) -> np.ndarray:
    return torch.clamp(x * 255, 0, 255).cpu().numpy().astype(np.uint8)


class QualityControlAugmenter:
    """Augmentation of single images, annotated images and batches with one
    ``AugmentConfig`` on one device (the card unless ``device="cpu"``), and
    the augmentation analytics. ``seed`` seeds each call's draws."""

    def __init__(self, config: Optional[AugmentConfig] = None, device="cuda"):
        self.config = config or AugmentConfig()
        self.device = torch.device(device)

    def _augment(self, images: torch.Tensor, boxes: Optional[torch.Tensor], seed: int):
        b, h, w = images.shape[:3]
        draws = draw_augment(torch.Generator().manual_seed(int(seed)), b, h, w, self.config,
                             self.device)
        return augment_image_and_boxes(images, boxes, draws, self.config)

    def _float(self, images) -> torch.Tensor:
        return to_float(torch.as_tensor(np.ascontiguousarray(images)).to(self.device))

    def augment_image(self, image: np.ndarray, seed: int = 0) -> np.ndarray:
        """One [H,W,3] image (uint8, or float in [0,1]) -> augmented uint8."""
        return _to_uint8(self._augment(self._float(image)[None], None, seed)[0][0])

    def augment_with_annotations(self, image: np.ndarray, bboxes: Sequence[Sequence[float]],
                                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """One image and its xyxy pixel boxes -> augmented uint8 image and
        the boxes moved with it."""
        b = torch.as_tensor(np.asarray(bboxes, np.float32).reshape(-1, 4)).to(self.device)
        out, nb = self._augment(self._float(image)[None], b[None], seed)
        return _to_uint8(out[0]), nb[0].cpu().numpy()

    def augment_batch(self, images: np.ndarray, n_augmentations: int = 1,
                      seed: int = 0) -> np.ndarray:
        """[B,H,W,3] -> [N*B,H,W,3] uint8: ``n_augmentations`` augmented
        copies of the batch, copy i drawn from ``seed + i``."""
        imgs = self._float(images)
        outs = [self._augment(imgs, None, seed + i)[0] for i in range(n_augmentations)]
        return _to_uint8(torch.cat(outs, 0))

    @staticmethod
    def create_defect_specific_augmentations(defect_class: str,
                                             device="cuda") -> "QualityControlAugmenter":
        """The augmenter of one defect class's pipeline (the defaults for a
        class without one)."""
        return QualityControlAugmenter(DEFECT_AUGMENT_CONFIGS.get(defect_class, AugmentConfig()),
                                       device)

    # -- analytics -------------------------------------------------------------------

    @staticmethod
    def _histogram(img: np.ndarray, bins: int = 32) -> np.ndarray:
        h, _ = np.histogram(img.reshape(-1), bins=bins, range=(0, 255))
        h = h.astype(np.float64)
        return h / max(h.sum(), 1)

    @classmethod
    def bhattacharyya_distance(cls, a: np.ndarray, b: np.ndarray) -> float:
        bc = float(np.sum(np.sqrt(cls._histogram(a) * cls._histogram(b))))
        return float(-np.log(max(bc, 1e-12)))

    @classmethod
    def effectiveness(cls, original: np.ndarray, variants: Sequence[np.ndarray]) -> Dict:
        """Diversity of ``variants`` (mean pairwise Bhattacharyya histogram
        distance), their mean distance from ``original``, and a robustness
        estimate of 0.1 + diversity / 2, capped at 0.23."""
        n = len(variants)
        dists = [cls.bhattacharyya_distance(variants[i], variants[j])
                 for i in range(n) for j in range(i + 1, n)]
        orig_dists = [cls.bhattacharyya_distance(original, v) for v in variants]
        diversity = float(np.mean(dists)) if dists else 0.0
        return {
            "n_samples": n,
            "pairwise_diversity": diversity,
            "mean_distance_from_original": float(np.mean(orig_dists)),
            "estimated_robustness_improvement": min(0.23, 0.1 + diversity * 0.5),
        }

    def analyze_augmentation_effectiveness(self, original: np.ndarray, n_samples: int = 8,
                                           seed: int = 0) -> Dict:
        """``effectiveness`` of ``n_samples`` augmentations of ``original``
        (seeds ``seed`` on)."""
        return self.effectiveness(
            original, [self.augment_image(original, seed=seed + i) for i in range(n_samples)])

    def visualize_augmentations(self, image: np.ndarray, n: int = 4, seed: int = 0) -> np.ndarray:
        """The image and ``n`` augmentations of it side by side."""
        variants = [image] + [self.augment_image(image, seed=seed + i) for i in range(n)]
        return np.concatenate(variants, axis=1)
