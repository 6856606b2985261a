"""Image operations of the request path, on tensors.

Layouts follow the JAX package: colour images are NHWC ``[..., H, W, 3]``
float in [0, 1]; grayscale images and masks are ``[..., H, W]``. Every
function works on any leading batch shape.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iqc_tpu_torch.ops.jit_utils import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(image: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]; float inputs pass through as float32."""
    if not image.is_floating_point():
        return image.to(torch.float32) / 255.0
    return image.to(torch.float32)


def normalize_imagenet(image: torch.Tensor) -> torch.Tensor:
    """(x - mean) * (1/std) per RGB channel, in the JAX package's order."""
    mean = device_constant(np.float32(IMAGENET_MEAN), image.device, image.dtype)
    inv_std = device_constant(np.float32([1.0 / s for s in IMAGENET_STD]), image.device,
                              image.dtype)
    return (image - mean) * inv_std


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma of [..., 3]."""
    return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]


def resize_bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to [..., h, w, C], antialiased on
    downscale (the triangle filter widened by the scale factor, half-pixel
    centres), as ``jax.image.resize(..., "bilinear")`` does."""
    lead = image.shape[:-3]
    h, w, c = image.shape[-3:]
    x = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, size[0], size[1], c)


# ---------------------------------------------------------------------------
# Filters on [..., H, W]
# ---------------------------------------------------------------------------


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(image: torch.Tensor, sigma: float = 1.0, radius: int = None) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] with edge-replicate padding:
    the row pass (along W) first, then the column pass."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, image.device)
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    x = image.reshape(-1, 1, h, w).to(torch.float32)
    x = F.pad(x, (radius, radius, radius, radius), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    return x.reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# Denoise and contrast preprocessing (plain PyTorch: no kernel in the JAX
# package either)
# ---------------------------------------------------------------------------


def bilateral_filter(image: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """Edge-preserving denoise of [..., H, W, C] (or [H, W]) float in [0,1]:
    the Gaussian range- and space-weighted mean over the d x d window.

    The window's shifted copies wrap around the borders (a roll), as the
    JAX package's filter does; cv2 reflects them instead. ``sigma_color``
    is on cv2's 8-bit scale. The taps accumulate over dy, then dx."""
    radius = d // 2
    sc = sigma_color / 255.0
    squeeze = image.dim() == 2
    x = image[..., None] if squeeze else image
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            w_s = torch.exp(torch.tensor(-0.5 * (dy * dy + dx * dx) / (sigma_space ** 2),
                                         dtype=torch.float32)).to(x.dtype).item()
            shifted = torch.roll(x, (dy, dx), dims=(-3, -2))
            diff = shifted - x
            w_r = torch.exp(-0.5 * torch.sum(diff * diff, dim=-1, keepdim=True) / (sc * sc))
            w = w_s * w_r
            num = num + w * shifted
            den = den + w
    y = num / den
    return y[..., 0] if squeeze else y


def clahe(gray: torch.Tensor, clip_limit: float = 3.0, grid: Tuple[int, int] = (8, 8),
          nbins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of each [H, W] image
    of [..., H, W] (float in [0,1]), every image with its own tiles.

    The image is edge-padded to a multiple of the grid; each tile's
    histogram is clipped at ``clip_limit`` times the mean bin and the excess
    spread evenly; the normalised CDFs are the tiles' lookup tables, and
    each pixel interpolates bilinearly between the four nearest tiles'."""
    lead = gray.shape[:-2]
    h, w = gray.shape[-2:]
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)
    x = gray.reshape(-1, h, w)
    n = x.shape[0]
    ph, pw = th * gh - h, tw * gw - w
    if ph or pw:
        x = F.pad(x[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
    bins = torch.clamp((x * (nbins - 1) + 0.5).to(torch.int32), 0, nbins - 1)
    tiles = bins.reshape(n, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(n * gh * gw, th * tw)
    # one histogram a tile: bins offset by tile * nbins into one count vector
    # (float32 counts are exact below 2^24; no host sync, so a CUDA graph
    # can hold it, which torch.bincount's size check forbids)
    offset = torch.arange(n * gh * gw, device=x.device)[:, None] * nbins
    idx = (tiles.long() + offset).reshape(-1)
    hist = torch.zeros(n * gh * gw * nbins, dtype=torch.float32, device=x.device)
    hist = hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    hist = hist.reshape(n * gh * gw, nbins)

    clip = max(clip_limit * (th * tw) / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / nbins
    cdf = torch.cumsum(hist, dim=1)
    cdf = cdf / cdf[:, -1:]
    luts = cdf.reshape(n, gh, gw, nbins)

    def centres(size, tile, count):
        pos = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) / tile - 0.5
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, count - 1)
        hi = torch.clamp(lo + 1, 0, count - 1)
        return lo, hi, torch.clamp(pos - lo, 0.0, 1.0)

    y0, y1, fy = centres(h, th, gh)
    x0, x1, fx = centres(w, tw, gw)
    fy, fx = fy[:, None], fx[None, :]
    b = bins[:, :h, :w].long()
    img = torch.arange(n, device=x.device)[:, None, None]

    def look(ty, tx):
        return luts[img, ty[None, :, None], tx[None, None, :], b]

    out = (look(y0, x0) * (1 - fy) * (1 - fx) + look(y0, x1) * (1 - fy) * fx
           + look(y1, x0) * fy * (1 - fx) + look(y1, x1) * fy * fx)
    return out.to(gray.dtype).reshape(*lead, h, w)


def enhance_contrast_rgb(image: torch.Tensor, clip_limit: float = 3.0) -> torch.Tensor:
    """CLAHE on the BT.601 luma of each RGB image of [..., H, W, 3], with
    the RGB values rescaled by the luma's change and clipped to [0,1]."""
    luma = rgb_to_gray(image)
    new_luma = clahe(luma, clip_limit=clip_limit)
    scale = (new_luma + 1e-6) / (luma + 1e-6)
    return torch.clamp(image * scale[..., None], 0.0, 1.0)


def otsu_threshold(x: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu threshold of each [H, W] image of [..., H, W] in [0,1] -> [...]."""
    lead = x.shape[:-2]
    flat = x.reshape(-1, x.shape[-2] * x.shape[-1])
    lo = flat.min(dim=1, keepdim=True).values
    hi = flat.max(dim=1, keepdim=True).values
    span = torch.clamp(hi - lo, min=1e-8)
    bins = torch.clamp(((flat - lo) / span * (nbins - 1)).to(torch.int32), 0, nbins - 1)
    hist = torch.zeros(flat.shape[0], nbins, dtype=torch.float32, device=x.device)
    hist.scatter_add_(1, bins.long(), torch.ones_like(flat))
    cdf = torch.cumsum(hist, dim=1)
    w0 = cdf
    w1 = w0[:, -1:] - w0
    centers = ((torch.arange(nbins, dtype=torch.float32, device=x.device) + 0.5)
               / nbins * span + lo)
    csum = torch.cumsum(hist * centers, dim=1)
    m0 = csum / torch.clamp(w0, min=1e-8)
    m1 = (csum[:, -1:] - csum) / torch.clamp(w1, min=1e-8)
    between = w0 * w1 * (m0 - m1) ** 2
    idx = torch.argmax(between, dim=1, keepdim=True)
    return torch.gather(centers, 1, idx).reshape(lead)


def box_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean of each pixel's (2 * radius + 1)^2 window of [..., H, W], over
    the window's pixels inside the image (zero padding, divided by the
    count of pixels inside)."""
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    x = image.reshape(-1, 1, h, w).to(torch.float32)
    y = F.avg_pool2d(x, 2 * radius + 1, stride=1, padding=radius, count_include_pad=False)
    return y.reshape(*lead, h, w)


def adaptive_local_mean(x: torch.Tensor, block_size: int, method: str = "gaussian"
                        ) -> torch.Tensor:
    """The local mean behind cv2's adaptive threshold: a gaussian blur (its
    sigma rule) or, with ``method="mean"``, a box blur."""
    radius = max(1, block_size // 2)
    if method == "gaussian":
        sigma = 0.3 * ((block_size - 1) * 0.5 - 1) + 0.8
        return gaussian_blur(x, sigma=sigma, radius=radius)
    return box_blur(x, radius)


def adaptive_threshold(x: torch.Tensor, block_size: int, c: float, invert: bool,
                       method: str = "gaussian") -> torch.Tensor:
    """cv2.adaptiveThreshold on a float [0,1] image [..., H, W]: x above its
    local mean less c/255 (below it with ``invert``, THRESH_BINARY_INV)."""
    thresh = adaptive_local_mean(x, block_size, method) - c / 255.0
    return (x < thresh) if invert else (x > thresh)


def _conv3x3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 cross-correlation of [..., H, W] with zero padding."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    y = F.conv2d(x.reshape(-1, 1, h, w).to(torch.float32), kernel.view(1, 1, 3, 3), padding=1)
    return y.reshape(*lead, h, w)


SOBEL_X = np.float32([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of [..., H, W] (zero padding)."""
    kx = device_constant(SOBEL_X, x.device)
    gx = _conv3x3(x, kx)
    gy = _conv3x3(x, device_constant(SOBEL_X.T, x.device))
    return torch.sqrt(gx * gx + gy * gy)


# ---------------------------------------------------------------------------
# Binary morphology on [..., H, W] bool (outside the image counts as empty)
# ---------------------------------------------------------------------------


def _diamond_step(mask: torch.Tensor, radius: int, dilate: bool) -> torch.Tensor:
    """Dilate or erode by the L1 ball of ``radius`` (radius 1 = the 5-point
    cross, radius 2 = the 13-point disk of radius 2)."""
    h, w = mask.shape[-2:]
    p = F.pad(mask.to(torch.uint8), (radius, radius, radius, radius)).bool()
    out = None
    for dy in range(-radius, radius + 1):
        for dx in range(-radius + abs(dy), radius - abs(dy) + 1):
            view = p[..., radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            if out is None:
                out = view.clone()
            elif dilate:
                out |= view
            else:
                out &= view
    return out


def binary_dilate(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    if radius > 2:
        raise ValueError("disk radii above 2 are not on the request path")
    return _diamond_step(mask.bool(), radius, dilate=True)


def binary_erode(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    if radius > 2:
        raise ValueError("disk radii above 2 are not on the request path")
    return _diamond_step(mask.bool(), radius, dilate=False)


def binary_open(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    return binary_dilate(binary_erode(mask, radius), radius)


def binary_close(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    return binary_erode(binary_dilate(mask, radius), radius)


def border_ring(h: int, w: int, device) -> torch.Tensor:
    """[h, w] bool, true on the outermost pixel ring."""
    ring = torch.zeros(h, w, dtype=torch.bool, device=device)
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = True
    return ring


def fill_holes(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Bounded hole fill: flood the background from each image's border ring
    for ``iterations`` cross steps; background not reached becomes mask."""
    inv = ~mask
    outside = border_ring(*mask.shape[-2:], mask.device) & inv
    for _ in range(iterations):
        outside = binary_dilate(outside, 1) & inv
    return ~outside


# ---------------------------------------------------------------------------
# Batched crop-and-resize
# ---------------------------------------------------------------------------


def _interp_matrix(samples: torch.Tensor, size: int) -> torch.Tensor:
    """[..., out] fractional positions -> [..., out, size] bilinear weights
    (a hat function, at most two nonzeros per row; clamped to the image)."""
    grid = torch.arange(size, dtype=torch.float32, device=samples.device)
    s = torch.clamp(samples, 0.0, size - 1.0)[..., None]
    return torch.clamp(1.0 - torch.abs(s - grid), min=0.0)


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor,
                    out_size: Tuple[int, int],
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bilinear crops of ``boxes`` [B,N,4] (x1,y1,x2,y2 pixels) from
    ``images`` [B,H,W,C] -> [B,N,oh,ow,C] float32. Half-pixel sample grid
    over each box (width and height at least 1 px); samples outside the image
    clamp to its edge.

    ``compute_dtype=torch.bfloat16`` rounds the image, the interpolation
    weights and the row pass to bfloat16 and accumulates both passes in
    float32: the products of bfloat16 operands are exact in float32, so the
    float32 contractions of the rounded operands (TF32 off) are the
    bfloat16-operand, float32-accumulate products."""
    h, w = images.shape[1], images.shape[2]
    oh, ow = out_size
    boxes = boxes.to(torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    gy = torch.arange(oh, dtype=torch.float32, device=images.device) + 0.5
    gx = torch.arange(ow, dtype=torch.float32, device=images.device) + 0.5
    ys = y1[..., None] + gy * bh[..., None] / oh - 0.5
    xs = x1[..., None] + gx * bw[..., None] / ow - 0.5
    rnd = lambda t: t.to(compute_dtype).to(torch.float32)
    wy = rnd(_interp_matrix(ys, h))  # [B,N,oh,H]
    wx = rnd(_interp_matrix(xs, w))  # [B,N,ow,W]
    img = rnd(images.to(torch.float32))
    rows = torch.einsum("bnoh,bhwc->bnowc", wy, img)
    return torch.einsum("bnpw,bnowc->bnopc", wx, rnd(rows))
