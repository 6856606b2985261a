"""Device mosaic and mixup for detection training.

Each output sample is a 4-image collage: quadrant q of the output, split at a
random centre (cx, cy) in [0.3 S, 0.7 S), holds source q squeezed into it by a
separable bilinear resample, two matrix products ``Wy @ src @ Wx^T`` whose
operands are rounded to bfloat16 and whose sums are float32 (the JAX
package's ``ops/mosaic.py`` computes them so); quadrant masks pick which
resample feeds each output pixel. Boxes follow their quadrant's scale and
offset; the valid ones move to the front, the first M kept.

Every function is split in two. ``draw_*`` takes the random choices (source
picks, centres, gates, mixup permutation and Beta(32, 32) weights) on the
CPU, from an explicit ``torch.Generator`` (and a ``numpy.random.Generator``
for the Beta draws, which no PyTorch sampler takes a generator for), and
returns them as tensors; the apply functions are deterministic and run on
the device of the images. The card and the CPU therefore train on the same
batches for the same seed.

Two pick modes: ``mosaic_batch`` takes companions from the current batch;
``mosaic_from_corpus`` from the whole device-resident dataset.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and held in float32: products of two such
    values are exact in float32, so a float32 product of them sums as a
    bfloat16 product with float32 accumulation does."""
    return x.to(torch.bfloat16).to(torch.float32)


def upload(x: torch.Tensor, device) -> torch.Tensor:
    """A CPU draw on ``device``. To the card through pinned memory without
    waiting (a copy from pageable memory would wait for the card's queue
    to drain, once per draw)."""
    device = torch.device(device)
    if device.type != "cuda" or x.device == device:
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _interp_matrix(out_start: torch.Tensor, out_end: torch.Tensor, size: int,
                   antialias: bool = False) -> torch.Tensor:
    """[..., size, size] bilinear resample matrices: output rows in
    [out_start, out_end) sample a [0, size) source squeezed into that span
    (``out_start``/``out_end``: [...] float32). Rows outside the span hold
    garbage; callers mask them. ``antialias`` widens the triangle by the
    downscale factor."""
    dev = out_start.device
    i = torch.arange(size, dtype=torch.float32, device=dev)[:, None]  # output row
    j = torch.arange(size, dtype=torch.float32, device=dev)[None, :]  # source row
    start = out_start.to(torch.float32)[..., None, None]
    span = torch.clamp(out_end.to(torch.float32)[..., None, None] - start, min=1.0)
    u = (i - start + 0.5) * size / span - 0.5
    d = torch.abs(u - j)
    if antialias:
        d = d / torch.clamp(size / span, min=1.0)
    w = torch.clamp(1.0 - d, min=0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def _mosaic(srcs: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
            valid: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
            antialias: bool = False) -> Batch:
    """Collages of a batch: srcs [B,4,S,S,3] float, boxes [B,4,M,4] xyxy in
    the source's pixels, classes/valid [B,4,M], centres cx/cy [B] ->
    images [B,S,S,3] float32, boxes [B,M,4], classes [B,M], valid [B,M]."""
    b, _, s = srcs.shape[:3]
    m = boxes.shape[2]
    dev = srcs.device
    zero = torch.zeros_like(cx)
    full = torch.full_like(cx, float(s))
    rects = ((zero, zero, cx, cy), (cx, zero, full, cy),
             (zero, cy, cx, full), (cx, cy, full, full))
    yy = torch.arange(s, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(s, dtype=torch.float32, device=dev)[None, :]

    out = torch.zeros((b, s, s, 3), dtype=torch.float32, device=dev)
    out_boxes = []
    for q, (x0, y0, x1, y1) in enumerate(rects):
        wy = _bf16(_interp_matrix(y0, y1, s, antialias))            # [B,S,S]
        wx = _bf16(_interp_matrix(x0, x1, s, antialias))
        src = _bf16(srcs[:, q].to(torch.float32)).reshape(b, s, s * 3)
        rows = _bf16(torch.bmm(wy, src).reshape(b, s, s, 3))       # [B,i,k,c]
        resized = torch.einsum("bikc,blk->bilc", rows, wx)
        mask = ((yy >= y0[:, None, None]) & (yy < y1[:, None, None])
                & (xx >= x0[:, None, None]) & (xx < x1[:, None, None]))
        out = torch.where(mask[..., None], resized, out)

        sx = ((x1 - x0) * (1.0 / s))[:, None]
        sy = ((y1 - y0) * (1.0 / s))[:, None]
        bq = boxes[:, q].to(torch.float32)
        out_boxes.append(torch.stack([bq[..., 0] * sx + x0[:, None], bq[..., 1] * sy + y0[:, None],
                                      bq[..., 2] * sx + x0[:, None], bq[..., 3] * sy + y0[:, None]],
                                     dim=-1))
    cand_boxes = torch.cat(out_boxes, dim=1)                        # [B,4M,4]
    cand_classes = classes.reshape(b, 4 * m)
    cand_valid = valid.reshape(b, 4 * m)
    # valid candidates to the front in order, the first M kept
    order = torch.sort((~cand_valid).to(torch.uint8), dim=1, stable=True).indices[:, :m]
    return (out, torch.gather(cand_boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(cand_classes, 1, order), torch.gather(cand_valid, 1, order))


def _mosaic_one(srcs, boxes, classes, valid, cx, cy, antialias: bool = False) -> Batch:
    """One collage: srcs [4,S,S,3], boxes [4,M,4], classes/valid [4,M],
    scalar centres."""
    out = _mosaic(srcs[None], boxes[None], classes[None], valid[None],
                  torch.as_tensor(cx, dtype=torch.float32, device=srcs.device).reshape(1),
                  torch.as_tensor(cy, dtype=torch.float32, device=srcs.device).reshape(1),
                  antialias)
    return tuple(t[0] for t in out)


def _select(take: Optional[torch.Tensor], new: Batch, old: Batch) -> Batch:
    if take is None:
        return new
    t = upload(take, new[0].device)
    return (torch.where(t[:, None, None, None], new[0], old[0]),
            torch.where(t[:, None, None], new[1], old[1]),
            torch.where(t[:, None], new[2], old[2]),
            torch.where(t[:, None], new[3], old[3]))


def draw_mosaic(gen: torch.Generator, batch: int, size: int, n_sources: int,
                prob: float = 1.0) -> Dict[str, Optional[torch.Tensor]]:
    """The random choices of one mosaic call, on the CPU: ``picks`` [B,3]
    companion indices in [0, n_sources), ``centers`` [B,2] (cx, cy) in
    [0.3 S, 0.7 S), and ``take`` [B] bool (each sample a collage with
    probability ``prob``; None at prob >= 1)."""
    picks = torch.randint(0, n_sources, (batch, 3), generator=gen)
    u = torch.rand((batch, 2), generator=gen, dtype=torch.float32)
    lo, hi = 0.3 * size, 0.7 * size
    centers = u * (hi - lo) + lo
    take = None if prob >= 1.0 else torch.rand((batch,), generator=gen) < prob
    return {"picks": picks, "centers": centers, "take": take}


def mosaic_batch(images: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
                 valid: torch.Tensor, draws: Dict[str, Optional[torch.Tensor]],
                 antialias: bool = False) -> Batch:
    """In-batch mosaic: sample i collages itself (top-left) with batch
    samples ``draws["picks"][i]`` (``draw_mosaic`` with n_sources = B).
    Returns float32 images, boxes, classes and valid."""
    b = images.shape[0]
    dev = images.device
    imgs_f = images.to(torch.float32)
    picks = upload(torch.cat([torch.arange(b)[:, None], draws["picks"]], dim=1), dev)  # [B,4]
    centers = upload(draws["centers"], dev)
    new = _mosaic(imgs_f[picks], boxes[picks].to(torch.float32), classes[picks], valid[picks],
                  centers[:, 0], centers[:, 1], antialias)
    return _select(draws["take"], new, (imgs_f, boxes.to(torch.float32), classes, valid))


def mosaic_from_corpus(corpus_images: torch.Tensor, corpus_boxes: torch.Tensor,
                       corpus_classes: torch.Tensor, corpus_valid: torch.Tensor,
                       anchor_idx: torch.Tensor, draws: Dict[str, Optional[torch.Tensor]],
                       antialias: bool = False) -> Batch:
    """Mosaic whose 3 companions come from the whole corpus [N,...] on the
    device (``draw_mosaic`` with n_sources = N); sample i is anchored at
    corpus index ``anchor_idx[i]``. Images stay in the corpus's scale."""
    dev = corpus_images.device
    anchor = upload(anchor_idx, dev).long()
    picks = torch.cat([anchor[:, None], upload(draws["picks"], dev)], dim=1)  # [B,4]
    centers = upload(draws["centers"], dev)
    new = _mosaic(corpus_images[picks].to(torch.float32), corpus_boxes[picks].to(torch.float32),
                  corpus_classes[picks], corpus_valid[picks], centers[:, 0], centers[:, 1],
                  antialias)
    if draws["take"] is None:
        return new
    old = (corpus_images[anchor].to(torch.float32), corpus_boxes[anchor].to(torch.float32),
           corpus_classes[anchor], corpus_valid[anchor])
    return _select(draws["take"], new, old)


def draw_mixup(gen: torch.Generator, rng: np.random.Generator, batch: int, prob: float = 0.0,
               alpha: float = 32.0) -> Optional[Dict[str, torch.Tensor]]:
    """The random choices of one mixup call: partner permutation ``perm``
    [B], weights ``lam`` [B] ~ Beta(alpha, alpha) (from ``rng``) and gates
    ``take`` [B]; None at prob <= 0 (no mixup, nothing drawn)."""
    if prob <= 0.0:
        return None
    perm = torch.randperm(batch, generator=gen)
    lam = torch.from_numpy(rng.beta(alpha, alpha, batch).astype(np.float32))
    take = torch.rand((batch,), generator=gen) < prob
    return {"perm": perm, "lam": lam, "take": take}


def mixup_batch(images: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
                valid: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]]) -> Batch:
    """Mixup after mosaic: blend each taken sample with its partner and keep
    both label sets (its own first) up to the M slots."""
    if draws is None:
        return images, boxes, classes, valid
    dev = images.device
    m = boxes.shape[1]
    perm, lam = upload(draws["perm"], dev), upload(draws["lam"], dev)[:, None, None, None]
    blended = lam * images + (1 - lam) * images[perm]
    ub = torch.cat([boxes, boxes[perm]], dim=1)[:, :m]
    uc = torch.cat([classes, classes[perm]], dim=1)[:, :m]
    uv = torch.cat([valid, valid[perm]], dim=1)[:, :m]
    return _select(draws["take"], (blended, ub, uc, uv), (images, boxes, classes, valid))
