"""MVTec-AD-layout corpus renderer (held-out parameters), a copy of the JAX
package's ``data/mvtec_synth.py`` that writes its PNG files through
``runtime/codec.py``.

To prove the full real-data cycle (import -> train -> deterministic eval ->
serve) without the MVTec AD archive, this module renders an
MVTec-AD-layout corpus to DISK — PNG images + ground-truth masks in the
exact directory schema ``data/mvtec.py`` imports::

    <root>/<category>/
      train/good/*.png
      test/good/*.png
      test/<defect_type>/*.png
      ground_truth/<defect_type>/<stem>_mask.png

Crucially the renderer is a SEPARATE generative model from the training
corpus generator (``data/yolo_dataset.py::SyntheticDefectDataset``): every
visual parameter is held out —

- textured surfaces (anisotropic brushed-metal streaks / woven fabric
  grid) instead of flat gray; illumination gradients + vignette; sensor
  noise with per-channel gain;
- defects rendered with different shape models: cracks BRANCH and vary in
  width with soft feathered edges (vs the train generator's rigid 3px
  polyline), scratches are curved quadratic Beziers that can glint bright
  (vs straight dark lines), dents shade directionally like a 3-D
  depression (vs uniform darkening), discoloration is an irregular
  smoothed-noise blotch (vs a clean ellipse), contamination is a splatter
  CLUSTER of mixed bright/dark blobs (vs one bright disc);
- rendered at a different base resolution (default 512) than training
  input sizes, so the import path exercises real resize scaling;
- labels come from rendered ground-truth MASKS (boxes re-derived by the
  importer's connected-components pass), not from generator box metadata.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFECT_TYPES = ("crack", "scratch", "dent", "discoloration", "contamination")


def _gauss(a: np.ndarray, sigma) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(a, sigma, mode="reflect")


class MVTecStyleRenderer:
    """Renders one category's samples; all randomness from a seeded PRNG."""

    def __init__(self, category: str = "metal_plate", size: int = 512,
                 seed: int = 2024):
        self.category = category
        self.size = size
        self.seed = seed

    # -- surfaces -----------------------------------------------------------

    def _surface(self, rng: np.random.Generator) -> np.ndarray:
        s = self.size
        base = rng.uniform(105, 185)
        if self.category.startswith(("fabric", "textile")):
            # woven grid: two orthogonal smoothed stripe fields
            u = _gauss(rng.normal(0, 1, (s, s)), (0.5, 6))
            v = _gauss(rng.normal(0, 1, (s, s)), (6, 0.5))
            tex = 10.0 * (u + v)
            cast = rng.uniform([0.95, 0.92, 0.88], [1.05, 1.02, 0.98])
        else:
            # brushed metal: strongly anisotropic streaks + mild 2-D grain
            streaks = _gauss(rng.normal(0, 1, (s, s)), (0.6, 18))
            grain = _gauss(rng.normal(0, 1, (s, s)), 1.2)
            tex = 26.0 * streaks + 4.0 * grain
            cast = rng.uniform([0.97, 0.98, 1.0], [1.02, 1.03, 1.08])
        img = (base + tex)[..., None] * cast[None, None, :]

        # illumination: linear gradient in a random direction + vignette
        yy, xx = np.mgrid[:s, :s].astype(np.float32) / s
        ang = rng.uniform(0, 2 * np.pi)
        grad = (np.cos(ang) * xx + np.sin(ang) * yy) * rng.uniform(-28, 28)
        cy, cx = rng.uniform(0.35, 0.65, 2)
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2
        vignette = -rng.uniform(6, 22) * r2
        img = img + (grad + vignette)[..., None]
        return img

    # -- defect renderers (draw into img float32, return alpha mask) -------

    def _crack(self, img, rng) -> np.ndarray:
        s = self.size
        mask = np.zeros((s, s), np.float32)
        x = float(rng.integers(s // 6, s - s // 6))
        y = float(rng.integers(s // 6, s - s // 6))
        ang = rng.uniform(0, 2 * np.pi)
        steps = int(rng.integers(s // 8, s // 3))
        branches = [(x, y, ang, steps)]
        while branches:
            x, y, ang, n = branches.pop()
            for _ in range(n):
                ang += rng.normal(0, 0.22)  # direction persistence
                x += np.cos(ang)
                y += np.sin(ang)
                if not (1 <= x < s - 1 and 1 <= y < s - 1):
                    break
                mask[int(y), int(x)] = 1.0
                if rng.uniform() < 0.015 and len(branches) < 3:  # branch
                    branches.append(
                        (x, y, ang + rng.choice([-1, 1]) * rng.uniform(0.5, 1.2),
                         int(n * rng.uniform(0.3, 0.6)))
                    )
        width = rng.uniform(0.6, 1.6)
        alpha = np.clip(_gauss(mask, width) * (2.5 + 2.0 * width), 0, 1)
        depth = rng.uniform(0.35, 0.7)
        img *= (1.0 - depth * alpha)[..., None]
        return alpha

    def _scratch(self, img, rng) -> np.ndarray:
        s = self.size
        mask = np.zeros((s, s), np.float32)
        # quadratic Bezier: endpoints + control point => gentle curve
        p0 = rng.uniform(s * 0.1, s * 0.9, 2)
        p2 = p0 + rng.uniform(-s * 0.45, s * 0.45, 2)
        p2 = np.clip(p2, 2, s - 3)
        p1 = (p0 + p2) / 2 + rng.uniform(-s * 0.12, s * 0.12, 2)
        t = np.linspace(0, 1, int(np.hypot(*(p2 - p0)) * 2 + 8))
        pts = ((1 - t) ** 2)[:, None] * p0 + (2 * t * (1 - t))[:, None] * p1 \
            + (t ** 2)[:, None] * p2
        ix = np.clip(pts[:, 0].astype(int), 0, s - 1)
        iy = np.clip(pts[:, 1].astype(int), 0, s - 1)
        mask[iy, ix] = 1.0
        alpha = np.clip(_gauss(mask, rng.uniform(0.5, 1.0)) * 3.0, 0, 1)
        if rng.uniform() < 0.45:  # metallic glint: bright scratch
            img += (alpha * rng.uniform(35, 80))[..., None]
        else:
            img *= (1.0 - rng.uniform(0.3, 0.55) * alpha)[..., None]
        return alpha

    def _dent(self, img, rng) -> np.ndarray:
        s = self.size
        yy, xx = np.mgrid[:s, :s].astype(np.float32)
        cx, cy = rng.uniform(s * 0.15, s * 0.85, 2)
        rx, ry = rng.uniform(s / 26, s / 9, 2)
        th = rng.uniform(0, np.pi)
        xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        d2 = (xr / rx) ** 2 + (yr / ry) ** 2
        support = np.clip(1.0 - d2, 0, 1)  # smooth bowl profile
        # directional shading: one rim darker, opposite rim brighter
        light = rng.uniform(0, 2 * np.pi)
        lobe = (np.cos(light) * xr / rx + np.sin(light) * yr / ry)
        shade = support * lobe * rng.uniform(18, 42)
        floor = -support ** 2 * rng.uniform(10, 30)  # bottom darkening
        img += (shade + floor)[..., None]
        return (support > 0.08).astype(np.float32)

    def _discoloration(self, img, rng) -> np.ndarray:
        s = self.size
        yy, xx = np.mgrid[:s, :s].astype(np.float32)
        cx, cy = rng.uniform(s * 0.15, s * 0.85, 2)
        rx, ry = rng.uniform(s / 14, s / 6, 2)
        support = np.clip(
            1.0 - ((xx - cx) / rx) ** 2 - ((yy - cy) / ry) ** 2, 0, 1
        )
        # irregular blotch: smoothed noise gates the ellipse support
        noise = _gauss(rng.normal(0, 1, (s, s)), s / 40)
        noise = (noise - noise.min()) / max(float(np.ptp(noise)), 1e-6)
        alpha = np.clip(support * (noise * 1.6 - 0.25), 0, 1)
        alpha = np.clip(alpha * 2.2, 0, 1)
        tint = rng.uniform([0.72, 0.72, 0.6], [1.3, 1.25, 1.45])
        img *= 1.0 + alpha[..., None] * (tint[None, None, :] - 1.0)
        return alpha

    def _contamination(self, img, rng) -> np.ndarray:
        s = self.size
        yy, xx = np.mgrid[:s, :s].astype(np.float32)
        cx, cy = rng.uniform(s * 0.2, s * 0.8, 2)
        alpha = np.zeros((s, s), np.float32)
        spread = rng.uniform(s / 30, s / 12)
        for _ in range(int(rng.integers(3, 11))):  # splatter cluster
            bx = cx + rng.normal(0, spread)
            by = cy + rng.normal(0, spread)
            r = rng.uniform(s / 140, s / 36)
            blob = np.exp(-(((xx - bx) ** 2 + (yy - by) ** 2) / (2 * r * r)))
            alpha = np.maximum(alpha, np.clip(blob * 1.8, 0, 1))
        sign = 1.0 if rng.uniform() < 0.5 else -1.0
        img += (alpha * sign * rng.uniform(30, 75))[..., None]
        return (alpha > 0.25).astype(np.float32)

    # -- samples ------------------------------------------------------------

    def render(self, defect_type: Optional[str], index: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (image uint8 [S,S,3], mask uint8 [S,S] in {0,255})."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) * 31
            + (0 if defect_type is None else 1 + DEFECT_TYPES.index(defect_type))
        )
        img = self._surface(rng)
        mask = np.zeros((self.size, self.size), np.float32)
        if defect_type is not None:
            draw = {
                "crack": self._crack, "scratch": self._scratch,
                "dent": self._dent, "discoloration": self._discoloration,
                "contamination": self._contamination,
            }[defect_type]
            for _ in range(int(rng.integers(1, 4))):  # 1-3 instances
                mask = np.maximum(mask, draw(img, rng))
        # sensor noise + per-channel gain, applied after defects
        img *= rng.uniform(0.98, 1.02, 3)[None, None, :]
        img += rng.normal(0, rng.uniform(1.5, 4.0), img.shape)
        image = np.clip(img, 0, 255).astype(np.uint8)
        return image, (mask > 0.3).astype(np.uint8) * 255


def write_corpus(
    root: str,
    category: str = "metal_plate",
    n_train_good: int = 60,
    n_test_good: int = 32,
    n_test_per_defect: int = 40,
    size: int = 512,
    seed: int = 2024,
    defect_types: Sequence[str] = DEFECT_TYPES,
) -> Dict:
    """Render the category to ``root`` in MVTec-AD layout; returns a
    manifest (also useful to verify determinism)."""
    from iqc_tpu_torch.runtime.codec import write_png

    r = MVTecStyleRenderer(category, size=size, seed=seed)
    cat = os.path.join(root, category)
    counts: Dict[str, int] = {}

    def save(img: np.ndarray, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, img)

    idx = 0
    for split, n in (("train/good", n_train_good), ("test/good", n_test_good)):
        for k in range(n):
            img, _ = r.render(None, idx)
            save(img, os.path.join(cat, split, f"{k:03d}.png"))
            idx += 1
        counts[split] = n
    for dt in defect_types:
        for k in range(n_test_per_defect):
            img, mask = r.render(dt, idx)
            stem = f"{k:03d}"
            save(img, os.path.join(cat, "test", dt, f"{stem}.png"))
            save(mask, os.path.join(cat, "ground_truth", dt,
                                    f"{stem}_mask.png"))
            idx += 1
        counts[f"test/{dt}"] = n_test_per_defect
    return {
        "root": root, "category": category, "size": size, "seed": seed,
        "counts": counts,
        "generator": "iqc_tpu_torch.data.mvtec_synth (held-out parameters; "
                     "distinct from the training corpus generator)",
    }
