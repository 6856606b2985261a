"""The port's classifier data path against the JAX package's on the CPU: the
PNG writer and BMP reader, the image-folder dataset, balanced sampling and
the loader, the MVTec importer and renderer, the classifier augmentation fed
the JAX package's draws (rebuilt from its keys with jax.random), the
augmenter's analytics, and the functions that ride along (box blur,
adaptive threshold, exact NMS, the batched mask cleanup).

Tolerances: decoded, resized and rendered images, sampled indices, loader
batches, MVTec samples and boxes, NMS keep masks and cleaned masks EQUAL;
the augmentation's images within 3e-5 (measured up to 4.8e-7: bilinear
weights, the rotation's trigonometry and the upsampled noise fields round
differently) and boxes within 1e-4 px (measured up to 3.8e-6); box blur and
adaptive means within 1e-6."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from iqc_tpu.data import augmentation as jaug
from iqc_tpu.data import mvtec as jmv
from iqc_tpu.data import mvtec_synth as jsynth
from iqc_tpu.data import pipeline as jpipe
from iqc_tpu_torch.data import augmentation as taug
from iqc_tpu_torch.data import mvtec as tmv
from iqc_tpu_torch.data import mvtec_synth as tsynth
from iqc_tpu_torch.data import pipeline as tpipe
from iqc_tpu_torch.runtime import codec

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED_AUG = yaml.safe_load(open(os.path.join(REPO, "config", "resnet_config.yaml"))
                             )["augmentation"]["train"]


# -- the JAX package's augmentation draws, rebuilt from its keys ---------------------


def jax_classifier_draws(keys, height, width, cfg):
    """The draws of the JAX package's augment_image_and_boxes for one key per
    image, as the port's draw_augment returns them (same names, stacked)."""
    h, w = height, width
    per = []
    for key in keys:
        ks = jax.random.split(key, 26)
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)
        gate = lambda k, p: bool(jax.random.uniform(k) < p)
        d = {}
        if cfg.p_hflip > 0:
            d["hflip"] = gate(ks[0], cfg.p_hflip)
        if cfg.p_vflip > 0:
            d["vflip"] = gate(ks[1], cfg.p_vflip)
        if h == w and cfg.p_rot90 > 0:
            d["rot90"] = gate(ks[2], cfg.p_rot90)
        if cfg.p_affine > 0:
            on = gate(ks[3], cfg.p_affine)
            deg, sc, tr, sh = (cfg.max_rotate_deg, cfg.max_scale, cfg.max_translate,
                               cfg.max_shear_deg)
            vals = {"angle": u(ks[4], -deg, deg) * jnp.pi / 180.0,
                    "scale": 1.0 + u(ks[5], -sc, sc),
                    "tx": u(ks[6], -tr, tr) * w, "ty": u(ks[7], -tr, tr) * h,
                    "shx": jnp.tan(u(ks[20], -sh, sh) * jnp.pi / 180.0),
                    "shy": jnp.tan(u(ks[21], -sh, sh) * jnp.pi / 180.0)}
            ident = {"angle": 0.0, "scale": 1.0, "tx": 0.0, "ty": 0.0, "shx": 0.0, "shy": 0.0}
            d["affine"] = on
            d.update({k: float(v) if on else ident[k] for k, v in vals.items()})
        if cfg.p_elastic > 0:
            d["elastic"] = gate(ks[8], cfg.p_elastic)
            k1, k2 = jax.random.split(ks[9])
            coarse = (max(h // 8, 1), max(w // 8, 1))
            d["elastic_dy"] = np.asarray(jax.random.normal(k1, coarse))
            d["elastic_dx"] = np.asarray(jax.random.normal(k2, coarse))
        if cfg.p_brightness > 0:
            r = cfg.brightness_range
            d["brightness"] = float(u(ks[10], -r, r)) if gate(ks[10], cfg.p_brightness) else 0.0
        if cfg.p_contrast > 0:
            r = cfg.contrast_range
            d["contrast"] = (float(1.0 + u(ks[11], -r, r)) if gate(ks[11], cfg.p_contrast)
                             else 1.0)
        if cfg.p_gamma > 0:
            d["gamma"] = gate(ks[12], cfg.p_gamma)
            d["gamma_value"] = float(jnp.exp(u(ks[12], -0.3, 0.3)))
        if cfg.p_saturation > 0:
            r = cfg.saturation_range
            d["saturation"] = gate(ks[13], cfg.p_saturation)
            d["saturation_value"] = float(1.0 + u(ks[13], -r, r))
        if cfg.p_hue > 0:
            d["hue"] = gate(ks[23], cfg.p_hue)
            d["hue_value"] = float(u(ks[22], -cfg.hue_range, cfg.hue_range))
        if cfg.p_grayscale > 0:
            d["grayscale"] = gate(ks[24], cfg.p_grayscale)
        if cfg.p_noise > 0:
            d["noise"] = gate(ks[14], cfg.p_noise)
            d["noise_value"] = np.asarray(jax.random.normal(ks[14], (h, w, 3)))
        if cfg.p_blur > 0:
            d["blur"] = gate(ks[15], cfg.p_blur)
        if cfg.p_motion_blur > 0:
            d["motion_blur"] = gate(ks[16], cfg.p_motion_blur)
            d["motion_theta"] = float(u(ks[16], 0.0, jnp.pi))
        if cfg.p_shadow > 0:
            d["shadow"] = gate(ks[17], cfg.p_shadow)
            k1, k2, k3 = jax.random.split(ks[17], 3)
            d["shadow_theta"] = float(u(k1, 0.0, 2 * jnp.pi))
            d["shadow_offset"] = float(u(k2, -0.25, 0.25))
            d["shadow_strength"] = float(u(k3, 0.3, 0.6))
        if cfg.p_fog > 0:
            d["fog"] = gate(ks[18], cfg.p_fog)
            k1, k2 = jax.random.split(ks[18])
            d["fog_field"] = np.asarray(jax.random.uniform(k1, (max(h // 16, 1),
                                                                max(w // 16, 1))))
            d["fog_density"] = float(u(k2, 0.2, 0.45))
        if cfg.p_cutout > 0:
            d["cutout"] = gate(ks[19], cfg.p_cutout)
            k1, k2 = jax.random.split(ks[19])
            ch, cw = max(int(h * cfg.cutout_frac), 1), max(int(w * cfg.cutout_frac), 1)
            d["cutout_y"] = int(jax.random.randint(k1, (), 0, h - ch + 1))
            d["cutout_x"] = int(jax.random.randint(k2, (), 0, w - cw + 1))
        if cfg.p_edge_enhance > 0:
            d["edge_enhance"] = gate(ks[8], cfg.p_edge_enhance)
        if cfg.p_spot > 0:
            d["spot"] = gate(ks[9], cfg.p_spot)
            k1, k2, k3 = jax.random.split(ks[9], 3)
            d["spot_y"] = float(u(k1, 0.2, 0.8))
            d["spot_x"] = float(u(k2, 0.2, 0.8))
            d["spot_gain"] = float(u(k3, 0.15, 0.4))
        if cfg.p_texture > 0:
            d["texture"] = gate(ks[25], cfg.p_texture)
            d["texture_field"] = np.asarray(jax.random.normal(ks[25], (max(h // 4, 1),
                                                                       max(w // 4, 1))))
        per.append(d)
    out = {}
    for k in per[0]:
        vals = [p[k] for p in per]
        if isinstance(vals[0], bool):
            out[k] = torch.tensor(vals)
        elif isinstance(vals[0], int):
            out[k] = torch.tensor(vals, dtype=torch.int64)
        else:
            out[k] = torch.from_numpy(np.asarray(vals, np.float32))
    return out


def port_config(jcfg):
    return taug.AugmentConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


# -- files -----------------------------------------------------------------------------


def test_png_writer_and_bmp_reader_against_pil(tmp_path):
    """The port's PNG bytes read by PIL equal the array; PIL's PNG and BMP
    files (RGB, RGBA, grey, grey-alpha) read by the port equal PIL's
    ``convert("RGB")`` and ``convert("L")``; an 8-bit BMP is refused by
    name."""
    rng = np.random.default_rng(0)
    for shape in ((17, 23, 3), (9, 31), (5, 5, 1)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        got = np.asarray(Image.open(io.BytesIO(codec.encode_png(a))))
        np.testing.assert_array_equal(got, a.reshape(got.shape))
    for mode in ("RGB", "RGBA", "L", "LA"):
        a = rng.integers(0, 256, (13, 19, len(mode)), dtype=np.uint8)
        im = Image.fromarray(a[..., 0] if mode == "L" else a, mode)
        for fmt in ("png", "bmp") if mode != "LA" else ("png",):
            path = str(tmp_path / f"{mode}.{fmt}")
            im.save(path)
            if fmt == "bmp" and mode == "L":  # PIL writes an 8-bit palette BMP
                with pytest.raises(ValueError, match="8-bit"):
                    codec.read_image(path)
                continue
            for conv in ("RGB", "L"):
                np.testing.assert_array_equal(codec.read_image(path, conv),
                                              np.asarray(Image.open(path).convert(conv)))
    assert codec.decode_bmp(b"not a bitmap") is None


def _write_tree(root, size, counts, seed=3):
    """An image-folder tree of rendered images written by PIL: {class: n}."""
    r = jsynth.MVTecStyleRenderer(size=size, seed=seed)
    i = 0
    for cls, n in counts.items():
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for k in range(n):
            Image.fromarray(r.render(cls, i)[0]).save(os.path.join(root, cls, f"{k:02d}.png"))
            i += 1


@pytest.mark.parametrize("size", [32, 48])
def test_image_folder_dataset_equal(tmp_path, size):
    """ImageFolderDataset: classes, samples and labels equal; every load
    byte-equal to the JAX package's (PIL decode, convert, bicubic resize)
    from 40 px PNGs, and the first at 48 -> 32 and 48 -> 48."""
    counts = {"crack": 3, "dent": 2, "scratch": 1}
    _write_tree(str(tmp_path), 40, counts)
    names = ("crack", "scratch", "dent", "discoloration", "contamination")
    j = jpipe.ImageFolderDataset(str(tmp_path), (size, size), names)
    t = tpipe.ImageFolderDataset(str(tmp_path), (size, size), names)
    assert t.class_names == j.class_names and t.samples == j.samples
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.class_counts(), j.class_counts())
    for i in range(len(j)):
        (ji, jl), (ti, tl) = j.load(i), t.load(i)
        assert ti.dtype == np.uint8 and tl == jl
        np.testing.assert_array_equal(ti, ji)


def test_balanced_indices_and_loader_batches_equal():
    """balanced_sample_indices and the DataLoader's batches (balanced,
    shuffled, in order with a ragged last batch; with and without the
    background producer) equal."""
    rng = np.random.default_rng(1)
    labels = np.repeat(np.arange(5), [9, 4, 2, 6, 3]).astype(np.int32)
    np.testing.assert_array_equal(
        tpipe.balanced_sample_indices(labels, 40, np.random.default_rng(7)),
        jpipe.balanced_sample_indices(labels, 40, np.random.default_rng(7)))
    images = rng.integers(0, 256, (len(labels), 8, 8, 3), dtype=np.uint8)
    jds, tds = jpipe.ArrayDataset(images, labels), tpipe.ArrayDataset(images, labels)
    for kw in ({"balanced": True}, {"shuffle": True}, {"shuffle": False, "drop_last": False}):
        for prefetch in (0, 2):
            jb = list(jpipe.DataLoader(jds, 8, seed=5, prefetch=prefetch, **kw))
            tb = list(tpipe.DataLoader(tds, 8, seed=5, prefetch=prefetch, **kw))
            assert len(tb) == len(jb) > 0
            for a, b in zip(tb, jb):
                for k in ("images", "labels"):
                    np.testing.assert_array_equal(a[k], b[k])


def test_device_prefetch_uploads_every_leaf():
    batches = [{"images": np.full((2, 4, 4, 3), i, np.uint8), "meta": i} for i in range(5)]
    got = list(tpipe.device_prefetch(iter(batches), "cpu", leaves=("images",)))
    assert [b["meta"] for b in got] == list(range(5))
    assert all(isinstance(b["images"], torch.Tensor) and int(b["images"][0, 0, 0, 0]) == i
               for i, b in enumerate(got))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small MVTec-layout corpus written by the JAX package (PIL)."""
    root = str(tmp_path_factory.mktemp("mvtec"))
    manifest = jsynth.write_corpus(root, n_train_good=2, n_test_good=2, n_test_per_defect=3,
                                   size=64, seed=11)
    return os.path.join(root, "metal_plate"), manifest


@pytest.mark.parametrize("defect", [None] + list(jsynth.DEFECT_TYPES))
def test_renderer_byte_equal(defect):
    """MVTecStyleRenderer.render at 64 px: image and mask byte-equal."""
    for index in (0, 5):
        ji, jm = jsynth.MVTecStyleRenderer(size=64, seed=9).render(defect, index)
        ti, tm = tsynth.MVTecStyleRenderer(size=64, seed=9).render(defect, index)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)


def test_write_corpus_read_back_equal(corpus, tmp_path):
    """The port's write_corpus: the same files and manifest counts, every
    file read back by PIL equal to the JAX package's."""
    root, manifest = corpus
    got = tsynth.write_corpus(str(tmp_path), n_train_good=2, n_test_good=2, n_test_per_defect=3,
                              size=64, seed=11)
    assert got["counts"] == manifest["counts"]
    mine = os.path.join(str(tmp_path), "metal_plate")
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), mine)
                           for d, _, fs in os.walk(mine) for f in fs)
    for f in files:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(mine, f))),
                                      np.asarray(Image.open(os.path.join(root, f))))


def test_mvtec_datasets_equal(corpus):
    """mask_to_boxes, the detection, classification and crop-classification
    datasets, subsets, concatenations and both splits: equal."""
    root, _ = corpus
    mask = np.asarray(Image.open(os.path.join(root, "ground_truth", "crack", "000_mask.png")))
    assert tmv.mask_to_boxes(mask) == jmv.mask_to_boxes(mask)
    pairs = [(jmv.MVTecDetectionDataset(root, image_size=48, max_boxes=4),
              tmv.MVTecDetectionDataset(root, image_size=48, max_boxes=4)),
             (jmv.MVTecClassificationDataset(root, (40, 32)),
              tmv.MVTecClassificationDataset(root, (40, 32))),
             (jmv.MVTecCropClassificationDataset(root, (32, 32), min_crop=16),
              tmv.MVTecCropClassificationDataset(root, (32, 32), min_crop=16))]
    for j, t in pairs:
        assert len(t) == len(j) > 0 and t.samples == j.samples
        for i in range(len(j)):
            for a, b in zip(t.load(i), j.load(i)):
                np.testing.assert_array_equal(a, b)
    j, t = pairs[2]
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.groups == j.groups
    assert tmv.split_indices(len(t), 0.3, 2) == jmv.split_indices(len(j), 0.3, 2)
    assert tmv.split_indices_grouped(t.groups, 0.3, 2) == jmv.split_indices_grouped(j.groups,
                                                                                    0.3, 2)
    tsub = tmv.SubsetDataset(t, [2, 0])
    jsub = jmv.SubsetDataset(j, [2, 0])
    np.testing.assert_array_equal(tsub.class_counts(), jsub.class_counts())
    tcat = tmv.ConcatDataset([tsub, t])
    jcat = jmv.ConcatDataset([jsub, j])
    assert len(tcat) == len(jcat)
    np.testing.assert_array_equal(tcat.class_counts(), jcat.class_counts())
    np.testing.assert_array_equal(tcat.load(3)[0], jcat.load(3)[0])


# -- augmentation ------------------------------------------------------------------------


def test_classifier_augment_config_equal():
    """classifier_augment_config of resnet_config.yaml's augmentation.train
    (and of None / {}) equal field for field."""
    assert taug.classifier_augment_config(None) is None
    assert taug.classifier_augment_config({}) is None
    j = jaug.classifier_augment_config(SHIPPED_AUG)
    t = taug.classifier_augment_config(SHIPPED_AUG)
    assert t == port_config(j)
    assert taug.AugmentConfig() == port_config(jaug.AugmentConfig())


CHAINS = {"shipped": jaug.classifier_augment_config(SHIPPED_AUG),
          "defaults": jaug.AugmentConfig(),
          **jaug.DEFECT_AUGMENT_CONFIGS}


@pytest.mark.parametrize("name", list(CHAINS))
def test_augment_image_and_boxes_fed_jax_draws(name):
    """The whole chain on 6 rendered 32 px images with boxes, fed the JAX
    package's draws: images within 3e-5 of its jitted, vmapped chain,
    boxes within 1e-4 px. Every gate of the chain is drawn on at least once
    over the batches with p > 0 (the draws vary per image)."""
    jcfg = CHAINS[name]
    r = jsynth.MVTecStyleRenderer(size=32, seed=4)
    imgs = np.stack([r.render(d, i)[0] for i, d in enumerate(jsynth.DEFECT_TYPES * 2)][:6])
    x = imgs.astype(np.float32) / 255.0
    boxes = np.tile(np.asarray([[3.0, 4.0, 20.0, 15.0], [10.0, 12.0, 30.0, 31.0]],
                               np.float32), (6, 1, 1))
    fn = jax.jit(jax.vmap(lambda k, im, b: jaug.augment_image_and_boxes(k, im, b, jcfg)))
    for seed in (0, 1):
        keys = jax.random.split(jax.random.PRNGKey(seed), 6)
        want_i, want_b = (np.asarray(v) for v in fn(keys, jnp.asarray(x), jnp.asarray(boxes)))
        draws = jax_classifier_draws(keys, 32, 32, jcfg)
        got_i, got_b = taug.augment_image_and_boxes(torch.from_numpy(x), torch.from_numpy(boxes),
                                                    draws, port_config(jcfg))
        np.testing.assert_allclose(got_i.numpy(), want_i, rtol=0, atol=3e-5)
        np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=1e-4)


def test_port_draws_cover_every_stage():
    """draw_augment gives every key the chain reads, at the right shapes,
    for every pipeline; yolo_train_augment on one image equals the batch
    version's first image."""
    for jcfg in CHAINS.values():
        cfg = port_config(jcfg)
        d = taug.draw_augment(torch.Generator().manual_seed(0), 3, 32, 32, cfg)
        want = jax_classifier_draws(jax.random.split(jax.random.PRNGKey(0), 3), 32, 32, jcfg)
        assert set(d) == set(want)
        for k in d:
            assert d[k].shape == want[k].shape and d[k].dtype == want[k].dtype, k
        taug.augment_image_and_boxes(torch.rand(3, 32, 32, 3), None, d, cfg)
    hyp = taug.YoloAugHyp(degrees=10.0)
    draws = taug.draw_yolo_augment(torch.Generator().manual_seed(1), 1, 32, 32, hyp)
    img, bx, vl = torch.rand(32, 32, 3), torch.tensor([[2.0, 3.0, 20.0, 25.0]]), torch.ones(
        1, dtype=torch.bool)
    one = taug.yolo_train_augment(img, bx, vl, draws, hyp)
    batch = taug.yolo_train_augment_batch(img[None], bx[None], torch.zeros(1, 1), vl[None],
                                          draws, hyp)
    for a, b in zip(one, (batch[0][0], batch[1][0], batch[3][0])):
        assert torch.equal(a, b)


def test_augmenter_analytics_equal():
    """QualityControlAugmenter's histogram distance and effectiveness
    figures equal the JAX package's on the same variants; its per-class
    factory takes the per-class pipeline; its outputs are uint8 of the
    right shapes."""
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2))
    assert (taug.QualityControlAugmenter.bhattacharyya_distance(a, b)
            == jaug.QualityControlAugmenter.bhattacharyya_distance(a, b))
    variants = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(4)]
    j = jaug.QualityControlAugmenter()
    j.augment_image = lambda image, seed=0: variants[seed]
    want = j.analyze_augmentation_effectiveness(a, n_samples=4)
    assert taug.QualityControlAugmenter.effectiveness(a, variants) == want
    aug = taug.QualityControlAugmenter.create_defect_specific_augmentations("dent", "cpu")
    assert aug.config == port_config(jaug.DEFECT_AUGMENT_CONFIGS["dent"])
    out = aug.augment_batch(np.stack([a, b]), n_augmentations=2, seed=3)
    assert out.shape == (4, 16, 16, 3) and out.dtype == np.uint8
    img, boxes = aug.augment_with_annotations(a, [[1, 2, 9, 12]], seed=1)
    assert img.shape == a.shape and boxes.shape == (1, 4)
    assert aug.visualize_augmentations(a, n=2).shape == (16, 48, 3)


# -- riding along ------------------------------------------------------------------------


def test_box_blur_and_adaptive_threshold_equal():
    """box_blur and the mean / gaussian adaptive local means within 1e-6;
    the adaptive thresholds equal where the mean is not within 1e-6 of the
    pixel's threshold."""
    from iqc_tpu.ops import image as jimg
    from iqc_tpu_torch.ops import image as timg

    x = np.random.default_rng(3).random((29, 33)).astype(np.float32)  # one grey ROI
    for radius in (1, 3):
        np.testing.assert_allclose(timg.box_blur(torch.from_numpy(x), radius).numpy(),
                                   np.asarray(jimg.box_blur(jnp.asarray(x), radius)), atol=1e-6)
    for method in ("gaussian", "mean"):
        want_mean = np.asarray(jimg.adaptive_local_mean(jnp.asarray(x), 11, method))
        np.testing.assert_allclose(timg.adaptive_local_mean(torch.from_numpy(x), 11, method)
                                   .numpy(), want_mean, atol=1e-6)
        for invert in (False, True):
            want = np.asarray(jimg.adaptive_threshold(jnp.asarray(x), 11, 2.0, invert, method))
            got = timg.adaptive_threshold(torch.from_numpy(x), 11, 2.0, invert, method).numpy()
            sure = np.abs(x - (want_mean - 2.0 / 255.0)) > 1e-6
            np.testing.assert_array_equal(got[sure], want[sure])


def test_exact_nms_equal():
    """nms_single and batched_nms with iterations=None (the exact sequential
    suppression) give the JAX package's keep sets, boxes and scores, on
    dense overlapping candidates where 16 fixed rounds would not settle."""
    from iqc_tpu.ops import nms as jnms
    from iqc_tpu_torch.ops import nms as tnms

    rng = np.random.default_rng(4)
    n = 60
    xy = np.cumsum(rng.uniform(0, 3, (n, 2)), 0).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(8, 12, (n, 2))], 1).astype(np.float32)
    scores = np.sort(rng.random(n).astype(np.float32))[::-1].copy()
    classes = rng.integers(0, 2, n).astype(np.int32)
    mask = np.ones(n, bool)
    want = jnms.nms_single(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                           jnp.asarray(mask), 40, 0.3, 0.05, iterations=None)
    got = tnms.nms_single(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(classes), torch.from_numpy(mask), 40, 0.3, 0.05,
                          iterations=None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fixed = tnms.nms_single(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), torch.from_numpy(mask), 40, 0.3, 0.05,
                            iterations=1)
    assert not torch.equal(fixed.valid, got.valid)  # one round does not reach the fixed point
    scores_all = np.stack([scores * (classes == c) for c in (0, 1)], -1)[None]
    want_b = jnms.batched_nms(jnp.asarray(boxes[None]), jnp.asarray(scores_all), 40, 0.3, 0.05,
                              iterations=None)
    got_b = tnms.batched_nms(torch.from_numpy(boxes[None]), torch.from_numpy(scores_all), 40,
                             0.3, 0.05, iterations=None)
    for a, b in zip(got_b, want_b):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_clean_and_grow_clean_batch_equal():
    """clean_mask_batch and grow_clean_batch equal the JAX package's (its
    XLA form on the CPU) on random 32 px masks."""
    from iqc_tpu.ops import segmentation as jseg
    from iqc_tpu_torch.ops import segmentation as tseg

    rng = np.random.default_rng(5)
    masks = rng.random((3, 32, 32)) < 0.45
    seeds = rng.random((3, 32, 32)) < 0.03
    allow = rng.random((3, 32, 32)) < 0.7
    np.testing.assert_array_equal(
        tseg.clean_mask_batch(torch.from_numpy(masks)).numpy(),
        np.asarray(jseg.clean_mask_batch(jnp.asarray(masks), use_pallas=False)))
    np.testing.assert_array_equal(
        tseg.grow_clean_batch(torch.from_numpy(seeds), torch.from_numpy(allow), 12).numpy(),
        np.asarray(jseg.grow_clean_batch(jnp.asarray(seeds), jnp.asarray(allow), 12,
                                         use_pallas=False)))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """profile_trace records the block and writes a Chrome trace holding its
    operators; without a directory it records nothing."""
    import json

    from iqc_tpu_torch.utils.tracing import profile_trace

    with profile_trace(str(tmp_path)) as prof:
        torch.relu(torch.ones(8) - 2)
    assert prof is not None
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any("relu" in str(e.get("name", "")) for e in events)
    with profile_trace(None) as prof:
        assert prof is None


def test_resnet_training_profile_equals_yaml():
    """config.RESNET_TRAINING_PROFILE holds resnet_config.yaml's training
    block and augmentation.train, equal to yaml.safe_load's."""
    from iqc_tpu_torch.config import RESNET_TRAINING_PROFILE
    from iqc_tpu_torch.train.train_resnet import config_from_profile

    raw = yaml.safe_load(open(os.path.join(REPO, "config", "resnet_config.yaml")))
    assert RESNET_TRAINING_PROFILE["training"] == raw["training"]
    assert RESNET_TRAINING_PROFILE["augmentation"]["train"] == raw["augmentation"]["train"]
    assert config_from_profile(raw) == config_from_profile(RESNET_TRAINING_PROFILE)
