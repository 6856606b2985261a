"""The port's training data path against the JAX package's on the CPU: the
device mosaic, mixup and augmentation applied to the JAX package's own
random draws (rebuilt from its keys with jax.random), the host loader,
mosaic4, mixup and YoloDataset, detection metrics, training utilities,
evolution's mutation and the training profile. Each test states its
tolerance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqc_tpu.data import augmentation as jaug
from iqc_tpu.data import yolo_dataset as jds
from iqc_tpu.ops import mosaic as jmosaic
from iqc_tpu_torch.data import augmentation as taug
from iqc_tpu_torch.data import yolo_dataset as tds
from iqc_tpu_torch.ops import mosaic as tmosaic

S = 64
HYP_FIELDS = ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear", "flipud",
              "fliplr")


def t(x):
    return torch.from_numpy(np.array(x))


def jax_mosaic_draws(key, batch, n, size, prob):
    """The draws of the JAX package's mosaic_batch / mosaic_from_corpus for
    ``key``, as the port's draw_mosaic returns them."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {"picks": t(jax.random.randint(k1, (batch, 3), 0, n, dtype=jnp.int32)).long(),
            "centers": t(jax.random.uniform(k2, (batch, 2), minval=0.3 * size,
                                            maxval=0.7 * size)),
            "take": None if prob >= 1.0 else t(jax.random.uniform(k3, (batch,)) < prob)}


def jax_mixup_draws(key, batch, prob, alpha=32.0):
    if prob <= 0:
        return None
    k1, k2, k3 = jax.random.split(key, 3)
    return {"perm": t(jax.random.permutation(k1, batch)).long(),
            "lam": t(jax.random.beta(k2, alpha, alpha, (batch,))),
            "take": t(jax.random.uniform(k3, (batch,)) < prob)}


def jax_aug_draws(key, batch, height, width, hyp):
    """The draws of the JAX package's yolo_train_augment_batch for ``key``
    (one split per image, then its geometric and HSV keys), as the port's
    draw_yolo_augment returns them."""
    geo = taug.YoloAugHyp(**{f: getattr(hyp, f) for f in HYP_FIELDS}).geometry()
    out = {k: [] for k in ("hflip", "vflip", "affine", "angle", "scale", "tx", "ty", "shx",
                           "shy", "hue", "sat", "val")}

    def u(k, lo, hi):
        return float(jax.random.uniform(k, (), minval=lo, maxval=hi))

    for kb in jax.random.split(key, batch):
        kg, kh = jax.random.split(kb)
        ks = jax.random.split(kg, 26)
        out["hflip"].append(geo.p_hflip > 0 and bool(jax.random.uniform(ks[0]) < geo.p_hflip))
        out["vflip"].append(geo.p_vflip > 0 and bool(jax.random.uniform(ks[1]) < geo.p_vflip))
        on = geo.p_affine > 0 and bool(jax.random.uniform(ks[3]) < geo.p_affine)
        out["affine"].append(on)
        deg, sh = geo.max_rotate_deg, geo.max_shear_deg
        vals = {
            "angle": float(jax.random.uniform(ks[4], (), minval=-deg, maxval=deg) * jnp.pi / 180),
            "scale": 1.0 + u(ks[5], -geo.max_scale, geo.max_scale),
            "tx": float(jax.random.uniform(ks[6], (), minval=-geo.max_translate,
                                           maxval=geo.max_translate) * width),
            "ty": float(jax.random.uniform(ks[7], (), minval=-geo.max_translate,
                                           maxval=geo.max_translate) * height),
            "shx": float(jnp.tan(jax.random.uniform(ks[20], (), minval=-sh, maxval=sh)
                                 * jnp.pi / 180)),
            "shy": float(jnp.tan(jax.random.uniform(ks[21], (), minval=-sh, maxval=sh)
                                 * jnp.pi / 180))}
        ident = {"angle": 0.0, "scale": 1.0, "tx": 0.0, "ty": 0.0, "shx": 0.0, "shy": 0.0}
        for k, v in vals.items():
            out[k].append(v if on else ident[k])
        a, b, c = jax.random.split(kh, 3)
        out["hue"].append(u(a, -hyp.hsv_h, hyp.hsv_h) if hyp.hsv_h > 0 else 0.0)
        out["sat"].append(1.0 + u(b, -hyp.hsv_s, hyp.hsv_s) if hyp.hsv_s > 0 else 1.0)
        out["val"].append(1.0 + u(c, -hyp.hsv_v, hyp.hsv_v) if hyp.hsv_v > 0 else 1.0)
    return {k: torch.tensor(v) if isinstance(v[0], bool) else torch.tensor(v, dtype=torch.float32)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def corpus():
    ds = jds.SyntheticDefectDataset(16, S, 8, seed=0)
    items = [ds.load(i) for i in range(16)]
    return tuple(np.stack([x[i] for x in items]) for i in range(4))


@pytest.mark.parametrize("start,end,antialias", [(10.3, 40.7, False), (0.0, 25.6, False),
                                                 (20.0, 64.0, True), (5.5, 6.0, False)])
def test_interp_matrix(start, end, antialias):
    """_interp_matrix within 1e-6."""
    want = np.asarray(jmosaic._interp_matrix(jnp.float32(start), jnp.float32(end), S, antialias))
    got = tmosaic._interp_matrix(torch.tensor(start), torch.tensor(end), S, antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mosaic_one(corpus):
    """_mosaic_one: image within 1e-6 (sources in 0..255), boxes within
    1e-4 px, classes and valid equal."""
    imgs, bxs, cls_, vld = corpus
    srcs = imgs[:4].astype(np.float32)
    want = jmosaic._mosaic_one(srcs, bxs[:4], cls_[:4], vld[:4], jnp.float32(27.3),
                               jnp.float32(35.9))
    got = tmosaic._mosaic_one(t(srcs), t(bxs[:4]), t(cls_[:4]), t(vld[:4]), 27.3, 35.9)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def check_batch(got, want, image_atol=1e-6, box_atol=1e-4):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=image_atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=box_atol)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_mosaic_batch_corpus_and_mixup(corpus, prob):
    """mosaic_batch, mosaic_from_corpus and mixup_batch fed the JAX
    package's draws from the same key: images within 1e-6 (of a 0..255
    scale; mixup's blends within 1e-4, a few float32 ulps at 255), boxes
    within 1e-4 px, classes and valid equal."""
    imgs, bxs, cls_, vld = corpus
    key = jax.random.fold_in(jax.random.PRNGKey(42), 3)
    km, kx = jax.random.split(key)
    b = 8
    want = jmosaic.mosaic_batch(imgs[:b], bxs[:b], cls_[:b], vld[:b], km, prob=prob)
    got = tmosaic.mosaic_batch(t(imgs[:b]), t(bxs[:b]), t(cls_[:b]), t(vld[:b]),
                               jax_mosaic_draws(km, b, b, S, prob))
    check_batch(got, want)

    idx = np.array([0, 5, 9, 15], np.int32)
    want = jmosaic.mosaic_from_corpus(imgs, bxs, cls_, vld, idx, km, prob=prob)
    got = tmosaic.mosaic_from_corpus(t(imgs), t(bxs), t(cls_), t(vld), t(idx),
                                     jax_mosaic_draws(km, 4, 16, S, prob))
    check_batch(got, want)

    x = [np.asarray(v) for v in want]
    want_m = jmosaic.mixup_batch(*x, kx, prob=prob)
    got_m = tmosaic.mixup_batch(*(t(v) for v in x), jax_mixup_draws(kx, 4, prob))
    check_batch(got_m, want_m, image_atol=1e-4)
    assert tmosaic.mixup_batch(*(t(v) for v in x), None)[0].equal(t(x[0]))


def test_draws_are_seeded_and_shaped():
    """draw_mosaic / draw_mixup / draw_yolo_augment: CPU tensors of the
    documented shapes and ranges, equal for equal generator seeds."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = tmosaic.draw_mosaic(g1, 6, S, 10, 0.5), tmosaic.draw_mosaic(g2, 6, S, 10, 0.5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["picks"].shape == (6, 3) and int(a["picks"].max()) < 10
    assert float(a["centers"].min()) >= 0.3 * S and float(a["centers"].max()) < 0.7 * S
    m = tmosaic.draw_mixup(g1, np.random.default_rng(0), 6, 0.5)
    assert sorted(m["perm"].tolist()) == list(range(6)) and m["lam"].dtype == torch.float32
    assert tmosaic.draw_mixup(g1, np.random.default_rng(0), 6, 0.0) is None
    d = taug.draw_yolo_augment(g1, 6, S, S, taug.YoloAugHyp())
    assert d["affine"].all() and (d["scale"] >= 0.5).all() and (d["scale"] <= 1.5).all()


@pytest.mark.parametrize("hyp", [
    dict(),  # the shipped profile: separable bfloat16 path
    dict(degrees=10.0, shear=5.0, flipud=0.5),  # the gather path
], ids=["shipped", "rotate_shear"])
def test_yolo_train_augment_batch(hyp):
    """yolo_train_augment_batch fed the JAX package's draws. Shipped
    hyperparameters (the separable path, bfloat16 operands and float32
    sums in both): images within 1e-6, boxes within 1e-3 px, valid equal.
    With rotation and shear (the bilinear gather): images within 3e-5
    (measured 7.9e-6: XLA's and PyTorch's float32 cos/sin of the angle
    differ by an ulp, which moves the sampling points by ~4e-6 px at
    64 px), boxes within 1e-3 px, valid equal."""
    rng = np.random.default_rng(0)
    b = 6
    img = rng.uniform(0, 1, (b, S, S, 3)).astype(np.float32)
    xy = rng.uniform(0, 40, (b, 8, 2))
    bx = np.concatenate([xy, xy + rng.uniform(1, 20, (b, 8, 2))], -1).astype(np.float32)
    cl = rng.integers(0, 5, (b, 8)).astype(np.int32)
    vl = rng.uniform(size=(b, 8)) < 0.7
    jhyp = jaug.YoloAugHyp(**hyp)
    key = jax.random.fold_in(jax.random.PRNGKey(42 + 7919), 2)
    want = jax.jit(lambda k, i, x, c, v: jaug.yolo_train_augment_batch(k, i, x, c, v, jhyp))(
        key, img, bx, cl, vl)
    thyp = taug.YoloAugHyp(**hyp)
    got = taug.yolo_train_augment_batch(t(img), t(bx), t(cl), t(vl),
                                        jax_aug_draws(key, b, S, S, jhyp), thyp)
    check_batch(got, want, image_atol=1e-6 if not hyp else 3e-5, box_atol=1e-3)


# -- host data ----------------------------------------------------------------------


def test_bilinear_and_bicubic_resize_match_pillow():
    """resize_bilinear and resize_bicubic byte-equal to Pillow on random
    sizes, up and down."""
    from PIL import Image

    from iqc_tpu_torch.data.resize import resize_bicubic, resize_bilinear

    rng = np.random.default_rng(0)
    for _ in range(40):
        h, w = rng.integers(4, 90, 2)
        oh, ow = (int(v) for v in rng.integers(1, 120, 2))
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resize_bilinear(im, (ow, oh)),
            np.asarray(Image.fromarray(im).resize((ow, oh), Image.BILINEAR)))
        np.testing.assert_array_equal(resize_bicubic(im, (ow, oh)),
                                      np.asarray(Image.fromarray(im).resize((ow, oh))))


def test_mosaic4_and_mixup_equal():
    """mosaic4 (its bilinear patches byte-equal to Pillow's) and mixup with
    the same numpy seed: exactly equal."""
    ds = jds.SyntheticDefectDataset(8, 96, 8, seed=3)
    samples = [ds.load(i) for i in range(4)]
    for seed in range(4):
        want = jds.mosaic4(samples, 96, 16, np.random.default_rng(seed))
        got = tds.mosaic4(samples, 96, 16, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        want = jds.mixup(samples[0], samples[1], np.random.default_rng(seed))
        got = tds.mixup(samples[0], samples[1], np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_detection_loader_batches_equal(prefetch):
    """DetectionLoader with host mosaic 0.5 and mixup 0.3, the same seed:
    two epochs of batches exactly equal to the JAX package's."""
    jl = jds.DetectionLoader(jds.SyntheticDefectDataset(12, 64, 8, seed=0), 4, mosaic_prob=0.5,
                             mixup_prob=0.3, seed=9, prefetch=prefetch)
    tl = tds.DetectionLoader(tds.SyntheticDefectDataset(12, 64, 8, seed=0), 4, mosaic_prob=0.5,
                             mixup_prob=0.3, seed=9, prefetch=prefetch)
    assert len(jl) == len(tl) == 3
    for _ in range(2):
        for want, got in zip(jl, tl):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_yolo_dataset_png_equal(tmp_path):
    """YoloDataset over PNG files (written with PIL) and YOLO txt labels:
    every sample equal to the JAX package's (which reads with PIL)."""
    from PIL import Image

    img_dir, lbl_dir = tmp_path / "images" / "train", tmp_path / "labels" / "train"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(64, 64), (50, 90), (120, 80)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"f{i}.png")
        (lbl_dir / f"f{i}.txt").write_text("2 0.5 0.5 0.25 0.25\n1 0.3 0.6 0.1 0.2\n")
    (img_dir / "notes.txt").write_text("not an image")
    want = jds.YoloDataset(str(img_dir), str(lbl_dir), image_size=96, max_boxes=4)
    got = tds.YoloDataset(str(img_dir), image_size=96, max_boxes=4)
    assert got.files == want.files and len(got) == 3
    for i in range(3):
        for g, w in zip(got.load(i), want.load(i)):
            np.testing.assert_array_equal(g, w)


# -- metrics, utilities, evolution, profile ---------------------------------------


def test_detection_metrics_equal():
    """evaluate_detections on seeded predictions and ground truths: every
    field exactly equal."""
    from iqc_tpu.train.detection_metrics import evaluate_detections as jeval
    from iqc_tpu_torch.train.detection_metrics import evaluate_detections

    rng = np.random.default_rng(1)
    preds, gts = [], []
    for _ in range(6):
        g = rng.uniform(0, 50, (4, 2))
        gb = np.concatenate([g, g + rng.uniform(5, 30, (4, 2))], -1).astype(np.float32)
        gc = rng.integers(0, 3, 4)
        pb = np.concatenate([gb + rng.normal(0, 2, gb.shape), rng.uniform(0, 80, (3, 4))])
        preds.append({"boxes": pb.astype(np.float32), "scores": rng.uniform(0, 1, 7),
                      "classes": np.concatenate([gc, rng.integers(0, 3, 3)])})
        gts.append({"boxes": gb, "classes": gc})
    assert evaluate_detections(preds, gts, 4) == jeval(preds, gts, 4)


def test_train_utils_equal(tmp_path):
    """EarlyStopping, ReduceLROnPlateau, MetricsTracker (JSON/CSV),
    ROC/AUC, class weights, parameter counts, profile_model and the
    training report equal to the JAX package's; set_global_seed returns a
    seeded CPU generator."""
    from iqc_tpu.train import utils as ju
    from iqc_tpu_torch.train import utils as tu

    vals = [0.1, 0.3, 0.3, 0.2, 0.25, 0.1, 0.05, 0.4]
    for mode in ("max", "min"):
        a, b = ju.EarlyStopping(patience=2, mode=mode), tu.EarlyStopping(patience=2, mode=mode)
        assert [a.step(v) for v in vals] == [b.step(v) for v in vals]
        a = ju.ReduceLROnPlateau(0.1, mode=mode, patience=1)
        b = tu.ReduceLROnPlateau(0.1, mode=mode, patience=1)
        assert [a.step(v) for v in vals] == [b.step(v) for v in vals]
    ma, mb = ju.MetricsTracker(), tu.MetricsTracker()
    for i, v in enumerate(vals):
        ma.update({"loss": v, "val_accuracy": 1 - v})
        mb.update({"loss": v, "val_accuracy": 1 - v})
    for m, name in ((ma, "a"), (mb, "b")):
        m.export_json(str(tmp_path / f"{name}.json"))
        m.export_csv(str(tmp_path / f"{name}.csv"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    assert ma.best("loss", "min") == mb.best("loss", "min")
    rng = np.random.default_rng(2)
    labels, probs = rng.integers(0, 3, 60), rng.dirichlet(np.ones(3), 60)
    assert ju.multiclass_roc_auc(labels, probs) == tu.multiclass_roc_auc(labels, probs)
    np.testing.assert_array_equal(ju.compute_class_weights(labels, 4),
                                  tu.compute_class_weights(labels, 4))
    assert ju.training_report(ma.history) == tu.training_report(mb.history)
    params = {"a": {"w": np.zeros((3, 4), np.float32)}, "b": np.zeros(5, np.float32)}
    tparams = {"a": {"w": torch.zeros(3, 4)}, "b": torch.zeros(5)}
    assert ju.count_parameters(params) == tu.count_parameters(tparams) == 17
    assert ju.model_size_mb(params) == tu.model_size_mb(tparams)
    prof = tu.profile_model(lambda x: x * 2, torch.ones(3), iterations=5, warmup=1)
    assert prof["iterations"] == 5 and prof["fps"] > 0
    g = tu.set_global_seed(7)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7


def test_evolve_mutate_equal():
    """mutate gives the JAX package's genes from equal generators."""
    from iqc_tpu.train.evolve import SEARCH_SPACE, mutate as jmutate
    from iqc_tpu_torch.train.evolve import SEARCH_SPACE as TSPACE, mutate

    assert TSPACE == SEARCH_SPACE
    genes = {k: (lo + hi) / 3 for k, (lo, hi) in SEARCH_SPACE.items()}
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for p in (0.8, 0.0, 0.3):
        assert mutate(genes, r2, p, 0.2) == jmutate(genes, r1, p, 0.2)


def test_training_profile_equals_yaml_and_routing():
    """YOLO_TRAINING_PROFILE equals the training, augmentation and
    qc_specific.class_weights blocks of config/yolo_config.yaml
    (yaml.safe_load), and config_from_profile routes them as the JAX
    package's train_yolo.main does."""
    import os

    import yaml

    from iqc_tpu_torch.config import REPO_ROOT, YOLO_TRAINING_PROFILE
    from iqc_tpu_torch.train.train_yolo import DEFAULT_CONFIG, config_from_profile

    with open(os.path.join(REPO_ROOT, "config", "yolo_config.yaml")) as f:
        raw = yaml.safe_load(f)
    assert YOLO_TRAINING_PROFILE["training"] == raw["training"]
    assert YOLO_TRAINING_PROFILE["augmentation"] == raw["augmentation"]
    assert YOLO_TRAINING_PROFILE["qc_specific"]["class_weights"] == \
        raw["qc_specific"]["class_weights"]
    cfg = config_from_profile(raw)
    # the training block sets mosaic and mixup, so they stay in the block
    aug = {k: v for k, v in raw["augmentation"].items() if k != "copy_paste"}
    assert cfg == {**raw["training"], "class_weights": raw["qc_specific"]["class_weights"],
                   "augmentation": aug}
    assert config_from_profile(YOLO_TRAINING_PROFILE) == cfg
    assert set(cfg) - {"class_weights", "augmentation"} <= set(DEFAULT_CONFIG)
    assert math.isclose(cfg["mosaic"], 1.0)
