"""The port's YOLOv8 training pieces against the JAX package's on the CPU:
boxes and CIoU, task-aligned assignment, DFL and the total loss with its
gradients, the train-mode network and its BatchNorm statistics, the frozen
module sets, the learning-rate schedule, the optimizer chain and the EMA
ramp. Inputs come from seeded numpy; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iqc_tpu.ops import boxes as jboxes
from iqc_tpu.ops.nms import make_anchors as jax_make_anchors
from iqc_tpu.train import steps as jsteps
from iqc_tpu.train import yolo_loss as jl
from iqc_tpu_torch import weights
from iqc_tpu_torch.ops import boxes as tboxes
from iqc_tpu_torch.train import steps as tsteps
from iqc_tpu_torch.train import yolo_loss as tl

REG_MAX, C, M = 8, 5, 4


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def anchors():
    a, s = jax_make_anchors([(8, 8), (4, 4), (2, 2)], [8, 16, 32])
    return np.asarray(a), np.asarray(s)


def random_boxes(rng, shape, lo=0.0, hi=60.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(1.0, 30.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_ciou_pairwise_iou_and_conversions():
    """ciou, _pairwise_iou, xywh<->xyxy and clamp_boxes within 1e-6."""
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, (3, 50)), random_boxes(rng, (3, 50))
    np.testing.assert_allclose(tboxes.ciou(t(a), t(b)).numpy(), np.asarray(jboxes.ciou(a, b)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl._pairwise_iou(t(a[0, :6]), t(b[0])).numpy(),
                               np.asarray(jl._pairwise_iou(a[0, :6], b[0])), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tboxes.xywh_to_xyxy(t(a)).numpy(),
                               np.asarray(jboxes.xywh_to_xyxy(a)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tboxes.xyxy_to_xywh(t(a)).numpy(),
                               np.asarray(jboxes.xyxy_to_xywh(a)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tboxes.clamp_boxes(t(a - 10), 48, 40).numpy(),
                               np.asarray(jboxes.clamp_boxes(a - 10, 48, 40)), rtol=0, atol=1e-6)


def _assign_case(name, anchors):
    """(pred_boxes [B,A,4], pred_scores [B,A,C], gt boxes, classes, valid)."""
    an = anchors[0]
    a = an.shape[0]
    rng = np.random.default_rng(7)
    centred = np.concatenate([an - 8.0, an + 8.0], -1)[None].repeat(2, 0).astype(np.float32)
    if name == "random":
        pb = np.concatenate([an - rng.uniform(2, 20, (2, a, 2)),
                             an + rng.uniform(2, 20, (2, a, 2))], -1).astype(np.float32)
        ps = rng.uniform(0.001, 0.9, (2, a, C)).astype(np.float32)
        gb = np.array([[[8, 8, 30, 30], [40, 12, 60, 40], [5, 30, 50, 62], [0, 0, 0, 0]],
                       [[2, 2, 20, 40], [10, 10, 60, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                      np.float32)
        gv = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    elif name == "no_valid_gt":
        pb, ps = centred, np.full((2, a, C), 0.5, np.float32)
        gb = random_boxes(rng, (2, M))
        gv = np.zeros((2, M), bool)
    elif name == "gt_without_anchor":
        # a 3 px box between anchor centres: no anchor lies inside it
        pb, ps = centred, np.full((2, a, C), 0.5, np.float32)
        gb = np.array([[[1, 1, 3, 3], [10, 10, 40, 40], [0, 0, 0, 0], [0, 0, 0, 0]]] * 2,
                      np.float32)
        gv = np.array([[1, 1, 0, 0]] * 2, bool)
    elif name == "ties":
        # identical predictions everywhere: every candidate anchor ties
        pb, ps = centred, np.full((2, a, C), 0.5, np.float32)
        gb = np.array([[[2, 2, 62, 62], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]] * 2,
                      np.float32)
        gv = np.array([[1, 0, 0, 0]] * 2, bool)
    else:  # "tiny": score^0.5 * iou^6 ~ 1e-14
        pb = np.concatenate([an - 1.0, an + 2.0], -1)[None].repeat(2, 0).astype(np.float32)
        ps = np.full((2, a, C), 1e-5, np.float32)
        gb = np.array([[[8, 8, 40, 40], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]] * 2,
                      np.float32)
        gv = np.array([[1, 0, 0, 0]] * 2, bool)
    gc = rng.integers(0, C, (2, M)).astype(np.int32)
    return pb, ps, gb, gc, gv


@pytest.mark.parametrize("case", ["random", "no_valid_gt", "gt_without_anchor", "ties", "tiny"])
def test_assign_targets(anchors, case):
    """fg, gt_index and target_class exactly equal; target_box and
    target_score within 1e-6."""
    pb, ps, gb, gc, gv = _assign_case(case, anchors)
    cfg = jl.YoloLossConfig()
    want = jax.vmap(lambda p, s, g, c, v: jl.assign_targets(p, s, anchors[0], g, c, v, cfg))(
        pb, ps, gb, gc, gv)
    got = tl.assign_targets(t(pb), t(ps), t(anchors[0]), t(gb), t(gc), t(gv), tl.YoloLossConfig())
    for k in ("fg", "gt_index", "target_class"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("target_box", "target_score"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    if case == "ties":
        assert got["fg"].sum(-1).tolist() == [cfg.tal_topk] * 2
    if case == "tiny":
        assert got["fg"].any()
    if case == "no_valid_gt":
        assert not got["fg"].any()


def test_dfl_loss(anchors):
    """dfl_loss within 1e-5 relative."""
    rng = np.random.default_rng(3)
    a = anchors[0].shape[0]
    dist = rng.normal(0, 2, (a, 4 * REG_MAX)).astype(np.float32)
    target = rng.uniform(-1, REG_MAX + 1, (a, 4)).astype(np.float32)
    np.testing.assert_allclose(tl.dfl_loss(t(dist), t(target), REG_MAX).numpy(),
                               np.asarray(jl.dfl_loss(dist, target, REG_MAX)), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_yolo_loss_and_gradients(anchors, weighted):
    """Total and parts within 1e-5 relative; the gradients with respect to
    both logit tensors within 1e-5 of their largest magnitude."""
    an, st = anchors
    a = an.shape[0]
    rng = np.random.default_rng(0)
    dist = rng.normal(0, 1, (2, a, 4 * REG_MAX)).astype(np.float32)
    cls = rng.normal(-4, 1, (2, a, C)).astype(np.float32)
    gb = np.array([[[8, 8, 30, 30], [40, 12, 60, 40], [0, 0, 0, 0], [0, 0, 0, 0]],
                   [[3, 20, 50, 44], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    gc = np.array([[1, 2, 0, 0], [4, 0, 0, 0]], np.int32)
    gv = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    cw = np.array([1.2, 1.0, 1.5, 0.8, 1.1], np.float32) if weighted else None

    def jloss(d, c):
        return jl.yolo_loss(d, c, an, st, gb, gc, gv, REG_MAX,
                            class_weights=None if cw is None else jnp.asarray(cw))

    (jtotal, jparts), (gd, gcl) = (jloss(dist, cls),
                                   jax.grad(lambda d, c: jloss(d, c)[0], argnums=(0, 1))(dist, cls))
    d, c = t(dist).requires_grad_(), t(cls).requires_grad_()
    total, parts = tl.yolo_loss(d, c, t(an), t(st), t(gb), t(gc), t(gv), REG_MAX,
                                class_weights=None if cw is None else t(cw))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]), rtol=1e-5, err_msg=k)
    for got, want in ((d.grad.numpy(), np.asarray(gd)), (c.grad.numpy(), np.asarray(gcl))):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- the network in training mode ----------------------------------------------------


@pytest.fixture(scope="module")
def tiny_yolo():
    from iqc_tpu.models.yolo import YOLOv8 as JYOLOv8

    kw = dict(num_classes=C, width_mult=0.125, depth_mult=0.334, reg_max=REG_MAX)
    init = jax.jit(lambda key, x: JYOLOv8(**kw).init(key, x, train=False))
    return kw, jax.device_get(init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_forward_and_batch_stats(tiny_yolo, dtype):
    """Train-mode YOLOv8 from the same carried-across weights. float32:
    logits within 1e-5 of their largest magnitude, the new batch_stats
    within 1e-6 (absolute; measured 8.3e-6 and 1.8e-7). bfloat16 (measured
    2.3e-2 and 4.7e-4): logits within 3e-2 of their largest magnitude and
    the batch_stats within 2e-3, bfloat16 rounding spreading with depth
    (each op rounds to 8 bits)."""
    from iqc_tpu.models.yolo import YOLOv8 as JYOLOv8
    from iqc_tpu_torch.models.yolo import YOLOv8

    kw, variables = tiny_yolo
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    def apply(v, x):
        return JYOLOv8(**kw, dtype=jdt).apply(v, x, train=True, mutable=["batch_stats"])

    # bfloat16 op by op: a jitted bfloat16 chain on the CPU keeps float32
    # precision (XLA's excess precision), where every op of the port rounds
    (jd, jc), upd = (jax.jit(apply) if dtype == "float32" else apply)(variables, x)
    module = YOLOv8(**kw, dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    weights.load_into(module, variables)
    module.train()
    with torch.no_grad():
        td, tc = module(t(x))
    logit_tol, stat_tol = (1e-5, 1e-6) if dtype == "float32" else (3e-2, 2e-3)
    for got, want in ((td, jd), (tc, jc)):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= logit_tol * np.abs(want).max()
    want_stats = weights.from_flax({"batch_stats": jax.device_get(upd["batch_stats"])})
    got_stats = {k: v for k, v in module.state_dict().items() if k.endswith(("mean", "var"))}
    assert set(got_stats) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), v.numpy(), rtol=0, atol=stat_tol,
                                   err_msg=k)


@pytest.mark.parametrize("stem", ["conv", "s2d"])
@pytest.mark.parametrize("n", [0, 3, 10, 12])
def test_frozen_modules_sets(stem, n):
    """frozen_modules equals the JAX package's set."""
    from iqc_tpu.train.train_yolo import frozen_modules as jfrozen
    from iqc_tpu_torch.models.yolo import YOLOv8
    from iqc_tpu_torch.train.train_yolo import frozen_modules

    module = YOLOv8(width_mult=0.125, stem_mode=stem)
    keys = {k.split(".")[0] for k, _ in module.named_parameters()}
    assert frozen_modules(keys, n) == jfrozen(list(keys), n)


def test_init_weights_flax_defaults():
    """init_weights: BatchNorm at identity, the class prior -4.6 on every
    cls_out bias, other biases 0, kernels within two standard deviations of
    1/sqrt(fan_in) with that variance (within 15%)."""
    from iqc_tpu_torch.models.yolo import YOLOv8, init_weights

    module = YOLOv8(width_mult=0.125, reg_max=REG_MAX)
    init_weights(module, 0)
    for name, p in module.named_parameters():
        if name.endswith("cls_out.bias"):
            assert torch.all(p == -4.6)
        elif name.endswith("bias"):
            assert torch.all(p == 0)
        elif p.dim() == 1:
            assert torch.all(p == 1)
        else:
            std = p[0].numel() ** -0.5
            assert float(p.abs().max()) <= 2 * std / 0.8796256 + 1e-6
            if p.numel() >= 2000:
                assert abs(float(p.std()) / std - 1) < 0.15


# -- schedule, optimizer, EMA ----------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,total,end", [(0.01, 48, 1600, 0.01), (0.01, 3, 10, 0.01),
                                                 (0.02, 1, 37, 0.2)])
def test_warmup_cosine_schedule(lr, warmup, total, end):
    """At every step 0..total (and one past) within two float32 ulps of the
    JAX package's schedule compiled by XLA, and bit for bit equal on all
    but 1% of the steps (XLA's float32 cos is not correctly rounded, and it
    fuses the last multiply-add; the port takes cos in float64)."""
    jfn = jax.jit(jsteps.warmup_cosine_schedule(lr, warmup, total, end))
    tfn = tsteps.warmup_cosine_schedule(lr, warmup, total, end)
    want = np.array([float(jfn(s)) for s in range(total + 2)], np.float32)
    got = np.array([tfn(s) for s in range(total + 2)], np.float32)
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2 and (ulps > 0).mean() <= 0.01


@pytest.mark.parametrize("masked", [False, True])
def test_optimizer_three_updates(tiny_yolo, masked):
    """Three updates of add_decayed_weights -> sgd(nesterov) (-> mask) on
    the tiny YOLOv8's parameter tree with seeded gradients: each parameter
    and momentum trace leaf within 1e-7, or one float32 ulp of its largest
    magnitude where that is larger (the port fuses the multiply-adds as XLA
    does; a few leaves still differ by an ulp), the count
    equal, and masked (frozen) leaves bitwise unchanged."""
    from iqc_tpu.train.steps import masked_updates, set_update_mask

    _, variables = tiny_yolo
    params = variables["params"]
    schedule_j = jsteps.warmup_cosine_schedule(0.01, 2, 6, 0.01)
    opt = optax.chain(optax.add_decayed_weights(5e-4),
                      optax.sgd(schedule_j, momentum=0.937, nesterov=True))
    if masked:
        opt = optax.chain(opt, masked_updates())
    state_j = opt.init(params)
    names = weights.flax_named(params)
    mask = {k: (0.0 if k.startswith(("stem", "down2", "c2f_2")) else 1.0) for k in names}
    if masked:
        state_j = set_update_mask(state_j, _mask_tree(params, mask))
    p_t = {k: v.clone() for k, v in names.items()}
    state_t = tsteps.sgd_init(p_t, masked=masked)
    if masked:
        state_t = tsteps.set_update_mask(state_t, mask)
    schedule_t = tsteps.warmup_cosine_schedule(0.01, 2, 6, 0.01)
    rng = np.random.default_rng(5)
    p_j = params
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), params)
        u, state_j = update(grads, state_j, p_j)
        p_j = optax.apply_updates(p_j, u)
        state_t = tsteps.sgd_update(p_t, weights.flax_named(grads), state_t, schedule_t,
                                    0.937, 5e-4)
    want_p = weights.flax_named(jax.device_get(p_j))
    leaves = weights._optax_leaves(jax.device_get(state_j))
    want_trace = weights.flax_named(leaves["trace"])
    assert int(leaves["count"]) == state_t.count == 3
    for k in names:
        for got, want in ((p_t[k].numpy(), want_p[k].numpy()),
                          (state_t.trace[k].numpy(), want_trace[k].numpy())):
            assert np.abs(got - want).max() <= max(1e-7, np.spacing(np.abs(want).max())), k
        if masked and mask[k] == 0.0:
            assert torch.equal(p_t[k], names[k])


def _mask_tree(params, mask):
    """A Flax-shaped tree of 0-d float32 mask values over ``params``."""
    leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    values = []
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        values.append(jnp.asarray(mask[".".join(keys[:-1] + [leaf_name[keys[-1]]])],
                                  jnp.float32))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), values)


@pytest.mark.parametrize("decay", [0.9999, 0.995, 0.9])
def test_ema_ramp(decay):
    """ema_decay_at within 1.2e-7 (one float32 ulp of exp near 1) of the
    JAX package's ramp d*(1-exp(-(step+1)/tau)) compiled by XLA at steps
    0..2999: XLA's float32 exp is not correctly rounded and the port's is,
    and 1 - exp cancels the leading digits."""
    tau = min(2000.0, 1.0 / max(1.0 - decay, 1e-6))
    f = jax.jit(jax.vmap(lambda st: decay * (1.0 - jnp.exp(-(st.astype(jnp.float32) + 1.0) / tau))))
    want = np.asarray(f(jnp.arange(3000, dtype=jnp.int32)), np.float32)
    got = np.array([tsteps.ema_decay_at(s, decay) for s in range(3000)], np.float32)
    assert np.abs(got - want).max() <= 1.2e-7
