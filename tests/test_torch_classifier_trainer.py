"""The port's ResNet classifier trainer against the JAX package's on the CPU,
at stage_sizes [1,1,1,1], 32 px, batch 8, float32 (as tests/test_training.py
runs the JAX trainer): the loss, the train-mode forward with the head's
dropout, each optimizer and schedule, three steps of both data tiers with
Adam + cosine, the shipped augmentation block, class weights and balanced
sampling fed the JAX trainer's own draws (augmentation rebuilt from its
keys, dropout masks read from its Dropout modules), freezing, the plateau
schedule, evaluate and test, checkpoints both ways, and ``main``.

Tolerances (each test states its own):
- cross-entropy within 1e-6; the float32 train-mode forward's logits
  within 1e-5 (measured 2.4e-6) and its batch statistics within 1e-6;
  bfloat16 logits within 0.03 (measured 3.9e-3 on logits of magnitude 2.5:
  bfloat16 rounding of differently summed convolutions);
- one update of every optimizer and schedule, from the same state, within
  2 ulps of each parameter's magnitude;
- the steps: the first loss within 1e-5 relative (measured 4.1e-7); later
  steps within STEP_RTOL. Adam moves every parameter by about the learning
  rate after its first update, whatever its gradient, so rounding
  differences of the first backward flip the sign of near-zero updates and
  reach the later losses. The JAX trainer run op by op differs from its
  own jitted device-corpus epoch by 1.1e-5 / 2.9e-4 relative (steps 2 and
  3) and, after the 3 steps, by 1.7e-3 in a parameter, 1.5e-2 in a batch
  statistic, 2.1e-2 / 1.7e-4 in Adam's moments (``python
  tests/test_torch_classifier_trainer.py`` prints it). The port differs
  from the jitted epoch by 4.3e-6 / 7.3e-4 (steps 2 and 3; step 3 lies
  beyond that single op-by-op sample) and by 1.7e-3 / 1.5e-2 / 2.1e-2 /
  1.8e-4 in the state. Steps 2 and 3 are held within 2e-4 / 2e-3
  relative, the state within 2e-3 / 2e-2 / 3e-2 / 3e-4;
- evaluate and test: predictions, labels, accuracy, P/R/F1 and the
  confusion matrix equal, the loss within 1e-5, ROC-AUC within 1e-6."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from iqc_tpu.config import MeshConfig
from iqc_tpu.data import mvtec_synth as jsynth
from iqc_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from iqc_tpu.train import checkpoint as jckpt
from iqc_tpu.train import steps as jsteps
from iqc_tpu.train.train_resnet import ResNetTrainer as JaxTrainer
from iqc_tpu_torch import weights
from iqc_tpu_torch.config import RESNET_TRAINING_PROFILE
from iqc_tpu_torch.data.pipeline import ArrayDataset
from iqc_tpu_torch.train import steps
from iqc_tpu_torch.train.train_resnet import ResNetTrainer, main

from test_torch_classifier_data import jax_classifier_draws

torch.set_num_threads(2)

SIZE, BATCH = 32, 8
CFG = {"image_size": SIZE, "batch_size": BATCH, "stage_sizes": [1, 1, 1, 1], "epochs": 1,
       "compute_dtype": "float32",
       "augmentation": RESNET_TRAINING_PROFILE["augmentation"]["train"]}
COUNTS = (8, 6, 4, 3, 3)  # 24 images, unbalanced: 3 steps of 8
STEP_RTOL = (1e-5, 2e-4, 2e-3)
MESH = MeshConfig(data_parallel=1, model_parallel=1)


def _dataset():
    r = jsynth.MVTecStyleRenderer(size=SIZE, seed=5)
    labels = np.repeat(np.arange(5), COUNTS).astype(np.int32)
    images = np.stack([r.render(jsynth.DEFECT_TYPES[c], i)[0] for i, c in enumerate(labels)])
    return images, labels


def jax_dropout_masks(module, variables, rng, batch):
    """The keep masks the JAX module's two Dropouts draw with ``rng`` (a
    train-mode apply whose Dropouts see ones: nonzero where kept)."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(torch.from_numpy(np.asarray(out != 0)))
            return out
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        module.apply(variables, jnp.zeros((batch, SIZE, SIZE, 3)), train=True,
                     mutable=["batch_stats"], rngs={"dropout": rng})
    assert len(masks) == 2
    return tuple(masks)


def jax_step_draws(jt, variables, rng, batch):
    """The augmentation draws and dropout masks of the JAX trainer's step
    given ``rng`` (split into the augmentation's and the dropout's keys)."""
    ka, kd = jax.random.split(rng)
    aug = jax_classifier_draws(jax.random.split(ka, batch), SIZE, SIZE, jt._aug_cfg)
    return aug, jax_dropout_masks(jt.module, variables, kd, batch)


def _variables(state):
    return {"params": state.params, "batch_stats": state.batch_stats}


@pytest.fixture(scope="module")
def data():
    return _dataset()


def jax_trainer(data, tmp, **overrides):
    images, labels = data
    jt = JaxTrainer({**CFG, "checkpoint_dir": str(tmp), **overrides}, mesh_config=MESH)
    jt.setup_data(JaxArrayDataset(images, labels))
    jt.build(steps_per_epoch=3)
    return jt


def port_trainer(data, tmp, jt=None, **overrides):
    images, labels = data
    pt = ResNetTrainer({**CFG, "checkpoint_dir": str(tmp), **overrides}, device="cpu")
    pt.setup_data(ArrayDataset(images, labels))
    pt.build(steps_per_epoch=3)
    if jt is not None:
        pt.load_flax_state(jax.device_get(jt.state))
    return pt


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    jt = jax_trainer(data, tmp_path_factory.mktemp("jax"))
    return jt, jax.device_get(jt.state)


def check_state(pt, jax_state, atol):
    want = weights.train_state_from_flax(jax_state)
    assert pt.state.step == want["step"] and pt.state.opt_state.count == want["count"]
    got = {"params": pt.state.params, "batch_stats": pt.state.batch_stats,
           "mu": pt.state.opt_state.mu, "nu": pt.state.opt_state.nu}
    for part, tol in atol.items():
        assert set(got[part]) == set(want[part])
        err = max(float((got[part][k].detach() - want[part][k]).abs().max()) for k in got[part])
        assert err <= tol, f"{part} differs by {err}"


def check_losses(got, want):
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL[i], atol=0, err_msg=f"step {i + 1}")


# -- the loss and the forward ---------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_cross_entropy(smoothing, weighted):
    """softmax_cross_entropy within 1e-6 of the JAX package's (smoothing,
    then the per-sample class weight, then the plain mean)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (16, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 16).astype(np.int32)
    cw = rng.uniform(0.2, 3, 5).astype(np.float32) if weighted else None
    want = float(jsteps.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                              smoothing, None if cw is None else jnp.asarray(cw)))
    got = float(steps.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                            smoothing, None if cw is None else torch.from_numpy(cw)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 0.03)])
def test_train_mode_forward(data, jax_run, tmp_path, dtype, atol):
    """The train-mode forward with the JAX module's dropout masks: logits
    within ``atol`` (float32 1e-5, bfloat16 0.03) and the moved batch
    statistics within 1e-6 (float32)."""
    jt, s0 = jax_run
    images, _ = data
    x = ((images[:BATCH].astype(np.float32) / 255.0) - 0.45) / 0.25
    rng = jax.random.PRNGKey(3)
    module = jt.module.clone(dtype=jnp.bfloat16) if dtype == "bfloat16" else jt.module
    want, upd = module.apply(_variables(s0), jnp.asarray(x), train=True,
                             mutable=["batch_stats"], rngs={"dropout": rng})
    masks = jax_dropout_masks(module, _variables(s0), rng, BATCH)
    pt = port_trainer(data, tmp_path, jt, compute_dtype=dtype)
    pt.module.train()
    got = pt.module(torch.from_numpy(x), dropout_masks=masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)
    if dtype == "float32":
        moved = weights.from_flax({"batch_stats": jax.device_get(upd["batch_stats"])})
        for k, v in moved.items():
            np.testing.assert_allclose(pt.state.batch_stats[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


# -- the optimizers ---------------------------------------------------------------------


def _jax_optimizer(kind, sched):
    def make(learning_rate):
        if kind == "sgd":
            return optax.sgd(learning_rate, momentum=0.9, nesterov=True)
        if kind == "adamw":
            return optax.adamw(learning_rate, weight_decay=1e-4)
        return optax.chain(optax.add_decayed_weights(1e-4), optax.adam(learning_rate))

    if sched == "plateau":
        return optax.inject_hyperparams(make)(learning_rate=1e-3)
    return make({"cosine": optax.cosine_decay_schedule(1e-3, 7),
                 "step": optax.exponential_decay(1e-3, 2, 0.1, staircase=True),
                 "none": 1e-3}[sched])


def _port_optimizer(kind, sched):
    wd = 0.0 if kind == "sgd" else 1e-4
    if sched == "plateau":
        return steps.Optimizer(kind, None, wd)
    if sched == "none":
        return steps.Optimizer(kind, steps.constant_schedule(1e-3), wd, scheduled=False)
    return steps.Optimizer(kind, {"cosine": steps.cosine_decay_schedule(1e-3, 7),
                                  "step": steps.exponential_decay(1e-3, 2, 0.1)}[sched], wd)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sched", ["cosine", "step", "none", "plateau"])
@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_optimizer_updates(kind, sched, masked):
    """Three updates of each optimizer under each schedule (with and without
    a mask freezing one leaf): each within 2 ulps of the parameter's
    magnitude of optax's jitted update; the frozen leaf bitwise unchanged;
    the state's layout (``save_train_state``'s tree) equal to optax's."""
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(0, 1, (64, 33)).astype(np.float32),
         "b": rng.normal(0, 1e-2, (700,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32) for k, v in p.items()}
             for s in (1e-2, 1e-3, 1e-4)]
    opt = _jax_optimizer(kind, sched)
    if masked:
        opt = optax.chain(opt, jsteps.masked_updates())
    jst = opt.init(p)
    if masked:
        jst = jsteps.set_update_mask(jst, {"a": jnp.float32(0.0), "b": jnp.float32(1.0)})

    @jax.jit
    def update(params, g, st):
        u, st = opt.update(g, st, params)
        return optax.apply_updates(params, u), st

    topt = _port_optimizer(kind, sched)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tst = topt.init(tp, masked=masked, plateau_lr=1e-3 if sched == "plateau" else None)
    if masked:
        tst = steps.set_update_mask(tst, {"a": 0.0, "b": 1.0})
    jp = p
    for g in grads:
        # one update each from the same state: optax's, carried into the port
        leaves = weights._optax_leaves(jax.device_get(jst))
        with torch.no_grad():
            for k in p:
                tp[k].copy_(torch.from_numpy(np.asarray(jp[k])))
                for leaf in ("mu", "nu", "trace"):
                    if getattr(tst, leaf) is not None:
                        getattr(tst, leaf)[k].copy_(torch.from_numpy(np.asarray(leaves[leaf][k])))
        before = {k: np.asarray(v) for k, v in jp.items()}
        jp, jst = update(jp, g, jst)
        tst = topt.update(tp, {k: torch.tensor(v) for k, v in g.items()}, tst)
        for k in p:
            want, got = np.asarray(jp[k]), tp[k].numpy()
            ulp = np.spacing(np.maximum(np.abs(before[k]), np.abs(want)))
            assert np.all(np.abs(got - want) <= 2 * ulp), (k, np.max(np.abs(got - want) / ulp))
    if masked:
        assert np.array_equal(tp["a"].numpy(), p["a"])
    assert tst.count == 3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sched", ["cosine", "none", "plateau"])
@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_train_state_layout_is_optax(kind, sched, masked, tmp_path):
    """The port's train-state checkpoint tree of each optimizer has the JAX
    trainer's keys and leaf shapes (its optax state included)."""
    from flax import serialization

    from iqc_tpu_torch.models.resnet import ResNet50
    from iqc_tpu_torch.train.checkpoint import _train_state_tree

    module = ResNet50(stage_sizes=(1, 1, 1, 1))
    opt = _port_optimizer(kind, sched)
    state = steps.module_state(module, opt.init(dict(module.named_parameters()), masked=masked,
                                                plateau_lr=1e-3 if sched == "plateau" else None))
    jt = JaxTrainer({**CFG, "optimizer": kind, "scheduler": sched, "freeze_backbone": masked,
                     "checkpoint_dir": str(tmp_path)}, mesh_config=MESH)
    jt.build(steps_per_epoch=2)
    want = serialization.to_state_dict(tuple(jax.device_get(jt.state)))
    shapes = lambda tree: {k: np.shape(v) for k, v in weights.flatten(tree).items()}
    assert shapes(_train_state_tree(module, state)) == shapes(want)


# -- three steps of each tier -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_corpus_steps(data, jax_run):
    """The JAX trainer's device-corpus epoch 0 (one scanned dispatch): its
    per-step losses and state, and each step's draws."""
    jt, s0 = jax_run
    corpus = jt._maybe_device_corpus()
    assert corpus is not None
    labels = np.asarray(jt.train_ds.labels)
    idx = jt_idx = None
    from iqc_tpu.data.pipeline import balanced_sample_indices

    idx = balanced_sample_indices(labels, 3 * BATCH, np.random.default_rng(CFG.get("seed", 42)))
    jt_idx = idx.reshape(3, BATCH).astype(np.int32)
    base = jax.random.PRNGKey(17)
    st, ms = jt._epoch_fn(jax.device_put(s0), corpus[0], corpus[1], jnp.asarray(jt_idx), base,
                          jt._class_weights)
    # each step's draws, from the state that step starts from
    draws, state = [], jax.device_put(s0)
    for i in range(3):
        rng = jax.random.fold_in(base, i)
        draws.append(jax_step_draws(jt, _variables(state), rng, BATCH))
        state, _ = jax.jit(jt._raw_step)(state, corpus[0][jt_idx[i]], corpus[1][jt_idx[i]], rng,
                                         jt._class_weights)
    return [float(v) for v in np.asarray(ms["loss"])], jax.device_get(st), draws, jt_idx


def test_device_corpus_tier(data, jax_run, jax_corpus_steps, tmp_path):
    """The device-resident corpus, epoch 0 (balanced indices from
    default_rng(seed + 0), as both trainers draw them): per-step losses
    within STEP_RTOL of the JAX trainer's scanned epoch; the state after it
    (parameters within 2e-3, statistics within 2e-2, Adam's moments within
    3e-2 / 3e-4: the JAX trainer's own op-by-op spread, rounded up) with
    the step and count equal."""
    jt, _ = jax_run
    want, state, draws, idx = jax_corpus_steps
    pt = port_trainer(data, tmp_path, jt)
    assert np.array_equal(pt.epoch_indices(0), idx)
    pt.draw_hook = lambda step, b: draws[step]
    corpus = pt._maybe_device_corpus()
    assert corpus is not None
    pt._finish_epoch(pt._corpus_epoch(corpus, idx), 0.0)
    check_losses([m["loss"] for m in pt.step_metrics], want)
    check_state(pt, state, {"params": 2e-3, "batch_stats": 2e-2, "mu": 3e-2, "nu": 3e-4})


def test_streaming_tier(data, jax_run, tmp_path):
    """Streaming (the loader's balanced batches from default_rng(seed), one
    upload per step): per-step losses within STEP_RTOL of the JAX trainer's
    jitted step on the same batches and draws."""
    jt, s0 = jax_run
    batches = list(jt.train_loader)
    rng, state, want, draws = jt.rng, jax.device_put(s0), [], []
    for b in batches:
        rng, step_rng = jax.random.split(rng)
        draws.append(jax_step_draws(jt, _variables(state), step_rng, BATCH))
        state, m = jt._train_step(state, jnp.asarray(b["images"]), jnp.asarray(b["labels"]),
                                  step_rng, jt._class_weights)
        want.append(float(m["loss"]))
    pt = port_trainer(data, tmp_path, jt)
    pt.draw_hook = lambda step, b: draws[step]
    assert pt._maybe_device_corpus() is not None  # both tiers are open: stream explicitly
    pt._finish_epoch(pt._stream_epoch(), 0.0)
    check_losses([m["loss"] for m in pt.step_metrics], want)


def test_port_draws_drive_a_whole_epoch(data, tmp_path):
    """Without a hook the trainer draws its own augmentation and dropout
    (seeded by (seed, step)): two trainers give the same losses; train()
    writes its artifacts and reports."""
    runs = []
    for i in range(2):
        pt = port_trainer(data, tmp_path / str(i))
        pt.setup_data(ArrayDataset(*data), ArrayDataset(*data))
        runs.append(pt.train(epochs=1))
        runs[-1]["steps"] = [m["loss"] for m in pt.step_metrics]
    assert runs[0]["steps"] == runs[1]["steps"] and len(runs[0]["steps"]) == 3
    assert np.isfinite(runs[0]["final_metrics"]["val_loss"])
    for f in ("history.json", "scalars.csv", "training_report.json", "best_model.msgpack"):
        assert os.path.exists(tmp_path / "0" / f)


# -- freezing and the plateau schedule ------------------------------------------------


def test_freezing_and_gradual_unfreezing(data, tmp_path):
    """freeze_backbone with an unfreeze_schedule: the trainable prefixes per
    epoch equal the JAX trainer's; in epoch 0 the stem and stages 1-3 stay
    bitwise unchanged while stage 4 and the head move; from epoch 1 stage 3
    moves too."""
    sched = [{"epoch": 1, "layers": ["layer3"]}]
    # over 3 epochs: the cosine rate is still above 0 in epoch 1
    jt = jax_trainer(data, tmp_path / "j", freeze_backbone=True, unfreeze_schedule=sched)
    pt = port_trainer(data, tmp_path / "p", freeze_backbone=True, unfreeze_schedule=sched,
                      augmentation=None, epochs=3)
    for epoch in range(3):
        assert pt._trainable_prefixes(epoch) == jt._trainable_prefixes(epoch)
    for epoch, moving in ((0, ("stage4", "head")), (1, ("stage3", "stage4", "head"))):
        before = {k: v.detach().clone() for k, v in pt.state.params.items()}
        pt.train_epoch(epoch)
        for k, v in pt.state.params.items():
            same = torch.equal(v, before[k])
            assert same != k.startswith(moving), (epoch, k)


def test_plateau_lowers_the_rate(data, tmp_path):
    """The plateau schedule: the rate is a float32 leaf of the state; the
    controller lowers it after ``plateau_patience`` epochs without a lower
    validation loss; the next update uses the lowered rate; a saved state
    carries it to the JAX trainer."""
    pt = port_trainer(data, tmp_path, scheduler="plateau", plateau_patience=0, gamma=0.5,
                      augmentation=None)
    assert pt.current_learning_rate() == np.float32(1e-3)
    assert pt._plateau.step(1.0) == 1e-3
    new = pt._plateau.step(1.5)
    assert new == 5e-4
    pt.set_learning_rate(new)
    assert pt.current_learning_rate() == float(np.float32(5e-4))
    assert pt.optimizer.learning_rate(pt.state.opt_state) == float(np.float32(5e-4))
    pt.train_epoch(0)
    path = str(tmp_path / "state.msgpack")
    pt.save_full(path)
    jt = jax_trainer(data, tmp_path / "j", scheduler="plateau")
    jt.resume(path)
    assert jt.current_learning_rate() == pt.current_learning_rate()
    assert int(jt.state.step) == 3


# -- evaluation ------------------------------------------------------------------------


def test_evaluate_and_test(data, jax_run, tmp_path):
    """evaluate and test of the same weights over a validation and a test
    set: loss within 1e-5, accuracy, P/R/F1, per-class figures and the
    confusion matrix equal, ROC-AUC within 1e-6."""
    jt, s0 = jax_run
    images, labels = data
    val = (images[::-1].copy(), labels[::-1].copy())
    jt.val_ds = jt.test_ds = JaxArrayDataset(*val)
    from iqc_tpu.data.pipeline import DataLoader as JaxLoader

    want = jt.evaluate(JaxLoader(jt.val_ds, BATCH, shuffle=False, drop_last=False))
    want_test = jt.test(str(tmp_path))
    pt = port_trainer(data, tmp_path, jt)
    pt.setup_data(ArrayDataset(*data), ArrayDataset(*val), ArrayDataset(*val))
    got = pt.evaluate(pt.val_loader)
    got_test = pt.test(str(tmp_path))
    assert abs(got.pop("loss") - want.pop("loss")) <= 1e-5
    assert got == want
    aucs = (got_test.pop("roc_auc"), want_test.pop("roc_auc"))
    assert got_test == want_test
    for k in aucs[1]:
        assert abs(aucs[0][k] - aucs[1][k]) <= 1e-6


# -- checkpoints ------------------------------------------------------------------------


def test_checkpoints_both_ways(data, jax_run, jax_corpus_steps, tmp_path):
    """save_full of each package resumes in the other with the whole state
    (step, weights, statistics, Adam's count and moments) equal; a weights-
    only file of each loads in the other, and resumes with a fresh
    optimizer."""
    jt, _ = jax_run
    _, state, _, _ = jax_corpus_steps
    jt2 = jax_trainer(data, tmp_path / "j")
    jt2.state = jax.device_put(state)
    jpath = str(tmp_path / "jax_full.msgpack")
    jt2.save_full(jpath, epoch=4)
    pt = port_trainer(data, tmp_path / "p")
    pt.resume(jpath)
    assert pt.start_epoch == 4
    check_state(pt, state, {"params": 0, "batch_stats": 0, "mu": 0, "nu": 0})
    ppath = str(tmp_path / "port_full.msgpack")
    pt.save_full(ppath, epoch=5)
    jt3 = jax_trainer(data, tmp_path / "j3")
    jt3.resume(ppath)
    assert jt3.start_epoch == 5
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jt3.state)),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # weights only: the JAX package's file into the port and the reverse
    jw, pw = str(tmp_path / "jax_w.msgpack"), str(tmp_path / "port_w.msgpack")
    jt2.save(jw)
    pt.save(pw)
    pt2 = port_trainer(data, tmp_path / "p2")
    pt2.resume(jw)
    assert pt2.state.opt_state.count == 0
    for k, v in weights.from_flax(jckpt.load_variables(jw, jt2.variables())).items():
        np.testing.assert_array_equal(pt2.module.state_dict()[k].numpy(), v.numpy())
    loaded = jckpt.load_variables(pw, jax.device_get(jt2.variables()))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(jax.device_get(jt2.variables()))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- set-up ----------------------------------------------------------------------------


def test_architectures_and_refusals(tmp_path):
    """resnet101's stages as the JAX trainer's; another architecture, a mesh
    of more than one device in a process that no launcher started (more
    ranks than the group has), and a card where there is none are
    refused."""
    for arch in ("resnet50", "resnet101"):
        pt = ResNetTrainer({"architecture": arch, "checkpoint_dir": str(tmp_path)}, device="cpu")
        assert pt.config["stage_sizes"] == list(JaxTrainer.ARCHITECTURES[arch])
        assert len(pt.module.blocks) == sum(JaxTrainer.ARCHITECTURES[arch])
    with pytest.raises(ValueError, match="Unsupported architecture: vgg16"):
        ResNetTrainer({"architecture": "vgg16"}, device="cpu")
    with pytest.raises(ValueError, match="more ranks than the group has"):
        ResNetTrainer({"checkpoint_dir": str(tmp_path)}, device="cpu",
                      mesh_config=MeshConfig(data_parallel=2, model_parallel=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ResNetTrainer({"checkpoint_dir": str(tmp_path)})


def test_fresh_init_has_zero_bn3_and_flax_layout(tmp_path):
    """A fresh port network: every bn3 scale 0 (as the JAX module's
    scale_init), other scales 1, and a variables tree with the JAX
    module's keys and shapes."""
    pt = ResNetTrainer({**CFG, "checkpoint_dir": str(tmp_path)}, device="cpu")
    pt.build(steps_per_epoch=1)
    jt = JaxTrainer({**CFG, "checkpoint_dir": str(tmp_path)}, mesh_config=MESH)
    jv = jax.device_get(jt.module.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                       train=False))
    flat = lambda tree: {k: np.shape(v) for k, v in weights.flatten(tree).items()}
    assert flat(pt.variables()) == flat(jv)
    for name in pt.module.blocks:
        block = getattr(pt.module, name)
        assert float(block.bn3.weight.abs().max()) == 0.0
        assert float(block.bn1.weight.min()) == 1.0


def test_main_on_an_image_folder_tree(tmp_path, capsys):
    """``main`` on the CPU over a written 32 px image-folder tree (train,
    val, test) with the profile's augmentation: one epoch, a report with the
    test split, no kernel launched, and a final checkpoint the JAX package
    loads."""
    from iqc_tpu_torch.data.mvtec_synth import MVTecStyleRenderer
    from iqc_tpu_torch.runtime.codec import write_png

    r = MVTecStyleRenderer(size=40, seed=2)
    names = ("crack", "scratch", "dent", "discoloration", "contamination")
    i = 0
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        for c in names:
            os.makedirs(tmp_path / "data" / split / c)
            for k in range(n):
                write_png(str(tmp_path / "data" / split / c / f"{k}.png"), r.render(c, i)[0])
                i += 1
    profile = {"training": {**{k: v for k, v in CFG.items() if k != "augmentation"},
                            "checkpoint_dir": str(tmp_path / "ckpt")},
               "augmentation": RESNET_TRAINING_PROFILE["augmentation"]}
    (tmp_path / "profile.json").write_text(json.dumps(profile))
    main(["--data-dir", str(tmp_path / "data"), "--config", str(tmp_path / "profile.json"),
          "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train"]["epochs_trained"] == 1
    assert len(out["test"]["confusion_matrix"]) == 5
    assert not any(out["kernel_launches"].values())
    jt = JaxTrainer({**CFG, "checkpoint_dir": str(tmp_path)}, mesh_config=MESH)
    template = jax.device_get(jt.module.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    jckpt.load_variables(str(tmp_path / "ckpt" / "final_model.msgpack"), template)


if __name__ == "__main__":
    # The JAX trainer's own spread: its device-corpus steps op by op against
    # its jitted scanned epoch (relative, per step).
    import tempfile

    data = _dataset()
    jt = jax_trainer(data, tempfile.mkdtemp())
    s0 = jax.device_get(jt.state)
    corpus = jt._maybe_device_corpus()
    from iqc_tpu.data.pipeline import balanced_sample_indices

    idx = balanced_sample_indices(np.asarray(jt.train_ds.labels), 3 * BATCH,
                                  np.random.default_rng(42)).reshape(3, BATCH).astype(np.int32)
    base = jax.random.PRNGKey(17)
    st_jit, ms = jt._epoch_fn(jax.device_put(s0), corpus[0], corpus[1], jnp.asarray(idx), base,
                              jt._class_weights)
    jitted = np.asarray(ms["loss"])
    state, eager = jax.device_put(s0), []
    with jax.disable_jit():
        for i in range(3):
            state, m = jt._raw_step(state, corpus[0][idx[i]], corpus[1][idx[i]],
                                    jax.random.fold_in(base, i), jt._class_weights)
            eager.append(float(m["loss"]))
    print("jitted", jitted.tolist())
    print("op by op", eager)
    print("relative spread per step", (np.abs(np.asarray(eager) - jitted) / np.abs(jitted)).tolist())
    a = weights.train_state_from_flax(jax.device_get(state))
    b = weights.train_state_from_flax(jax.device_get(st_jit))
    for part in ("params", "batch_stats", "mu", "nu"):
        print(part, "max abs spread after 3 steps",
              max(float((a[part][k] - b[part][k]).abs().max()) for k in a[part]))
