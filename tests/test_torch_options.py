"""The options the JAX package serves beyond the shipped profile, in the port
against ``iqc_tpu`` on the same numpy inputs: the denoise and contrast
preprocessing, weight-only int8 storage, magnitude pruning, the msgpack
writer, the v1 int8 YOLO walk, and the detector under each of them.

The detectors: one JAX ``QualityControlDetector`` in a child process (with
``XLA_FLAGS=--xla_allow_excess_precision=false``, so that its bfloat16
chains round every op as the port does; ``test_torch_precision.py``) serves
two settings on the YOLOv8n checkpoint at 128^2 with a tiny ResNet:
- A: weight-only int8 YOLO (``edge.yolo_int8: false``, float32 compute),
  ``denoise`` and ``enhance_contrast``;
- B: the v1 int8 YOLO walk (``edge.yolo_int8_stream: false``, bfloat16
  compute), structured pruning at 0.05 (at 0.15 and above, with A's
  preprocessing, the pruned detector finds nothing on these frames; the
  JAX package prunes op by op, slowest for the unstructured kind, which the
  pruning tests below cover).
Between them only its predictor and preprocessing are rebuilt. The port's
detector under each setting serves the JAX detector's quantized networks
(``int8_state``) and is held to the JAX answers with the tolerances of
``test_torch_precision.py`` (decisions equal, pixel boxes within 1 px).

Tolerances of the pieces (measured in brackets):
- bilateral filter, CLAHE and the contrast step against the jitted JAX
  functions: 2e-6 absolute (2.4e-7, 2.1e-7, 3.0e-7). XLA's ``cumsum`` and
  ``exp`` on the CPU round differently from PyTorch's (by up to 2 ulp of
  the CLAHE CDF), so these are not bit-equal. Denoise then contrast: a
  pixel whose filtered luma sits on a CLAHE bin edge can take the next
  bin's mapping: at most 0.1% of the values beyond 2e-6, each within 0.05
  (3 of 55,296, 0.0141);
- weight-only int8 codes and scales, pruning masks and reports, the int8
  trees of ``quantize_yolo``, the msgpack bytes: EQUAL;
- the v1 walk against the op-by-op JAX forward: every int8 code, int32
  accumulator and dynamic scale EQUAL; logits within 1e-5 of their largest
  magnitude (1.3e-7).
"""

import copy
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from test_torch_precision import _compare, _strip
from test_torch_slice import SIZE, YOLO_CKPT, _images

from iqc_tpu.config import SystemConfig as JaxConfig
from iqc_tpu.inference.detector import QualityControlDetector as JaxDetector
from iqc_tpu.models import optimizer as jopt
from iqc_tpu.models import yolo_int8 as jy8
from iqc_tpu.ops import image as jimg
from iqc_tpu.train.checkpoint import load_variables as jax_load
from iqc_tpu.train.checkpoint import save_variables as jax_save
from iqc_tpu_torch.config import REPO_ROOT, SystemConfig
from iqc_tpu_torch.inference.detector import QualityControlDetector
from iqc_tpu_torch.models import optimizer as topt
from iqc_tpu_torch.models import yolo_int8 as ty8
from iqc_tpu_torch.ops import image as timg
from iqc_tpu_torch.weights import read_checkpoint, read_msgpack, save_variables, write_msgpack

torch.set_num_threads(2)

FILTER_ATOL = 2e-6
BIN_EDGE_SHARE = 1e-3
BIN_EDGE_ATOL = 0.05
LOGIT_REL = 1e-5
FRAMES = 3

_SETTINGS = {
    "A": {"model": {"compute_dtype": "float32"},
          "processing": {"preprocessing": {"denoise": True, "enhance_contrast": True}},
          "edge": {"precision": "int8", "yolo_int8": False}},
    "B": {"edge": {"precision": "int8", "yolo_int8_stream": False, "sparsity": 0.05,
                   "structured_pruning": True}},
}


def _raw_config(setting):
    """tiny_config's shape with the YOLOv8n checkpoint at 128^2 (as
    test_torch_precision.py) under one setting."""
    raw = {
        "model": {"yolo_weights": YOLO_CKPT, "resnet_weights": "", "width_mult": 0.25,
                  "depth_mult": 0.334, "max_detections": 16, "max_classified": 4,
                  "confidence_threshold": 0.05, "compute_dtype": "bfloat16",
                  "classifier_input": 64, "resnet_stages": [1, 1, 1, 1]},
        "processing": {"batch_size": 2, "input_size": [SIZE, SIZE],
                       "preprocessing": {"resize": [SIZE, SIZE]}},
        "quality_control": {"thresholds": {"confidence_threshold": 0.0,
                                           "area_threshold_percent": 1000.0}},
    }
    for section, values in _SETTINGS[setting].items():
        for k, v in values.items():
            if isinstance(v, dict):
                raw[section].setdefault(k, {}).update(v)
            else:
                raw.setdefault(section, {})[k] = v
    return raw


def _jax_reference(out_path):
    """The child process: one JAX detector, its quantized state and answers
    under setting A, then its predictor and preprocessing rebuilt for B."""
    jax.config.update("jax_platforms", "cpu")
    from iqc_tpu.models import ensemble as jens
    from iqc_tpu.train.checkpoint import try_load_variables

    def init_or_load(module, dummy_shape, path):
        init = jax.jit(lambda k, x: module.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros(dummy_shape, jnp.float32))
        loaded = try_load_variables(path, init) if path else None
        return (loaded, "checkpoint") if loaded is not None else (init, "initialized")

    jens.EnsemblePredictor._init_or_load = staticmethod(init_or_load)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    frames = _images(21, FRAMES)
    out = {}
    det = None
    for setting in ("A", "B"):
        cfg = JaxConfig.from_dict(copy.deepcopy(_raw_config(setting)))
        if det is None:
            det = JaxDetector(config=cfg)
        else:
            det.config = cfg
            det.ensemble_predictor = jens.EnsemblePredictor(config=cfg)
            det._preprocess = det._build_preprocess()
        ens = det.ensemble_predictor
        yolo = ens.yolo_vars if setting == "B" else None
        out[setting] = {"yolo_vars": host(yolo) if yolo is not None else None,
                        "resnet_vars": host(ens.resnet_vars),
                        "model_info": ens.get_model_info(),
                        "predict": [det.predict(f) for f in frames]}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the JAX child at once; ``reference()`` waits for it."""
    out = str(tmp_path_factory.mktemp("options_reference") / "reference.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip(),
               PYTHONPATH=os.pathsep.join([REPO_ROOT, os.path.dirname(__file__)]))
    proc = subprocess.Popen([sys.executable, __file__, out], env=env, cwd=REPO_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cache = {}

    def wait():
        if "data" not in cache:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log[-4000:]
            with open(out, "rb") as f:
                cache["data"] = pickle.load(f)
        return cache["data"]

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


# -- preprocessing -------------------------------------------------------------------


def _unit(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(37, 53, 3), (2, 40, 48, 3), (33, 45)],
                         ids=["3d", "batched", "2d"])
def test_bilateral_filter_equals_jax(shape, reference):
    # `reference` starts the JAX detector's child process, which the last
    # tests of the file wait for
    x = _unit(shape, 1)
    want = np.asarray(jax.jit(jimg.bilateral_filter)(jnp.asarray(x)))
    got = timg.bilateral_filter(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_ATOL)


@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (100, 72)],
                         ids=["grid-divisible", "padded", "padded-tall"])
def test_clahe_equals_jax(shape):
    x = _unit(shape, 2)
    want = np.asarray(jax.jit(jimg.clahe)(jnp.asarray(x)))
    got = timg.clahe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_ATOL)
    # a batch is equalised image by image, as the JAX detector vmaps it
    xs = np.stack([x, _unit(shape, 3)])
    want = np.asarray(jax.jit(jax.vmap(jimg.clahe))(jnp.asarray(xs)))
    np.testing.assert_allclose(timg.clahe(torch.from_numpy(xs)).numpy(), want, rtol=0,
                               atol=FILTER_ATOL)


@pytest.mark.parametrize("shape", [(50, 70, 3), (3, 50, 70, 3)], ids=["3d", "batched"])
def test_enhance_contrast_equals_jax(shape):
    x = _unit(shape, 4)
    fn = jimg.enhance_contrast_rgb if len(shape) == 3 else jax.vmap(jimg.enhance_contrast_rgb)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = timg.enhance_contrast_rgb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_ATOL)


@pytest.mark.parametrize("options", [(True, False), (False, True), (True, True)],
                         ids=["denoise", "contrast", "both"])
def test_detector_preprocess_equals_jax(options):
    """The detectors' preprocessing (to float, resize, denoise, contrast),
    called on a stand-in object holding only the config."""
    pre = {"resize": [96, 96], "denoise": options[0], "enhance_contrast": options[1]}
    raw = {"processing": {"input_size": [96, 96], "preprocessing": pre}}
    images = np.random.default_rng(5).integers(0, 256, (2, 120, 80, 3), dtype=np.uint8)
    jfn = JaxDetector._build_preprocess(types.SimpleNamespace(config=JaxConfig.from_dict(raw)))
    want = np.asarray(jfn(jnp.asarray(images)))
    got = QualityControlDetector._preprocess(
        types.SimpleNamespace(config=SystemConfig.from_dict(raw)), torch.from_numpy(images))
    assert got.shape == want.shape == (2, 96, 96, 3)
    err = np.abs(got.numpy() - want)
    if not (options[0] and options[1]):
        assert err.max() <= FILTER_ATOL, err.max()
        return
    # after the filter, a pixel whose luma sits on a CLAHE bin edge can fall
    # into the neighbouring bin and take that bin's mapping
    assert np.mean(err > FILTER_ATOL) <= BIN_EDGE_SHARE, np.mean(err > FILTER_ATOL)
    assert err.max() <= BIN_EDGE_ATOL, err.max()


# -- weight-only int8, pruning, bfloat16 ------------------------------------------------


@pytest.fixture(scope="module")
def yolo_ckpt():
    return read_checkpoint(YOLO_CKPT)


def _part(variables, names=("c2f_3", "sppf", "head_p3")):
    """Blocks of a checkpoint holding every kind of leaf (conv kernels,
    projection kernels and biases, BatchNorm scales, biases, means and
    variances). The JAX functions run op by op, compiling each leaf shape
    anew, so the whole checkpoint takes them about four times longer."""
    return {c: {k: variables[c][k] for k in names} for c in ("params", "batch_stats")}


def test_quantize_int8_equals_jax(yolo_ckpt):
    part = _part(yolo_ckpt)
    want_v, want_s = jopt.quantize_int8(part)
    got_v, got_s = topt.quantize_int8(part)
    _assert_trees_equal(got_v, _host(want_v))
    _assert_trees_equal(got_s, _host(want_s))
    _assert_trees_equal(topt.dequantize_int8(got_v, got_s),
                        _host(jopt.dequantize_int8(want_v, want_s)))


def test_quantize_int8_empty_and_integer_leaves():
    tree = {"a": np.zeros((0, 3), np.float32), "b": np.arange(6, dtype=np.int32),
            "c": np.full((2, 2), 0.0, np.float32), "d": [np.float64(2.5) * np.ones(3)]}
    want_v, want_s = jopt.quantize_int8(tree)
    got_v, got_s = topt.quantize_int8(tree)
    _assert_trees_equal(got_v, _host(want_v))
    _assert_trees_equal(got_s, _host(want_s))


@pytest.mark.parametrize("sparsity,structured", [(0.3, False), (0.5, True)],
                         ids=["unstructured", "structured"])
def test_prune_checkpoint_equals_jax(yolo_ckpt, sparsity, structured):
    """The whole checkpoint by channel norms (whose float32 sums could break
    near-ties differently); by magnitude, blocks of it."""
    tree = yolo_ckpt if structured else _part(yolo_ckpt)
    want, want_report = jopt.prune_magnitude(tree, sparsity, structured)
    got, got_report = topt.prune_magnitude(tree, sparsity, structured)
    _assert_trees_equal(got, _host(want))
    assert got_report == want_report


@pytest.mark.parametrize("structured", [False, True], ids=["unstructured", "structured"])
def test_prune_ties_and_narrow_heads_equal_jax(structured):
    """All-equal magnitudes (exactly k zeros, lowest index first), equal
    channel norms, a narrow head (fewer than 32 outputs), a small and a 1-D
    leaf (never pruned), an integer leaf, and sparsity 0."""
    rng = np.random.default_rng(6)
    tree = {"params": {
        "ties": np.tile(np.asarray([1.0, -1.0], np.float32), 256).reshape(16, 32),
        "chan_ties": np.repeat(rng.standard_normal((8, 1)).astype(np.float32), 64, axis=1),
        "conv": rng.standard_normal((3, 3, 16, 48)).astype(np.float32),
        "head": rng.standard_normal((64, 20)).astype(np.float32),
        "small": rng.standard_normal((10, 10)).astype(np.float32),
        "bias": rng.standard_normal(512).astype(np.float32),
        "count": np.arange(600, dtype=np.int32).reshape(20, 30)}}
    for sparsity in (0.0, 0.25, 0.6):
        want, want_report = jopt.prune_magnitude(tree, sparsity, structured)
        got, got_report = topt.prune_magnitude(tree, sparsity, structured)
        _assert_trees_equal(got, _host(want))
        assert got_report == want_report
    with pytest.raises(ValueError):
        topt.prune_magnitude(tree, 1.0)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_engine_optimizer_equals_jax(yolo_ckpt, precision, tmp_path):
    """optimize_variables (with pruning) gives the JAX optimizer's tree and
    report; export writes files that each package's reader loads equal."""
    head = {"params": yolo_ckpt["params"]["head_p3"], "batch_stats":
            yolo_ckpt["batch_stats"]["head_p3"]}
    jo = jopt.XLAOptimizer(precision=precision, sparsity=0.25, structured_pruning=True)
    to = topt.EngineOptimizer(precision=precision, sparsity=0.25, structured_pruning=True)
    want, want_report = jo.optimize_variables(head)
    got, got_report = to.optimize_variables(head)
    _assert_trees_equal(got, _host(want))
    assert got_report == want_report
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jo.export(jpath)
    to.export(tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    with open(jpath + ".json") as f, open(tpath + ".json") as g:
        assert f.read() == g.read()


def test_msgpack_both_directions(tmp_path):
    rng = np.random.default_rng(7)
    tree = {"params": {"b": {"kernel": rng.standard_normal((3, 3, 4, 70000 // 36)).astype(
                                 np.float32),
                             "bias": np.zeros(8, np.float32)},
                       "a": {"codes": rng.integers(-127, 128, (10, 20)).astype(np.int8)}},
            "batch_stats": {"scalar": np.asarray(0.5, np.float32),
                            "empty": np.zeros((0,), np.float32)},
            "list": [np.arange(3, dtype=np.int64), {"x": np.ones((2, 2), np.float16)}]}
    want = serialization.to_bytes(_host(tree))
    assert write_msgpack(tree) == want
    back = read_msgpack(want)
    _assert_trees_equal(back["params"], tree["params"])
    _assert_trees_equal(back["list"], {"0": tree["list"][0], "1": tree["list"][1]})
    # port -> JAX and JAX -> port through files
    save_variables(str(tmp_path / "p.msgpack"), {"params": tree["params"]}, {"k": 1})
    _assert_trees_equal(_host(jax_load(str(tmp_path / "p.msgpack"),
                                       {"params": tree["params"]})), {"params": tree["params"]})
    jax_save(str(tmp_path / "j.msgpack"), {"params": tree["params"]})
    _assert_trees_equal(read_checkpoint(str(tmp_path / "j.msgpack")), {"params": tree["params"]})
    # bfloat16: written as bfloat16, read back widened exactly to float32
    bf = {"w": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)}
    got_bf = topt.to_bf16({"w": np.asarray(bf["w"].astype(jnp.float32))})
    assert got_bf["w"].dtype == torch.bfloat16
    assert write_msgpack(got_bf) == serialization.to_bytes(_host(bf))
    _assert_trees_equal(read_msgpack(serialization.to_bytes(_host(bf))), bf)


def test_engine_build_on_the_cpu_is_eager(yolo_ckpt):
    """build_engine at max_batch_size: on the CPU the built function is the
    eager one, with its operations counted."""
    from iqc_tpu_torch.models.yolo import YOLOv8
    from iqc_tpu_torch.weights import load_into

    net = YOLOv8(num_classes=5, width_mult=0.25, depth_mult=0.334).eval()

    def apply_fn(variables, batch):
        load_into(net, variables)
        return net(batch)

    opt = topt.EngineOptimizer(precision="int8", max_batch_size=2)
    engine = opt.build_engine(apply_fn, yolo_ckpt, torch.zeros(1, 64, 64, 3))
    assert engine.graph is None and engine.flops > 1e8
    assert opt.report["max_batch_size"] == 2 and opt.report["flops"] == engine.flops
    x = torch.from_numpy(_unit((2, 64, 64, 3), 8))
    weights, _ = opt.optimize_variables(yolo_ckpt)
    with torch.inference_mode():
        got = engine(weights, x)
        want = apply_fn(weights, x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the v1 int8 YOLO walk -------------------------------------------------------------


def test_quantize_yolo_equals_jax(yolo_ckpt):
    _assert_trees_equal(ty8.quantize_yolo(yolo_ckpt), _host(jy8.quantize_yolo(yolo_ckpt)))
    assert ty8.n_convs() == jy8.n_convs() == 57


def test_v1_walk_equals_jax_op_by_op(yolo_ckpt, monkeypatch):
    """With per-batch dynamic scales (the calibration pass): each conv's
    int8 input codes and int32 accumulators, the collected scales and the
    logits, against the op-by-op JAX walk; then the port's walk with those
    scales as static ones against JAX's."""
    q = jy8.quantize_yolo(yolo_ckpt)
    qd = ty8.device_tree(ty8.quantize_yolo(yolo_ckpt), "cpu")
    want_rec, got_rec = [], []
    real = jax.lax

    def conv(x, w, *args, **kw):
        out = real.conv_general_dilated(x, w, *args, **kw)
        if x.dtype == jnp.int8:
            want_rec.append((np.asarray(x), np.asarray(out)))
        return out

    proxy = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                     if not k.startswith("__")})
    proxy.conv_general_dilated = conv
    monkeypatch.setattr(jy8, "lax", proxy)
    port_conv = ty8.conv_int8

    def tconv(x, w, *args):
        out = port_conv(x, w, *args)
        got_rec.append((x.numpy(), out.numpy()))
        return out

    monkeypatch.setattr(ty8, "conv_int8", tconv)
    x = _unit((1, 64, 64, 3), 9)
    want_scales, got_scales = [], []
    want = jy8.apply(q, jnp.asarray(x), _collect=want_scales)
    with torch.inference_mode():
        got = ty8.apply(qd, torch.from_numpy(x), _collect=got_scales)
    assert len(got_rec) == len(want_rec) == ty8.n_convs()
    for i, ((gx, ga), (wx, wa)) in enumerate(zip(got_rec, want_rec)):
        assert gx.dtype == np.int8 and ga.dtype == np.int32
        np.testing.assert_array_equal(gx, wx, err_msg=f"conv {i} codes")
        np.testing.assert_array_equal(ga, wa, err_msg=f"conv {i} accumulators")
    np.testing.assert_array_equal(torch.stack(got_scales).numpy(),
                                  np.asarray(jnp.stack(want_scales)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LOGIT_REL * np.abs(w).max())
    # static scales: the port's calibration is the same running max
    scales = ty8.calibrate_activation_scales(qd, [torch.from_numpy(x)])
    np.testing.assert_array_equal(scales.numpy(), torch.stack(got_scales).numpy())


# -- the detector under each setting ----------------------------------------------------


@pytest.mark.parametrize("setting", ["A", "B"])
def test_detector_setting_matches_jax(setting, reference):
    ref = reference()[setting]
    state = {"yolo": ref["yolo_vars"], "resnet": ref["resnet_vars"]}
    det = QualityControlDetector(config=SystemConfig.from_dict(_raw_config(setting)),
                                 device="cpu", int8_state=state)
    info = det.ensemble_predictor.get_model_info()
    want_info = ref["model_info"]
    # the reports count shapes only, so the port's own ResNet initialisation
    # gives the JAX one's too
    assert info["precision_report"] == want_info["precision_report"]
    assert info["pruning_report"] == want_info["pruning_report"]
    assert (info["pruning_report"] is None) == (setting == "A")
    frames = _images(21, FRAMES)
    n_detections = 0
    for i, (frame, want) in enumerate(zip(frames, ref["predict"])):
        got = det.predict(frame)
        assert "error" not in got and "error" not in want
        n_detections += len(want["detections"])
        _compare(_strip(got), _strip(want), f"{setting} frame {i}")
    assert n_detections > 0


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
