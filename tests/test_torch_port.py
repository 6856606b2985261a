"""The port's package boundary, configuration, weight reader and timers, and
``chip_smoke.py``'s refusal to run without a card.

Tolerances: configuration values and checkpoint leaves EQUAL.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from iqc_tpu.config import load_config
from iqc_tpu_torch import weights
from iqc_tpu_torch.config import REPO_ROOT, SystemConfig, resolve_path
from iqc_tpu_torch.utils.tracing import StageTimes, stage_timer

torch.set_num_threads(2)

PORT_DIR = os.path.join(REPO_ROOT, "iqc_tpu_torch")
SMOKE = os.path.join(REPO_ROOT, "chip_smoke.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "msgpack", "PIL", "iqc_tpu"}


def _port_sources():
    paths = [SMOKE]
    for root, _, files in os.walk(PORT_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO_ROOT)} imports {bad}"


def test_config_defaults_are_the_shipped_profile():
    """Every field of the port's configuration equals config/config.yaml as
    the JAX package loads it, the precision fields included (bfloat16
    compute, int8 serving with both streaming walks)."""
    want = load_config(os.path.join(REPO_ROOT, "config", "config.yaml"))
    got = SystemConfig()

    def compare(g, w, path):
        for f in dataclasses.fields(g):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if dataclasses.is_dataclass(gv):
                compare(gv, wv, path + (f.name,))
            else:
                assert gv == wv, (path + (f.name,), gv, wv)

    compare(got, want, ())
    assert got.model.compute_dtype == "bfloat16" and got.edge.precision == "int8"
    assert got.edge.yolo_int8 and got.edge.yolo_int8_stream and got.edge.resnet_int8_stream


def test_config_from_dict_and_validation():
    cfg = SystemConfig.from_dict({"model": {"max_detections": 100, "resnet_stages": [1, 1, 1, 1]},
                                  "processing": {"input_size": [320, 320]},
                                  "unknown_block": {"x": 1}})
    assert cfg.model.max_detections == 100 and cfg.model.resnet_stages == (1, 1, 1, 1)
    assert cfg.processing.input_size == (320, 320) and cfg.model.max_classified == 32
    assert cfg.update({"model": {"nms_threshold": 0.4}}).model.nms_threshold == 0.4
    for ok in ({"edge": {"precision": p}} for p in ("fp32", "bf16", "int8")):
        assert SystemConfig.from_dict(ok).edge.precision == ok["edge"]["precision"]
    assert SystemConfig.from_dict({"model": {"compute_dtype": "float32"}}).model.compute_dtype \
        == "float32"
    # the settings the JAX package serves beyond the shipped profile
    for ok in ({"edge": {"yolo_int8": False}}, {"edge": {"yolo_int8_stream": False}},
               {"edge": {"sparsity": 0.5, "structured_pruning": True}},
               {"processing": {"preprocessing": {"denoise": True, "enhance_contrast": True}}}):
        SystemConfig.from_dict(ok)
    for bad in ({"edge": {"sparsity": 1.0}}, {"edge": {"sparsity": -0.1}},
                {"edge": {"precision": "fp16"}},
                {"model": {"compute_dtype": "float16"}},
                {"processing": {"input_size": [100, 100]}}):
        with pytest.raises(ValueError):
            SystemConfig.from_dict(bad)


def test_weight_paths_resolve_from_the_repository():
    assert resolve_path("models/x.msgpack") == os.path.join(REPO_ROOT, "models", "x.msgpack")
    assert resolve_path("/abs/x") == "/abs/x"
    assert os.path.exists(resolve_path(SystemConfig().model.yolo_weights))
    assert os.path.exists(resolve_path(SystemConfig().model.resnet_weights))


def test_reader_matches_flax_on_the_yolo_checkpoint():
    path = resolve_path("models/yolov8n_qc_synthetic.msgpack")
    got = weights.flatten(weights.read_checkpoint(path))
    want = weights.flatten(serialization.msgpack_restore(open(path, "rb").read()))
    assert len(got) == 297 and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_reader_on_every_msgpack_type_flax_writes():
    tree = {"params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": {"c": np.asarray([1, -2], np.int32),
                             "s": np.float64(2.5)}},
            "meta": {"n": 7, "neg": -3, "big": 2 ** 40, "f": 1.5, "t": True, "none": None,
                     "str": "x" * 40, "list": [1, 2, 3]}}
    got = weights.read_msgpack(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["params"]["a"], tree["params"]["a"])
    np.testing.assert_array_equal(got["params"]["b"]["c"], tree["params"]["b"]["c"])
    assert got["params"]["b"]["s"] == 2.5
    assert got["meta"] == tree["meta"]


@pytest.mark.parametrize("data", [b"\xc1", b"\x92\x01", b"\x82\xa1a\x01", b"\x01\x02",
                                  b"\xd4\x05\x00"])
def test_reader_rejects_malformed_or_foreign_data(data):
    with pytest.raises(ValueError):
        weights.read_msgpack(data)


def test_reader_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        weights.read_checkpoint(str(tmp_path / "absent.msgpack"))


def test_from_flax_layouts():
    conv = np.random.default_rng(0).random((3, 3, 4, 8)).astype(np.float32)  # HWIO
    dense = np.random.default_rng(1).random((8, 5)).astype(np.float32)       # [in,out]
    sd = weights.from_flax({
        "params": {"c": {"Conv_0": {"kernel": conv}}, "d": {"kernel": dense, "bias": np.ones(5)},
                   "bn": {"scale": np.ones(8), "bias": np.zeros(8)}},
        "batch_stats": {"bn": {"mean": np.zeros(8), "var": np.ones(8)}},
    })
    assert sd["c.Conv_0.weight"].shape == (8, 4, 3, 3)
    np.testing.assert_array_equal(sd["c.Conv_0.weight"][5, 2].numpy(), conv[:, :, 2, 5])
    np.testing.assert_array_equal(sd["d.weight"].numpy(), dense.T)
    assert set(sd) == {"c.Conv_0.weight", "d.weight", "d.bias", "bn.weight", "bn.bias",
                       "bn.running_mean", "bn.running_var"}
    with pytest.raises(ValueError):
        weights.from_flax({"params": {"x": {"embedding": np.ones(3)}}})


def test_stage_timer_accumulates():
    stages = StageTimes()
    for _ in range(2):
        with stage_timer(stages, "a", torch.device("cpu")):
            pass
    with pytest.raises(RuntimeError):
        with stage_timer(stages, "b"):
            raise RuntimeError("stage failed")
    d = stages.as_dict()
    assert set(d) == {"a", "b"} and all(v >= 0 for v in d.values())


def test_reader_rejects_a_truncated_array():
    data = serialization.msgpack_serialize({"a": np.ones(2, np.float32)})
    with pytest.raises(ValueError):
        weights.read_msgpack(data[:-1])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA device here: the script exits nonzero and prints no result,
    also when it stands in a directory with nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = SMOKE
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        with open(SMOKE) as src, open(script, "w") as dst:
            dst.write(src.read())
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
