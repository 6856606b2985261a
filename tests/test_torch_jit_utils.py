"""The port's ``hoisted_jit`` (``iqc_tpu_torch/ops/jit_utils.py``) on the
CPU, where it calls the function and keys its cache by signature: the six
cases of tests/test_jit_utils.py, a Python float that is a run-time input
(not part of the signature), and ``torch.library.opcheck`` of the three
kernels' custom ops (schema, fake implementation, CPU implementation). On
the card the wrapper replays CUDA graphs: tests/test_torch_cuda.py.

Tolerance: the wrapped function's outputs EQUAL a plain call's (the same
operations run on the CPU).
"""

import numpy as np
import pytest
import torch

from iqc_tpu_torch.ops import morph_kernel, nms_kernel  # noqa: F401  (registers iqc::*)
from iqc_tpu_torch.ops.jit_utils import device_constant, hoisted_jit

torch.set_num_threads(2)


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32))


def test_hoisted_jit_matches_plain_call():
    const = _normal(0, (16, 16))

    def fn(x):
        return torch.tanh(x @ const) + device_constant(np.float32([1.0, 2.0] * 8), x.device)

    x = _normal(1, (4, 16))
    assert torch.equal(hoisted_jit(fn)(x), fn(x))


def test_hoisted_jit_pytree_io():
    mean = torch.tensor([0.485, 0.456, 0.406])

    def fn(batch):
        return {"norm": batch["img"] - mean, "sum": torch.sum(batch["img"])}

    out = hoisted_jit(fn)({"img": torch.ones((2, 4, 4, 3))})
    assert set(out) == {"norm", "sum"}
    assert out["norm"].shape == (2, 4, 4, 3)
    assert float(out["sum"]) == 96.0


def test_hoisted_jit_multiple_signatures():
    f = hoisted_jit(lambda x: x * device_constant(np.float32([2.0]), x.device))
    a = f(torch.ones((3,)))
    b = f(torch.ones((5,)))
    assert a.shape == (3,) and b.shape == (5,)
    assert len(f._cache) == 2
    f(torch.ones((3,)))  # a repeated signature reuses its entry
    assert len(f._cache) == 2
    f(torch.ones((3,), dtype=torch.float64))  # the dtype is part of the signature
    assert len(f._cache) == 3


def test_hoisted_jit_no_consts():
    f = hoisted_jit(lambda x: x + 1.0)
    assert f(torch.zeros((2,))).tolist() == [1.0, 1.0]


def test_hoisted_jit_kwargs_and_scalars():
    def fn(x, scale):
        return x * scale

    f = hoisted_jit(fn)
    assert f(torch.ones((2,)), torch.tensor(3.0)).tolist() == [3.0, 3.0]
    assert f(torch.ones((2,)), scale=torch.tensor(4.0)).tolist() == [4.0, 4.0]
    assert len(f._cache) == 2  # positional and keyword arguments are distinct structures


def test_hoisted_jit_decorator_form():
    @hoisted_jit
    def fn(x):
        return x - torch.tensor([1.0, 1.0])

    assert fn(torch.zeros((2,))).tolist() == [-1.0, -1.0]


def test_float_is_a_runtime_input_and_ints_are_static():
    """A Python float is an input, as JAX traces it: new values reuse the
    signature. An int, a bool or None is static: each value is its own."""
    def fn(x, scale, power, flip):
        y = (x * scale) ** power
        return -y if flip else y

    f = hoisted_jit(fn)
    x = torch.arange(3, dtype=torch.float32)
    assert f(x, 2.0, 1, False).tolist() == [0.0, 2.0, 4.0]
    assert f(x, 0.5, 1, False).tolist() == [0.0, 0.5, 1.0]
    assert len(f._cache) == 1
    assert f(x, 2.0, 2, False).tolist() == [0.0, 4.0, 16.0]
    assert f(x, 2.0, 2, True).tolist() == [0.0, -4.0, -16.0]
    assert len(f._cache) == 3


def test_device_constant_is_built_once():
    a = device_constant(np.int32([1, 1, 2, 0, 3]), "cpu")
    assert a is device_constant(np.int32([1, 1, 2, 0, 3]), "cpu")
    assert a is not device_constant(np.int64([1, 1, 2, 0, 3]), "cpu")
    assert device_constant(np.float32([0.5]), "cpu", torch.bfloat16).dtype == torch.bfloat16


def _opcheck_cases():
    rng = np.random.default_rng(5)
    boxes = np.sort(rng.uniform(0, 60, (2, 24, 4)).astype(np.float32), axis=-1)
    masks = torch.from_numpy(rng.random((3, 32, 32)) < 0.5)
    seeds = torch.from_numpy(rng.random((3, 32, 32)) < 0.02)
    return {
        "suppress": (torch.ops.iqc.suppress.default,
                     (torch.from_numpy(boxes), torch.tensor(0.45), 16)),
        "grow_clean": (torch.ops.iqc.grow_clean.default, (seeds, masks, 24, 16)),
        "clean": (torch.ops.iqc.clean.default, (masks, 16)),
    }


@pytest.mark.parametrize("name", ["suppress", "grow_clean", "clean"])
def test_kernel_custom_op_opcheck(name):
    """The op's schema, fake (meta) implementation and CPU implementation
    agree, and the op traces under AOT dispatch."""
    op, args = _opcheck_cases()[name]
    torch.library.opcheck(op, args)
