"""Reader for the Flax msgpack checkpoints, and Flax -> PyTorch parameter mapping.

Flax's ``serialization.to_bytes`` writes a nested msgpack map (top level
``params`` and ``batch_stats``) whose leaves are ext type 1 records. Each
record's payload is itself msgpack: ``(shape, dtype name, raw C-order bytes)``.
This module decodes that subset of msgpack with ``struct`` and numpy alone:
maps, arrays, strings, bin, ext/fixext, ints, floats, bool and nil. Anything
else raises. A ``bfloat16`` record is widened exactly to float32 (numpy has
no bfloat16). ``save_variables`` writes the same format (``write_msgpack``),
so the JAX package reads the port's files, with a JSON metadata sidecar.

``from_flax`` renames a Flax variables tree to the state dict of the port's
modules, whose submodule names follow the Flax scopes (``Conv_0``,
``BatchNorm_0``, ``stage1_block1`` ...): conv kernels HWIO -> OIHW, dense
kernels [in,out] -> [out,in], BatchNorm ``scale``/``mean``/``var`` ->
``weight``/``running_mean``/``running_var``; ``to_flax`` is its inverse.
``install_int8_state`` puts the JAX package's quantized networks (trees and
activation scales, as numpy) into the port's int8 predictor;
``train_state_from_flax`` turns the JAX trainer's state (parameters,
statistics, optax's trace, count and mask, the EMA) into the port's.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self._str(n)
        if b in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        arr = _ndarray_from_payload(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    rec = r.value()
    if r.pos != len(payload) or not (isinstance(rec, list) and len(rec) == 3):
        raise ValueError("malformed ndarray record")
    shape, dtype_name, raw = rec
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if not isinstance(raw, bytes):
        raise ValueError("ndarray record without a byte buffer")
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":  # numpy has no bfloat16: widen exactly
        bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"unsupported array dtype {dtype_name!r}") from e
    return np.frombuffer(raw, dtype=dtype).copy().reshape(shape)


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack object (Flax checkpoint subset)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def read_checkpoint(path: str) -> Dict[str, Any]:
    """Flax variables tree {collection: nested dict of numpy arrays}.
    A missing file raises FileNotFoundError."""
    with open(path, "rb") as f:
        tree = read_msgpack(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: top level is not a map")
    return tree


class _Writer:
    """msgpack encoder of the subset the reader decodes, with the shortest
    encoding of each value (as msgpack-python packs it)."""

    def __init__(self):
        self.parts = []

    def put(self, fmt: str, *values) -> None:
        self.parts.append(struct.pack(fmt, *values))

    def _sized(self, n: int, small, formats) -> None:
        """A length header: ``small`` = (limit, base byte) of the fix form
        or None; ``formats``: (type byte, struct format) by width."""
        if small is not None and n < small[0]:
            self.put(">B", small[1] | n)
            return
        for code, fmt in formats:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.put(">B" + fmt[1:], code, n)
                return
        raise ValueError(f"msgpack object of {n} entries is too long")

    def value(self, v: Any) -> None:
        if isinstance(v, dict):
            self._sized(len(v), (16, 0x80), ((0xDE, ">H"), (0xDF, ">I")))
            for k in sorted(v, key=str):
                self.value(str(k))
                self.value(v[k])
        elif isinstance(v, (list, tuple)):
            self._sized(len(v), (16, 0x90), ((0xDC, ">H"), (0xDD, ">I")))
            for x in v:
                self.value(x)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self._sized(len(b), (32, 0xA0), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
            self.parts.append(b)
        elif isinstance(v, bytes):
            self._sized(len(v), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
            self.parts.append(v)
        elif isinstance(v, bool) or v is None:
            self.put(">B", {None: 0xC0, False: 0xC2, True: 0xC3}[v])
        elif isinstance(v, (int, np.integer)) and not isinstance(v, np.ndarray) and v >= 0:
            v = int(v)
            if v < 0x80:
                self.put(">B", v)
            else:
                self._sized(v, None, ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")))
        else:
            self._ext(_EXT_NDARRAY, _ndarray_payload(v))

    def _ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.put(">B", fixed[n])
        else:
            self._sized(n, None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        self.put(">b", code)
        self.parts.append(payload)


def _ndarray_payload(leaf) -> bytes:
    """Flax's ndarray record: msgpack of (shape, dtype name, C-order bytes).
    A torch bfloat16 tensor is written as dtype ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        a = np.asarray(leaf)
        if a.dtype.hasobject:
            raise ValueError(f"cannot serialize a leaf of dtype {a.dtype}")
        shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    w = _Writer()
    w.value((tuple(int(s) for s in shape), name, raw))
    return b"".join(w.parts)


def write_msgpack(tree: Any) -> bytes:
    """Encode a nested dict / list of arrays as Flax's ``to_bytes`` does
    (dict keys sorted, as JAX's tree utilities order them; every leaf an
    ndarray record)."""
    w = _Writer()
    w.value(_state_dict(tree))
    return b"".join(w.parts)


def _state_dict(tree: Any) -> Any:
    """Lists become maps keyed '0', '1', ... (Flax's state-dict form)."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def save_variables(path: str, variables: Any, metadata: Optional[Dict] = None) -> None:
    """Write a variables tree as a Flax msgpack checkpoint at ``path`` (and
    ``metadata`` as JSON beside it, ``path + ".json"``); the JAX package's
    ``load_variables`` reads it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(write_msgpack(variables))
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested dict -> {key path: leaf}."""
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


_RENAME = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables {params, batch_stats} (numpy leaves) -> state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for (collection, *scope, leaf), value in flatten(variables).items():
        name = _RENAME.get((collection, leaf))
        if name is None:
            raise ValueError(f"unexpected Flax leaf {collection}/{'/'.join(scope)}/{leaf}")
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif leaf == "kernel" and arr.ndim == 2:
            arr = arr.T  # [in,out] -> [out,in]
        key = ".".join(scope + [name])
        if key in sd:
            raise ValueError(f"duplicate parameter {key}")
        sd[key] = torch.from_numpy(np.array(arr, order="C", copy=True))
    return sd


def load_into(module: torch.nn.Module, variables: Dict[str, Any]) -> None:
    """Fill ``module`` from a Flax tree: the key sets must be equal and every
    leaf shape must match, else ValueError."""
    sd = from_flax(variables)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(
            f"checkpoint structure mismatch: {len(extra)} key(s) not in model "
            f"(e.g. {extra[:5]}), {len(missing)} model key(s) absent (e.g. {missing[:5]})"
        )
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint leaf {k} has shape {tuple(v.shape)}, "
                             f"model expects {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)


def to_flax(module: torch.nn.Module, values: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The port's module -> Flax variables {params, batch_stats} of numpy
    float32 arrays (the inverse of ``from_flax``). ``values`` maps
    state-dict names to other leaves of the same layout to write in the
    module's place (a momentum trace, an EMA, per-leaf mask scalars); the
    tree then holds only the names it gives."""
    from iqc_tpu_torch.models.layers import BatchNorm

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, scope, leaf, name, value, layout=None):
        if values is not None:
            if name not in values:
                return
            value = values[name]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float()
            if layout is not None and value.dim() == 4:
                value = value.permute(2, 3, 1, 0)
            elif layout is not None and value.dim() == 2:
                value = value.t()
            value = value.numpy()
        for part in scope:
            tree = tree.setdefault(part, {})
        tree[leaf] = np.array(value, np.float32, order="C")

    for name, m in module.named_modules():
        scope = name.split(".") if name else []
        pre = name + "." if name else ""
        if isinstance(m, BatchNorm):
            put(params, scope, "scale", pre + "weight", m.weight)
            put(params, scope, "bias", pre + "bias", m.bias)
            put(stats, scope, "mean", pre + "running_mean", m.running_mean)
            put(stats, scope, "var", pre + "running_var", m.running_var)
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            put(params, scope, "kernel", pre + "weight", m.weight, layout="kernel")
            if m.bias is not None:
                put(params, scope, "bias", pre + "bias", m.bias)
    return {"params": params, "batch_stats": stats}


def flax_named(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax params-shaped tree (params, a momentum trace, an EMA, a mask
    of scalars) -> tensors by the port's state-dict names."""
    return from_flax({"params": tree})


_OPTAX_LEAVES = ("trace", "mu", "nu", "count", "mask", "learning_rate")


def _optax_leaves(opt_state) -> Dict[str, Any]:
    """The momentum trace, Adam's moments, the count, the mask and the
    injected learning rate of an optax chain's state, as optax state
    objects (NamedTuples in nested tuples) or as their state-dict form
    (nested dicts keyed by field name or position)."""
    found: Dict[str, Any] = {}

    def walk(node):
        if isinstance(node, dict):
            items = node.items()
        elif hasattr(node, "_fields"):
            items = ((f, getattr(node, f)) for f in node._fields)
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            return
        for k, v in items:
            if k in _OPTAX_LEAVES:
                found[k] = v
            else:
                walk(v)

    walk(opt_state)
    return found


def train_state_from_flax(state, ema_params=None) -> Dict[str, Any]:
    """The JAX trainer's state as the port's: ``state`` is its
    ``TrainState`` (step, params, batch_stats, opt_state), or that tuple as
    numpy (``jax.device_get``) or in the state-dict form a train-state
    checkpoint holds; ``ema_params`` its EMA tree. Returns {"step": int,
    "params", "batch_stats", "trace", "mu", "nu", "ema": tensors by
    state-dict name (None where the state has none), "count": int (0 where
    the chain counts nothing), "mask": {name: float} or None,
    "learning_rate": the injected float rate or None}."""
    if isinstance(state, dict):
        state = tuple(state[str(i)] for i in range(4))
    step, params, batch_stats, opt_state = state
    opt = _optax_leaves(opt_state)
    if "trace" not in opt and "mu" not in opt:
        raise ValueError("the optimizer state holds neither a momentum trace nor Adam's "
                         "moments (expected sgd with momentum, adam or adamw)")
    named = lambda k: flax_named(opt[k]) if k in opt else None
    out = {"step": int(np.asarray(step)),
           "params": flax_named(params),
           "batch_stats": from_flax({"batch_stats": batch_stats}),
           "trace": named("trace"), "mu": named("mu"), "nu": named("nu"),
           "count": int(np.asarray(opt.get("count", 0))),
           "mask": None, "ema": None, "learning_rate": None}
    if "mask" in opt:
        out["mask"] = {k: float(v) for k, v in flax_named(opt["mask"]).items()}
    if "learning_rate" in opt:
        out["learning_rate"] = float(np.asarray(opt["learning_rate"], np.float32))
    if ema_params is not None:
        out["ema"] = flax_named(ema_params)
    return out


def install_int8_state(predictor, yolo_vars: Dict[str, Any] = None,
                       resnet_vars: Dict[str, Any] = None) -> None:
    """Install quantized networks in an int8 ``EnsemblePredictor``: each of
    ``yolo_vars`` / ``resnet_vars`` is {"q": int8 tree, "scales": [n]} with
    numpy leaves, as the JAX package's predictor holds them after its int8
    set-up (``yolo_vars`` for the streaming walk). The predictor then runs
    those codes and scales instead of its own."""
    if predictor.config.edge.precision != "int8":
        raise ValueError("int8 state goes into a predictor at edge.precision int8")

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [host(v) for v in tree]
        return np.asarray(tree)

    if yolo_vars is not None:
        predictor.install_yolo_int8(host(yolo_vars["q"]), host(yolo_vars["scales"]))
    if resnet_vars is not None:
        predictor.install_resnet_int8(host(resnet_vars["q"]), host(resnet_vars["scales"]))


def load_or_init(module: torch.nn.Module, path: Optional[str], seed: int) -> str:
    """Fill ``module`` from the Flax checkpoint at ``path`` (relative paths
    from the repository root) and return "checkpoint". No path, or a missing
    file, leaves seeded random weights (``layers.init_random``) and returns
    "initialized"; a malformed or mismatched file raises ValueError."""
    from iqc_tpu_torch.config import resolve_path
    from iqc_tpu_torch.models.layers import init_random

    init_random(module, seed)
    if not path:
        return "initialized"
    full = resolve_path(path)
    if not os.path.exists(full):
        logger.warning("checkpoint %s not found; using initialized weights", full)
        return "initialized"
    try:
        load_into(module, read_checkpoint(full))
    except ValueError as e:
        raise ValueError(f"corrupt or incompatible checkpoint {full!r}: {e}") from e
    return "checkpoint"
