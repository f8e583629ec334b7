"""Save and load the port's objects: keys, ciphertexts, shares.

Counterpart of :mod:`lattigo_tpu.utils.serialization`, with the same
``dumps`` / ``loads`` / ``save`` / ``load``. The JAX package pickles a JAX
tree definition, which the port cannot read, so this is the port's own
container: one ``.npz`` holding every tensor and array, and beside them
the structure as JSON (the port's dataclasses by name with their fields,
dicts, lists, tuples, integers, ``Fraction`` scales, seeds). Loading
unpickles nothing and builds no object but a dataclass that a module of
``lattigo_tpu_torch`` defines at its top level, through that class's own
constructor; any other class name in the blob is refused with
``ValueError``. Tensors come back on the device the caller names. The
two packages exchange objects through
:mod:`lattigo_tpu_torch.utils.lattigo_wire`, not through this.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
from fractions import Fraction

import numpy as np
import torch

from lattigo_tpu_torch.device import resolve_device

_PACKAGE = "lattigo_tpu_torch"


def _encode(obj, arrays: list):
    if isinstance(obj, torch.Tensor):
        arrays.append(obj.detach().cpu().contiguous().numpy())
        return {"tensor": len(arrays) - 1}
    if isinstance(obj, np.ndarray):
        arrays.append(np.ascontiguousarray(obj))
        return {"ndarray": len(arrays) - 1}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Fraction):
        return {"fraction": [obj.numerator, obj.denominator]}
    if isinstance(obj, bytes):
        return {"bytes": obj.hex()}
    if isinstance(obj, (list, tuple)):
        return {"list" if isinstance(obj, list) else "tuple":
                [_encode(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"dict": [[_encode(k, arrays), _encode(v, arrays)]
                         for k, v in obj.items()]}
    cls = type(obj)
    name = f"{cls.__module__}:{cls.__qualname__}"
    if dataclasses.is_dataclass(obj) and _resolve(name) is cls:
        return {"class": name,
                "fields": {f.name: _encode(getattr(obj, f.name), arrays)
                           for f in dataclasses.fields(obj) if f.init}}
    raise TypeError(f"cannot serialize a {cls.__name__}")


def _resolve(name):
    """The dataclass that ``module:Name`` names, or None. Only a module of
    the package and a class that it defines at its top level qualify."""
    module, _, qualname = str(name).partition(":")
    if not (module == _PACKAGE or module.startswith(_PACKAGE + ".")):
        return None
    if not qualname.isidentifier() or not all(
            part.isidentifier() for part in module.split(".")):
        return None
    try:
        cls = getattr(importlib.import_module(module), qualname, None)
    except ImportError:
        return None
    if (isinstance(cls, type) and dataclasses.is_dataclass(cls)
            and cls.__module__ == module and cls.__qualname__ == qualname):
        return cls
    return None


def _decode(node, arrays, device):
    if not isinstance(node, dict):
        return node
    if "class" in node:
        cls = _resolve(node["class"])
        fields = node.get("fields")
        if cls is None or set(node) != {"class", "fields"} or not isinstance(fields, dict):
            raise ValueError(f"refusing to load class {node['class']!r}")
        names = {f.name for f in dataclasses.fields(cls) if f.init}
        if not set(fields) <= names:
            raise ValueError(f"unknown fields {sorted(set(fields) - names)} "
                             f"for {node['class']!r}")
        return cls(**{k: _decode(v, arrays, device) for k, v in fields.items()})
    ((kind, val),) = node.items()
    if kind == "tensor":
        return torch.from_numpy(arrays[f"a{val}"]).to(device)
    if kind == "ndarray":
        return arrays[f"a{val}"]
    if kind == "fraction":
        return Fraction(*val)
    if kind == "bytes":
        return bytes.fromhex(val)
    if kind in ("list", "tuple"):
        out = [_decode(x, arrays, device) for x in val]
        return out if kind == "list" else tuple(out)
    if kind == "dict":
        return {_decode(k, arrays, device): _decode(v, arrays, device) for k, v in val}
    raise ValueError(f"unknown node {kind!r}")


def dumps(obj) -> bytes:
    """Serialize any of the port's objects to bytes."""
    arrays: list = []
    structure = json.dumps(_encode(obj, arrays))
    buf = io.BytesIO()
    np.savez(buf, structure=np.frombuffer(structure.encode(), dtype=np.uint8),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    return buf.getvalue()


def loads(data: bytes, device=None):
    """Inverse of :func:`dumps`: tensors on ``device`` (CUDA unless the
    caller names another), numpy arrays as they were."""
    dev = resolve_device(device)
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    structure = json.loads(arrays.pop("structure").tobytes().decode())
    return _decode(structure, arrays, dev)


def save(obj, path: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps(obj))


def load(path: str, device=None):
    with open(path, "rb") as f:
        return loads(f.read(), device)
