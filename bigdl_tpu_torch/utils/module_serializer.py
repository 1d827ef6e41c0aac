"""The topology-bearing model file (counterpart of
``bigdl_tpu/utils/module_serializer.py``; reference: ``Module.saveModule`` /
``Module.loadModule`` over ``$DL/utils/serializer``).

One ``.npz``:

* ``__bigdl__``: a JSON document with ``version``, the recursive topology
  (class, recorded constructor arguments and children; a ``Graph`` writes
  its DAG, each shared module once) and the model's build-time input spec;
* the parameters and the state, flattened as the checkpoints flatten them
  (``params/...``, ``state/...``).

**The format is the JAX package's, in both directions.** A file names the
reference's classes (``"module": "bigdl_tpu.nn.linear"``), as BigDL's
protobuf names its Scala classes: the port writes ``bigdl_tpu.<path>`` for
its own ``bigdl_tpu_torch.<path>`` and maps it back on load, refusing any
other prefix, so a model file cannot import arbitrary code. It never
imports ``bigdl_tpu``. Callables travel under the JAX package's names
(``"jnp.tanh"``, ``"jax.nn.gelu"``), each mapped to the torch function with
the same numbers (``jax.nn.gelu`` is the tanh approximation). Dtype names
are mapped to torch dtypes directly (numpy has no ``bfloat16``).

``load_module_def(path, device)`` rebuilds the topology on ``device`` (the
card unless ``"cpu"``), builds it once from the recorded input spec (a
sample of zeros, ones for integer inputs, on the device: one eval-mode
forward, with its own generator so the global one does not move), then
copies the arrays in.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FORMAT_VERSION = 1
# every port class lives at its JAX counterpart's path under this prefix
_FILE_PREFIX = "bigdl_tpu."
_PORT_PREFIX = "bigdl_tpu_torch."


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _log_softmax(x):
    return torch.log_softmax(x, -1)


def _softmax(x):
    return torch.softmax(x, -1)


# callables that may appear as constructor arguments, by the JAX package's names
_FN_REGISTRY: Dict[str, Any] = {
    "jnp.tanh": torch.tanh, "jnp.exp": torch.exp, "jnp.abs": torch.abs, "jnp.sqrt": torch.sqrt,
    "jnp.square": torch.square, "jax.nn.relu": torch.relu, "jax.nn.relu6": F.relu6,
    "jax.nn.sigmoid": torch.sigmoid, "jax.nn.softplus": F.softplus,
    "jax.nn.soft_sign": F.softsign, "jax.nn.silu": F.silu, "jax.nn.gelu": _gelu_tanh,
    "jax.nn.elu": F.elu, "jax.nn.leaky_relu": F.leaky_relu,
    "jax.nn.log_softmax": _log_softmax, "jax.nn.softmax": _softmax,
    "jax.nn.hard_sigmoid": F.hardsigmoid, "jax.nn.hard_tanh": F.hardtanh,
}


def _fn_name(fn) -> Optional[str]:
    for name, f in _FN_REGISTRY.items():
        if f is fn:
            return name
    return None


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r} in the model file")
    return dt


def class_ref(cls) -> Tuple[str, str]:
    """``(module, class)`` as a model file names ``cls``: the JAX package's
    module path for a class of the port."""
    module, name = cls.__module__, cls.__name__
    if module.startswith(_PORT_PREFIX):
        module = _FILE_PREFIX + module[len(_PORT_PREFIX):]
    return module, name


def _resolve_class(module: str, name: str):
    if not module.startswith(_FILE_PREFIX):
        raise ValueError(f"refusing to import {module!r}: model files may only reference "
                         f"{_FILE_PREFIX}* classes")
    return getattr(importlib.import_module(_PORT_PREFIX + module[len(_FILE_PREFIX):]), name)


# ------------------------------------------------------------------ encoding
def _encode(v) -> Any:
    from ..nn.module import AbstractModule

    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, AbstractModule):
        return {"__module__": module_to_spec(v)}
    if isinstance(v, (list, tuple)):
        return {"__seq__": type(v).__name__, "items": [_encode(x) for x in v]}
    if isinstance(v, dict):
        return {"__map__": {str(k): _encode(x) for k, x in v.items()}}
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, (np.dtype, torch.dtype)) or (isinstance(v, type)
                                                  and issubclass(v, np.generic)):
        return {"__dtype__": _dtype_name(v)}
    name = _fn_name(v) if callable(v) else None
    if name is not None:
        return {"__fn__": name}
    if type(v).__module__.startswith(_PORT_PREFIX):
        # regularizers, initialisation methods, ...: their recorded
        # constructor arguments (or none)
        args, kwargs = getattr(v, "_ctor_spec", ((), {}))
        module, cls = class_ref(type(v))
        return {"__obj__": {"class": cls, "module": module,
                            "args": [_encode(a) for a in args],
                            "kwargs": {k: _encode(x) for k, x in kwargs.items()}}}
    raise TypeError(f"cannot serialize ctor argument of type {type(v).__name__}: {v!r}")


def _decode(v, device) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, list):
        return [_decode(x, device) for x in v]
    if not isinstance(v, dict):
        raise TypeError(f"bad encoded value {v!r}")
    if "__module__" in v:
        return spec_to_module(v["__module__"], device)
    if "__seq__" in v:
        seq = [_decode(x, device) for x in v["items"]]
        return tuple(seq) if v["__seq__"] == "tuple" else seq
    if "__map__" in v:
        return {k: _decode(x, device) for k, x in v["__map__"].items()}
    if "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=np.dtype(v["dtype"]))
    if "__dtype__" in v:
        return _torch_dtype(v["__dtype__"])
    if "__fn__" in v:
        if v["__fn__"] not in _FN_REGISTRY:
            raise ValueError(f"unknown function {v['__fn__']!r} in the model file")
        return _FN_REGISTRY[v["__fn__"]]
    if "__obj__" in v:
        o = v["__obj__"]
        cls = _resolve_class(o["module"], o["class"])
        return cls(*[_decode(a, device) for a in o["args"]],
                   **{k: _decode(x, device) for k, x in o["kwargs"].items()})
    raise TypeError(f"bad encoded value {v!r}")


# ------------------------------------------------------------ module <-> spec
def module_to_spec(m) -> Dict[str, Any]:
    """The topology record of one module subtree."""
    from ..nn.module import Container

    if hasattr(m, "_serialize_spec"):  # a Graph's DAG
        spec = m._serialize_spec()
    else:
        args, kwargs = getattr(m, "_ctor_spec", ((), {}))
        module, cls = class_ref(type(m))
        spec = {"class": cls, "module": module, "args": [_encode(a) for a in args],
                "kwargs": {k: _encode(v) for k, v in kwargs.items()}}
        if isinstance(m, Container):
            spec["children"] = [module_to_spec(c) for c in m._layers]
    if m._name is not None:
        spec["name"] = m._name
    return spec


def spec_to_module(spec: Dict[str, Any], device=None):
    """A fresh, unbuilt module subtree on ``device`` from its record."""
    from ..nn.module import AbstractModule, Container

    cls = _resolve_class(spec["module"], spec["class"])
    if hasattr(cls, "_from_spec") and "graph" in spec:
        m = cls._from_spec(spec, device)
    else:
        kwargs = {k: _decode(v, device) for k, v in spec.get("kwargs", {}).items()}
        if issubclass(cls, AbstractModule):
            kwargs["device"] = device
        m = cls(*[_decode(a, device) for a in spec.get("args", [])], **kwargs)
        children = spec.get("children")
        if children is not None:
            if not isinstance(m, Container):
                raise ValueError(f"{spec['class']} has children in the file but is no container")
            # children the constructor made are a prefix of the record; add the rest
            for child_spec in children[len(m._layers):]:
                m.add(spec_to_module(child_spec, device))
            if len(m._layers) != len(children):
                raise ValueError(f"{spec['class']}: rebuilt {len(m._layers)} children, "
                                 f"the file has {len(children)}")
            for c, cspec in zip(m._layers, children):
                if "name" in cspec:
                    c._name = cspec["name"]
    if "name" in spec:
        m._name = spec["name"]
    return m


# -------------------------------------------------------------- input specs
def _encode_spec(s) -> Any:
    from .table import Table

    if isinstance(s, Table):
        return {"__table__": [_encode_spec(x) for x in s.to_list()]}
    if isinstance(s, (list, tuple)):
        return {"__seq__": type(s).__name__, "items": [_encode_spec(x) for x in s]}
    if isinstance(s, dict):
        return {"__map__": {str(k): _encode_spec(v) for k, v in s.items()}}
    if isinstance(s, torch.Tensor):
        return {"shape": list(s.shape), "dtype": _dtype_name(s.dtype)}
    raise TypeError(f"cannot serialize input spec leaf {type(s).__name__}")


def _decode_sample(s, device) -> Any:
    """The recorded input spec as a sample on ``device``: zeros, ones for
    integer and boolean inputs (valid ids of a 1-based table)."""
    from .table import T

    if isinstance(s, dict) and "__table__" in s:
        return T(*[_decode_sample(x, device) for x in s["__table__"]])
    if isinstance(s, dict) and "__seq__" in s:
        seq = [_decode_sample(x, device) for x in s["items"]]
        return tuple(seq) if s["__seq__"] == "tuple" else seq
    if isinstance(s, dict) and "__map__" in s:
        return {k: _decode_sample(v, device) for k, v in s["__map__"].items()}
    dt = _torch_dtype(s["dtype"])
    fill = torch.zeros if dt.is_floating_point or dt.is_complex else torch.ones
    return fill(tuple(s["shape"]), dtype=dt, device=device)


# ------------------------------------------------------------------ save/load
def save_module_def(path: str, module) -> None:
    """Write the topology and the arrays; ``load_module_def`` reads them
    back in a fresh process."""
    from .serialization import _atomic_savez, flatten_pytree

    if not module.is_built():
        raise ValueError("save_module_def: module must be built (run init/forward)")
    in_spec = getattr(module, "_top_in_spec", None)
    if in_spec is None:
        raise ValueError("save_module_def: module has no recorded input spec")
    meta = {"version": FORMAT_VERSION, "topology": module_to_spec(module),
            "in_spec": _encode_spec(in_spec)}
    arrays = flatten_pytree({"params": module.get_parameters(), "state": module.get_state()})
    arrays["__bigdl__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    _atomic_savez(path, arrays)


def load_module_def(path: str, device=None):
    """The model saved by ``save_module_def`` (either package's), rebuilt on
    ``device`` with its arrays."""
    from .serialization import copy_into

    with np.load(path) as z:
        if "__bigdl__" not in z.files:
            raise ValueError(f"{path} has no topology record — it is an arrays-only "
                             "checkpoint; rebuild the module in code and use load_module()")
        meta = json.loads(bytes(z["__bigdl__"].tobytes()).decode())
        flat = {k: z[k] for k in z.files if k != "__bigdl__"}
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"model file version {meta['version']} is newer than supported "
                         f"({FORMAT_VERSION})")
    m = spec_to_module(meta["topology"], device)
    generator = torch.Generator()
    generator.manual_seed(0)
    m.build(generator, _decode_sample(meta["in_spec"], m.device))
    for what, tree in (("params", m.get_parameters()), ("state", m.get_state())):
        copy_into(tree, {k[len(what) + 1:]: v for k, v in flat.items()
                         if k.startswith(what + "/")}, what)
    return m
