"""Keras-1.2.2 model converter (counterpart of
``bigdl_tpu/nn/keras/converter.py``; BigDL's ``DefinitionLoader`` +
``WeightLoader``).

``model_from_json`` rebuilds a keras ``model.to_json()`` topology onto the
port's keras wrapper layers (``bigdl_tpu_torch.nn.keras``);
``load_weights_hdf5`` reads the keras-1.2.2 weight-file layout (h5py: root
attrs ``layer_names``, per-layer group attrs ``weight_names``) and injects
converted arrays. ``h5py`` is imported inside ``load_weights_hdf5`` only.
The model lives on ``device``: the card unless ``"cpu"``.

Conventions (keras 1.2.2, ``dim_ordering='th'`` — the ordering the wrapper
layers implement): Dense kernel (in, out) → Linear (out, in) transpose;
Convolution2D kernel (nb_filter, stack, rows, cols) = OIHW as-is;
Embedding (vocab, dim) as-is; BatchNormalization [gamma, beta,
running_mean, running_std].
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import layers as L
from .topology import Model, Sequential


def _wrapper_class(class_name: str):
    cls = getattr(L, class_name, None)
    if cls is None and class_name == "InputLayer":
        return None
    if cls is None:
        raise ValueError(
            f"keras converter: unsupported layer class {class_name!r} — "
            "extend bigdl_tpu_torch.nn.keras.layers"
        )
    return cls


_RENAMES = {"batch_input_shape": "input_shape"}


def _build_layer(spec: Dict[str, Any], device=None):
    cls = _wrapper_class(spec["class_name"])
    if cls is None:
        return None
    cfg = dict(spec.get("config", {}))
    name = cfg.pop("name", None)
    kwargs: Dict[str, Any] = {}
    sig = inspect.signature(cls.__init__)
    accepts = set(sig.parameters)
    has_var_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )
    for key, value in cfg.items():
        key = _RENAMES.get(key, key)
        if key == "input_shape" and value is not None:
            value = tuple(d for d in value[1:])  # drop the batch dim
            if not value:
                value = None
        if isinstance(value, list):
            value = tuple(value)
        if key in accepts or has_var_kw:
            kwargs[key] = value
    kwargs["device"] = device
    layer = cls(**kwargs)
    if name:
        layer.set_name(name)
    return layer


def _build_model_layer(spec: Dict[str, Any], device=None):
    """Layer spec -> wrapper layer OR nested Sequential/Model (recursion)."""
    cls_name = spec["class_name"]
    if cls_name in ("Model", "Sequential"):
        nested = _model_from_spec(spec, device)
        cfg = spec.get("config", {})
        # keras 1.x Sequential config is a bare LIST of layer specs
        name = spec.get("name") or (cfg.get("name")
                                    if isinstance(cfg, dict) else None)
        if name:
            nested.set_name(name)
        return nested
    return _build_layer(spec, device)


def model_from_json(text: str, device=None):
    """keras ``model.to_json()`` → keras-API Sequential/Model on ``device``."""
    return _model_from_spec(json.loads(text), device)


def _model_from_spec(spec: Dict[str, Any], device=None):
    if spec.get("class_name") == "Sequential":
        model = Sequential(device=device)
        cfg = spec["config"]
        layer_specs = cfg["layers"] if isinstance(cfg, dict) else cfg
        for layer_spec in layer_specs:
            layer = _build_model_layer(layer_spec, device)
            if layer is not None:
                model.add(layer)
        return model
    if spec.get("class_name") == "Model":
        return _functional_from_config(spec["config"], device)
    raise ValueError(f"unsupported keras model class {spec.get('class_name')!r}")


def _functional_from_config(cfg: Dict[str, Any], device=None):
    """Functional-API rebuild with full node semantics (VERDICT r3 #6).

    Each layer's ``inbound_nodes`` is a LIST of calls (a shared layer has
    several); downstream refs ``[name, node_index, tensor_index]`` pick a
    specific call's output. Shared layers map to one module wired at
    several graph nodes — ``nn.Graph`` registers it once, so keras weight-
    sharing semantics (summed gradients) hold exactly. Nested
    Sequential/Model layer specs recurse through the converter and wire as
    single nodes. Multi-output refs (``tensor_index != 0``) have no
    wrapper-layer counterpart and are rejected with a clear error."""
    from ..graph import Input

    # graph nodes per (layer_name, node_index)
    calls: Dict[tuple, Any] = {}
    layers: Dict[str, Any] = {}
    inputs: List[Any] = []

    def ref_key(ref) -> tuple:
        name, node_index = ref[0], ref[1] if len(ref) > 1 else 0
        tensor_index = ref[2] if len(ref) > 2 else 0
        if tensor_index != 0:
            raise ValueError(
                f"keras converter: ref to {name!r} uses tensor_index "
                f"{tensor_index} — multi-output layers are not supported"
            )
        return (name, node_index)

    pending: List[tuple] = []  # (layer_name, node_index, [parent refs])
    for layer_spec in cfg["layers"]:
        cfg_l = layer_spec.get("config", {})
        name = layer_spec.get("name") or (cfg_l.get("name")
                                          if isinstance(cfg_l, dict) else None)
        if layer_spec["class_name"] == "InputLayer":
            node = Input()
            calls[(name, 0)] = node
            inputs.append(node)
            continue
        layer = _build_model_layer(layer_spec, device)
        layers[name] = layer
        inbound = layer_spec.get("inbound_nodes") or []
        if not inbound:
            raise ValueError(
                f"keras converter: functional layer {name!r} has no "
                "inbound_nodes"
            )
        for node_index, call in enumerate(inbound):
            pending.append((name, node_index, [ref_key(r) for r in call]))

    # keras orders layer ENTRIES topologically but a shared layer's later
    # calls may depend on nodes created after its entry — fixed-point wiring
    while pending:
        progressed = False
        still = []
        for name, node_index, parent_keys in pending:
            if all(k in calls for k in parent_keys):
                parents = [calls[k] for k in parent_keys]
                calls[(name, node_index)] = layers[name].inputs(*parents)
                progressed = True
            else:
                still.append((name, node_index, parent_keys))
        if not progressed:
            missing = sorted({k for _, _, pk in still for k in pk
                              if k not in calls})
            raise ValueError(
                f"keras converter: unresolvable inbound refs {missing} — "
                "cycle or reference to a missing layer/call"
            )
        pending = still

    outputs = [calls[ref_key(ref)] for ref in cfg["output_layers"]]
    return Model(inputs, outputs, device=device)


# ------------------------------------------------------------------- weights
def _top_level_layers(model) -> List[Any]:
    """Direct children that correspond to keras layer entries (wrapper
    layers and nested models)."""
    return [m for m in getattr(model, "_layers", [])
            if isinstance(m, (L.KerasLayer, Sequential, Model))]


def _collect_layers(model) -> List[Any]:
    """Depth-first wrapper-layer leaves (nested models flattened)."""
    out: List[Any] = []
    for m in getattr(model, "_layers", []):
        if isinstance(m, (Sequential, Model)):
            out.extend(_collect_layers(m))
        elif isinstance(m, L.KerasLayer):
            out.append(m)
    return out


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 0 if tree is None else 1


def _n_arrays(layer) -> int:
    """How many keras weight arrays a BUILT layer consumes.

    NOT simply this framework's param-leaf count: keras array layouts
    differ per layer family (e.g. a keras-1.x LSTM stores 12 arrays where
    the fused cell here holds 3), so splitting a nested model's flat
    weight group needs an explicit per-type table; unknown parameterized
    types are rejected rather than silently misaligned."""
    n_params = _n_leaves(layer.get_parameters())
    if isinstance(layer, L.BatchNormalization):
        return 4
    if isinstance(layer, (L.Dense, L.Convolution2D, L.Convolution1D,
                          L.Embedding)):
        return n_params  # weight [+ bias] map 1:1
    if isinstance(layer, (Sequential, Model)):
        return sum(_n_arrays(l) for l in _collect_layers(layer))
    if n_params:
        raise ValueError(
            f"keras converter: cannot split a nested weight group across "
            f"{type(layer).__name__} ({layer.name()!r}) — its keras array "
            "count is unknown; load it as a top-level layer instead"
        )
    return 0


def _convert_layer_weights(layer, arrays: List[np.ndarray]) -> None:
    """Inject keras-layout arrays into a BUILT wrapper layer."""
    if isinstance(layer, (Sequential, Model)):
        # nested model: keras saves ONE group whose arrays span the nested
        # layers in order — split by each leaf's arity
        leaves = [l for l in _collect_layers(layer) if _n_arrays(l)]
        i = 0
        for leaf in leaves:
            k = _n_arrays(leaf)
            _convert_layer_weights(leaf, arrays[i:i + k])
            i += k
        if i != len(arrays):
            raise ValueError(
                f"nested model {layer.name()!r}: weight group has "
                f"{len(arrays)} arrays, layers consume {i}"
            )
        return
    if isinstance(layer, L.Dense):
        inner = layer[0]  # Linear
        params = dict(inner.get_parameters())
        params["weight"] = np.ascontiguousarray(arrays[0].T)
        if len(arrays) > 1 and "bias" in params:
            params["bias"] = arrays[1]
        inner.set_parameters(params)
        return
    if isinstance(layer, (L.Convolution2D, L.Convolution1D)):
        inner = layer[0]
        params = dict(inner.get_parameters())
        params["weight"] = arrays[0]
        if len(arrays) > 1 and "bias" in params:
            params["bias"] = arrays[1]
        inner.set_parameters(params)
        return
    if isinstance(layer, L.Embedding):
        inner = layer[len(layer) - 1]
        params = dict(inner.get_parameters())
        params["weight"] = arrays[0]
        inner.set_parameters(params)
        return
    if isinstance(layer, L.BatchNormalization):
        inner = layer[0]
        params = dict(inner.get_parameters())
        state = dict(inner.get_state())
        params["weight"], params["bias"] = arrays[0], arrays[1]
        if len(arrays) > 3:
            # keras 1.x names weights[3] 'running_std' but it actually holds the
            # running VARIANCE (K.normalize_batch_in_training returns var and
            # K.batch_normalization consumes it as var) — pass through unsquared.
            for key, arr in (("running_mean", arrays[2]), ("running_var", arrays[3])):
                state[key] = torch.as_tensor(np.asarray(arr), dtype=state[key].dtype,
                                             device=state[key].device)
        inner.set_parameters(params)
        inner.set_state(state)
        return
    # generic fallback: positional injection into the first parameterized child
    for inner in getattr(layer, "_layers", []):
        params = dict(inner.get_parameters())
        if params:
            keys = list(params)
            for key, arr in zip(keys, arrays):
                params[key] = arr
            inner.set_parameters(params)
            return


def load_weights_hdf5(model, path: str, by_name: bool = False) -> None:
    """Load a keras-1.2.2 ``save_weights`` hdf5 into a built model."""
    import h5py

    if not model.is_built():
        raise ValueError("build the model first (call forward once or build())")
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in root.attrs["layer_names"]
        ]
        per_layer: Dict[str, List[np.ndarray]] = {}
        for lname in layer_names:
            g = root[lname]
            weight_names = [
                n.decode() if isinstance(n, bytes) else n
                for n in g.attrs["weight_names"]
            ]
            per_layer[lname] = [np.asarray(g[w]) for w in weight_names]

    layers = _top_level_layers(model)
    if by_name:
        for layer in layers:
            arrays = per_layer.get(layer.name())
            if arrays:
                _convert_layer_weights(layer, arrays)
    else:
        stacked = [per_layer[n] for n in layer_names if per_layer[n]]
        with_params = [l for l in layers if _n_arrays(l)]
        if len(stacked) != len(with_params):
            raise ValueError(
                f"weight file has {len(stacked)} parameterized layers, "
                f"model has {len(with_params)}"
            )
        for layer, arrays in zip(with_params, stacked):
            _convert_layer_weights(layer, arrays)


def load_keras(json_path: str, hdf5_path: Optional[str] = None,
               sample_input=None, by_name: bool = False, device=None):
    """One-call import (the ``DefinitionLoader.from_json_path`` +
    ``WeightLoader.load_weights_from_hdf5`` flow) onto ``device``."""
    with open(json_path) as f:
        model = model_from_json(f.read(), device)
    if hdf5_path is not None:
        if sample_input is None:
            raise ValueError("sample_input is required to build before weights")
        with torch.no_grad():
            model.forward(np.asarray(sample_input))
        load_weights_hdf5(model, hdf5_path, by_name=by_name)
    return model
