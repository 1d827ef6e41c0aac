"""TensorFlow GraphDef EXPORT (counterpart of ``bigdl_tpu/utils/tf_saver.py``;
BigDL's ``TensorflowSaver``).

Writes a frozen GraphDef (public tensorflow graph.proto wire format, encoded
with the in-repo ``WireWriter`` — no TF dependency) from a built
Sequential/Graph. Weights are inlined as Const nodes (float32 host copies of
the parameters, wherever they live), so the file is the frozen-graph form
the loader (``utils/tf_loader``) and stock TF both read.

Layout: this framework is NCHW (Torch convention); TF convs/pools are NHWC.
Conv/pool layers are exported as Transpose(NCHW→NHWC) → op → Transpose
back, with filters rewritten OIHW→HWIO — the same transpose-insertion the
reference saver performs. Shape-dependent glue (Flatten/Reshape) resolves
its static target from the per-module specs (``infer_module_shape`` on meta
tensors: nothing runs on the card).

Supported: Linear (MatMul+BiasAdd); SpatialConvolution incl. dilated (pad 0
= VALID, pad -1 = SAME, or pad effective_k//2 at stride 1 with odd
EFFECTIVE — i.e. dilated — kernels); SpatialMax/AveragePooling (pad 0 =
VALID, pad -1 = SAME; ceil-mode and sum-pooling raise; SAME avg-pool
requires count_include_pad=False, the TF divide-by-valid-count semantic);
ReLU/ReLU6/Sigmoid/Tanh/SoftPlus, SoftMax, LogSoftMax (Softmax+Log),
CAddTable/CSubTable/CMulTable, Flatten/Reshape, Identity/Dropout
(inference pass-through). A conv or linear layer with a declared epilogue
(``activation=``) is refused: the file would drop the activation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .protowire import WireWriter

_DT_FLOAT = 1
_DT_INT32 = 3


def _tensor_proto(arr: np.ndarray) -> WireWriter:
    if np.issubdtype(np.asarray(arr).dtype, np.integer):
        arr = np.ascontiguousarray(arr, np.int32)
        dt = _DT_INT32
    else:
        arr = np.ascontiguousarray(arr, np.float32)
        dt = _DT_FLOAT
    t = WireWriter()
    t.varint(1, dt)
    shape = WireWriter()
    for d in arr.shape:
        dim = WireWriter()
        dim.varint(1, int(d))
        shape.message(2, dim)
    t.message(2, shape)
    t.bytes_(4, arr.tobytes())
    return t


def _attr(w: WireWriter, key: str, value: WireWriter) -> None:
    entry = WireWriter()
    entry.string(1, key)
    entry.message(2, value)
    w.message(5, entry)


def _attr_s(s: str) -> WireWriter:
    v = WireWriter()
    v.string(2, s)
    return v


def _attr_ilist(ints) -> WireWriter:
    lst = WireWriter()
    for i in ints:
        lst.varint(3, int(i))
    v = WireWriter()
    v.message(1, lst)
    return v


def _node(g: WireWriter, name: str, op: str, inputs: Tuple[str, ...] = (),
          attrs: Optional[Dict[str, WireWriter]] = None) -> str:
    n = WireWriter()
    n.string(1, name)
    n.string(2, op)
    for i in inputs:
        n.string(3, i)
    for k, v in (attrs or {}).items():
        _attr(n, k, v)
    g.message(1, n)
    return name


def _const(g: WireWriter, name: str, arr: np.ndarray) -> str:
    val = WireWriter()
    val.message(8, _tensor_proto(arr))
    dt = WireWriter()
    dt.varint(6, _DT_INT32 if np.issubdtype(np.asarray(arr).dtype, np.integer)
              else _DT_FLOAT)
    return _node(g, name, "Const", attrs={"value": val, "dtype": dt})


def _host(t) -> np.ndarray:
    """A parameter as a float32 host array (inlined as a Const)."""
    return t.detach().to("cpu", torch.float32).numpy()


def _no_epilogue(module) -> None:
    if getattr(module, "activation", None) is not None:
        raise ValueError(
            f"TensorflowSaver: {module.name()} declares an activation epilogue "
            f"({module.activation!r}); export a model whose activations are "
            "their own modules")


class _Exporter:
    def __init__(self):
        self.g = WireWriter()
        self.used: Dict[str, int] = {}

    def fresh(self, base: str) -> str:
        k = self.used.get(base, 0)
        self.used[base] = k + 1
        return base if k == 0 else f"{base}_{k}"

    def _transpose(self, name: str, src: str, perm) -> str:
        pname = _const(self.g, name + "/perm", np.asarray(perm, np.int32))
        return _node(self.g, name, "Transpose", (src, pname))

    def _tf_padding(self, module, dilation=(1, 1)) -> str:
        kh, kw = module.kernel
        # SAME-equivalence must use the EFFECTIVE (dilated) kernel extent
        ekh = kh + (kh - 1) * (dilation[0] - 1)
        ekw = kw + (kw - 1) * (dilation[1] - 1)
        ph, pw = module.pad
        if (ph, pw) == (0, 0):
            return "VALID"
        if (ph, pw) == (-1, -1):  # the repo's SAME_PADDING convention
            return "SAME"
        sh, sw = module.stride
        if (sh, sw) == (1, 1) and ekh % 2 and ekw % 2 and \
                (ph, pw) == (ekh // 2, ekw // 2):
            return "SAME"
        raise ValueError(
            f"TensorflowSaver: padding {module.pad} of {module.name()} has no "
            "TF SAME/VALID equivalent (TF supports pad 0, pad -1 = SAME, or "
            "effective-k//2 with stride 1 and odd effective kernels)"
        )

    def emit(self, module, params, inputs: List[str], in_spec,
             out_spec=None) -> str:
        """Emit nodes for one module; returns its output node name.
        ``out_spec`` (when the caller already traced it) avoids re-tracing
        for the shape-glue branch."""
        from .. import nn as N

        name = self.fresh(module.name())
        simple = {
            N.ReLU: "Relu", N.ReLU6: "Relu6", N.Sigmoid: "Sigmoid",
            N.Tanh: "Tanh", N.SoftPlus: "Softplus", N.SoftMax: "Softmax",
            N.Abs: "Abs", N.Exp: "Exp", N.Log: "Log", N.Sqrt: "Sqrt",
            N.Square: "Square",
        }
        for cls, op in simple.items():
            if type(module) is cls:
                return _node(self.g, name, op, (inputs[0],))
        if isinstance(module, N.LogSoftMax):
            sm = _node(self.g, name + "/softmax", "Softmax", (inputs[0],))
            return _node(self.g, name, "Log", (sm,))
        if isinstance(module, N.Linear):
            _no_epilogue(module)
            w = _host(params["weight"])  # (out, in) -> TF wants (in, out)
            wname = _const(self.g, name + "/w", w.T)
            mm = _node(self.g, name + "/mm", "MatMul", (inputs[0], wname))
            if not module.with_bias:
                return _node(self.g, name, "Identity", (mm,))
            bname = _const(self.g, name + "/b", _host(params["bias"]))
            return _node(self.g, name, "BiasAdd", (mm, bname))
        if isinstance(module, N.SpatialConvolution):
            if module.n_group != 1:
                raise ValueError("TensorflowSaver: grouped conv not supported")
            _no_epilogue(module)
            dilation = tuple(getattr(module, "dilation", (1, 1)))
            padding = self._tf_padding(module, dilation)
            nhwc = self._transpose(name + "/to_nhwc", inputs[0], [0, 2, 3, 1])
            w = _host(params["weight"])  # OIHW -> HWIO
            wname = _const(self.g, name + "/w", w.transpose(2, 3, 1, 0))
            attrs = {"strides": _attr_ilist([1, *module.stride, 1]),
                     "padding": _attr_s(padding),
                     "data_format": _attr_s("NHWC")}
            if dilation != (1, 1):
                attrs["dilations"] = _attr_ilist([1, *dilation, 1])
            conv = _node(
                self.g, name + "/conv", "Conv2D", (nhwc, wname), attrs=attrs,
            )
            if module.with_bias:
                bname = _const(self.g, name + "/b", _host(params["bias"]))
                conv = _node(self.g, name + "/biasadd", "BiasAdd",
                             (conv, bname))
            return self._transpose(name, conv, [0, 3, 1, 2])
        if isinstance(module, (N.SpatialMaxPooling, N.SpatialAveragePooling)):
            if module.pad == (0, 0):
                padding = "VALID"
            elif module.pad == (-1, -1):
                padding = "SAME"
            else:
                raise ValueError(
                    "TensorflowSaver: explicitly padded pooling has no TF "
                    "equivalent (pad 0 = VALID, pad -1 = SAME)"
                )
            if getattr(module, "global_pooling", False):
                raise ValueError(
                    "TensorflowSaver: global pooling not supported"
                )
            if getattr(module, "ceil_mode", False):
                raise ValueError(
                    "TensorflowSaver: ceil-mode pooling has no TF equivalent "
                    "(TF pools size with floor)"
                )
            if isinstance(module, N.SpatialAveragePooling):
                if not module.divide:
                    raise ValueError(
                        "TensorflowSaver: sum-pooling (divide=False) has no "
                        "TF AvgPool equivalent"
                    )
                # TF AvgPool divides SAME-padded border windows by the VALID
                # element count — that is count_include_pad=False semantics;
                # with VALID padding there are no pad cells so either is fine
                if padding == "SAME" and module.count_include_pad:
                    raise ValueError(
                        "TensorflowSaver: SAME avg-pool with "
                        "count_include_pad=True divides by the full kernel "
                        "area; TF divides by the valid count — build the "
                        "module with count_include_pad=False to export"
                    )
            op = "MaxPool" if isinstance(module, N.SpatialMaxPooling) else "AvgPool"
            nhwc = self._transpose(name + "/to_nhwc", inputs[0], [0, 2, 3, 1])
            pool = _node(
                self.g, name + "/pool", op, (nhwc,),
                attrs={"ksize": _attr_ilist([1, *module.kernel, 1]),
                       "strides": _attr_ilist([1, *module.stride, 1]),
                       "padding": _attr_s(padding),
                       "data_format": _attr_s("NHWC")},
            )
            return self._transpose(name, pool, [0, 3, 1, 2])
        if isinstance(module, (N.Flatten, N.Reshape, N.View)):
            # static target from the traced spec; -1 keeps batch flexible
            if out_spec is None:
                out_spec = _out_spec(module, in_spec)
            target = np.asarray([-1, *out_spec.shape[1:]], np.int32)
            sname = _const(self.g, name + "/shape", target)
            return _node(self.g, name, "Reshape", (inputs[0], sname))
        if isinstance(module, N.CAddTable):
            return _node(self.g, name, "AddV2", tuple(inputs))
        if isinstance(module, N.CSubTable):
            return _node(self.g, name, "Sub", tuple(inputs))
        if isinstance(module, N.CMulTable):
            return _node(self.g, name, "Mul", tuple(inputs))
        if isinstance(module, (N.Identity, N.Dropout, N.Contiguous)):
            return _node(self.g, name, "Identity", (inputs[0],))
        raise ValueError(
            f"TensorflowSaver: no TF mapping for {type(module).__name__} "
            f"({module.name()}) — extend _Exporter.emit"
        )


def _out_spec(module, in_spec):
    from ..nn.module import infer_module_shape

    return infer_module_shape(module, in_spec)


def save_tf(model, path: str, input_name: str = "input") -> str:
    """Export a built Sequential/Graph to a frozen GraphDef at ``path``.

    Returns the final node's ACTUAL exported name (``_Exporter.fresh`` renames
    collisions to ``name_1``...), which ``output_node_name`` then reports —
    round-trips through ``load_tf(path, [input_name], [<returned name>])``."""
    from ..nn.graph import Graph
    from ..nn.module import Sequential

    ex = _Exporter()
    dt = WireWriter()
    dt.varint(6, _DT_FLOAT)
    _node(ex.g, input_name, "Placeholder", attrs={"dtype": dt})
    # claim the placeholder's name so a module that happens to share it gets
    # collision-renamed by fresh() instead of emitting a duplicate node
    ex.used[input_name] = 1

    top_spec = getattr(model, "_top_in_spec", None)
    if isinstance(model, Sequential):
        prev, spec = input_name, top_spec
        for m in model._layers:
            out = _out_spec(m, spec) if spec is not None else None
            prev = ex.emit(m, m.get_parameters() or {}, [prev], spec, out)
            spec = out
    elif isinstance(model, Graph):
        names: Dict[int, str] = {}
        specs: Dict[int, Any] = {}
        for node in model.input_nodes:
            names[node.id] = input_name
            specs[node.id] = top_spec
        for node in model._topo:
            if node.id in names:
                continue
            ins = [names[p.id] for p in node.parents]
            pspecs = [specs.get(p.id) for p in node.parents]
            in_spec = pspecs[0] if len(pspecs) == 1 else pspecs
            out = _out_spec(node.module, in_spec) if in_spec is not None else None
            names[node.id] = ex.emit(
                node.module, node.module.get_parameters() or {}, ins, in_spec,
                out,
            )
            specs[node.id] = out
        prev = names[model.output_nodes[0].id]
    else:
        raise ValueError("save_tf expects a Sequential or Graph")

    with open(path, "wb") as f:
        f.write(ex.g.blob())
    model._tf_output_node = prev
    return prev


def output_node_name(model) -> str:
    """The name ``save_tf`` gave the final node.

    Consults the name recorded by the last ``save_tf`` call (collision-renamed
    via ``_Exporter.fresh``); falls back to the module's own name if the model
    has not been exported yet. A recorded name is only trusted while it still
    derives from the model's CURRENT final module — structurally modifying
    the model after a save invalidates the cache instead of silently
    returning a stale node name."""
    from ..nn.graph import Graph

    if isinstance(model, Graph):
        current = model.output_nodes[0].module.name()
    else:
        current = model[len(model) - 1].name()
    recorded = getattr(model, "_tf_output_node", None)
    if recorded is not None and (
        recorded == current
        or (recorded.startswith(current + "_")
            and recorded[len(current) + 1:].isdigit())  # fresh() rename
    ):
        return recorded
    return current
