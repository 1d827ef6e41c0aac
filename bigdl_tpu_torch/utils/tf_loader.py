"""TensorFlow GraphDef import (counterpart of ``bigdl_tpu/utils/tf_loader.py``;
BigDL's ``TensorflowLoader``).

No tensorflow dependency: the protobuf **wire-format** reader decodes the
GraphDef message subset the converter needs (nodes, ops, inputs, attrs,
const tensors), then nodes map onto ``bigdl_tpu_torch.nn.ops`` modules wired
into a ``Graph``. The tensors are numpy at parse; the modules (a ``Const``'s
value too) live on the loader's device, the card unless ``device="cpu"``.
A ``DT_INT64``/``DT_DOUBLE`` value narrows to int32/float32 there, as the
JAX package's does with 64-bit types off.

Wire format facts used (public protobuf spec): a message is a stream of
(tag = field_no << 3 | wire_type) varints; wire type 0 = varint, 1 = 64-bit,
2 = length-delimited (submessage / string / packed), 5 = 32-bit.

GraphDef schema subset (public tensorflow/core/framework protos):
  GraphDef.node = 1 (NodeDef)
  NodeDef: name = 1, op = 2, input = 3 (repeated), attr = 5 (map)
  map entry: key = 1, value = 2 (AttrValue)
  AttrValue: s = 2, i = 3, f = 4, b = 5, type = 6, shape = 7, tensor = 8
  TensorProto: dtype = 1, tensor_shape = 2, tensor_content = 4,
               float_val = 5 (packed), int_val = 6 (packed)
  TensorShapeProto.dim = 2; Dim.size = 1
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .. import nn
from ..nn import ops as O
from ..nn.graph import Graph, Input, ModuleNode
from .protowire import WireReader as _Reader
from .protowire import signed64 as _signed64



# TF DataType enum values the importer understands
_TF_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64,
              10: np.bool_}



def _parse_tensor(r: _Reader) -> np.ndarray:
    dtype = np.float32
    dims: List[int] = []
    content = b""
    floats: List[float] = []
    ints: List[int] = []
    while not r.done():
        f, wt = r.field()
        if f == 1 and wt == 0:
            code = r.varint()
            if code not in _TF_DTYPES:
                raise ValueError(
                    f"unsupported TF tensor dtype enum {code} — extend "
                    "bigdl_tpu_torch.utils.tf_loader._TF_DTYPES"
                )
            dtype = _TF_DTYPES[code]
        elif f == 2 and wt == 2:  # tensor_shape
            sh = r.sub()
            while not sh.done():
                sf, swt = sh.field()
                if sf == 2 and swt == 2:  # dim
                    d = sh.sub()
                    while not d.done():
                        df, dwt = d.field()
                        if df == 1 and dwt == 0:
                            dims.append(_signed64(d.varint()))
                        else:
                            d.skip(dwt)
                else:
                    sh.skip(swt)
        elif f == 4 and wt == 2:
            content = r.bytes_()
        elif f == 5:  # float_val (packed or repeated)
            if wt == 2:
                sub = r.sub()
                while not sub.done():
                    floats.append(sub.f32())
            else:
                floats.append(r.f32())
        elif f in (7, 10, 11):  # int_val=7 / int64_val=10 / bool_val=11
            if wt == 2:
                sub = r.sub()
                while not sub.done():
                    ints.append(_signed64(sub.varint()))
            else:
                ints.append(_signed64(r.varint()))
        elif f == 6:  # double_val=6 (golden-fixture finding: was swapped w/ int_val)
            if wt == 2:
                sub = r.sub()
                while not sub.done():
                    floats.append(sub.f64())
            else:
                floats.append(r.f64())
        else:
            r.skip(wt)
    shape = tuple(dims)
    if content:
        arr = np.frombuffer(content, dtype)
    elif floats:
        arr = np.asarray(floats, dtype)
    elif ints:
        arr = np.asarray(ints, dtype)
    else:
        arr = np.zeros(shape or (0,), dtype)
    if shape and arr.size == int(np.prod(shape)):
        arr = arr.reshape(shape)
    elif shape and arr.size == 1:
        arr = np.full(shape, arr.ravel()[0], dtype)  # splat-encoded const
    return arr


def _parse_attr_list(r: _Reader) -> Any:
    """AttrValue.ListValue: repeated s=2 / i=3 / f=4 / b=5."""
    out: List[Any] = []
    while not r.done():
        f, wt = r.field()
        if f == 2 and wt == 2:
            out.append(r.bytes_())
        elif f == 3 and wt == 0:
            out.append(_signed64(r.varint()))
        elif f == 4 and wt == 5:
            out.append(r.f32())
        elif f == 5 and wt == 0:
            out.append(bool(r.varint()))
        else:
            r.skip(wt)
    return out


def _parse_attr(r: _Reader) -> Any:
    while not r.done():
        f, wt = r.field()
        if f == 1 and wt == 2:
            return ("list", _parse_attr_list(r.sub()))
        if f == 2 and wt == 2:
            return ("s", r.bytes_())
        if f == 3 and wt == 0:
            return ("i", _signed64(r.varint()))
        if f == 4 and wt == 5:
            return ("f", r.f32())
        if f == 5 and wt == 0:
            return ("b", bool(r.varint()))
        if f == 6 and wt == 0:
            return ("type", r.varint())
        if f == 8 and wt == 2:
            return ("tensor", _parse_tensor(r.sub()))
        r.skip(wt)
    return (None, None)


class NodeDef:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self):
        self.name = ""
        self.op = ""
        self.inputs: List[str] = []
        self.attrs: Dict[str, Any] = {}


def parse_graph_def(blob: bytes) -> List[NodeDef]:
    """Serialized GraphDef -> NodeDef list (wire-format decode, no TF)."""
    nodes: List[NodeDef] = []
    r = _Reader(blob)
    while not r.done():
        f, wt = r.field()
        if f == 1 and wt == 2:
            nr = r.sub()
            node = NodeDef()
            while not nr.done():
                nf, nwt = nr.field()
                if nf == 1 and nwt == 2:
                    node.name = nr.bytes_().decode()
                elif nf == 2 and nwt == 2:
                    node.op = nr.bytes_().decode()
                elif nf == 3 and nwt == 2:
                    node.inputs.append(nr.bytes_().decode())
                elif nf == 5 and nwt == 2:
                    entry = nr.sub()
                    key, value = "", (None, None)
                    while not entry.done():
                        ef, ewt = entry.field()
                        if ef == 1 and ewt == 2:
                            key = entry.bytes_().decode()
                        elif ef == 2 and ewt == 2:
                            value = _parse_attr(entry.sub())
                        else:
                            entry.skip(ewt)
                    node.attrs[key] = value
                else:
                    nr.skip(nwt)
            nodes.append(node)
        else:
            r.skip(wt)
    return nodes


# --------------------------------------------------------------- conversion


def _attr(node: NodeDef, key: str, default=None):
    kind, val = node.attrs.get(key, (None, default))
    if kind == "s" and isinstance(val, bytes):
        return val.decode()
    return val


#: ops whose trailing inputs are shape/axis CONSTS to fold at import time
#: (TF passes them as tensors; the modules take them as configuration) —
#: maps op -> a function taking (node, const_vals, module kwargs) and returning
#: (module, n_data_inputs)
def _fold_reshape(node, const_vals, d):
    if len(const_vals) < 2 or const_vals[1] is None:
        raise ValueError(f"Reshape {node.name}: shape input is not a Const — "
                         "freeze the graph with shapes inlined")
    return O.ReshapeOp(const_vals[1].ravel(), **d), 1


def _fold_expand_dims(node, const_vals, d):
    if len(const_vals) < 2 or const_vals[1] is None:
        raise ValueError(f"ExpandDims {node.name}: axis input is not a Const")
    return O.ExpandDims(int(const_vals[1].ravel()[0]), **d), 1


def _fold_argmax(node, const_vals, d):
    if len(const_vals) < 2 or const_vals[1] is None:
        raise ValueError(f"{node.op} {node.name}: dimension input is not a Const")
    axis = int(const_vals[1].ravel()[0])
    return (O.ArgMax(axis, **d) if node.op == "ArgMax" else O.ArgMin(axis, **d)), 1


def _fold_pad(node, const_vals, d):
    if len(const_vals) < 2 or const_vals[1] is None:
        raise ValueError(f"Pad {node.name}: paddings input is not a Const")
    return O.Pad([tuple(p) for p in const_vals[1].reshape(-1, 2)], **d), 1


def _fold_transpose(node, const_vals, d):
    if len(const_vals) < 2 or const_vals[1] is None:
        raise ValueError(f"Transpose {node.name}: perm input is not a Const")
    return O.TransposeOp([int(p) for p in const_vals[1].ravel()], **d), 1


def _fold_reduce(node, const_vals, d):
    if len(const_vals) < 2 or const_vals[1] is None:
        raise ValueError(
            f"{node.op} {node.name}: reduction_indices input is not a Const")
    keep = bool(node.attrs.get("keep_dims", (None, False))[1])
    return O.ReduceOp(node.op, const_vals[1].ravel().tolist(), keep, **d), 1


def _fold_concat(node, const_vals, d):
    # ConcatV2: values..., axis (LAST input is the const axis)
    if not const_vals or const_vals[-1] is None:
        raise ValueError(f"{node.op} {node.name}: axis input is not a Const")
    return O.ConcatOp(int(const_vals[-1].ravel()[0]), **d), len(const_vals) - 1


_CONST_FOLD = {
    "Reshape": _fold_reshape,
    "ExpandDims": _fold_expand_dims,
    "ArgMax": _fold_argmax,
    "ArgMin": _fold_argmax,
    "Pad": _fold_pad,
    "Transpose": _fold_transpose,
    "Mean": _fold_reduce,
    "Sum": _fold_reduce,
    "Max": _fold_reduce,
    "Min": _fold_reduce,
    "ConcatV2": _fold_concat,
}


def _module_for(node: NodeDef, d: Dict[str, Any]) -> Optional[nn.AbstractModule]:
    op = node.op
    if op == "Conv2D":
        return O.Conv2D(
            _attr(node, "strides", [1, 1, 1, 1]) or [1, 1, 1, 1],
            _attr(node, "padding", "VALID") or "VALID",
            _attr(node, "data_format", "NHWC") or "NHWC",
            dilations=_attr(node, "dilations", None), **d,
        )
    if op in ("MaxPool", "AvgPool"):
        cls = O.MaxPool if op == "MaxPool" else O.AvgPool
        return cls(
            _attr(node, "ksize", [1, 2, 2, 1]) or [1, 2, 2, 1],
            _attr(node, "strides", [1, 2, 2, 1]) or [1, 2, 2, 1],
            _attr(node, "padding", "VALID") or "VALID",
            _attr(node, "data_format", "NHWC") or "NHWC", **d,
        )
    if op == "Const":
        kind, tensor = node.attrs.get("value", (None, None))
        if kind != "tensor":
            raise ValueError(f"Const {node.name} has no tensor value")
        return O.Const(tensor, **d)
    if op in ("Placeholder", "PlaceholderV2", "Identity", "NoOp",
              "StopGradient"):
        return None  # wiring-only
    simple = {
        "Relu": nn.ReLU, "Relu6": nn.ReLU6, "Sigmoid": nn.Sigmoid,
        "Tanh": nn.Tanh, "Softmax": nn.SoftMax, "Softplus": nn.SoftPlus,
        "Abs": nn.Abs, "Exp": nn.Exp, "Log": nn.Log, "Neg": nn.Neg,
        "Sqrt": nn.Sqrt, "Square": nn.Square, "Floor": O.Floor,
        "Ceil": O.Ceil, "Round": O.Round, "Sign": O.Sign, "Rsqrt": O.Rsqrt,
        "Add": nn.CAddTable, "AddV2": nn.CAddTable, "Sub": nn.CSubTable,
        "Mul": nn.CMulTable, "Maximum": O.Maximum, "Minimum": O.Minimum,
        "BiasAdd": O.BiasAdd, "Equal": O.Equal, "NotEqual": O.NotEqual,
        "Greater": O.Greater, "GreaterEqual": O.GreaterEqual,
        "Less": O.Less, "LessEqual": O.LessEqual,
        "LogicalAnd": O.LogicalAnd, "LogicalOr": O.LogicalOr,
        "LogicalNot": O.LogicalNot, "Select": O.SelectOp,
        "SquaredDifference": O.SquaredDifference, "L2Loss": O.L2Loss,
        "Shape": O.Shape, "Rank": O.Rank, "Size": O.SizeOp,
        "IsFinite": O.IsFinite, "IsInf": O.IsInf, "IsNan": O.IsNan,
    }
    if op in simple:
        return simple[op](**d)
    if op == "MatMul":
        return O.MatMul(
            transpose_a=bool(node.attrs.get("transpose_a", (None, False))[1]),
            transpose_b=bool(node.attrs.get("transpose_b", (None, False))[1]), **d,
        )
    if op == "Cast":
        code = node.attrs.get("DstT", (None, 1))[1]
        return O.Cast(_TF_DTYPES.get(code, np.float32), **d)
    if op == "Squeeze":
        dims = _attr(node, "squeeze_dims", []) or []
        return O.Squeeze(dims, **d)
    if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        if bool(node.attrs.get("is_training", (None, False))[1]):
            raise ValueError(
                f"{op} {node.name!r} is a TRAINING-mode node — freeze the "
                "graph for inference import, or rebuild with the native "
                "SpatialBatchNormalization and fine-tune via TFSession")
        eps = node.attrs.get("epsilon", (None, 1e-3))[1] or 1e-3
        fmt = _attr(node, "data_format", "NHWC") or "NHWC"
        return O.FusedBatchNorm(float(eps), fmt, **d)
    if op in ("ParseExample", "ParseExampleV2", "ParseSingleExample"):
        # string/Example tensors have no device representation: Example
        # parsing belongs to the host data pipeline
        raise ValueError(
            f"{op} (node {node.name!r}) parses tf.Example inside the graph — "
            "do it in the host data pipeline instead: "
            "bigdl_tpu_torch.dataset.tfrecord (TFRecordDataSet / parse_example), "
            "then feed the graph its dense input node directly"
        )
    raise ValueError(f"unsupported TF op {op!r} (node {node.name!r}) — "
                     "extend bigdl_tpu_torch.utils.tf_loader._module_for")


class TensorflowLoader:
    """Frozen-GraphDef bytes -> ``nn.Graph`` (reference: TensorflowLoader);
    the modules live on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, graph_def: bytes, device=None):
        self.nodes = parse_graph_def(graph_def)
        self.device = device

    @staticmethod
    def from_file(path: str, device=None) -> "TensorflowLoader":
        with open(path, "rb") as f:
            return TensorflowLoader(f.read(), device)

    def create_module(self, inputs: List[str], outputs: List[str],
                      trainable=None) -> Graph:
        """``trainable``: optional ``NodeDef -> bool`` predicate; a float
        Const node it accepts is wired as an ``ops.Variable`` (trainable
        parameter) instead of a frozen constant — how ``TFSession`` makes
        imported graphs fine-tunable (reference: BigDLSessionImpl)."""
        d = {"device": self.device}
        by_name = {n.name: n for n in self.nodes}
        wired: Dict[str, ModuleNode] = {}
        input_nodes: List[ModuleNode] = []

        for name in inputs:
            node = Input()
            wired[name] = node
            input_nodes.append(node)

        def data_inputs(nd: NodeDef) -> List[str]:
            # ^name inputs are control dependencies (ordering only) — the
            # graph's pure dataflow has no side effects to order: drop them
            return [i.split(":")[0] for i in nd.inputs
                    if not i.startswith("^")]

        def wire(root: str) -> ModuleNode:
            """Iterative post-order wiring (deep frozen graphs overflow
            Python recursion)."""
            root = root.split(":")[0]
            stack = [root]
            expanding = set()  # nodes awaiting their inputs: re-seen = cycle
            while stack:
                name = stack[-1]
                if name in wired:
                    stack.pop()
                    expanding.discard(name)
                    continue
                nd = by_name.get(name)
                if nd is None:
                    raise ValueError(f"graph references unknown node {name!r}")
                missing = [i for i in data_inputs(nd) if i not in wired]
                if missing:
                    if name in expanding:
                        raise ValueError(
                            f"cycle in GraphDef involving node {name!r}"
                        )
                    expanding.add(name)
                    stack.extend(missing)
                    continue
                expanding.discard(name)
                stack.pop()
                names_in = data_inputs(nd)
                if nd.op in _CONST_FOLD:
                    # shape/axis tensor inputs become static module config
                    const_vals = []
                    for i in names_in:
                        src = by_name.get(i)
                        if src is not None and src.op == "Const":
                            kind, tensor = src.attrs.get("value", (None, None))
                            const_vals.append(
                                tensor if kind == "tensor" else None
                            )
                        else:
                            const_vals.append(None)
                    module, n_data = _CONST_FOLD[nd.op](nd, const_vals, d)
                    names_in = names_in[:n_data]
                else:
                    module = _module_for(nd, d)
                    if (trainable is not None and isinstance(module, O.Const)
                            and module.value.is_floating_point()
                            and trainable(nd)):
                        module = O.Variable(module.value, **d)
                parents = [wired[i] for i in names_in]
                if module is None:  # identity-style wiring node
                    out = parents[0] if parents else Input()
                    if not parents:
                        input_nodes.append(out)
                else:
                    module.set_name(nd.name)
                    # Const nodes are parentless graph sources (the executor
                    # feeds only input_nodes; _gather hands sources an empty T)
                    out = ModuleNode(module, parents)
                wired[name] = out
            return wired[root]

        output_nodes = [wire(o) for o in outputs]
        return Graph(input_nodes, output_nodes, device=self.device)


def load_tf(path: str, inputs: List[str], outputs: List[str], device=None) -> Graph:
    """One-call import (reference: ``Module.loadTF``) onto ``device``: the
    card unless ``"cpu"``."""
    return TensorflowLoader.from_file(path, device).create_module(inputs, outputs)
