"""Caffe model import and export (counterpart of ``bigdl_tpu/utils/caffe.py``;
BigDL's ``CaffeLoader`` with its per-layer converters and
``CaffePersister``).

A from-scratch protobuf **text-format** parser reads the prototxt (no
protobuf runtime needed) and a converter table covering the classic Caffe
layer set builds a ``Graph`` wired by bottom/top names. Binary
``.caffemodel`` weights are read by ``load_caffemodel_weights``, a
schema-free protobuf wire reader that walks the LayerParameter/BlobProto
field numbers directly; ``load_weights`` also takes a plain name->arrays
dict. The weights are numpy at load and land on the modules' device: the
card unless the caller passes ``device="cpu"``.

The JAX package's semantics hold: a pool sizes with ceil unless its
``round_mode`` says ``FLOOR`` (or ``1``); ``Concat``'s axis counts the batch
(shifted by one); ``InnerProduct`` is ``Flatten`` + ``Linear``;
``BatchNorm`` is stat-only (``affine=False``) and ``Scale`` carries the
affine part; ``global_pooling`` maps to the global average or adaptive max
pool. ``save_caffe`` writes a pool's ``round_mode`` (a floor pool says
``FLOOR``), so stock Caffe and :func:`load_caffe` size it alike.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import nn
from ..nn.graph import Graph, Input, ModuleNode
from .protowire import WireReader, WireWriter

# ------------------------------------------------------ prototxt text parser

_TOKEN = re.compile(
    r"\s*(?:(#[^\n]*)|(\{)|(\})|([A-Za-z_][A-Za-z0-9_]*)\s*:?|\"((?:[^\"\\]|\\.)*)\"|([-+0-9.eE]+))"
)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise ValueError(f"prototxt parse error at {text[pos:pos+30]!r}")
            return
        pos = m.end()
        comment, lbrace, rbrace, ident, string, number = m.groups()
        if comment is not None:
            continue
        if lbrace:
            yield ("{", None)
        elif rbrace:
            yield ("}", None)
        elif ident is not None:
            if ident in ("true", "false"):  # prototxt booleans
                yield ("bool", ident == "true")
            else:
                yield ("ident", ident)
        elif string is not None:
            yield ("str", string)
        else:
            yield ("num", float(number) if "." in number or "e" in number.lower()
                   else int(number))


def parse_prototxt(text: str) -> Dict[str, Any]:
    """Protobuf text format -> nested dict; repeated keys become lists."""
    tokens = list(_tokenize(text))
    pos = 0

    def parse_block():
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(tokens) and tokens[pos][0] != "}":
            kind, key = tokens[pos]
            if kind != "ident":
                raise ValueError(f"expected field name, got {tokens[pos]}")
            pos += 1
            kind, val = tokens[pos]
            if kind == "{":
                pos += 1
                value = parse_block()
                if tokens[pos][0] != "}":
                    raise ValueError("unbalanced braces")
                pos += 1
            else:
                value = val
                pos += 1
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(value)
            else:
                out[key] = value
        return out

    return parse_block()


def _as_list(v) -> List[Any]:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _kv(param: Dict[str, Any], key: str, default=None):
    v = param.get(key, default)
    return v[0] if isinstance(v, list) else v


# ----------------------------------------------------------- layer converters


def _conv(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("convolution_param", {})
    k = int(_kv(p, "kernel_size", _kv(p, "kernel_w", 3)))
    kh = int(_kv(p, "kernel_h", k))
    stride = int(_kv(p, "stride", _kv(p, "stride_w", 1)))
    sh = int(_kv(p, "stride_h", stride))
    pad = int(_kv(p, "pad", _kv(p, "pad_w", 0)))
    ph = int(_kv(p, "pad_h", pad))
    # repeated `dilation`: one value = all spatial dims, two = (h, w)
    dils = [int(x) for x in _as_list(p.get("dilation"))] or [1]
    dh, dw = (dils[0], dils[0]) if len(dils) == 1 else (dils[0], dils[1])
    common = dict(n_group=int(_kv(p, "group", 1)),
                  with_bias=bool(_kv(p, "bias_term", True)), **d)
    if (dh, dw) != (1, 1):
        return nn.SpatialDilatedConvolution(
            None, int(_kv(p, "num_output")), k, kh, stride, sh, pad, ph,
            dilation_w=dw, dilation_h=dh, **common)
    return nn.SpatialConvolution(
        None, int(_kv(p, "num_output")), k, kh, stride, sh, pad, ph, **common)


def _pool(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("pooling_param", {})
    k = int(_kv(p, "kernel_size", _kv(p, "kernel_w", 2)))
    kh = int(_kv(p, "kernel_h", k))
    stride = int(_kv(p, "stride", _kv(p, "stride_w", k)))
    sh = int(_kv(p, "stride_h", stride))
    pad = int(_kv(p, "pad", _kv(p, "pad_w", 0)))
    ph = int(_kv(p, "pad_h", pad))
    mode = str(_kv(p, "pool", "MAX")).upper()
    # caffe's historical sizing is ceil; modern caffe records round_mode
    # (CEIL=0 / FLOOR=1) — honor both the symbolic and numeric encodings
    ceil = str(_kv(p, "round_mode", "CEIL")).upper() not in ("FLOOR", "1")
    if bool(_kv(p, "global_pooling", False)):
        return nn.SpatialAveragePooling(1, global_pooling=True, **d) if mode == "AVE" \
            else nn.SpatialAdaptiveMaxPooling(1, 1, **d)
    if mode == "AVE":
        return nn.SpatialAveragePooling(k, kh, stride, sh, pad, ph,
                                        ceil_mode=ceil, **d)
    pool = nn.SpatialMaxPooling(k, kh, stride, sh, pad, ph, **d)
    return pool.ceil() if ceil else pool


def _inner_product(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("inner_product_param", {})
    return nn.Sequential(
        nn.Flatten(**d),
        nn.Linear(None, int(_kv(p, "num_output")),
                  with_bias=bool(_kv(p, "bias_term", True)), **d),
        **d,
    )


def _lrn(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("lrn_param", {})
    return nn.SpatialCrossMapLRN(
        size=int(_kv(p, "local_size", 5)),
        alpha=float(_kv(p, "alpha", 1.0)),
        beta=float(_kv(p, "beta", 0.75)),
        k=float(_kv(p, "k", 1.0)),
        **d,
    )


def _eltwise(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    op = str(_kv(layer.get("eltwise_param", {}), "operation", "SUM")).upper()
    return {"SUM": nn.CAddTable, "PROD": nn.CMulTable, "MAX": nn.CMaxTable}[op](**d)


def _dropout(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("dropout_param", {})
    return nn.Dropout(float(_kv(p, "dropout_ratio", 0.5)), **d)


def _concat(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("concat_param", {})
    return nn.JoinTable(int(_kv(p, "axis", 1)) + 1, **d)  # caffe 0-based incl batch


def _batch_norm(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("batch_norm_param", {})
    return nn.SpatialBatchNormalization(
        None, eps=float(_kv(p, "eps", 1e-5)), affine=False, **d
    )


def _scale(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    # caffe Scale = pure per-channel affine (the piece caffe splits off its
    # stat-only BatchNorm); a BN-with-affine stand-in would re-normalize by
    # BATCH stats under training and silently change the math
    return nn.Scale(**d)


def _power(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    p = layer.get("power_param", {})
    return nn.Power(float(_kv(p, "power", 1.0)), float(_kv(p, "scale", 1.0)),
                    float(_kv(p, "shift", 0.0)), **d)


def _reshape(layer: Dict[str, Any], d: Dict[str, Any]) -> nn.AbstractModule:
    dims = layer.get("reshape_param", {}).get("shape", {}).get("dim", [])
    return nn.InferReshape([int(v) for v in _as_list(dims)], **d)


def _plain(cls):
    return lambda layer, d: cls(**d)


_CONVERTERS = {
    "Convolution": _conv,
    "Pooling": _pool,
    "InnerProduct": _inner_product,
    "ReLU": _plain(nn.ReLU),
    "Sigmoid": _plain(nn.Sigmoid),
    "TanH": _plain(nn.Tanh),
    "AbsVal": _plain(nn.Abs),
    "Power": _power,
    "ELU": _plain(nn.ELU),
    "Softmax": _plain(nn.SoftMax),
    "SoftmaxWithLoss": _plain(nn.SoftMax),
    "LRN": _lrn,
    "Dropout": _dropout,
    "Concat": _concat,
    "Eltwise": _eltwise,
    "Flatten": _plain(nn.Flatten),
    "Reshape": _reshape,
    "BatchNorm": _batch_norm,
    "Scale": _scale,
    "Input": _plain(nn.Identity),
    "Data": _plain(nn.Identity),
    "Accuracy": None,  # train-harness layers: skipped
    "Silence": None,
}


class CaffeLoader:
    """prototxt -> ``nn.Graph`` (reference: ``CaffeLoader.scala``); the
    modules live on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, prototxt_text: str, device=None):
        self.net = parse_prototxt(prototxt_text)
        self.layers = [l for l in _as_list(self.net.get("layer"))
                       + _as_list(self.net.get("layers"))]
        self.device = device

    @staticmethod
    def from_file(path: str, device=None) -> "CaffeLoader":
        with open(path) as f:
            return CaffeLoader(f.read(), device)

    def create_module(self) -> Graph:
        """Wire bottom/top names into a Graph; in-place layers chain."""
        tops: Dict[str, ModuleNode] = {}
        inputs: List[ModuleNode] = []
        made: List[ModuleNode] = []  # every layer's node, re-bound names too

        # explicit input declarations ("input: \"data\"" at net level)
        for name in _as_list(self.net.get("input")):
            node = Input()
            tops[name] = node
            inputs.append(node)

        for layer in self.layers:
            ltype = layer.get("type")
            name = layer.get("name", ltype)
            bottoms = _as_list(layer.get("bottom"))
            layer_tops = _as_list(layer.get("top"))
            if ltype in ("Input", "Data") or not bottoms:
                node = Input()
                for t in layer_tops or [name]:
                    tops[t] = node
                inputs.append(node)
                continue
            if ltype not in _CONVERTERS:
                raise ValueError(f"unsupported caffe layer type {ltype!r} "
                                 f"(layer {name!r})")
            conv = _CONVERTERS[ltype]
            if conv is None:
                continue  # harness-only layer
            module = conv(layer, {"device": self.device}).set_name(name)
            parents = []
            for b in bottoms:
                if b not in tops:
                    node = Input()
                    tops[b] = node
                    inputs.append(node)
                parents.append(tops[b])
            node = module.inputs(*parents)
            made.append(node)
            for t in layer_tops or [name]:
                tops[t] = node  # in-place (top == bottom) re-binds the name

        # outputs = nodes nobody consumes — computed at NODE level (name-level
        # "consumed" breaks on nets whose terminal layers are in-place, where
        # the output name is also a bottom), over EVERY layer's node: a node
        # whose name an in-place layer re-bound still consumes its parents
        # (the JAX loader looks only at the nodes still named, so a layer
        # feeding a conv that an in-place ReLU follows becomes an output)
        uniq = {n.id: n for n in tops.values()}
        consumed_ids = {p.id for n in made for p in n.parents}
        outputs = [n for n in uniq.values()
                   if n.id not in consumed_ids and n not in inputs]
        if not outputs:
            outputs = [list(uniq.values())[-1]]
        return Graph(inputs, outputs, device=self.device)

    def load_weights(self, module: Graph,
                     weights: Dict[str, Tuple[np.ndarray, ...]]) -> Graph:
        """Inject converted weights by layer name: {name: (weight, bias?)}.

        Caffe conv weights are already OIHW and IP weights (out, in) — the
        same conventions this framework uses, so injection is a copy. On an
        UNBUILT module (shapes unknown until the first forward) the
        injection is deferred to run right after build.
        """
        if not module.is_built():
            orig_build = module.build

            def build_then_inject(generator, sample):
                out = orig_build(generator, sample)
                del module.build  # one-shot: the class's build again
                self.load_weights(module, weights)
                return out

            module.build = build_then_inject
            return module
        for m in module._layers:
            w = weights.get(m.name())
            if w is None:
                continue
            if isinstance(m, nn.Sequential):  # InnerProduct: Flatten+Linear
                m = m[len(m) - 1]
            params = dict(m.get_parameters())
            arrays = list(w)
            for key, arr in zip(("weight", "bias"), arrays):
                if key in params:
                    params[key] = torch.from_numpy(
                        np.array(arr, np.float32).reshape(tuple(params[key].shape)))
            m.set_parameters(params)
        return module


def load_caffe(prototxt_path: str, weights=None, device=None) -> Graph:
    """One-call import (reference: ``Module.loadCaffeModel``).

    ``weights`` may be a {name: arrays} dict or a path to a binary
    ``.caffemodel`` file (parsed with the schema-free wire reader). The
    graph's modules live on ``device``: the card unless ``"cpu"``."""
    loader = CaffeLoader.from_file(prototxt_path, device)
    module = loader.create_module()
    if isinstance(weights, str):
        with open(weights, "rb") as f:
            weights = load_caffemodel_weights(f.read())
    if weights:
        loader.load_weights(module, weights)
    return module


# ------------------------------------------------- binary caffemodel weights


def _parse_blob(r) -> np.ndarray:
    """BlobProto: shape=7 (BlobShape.dim=1), data=5 (packed f32),
    double_data=8, legacy num/channels/height/width = 1..4.

    Packed repeated fields may legally arrive in MULTIPLE chunks (message
    concatenation) — chunks accumulate, never overwrite."""
    dims: List[int] = []
    legacy = [None, None, None, None]
    chunks: List[np.ndarray] = []
    while not r.done():
        f, wt = r.field()
        if f == 7 and wt == 2:  # BlobShape
            sh = r.sub()
            while not sh.done():
                sf, swt = sh.field()
                if sf == 1 and swt == 0:
                    dims.append(sh.varint())
                elif sf == 1 and swt == 2:  # packed dims
                    p = sh.sub()
                    while not p.done():
                        dims.append(p.varint())
                else:
                    sh.skip(swt)
        elif f == 5:  # data (packed or repeated float)
            if wt == 2:
                chunks.append(np.frombuffer(r.bytes_(), "<f4"))
            else:
                chunks.append(np.float32([r.f32()]))
        elif f == 8 and wt == 2:  # double_data packed
            chunks.append(np.frombuffer(r.bytes_(), "<f8"))
        elif f in (1, 2, 3, 4) and wt == 0:
            legacy[f - 1] = r.varint()
        else:
            r.skip(wt)
    data = (np.concatenate([c.astype(np.float32) for c in chunks])
            if chunks else np.zeros((0,), np.float32))
    if not dims and any(v is not None for v in legacy):
        dims = [v for v in legacy if v is not None]
    if dims and data.size == int(np.prod(dims)):
        data = data.reshape(dims)
    return data


def load_caffemodel_weights(blob: bytes) -> Dict[str, Tuple[np.ndarray, ...]]:
    """Parse a binary ``.caffemodel`` (NetParameter) into {layer: blobs}.

    Handles both the modern ``layer`` (field 100, LayerParameter: name=1,
    blobs=7) and the V1 ``layers`` (field 2, V1LayerParameter: name=4,
    blobs=6) encodings. Blob order per layer is caffe's (weight, bias, ...).
    Feed the result to ``CaffeLoader.load_weights``.
    """

    def parse_layer(lr, name_field: int, blob_field: int):
        name, blobs = "", []
        while not lr.done():
            lf, lwt = lr.field()
            if lf == name_field and lwt == 2:
                name = lr.bytes_().decode()
            elif lf == blob_field and lwt == 2:
                blobs.append(_parse_blob(lr.sub()))
            else:
                lr.skip(lwt)
        return name, blobs

    out: Dict[str, Tuple[np.ndarray, ...]] = {}
    r = WireReader(blob)
    while not r.done():
        f, wt = r.field()
        if f == 100 and wt == 2:  # LayerParameter: name=1, blobs=7
            name, blobs = parse_layer(r.sub(), 1, 7)
        elif f == 2 and wt == 2:  # V1LayerParameter: name=4, blobs=6
            name, blobs = parse_layer(r.sub(), 4, 6)
        else:
            r.skip(wt)
            continue
        if blobs:
            out[name] = tuple(blobs)
    return out


# --------------------------------------------------- export (CaffePersister)
class _Enum(str):
    """A proto enum identifier — rendered UNQUOTED in text format (protobuf
    TextFormat rejects quoted enum values; only real strings get quotes)."""


def _pt_block(name: str, fields: List[Tuple[str, Any]]) -> str:
    """Render one prototxt block; values: str -> quoted, bool -> caffe bool."""
    lines = [f"{name} {{"]
    for k, v in fields:
        if isinstance(v, _Enum):
            lines.append(f"  {k}: {v}")
        elif isinstance(v, str):
            lines.append(f'  {k}: "{v}"')
        elif isinstance(v, bool):
            lines.append(f"  {k}: {'true' if v else 'false'}")
        elif isinstance(v, tuple):  # nested block
            inner = _pt_block(k, list(v)).replace("\n", "\n  ")
            lines.append("  " + inner)
        else:
            lines.append(f"  {k}: {v}")
    lines.append("}")
    return "\n".join(lines)


def _host(t) -> np.ndarray:
    """A parameter as a float32 host array (written to the caffemodel)."""
    return t.detach().to("cpu", torch.float32).numpy()


def _export_entry(module, params) -> Optional[Tuple[str, List[Tuple[str, Any]], List[np.ndarray]]]:
    """(caffe type, param-block fields, blobs) for one module, or None to skip."""
    N = nn

    if isinstance(module, N.SpatialConvolution):
        p = params or {}
        blobs = [_host(p["weight"])]
        if module.with_bias:
            blobs.append(_host(p["bias"]))
        conv_fields = [
            ("num_output", module.n_output_plane),
            ("kernel_w", module.kernel[1]), ("kernel_h", module.kernel[0]),
            ("stride_w", module.stride[1]), ("stride_h", module.stride[0]),
            ("pad_w", module.pad[1]), ("pad_h", module.pad[0]),
            ("group", module.n_group), ("bias_term", module.with_bias),
        ]
        # dilated convs (SpatialDilatedConvolution subclasses this) must carry
        # the repeated dilation field — (h, w) order — or they silently
        # round-trip to a non-dilated conv with the same weights
        dil = getattr(module, "dilation", (1, 1))
        if tuple(dil) != (1, 1):
            conv_fields += [("dilation", dil[0]), ("dilation", dil[1])]
        fields = [("convolution_param", tuple(conv_fields))]
        return "Convolution", fields, blobs
    if isinstance(module, N.Linear):
        p = params or {}
        blobs = [_host(p["weight"])]
        if module.with_bias:
            blobs.append(_host(p["bias"]))
        fields = [("inner_product_param", (
            ("num_output", int(p["weight"].shape[0])),
            ("bias_term", module.with_bias),
        ))]
        return "InnerProduct", fields, blobs
    if isinstance(module, N.SpatialMaxPooling) or isinstance(module, N.SpatialAveragePooling):
        mode = "MAX" if isinstance(module, N.SpatialMaxPooling) else "AVE"
        if getattr(module, "global_pooling", False):
            return "Pooling", [("pooling_param", (
                ("pool", _Enum(mode)), ("global_pooling", True),
            ))], []
        fields = [("pooling_param", (
            ("pool", _Enum(mode)),
            ("kernel_w", module.kernel[1]), ("kernel_h", module.kernel[0]),
            ("stride_w", module.stride[1]), ("stride_h", module.stride[0]),
            ("pad_w", module.pad[1]), ("pad_h", module.pad[0]),
            # caffe's historical sizing is ceil; floor-mode pools (the native
            # default here) must say so or the round-trip changes shapes
            ("round_mode", _Enum("CEIL" if getattr(module, "ceil_mode", False)
                                 else "FLOOR")),
        ))]
        return "Pooling", fields, []
    if isinstance(module, N.SpatialCrossMapLRN):
        return "LRN", [("lrn_param", (
            ("local_size", module.size), ("alpha", module.alpha),
            ("beta", module.beta), ("k", module.k),
        ))], []
    if isinstance(module, N.Dropout):
        return "Dropout", [("dropout_param", (("dropout_ratio", module.p),))], []
    if isinstance(module, N.JoinTable):
        return "Concat", [("concat_param", (("axis", module.dimension - 1),))], []
    if isinstance(module, N.CAddTable):
        return "Eltwise", [("eltwise_param", (("operation", _Enum("SUM")),))], []
    if isinstance(module, (N.SoftMax, N.LogSoftMax)):
        return "Softmax", [], []
    if isinstance(module, N.ReLU):
        return "ReLU", [], []
    if isinstance(module, N.Sigmoid):
        return "Sigmoid", [], []
    if isinstance(module, N.Tanh):
        return "TanH", [], []
    if isinstance(module, N.Flatten):
        return "Flatten", [], []
    if isinstance(module, N.Identity):
        return None
    raise ValueError(
        f"CaffePersister: no caffe mapping for {type(module).__name__} "
        f"({module.name()}) — extend _export_entry"
    )


def _blob_writer(arr: np.ndarray) -> WireWriter:
    w = WireWriter()
    shape = WireWriter()
    for d in arr.shape:
        shape.varint(1, int(d))
    w.message(7, shape)
    w.bytes_(5, np.ascontiguousarray(arr, np.float32).tobytes())
    return w


def save_caffe(model, prototxt_path: str, caffemodel_path: str) -> None:
    """Export a built Graph/Sequential to prototxt + binary caffemodel
    (reference: ``CaffePersister.scala`` — SURVEY.md §2.7 export direction).

    Re-importable by :func:`load_caffe` + ``load_caffemodel_weights`` (and by
    stock caffe: the text/wire formats follow the public caffe.proto).
    """
    from ..nn.module import Sequential

    # normalize to (module, bottoms, top) triples in execution order
    entries: List[Tuple[Any, List[str], str]] = []
    if isinstance(model, Graph):
        names = {}
        for node in model.input_nodes:
            names[node.id] = "data"
        for node in model._topo:
            if node.id in names:
                continue
            top = node.module.name()
            bottoms = [names[p.id] for p in node.parents]
            names[node.id] = top
            entries.append((node.module, bottoms, top))
    elif isinstance(model, Sequential):
        prev = "data"
        for m in model._layers:
            top = m.name()
            entries.append((m, [prev], top))
            prev = top
    else:
        raise ValueError("save_caffe expects a Graph or Sequential")

    blocks = [f'name: "{getattr(model, "_name", None) or "bigdl_tpu-export"}"',
              'input: "data"']
    # stock caffe requires input dims with a net-level input declaration; the
    # build-time spec (recorded on every built model) provides them
    in_spec = getattr(model, "_top_in_spec", None)
    if in_spec is not None and hasattr(in_spec, "shape"):
        for dim in in_spec.shape:
            blocks.append(f"input_dim: {int(dim)}")
    net = WireWriter()
    net.string(1, "bigdl_tpu-export")
    skipped: Dict[str, str] = {}  # top -> replacement bottom for skipped layers
    for module, bottoms, top in entries:
        bottoms = [skipped.get(b, b) for b in bottoms]
        entry = _export_entry(module, module.get_parameters() or None)
        if entry is None:
            skipped[top] = bottoms[0]
            continue
        ltype, fields, blobs = entry
        pt_fields: List[Tuple[str, Any]] = [("name", top), ("type", ltype)]
        pt_fields += [("bottom", b) for b in bottoms]
        pt_fields.append(("top", top))
        pt_fields += fields
        blocks.append(_pt_block("layer", pt_fields))
        lw = WireWriter()
        lw.string(1, top).string(2, ltype)
        for b in bottoms:
            lw.string(3, b)
        lw.string(4, top)
        for blob in blobs:
            lw.message(7, _blob_writer(blob))
        net.message(100, lw)

    with open(prototxt_path, "w") as f:
        f.write("\n".join(blocks) + "\n")
    with open(caffemodel_path, "wb") as f:
        f.write(net.blob())
