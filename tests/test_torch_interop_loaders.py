"""The port's interop loaders against the JAX package's, case by case:
each case of ``test_ops_caffe.py`` (the prototxt parser, ``CaffeLoader``,
binary caffemodels), ``test_tf_loader.py`` (the wire parser, imports of
MLPs, convnets and the long-tail ops), ``test_tf_session.py``
(Variable/Assign graphs, feeds and fetches, fine-tuning a ``save_tf`` export)
and the keras converter's cases of ``test_interop_export.py`` (JSON +
HDF5, functional models, shared layers, nested models) runs through both
packages, and the port's result is held to the JAX package's: the same
values within 1e-5 (1e-4 through a convolution), the same errors. The
GraphDefs are written with the JAX tests' own wire helpers. Also
``nn.load_caffe``/``nn.load_tf`` and the import example's ``main`` at
``--platform cpu`` against the numpy oracle of its weights.
"""

import json

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu.utils import caffe as jcaffe
from bigdl_tpu.utils import tf_loader as jtfl
from bigdl_tpu.utils import tf_session as jsess
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch.utils import caffe as pcaffe
from bigdl_tpu_torch.utils import tf_loader as ptfl
from bigdl_tpu_torch.utils import tf_session as psess
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_ops_caffe import BRANCHY_PROTOTXT, LENET_PROTOTXT
from test_ops_caffe import TestCaffemodelBinary as _CaffeWire
from test_tf_loader import (_attr_bool, _attr_int_list, _attr_str, _attr_tensor, _field,
                            _mlp_graph_def, _node, _varint)

D = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fp32_policy():
    from bigdl_tpu_torch import Engine

    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(y):
    return y.detach().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _pfwd(m, x):
    with torch.no_grad():
        return _np(m.forward(x))


def _weights_of(jgraph):
    """A JAX Caffe graph's weights as the {layer: (weight, bias)} dict that
    ``CaffeLoader.load_weights`` takes (an InnerProduct's from its Linear)."""
    out = {}
    for name, tree in jgraph.get_parameters().items():
        if "weight" not in tree:  # a Sequential(Flatten, Linear): the Linear's
            tree = next((t for t in tree.values() if "weight" in t), {})
        if "weight" in tree:
            out[name] = tuple(np.asarray(tree[k]) for k in ("weight", "bias") if k in tree)
    return out


# ------------------------------------------------------------------ Caffe
@pytest.mark.parametrize("text", [LENET_PROTOTXT, BRANCHY_PROTOTXT,
                                  "# a comment\npool: MAX\nratio: 0.5\nflag: false\n"],
                         ids=["lenet", "branchy", "scalars"])
def test_prototxt_parser(text):
    assert pcaffe.parse_prototxt(text) == jcaffe.parse_prototxt(text)


@pytest.mark.parametrize("proto,shape", [(LENET_PROTOTXT, (2, 1, 12, 12)),
                                         (BRANCHY_PROTOTXT, (1, 2, 4, 4))],
                         ids=["lenet", "branchy"])
def test_caffe_topology_and_injected_weights(proto, shape):
    JRandom.set_seed(4)
    jg = jcaffe.CaffeLoader(proto).create_module()
    x = _x(*shape, seed=5)
    jy = np.asarray(jg.forward(x))
    pg = pcaffe.CaffeLoader(proto, device="cpu").create_module()
    pcaffe.CaffeLoader(proto, device="cpu").load_weights(pg, _weights_of(jg))
    py = _pfwd(pg, x)
    assert py.shape == jy.shape
    np.testing.assert_allclose(py, jy, atol=1e-5, rtol=1e-5)
    if proto is LENET_PROTOTXT:
        np.testing.assert_allclose(py.sum(1), 1.0, rtol=1e-5)
        names = [m.name() for m in pg]
        assert names == [m.name() for m in jg.modules]
        assert names.index("relu1") < names.index("pool1")


def test_caffe_weight_injection_after_build():
    pg = pcaffe.CaffeLoader(LENET_PROTOTXT, device="cpu").create_module()
    pg.forward(_x(1, 1, 12, 12, seed=9))
    pcaffe.CaffeLoader(LENET_PROTOTXT, device="cpu").load_weights(
        pg, {"conv1": (np.zeros((4, 1, 5, 5), np.float32), np.full((4,), 3.0, np.float32))})
    np.testing.assert_array_equal(pg.get_parameters()["conv1"]["bias"].detach().numpy(), 3.0)


def test_caffe_unknown_layer_raises():
    bad = LENET_PROTOTXT.replace('type: "Softmax"', 'type: "MVN"')
    for mod, kw in ((jcaffe, {}), (pcaffe, D)):
        with pytest.raises(ValueError, match="MVN"):
            mod.CaffeLoader(bad, **kw).create_module()


def test_caffe_bias_term_false_and_inplace_terminals():
    txt = LENET_PROTOTXT.replace(
        "convolution_param { num_output: 4 kernel_size: 5 stride: 1 }",
        "convolution_param { num_output: 4 kernel_size: 5 stride: 1 bias_term: false }")
    g = pcaffe.CaffeLoader(txt, device="cpu").create_module()
    g.forward(np.zeros((1, 1, 12, 12), np.float32))
    assert "bias" not in g.get_parameters()["conv1"]
    two = BRANCHY_PROTOTXT.replace(
        'layer {\n  name: "sum" type: "Eltwise" bottom: "a" bottom: "b" top: "sum"\n'
        '  eltwise_param { operation: SUM }\n}',
        'layer { name: "relu_a" type: "ReLU" bottom: "a" top: "a" }\n'
        'layer { name: "relu_b" type: "ReLU" bottom: "b" top: "b" }')
    assert len(pcaffe.CaffeLoader(two, device="cpu").create_module().output_nodes) == \
        len(jcaffe.CaffeLoader(two).create_module().output_nodes) == 2


CHAIN_PROTOTXT = """
name: "Chain"
input: "data"
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 3 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "conv2" type: "Convolution" bottom: "conv1" top: "conv2"
        convolution_param { num_output: 2 kernel_size: 3 pad: 1 } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "ip" type: "InnerProduct" bottom: "conv2" top: "ip"
        inner_product_param { num_output: 4 } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }
"""


def test_caffe_outputs_over_in_place_layers():
    """A layer feeding a conv that an in-place ReLU follows is consumed:
    the port's graph has the one output ``prob``. The JAX loader keeps
    ``relu1`` as a second output (it looks only at the nodes still named;
    ROADMAP, reference-side fault); its ``prob`` equals the port's."""
    JRandom.set_seed(31)
    jg = jcaffe.CaffeLoader(CHAIN_PROTOTXT).create_module()
    assert [n.module.name() for n in jg.output_nodes] == ["relu1", "prob"]
    x = _x(2, 1, 5, 5, seed=31)
    jy = jg.forward(x)
    pg = pcaffe.CaffeLoader(CHAIN_PROTOTXT, device="cpu").create_module()
    assert [n.module.name() for n in pg.output_nodes] == ["prob"]
    pcaffe.CaffeLoader(CHAIN_PROTOTXT, device="cpu").load_weights(pg, _weights_of(jg))
    np.testing.assert_allclose(_pfwd(pg, x), np.asarray(jy.to_list()[-1]), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("layer,check", [
    ({"type": "BatchNorm", "batch_norm_param": {"eps": 1e-3}},
     lambda m: isinstance(m, pnn.SpatialBatchNormalization) and m.affine is False
     and m.eps == 1e-3),
    ({"type": "Scale"}, lambda m: isinstance(m, pnn.Scale)),
    ({"type": "Concat", "concat_param": {"axis": 1}},
     lambda m: isinstance(m, pnn.JoinTable) and m.dimension == 2),
    ({"type": "InnerProduct", "inner_product_param": {"num_output": 7}},
     lambda m: isinstance(m, pnn.Sequential) and isinstance(m[0], pnn.Flatten)
     and isinstance(m[1], pnn.Linear)),
    ({"type": "Pooling", "pooling_param": {"pool": "AVE", "global_pooling": True}},
     lambda m: isinstance(m, pnn.SpatialAveragePooling) and m.global_pooling),
    ({"type": "Pooling", "pooling_param": {"pool": "MAX", "global_pooling": True}},
     lambda m: isinstance(m, pnn.SpatialAdaptiveMaxPooling)),
], ids=["batchnorm", "scale", "concat", "inner_product", "global_ave", "global_max"])
def test_caffe_layer_semantics(layer, check):
    m = pcaffe._CONVERTERS[layer["type"]](layer, D)
    assert check(m)


@pytest.mark.parametrize("encoded,ceil", [("1", False), (1, False), ("FLOOR", False),
                                          ("0", True), (0, True), ("CEIL", True),
                                          (None, True)])
def test_caffe_pool_round_mode(encoded, ceil):
    p = {"kernel_size": 3, "stride": 2}
    if encoded is not None:
        p["round_mode"] = encoded
    jp = jcaffe._pool({"pooling_param": p})
    pp = pcaffe._pool({"pooling_param": p}, D)
    assert bool(getattr(pp, "ceil_mode", False)) == bool(getattr(jp, "ceil_mode", False)) == ceil


def test_caffe_scale_is_pure_affine_in_training():
    s = pnn.Scale(**D)
    x = _x(4, 3, 2, 2, seed=11)
    s.init(sample_input=x)
    s.set_parameters({"weight": np.float32([2.0, 3.0, 4.0]), "bias": np.float32([1.0, 0, -1])})
    s.train()
    want = x * np.float32([2, 3, 4]).reshape(1, 3, 1, 1) + np.float32([1, 0, -1]).reshape(
        1, 3, 1, 1)
    np.testing.assert_allclose(_pfwd(s, x), want, rtol=1e-6)


def test_caffemodel_modern_and_v1():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = np.float32([1, 2, 3, 4])
    blob = _CaffeWire._layer("ip1", w, b) + _CaffeWire._layer("old", np.float32([[9.0]]), v1=True)
    jw, pw = jcaffe.load_caffemodel_weights(blob), pcaffe.load_caffemodel_weights(blob)
    assert set(pw) == set(jw) == {"ip1", "old"}
    for k in jw:
        for a, c in zip(jw[k], pw[k]):
            np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("via", ["utils", "nn"])
def test_load_caffe_end_to_end(tmp_path, via):
    """``load_caffe(prototxt, caffemodel)``: the weights land at build, and
    the graph lives on the asked device."""
    w = np.zeros((4, 1, 5, 5), np.float32)
    w[:, :, 2, 2] = 2.0
    proto_p, model_p = tmp_path / "net.prototxt", tmp_path / "net.caffemodel"
    proto_p.write_text(LENET_PROTOTXT)
    model_p.write_bytes(_CaffeWire._layer("conv1", w, np.zeros(4, np.float32)))
    load = pnn.load_caffe if via == "nn" else pcaffe.load_caffe
    g = load(str(proto_p), str(model_p), device="cpu")
    x = _x(1, 1, 12, 12, seed=10)
    JRandom.set_seed(9)
    jg = jnn.load_caffe(str(proto_p), str(model_p))
    jy = np.asarray(jg.forward(x))
    py = _pfwd(g, x)
    np.testing.assert_array_equal(g.get_parameters()["conv1"]["weight"].detach().numpy(), w)
    assert py.shape == jy.shape == (1, 10)
    assert next(g.parameters()).device.type == "cpu"


# --------------------------------------------------------------------- TF
def _both_tf(blob, inputs, outputs, x):
    jy = jtfl.TensorflowLoader(blob).create_module(inputs, outputs).forward(x)
    pg = ptfl.TensorflowLoader(blob, device="cpu").create_module(inputs, outputs)
    return np.asarray(jy), _pfwd(pg, x)


def test_tf_wire_parser_nodes_and_splat():
    w = np.ones((2, 3), np.float32)
    blob = _mlp_graph_def(w, np.zeros(3, np.float32), np.ones((3, 2), np.float32))
    import struct

    body = (_field(1, 0, _varint(1)) + _field(2, 2, _field(2, 2, _field(1, 0, _varint(4))))
            + _field(5, 5, struct.pack("<f", 2.5)))
    splat = _field(1, 2, _field(1, 2, b"c") + _field(2, 2, b"Const")
                   + _field(5, 2, _field(1, 2, b"value") + _field(2, 2, _field(8, 2, body))))
    neg = (_field(1, 0, _varint(3)) + _field(2, 2, _field(2, 2, _field(1, 0, _varint(1))))
           + _field(7, 0, _varint((1 << 64) - 1)))
    negn = _field(1, 2, _field(1, 2, b"n") + _field(2, 2, b"Const")
                  + _field(5, 2, _field(1, 2, b"value") + _field(2, 2, _field(8, 2, neg))))
    for b in (blob, splat, negn):
        jn, pn = jtfl.parse_graph_def(b), ptfl.parse_graph_def(b)
        assert [(n.name, n.op, n.inputs) for n in pn] == [(n.name, n.op, n.inputs) for n in jn]
        for a, c in zip(jn, pn):
            for k in a.attrs:
                np.testing.assert_array_equal(np.asarray(c.attrs[k][1]), np.asarray(a.attrs[k][1]))
    assert ptfl.parse_graph_def(negn)[0].attrs["value"][1].tolist() == [-1]


def test_tf_mlp_and_transpose_b():
    rng = np.random.default_rng(0)
    w1, b1, w2 = (rng.standard_normal(s).astype(np.float32) for s in ((4, 8), 8, (8, 3)))
    x = rng.standard_normal((5, 4)).astype(np.float32)
    jy, py = _both_tf(_mlp_graph_def(w1, b1, w2), ["x"], ["prob"], x)
    np.testing.assert_allclose(py, jy, atol=1e-6, rtol=1e-5)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    blob = (_node("x", "Placeholder") + _node("w", "Const", attrs=_attr_tensor("value", w))
            + _node("y", "MatMul", ["x", "w"], _attr_bool("transpose_b", True)))
    jy, py = _both_tf(blob, ["x"], ["y"], rng.standard_normal((2, 4)).astype(np.float32))
    np.testing.assert_allclose(py, jy, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("blob,match", [
    (_node("x", "Placeholder") + _node("z", "FancyOp", ["x"]), "FancyOp"),
    (_node("x", "Placeholder") + _node("y", "ArgMax", ["x", "x"]), "not a Const"),
    (_node("a", "Relu", ["b"]) + _node("b", "Relu", ["a"]), "cycle"),
    (_node("x", "Placeholder") + _node("p", "ParseExample", ["x"]), "host data pipeline"),
], ids=["unknown_op", "nonconst_dim", "cycle", "parse_example"])
def test_tf_import_errors(blob, match):
    outputs = ["a"] if match == "cycle" else [{"FancyOp": "z", "not a Const": "y",
                                               "host data pipeline": "p"}[match]]
    inputs = [] if match == "cycle" else ["x"]
    for loader in (lambda: jtfl.TensorflowLoader(blob),
                   lambda: ptfl.TensorflowLoader(blob, device="cpu")):
        with pytest.raises(ValueError, match=match):
            loader().create_module(inputs, outputs)


def test_tf_control_dependency_and_argmax_fold():
    blob = _node("x", "Placeholder") + _node("noop", "NoOp") + _node("y", "Relu", ["x", "^noop"])
    jy, py = _both_tf(blob, ["x"], ["y"], _x(2, 3, seed=2))
    np.testing.assert_array_equal(py, jy)
    blob = (_node("x", "Placeholder")
            + _node("dim", "Const", attrs=_attr_tensor("value", np.int32([1])))
            + _node("y", "ArgMax", ["x", "dim"]))
    jy, py = _both_tf(blob, ["x"], ["y"], np.float32([[1, 9, 2], [7, 0, 3]]))
    assert py.tolist() == jy.tolist() == [1, 0] and py.dtype == jy.dtype


def test_tf_small_cnn():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    fc = rng.standard_normal((4 * 3 * 3, 5)).astype(np.float32)
    blob = (_node("x", "Placeholder")
            + _node("w", "Const", attrs=_attr_tensor("value", w))
            + _node("b", "Const", attrs=_attr_tensor("value", b))
            + _node("fc", "Const", attrs=_attr_tensor("value", fc))
            + _node("shape", "Const", attrs=_attr_tensor("value", np.int32([-1, 36])))
            + _node("conv", "Conv2D", ["x", "w"], _attr_int_list("strides", [1, 1, 1, 1])
                    + _attr_str("padding", "SAME"))
            + _node("badd", "BiasAdd", ["conv", "b"]) + _node("relu", "Relu", ["badd"])
            + _node("pool", "MaxPool", ["relu"], _attr_int_list("ksize", [1, 2, 2, 1])
                    + _attr_int_list("strides", [1, 2, 2, 1]) + _attr_str("padding", "VALID"))
            + _node("flat", "Reshape", ["pool", "shape"])
            + _node("logits", "MatMul", ["flat", "fc"]))
    jy, py = _both_tf(blob, ["x"], ["logits"], rng.standard_normal((2, 6, 6, 2)).astype(
        np.float32))
    np.testing.assert_allclose(py, jy, atol=1e-4, rtol=1e-4)
    blob = (_node("x", "Placeholder")
            + _node("y", "AvgPool", ["x"], _attr_int_list("ksize", [1, 2, 2, 1])
                    + _attr_int_list("strides", [1, 2, 2, 1]) + _attr_str("padding", "SAME")))
    jy, py = _both_tf(blob, ["x"], ["y"], np.ones((1, 3, 3, 1), np.float32))
    np.testing.assert_allclose(py, jy, atol=1e-6)
    np.testing.assert_allclose(py, 1.0, atol=1e-6)


def _graph(build, writer):
    """A GraphDef through a package's own ``tf_saver._node``/``_const``."""
    S = writer
    g = S.WireWriter()
    dt = S.WireWriter()
    dt.varint(6, S._DT_FLOAT)
    S._node(g, "x", "Placeholder", attrs={"dtype": dt})
    build(g, S._node, S._const)
    return g.blob()


@pytest.fixture(params=["jax_writer", "port_writer"])
def saver(request):
    if request.param == "jax_writer":
        from bigdl_tpu.utils import tf_saver as S
    else:
        from bigdl_tpu_torch.utils import tf_saver as S
    return S


def test_tf_op_tail(saver):
    rng = np.random.default_rng(61)
    gamma, beta, mean = (rng.standard_normal(3).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 3).astype(np.float32)

    def bn(g, _node, _const):
        for nm, arr in (("g", gamma), ("b", beta), ("m", mean), ("v", var)):
            _const(g, nm, arr)
        _node(g, "bn", "FusedBatchNormV3", ("x", "g", "b", "m", "v"))

    jy, py = _both_tf(_graph(bn, saver), ["x"], ["bn"], _x(2, 4, 4, 3, seed=1))
    np.testing.assert_allclose(py, jy, atol=1e-5, rtol=1e-5)

    def cat(g, _node, _const):
        _const(g, "axis", np.asarray(1, np.int32))
        _node(g, "cat", "ConcatV2", ("x", "x", "axis"))
        _const(g, "rdim", np.asarray([2], np.int32))
        _node(g, "mean", "Mean", ("cat", "rdim"))
        _node(g, "neg", "Neg", ("mean",))

    jy, py = _both_tf(_graph(cat, saver), ["x"], ["neg"], _x(2, 3, 5, seed=62))
    np.testing.assert_allclose(py, jy, atol=1e-6, rtol=1e-5)


def test_tf_training_mode_bn_rejected(saver):
    g = saver.WireWriter()
    dt = saver.WireWriter()
    dt.varint(6, saver._DT_FLOAT)
    saver._node(g, "x", "Placeholder", attrs={"dtype": dt})
    tr = saver.WireWriter()
    tr.varint(5, 1)
    saver._node(g, "bn", "FusedBatchNorm", ("x", "x", "x", "x", "x"), attrs={"is_training": tr})
    with pytest.raises(ValueError, match="TRAINING-mode"):
        ptfl.TensorflowLoader(g.blob(), device="cpu").create_module(["x"], ["bn"])


def test_nn_load_tf(tmp_path):
    rng = np.random.default_rng(0)
    w1, b1, w2 = (rng.standard_normal(s).astype(np.float32) for s in ((4, 8), 8, (8, 3)))
    p = tmp_path / "mlp.pb"
    p.write_bytes(_mlp_graph_def(w1, b1, w2))
    x = rng.standard_normal((5, 4)).astype(np.float32)
    g = pnn.load_tf(str(p), ["x"], ["prob"], device="cpu")
    np.testing.assert_allclose(_pfwd(g, x), np.asarray(jnn.load_tf(str(p), ["x"], ["prob"])
                                                       .forward(x)), atol=1e-6, rtol=1e-5)
    assert all(b.device.type == "cpu" for b in g.buffers())


# ------------------------------------------------------------- TF session
def _variable_graph(tmp_path, S):
    g = S.WireWriter()
    dt = S.WireWriter()
    dt.varint(6, S._DT_FLOAT)
    S._node(g, "x", "Placeholder", attrs={"dtype": dt})
    rng = np.random.default_rng(0)
    W0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    S._const(g, "W/init", W0)
    S._const(g, "b/init", b0)
    S._node(g, "W", "VariableV2")
    S._node(g, "b", "VariableV2")
    S._node(g, "W/read", "Identity", ("W/init",))
    S._node(g, "W/assign", "Assign", ("W", "W/read"))
    S._node(g, "b/assign", "Assign", ("b", "b/init"))
    S._node(g, "mm", "MatMul", ("x", "W"))
    S._node(g, "y", "BiasAdd", ("mm", "b"))
    p = str(tmp_path / "vars.pb")
    with open(p, "wb") as f:
        f.write(g.blob())
    return p, W0, b0


def test_session_variables_run_and_train(tmp_path, saver):
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Trigger

    p, W0, b0 = _variable_graph(tmp_path, saver)
    sess = psess.TFSession(p, inputs=["x"], outputs=["y"], device="cpu")
    jsession = jsess.TFSession(p, inputs=["x"], outputs=["y"])
    x = _x(5, 4, seed=1)
    np.testing.assert_allclose(_np(sess.run({"x": x})), np.asarray(jsession.run({"x": x})),
                               atol=1e-6)
    np.testing.assert_allclose(_np(sess.run({"x": x})), x @ W0 + b0, atol=1e-5)
    got = sess.variables()
    assert set(got) == set(jsession.variables()) == {"W", "b"}
    np.testing.assert_array_equal(got["W"], W0)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((128, 4)).astype(np.float32)
    t = xs @ rng.standard_normal((4, 3)).astype(np.float32)
    crit = pnn.MSECriterion()
    before = float(crit.forward(sess.run({"x": xs}), torch.from_numpy(t)))
    sess.train(DataSet.array(xs, t, batch_size=32), crit,
               optim_method=SGD(learningrate=0.05), end_when=Trigger.max_epoch(30))
    after = float(crit.forward(sess.run({"x": xs}), torch.from_numpy(t)))
    assert after < before * 0.1, (before, after)
    assert np.abs(sess.variables()["W"] - W0).max() > 0.01


def test_session_uninitialized_variable_rejected(tmp_path, saver):
    g = saver.WireWriter()
    dt = saver.WireWriter()
    dt.varint(6, saver._DT_FLOAT)
    saver._node(g, "x", "Placeholder", attrs={"dtype": dt})
    saver._node(g, "W", "VariableV2")
    saver._node(g, "y", "MatMul", ("x", "W"))
    p = str(tmp_path / "bad.pb")
    with open(p, "wb") as f:
        f.write(g.blob())
    with pytest.raises(ValueError, match="no initializing Assign"):
        psess.TFSession(p, inputs=["x"], outputs=["y"], device="cpu")


def test_session_feeds_and_fetches(tmp_path):
    from bigdl_tpu_torch.utils import tf_saver as S

    g = S.WireWriter()
    dt = S.WireWriter()
    dt.varint(6, S._DT_FLOAT)
    S._node(g, "x", "Placeholder", attrs={"dtype": dt})
    S._node(g, "relu", "Relu", ("x",))
    S._node(g, "neg", "Neg", ("x",))
    p = str(tmp_path / "two.pb")
    with open(p, "wb") as f:
        f.write(g.blob())
    sess = psess.TFSession(p, inputs=["x"], outputs=["relu", "neg"], device="cpu")
    x = np.asarray([[-1.0, 2.0]], np.float32)
    r, n = sess.run({"x": x})
    np.testing.assert_allclose(_np(r), [[0.0, 2.0]])
    np.testing.assert_allclose(_np(n), [[1.0, -2.0]])
    np.testing.assert_allclose(_np(sess.run({"x": x}, fetches=["neg"])), [[1.0, -2.0]])
    with pytest.raises(ValueError, match="not among the session outputs"):
        sess.run({"x": x}, fetches=["mystery"])
    with pytest.raises(ValueError, match="missing inputs"):
        sess.run({})


def test_session_finetunes_a_save_tf_export(tmp_path):
    """A convnet exported by the JAX package's ``save_tf``, re-imported
    trainable by the port's ``TFSession`` and fine-tuned to a loss drop;
    its first forward equals the JAX model's."""
    from bigdl_tpu.utils.tf_saver import save_tf
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Trigger

    JRandom.set_seed(23)
    m = jnn.Sequential(jnn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1).set_name("c1"),
                       jnn.ReLU().set_name("r1"), jnn.SpatialMaxPooling(2, 2, 2, 2).set_name("p1"),
                       jnn.Flatten().set_name("fl"), jnn.Linear(4 * 4 * 4, 5).set_name("fc"),
                       jnn.LogSoftMax().set_name("out"))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 1, 8, 8)).astype(np.float32)
    m.forward(x[:2])
    p = str(tmp_path / "net.pb")
    final = save_tf(m, p)
    sess = psess.TFSession(p, inputs=["input"], outputs=[final], trainable=True, device="cpu")
    m.evaluate()
    np.testing.assert_allclose(_np(sess.run({"input": x})), np.asarray(m.forward(x)),
                               atol=1e-5, rtol=1e-5)
    assert set(sess.variables()) == {"c1/w", "c1/b", "fc/w", "fc/b"}
    y = rng.integers(0, 5, 64)
    crit = pnn.ClassNLLCriterion()
    before = float(crit.forward(sess.run({"input": x}), torch.from_numpy(y)))
    sess.train(DataSet.array(x, y, batch_size=32), crit, optim_method=SGD(learningrate=0.1),
               end_when=Trigger.max_epoch(40))
    after = float(crit.forward(sess.run({"input": x}), torch.from_numpy(y)))
    assert after < before * 0.5, (before, after)
    frozen = psess.TFSession(p, inputs=["input"], outputs=[final], device="cpu")
    assert frozen.variables() == {}


# ------------------------------------------------------------------ keras
def _keras_files(tmp_path):
    h5py = pytest.importorskip("h5py")
    spec = {"class_name": "Sequential", "config": [
        {"class_name": "Dense", "config": {"name": "d1", "output_dim": 8,
                                           "batch_input_shape": [None, 6],
                                           "activation": "relu"}},
        {"class_name": "Dropout", "config": {"name": "do", "p": 0.5}},
        {"class_name": "Dense", "config": {"name": "d2", "output_dim": 3,
                                           "activation": "softmax"}}]}
    jp, wp = str(tmp_path / "model.json"), str(tmp_path / "weights.h5")
    with open(jp, "w") as f:
        json.dump(spec, f)
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((6, 8), 8, (8, 3), 3)]
    with h5py.File(wp, "w") as f:
        f.attrs["layer_names"] = [b"d1", b"do", b"d2"]
        for name, W, b in (("d1", *arrs[:2]), ("d2", *arrs[2:])):
            g = f.create_group(name)
            g.attrs["weight_names"] = [f"{name}_W".encode(), f"{name}_b".encode()]
            g.create_dataset(f"{name}_W", data=W)
            g.create_dataset(f"{name}_b", data=b)
        f.create_group("do").attrs["weight_names"] = []
    return jp, wp, arrs


@pytest.mark.parametrize("by_name", [False, True])
def test_keras_json_plus_hdf5(tmp_path, by_name):
    from bigdl_tpu.nn.keras.converter import load_keras as jload
    from bigdl_tpu_torch.nn.keras.converter import load_keras

    jp, wp, (W1, b1, W2, b2) = _keras_files(tmp_path)
    x = _x(4, 6, seed=4)
    m = load_keras(jp, wp, sample_input=x, by_name=by_name, device="cpu")
    m.evaluate()
    jm = jload(jp, wp, sample_input=x, by_name=by_name)
    jm.evaluate()
    np.testing.assert_allclose(_pfwd(m, x), np.asarray(jm.forward(x)), atol=1e-6, rtol=1e-5)
    d1 = next(layer for layer in m if layer.name() == "d1")
    np.testing.assert_array_equal(d1[0].get_parameters()["weight"].detach().numpy(), W1.T)


def test_keras_bn_running_var_passthrough(tmp_path):
    h5py = pytest.importorskip("h5py")
    from bigdl_tpu.nn.keras.converter import load_keras as jload
    from bigdl_tpu_torch.nn.keras.converter import load_keras

    spec = {"class_name": "Sequential", "config": [
        {"class_name": "BatchNormalization", "config": {
            "name": "bn", "epsilon": 1e-3, "momentum": 0.99, "batch_input_shape": [None, 4]}}]}
    jp = str(tmp_path / "bn.json")
    with open(jp, "w") as f:
        json.dump(spec, f)
    rng = np.random.default_rng(13)
    gamma, beta, mean = (rng.standard_normal(4).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    wp = str(tmp_path / "bn.h5")
    with h5py.File(wp, "w") as f:
        f.attrs["layer_names"] = [b"bn"]
        g = f.create_group("bn")
        g.attrs["weight_names"] = [b"bn_gamma", b"bn_beta", b"bn_running_mean",
                                   b"bn_running_std"]
        for nm, arr in (("bn_gamma", gamma), ("bn_beta", beta), ("bn_running_mean", mean),
                        ("bn_running_std", var)):
            g.create_dataset(nm, data=arr)
    x = _x(3, 4, seed=14)
    m = load_keras(jp, wp, sample_input=x, device="cpu")
    m.evaluate()
    jm = jload(jp, wp, sample_input=x)
    jm.evaluate()
    y = _pfwd(m, x)
    np.testing.assert_allclose(y, np.asarray(jm.forward(x)), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(y, gamma * (x - mean) / np.sqrt(var + 1e-3) + beta, atol=1e-4)


def _functional(layers, outputs):
    return json.dumps({"class_name": "Model",
                       "config": {"layers": layers, "output_layers": outputs}})


def _inp(name, n):
    return {"class_name": "InputLayer", "name": name, "config": {"batch_input_shape": [None, n]}}


def _both_keras(text, x):
    """The JSON in both packages, the port's weights from the JAX model's."""
    from bigdl_tpu.nn.keras.converter import model_from_json as jm
    from bigdl_tpu_torch.nn.keras.converter import model_from_json as pm

    JRandom.set_seed(41)
    j = jm(text)
    jy = np.asarray(j.forward(x))
    p = pm(text, device="cpu")
    p.init(sample_input=x)
    load_jax_params(p, jax.tree_util.tree_map(np.asarray, j.get_parameters()))
    return j, p, jy, _pfwd(p, x)


def test_keras_functional_cases():
    merge = _functional([
        _inp("inp", 6),
        {"class_name": "Dense", "name": "d1", "config": {"name": "d1", "output_dim": 4},
         "inbound_nodes": [[["inp", 0, 0]]]},
        {"class_name": "Dense", "name": "d2", "config": {"name": "d2", "output_dim": 4},
         "inbound_nodes": [[["inp", 0, 0]]]},
        {"class_name": "Merge", "name": "m", "config": {"name": "m", "mode": "sum"},
         "inbound_nodes": [[["d1", 0, 0], ["d2", 0, 0]]]}], [["m", 0, 0]])
    _, _, jy, py = _both_keras(merge, _x(3, 6))
    np.testing.assert_allclose(py, jy, atol=1e-6, rtol=1e-5)
    shared = _functional([
        _inp("a", 6), _inp("b", 6),
        {"class_name": "Dense", "name": "enc", "config": {"name": "enc", "output_dim": 4},
         "inbound_nodes": [[["a", 0, 0]], [["b", 0, 0]]]},
        {"class_name": "Merge", "name": "m", "config": {"name": "m", "mode": "sum"},
         "inbound_nodes": [[["enc", 0, 0], ["enc", 1, 0]]]}], [["m", 0, 0]])
    xs = [_x(3, 6, seed=1), _x(3, 6, seed=2)]
    _, p, jy, py = _both_keras(shared, xs)
    np.testing.assert_allclose(py, jy, atol=1e-6, rtol=1e-5)
    assert sum(1 for layer in p if layer.name() == "enc") == 1
    calls = _functional([
        _inp("x", 5),
        {"class_name": "Activation", "name": "f", "config": {"name": "f", "activation": "relu"},
         "inbound_nodes": [[["x", 0, 0]], [["g", 0, 0]]]},
        {"class_name": "Activation", "name": "g", "config": {"name": "g", "activation": "tanh"},
         "inbound_nodes": [[["f", 0, 0]]]}], [["f", 1, 0]])
    x = _x(2, 5, seed=43)
    _, _, jy, py = _both_keras(calls, x)
    np.testing.assert_allclose(py, np.maximum(np.tanh(np.maximum(x, 0)), 0), atol=1e-6)
    np.testing.assert_allclose(py, jy, atol=1e-6)


def test_keras_shared_layer_gradients_sum():
    text = _functional([
        _inp("a", 4),
        {"class_name": "Dense", "name": "enc",
         "config": {"name": "enc", "output_dim": 4, "bias": False},
         "inbound_nodes": [[["a", 0, 0]]]},
        {"class_name": "Dense", "name": "enc2",
         "config": {"name": "enc2", "output_dim": 4, "bias": False},
         "inbound_nodes": [[["enc", 0, 0]]]}], [["enc2", 0, 0]])
    x = _x(2, 4, seed=42)
    j, p, _, _ = _both_keras(text, x)
    dy = np.ones((2, 4), np.float32)
    j.forward(x)
    jg = j.backward(x, dy)
    p.forward(x)
    pg = p.backward(x, torch.from_numpy(dy))
    np.testing.assert_allclose(_np(pg), np.asarray(jg), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("text,match", [
    (json.dumps({"class_name": "Sequential", "config": [{"class_name": "FancyLayer",
                                                         "config": {}}]}), "FancyLayer"),
    (_functional([_inp("x", 5), {"class_name": "Dense", "name": "d",
                                 "config": {"name": "d", "output_dim": 3},
                                 "inbound_nodes": [[["x", 0, 1]]]}], [["d", 0, 0]]),
     "tensor_index"),
    (_functional([_inp("x", 5), {"class_name": "Dense", "name": "d",
                                 "config": {"name": "d", "output_dim": 3},
                                 "inbound_nodes": [[["ghost", 0, 0]]]}], [["d", 0, 0]]),
     "unresolvable inbound refs"),
], ids=["unsupported", "tensor_index", "missing_ref"])
def test_keras_errors(text, match):
    from bigdl_tpu.nn.keras.converter import model_from_json as jm
    from bigdl_tpu_torch.nn.keras.converter import model_from_json as pm

    for load in (jm, lambda t: pm(t, device="cpu")):
        with pytest.raises(ValueError, match=match):
            load(text)


def test_keras_nested_sequential_in_model(tmp_path):
    h5py = pytest.importorskip("h5py")
    from bigdl_tpu.nn.keras.converter import load_keras as jload
    from bigdl_tpu_torch.nn.keras.converter import load_keras

    text = _functional([
        _inp("inp", 6),
        {"class_name": "Sequential", "name": "tower", "config": [
            {"class_name": "Dense", "config": {"name": "t_d1", "output_dim": 8,
                                               "batch_input_shape": [None, 6],
                                               "activation": "relu"}},
            {"class_name": "Dense", "config": {"name": "t_d2", "output_dim": 4}}],
         "inbound_nodes": [[["inp", 0, 0]]]},
        {"class_name": "Dense", "name": "head", "config": {"name": "head", "output_dim": 2},
         "inbound_nodes": [[["tower", 0, 0]]]}], [["head", 0, 0]])
    jp = str(tmp_path / "nested.json")
    with open(jp, "w") as f:
        f.write(text)
    rng = np.random.default_rng(44)
    W1, b1, W2, b2, W3, b3 = (rng.standard_normal(s).astype(np.float32)
                              for s in ((6, 8), 8, (8, 4), 4, (4, 2), 2))
    wp = str(tmp_path / "nested.h5")
    with h5py.File(wp, "w") as f:
        f.attrs["layer_names"] = [b"tower", b"head"]
        g = f.create_group("tower")
        g.attrs["weight_names"] = [b"t_d1_W", b"t_d1_b", b"t_d2_W", b"t_d2_b"]
        for nm, arr in (("t_d1_W", W1), ("t_d1_b", b1), ("t_d2_W", W2), ("t_d2_b", b2)):
            g.create_dataset(nm, data=arr)
        g = f.create_group("head")
        g.attrs["weight_names"] = [b"head_W", b"head_b"]
        g.create_dataset("head_W", data=W3)
        g.create_dataset("head_b", data=b3)
    x = _x(3, 6, seed=45)
    y = _pfwd(load_keras(jp, wp, sample_input=x, device="cpu"), x)
    np.testing.assert_allclose(y, np.asarray(jload(jp, wp, sample_input=x).forward(x)),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(y, (np.maximum(x @ W1 + b1, 0) @ W2 + b2) @ W3 + b3, atol=1e-5)


# ---------------------------------------------------------------- example
def test_import_example_main_on_the_cpu():
    """The example's three paths at ``--platform cpu``: the Caffe graph's
    rows are probabilities, the .t7 round trip gives the conv weight back
    and the TF graph's output is the numpy oracle of the weights the JAX
    example draws from the same seed."""
    from bigdl_tpu_torch.examples import import_models

    out = import_models.main(["--platform", "cpu"])
    assert out["caffe"].shape == (2, 4) and np.allclose(out["caffe"].sum(1), 1.0, atol=1e-5)
    assert out["t7"].shape == (6, 3, 3, 3) and out["t7"].dtype == np.float32
    rng = np.random.default_rng(1)
    w1, b1, w2 = (rng.standard_normal(s).astype(np.float32) for s in ((4, 8), 8, (8, 3)))
    x = rng.standard_normal((5, 4)).astype(np.float32)
    logits = np.maximum(x @ w1 + b1, 0) @ w2
    e = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_allclose(out["tf"], e / e.sum(1, keepdims=True), atol=1e-5, rtol=1e-4)
