"""Files between the packages: Caffe (prototxt + caffemodel), frozen TF
GraphDefs and Torch7 ``.t7`` files written by either package are read by
the other with equal outputs, and the golden fixtures of
``tests/fixtures/`` read the same in both.

Each export case builds one model in both packages from the JAX package's
weights (the port's copied in with ``load_jax_params``), writes it with each
package's writer and reads each file with each package's loader (four
ways); every reading's forward is held to the JAX model's own forward
within 1e-5 (1e-4 through a convolution). Each case of the JAX package's
``tests/test_torch_file.py`` runs again with the port's reader and writer,
and with one package writing and the other reading.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu.nn.graph import Graph as JGraph
from bigdl_tpu.nn.graph import Input as JInput
from bigdl_tpu.utils import caffe as jcaffe
from bigdl_tpu.utils import tf_loader as jtfl
from bigdl_tpu.utils import tf_saver as jtfs
from bigdl_tpu.utils import torch_file as jt7
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch.nn.graph import Graph as PGraph
from bigdl_tpu_torch.nn.graph import Input as PInput
from bigdl_tpu_torch.utils import caffe as pcaffe
from bigdl_tpu_torch.utils import tf_loader as ptfl
from bigdl_tpu_torch.utils import tf_saver as ptfs
from bigdl_tpu_torch.utils import torch_file as pt7
from bigdl_tpu_torch.utils.convert import load_jax_params

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
D = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fp32_policy():
    from bigdl_tpu_torch import Engine

    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _out(y):
    if isinstance(y, torch.Tensor):
        return y.detach().numpy()
    return np.asarray(y)


class Pair:
    """One model in both packages: ``build(nn, Input, Graph, d)`` makes it,
    the JAX one is initialised on ``x`` from ``seed`` and the port's takes
    its weights."""

    def __init__(self, build, x, seed):
        JRandom.set_seed(seed)
        self.x = x
        self.j = build(jnn, JInput, JGraph, {})
        self.j.init(sample_input=x)
        self.p = build(pnn, PInput, PGraph, D)
        self.p.init(sample_input=x)
        load_jax_params(self.p, jax.tree_util.tree_map(np.asarray, self.j.get_parameters()))
        self.j.evaluate()
        self.p.evaluate()
        self.ref = np.asarray(self.j.forward(x))
        with torch.no_grad():
            np.testing.assert_allclose(_out(self.p.forward(x)), self.ref, atol=1e-5, rtol=1e-5)


def _forward(model, x, port):
    if port:
        model.evaluate()
        with torch.no_grad():
            return _out(model.forward(x))
    model.evaluate()
    return np.asarray(model.forward(x))


WAYS = [("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port")]
WAY_IDS = [f"{w}-writes-{r}-reads" for w, r in WAYS]


# ------------------------------------------------------------------ Caffe
def _caffe_conv_net(nn, Input, Graph, d):
    inp = Input()
    c1 = nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **d).set_name("conv1").inputs(inp)
    r1 = nn.ReLU(**d).set_name("relu1").inputs(c1)
    p1 = nn.SpatialMaxPooling(2, 2, 2, 2, **d).set_name("pool1").inputs(r1)
    fl = nn.Flatten(**d).set_name("flat").inputs(p1)
    fc = nn.Linear(4 * 4 * 4, 5, **d).set_name("fc").inputs(fl)
    return Graph(inp, nn.SoftMax(**d).set_name("prob").inputs(fc), **d)


def _caffe_branches(nn, Input, Graph, d):
    inp = Input()
    a = nn.Linear(6, 6, **d).set_name("branch_a").inputs(inp)
    b = nn.Linear(6, 6, **d).set_name("branch_b").inputs(inp)
    add = nn.CAddTable(**d).set_name("sum").inputs(a, b)
    return Graph(inp, nn.ReLU(**d).set_name("out").inputs(add), **d)


def _caffe_pools(nn, Input, Graph, d):
    inp = Input()
    c = nn.SpatialConvolution(2, 3, 3, 3, 1, 1, 1, 1, **d).set_name("c").inputs(inp)
    pf = nn.SpatialMaxPooling(3, 3, 2, 2, **d).set_name("pf").inputs(c)
    pc = nn.SpatialMaxPooling(3, 3, 2, 2, **d).ceil().set_name("pc").inputs(c)
    pa = nn.SpatialAveragePooling(2, 3, 1, 1, **d).set_name("pa").inputs(pf)
    gap = nn.SpatialAveragePooling(1, global_pooling=True, **d).set_name("gap").inputs(pa)
    gmp = nn.SpatialAveragePooling(1, global_pooling=True, **d).set_name("gcp").inputs(pc)
    cat = nn.JoinTable(2, **d).set_name("cat").inputs(gap, gmp)
    return Graph(inp, nn.Flatten(**d).set_name("fl").inputs(cat), **d)


def _caffe_dilated(nn, Input, Graph, d):
    inp = Input()
    dc = nn.SpatialDilatedConvolution(2, 4, 3, 3, 1, 1, 2, 2, dilation_w=2, dilation_h=2,
                                      **d).set_name("dil").inputs(inp)
    lrn = nn.SpatialCrossMapLRN(3, 1e-2, 0.75, 1.0, **d).set_name("lrn").inputs(dc)
    return Graph(inp, nn.Tanh(**d).set_name("t").inputs(lrn), **d)


CAFFE_CASES = {
    "conv_net": (_caffe_conv_net, (2, 3, 8, 8)),
    "branches": (_caffe_branches, (3, 6)),
    "pools": (_caffe_pools, (2, 2, 9, 9)),
    "dilated_lrn": (_caffe_dilated, (1, 2, 9, 9)),
}


@pytest.mark.parametrize("case", sorted(CAFFE_CASES))
@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_caffe_files_cross(tmp_path, case, writer, reader):
    build, shape = CAFFE_CASES[case]
    pair = Pair(build, _x(*shape, seed=3), seed=5)
    pt, cm = str(tmp_path / "n.prototxt"), str(tmp_path / "n.caffemodel")
    if writer == "jax":
        jcaffe.save_caffe(pair.j, pt, cm)
    else:
        pcaffe.save_caffe(pair.p, pt, cm)
    if reader == "jax":
        g = jcaffe.load_caffe(pt, cm)
    else:
        g = pcaffe.load_caffe(pt, cm, device="cpu")
    y = _forward(g, pair.x, reader == "port")
    assert y.shape == pair.ref.shape
    np.testing.assert_allclose(y, pair.ref, atol=1e-5, rtol=1e-5)


def test_caffe_files_are_the_same_bytes(tmp_path):
    """The port writes the JAX package's prototxt and caffemodel byte for
    byte (the same names, fields, order and float32 blobs)."""
    pair = Pair(_caffe_pools, _x(2, 2, 9, 9, seed=1), seed=2)
    jcaffe.save_caffe(pair.j, str(tmp_path / "j.prototxt"), str(tmp_path / "j.caffemodel"))
    pcaffe.save_caffe(pair.p, str(tmp_path / "p.prototxt"), str(tmp_path / "p.caffemodel"))
    for ext in ("prototxt", "caffemodel"):
        assert (tmp_path / f"p.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_caffe_unsupported_module_raises(tmp_path):
    m = pnn.Sequential(pnn.PReLU(**D), **D)
    m.init(sample_input=np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="no caffe mapping"):
        pcaffe.save_caffe(m, str(tmp_path / "x.prototxt"), str(tmp_path / "x.caffemodel"))


# --------------------------------------------------------------------- TF
def _tf_mlp(nn, Input, Graph, d):
    return nn.Sequential(nn.Linear(6, 10, **d).set_name("fc1"), nn.ReLU(**d).set_name("relu1"),
                         nn.Linear(10, 4, **d).set_name("fc2"),
                         nn.LogSoftMax(**d).set_name("out"), **d)


def _tf_lenet(nn, Input, Graph, d):
    if d:
        from bigdl_tpu_torch.models import LeNet5
    else:
        from bigdl_tpu.models import LeNet5
    return LeNet5(10, **d)


def _tf_convs(nn, Input, Graph, d):
    return nn.Sequential(
        nn.SpatialConvolution(3, 5, 3, 3, 1, 1, 1, 1, **d).set_name("c"),
        nn.ReLU(**d).set_name("r"),
        nn.SpatialConvolution(5, 4, 3, 3, 2, 2, -1, -1, **d).set_name("sc"),
        nn.SpatialDilatedConvolution(4, 4, 3, 3, dilation_w=2, dilation_h=2,
                                     **d).set_name("dc"),
        nn.SpatialMaxPooling(2, 2, 2, 2, -1, -1, **d).set_name("mp"),
        nn.Tanh(**d).set_name("t"), **d)


def _tf_graph_add(nn, Input, Graph, d):
    inp = Input()
    a = nn.Linear(5, 7, **d).set_name("a").inputs(inp)
    b = nn.Linear(5, 7, **d).set_name("b").inputs(inp)
    s = nn.CAddTable(**d).set_name("s").inputs(a, b)
    return Graph(inp, nn.Tanh(**d).set_name("t").inputs(s), **d)


def _tf_collision(nn, Input, Graph, d):
    return nn.Sequential(nn.Linear(5, 5, **d).set_name("fc"), nn.ReLU(**d).set_name("act"),
                         nn.Linear(5, 3, **d).set_name("input"), **d)


TF_CASES = {
    "mlp": (_tf_mlp, (3, 6)),
    "lenet": (_tf_lenet, (2, 784)),
    "convs": (_tf_convs, (2, 3, 9, 9)),
    "graph_add": (_tf_graph_add, (2, 5)),
    "collision": (_tf_collision, (2, 5)),
}


@pytest.mark.parametrize("case", sorted(TF_CASES))
@pytest.mark.parametrize("writer,reader", WAYS, ids=WAY_IDS)
def test_tf_files_cross(tmp_path, case, writer, reader):
    build, shape = TF_CASES[case]
    pair = Pair(build, _x(*shape, seed=4), seed=6)
    p = str(tmp_path / "m.pb")
    final = (jtfs.save_tf(pair.j, p) if writer == "jax" else ptfs.save_tf(pair.p, p))
    assert final == (jtfs.output_node_name(pair.j) if writer == "jax"
                     else ptfs.output_node_name(pair.p))
    if case == "collision":
        assert final == "input_1"
    g = (jtfl.load_tf(p, ["input"], [final]) if reader == "jax"
         else ptfl.load_tf(p, ["input"], [final], device="cpu"))
    np.testing.assert_allclose(_forward(g, pair.x, reader == "port"), pair.ref,
                               atol=1e-4, rtol=1e-4)


def test_tf_files_are_the_same_bytes(tmp_path):
    pair = Pair(_tf_convs, _x(2, 3, 9, 9, seed=2), seed=3)
    jtfs.save_tf(pair.j, str(tmp_path / "j.pb"))
    ptfs.save_tf(pair.p, str(tmp_path / "p.pb"))
    assert (tmp_path / "p.pb").read_bytes() == (tmp_path / "j.pb").read_bytes()


@pytest.mark.parametrize("build,match", [
    (lambda d: pnn.Sequential(pnn.SpatialConvolution(3, 4, 3, 3, 2, 2, 1, 1, **d), **d),
     "SAME/VALID"),
    (lambda d: pnn.Sequential(pnn.SpatialMaxPooling(3, 3, 2, 2, **d).ceil(), **d),
     "ceil-mode"),
    (lambda d: pnn.Sequential(pnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, activation="relu",
                                                     **d), **d), "epilogue"),
], ids=["padding", "ceil", "epilogue"])
def test_tf_saver_refusals(tmp_path, build, match):
    m = build(D)
    m.init(sample_input=np.zeros((1, 3, 9, 9), np.float32))
    with pytest.raises(ValueError, match=match):
        ptfs.save_tf(m, str(tmp_path / "bad.pb"))


def test_output_node_name_cache_invalidated():
    import tempfile

    m = pnn.Sequential(pnn.Linear(4, 4, **D).set_name("dense_out"), **D)
    m.init(sample_input=np.zeros((2, 4), np.float32))
    with tempfile.TemporaryDirectory() as d:
        ptfs.save_tf(m, os.path.join(d, "m.pb"))
    assert ptfs.output_node_name(m).startswith("dense_out")
    m.add(pnn.ReLU(**D).set_name("relu_new"))
    assert ptfs.output_node_name(m) == "relu_new"


# -------------------------------------------------------------- the goldens
def _read(name):
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read()


def test_golden_graphdef_reads_the_same():
    blob = _read("golden_graphdef.pb")
    jn = {n.name: n for n in jtfl.parse_graph_def(blob)}
    pn = {n.name: n for n in ptfl.parse_graph_def(blob)}
    assert set(jn) == set(pn)
    for name in jn:
        assert (jn[name].op, jn[name].inputs) == (pn[name].op, pn[name].inputs)
        assert set(jn[name].attrs) == set(pn[name].attrs)
        for k, (kind, v) in jn[name].attrs.items():
            pk, pv = pn[name].attrs[k]
            assert kind == pk
            if isinstance(v, np.ndarray):
                assert v.dtype == pv.dtype and np.array_equal(v, pv)
            else:
                assert v == pv
    x = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    jy = np.asarray(jtfl.TensorflowLoader(blob).create_module(["input"], ["out"]).forward(x))
    g = ptfl.TensorflowLoader(blob, device="cpu").create_module(["input"], ["out"])
    py = _out(g.forward(x))
    np.testing.assert_array_equal(py, jy)
    # the x64 values narrow as the JAX package's Consts do
    for name, want in (("dbl_const", torch.float32), ("int_const", torch.int32),
                       ("int64_const", torch.int32)):
        kind, tensor = pn[name].attrs["value"]
        from bigdl_tpu_torch.nn.ops import Const

        c = Const(tensor, **D)
        assert c.value.dtype == want
        np.testing.assert_array_equal(c.value.numpy(),
                                      np.asarray(jnn.ops.Const(tensor).value))


def test_golden_caffemodel_reads_the_same():
    blob = _read("golden.caffemodel")
    jw, pw = jcaffe.load_caffemodel_weights(blob), pcaffe.load_caffemodel_weights(blob)
    assert set(jw) == set(pw) == {"conv1", "ip1"}
    for k in jw:
        assert len(jw[k]) == len(pw[k])
        for a, b in zip(jw[k], pw[k]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_golden_t7_reads_the_same():
    j, p = jt7.load_t7(os.path.join(FIX, "golden.t7")), pt7.load_t7(os.path.join(FIX, "golden.t7"))
    assert set(j) == set(p)
    for k in j:
        if isinstance(j[k], np.ndarray):
            assert j[k].dtype == p[k].dtype and np.array_equal(j[k], p[k])
        else:
            assert j[k] == p[k]


# -------------------------------------------------------------------- .t7
def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_T7_TESTS = _load_module("jax_torch_file_cases",
                         os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "test_torch_file.py"))
T7_CASES = [(cls_name, meth) for cls_name, cls in vars(_T7_TESTS).items()
            if cls_name.startswith("Test") and isinstance(cls, type)
            for meth in sorted(vars(cls)) if meth.startswith("test_")]
T7_WAYS = {"port": (pt7, pt7), "jax-writes-port-reads": (jt7, pt7),
           "port-writes-jax-reads": (pt7, jt7)}


def test_t7_cases_found():
    assert len(T7_CASES) == 12


@pytest.mark.parametrize("way", sorted(T7_WAYS))
@pytest.mark.parametrize("cls_name,meth", T7_CASES, ids=[f"{c}.{m}" for c, m in T7_CASES])
def test_t7_case(tmp_path, monkeypatch, way, cls_name, meth):
    """A case of the JAX package's ``test_torch_file.py`` with the port's
    writer and reader, or one package's writer and the other's reader."""
    writer, reader = T7_WAYS[way]
    monkeypatch.setattr(_T7_TESTS, "save_t7", writer.save_t7)
    monkeypatch.setattr(_T7_TESTS, "load_t7", reader.load_t7)
    monkeypatch.setattr(_T7_TESTS, "T7Object", reader.T7Object)
    getattr(getattr(_T7_TESTS, cls_name)(), meth)(tmp_path)


@pytest.mark.parametrize("way", ["jax-writes", "port-writes"])
def test_t7_model_weights_cross(tmp_path, way):
    """A model's parameter tree (the port's straight from its tensors, the
    bfloat16 ones as float32) written by one package, read by both."""
    pair = Pair(_tf_convs, _x(1, 3, 9, 9), seed=8)
    p = str(tmp_path / "w.t7")
    jtree = jax.tree_util.tree_map(np.asarray, pair.j.get_parameters())
    if way == "jax-writes":
        jt7.save_t7(p, jtree)
    else:
        pt7.save_t7(p, pair.p.get_parameters())
    for back in (jt7.load_t7(p), pt7.load_t7(p)):
        flat_j = jax.tree_util.tree_leaves(jtree)
        flat_b = jax.tree_util.tree_leaves(back)
        assert len(flat_j) == len(flat_b)
        for a, b in zip(flat_j, flat_b):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    pt7.save_t7(str(tmp_path / "bf.t7"), {"w": torch.arange(6, dtype=torch.bfloat16)})
    back = jt7.load_t7(str(tmp_path / "bf.t7"))
    assert back["w"].dtype == np.float32 and back["w"].tolist() == list(range(6))


def test_t7_shared_tensor_written_once(tmp_path):
    t = torch.arange(3, dtype=torch.float32)
    pt7.save_t7(str(tmp_path / "s.t7"), {"a": t, "b": t})
    back = jt7.load_t7(str(tmp_path / "s.t7"))
    assert back["a"] is back["b"] and back["a"].tolist() == [0.0, 1.0, 2.0]
