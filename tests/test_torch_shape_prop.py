"""The port's ``ShapeProp`` against the JAX package's.

* every row of the JAX serializer sweep whose classes the port has (the
  port module read from the JAX module's topology record, as in
  ``test_torch_module_serializer.py``) and the ported zoo (LeNet-5, a CIFAR
  ResNet, Inception-v1, the BiLSTM classifier, the Siamese graph): the
  output specs' shapes and dtypes equal JAX's ShapeProp's and the port's
  own forward's, with the model left unbuilt and no parameter allocated;
* ``tests/test_analysis.py::TestContractChecks``' faults raise
  ``ShapeInferenceError`` with the same module path in both packages;
* a built model resolves through its meta forward, and a module without a
  contract through a meta build that leaves it exactly as it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.models as jmodels
import bigdl_tpu.nn as jnn
from bigdl_tpu.analysis import ShapeInferenceError as JShapeInferenceError
from bigdl_tpu.analysis import ShapeProp as JShapeProp
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.models as pmodels
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.analysis import ShapeInferenceError, ShapeProp, infer_shapes
from bigdl_tpu_torch.nn.module import infer_module_shape, to_spec
from bigdl_tpu_torch.utils.module_serializer import spec_to_module
from bigdl_tpu_torch.utils.table import T, Table

from test_module_serializer import SWEEP
from test_torch_lenet import _fp32_policy  # noqa: F401 (fixture)
from test_torch_module_serializer import PORTED, _ported, _torch


def _jspec(x):
    if isinstance(x, list):
        return [_jspec(v) for v in x]
    return jax.ShapeDtypeStruct(x.shape, jnp.asarray(x).dtype)


def _sig(spec):
    """[(shape, dtype name)] over the leaves of either package's spec."""
    if isinstance(spec, (Table, JTable, list, tuple)):
        return [s for v in spec for s in _sig(v)]
    return [(tuple(spec.shape), str(spec.dtype).replace("torch.", ""))]


def _agree(pm, jm, x):
    jout = JShapeProp(jm).infer(_jspec(x))
    out = ShapeProp(pm).infer(_torch(x))
    assert not pm.is_built() and not list(pm.parameters())
    assert _sig(out) == _sig(jout)
    pm.evaluate()
    with torch.no_grad():
        pm.init(sample_input=_torch(x) if isinstance(x, np.ndarray) else T(*_torch(x)))
        y = pm.apply(pm.get_parameters(), pm.get_state(), _torch(x))[0]
    assert _sig(to_spec(y)) == _sig(out)


@pytest.mark.parametrize("i", PORTED)
def test_sweep_row_matches_jax(i):
    _agree(spec_to_module(_ported(i), "cpu"), SWEEP[i][0](), SWEEP[i][1])


def _siamese(nn, trunk, **d):
    a, b = nn.Input(), nn.Input()
    return nn.Graph([a, b], [trunk.inputs(a), trunk.inputs(b)], **d)


ZOO = {
    "lenet": (lambda m, **d: m.LeNet5(10, **d), np.zeros((2, 784), np.float32)),
    "resnet20": (lambda m, **d: m.ResNet(20, class_num=10, dataset="cifar10", **d),
                 np.zeros((2, 3, 32, 32), np.float32)),
    "inception": (lambda m, **d: m.Inception_v1(100, **d), np.zeros((1, 3, 224, 224), np.float32)),
    "bilstm": (lambda m, **d: m.BiLSTMClassifier(50, 8, 6, class_num=3, **d),
               np.ones((2, 9), np.int32)),
    "siamese": (lambda m, **d: _siamese(pnn if d else jnn,
                                        m.ResNet(8, class_num=16, dataset="cifar10", **d), **d),
                [np.zeros((2, 3, 16, 16), np.float32)] * 2),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_matches_jax(name):
    make, x = ZOO[name]
    _agree(make(pmodels, device="cpu"), make(jmodels), x)


def _concat(nn, **d):
    c = nn.Concat(2, **d).set_name("tower")
    c.add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **d).set_name("b1"))
    c.add(nn.SpatialConvolution(3, 8, 3, 3, **d).set_name("b2"))  # no pad: H/W shrink
    return c


CONTRACTS = {
    "join": (lambda nn, **d: nn.JoinTable(2, **d).set_name("join"),
             [np.zeros((4, 3), np.float32), np.zeros((5, 7), np.float32)], r"\(4, 3\).*\(5, 7\)"),
    "cadd": (lambda nn, **d: nn.CAddTable(**d).set_name("shortcut"),
             [np.zeros((2, 8), np.float32), np.zeros((2, 9), np.float32)], "broadcast"),
    "reshape": (lambda nn, **d: nn.Reshape([12 * 4 * 4], **d).set_name("flatten"),
                np.zeros((2, 12, 5, 5), np.float32), "cannot reshape"),
    "conv": (lambda nn, **d: nn.SpatialConvolution(3, 8, 3, 3, **d).set_name("stem"),
             np.zeros((1, 4, 8, 8), np.float32), "expected 3 input channels, got 4"),
    "concat": (_concat, np.zeros((1, 3, 8, 8), np.float32), "concatenate"),
    "linear": (lambda nn, **d: nn.Linear(7, 3, **d).set_name("fc_bad"),
               np.zeros((8, 5), np.float32), "expected last dim 7, got 5"),
}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_contract_faults_name_the_same_path(name):
    make, x, words = CONTRACTS[name]
    jm = jnn.Sequential(jnn.Identity().set_name("head"), make(jnn)).set_name("model")
    pm = pnn.Sequential(pnn.Identity(device="cpu").set_name("head"), make(pnn, device="cpu"),
                        device="cpu").set_name("model")
    with pytest.raises(JShapeInferenceError) as je:
        JShapeProp(jm).infer(_jspec(x))
    with pytest.raises(ShapeInferenceError, match=words) as pe:
        ShapeProp(pm).infer(_torch(x))
    assert pe.value.module_path == je.value.module_path
    assert not pm.is_built()


def test_a_built_model_resolves_through_its_meta_forward():
    m = pnn.Sequential(pnn.Recurrent(pnn.LSTM(4, 3, device="cpu"), device="cpu"),
                       pnn.Select(2, -1, device="cpu"), device="cpu")
    x = torch.zeros(2, 5, 4)
    m.init(sample_input=x)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    out, report = infer_shapes(m, x)
    assert tuple(out.shape) == (2, 3) and out.device.type == "meta"
    assert all(torch.equal(v, m.state_dict()[k]) for k, v in before.items())
    assert [p for p, _, _ in report][-1].startswith("Sequential(")


def test_a_meta_build_leaves_the_module_as_it_was():
    rec = pnn.Recurrent(pnn.GRU(None, 3, device="cpu"), device="cpu")
    before = dict(rec.__dict__)
    out = infer_module_shape(rec, to_spec(torch.zeros(2, 5, 4)))
    assert tuple(out.shape) == (2, 5, 3)
    assert not rec.is_built() and rec[0].input_size is None and not list(rec.parameters())
    assert rec.__dict__.keys() == before.keys()
    rec.init(sample_input=torch.zeros(2, 5, 6))  # a later real build with another width
    assert rec[0].input_size == 6


def test_the_port_spec_of_a_table_is_a_table():
    out = ShapeProp(pnn.ConcatTable(pnn.Identity(device="cpu"), pnn.Identity(device="cpu"),
                                    device="cpu")).infer(torch.zeros(2, 3))
    jout = JShapeProp(jnn.ConcatTable(jnn.Identity(), jnn.Identity())).infer(
        jax.ShapeDtypeStruct((2, 3), jnp.float32))
    assert isinstance(out, Table) and isinstance(jout, JTable) and _sig(out) == _sig(jout)
