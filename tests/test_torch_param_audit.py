"""The port's ``ParamAudit`` and ``validate_model`` against the JAX
package's: each case of ``tests/test_analysis.py::TestParamAudit`` (a clean
model, one weight handed to two layers with and without ``allow_shared``,
bf16 masters, a NaN at initialisation, the composed passes) built in both
packages; the finding codes must be equal, and a fatal one must raise the
port's ``ParamAuditError`` naming the module.

The port keys aliasing on storage, not on the tensor object (an in-place
update through one leaf writes every leaf over the same memory): a weight
that is a view of another layer's is caught too, and intentional sharing —
one module at two graph nodes — is not aliasing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.analysis import ParamAudit as JParamAudit
from bigdl_tpu.analysis import validate_model as jvalidate_model
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.analysis import (ParamAudit, ParamAuditError, ShapeInferenceError,
                                      validate_model)


def _pair(make):
    jm, pm = make(jnn, {}), make(pnn, {"device": "cpu"})
    jm.build(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((2, 4), jnp.float32))
    pm.init(sample_input=torch.zeros(2, 4))
    return jm, pm


def _two(nn, d):
    return nn.Sequential(nn.Linear(4, 4, **d).set_name("a"), nn.Linear(4, 4, **d).set_name("b"),
                         **d)


def _codes(found):
    return [f.code for f in found]


def _alias(jm, pm):
    jm[1]._params = dict(jm[1]._params, weight=jm[0]._params["weight"])
    pm[1]._param_tree = dict(pm[1]._param_tree, weight=pm[0]._param_tree["weight"])


def _bf16(jm, pm):
    jm._params = {k: v.astype(jnp.bfloat16) for k, v in jm._params.items()}
    pm._param_tree = {k: v.to(torch.bfloat16) for k, v in pm._param_tree.items()}


def _nan(jm, pm):
    w = np.asarray(jm._params["weight"]).copy()
    w[0, 0] = np.nan
    jm._params = dict(jm._params, weight=jnp.asarray(w))
    with torch.no_grad():
        pm._param_tree["weight"][0, 0] = float("nan")


CASES = {"clean": (_two, None, None), "aliased": (_two, _alias, "aliased"),
         "bf16": (lambda nn, d: nn.Linear(4, 2, **d).set_name("fc"), _bf16, "fc.*bfloat16.*float32"),
         "nonfinite": (lambda nn, d: nn.Linear(4, 2, **d).set_name("fc"), _nan, "fc.*NaN/Inf")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_match_jax(case):
    make, spoil, match = CASES[case]
    jm, pm = _pair(make)
    if spoil is not None:
        spoil(jm, pm)
    jf, pf = JParamAudit(jm).findings(), ParamAudit(pm).findings()
    assert _codes(pf) == _codes(jf)
    if match is None:
        assert ParamAudit(pm).check() == []
    else:
        with pytest.raises(ParamAuditError, match=match):
            ParamAudit(pm).check()


def test_allow_shared_suppresses_the_alias():
    jm, pm = _pair(_two)
    _alias(jm, pm)
    assert _codes(ParamAudit(pm, allow_shared=["b"]).findings()) == \
        _codes(JParamAudit(jm, allow_shared=["b"]).findings()) == []


def test_a_view_of_another_layers_weight_is_aliasing():
    _, pm = _pair(_two)
    w = pm[0]._param_tree["weight"]
    pm[1]._param_tree = dict(pm[1]._param_tree, weight=w.detach()[1:])  # rows 1..3 of a's
    with pytest.raises(ParamAuditError, match=r"aliased at 2 sites: a\['weight'\], b\['weight'\]"):
        ParamAudit(pm).check()
    pm[1]._param_tree = dict(pm[1]._param_tree, weight=w.detach().clone())
    assert ParamAudit(pm).check() == []


def test_a_module_at_two_graph_nodes_is_not_aliasing():
    a, b = pnn.Input(), pnn.Input()
    enc = pnn.Linear(4, 3, device="cpu").set_name("enc")
    g = pnn.Graph([a, b], pnn.CAddTable(device="cpu").inputs(enc.inputs(a), enc.inputs(b)),
                  device="cpu")
    g.init(sample_input=[torch.zeros(2, 4), torch.zeros(2, 4)])
    assert ParamAudit(g).check() == []


def test_validate_model_composes():
    def make(nn, d):
        return nn.Sequential(nn.Linear(8, 4, **d), nn.ReLU(**d), nn.Linear(4, 2, **d), **d)

    assert validate_model(make(pnn, {"device": "cpu"}), torch.zeros(2, 8)) == \
        jvalidate_model(make(jnn, {}), jax.ShapeDtypeStruct((2, 8), jnp.float32)) == []
    with pytest.raises(ShapeInferenceError):
        validate_model(make(pnn, {"device": "cpu"}), torch.zeros(2, 9))
    built = make(pnn, {"device": "cpu"})
    built.init(sample_input=torch.zeros(2, 8))
    assert validate_model(built, torch.zeros(2, 8)) == []
