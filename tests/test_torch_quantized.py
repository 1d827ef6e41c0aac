"""The port's quantized tensors and layers against the JAX package's, on the
CPU: ``tensor/quantized.py`` (``quantize_symmetric``, ``quantize_fp8``),
``nn/quantized.py`` (the int8 and fp8 twins of ``Linear``,
``SpatialConvolution`` and ``SpatialDilatedConvolution``, ``quantize``,
``quantized_mode``) and ``AbstractModule.quantize``.

Inputs and weights come from numpy with a seed; the JAX layers' weights are
carried into the port (``load_jax_params``). Tolerances, fixed before the
first run:

* int8: the weight and input codes, the scales and the int32 accumulators
  equal the JAX package's bit for bit, and so do the outputs (the same f32
  multiply and add on equal operands);
* fp8: the codes and scales bit for bit; the accumulators and outputs within
  1e-6 of the largest |value| (e4m3 products are exact in f32, only the
  order of the f32 sums differs);
* a whole quantized model whose float layers (tanh, pooling) sit between
  quantized ones: 1e-4 of the largest output, since ulp-level differences
  of XLA's and torch's tanh may move an input code by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bigdl_tpu.nn as jnn
import bigdl_tpu.nn.quantized as jq
import bigdl_tpu.tensor.quantized as jqt
from bigdl_tpu.nn.graph import Input as JInput
from bigdl_tpu.nn.conv import resolve_padding as jresolve_padding
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.analysis import ShapeProp
from bigdl_tpu_torch.nn import quantized as pq
from bigdl_tpu_torch.tensor import quantized as pqt
from bigdl_tpu_torch.utils import compat
from bigdl_tpu_torch.utils.convert import load_jax_params

FP8_REL = 1e-6
MODEL_REL = 1e-4


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return t.view(torch.uint8).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _pair(jax_factory, port_factory, x):
    """A built JAX module and its port twin holding the JAX weights."""
    JRandom.set_seed(5)
    jm = jax_factory()
    jm.forward(jnp.asarray(x))
    pm = port_factory()
    pm.init(sample_input=x)
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.get_parameters()))
    return jm, pm


# ---------------------------------------------------------------------------
# tensor/quantized.py
# ---------------------------------------------------------------------------

WEIGHTS = [((8, 32), 0), ((6, 3, 3, 3), 0), ((5, 7), 1), ((4, 9, 2), 2)]


@pytest.mark.parametrize("shape,axis", WEIGHTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_symmetric_codes_and_scales_equal_jax(shape, axis, dtype):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 3
    w[(slice(None),) * axis + (0,)] = 0.0  # an all-zero channel: scale 1
    jw = jnp.asarray(w, dtype)
    pw = torch.from_numpy(w).to(getattr(torch, dtype))
    a, b = jqt.quantize_symmetric(jw, axis), pqt.quantize_symmetric(pw, axis)
    assert b.values.dtype == torch.int8 and b.scales.dtype == torch.float32
    np.testing.assert_array_equal(_np(b.values), _np(a.values))
    np.testing.assert_array_equal(_np(b.scales), _np(a.scales))
    np.testing.assert_array_equal(_np(b.to_dense()), _np(a.to_dense()))
    assert b.shape == tuple(shape)


def test_quantize_symmetric_rounds_half_to_even_as_jax():
    # amax 127 gives scale 1: 2.5 and -0.5 sit exactly half way
    w = np.array([[127.0, 2.5, 3.5, -0.5, -1.5]], np.float32)
    a, b = jqt.quantize_symmetric(jnp.asarray(w)), pqt.quantize_symmetric(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(b.values), _np(a.values))
    assert _np(b.values).tolist() == [[127, 2, 4, 0, -2]]


@pytest.mark.parametrize("shape,axis", WEIGHTS)
def test_quantize_fp8_codes_and_scales_equal_jax(shape, axis):
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 3
    a, b = jqt.quantize_fp8(jnp.asarray(w), axis), pqt.quantize_fp8(torch.from_numpy(w), axis)
    assert b.values.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_np(b.values), _np(a.values))
    np.testing.assert_array_equal(_np(b.scales), _np(a.scales))
    np.testing.assert_allclose(_np(b.to_dense()), w, rtol=0.07, atol=1e-6)


def test_quantize_fp8_refuses_int8_and_an_unsupported_build(monkeypatch):
    w = torch.ones(2, 3)
    with pytest.raises(ValueError, match="not a float8"):
        pqt.quantize_fp8(w, dtype="int8")
    assert pqt.quantize_fp8(w, dtype="float8_e5m2").values.dtype == torch.float8_e5m2
    monkeypatch.setattr(compat, "_float8_probe_cache",
                        compat.Float8Support(False, reason="simulated"))
    with pytest.raises(ValueError, match="simulated"):
        pqt.quantize_fp8(w)


def test_probe_float8_answers_from_torch():
    support = compat.probe_float8(refresh=True)
    assert support.available and support.reason is None
    assert support.dtypes == {"float8_e4m3fn": torch.float8_e4m3fn,
                              "float8_e5m2": torch.float8_e5m2}
    assert compat.float8_matmul_reason(torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the layers: codes, scales and accumulators against the JAX computation
# ---------------------------------------------------------------------------

def _jax_products(jlayer, x, fp8: bool):
    """The JAX layer's (input codes, input scale, accumulator), from its own
    quantizer and its own lax call."""
    p = jlayer.get_parameters()
    wq = p["weight_q"]
    if fp8:
        xq, sx = jq._quantize_activation_fp8(jnp.asarray(x), wq.dtype)
        pet = jnp.float32
    else:
        xq, sx = jq._quantize_activation(jnp.asarray(x))
        pet = jnp.int32
    if isinstance(jlayer, jq.QuantizedLinear):
        acc = lax.dot_general(xq, wq, (((xq.ndim - 1,), (1,)), ((), ())),
                              preferred_element_type=pet)
    else:
        acc = lax.conv_general_dilated(
            xq, wq, window_strides=jlayer.stride, padding=jresolve_padding(jlayer.pad),
            rhs_dilation=getattr(jlayer, "dilation", (1, 1)), feature_group_count=jlayer.n_group,
            dimension_numbers=("NCHW", "OIHW", "NCHW"), preferred_element_type=pet)
    return xq, sx, acc


LAYERS = {
    "linear": (lambda: jnn.Linear(40, 24), lambda: pnn.Linear(40, 24, device="cpu"), (6, 40)),
    "linear_3d_odd": (lambda: jnn.Linear(13, 7), lambda: pnn.Linear(13, 7, device="cpu"),
                      (2, 5, 13)),
    "linear_nobias": (lambda: jnn.Linear(16, 8, with_bias=False),
                      lambda: pnn.Linear(16, 8, with_bias=False, device="cpu"), (20, 16)),
    "conv_pad_stride": (lambda: jnn.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1),
                        lambda: pnn.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1, device="cpu"),
                        (2, 3, 11, 11)),
    "conv_same": (lambda: jnn.SpatialConvolution(5, 6, 4, 3, 2, 1, -1, -1),
                  lambda: pnn.SpatialConvolution(5, 6, 4, 3, 2, 1, -1, -1, device="cpu"),
                  (2, 5, 9, 10)),
    "conv_grouped": (lambda: jnn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, n_group=2),
                     lambda: pnn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, n_group=2,
                                                    device="cpu"), (2, 4, 7, 7)),
    "conv_1x1": (lambda: jnn.SpatialConvolution(16, 24, 1, 1, with_bias=False),
                 lambda: pnn.SpatialConvolution(16, 24, 1, 1, with_bias=False, device="cpu"),
                 (2, 16, 5, 5)),
    "dilated": (lambda: jnn.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, dilation_w=2,
                                                      dilation_h=2),
                lambda: pnn.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, dilation_w=2,
                                                      dilation_h=2, device="cpu"),
                (2, 3, 10, 10)),
    "dilated_same": (lambda: jnn.SpatialDilatedConvolution(3, 4, 3, 3, 1, 1, -1, -1,
                                                           dilation_w=3, dilation_h=2),
                     lambda: pnn.SpatialDilatedConvolution(3, 4, 3, 3, 1, 1, -1, -1,
                                                           dilation_w=3, dilation_h=2,
                                                           device="cpu"),
                     (1, 3, 9, 8)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_int8_codes_and_int32_accumulators_equal_jax(name):
    jf, pf, shape = LAYERS[name]
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jm, pm = _pair(jf, pf, x)
    jt = jq._QUANTIZABLE["int8"][type(jm)](jm)
    pt = pq._QUANTIZABLE["int8"][type(pm)](pm)
    assert type(pt).__name__ == type(jt).__name__
    jp, pp = jt.get_parameters(), pt.get_parameters()
    assert sorted(pp) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(_np(pp[k]), _np(jp[k]), err_msg=k)
    jxq, jsx, jacc = _jax_products(jt, x, fp8=False)
    pxq, psx, pacc = pt.products(pp, torch.from_numpy(x))
    assert pxq.dtype == torch.int8 and pacc.dtype == torch.int32
    np.testing.assert_array_equal(_np(pxq), _np(jxq))
    np.testing.assert_array_equal(_np(psx), _np(jsx))
    np.testing.assert_array_equal(_np(pacc), _np(jacc))
    np.testing.assert_array_equal(_np(pt.forward(x)), _np(jt.forward(jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fp8_codes_and_outputs_match_jax(name):
    jf, pf, shape = LAYERS[name]
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jm, pm = _pair(jf, pf, x)
    jt = jq._QUANTIZABLE["fp8"][type(jm)](jm)
    pt = pq._QUANTIZABLE["fp8"][type(pm)](pm)
    assert type(pt).__name__ == type(jt).__name__
    jp, pp = jt.get_parameters(), pt.get_parameters()
    for k in jp:
        np.testing.assert_array_equal(_np(pp[k]), _np(jp[k]), err_msg=k)
    jxq, jsx, jacc = _jax_products(jt, x, fp8=True)
    pxq, psx, pacc = pt.products(pp, torch.from_numpy(x))
    assert pxq.dtype == torch.float8_e4m3fn and pacc.dtype == torch.float32
    np.testing.assert_array_equal(_np(pxq), _np(jxq))
    np.testing.assert_array_equal(_np(psx), _np(jsx))
    jacc = _np(jacc)
    np.testing.assert_allclose(_np(pacc), jacc, rtol=0, atol=FP8_REL * np.abs(jacc).max())
    jy = _np(jt.forward(jnp.asarray(x)))
    np.testing.assert_allclose(_np(pt.forward(x)), jy, rtol=0, atol=FP8_REL * np.abs(jy).max())


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 13, 7), (16, 8, 8), (17, 9, 15), (40, 64, 24)])
def test_int8_matmul_pads_to_the_int_mm_shape_rules_and_crops_back(m, k, n):
    g = torch.Generator().manual_seed(m * 100 + k)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    acc = pq._int8_matmul(a, w)
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc, (a.long() @ w.long().t()).int())


def test_int8_accumulator_is_exact_past_float32_integers():
    """K = 4608 (ResNet-50's 512 x 3 x 3) at the extreme codes: every sum is
    127^2 * 4608 = 74,322,432, past 2^24, which f32 sums could not hold."""
    a = torch.full((20, 4608), 127, dtype=torch.int8)
    w = torch.full((8, 4608), -127, dtype=torch.int8)
    w[1, :3] = 126
    acc = pq._int8_matmul(a, w)
    assert int(acc[0, 0]) == -127 * 127 * 4608
    assert int(acc[0, 1]) == -127 * 127 * 4605 + 3 * 127 * 126


def test_from_float_needs_a_built_layer():
    with pytest.raises(ValueError, match="built"):
        pq.QuantizedLinear.from_float(pnn.Linear(4, 4, device="cpu"))
    with pytest.raises(ValueError, match="built"):
        pnn.Sequential(pnn.Linear(4, 4, device="cpu"), device="cpu").quantize()


# ---------------------------------------------------------------------------
# quantize(): Sequential, Graph, a Graph with a shared module
# ---------------------------------------------------------------------------

def _seq(nn, dev):
    return (nn.Sequential(**dev)
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **dev))
            .add(nn.ReLU(**dev))
            .add(nn.Reshape((4 * 8 * 8,), **dev))
            .add(nn.Linear(4 * 8 * 8, 10, **dev)))


@pytest.mark.parametrize("family", ["int8", "fp8"])
def test_sequential_rewrite_matches_jax(family):
    x = np.random.default_rng(5).standard_normal((4, 3, 8, 8)).astype(np.float32)
    jm, pm = _pair(lambda: _seq(jnn, {}), lambda: _seq(pnn, {"device": "cpu"}), x)
    jq_, pq_ = jm.quantize(family), pm.quantize(family)
    assert pq_ is pm and not pq_.training
    assert [type(m).__name__ for m in pq_._layers] == [type(m).__name__ for m in jq_.modules]
    assert [n for n, _ in pq_.named_children()] == [m.name() for m in pq_._layers]
    assert pnn.quantized_mode(pq_) == jq.quantized_mode(jq_) == family
    jy, py = _np(jq_.forward(jnp.asarray(x))), _np(pq_.forward(x))
    if family == "int8":
        np.testing.assert_array_equal(py, jy)
    else:
        np.testing.assert_allclose(py, jy, rtol=0, atol=FP8_REL * np.abs(jy).max())


def _graph(nn, dev, shared: bool):
    inp = nn.Input()
    first = nn.Linear(6, 6, **dev).set_name("tied")
    a = first.inputs(inp)
    r = nn.ReLU(**dev).set_name("act").inputs(a)
    second = first if shared else nn.Linear(6, 6, **dev).set_name("other")
    b = second.inputs(r)
    out = nn.Linear(6, 3, **dev).set_name("head").inputs(b)
    return nn.Graph(inp, out, **dev)


@pytest.mark.parametrize("shared", [False, True], ids=["plain", "shared_module"])
def test_graph_rewrite_matches_jax_convert(shared):
    """A Graph's nodes are rewritten one by one, as the JAX ``_convert``
    does: a module shared by two nodes becomes two quantized twins with one
    name, the children list names it once per node, the parameter tree once
    (the last twin's), and the forward equals JAX's."""
    x = np.random.default_rng(6).standard_normal((5, 6)).astype(np.float32)
    jg, pg = _pair(lambda: _graph(jnn, {}, shared), lambda: _graph(pnn, {"device": "cpu"}, shared),
                   x)
    jy0, py0 = _np(jg.forward(jnp.asarray(x))), _np(pg.forward(x))
    np.testing.assert_allclose(py0, jy0, rtol=1e-6, atol=1e-6)
    jq_, pq_ = jg.quantize(), pg.quantize()

    def outline(layers, topo, inputs, params):
        mods = [n.module for n in topo if n not in inputs]
        return ([(type(m).__name__, m.name()) for m in layers],
                [sum(m is o for o in mods) for m in mods], sorted(params))

    assert (outline(pq_._layers, pq_._topo, pq_.input_nodes, pq_.get_parameters())
            == outline(jq_.modules, jq_._topo, jq_.input_nodes, jq_.get_parameters()))
    np.testing.assert_array_equal(_np(pq_.forward(x)), _np(jq_.forward(jnp.asarray(x))))
    assert sorted(n for n, _ in pq_.named_children()) == sorted(pq_.get_parameters())


def test_only_the_exact_classes_are_rewritten():
    """Subclasses keep their float path in both packages (a type lookup, not
    isinstance): ``SparseLinear`` here."""
    x = np.random.default_rng(7).standard_normal((3, 6)).astype(np.float32)
    jm, pm = _pair(lambda: jnn.Sequential(jnn.SparseLinear(6, 4), jnn.Linear(4, 2)),
                   lambda: pnn.Sequential(pnn.SparseLinear(6, 4, device="cpu"),
                                          pnn.Linear(4, 2, device="cpu"), device="cpu"), x)
    kinds = [type(m).__name__ for m in pm.quantize()._layers]
    assert kinds == [type(m).__name__ for m in jm.quantize().modules] == [
        "SparseLinear", "QuantizedLinear"]


def test_mode_detection_unknown_family_and_fp8_refusal(monkeypatch):
    x = np.zeros((2, 8), np.float32)
    RandomGenerator.set_seed(5)
    m = pnn.Sequential(pnn.Linear(8, 4, device="cpu"), device="cpu")
    m.init(sample_input=x)
    assert pnn.quantized_mode(m) is None
    with pytest.raises(ValueError, match="unknown quantization family"):
        m.quantize(dtype="int4")
    monkeypatch.setattr(compat, "_float8_probe_cache",
                        compat.Float8Support(False, reason="simulated"))
    with pytest.raises(ValueError, match="simulated"):
        m.quantize(dtype="fp8")
    assert pnn.quantized_mode(m) is None  # nothing was rewritten
    assert pnn.quantized_mode(m.quantize()) == "int8"


def test_quantized_lenet_close_to_jax():
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu_torch.models import LeNet5

    x = np.random.default_rng(8).standard_normal((8, 1, 28, 28)).astype(np.float32)
    jm, pm = _pair(lambda: JLeNet5(class_num=10), lambda: LeNet5(class_num=10, device="cpu"),
                   x)
    for family in ("int8", "fp8"):
        jq_, pq_ = jm.quantize(family), pm.quantize(family)
        jy, py = _np(jq_.forward(jnp.asarray(x))), _np(pq_.forward(x))
        np.testing.assert_allclose(py, jy, rtol=0, atol=MODEL_REL * np.abs(jy).max())
        assert (py.argmax(1) == jy.argmax(1)).all()


def test_shape_prop_resolves_quantized_layers_on_meta_tensors():
    x = np.random.default_rng(9).standard_normal((2, 3, 8, 8)).astype(np.float32)
    RandomGenerator.set_seed(9)
    m = _seq(pnn, {"device": "cpu"})
    m.init(sample_input=x)
    for family in ("int8", "fp8"):
        q = m.quantize(family) if family == "int8" else _requantized(x, family)
        out = ShapeProp(q).infer(x)
        assert out.device.type == "meta"
        y = q.forward(x)
        assert tuple(out.shape) == tuple(y.shape) and out.dtype == y.dtype == torch.float32


def _requantized(x, family):
    RandomGenerator.set_seed(9)
    m = _seq(pnn, {"device": "cpu"})
    m.init(sample_input=x)
    return m.quantize(family)


def test_quantized_model_file_is_refused_on_load_as_in_jax(tmp_path):
    """Neither package's model file can bring a quantized model back: the
    containers' recorded constructor arguments still name the float layers
    (``quantize`` rewrites the tree after construction), so the load builds
    float layers and finds no ``weight`` array for them."""
    x = np.random.default_rng(10).standard_normal((3, 8)).astype(np.float32)
    jm, pm = _pair(lambda: jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4)),
                   lambda: pnn.Sequential(pnn.Linear(8, 16, device="cpu"), pnn.ReLU(device="cpu"),
                                          pnn.Linear(16, 4, device="cpu"), device="cpu"), x)
    errors = []
    for model, load, path in ((jm, jnn.load_module, tmp_path / "jax.npz"),
                              (pm, lambda p: pnn.load_module(p, device="cpu"),
                               tmp_path / "port.npz")):
        model.quantize().save_module(str(path))
        with pytest.raises(KeyError, match="weight") as e:
            load(str(path))
        errors.append(type(e.value))
    assert errors[0] is errors[1] is KeyError
