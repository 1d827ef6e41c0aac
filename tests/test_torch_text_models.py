"""The port's text-model slice against the JAX package's: ``Sum``, ``Mean``,
``Max`` and ``Min`` (1-based dims, ``n_input_dims``, ``squeeze``; ties
planted, whose gradient both split evenly), ``TemporalConvolution``
(stride, dilation, its errors), ``TemporalMaxPooling`` (ties planted,
whose gradient both send to the first maximum), ``TimeDistributed``
(nested parameter paths); ``CNNTextClassifier`` and ``PTBModel`` (paths,
forward, 3 ``LocalOptimizer`` steps each); ``examples/ptb_train`` (its
corpus reader against the JAX main's on files the test writes, its
``main`` to its end at a tiny size).

Inputs from numpy with a seed, f32 on the CPU. Tolerances, fixed before
the first run: the reductions' outputs exact and their gradients 1e-7
absolute (a tie's share is dy / k in both), except that a mean's output
may be one f32 unit in the last place apart (``Mean``, ``Sum`` with
``size_average``: the first run read 1.19e-7 at magnitude 1.67, a sum
divided by the count in another rounding; 2^-23 relative allowed since); ``TemporalMaxPooling`` exact
(a copy of elements, each gradient routed whole); ``TemporalConvolution``,
``TimeDistributed`` and the models' log-probabilities 1e-5 absolute + 1e-5
relative, their gradients likewise (the same f32 products summed in
another order); after 3 steps (SGD lr 0.01 momentum 0.9 for the CNN, Adam
1e-3 for PTB, the examples' methods), losses 1e-5, every parameter 1e-5
absolute and the whole update within 1e-3 relative L2.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import CNNTextClassifier as JCNNTextClassifier
from bigdl_tpu.models import PTBModel as JPTBModel
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.examples import ptb_train
from bigdl_tpu_torch.models import CNNTextClassifier, PTBModel
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_ncf import (_engine_isolation, _fp32_policy,  # noqa: F401 (fixtures)
                            assert_trained_alike, train_both)

TOL = dict(atol=1e-5, rtol=1e-5)


def _vjp_pair(jmod, pmod, x, dy, params=None):
    """Both modules' outputs and input gradients for the cotangent ``dy``
    (the port's carrying ``params``, the JAX module's, when given)."""
    jp, js = (params, jmod.get_state()) if params else ({}, {})
    jy, vjp = jax.vjp(lambda v: jmod.apply(jp, js, v)[0], jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    py, _ = pmod.apply(*((pmod.get_parameters(), pmod.get_state()) if params else ({}, {})), xt)
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy))
    return (np.asarray(jy), np.asarray(jdx)), (py.detach().numpy(), pdx.numpy())


# ------------------------------------------------------------ reductions
@pytest.mark.parametrize("squeeze", [True, False])
@pytest.mark.parametrize("dimension,n_input_dims", [(1, -1), (2, -1), (3, -1), (1, 2), (2, 2)])
@pytest.mark.parametrize("cls", ["Sum", "Mean", "Max", "Min"])
def test_reductions_match_jax_with_ties(cls, dimension, n_input_dims, squeeze):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (3, 5, 4)).astype(np.float32)  # many ties
    kw = dict(n_input_dims=n_input_dims, squeeze=squeeze)
    if cls == "Sum":
        kw["size_average"] = dimension == 2
    jmod, pmod = getattr(jnn, cls)(dimension, **kw), getattr(pnn, cls)(dimension, **kw,
                                                                       device="cpu")
    jy = np.asarray(jmod.apply({}, {}, jnp.asarray(x))[0])
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    (jy, jdx), (py, pdx) = _vjp_pair(jmod, pmod, x, dy)
    assert py.shape == jy.shape
    if cls == "Mean" or kw.get("size_average"):
        np.testing.assert_allclose(py, jy, rtol=2.0 ** -23, atol=0)
    else:
        np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(pdx, jdx, atol=1e-7, rtol=0)


def test_max_over_time_splits_tied_gradients_evenly():
    x = np.zeros((1, 4, 2), np.float32)
    x[0, [0, 2, 3], 0] = 5.0  # three tied maxima in channel 0
    x[0, 1, 1] = 1.0
    pm = pnn.Max(1, n_input_dims=2, device="cpu")
    (jy, jdx), (py, pdx) = _vjp_pair(jnn.Max(1, n_input_dims=2), pm, x,
                                     np.array([[3.0, 1.0]], np.float32))
    np.testing.assert_array_equal(py, [[5.0, 1.0]])
    np.testing.assert_allclose(pdx[0, :, 0], [1.0, 0.0, 1.0, 1.0], rtol=1e-7)
    np.testing.assert_allclose(pdx, jdx, rtol=1e-7)


# ------------------------------------------------------ TemporalConvolution
@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 3), (3, 2)])
def test_temporal_convolution_matches_jax(stride, dilation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 17, 6)).astype(np.float32)
    jm = jnn.TemporalConvolution(6, 4, 3, stride, dilation)
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = pnn.TemporalConvolution(6, 4, 3, stride, dilation, device="cpu")
    pm.init(sample_input=x)
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == {
        k: v.shape for k, v in flat(np_tree(jp)).items()}
    load_jax_params(pm, np_tree(jp))
    jy = np.asarray(jm.apply(jp, {}, jnp.asarray(x))[0])
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    (jy, jdx), (py, pdx) = _vjp_pair(jm, pm, x, dy, params=jp)
    np.testing.assert_allclose(py, jy, **TOL)
    np.testing.assert_allclose(pdx, jdx, **TOL)
    jg = jax.grad(lambda p: jnp.sum(jm.apply(p, {}, jnp.asarray(x))[0] * dy))(jp)
    pm.zero_grad_parameters()
    pm.backward(x, dy)
    for k, v in flat(np_tree(jg)).items():
        np.testing.assert_allclose(flat(pm.get_grad_parameters())[k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("args,shape", [((5, 4, 3), (2, 10, 6)),   # declared frame size 5
                                        ((6, 4, 7, 1, 2), (2, 10, 6)),  # 13 frames > 10
                                        ((6, 4, 3), (2, 10))])  # not (N, T, C)
def test_temporal_convolution_errors_match_jax(args, shape):
    jm = jnn.TemporalConvolution(*args).set_name("tc")
    with pytest.raises(ValueError) as jerr:
        jm.infer_shape(jax.ShapeDtypeStruct(shape, jnp.float32))
    pm = pnn.TemporalConvolution(*args, device="cpu").set_name("tc")
    with pytest.raises(ValueError) as perr:
        pm.forward(np.zeros(shape, np.float32))
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------------ TemporalMaxPooling
@pytest.mark.parametrize("k_w,d_w", [(2, None), (3, 2), (5, 5), (2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temporal_max_pooling_matches_jax_with_ties(k_w, d_w, dtype):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 3, (2, 13, 4)).astype(np.float32)  # ties in most windows
    jm, pm = jnn.TemporalMaxPooling(k_w, d_w), pnn.TemporalMaxPooling(k_w, d_w, device="cpu")
    jy = jm.apply({}, {}, jnp.asarray(x))[0]
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, vjp = jax.vjp(lambda v: jm.apply({}, {}, v)[0], jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    py, _ = pm.apply({}, {}, xt)
    (pdx,) = torch.autograd.grad(py, xt, torch.from_numpy(dy).to(tdt))
    assert py.dtype == tdt and tuple(py.shape) == jy.shape
    np.testing.assert_array_equal(py.detach().float().numpy(), np.asarray(jy, np.float32))
    np.testing.assert_array_equal(pdx.float().numpy(), np.asarray(jdx, np.float32))


def test_temporal_max_pooling_routes_a_tie_to_the_first_maximum():
    x = np.array([[[1.0], [4.0], [4.0], [2.0], [4.0], [4.0]]], np.float32)
    (_, jdx), (py, pdx) = _vjp_pair(jnn.TemporalMaxPooling(3),
                                    pnn.TemporalMaxPooling(3, device="cpu"), x,
                                    np.array([[[1.0], [10.0]]], np.float32))
    np.testing.assert_array_equal(pdx[0, :, 0], [0, 1, 0, 0, 10, 0])
    np.testing.assert_array_equal(pdx, jdx)


def test_temporal_max_pooling_window_error_matches_jax():
    jm = jnn.TemporalMaxPooling(5).set_name("tp")
    with pytest.raises(ValueError) as jerr:
        jm.infer_shape(jax.ShapeDtypeStruct((2, 4, 3), jnp.float32))
    with pytest.raises(ValueError) as perr:
        pnn.TemporalMaxPooling(5, device="cpu").set_name("tp").forward(np.zeros((2, 4, 3),
                                                                                np.float32))
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------- TimeDistributed
def test_time_distributed_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 5)).astype(np.float32)
    jm = jnn.TimeDistributed(jnn.Linear(5, 3).set_name("inner")).set_name("td")
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = pnn.TimeDistributed(pnn.Linear(5, 3, device="cpu").set_name("inner"),
                             device="cpu").set_name("td")
    pm.init(sample_input=x)
    assert sorted(k for k, _ in pm.named_parameters()) == ["inner.bias", "inner.weight"]
    assert set(flat(np_tree(jp))) == {"inner.bias", "inner.weight"}
    load_jax_params(pm, np_tree(jp))
    dy = rng.standard_normal((2, 4, 3)).astype(np.float32)
    (jy, jdx), (py, pdx) = _vjp_pair(jm, pm, x, dy, params=jp)
    assert py.shape == (2, 4, 3)
    np.testing.assert_allclose(py, jy, **TOL)
    np.testing.assert_allclose(pdx, jdx, **TOL)


# ------------------------------------------------------------------ models
def _logprobs_match(jm, pm, x):
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm.init(sample_input=x)
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == {
        k: v.shape for k, v in flat(np_tree(jp)).items()}
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    load_jax_params(pm, np_tree(jp))
    jy = jm.apply(jp, js, jnp.asarray(x))[0]
    py = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x))[0]
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **TOL)
    return py


def test_cnn_text_classifier_matches_jax():
    x = np.random.default_rng(4).integers(0, 50, (3, 40)).astype(np.int32)
    py = _logprobs_match(JCNNTextClassifier(50, embedding_dim=8, class_num=4),
                         CNNTextClassifier(50, embedding_dim=8, class_num=4, device="cpu"), x)
    assert tuple(py.shape) == (3, 4)


def test_cnn_text_classifier_trains_like_jax():
    rng = np.random.default_rng(5)
    x, y = rng.integers(0, 50, (12, 40)).astype(np.int32), rng.integers(0, 4, 12)
    run = train_both(JCNNTextClassifier(50, embedding_dim=8, class_num=4),
                     CNNTextClassifier(50, embedding_dim=8, class_num=4, device="cpu"), x, y, 4,
                     lambda nn: nn.ClassNLLCriterion(),
                     lambda o: o.SGD(learningrate=0.01, momentum=0.9))
    assert_trained_alike(run)


def test_ptb_model_matches_jax():
    x = np.random.default_rng(6).integers(0, 30, (3, 7)).astype(np.int32)
    py = _logprobs_match(JPTBModel(30, 8, 6, 2), PTBModel(30, 8, 6, 2, device="cpu"), x)
    assert tuple(py.shape) == (3, 7, 30)


def test_ptb_model_trains_like_jax():
    rng = np.random.default_rng(7)
    x, y = rng.integers(1, 30, (8, 6)).astype(np.int32), rng.integers(1, 30, (8, 6))
    run = train_both(JPTBModel(31, 8, 6, 2), PTBModel(31, 8, 6, 2, device="cpu"), x, y, 4,
                     lambda nn: nn.TimeDistributedCriterion(
                         nn.ClassNLLCriterion(one_based_label=True), size_average=True),
                     lambda o: o.Adam(learningrate=1e-3))
    assert_trained_alike(run)


# --------------------------------------------------------- the PTB example
def _jax_ptb_main():
    path = Path(__file__).resolve().parents[1] / "examples" / "ptb" / "train.py"
    spec = importlib.util.spec_from_file_location("jax_ptb_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("files", ["synthetic", "train", "train+valid"])
def test_ptb_corpus_matches_the_jax_main(tmp_path, files):
    words = "the cat sat on the mat and the dog sat on a log of wood".split()
    rng = np.random.default_rng(8)
    if files != "synthetic":
        (tmp_path / "ptb.train.txt").write_text(" ".join(rng.choice(words, 300)))
    if files == "train+valid":
        (tmp_path / "ptb.valid.txt").write_text(" ".join(rng.choice(words + ["zebra"], 80)))
    data_dir = None if files == "synthetic" else str(tmp_path)
    for vocab in (6, 40):
        got = ptb_train.load_corpus(data_dir, vocab, 500, seed=0)
        want = _jax_ptb_main()._load_corpus(data_dir, vocab, 500, seed=0)
        for g, w in zip(got[:2], want[:2]):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]


def test_ptb_example_runs_to_its_end(capsys):
    run = ptb_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "900",
                          "--vocab-size", "40", "--hidden-size", "8", "--seq-len", "10",
                          "-b", "4"])
    assert len(run.optimizer.history) == int(0.9 * 89) // 4
    assert all(np.isfinite(h["loss"]) for h in run.optimizer.history)
    assert np.isfinite(run.results["Loss"]) and "perplexity" in capsys.readouterr().out
    # --summary-dir is taken and, as in the JAX main, nothing is written there
    # (test_torch_examples_flags.py runs it)
