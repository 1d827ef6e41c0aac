"""The port's keras-style API (``bigdl_tpu_torch.nn.keras``) against the JAX
package's, case by case:

* every row of ``test_keras_breadth.py``'s shape table: the two wrappers
  built on the same input, the port's weights copied from the JAX
  wrapper's, outputs and the gradients of every input and parameter held
  through ``test_torch_activations.check_pair`` (f32: 1e-6 + 1e-5
  relative; the recurrent rows also 1e-6 of the largest value: XLA's and
  ATen's tanh/exp part by a few units in the last place a step), and the
  keras shape of the table;
* each case of ``test_keras_api.py`` and ``test_keras_oracle.py`` run in
  both packages: shapes, errors and their words, the outputs from the same
  weights (1e-6 + 1e-5 relative; BatchNormalization in train and eval
  mode), ``fit``/``evaluate``/``predict``/``predict_classes`` with their
  accuracy floors;
* the keras example's model (``examples/keras_train.cnn``, dropout 0: each
  package draws its own masks) fitted 4 SGD steps in both packages from the
  same weights over the same batches (one global seed gives both the same
  epoch order): losses within 1e-5, weights within 1e-5, validation
  results within 1e-5;
* a narrow U-Net (Ronneberger et al. 2015, Fig. 1: valid 3x3 pairs, 2x2
  pools, 2x2/s2 up-convolutions, cropped skips, base width 4, a 188x188
  tile, 2 classes) through the functional ``Model``: outputs and gradients
  (1e-5 + 1e-4 relative plus 1e-5 of the largest value: 23 stacked
  layers), its ``predict`` in batches;
* the names: every class and function of the JAX package's
  ``nn/{structural,conv,pooling,normalization,linear,initialization,module}.py``
  exists at the same path of the port, every name ``bigdl_tpu.nn`` exports
  (the interop loaders ``load_caffe``/``load_tf`` too) is in
  ``bigdl_tpu_torch.nn``, and the keras ``__all__`` are equal.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.nn import keras as JK
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.examples import keras_train
from bigdl_tpu_torch.nn import keras as PK
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_activations import _fp32_policy, check_pair  # noqa: F401 (fixture)
from test_torch_conv_bn import flat, np_tree

D = {"device": "cpu"}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# test_keras_breadth.py's table: (factory(K, d), input shape, keras output shape)
BREADTH = [
    (lambda K, d: K.Convolution1D(5, 3, **d), (2, 10, 4), (2, 8, 5)),
    (lambda K, d: K.Convolution3D(4, 2, 2, 2, **d), (1, 3, 6, 6, 6), (1, 4, 5, 5, 5)),
    (lambda K, d: K.AtrousConvolution2D(4, 3, 3, atrous_rate=(2, 2), **d),
     (1, 3, 9, 9), (1, 4, 5, 5)),
    (lambda K, d: K.AtrousConvolution1D(5, 3, atrous_rate=2, **d), (2, 10, 4), (2, 6, 5)),
    (lambda K, d: K.Deconvolution2D(4, 3, 3, subsample=(2, 2), **d),
     (1, 3, 5, 5), (1, 4, 11, 11)),
    (lambda K, d: K.SeparableConvolution2D(6, 3, 3, border_mode="same", depth_multiplier=2,
                                           **d), (1, 4, 8, 8), (1, 6, 8, 8)),
    (lambda K, d: K.LocallyConnected1D(5, 3, **d), (2, 10, 4), (2, 8, 5)),
    (lambda K, d: K.LocallyConnected2D(4, 3, 3, **d), (1, 3, 6, 6), (1, 4, 4, 4)),
    (lambda K, d: K.MaxPooling1D(2, **d), (2, 10, 4), (2, 5, 4)),
    (lambda K, d: K.AveragePooling1D(2, **d), (2, 10, 4), (2, 5, 4)),
    (lambda K, d: K.MaxPooling3D((2, 2, 2), **d), (1, 2, 4, 4, 4), (1, 2, 2, 2, 2)),
    (lambda K, d: K.AveragePooling3D((2, 2, 2), **d), (1, 2, 4, 4, 4), (1, 2, 2, 2, 2)),
    (lambda K, d: K.GlobalMaxPooling1D(**d), (2, 10, 4), (2, 4)),
    (lambda K, d: K.GlobalAveragePooling1D(**d), (2, 10, 4), (2, 4)),
    (lambda K, d: K.GlobalMaxPooling3D(**d), (1, 2, 4, 4, 4), (1, 2)),
    (lambda K, d: K.GlobalAveragePooling3D(**d), (1, 2, 4, 4, 4), (1, 2)),
    (lambda K, d: K.UpSampling1D(2, **d), (2, 5, 3), (2, 10, 3)),
    (lambda K, d: K.UpSampling2D((2, 3), **d), (1, 2, 4, 4), (1, 2, 8, 12)),
    (lambda K, d: K.UpSampling3D((2, 2, 2), **d), (1, 2, 3, 3, 3), (1, 2, 6, 6, 6)),
    (lambda K, d: K.ZeroPadding1D(2, **d), (2, 5, 3), (2, 9, 3)),
    (lambda K, d: K.ZeroPadding2D((1, 2), **d), (1, 2, 4, 4), (1, 2, 6, 8)),
    (lambda K, d: K.Cropping1D((1, 2), **d), (2, 8, 3), (2, 5, 3)),
    (lambda K, d: K.Cropping2D(((1, 1), (2, 1)), **d), (1, 2, 6, 7), (1, 2, 4, 4)),
    (lambda K, d: K.Cropping3D(((1, 1), (1, 1), (1, 1)), **d), (1, 2, 4, 4, 4), (1, 2, 2, 2, 2)),
    (lambda K, d: K.Permute((2, 1), **d), (2, 3, 5), (2, 5, 3)),
    (lambda K, d: K.Permute((3, 1, 2), **d), (2, 3, 4, 5), (2, 5, 3, 4)),
    (lambda K, d: K.RepeatVector(6, **d), (2, 3), (2, 6, 3)),
    (lambda K, d: K.Masking(0.0, **d), (2, 5, 3), (2, 5, 3)),
    (lambda K, d: K.GaussianNoise(0.1, **d), (2, 5), (2, 5)),
    (lambda K, d: K.GaussianDropout(0.1, **d), (2, 5), (2, 5)),
    (lambda K, d: K.SpatialDropout1D(0.3, **d), (2, 5, 3), (2, 5, 3)),
    (lambda K, d: K.SpatialDropout2D(0.3, **d), (2, 3, 4, 4), (2, 3, 4, 4)),
    (lambda K, d: K.SpatialDropout3D(0.3, **d), (2, 3, 2, 4, 4), (2, 3, 2, 4, 4)),
    (lambda K, d: K.ELU(0.5, **d), (2, 5), (2, 5)),
    (lambda K, d: K.LeakyReLU(0.1, **d), (2, 5), (2, 5)),
    (lambda K, d: K.PReLU(**d), (2, 5), (2, 5)),
    (lambda K, d: K.SReLU(**d), (2, 5), (2, 5)),
    (lambda K, d: K.ThresholdedReLU(0.5, **d), (2, 5), (2, 5)),
    (lambda K, d: K.SoftMax(**d), (2, 5), (2, 5)),
    (lambda K, d: K.Highway(**d), (2, 6), (2, 6)),
    (lambda K, d: K.MaxoutDense(7, nb_feature=3, **d), (2, 6), (2, 7)),
    (lambda K, d: K.TimeDistributed(K.Dense(6, **d), **d), (2, 5, 4), (2, 5, 6)),
    (lambda K, d: K.Bidirectional(K.LSTM(4, return_sequences=True, **d), merge_mode="concat",
                                  **d), (2, 5, 3), (2, 5, 8)),
    (lambda K, d: K.Bidirectional(K.LSTM(4, **d), merge_mode="sum", **d), (2, 5, 3), (2, 4)),
    (lambda K, d: K.ConvLSTM2D(4, 3, return_sequences=True, **d), (1, 3, 2, 6, 6),
     (1, 3, 4, 6, 6)),
    (lambda K, d: K.ConvLSTM2D(4, 3, **d), (1, 3, 2, 6, 6), (1, 4, 6, 6)),
]
RECURRENT = ("Bidirectional", "ConvLSTM2D")


def test_the_table_is_test_keras_breadths():
    from test_keras_breadth import CASES

    assert len(BREADTH) == len(CASES)
    for (f, i, o), (jf, ji, jo) in zip(BREADTH, CASES):
        assert (type(f(JK, {})), i, o) == (type(jf()), ji, jo)


@pytest.mark.parametrize("i", range(len(BREADTH)),
                         ids=[f"{i:02d}-{type(c[0](JK, {})).__name__}"
                              for i, c in enumerate(BREADTH)])
def test_wrapper_matches_jax(i):
    make, in_shape, out_shape = BREADTH[i]
    jm = make(JK, {})
    share = 1e-6 if type(jm).__name__ in RECURRENT else None
    x = _x(*in_shape, seed=i)
    if type(jm).__name__ == "Masking":
        x[0, 1] = 0.0
    y = check_pair(jm, make(PK, D), x, grad_share=share)
    assert tuple(y[0].shape) == out_shape


# ------------------------------------------------------- test_keras_api.py
def _both(make, x, training=False, seed=0):
    """Build JAX's and the port's ``make(K, d)`` on ``x``, the port's
    weights (and state) from the JAX one's; the two outputs."""
    jm, pm = make(JK, {}), make(PK, D)
    jp, js = jm.init(jax.random.PRNGKey(seed), sample_input=jnp.asarray(x))
    pm.init(sample_input=torch.from_numpy(x))
    if flat(np_tree(jp)):
        load_jax_params(pm, np_tree(jp))
    if flat(np_tree(js)):
        load_jax_state(pm, np_tree(js))
    if training:
        pm.train()
        jm.training()
    else:
        pm.evaluate()
        jm.evaluate()
    return np.asarray(jm.forward(jnp.asarray(x))), pm.forward(torch.from_numpy(x)).detach().numpy()


def _close(a, b):
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-5)


def test_dense_shapes_and_activation():
    jy, py = _both(lambda K, d: K.Dense(16, activation="relu", **d), _x(4, 8))
    assert py.shape == (4, 16) and (py >= 0).all()
    _close(jy, py)


def test_conv_pool_stack():
    def make(K, d):
        m = K.Sequential(**d)
        m.add(K.Convolution2D(4, 3, 3, border_mode="same", activation="relu", **d))
        m.add(K.MaxPooling2D(**d))
        return m
    jy, py = _both(make, _x(2, 3, 16, 16, seed=1))
    assert py.shape == (2, 4, 8, 8)
    _close(jy, py)


def test_global_pooling():
    x = _x(2, 3, 8, 8, seed=2)
    jy, py = _both(lambda K, d: K.GlobalAveragePooling2D(**d), x)
    np.testing.assert_allclose(py, x.mean(axis=(2, 3)), atol=1e-6)
    _close(jy, py)
    jy, py = _both(lambda K, d: K.GlobalMaxPooling2D(**d), x)
    _close(jy, py)


def test_batchnorm_picks_spatial():
    bn = PK.BatchNormalization(**D)
    bn.forward(np.ones((2, 3, 4, 4), np.float32))
    assert isinstance(bn[0], pnn.SpatialBatchNormalization)
    bn1 = PK.BatchNormalization(**D)
    bn1.forward(np.ones((2, 3), np.float32))
    assert type(bn1[0]) is pnn.BatchNormalization
    assert bn[0].momentum == pytest.approx(1.0 - 0.99) and bn[0].eps == 1e-3


def test_lstm_return_sequences():
    x = _x(2, 5, 8, seed=3)
    jy, py = _both(lambda K, d: K.LSTM(6, return_sequences=True, **d), x)
    assert py.shape == (2, 5, 6)
    _close(jy, py)
    jy, py = _both(lambda K, d: K.LSTM(6, **d), x)
    assert py.shape == (2, 6)
    _close(jy, py)


def test_embedding():
    ids = np.array([[0, 1, 2], [2, 1, 0]], np.int32)
    jy, py = _both(lambda K, d: K.Embedding(10, 4, **d), ids)
    assert py.shape == (2, 3, 4)
    _close(jy, py)


def test_unknown_activation_raises():
    for K, d in ((JK, {}), (PK, D)):
        with pytest.raises(ValueError, match="unknown activation"):
            K.Dense(4, activation="bogus", **d).forward(np.ones((1, 2), np.float32))


def _mnistish(seed=4):
    r = np.random.default_rng(seed)
    x = r.standard_normal((64, 1, 8, 8)).astype(np.float32)
    return x, (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)


@pytest.mark.parametrize("K,d,optim,nn", [(JK, {}, joptim, jnn), (PK, D, poptim, pnn)],
                         ids=["jax", "port"])
def test_fit_evaluate_predict_mnistish(K, d, optim, nn):
    x, y = _mnistish()
    (JRandom if K is JK else RandomGenerator).set_seed(0)
    m = K.Sequential(**d)
    m.add(K.Convolution2D(4, 3, 3, activation="relu", input_shape=(1, 8, 8), **d))
    m.add(K.Flatten(**d))
    m.add(K.Dense(2, activation="log_softmax", **d))
    m.compile(optimizer=optim.Adam(learningrate=0.01), loss=nn.ClassNLLCriterion(),
              metrics=["accuracy"])
    m.fit(x, y, batch_size=16, nb_epoch=15)
    loss, acc = m.evaluate(x, y, batch_size=16)[:2]
    assert acc > 0.8, (loss, acc)
    assert np.asarray(m.predict(x[:8])).shape == (8, 2)
    assert np.asarray(m.predict_classes(x[:8])).shape == (8,)


@pytest.mark.parametrize("K,d", [(JK, {}), (PK, D)], ids=["jax", "port"])
def test_categorical_crossentropy_onehot(K, d):
    r = np.random.default_rng(5)
    x = r.standard_normal((32, 6)).astype(np.float32)
    onehot = np.eye(2)[(x.sum(1) > 0).astype(int)]
    m = K.Sequential(**d)
    m.add(K.Dense(2, input_shape=(6,), **d))
    m.compile(optimizer="sgd", loss="categorical_crossentropy")
    m.fit(x, onehot + 0, batch_size=16, nb_epoch=5)
    assert np.isfinite(m.evaluate(x, onehot)[0])


def test_fit_without_compile_raises():
    for K, d in ((JK, {}), (PK, D)):
        m = K.Sequential(**d).add(K.Dense(2, input_shape=(4,), **d))
        with pytest.raises(RuntimeError, match="compile"):
            m.fit(np.ones((4, 4), np.float32), np.ones(4))


def _two_branch(K, d):
    inp = K.Input(shape=(8,))
    a = K.Dense(4, activation="relu", **d)(inp)
    b = K.Dense(4, activation="tanh", **d)(inp)
    merged = K.Merge(mode="concat", **d)([a, b])
    return K.Model(inp, K.Dense(2, **d)(merged), **d)


def test_two_branch_merge():
    jy, py = _both(_two_branch, _x(3, 8, seed=6))
    assert py.shape == (3, 2)
    _close(jy, py)


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "max"])
def test_merge_modes(mode):
    def make(K, d):
        inp = K.Input(shape=(5,))
        a = K.Dense(3, **d)(inp)
        b = K.Dense(3, **d)(inp)
        return K.Model(inp, K.Merge(mode=mode, **d)([a, b]), **d)
    jy, py = _both(make, _x(4, 5, seed=7))
    _close(jy, py)


@pytest.mark.parametrize("K,d,optim", [(JK, {}, joptim), (PK, D, poptim)], ids=["jax", "port"])
def test_functional_fit(K, d, optim):
    r = np.random.default_rng(7)
    x = r.standard_normal((32, 4)).astype(np.float32)
    y = x @ r.standard_normal((4, 1)).astype(np.float32)
    inp = K.Input(shape=(4,))
    out = K.Dense(1, **d)(K.Dense(8, activation="tanh", **d)(inp))
    model = K.Model(inp, out, **d)
    model.compile(optimizer=optim.Adam(learningrate=0.02), loss="mse")
    model.fit(x, y, batch_size=16, nb_epoch=40)
    final = model.evaluate(x, y)[0]
    assert final < 0.5 * float(np.mean(y ** 2)), final


def test_same_pooling_shape():
    x = _x(2, 3, 7, 7, seed=8)
    jy, py = _both(lambda K, d: K.MaxPooling2D(pool_size=(2, 2), border_mode="same", **d), x)
    assert py.shape == (2, 3, 4, 4)
    _close(jy, py)
    jy, py = _both(lambda K, d: K.AveragePooling2D(pool_size=(3, 3), strides=(1, 1),
                                                   border_mode="same", **d), x)
    assert py.shape == (2, 3, 7, 7)
    _close(jy, py)


def test_evaluate_uncompiled():
    for K, d in ((JK, {}), (PK, D)):
        m = K.Sequential(**d).add(K.Dense(2, input_shape=(4,), **d))
        assert np.isfinite(m.evaluate(np.ones((4, 4), np.float32),
                                      np.ones((4, 1), np.float32))[0])


def test_rnn_activation_forwarding():
    x = _x(2, 4, 6, seed=9)
    jy, py = _both(lambda K, d: K.SimpleRNN(5, activation="relu", return_sequences=True, **d), x)
    assert (py >= 0).all()
    _close(jy, py)
    jy, py = _both(lambda K, d: K.SimpleRNN(5, activation="sigmoid", **d), x)
    _close(jy, py)
    for K, d in ((JK, {}), (PK, D)):
        with pytest.raises(ValueError, match="tanh"):
            K.LSTM(5, activation="relu", **d).forward(x)


def test_dim_ordering_tf_rejected():
    for K, d in ((JK, {}), (PK, D)):
        with pytest.raises(ValueError, match="NCHW"):
            K.Convolution2D(4, 3, 3, dim_ordering="tf", **d)
        with pytest.raises(ValueError, match="NCHW"):
            K.MaxPooling2D(dim_ordering="tf", **d)
        with pytest.raises(ValueError, match="valid"):
            K.Deconvolution2D(4, 3, 3, border_mode="same", **d)
        with pytest.raises(ValueError, match="same"):
            K.ConvLSTM2D(4, 3, border_mode="valid", **d)
        with pytest.raises(TypeError, match="Bidirectional"):
            K.Bidirectional(K.Dense(3, **d), **d)


def test_input_shape_validated():
    for K, d in ((JK, {}), (PK, D)):
        inp = K.Input(shape=(5,))
        model = K.Model(inp, K.Dense(2, **d)(inp), **d)
        with pytest.raises(ValueError, match="declared shape"):
            model.forward(np.ones((3, 7), np.float32))


# ----------------------------------------------------- test_keras_oracle.py
ORACLE = {
    "Dense": (lambda K, d: K.Dense(7, activation="relu", input_shape=(5,), **d), (4, 5)),
    "Convolution2D_valid": (lambda K, d: K.Convolution2D(6, 3, 3, input_shape=(2, 9, 9), **d),
                            (2, 2, 9, 9)),
    "Convolution2D_strided": (lambda K, d: K.Convolution2D(6, 3, 3, subsample=(2, 2), **d),
                              (2, 2, 9, 9)),
    "Convolution2D_same": (lambda K, d: K.Convolution2D(6, 3, 3, border_mode="same", **d),
                           (2, 2, 9, 9)),
    "Convolution1D": (lambda K, d: K.Convolution1D(5, 3, input_shape=(8, 4), **d), (2, 8, 4)),
    "MaxPooling2D": (lambda K, d: K.MaxPooling2D(pool_size=(2, 2), **d), (2, 3, 8, 8)),
    "AveragePooling2D": (lambda K, d: K.AveragePooling2D(pool_size=(2, 2), **d), (2, 3, 8, 8)),
    "GlobalAveragePooling2D": (lambda K, d: K.GlobalAveragePooling2D(**d), (2, 3, 6, 6)),
    "LSTM_sequences": (lambda K, d: K.LSTM(6, return_sequences=True, **d), (2, 5, 3)),
    "LSTM_last": (lambda K, d: K.LSTM(6, **d), (2, 5, 3)),
    "SimpleRNN": (lambda K, d: K.SimpleRNN(4, **d), (2, 6, 3)),
    "GRU": (lambda K, d: K.GRU(5, **d), (2, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(ORACLE))
def test_oracle_case_matches_jax(name):
    make, shape = ORACLE[name]
    jy, py = _both(make, _x(*shape, seed=10))
    _close(jy, py)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_jax(training):
    x = _x(6, 4, 5, 5, seed=11)
    jy, py = _both(lambda K, d: K.BatchNormalization(input_shape=(4, 5, 5), **d), x, training)
    np.testing.assert_allclose(py, jy, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- the example's fit
def test_example_model_fits_alike():
    x = _x(256, 1, 28, 28, seed=12)
    y = np.random.default_rng(12).integers(0, 10, 256)
    runs = {}
    for K, d, optim in ((JK, {}, joptim), (PK, D, poptim)):
        m = keras_train.cnn(K, dropout=0.0, **d)
        m.init(*(() if K is PK else (jax.random.PRNGKey(3),)), sample_input=x[:64])
        if K is PK:
            load_jax_params(m, runs["jax"]["init"])
        m.compile(optimizer=optim.SGD(learningrate=0.05), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        (JRandom if K is JK else RandomGenerator).set_seed(7)
        if K is JK:
            init = np_tree(m.get_parameters())
            losses = []
            orig = joptim.LocalOptimizer._log_iteration

            def log(self, state, loss, *a, **k):
                losses.append(float(loss))
                return orig(self, state, loss, *a, **k)

            joptim.LocalOptimizer._log_iteration = log
            try:
                m.fit(x, y, batch_size=64, nb_epoch=1, validation_data=(x[:128], y[:128]))
            finally:
                joptim.LocalOptimizer._log_iteration = orig
        else:
            init = None
            m.fit(x, y, batch_size=64, nb_epoch=1, validation_data=(x[:128], y[:128]))
            losses = [h["loss"] for h in m.last_optimizer.history]
        runs["jax" if K is JK else "port"] = dict(
            init=init, losses=losses,
            params=flat(np_tree(m.get_parameters()) if K is JK else m.get_parameters()),
            val=m.evaluate(x[:128], y[:128]))
    j, p = runs["jax"], runs["port"]
    assert len(p["losses"]) == len(j["losses"]) == 4
    np.testing.assert_allclose(p["losses"], j["losses"], atol=1e-5)
    assert set(p["params"]) == set(j["params"])
    for k, v in j["params"].items():
        np.testing.assert_allclose(p["params"][k], v, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(p["val"], j["val"], atol=1e-5)


def test_example_main_runs_on_the_cpu():
    run = keras_train.main(["--platform", "cpu", "--synthetic-size", "256", "--max-epoch", "1",
                            "-b", "64"])
    losses = [h["loss"] for h in run.optimizer.history]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert len(run.results["validation"]) == 2
    assert run.model.predict_classes(np.zeros((3, 1, 28, 28), np.float32)).shape == (3,)


# ------------------------------------------------------------------ U-Net
def unet_sizes(tile: int):
    """Each level's (conv output, pooled) sizes down and (up, conv) up, for
    a valid U-Net on a ``tile`` x ``tile`` input."""
    down, s = [], tile
    for _ in range(4):
        s -= 4
        down.append(s)
        s //= 2
    bottom = s - 4
    return down, bottom


def unet(K, base, classes, tile, d):
    """The U-Net of Ronneberger et al. 2015 (arXiv:1505.04597, Fig. 1) in
    the keras functional API: valid 3x3 ReLU pairs at base·(1, 2, 4, 8, 16),
    2x2 max pools, 2x2/s2 up-convolutions, each skip cropped to the
    up-convolution's size and joined before it, a 1x1 convolution to
    ``classes``."""
    down, s = unet_sizes(tile)

    def pair(x, n):
        x = K.Convolution2D(n, 3, 3, activation="relu", **d)(x)
        return K.Convolution2D(n, 3, 3, activation="relu", **d)(x)

    inp = K.Input(shape=(1, tile, tile))
    skips, x = [], inp
    for level in range(4):
        x = pair(x, base * 2 ** level)
        skips.append(x)
        x = K.MaxPooling2D(**d)(x)
    x = pair(x, base * 16)
    for level in reversed(range(4)):
        x = K.Deconvolution2D(base * 2 ** level, 2, 2, subsample=(2, 2), **d)(x)
        s = 2 * s
        c = (down[level] - s) // 2
        skip = K.Cropping2D(((c, c), (c, c)), **d)(skips[level])
        x = pair(K.Merge(mode="concat", concat_axis=1, **d)([skip, x]), base * 2 ** level)
        s -= 4
    return K.Model(inp, K.Convolution2D(classes, 1, 1, **d)(x), **d)


def test_unet_sizes_are_the_papers():
    assert unet_sizes(572) == ([568, 280, 136, 64], 28)
    m = unet(PK, 1, 2, 572, {"device": "meta"})
    from bigdl_tpu_torch.nn.module import infer_module_shape

    assert tuple(infer_module_shape(m, torch.empty(1, 1, 572, 572, device="meta")).shape) == (
        1, 2, 388, 388)


def test_narrow_unet_matches_jax():
    x = _x(1, 1, 188, 188, seed=13)
    y = check_pair(unet(JK, 4, 2, 188, {}), unet(PK, 4, 2, 188, D), x, atol=1e-5, rtol=1e-4,
                   grad_share=1e-5)
    assert tuple(y[0].shape) == (1, 2, 4, 4)


def test_unet_predict_in_batches():
    RandomGenerator.set_seed(4)
    m = unet(PK, 2, 2, 188, D)
    x = _x(5, 1, 188, 188, seed=14)
    out = m.predict(x, batch_size=2)
    assert out.shape == (5, 2, 4, 4) and np.isfinite(out).all()
    m.evaluate()
    with torch.no_grad():
        np.testing.assert_allclose(out[4:], m.forward(torch.from_numpy(x[4:])).numpy(),
                                   atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------------ names
NN_FILES = ("structural", "conv", "pooling", "normalization", "linear", "initialization",
            "module")


@pytest.mark.parametrize("name", NN_FILES)
def test_the_port_has_every_name_of_the_jax_file(name):
    jmod = importlib.import_module(f"bigdl_tpu.nn.{name}")
    pmod = importlib.import_module(f"bigdl_tpu_torch.nn.{name}")
    names = [n for n, o in vars(jmod).items()
             if not n.startswith("_") and (inspect.isclass(o) or inspect.isfunction(o))
             and o.__module__ == jmod.__name__]
    assert names and [n for n in names if not hasattr(pmod, n)] == []


def test_the_port_nn_exports_every_jax_name_but_the_interop_loaders():
    missing = sorted(n for n in vars(jnn) if not n.startswith("_") and not hasattr(pnn, n)
                     and not inspect.ismodule(getattr(jnn, n)))
    assert missing == []  # the interop loaders too, since they were ported
    assert set(PK.__all__) == set(JK.__all__)
    assert all(hasattr(PK, n) for n in PK.__all__)
