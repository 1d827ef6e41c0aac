"""The port's other recurrent cells against the JAX package's: ``RnnCell``
(tanh and sigmoid), ``LSTMPeephole``, ``GRU`` and ``ConvLSTMPeephole``
(with and without peepholes, with even ``kernel_c`` 2 and 4, whose SAME
padding is one cell more on the high side) as one bare step, under
``Recurrent`` and under ``BiRecurrent`` (T 6), and ``RecurrentDecoder``
over ``LSTM``, ``LSTMPeephole``, ``GRU``, ``RnnCell`` and
``ConvLSTMPeephole``: forward, and the input's and every parameter's
gradient against ``jax.grad``; the bf16 policy over ``Recurrent(GRU)``; 3
``LocalOptimizer`` SGD steps of a GRU text classifier through both
packages.

Weights carried with ``load_jax_params``; inputs from numpy with a seed,
f32 on the CPU. Tolerances, fixed before the first run, as
``test_torch_recurrent.py``'s: outputs and gradients 1e-5 absolute (the
same f32 products summed in another order, carried through 6 steps of a
contracting recurrence; the decoder through 7); under the bf16 policy
1e-2 relative L2 and 5e-2 of the largest value (the input product rounded
to bf16 once per element in both, after fp32 sums taken in another order);
after 3 SGD steps losses 1e-5 absolute, every parameter 1e-5 absolute and
the whole update within 1e-3 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_activations import _fp32_policy, check_pair  # noqa: F401
from test_torch_conv_bn import np_tree
from test_torch_lenet import sgd_steps, update_distance

N, T, D, H = 3, 6, 5, 6
CONV = dict(n=2, c=2, hw=6, out=3)

CELLS = {
    "RnnCell": lambda nn, d: nn.RnnCell(D, H, **d),
    "RnnCell_sigmoid": lambda nn, d: nn.RnnCell(
        D, H, activation=jax.nn.sigmoid if nn is jnn else torch.sigmoid, **d),
    "LSTMPeephole": lambda nn, d: nn.LSTMPeephole(D, H, **d),
    "GRU": lambda nn, d: nn.GRU(D, H, **d),
    "ConvLSTMPeephole": lambda nn, d: nn.ConvLSTMPeephole(CONV["c"], CONV["out"], 3, 3, **d),
    "ConvLSTMPeephole_no_peephole": lambda nn, d: nn.ConvLSTMPeephole(
        CONV["c"], CONV["out"], 3, 3, with_peephole=False, **d),
    "ConvLSTMPeephole_kernel_c2": lambda nn, d: nn.ConvLSTMPeephole(CONV["c"], CONV["out"], 3, 2,
                                                                    **d),
    "ConvLSTMPeephole_kernel_4_2": lambda nn, d: nn.ConvLSTMPeephole(CONV["c"], CONV["out"], 4,
                                                                     2, **d),
    "ConvLSTMPeephole_kernel_c4": lambda nn, d: nn.ConvLSTMPeephole(
        CONV["c"], CONV["out"], 1, 4, with_peephole=False, **d),
}


def _sequence(kind, steps=T, seed=1):
    rng = np.random.default_rng(seed)
    if kind.startswith("ConvLSTM"):
        shape = (CONV["n"], steps, CONV["c"], CONV["hw"], CONV["hw"])
    else:
        shape = (N, steps, D)
    return rng.standard_normal(shape).astype(np.float32)


def _wrap(nn, d, kind, wrapper):
    cell = CELLS[kind](nn, d)
    if wrapper == "step":
        return cell
    if wrapper == "recurrent":
        return nn.Recurrent(cell, **d)
    return nn.BiRecurrent(cell, merge_mode=wrapper.split("_")[1], **d)


WRAPPERS = ("step", "recurrent", "birecurrent_add", "birecurrent_concat")
# every wrapper over each class; the variants (an activation, no peepholes,
# even kernels) under Recurrent
CASES = [(k, w) for k in sorted(CELLS) for w in WRAPPERS if "_" not in k or w == "recurrent"]


@pytest.mark.parametrize("kind,wrapper", CASES)
def test_cell_matches_jax(kind, wrapper):
    x = _sequence(kind)
    if wrapper == "step":
        x = x[:, 0]
    check_pair(_wrap(jnn, {}, kind, wrapper), _wrap(pnn, {"device": "cpu"}, kind, wrapper), x,
               atol=1e-5, rtol=0.0, jit=True)


DECODED = {
    "LSTM": lambda nn, d: nn.LSTM(H, H, **d),
    "LSTMPeephole": lambda nn, d: nn.LSTMPeephole(H, H, **d),
    "GRU": lambda nn, d: nn.GRU(H, H, **d),
    "RnnCell": lambda nn, d: nn.RnnCell(H, H, **d),
    "ConvLSTMPeephole": lambda nn, d: nn.ConvLSTMPeephole(CONV["out"], CONV["out"], 3, 2, **d),
}


@pytest.mark.parametrize("kind", sorted(DECODED))
def test_recurrent_decoder_matches_jax(kind):
    rng = np.random.default_rng(2)
    shape = ((CONV["n"], CONV["out"], CONV["hw"], CONV["hw"]) if kind.startswith("ConvLSTM")
             else (N, H))
    x = rng.standard_normal(shape).astype(np.float32)
    ys = check_pair(jnn.RecurrentDecoder(7, DECODED[kind](jnn, {})),
                    pnn.RecurrentDecoder(7, DECODED[kind](pnn, {"device": "cpu"}),
                                         device="cpu"), x, atol=1e-5, rtol=0.0, jit=True)
    assert tuple(ys[0].shape) == (shape[0], 7) + shape[1:]


def test_cell_errors_and_hooks():
    with pytest.raises(ValueError, match="stride 1"):
        pnn.ConvLSTMPeephole(2, 3, stride=2, device="cpu")
    cell = pnn.ConvLSTMPeephole(2, 3, device="cpu")
    with pytest.raises(ValueError, match="build before init_carry"):
        cell.init_carry(2, "cpu")
    cell.init(sample_input=np.zeros((2, 2, 5, 7), np.float32))
    h, c = cell.init_carry(4, "cpu")
    assert tuple(h.shape) == tuple(c.shape) == (4, 3, 5, 7)  # the built sample's plane
    with pytest.raises(ValueError, match="declared input_size"):
        pnn.GRU(D + 1, H, device="cpu").init(sample_input=np.zeros((2, D), np.float32))
    with pytest.raises(ValueError, match="exactly one Cell"):
        pnn.RecurrentDecoder(3, pnn.GRU(H, H, device="cpu"), device="cpu").add(
            pnn.GRU(H, H, device="cpu"))
    with pytest.raises(TypeError, match="needs a Cell"):
        pnn.RecurrentDecoder(3, pnn.Linear(H, H, device="cpu"), device="cpu")
    # LSTMPeephole inherits LSTM's regularizer hooks (peep is not penalised)
    import bigdl_tpu.optim.regularizer as jreg

    from bigdl_tpu_torch.optim import regularizer as preg

    def peephole(nn, r, d):
        return nn.LSTMPeephole(D, H, w_regularizer=r.L2Regularizer(0.1),
                               u_regularizer=r.L1Regularizer(0.02), **d)

    jm = peephole(jnn, jreg, {})
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=np.zeros((N, D), np.float32))
    pm = peephole(pnn, preg, {"device": "cpu"})
    pm.init(sample_input=np.zeros((N, D), np.float32))
    load_jax_params(pm, np_tree(jp))
    np.testing.assert_allclose(pm.regularization_loss_tree(pm.get_parameters()).item(),
                               float(jm.regularization_loss_tree(jp)), rtol=1e-6)


def test_gru_bf16_policy_matches_jax():
    """bf16 compute and activations: the projected input is bf16 in both,
    the carry and the outputs fp32 (the fp32 biases promote the gates)."""
    x = _sequence("GRU", seed=3)
    jm, pm = jnn.Recurrent(jnn.GRU(D, H)), pnn.Recurrent(pnn.GRU(D, H, device="cpu"),
                                                         device="cpu")
    jp, js = jm.init(jax.random.PRNGKey(4), sample_input=x)
    pm.init(sample_input=x)
    load_jax_params(pm, np_tree(jp))
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    for engine in (JEngine, Engine):
        engine.set_compute_dtype("bfloat16")
        engine.set_activation_dtype("bfloat16")
    try:
        jy = jm.apply(jp, js, jnp.asarray(x))[0]
        py = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x))[0]
        cell = pm.cell
        u = cell.project(pm.get_parameters()["GRU_0"], torch.from_numpy(x))
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
        Engine.set_activation_dtype(None)
    assert u.dtype == torch.bfloat16 and py.dtype == torch.float32 and jy.dtype == jnp.float32
    want, got = np.asarray(jy), py.detach().numpy()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def _gru_classifier(nn, d):
    return nn.Sequential(nn.LookupTable(100, 16, **d), nn.Recurrent(nn.GRU(16, 24, **d), **d),
                         nn.Select(2, -1, **d), nn.Linear(24, 20, **d), nn.LogSoftMax(**d), **d)


def test_gru_classifier_trains_like_jax():
    rng = np.random.default_rng(5)
    x, y = rng.integers(1, 100, (8, 12)).astype(np.int32), rng.integers(0, 20, 8)
    run = sgd_steps(_gru_classifier(jnn, {}), _gru_classifier(pnn, {"device": "cpu"}), x, y,
                    batch=4)
    assert len(run["losses"]) == len(run["jax_losses"]) == 3
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=1e-5)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-5, err_msg=k)
    assert update_distance(run) <= 1e-3
