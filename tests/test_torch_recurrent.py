"""The port's recurrent slice against the JAX package's: ``Select``; one
``LSTM`` step, ``Recurrent(LSTM)`` and ``BiRecurrent(LSTM)`` in both merge
modes (forward, and every gradient against ``jax.grad``); the BiLSTM text
classifier's parameter paths at its full widths, 3 ``LocalOptimizer`` SGD
steps of a narrow one (vocab 100, embedding 16, hidden 24, T 12) and its
bf16 policy node by node, each node's output dtype the JAX node's.

Weights carried over with ``load_jax_params``; inputs from numpy with a
seed, f32 on the CPU. Tolerances, fixed before the first run: ``Select``
exact (a copy of elements); the cell, ``Recurrent`` and ``BiRecurrent``
1e-5 absolute in outputs and gradients (the same f32 products summed in
another order, carried through 9 steps of a contracting recurrence); after
3 SGD steps, losses 1e-5 absolute, every parameter 1e-5 absolute and the
whole update within 1e-3 relative L2 (a smooth network); under the bf16
policy each node fed the JAX node's inputs within 1e-2 relative L2 and
5e-2 of its largest value (the input product is rounded to bf16 once per
element in both, after fp32 sums taken in another order; 12 steps carry it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import BiLSTMClassifier as JBiLSTMClassifier
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.models import BiLSTMClassifier
from bigdl_tpu_torch.utils.convert import load_jax_params

from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import sgd_steps, update_distance

N, T, D, H = 3, 9, 5, 6


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX LocalOptimizer here runs on one device (see test_torch_training.py)."""
    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


# ---------------------------------------------------------------- Select
@pytest.mark.parametrize("dimension,index", [(1, 1), (1, -1), (2, 3), (2, -2), (3, 4),
                                             (-1, 1), (-1, -4), (-2, 2), (-3, -2)])
def test_select_matches_jax(dimension, index):
    x = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(np.float32)
    want = np.asarray(jnn.Select(dimension, index).apply({}, {}, jnp.asarray(x))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    got, _ = pnn.Select(dimension, index, device="cpu").apply({}, {}, xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()  # the selected elements get the gradient, the rest 0
    mask = np.asarray(jax.grad(lambda v: jnn.Select(dimension, index).apply(
        {}, {}, v)[0].sum())(jnp.asarray(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), mask)


# ----------------------------------------------- LSTM, Recurrent, BiRecurrent
def _layers(kind):
    """(JAX layer, port layer) of one kind."""
    if kind == "lstm_step":
        return jnn.LSTM(D, H), pnn.LSTM(D, H, device="cpu")
    if kind == "recurrent":
        return jnn.Recurrent(jnn.LSTM(D, H)), pnn.Recurrent(pnn.LSTM(D, H, device="cpu"),
                                                            device="cpu")
    mode = kind.split("_")[1]
    return (jnn.BiRecurrent(jnn.LSTM(D, H), merge_mode=mode),
            pnn.BiRecurrent(pnn.LSTM(D, H, device="cpu"), merge_mode=mode, device="cpu"))


@pytest.mark.parametrize("kind", ["lstm_step", "recurrent", "birecurrent_add",
                                  "birecurrent_concat"])
def test_recurrent_layers_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, D) if kind == "lstm_step" else (N, T, D)).astype(np.float32)
    jm, pm = _layers(kind)
    jp, js = jm.init(jax.random.PRNGKey(2), sample_input=x)
    pm.init(sample_input=x)
    load_jax_params(pm, np_tree(jp))  # the same paths, no key left over
    jy = jm.apply(jp, js, jnp.asarray(x))[0]
    dy = rng.standard_normal(jy.shape).astype(np.float32)

    def jloss(p, v):
        return jnp.sum(jm.apply(p, js, v)[0] * dy)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    py, _ = pm.apply(pm.get_parameters(), pm.get_state(), xt)
    assert py.dtype == torch.float32 and tuple(py.shape) == jy.shape
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), atol=1e-5)
    (py * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5)
    want = flat(np_tree(jgp))
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_birecurrent_copies_the_cell_under_jax_names():
    """The reverse cell is a deep copy named by its Recurrent, as in JAX;
    the two directions own separate weights."""
    x = np.zeros((2, 4, D), np.float32)
    jm = jnn.BiRecurrent(jnn.LSTM(D, H).set_name("fwd_cell"))
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = pnn.BiRecurrent(pnn.LSTM(D, H, device="cpu").set_name("fwd_cell"), device="cpu")
    pm.init(sample_input=x)
    names = {k for k, _ in pm.named_parameters()}
    assert names == set(flat(np_tree(jp)))
    assert "Recurrent_1.LSTM_0.i2g" in names and "Recurrent_0.fwd_cell.i2g" in names
    fwd, bwd = (r.cell for r in pm)
    assert fwd is not bwd and fwd.i2g.data_ptr() != bwd.i2g.data_ptr()


def test_recurrent_layer_errors():
    # the regularizer arguments, which raised before they were ported, now
    # penalise i2g, h2g and bias as the JAX cell does (1e-6 relative)
    import bigdl_tpu.optim.regularizer as jreg

    from bigdl_tpu_torch.optim import regularizer as preg

    def cell(nn, r, d):
        return nn.LSTM(D, H, w_regularizer=r.L2Regularizer(0.1), u_regularizer=r.L1Regularizer(
            0.02), b_regularizer=r.L1L2Regularizer(0.01, 0.3), **d)

    jm = cell(jnn, jreg, {})
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=np.zeros((N, D), np.float32))
    pm = cell(pnn, preg, {"device": "cpu"})
    pm.init(sample_input=np.zeros((N, D), np.float32))
    load_jax_params(pm, np_tree(jp))
    np.testing.assert_allclose(pm.regularization_loss_tree(pm.get_parameters()).item(),
                               float(jm.regularization_loss_tree(jp)), rtol=1e-6)
    with pytest.raises(ValueError, match="exactly one Cell"):
        pnn.Recurrent(pnn.LSTM(D, H, device="cpu"), device="cpu").add(
            pnn.LSTM(D, H, device="cpu"))
    with pytest.raises(TypeError, match="needs a Cell"):
        pnn.Recurrent(pnn.Linear(D, H, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="merge_mode"):
        pnn.BiRecurrent(pnn.LSTM(D, H, device="cpu"), merge_mode="mul", device="cpu")
    with pytest.raises(ValueError, match="declared input_size"):
        pnn.LSTM(D + 1, H, device="cpu").init(sample_input=np.zeros((2, D), np.float32))


# -------------------------------------------------------- BiLSTM classifier
NARROW = dict(vocab_size=100, embedding_dim=16, hidden_size=24)


def _ids(n, t, vocab, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (n, t)).astype(np.int32), rng.integers(0, 20, n)


def test_bilstm_paths_match_jax_at_full_width():
    """BASELINE config 4's widths: vocab 20001, embedding and hidden 128."""
    x, _ = _ids(2, 5, 20001, 0)
    jm = JBiLSTMClassifier(vocab_size=20001, hidden_size=128)
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm = BiLSTMClassifier(vocab_size=20001, hidden_size=128, device="cpu")
    pm.init(sample_input=x)
    want = {k: v.shape for k, v in flat(np_tree(jp)).items()}
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == want
    assert "bilstm.Recurrent_1.LSTM_0.h2g" in want
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    load_jax_params(pm, np_tree(jp))


@pytest.mark.parametrize("merge_mode", ["concat", "add"])
def test_bilstm_trains_like_jax(merge_mode):
    x, y = _ids(8, 12, NARROW["vocab_size"], 3)
    run = sgd_steps(JBiLSTMClassifier(**NARROW, merge_mode=merge_mode),
                    BiLSTMClassifier(**NARROW, merge_mode=merge_mode, device="cpu"), x, y,
                    batch=4)
    assert len(run["losses"]) == len(run["jax_losses"]) == 3
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=1e-5)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-5, err_msg=k)
    assert update_distance(run) <= 1e-3


def _to_torch(a):
    if jnp.issubdtype(a.dtype, jnp.integer):
        return torch.from_numpy(np.array(a))
    dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)


def test_bilstm_bf16_policy_matches_jax_node_by_node():
    x, _ = _ids(4, 12, NARROW["vocab_size"], 4)
    jm = JBiLSTMClassifier(**NARROW)
    jp, js = jm.init(jax.random.PRNGKey(5), sample_input=x)
    pm = BiLSTMClassifier(**NARROW, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, np_tree(jp))
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    for engine in (JEngine, Engine):
        engine.set_compute_dtype("bfloat16")
        engine.set_activation_dtype("bfloat16")
    try:
        jx, dtypes = jnp.asarray(x), []
        for m, q in zip(jm.modules, pm):
            assert m.name() == q.name()
            jy = m._apply(jp[m.name()], js[m.name()], jx, True, None)[0]
            py = q._apply_params(pm.get_parameters()[q.name()], pm.get_state()[q.name()],
                                 _to_torch(jx), True, None)[0]
            want, got = np.asarray(jy.astype(jnp.float32)), py.detach().float().numpy()
            assert (py.dtype == torch.bfloat16) == (jy.dtype == jnp.bfloat16), m.name()
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want), m.name()
            assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max(), m.name()
            dtypes.append(str(py.dtype))
            jx = jy
        # the carry is fp32 and the fp32 bias promotes the gates: the LSTM's
        # outputs, the merge and the selected step stay fp32; Linear casts back
        assert dtypes == ["torch.float32", "torch.float32", "torch.float32", "torch.bfloat16",
                          "torch.float32"]
        cell, cp = pm[1][0].cell, pm.get_parameters()["bilstm"]["Recurrent_0"]["LSTM_0"]
        (h, c), y = cell.step(cp, cell.init_carry(4, "cpu"),
                              cell.project(cp, torch.zeros(4, NARROW["embedding_dim"])))
        jcell = jm.modules[1].modules[0].cell
        (jh, jc), _ = jcell.step(jp["bilstm"]["Recurrent_0"]["LSTM_0"], jcell.init_carry(4),
                                 jnp.zeros((4, NARROW["embedding_dim"])))
        assert h.dtype == c.dtype == y.dtype == torch.float32
        assert jh.dtype == jc.dtype == jnp.float32
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
        Engine.set_activation_dtype(None)
