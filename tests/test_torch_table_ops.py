"""The port's table layers against the JAX package's: every class of
``bigdl_tpu/nn/table_ops.py`` that the port did not have (``Concat`` is
held in ``test_torch_inception.py``, ``CAddTable`` in
``test_torch_layers.py`` and again here) forward and backward
(every input entry's and every parameter's gradient against ``jax.grad``)
on the same seeded numpy tables, weights carried with ``load_jax_params``;
``MapTable``'s one parameter set taking the entries' summed gradient and
threading its child's state; ``PairwiseDistance``'s NaN gradient at
a == b (the JAX package's, kept); 3 ``LocalOptimizer`` SGD steps of a
``ConcatTable -> JoinTable`` classifier through both packages.

Tolerances are ``test_torch_activations.TOL``'s f32 limits, 1e-6 absolute
plus 1e-5 relative (sums of at most 12 products in another order); after
3 SGD steps, losses 1e-5 absolute, every parameter 1e-5 absolute and the
whole update within 1e-3 relative L2, as the BiLSTM's in
``test_torch_recurrent.py`` (a smooth network).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.table import T as PT

from test_torch_activations import _fp32_policy, check_pair, leaves, to_jax  # noqa: F401
from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import sgd_steps, update_distance


def _arrays(*shapes, seed=0, positive=False):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [np.abs(a) + 0.5 for a in out] if positive else out


def _ties(seed=0):
    """Three (4, 5) entries with planted ties between entries 1 and 2 and
    between all three."""
    a, b, c = _arrays((4, 5), (4, 5), (4, 5), seed=seed)
    b[0] = a[0]
    b[1, :2] = c[1, :2] = a[1, :2]
    return [a, b, c]


TABLES = {
    "ConcatTable": (lambda nn, d: nn.ConcatTable(nn.Linear(5, 3, **d), nn.Tanh(**d), **d),
                    lambda: _arrays((4, 5))[0]),
    "ConcatTable_JoinTable": (
        lambda nn, d: nn.Sequential(nn.ConcatTable(nn.Linear(5, 3, **d), nn.Linear(5, 2, **d),
                                                   **d), nn.JoinTable(2, **d), **d),
        lambda: _arrays((4, 5))[0]),
    "ParallelTable": (lambda nn, d: nn.ParallelTable(nn.Linear(5, 3, **d), nn.Linear(4, 3, **d),
                                                     **d),
                      lambda: _arrays((4, 5), (4, 4))),
    "MapTable": (lambda nn, d: nn.MapTable(nn.Linear(5, 3, **d), **d),
                 lambda: _arrays((4, 5), (4, 5), (4, 5))),
    "JoinTable": (lambda nn, d: nn.JoinTable(2, **d), lambda: _arrays((4, 3), (4, 5))),
    "JoinTable_batch": (lambda nn, d: nn.JoinTable(1, **d), lambda: _arrays((4, 3), (2, 3))),
    "JoinTable_n_input_dims": (lambda nn, d: nn.JoinTable(1, n_input_dims=1, **d),
                               lambda: _arrays((4, 3), (4, 5))),
    "CAddTable": (lambda nn, d: nn.CAddTable(**d), _ties),
    "CSubTable": (lambda nn, d: nn.CSubTable(**d), lambda: _arrays((4, 5), (4, 5))),
    "CMulTable": (lambda nn, d: nn.CMulTable(**d), _ties),
    "CDivTable": (lambda nn, d: nn.CDivTable(**d),
                  lambda: [_arrays((4, 5))[0], _arrays((4, 5), seed=1, positive=True)[0]]),
    "CMaxTable": (lambda nn, d: nn.CMaxTable(**d), _ties),
    "CMinTable": (lambda nn, d: nn.CMinTable(**d), _ties),
    "CAveTable": (lambda nn, d: nn.CAveTable(**d), _ties),
    "SelectTable": (lambda nn, d: nn.SelectTable(2, **d), _ties),
    "SelectTable_last": (lambda nn, d: nn.SelectTable(-1, **d), _ties),
    "FlattenTable": (lambda nn, d: nn.FlattenTable(**d),
                     lambda: (lambda a: [a[0], [a[1], [a[2]]]])(_arrays((4, 5), (4, 2), (4, 3)))),
    "MixtureTable": (lambda nn, d: nn.MixtureTable(**d),
                     lambda: (lambda a: [a[0], a[1:]])(_arrays((4, 3), (4, 5), (4, 5), (4, 5)))),
    "DotProduct": (lambda nn, d: nn.DotProduct(**d), lambda: _arrays((4, 5), (4, 5))),
    "CosineDistance": (lambda nn, d: nn.CosineDistance(**d), lambda: _arrays((4, 5), (4, 5))),
    "PairwiseDistance_1": (lambda nn, d: nn.PairwiseDistance(1, **d),
                           lambda: _arrays((4, 5), (4, 5))),
    "PairwiseDistance_2": (lambda nn, d: nn.PairwiseDistance(**d),
                           lambda: _arrays((4, 5), (4, 5))),
    "PairwiseDistance_3": (lambda nn, d: nn.PairwiseDistance(3, **d),
                           lambda: _arrays((4, 5), (4, 5))),
    "MM": (lambda nn, d: nn.MM(**d), lambda: _arrays((2, 3, 4), (2, 4, 5))),
    "MM_trans": (lambda nn, d: nn.MM(True, True, **d), lambda: _arrays((2, 4, 3), (2, 5, 4))),
    "MM_2d": (lambda nn, d: nn.MM(False, True, **d), lambda: _arrays((3, 4), (5, 4))),
    "MV": (lambda nn, d: nn.MV(**d), lambda: _arrays((2, 3, 4), (2, 4))),
    "MV_trans": (lambda nn, d: nn.MV(True, **d), lambda: _arrays((2, 4, 3), (2, 4))),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_layer_matches_jax(name):
    make, data = TABLES[name]
    check_pair(make(jnn, {}), make(pnn, {"device": "cpu"}), data())


def test_table_layers_take_lists_and_tuples():
    """A list or a tuple is a table, as in the JAX package."""
    a, b = _arrays((4, 5), (4, 5))
    want = pnn.CosineDistance(device="cpu").apply({}, {}, PT(torch.from_numpy(a),
                                                             torch.from_numpy(b)))[0]
    for table in ([torch.from_numpy(a), torch.from_numpy(b)],
                  (torch.from_numpy(a), torch.from_numpy(b))):
        got = pnn.CosineDistance(device="cpu").apply({}, {}, table)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_map_table_sums_the_entries_gradients_into_one_parameter_set():
    xs = _arrays((4, 5), (4, 5), (4, 5), seed=3)
    m = pnn.MapTable(pnn.Linear(5, 3, device="cpu"), device="cpu")
    m.init(sample_input=PT(*[torch.from_numpy(x) for x in xs]))
    assert [k for k, _ in m.named_parameters()] == ["Linear_0.weight", "Linear_0.bias"]
    ys = m.apply(m.get_parameters(), m.get_state(), PT(*[torch.from_numpy(x) for x in xs]))[0]
    sum(y.sum() for y in ys).backward()
    lin = m[0]
    want_w = sum(np.ones((4, 3), np.float32).T @ x for x in xs)
    np.testing.assert_allclose(lin.weight.grad.numpy(), want_w, rtol=1e-6)
    np.testing.assert_allclose(lin.bias.grad.numpy(), np.full(3, 12.0, np.float32))


def test_map_table_threads_the_child_state_through_the_entries():
    """A BatchNormalization child in training: the running statistics after
    the three entries are the JAX package's (each entry updates them once,
    in order), and so are the outputs."""
    xs = _arrays((6, 5), (6, 5), (6, 5), seed=4)
    jm, pm = jnn.MapTable(jnn.BatchNormalization(5)), pnn.MapTable(
        pnn.BatchNormalization(5, device="cpu"), device="cpu")
    jx = to_jax(xs)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=jx)
    pm.init(sample_input=PT(*[torch.from_numpy(x) for x in xs]))
    load_jax_params(pm, np_tree(jp))
    jy, jstate = jm.apply(jp, js, jx, training=True)
    py, pstate = pm.apply(pm.get_parameters(), pm.get_state(),
                          PT(*[torch.from_numpy(x) for x in xs]), training=True)
    for a, b in zip(leaves(py), leaves(jy)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    want, got = flat(np_tree(jstate)), flat(pstate)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_pairwise_distance_gradient_at_equal_rows_is_nan_as_in_jax():
    a = np.random.default_rng(5).standard_normal((2, 4)).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jnn.PairwiseDistance().apply({}, {}, to_jax([v, a]))[0]))(
        jnp.asarray(a))
    x = torch.from_numpy(a.copy()).requires_grad_(True)
    pnn.PairwiseDistance(device="cpu").apply({}, {}, PT(x, torch.from_numpy(a)))[0].sum() \
        .backward()
    assert np.isnan(np.asarray(jg)).all() and torch.isnan(x.grad).all()


def test_join_and_elementwise_table_errors():
    with pytest.raises(ValueError, match="cannot concatenate along dim 2"):
        pnn.JoinTable(2, device="cpu").init(sample_input=_arrays((4, 3), (5, 3)))
    with pytest.raises(ValueError, match="does not broadcast"):
        pnn.CAddTable(device="cpu").init(sample_input=_arrays((4, 3), (4, 5)))
    with pytest.raises(ValueError, match="2 branches but 3 inputs"):
        pnn.ParallelTable(pnn.Linear(5, 3, device="cpu"), pnn.Linear(5, 3, device="cpu"),
                          device="cpu").init(sample_input=_arrays((4, 5), (4, 5), (4, 5)))


def _two_branch(nn, d):
    return nn.Sequential(
        nn.ConcatTable(nn.Linear(8, 6, **d), nn.Sequential(nn.Linear(8, 6, **d), nn.Tanh(**d),
                                                           **d), **d),
        nn.JoinTable(2, **d), nn.Linear(12, 4, **d), nn.LogSoftMax(**d), **d)


def test_concat_join_classifier_trains_like_jax():
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal((16, 8)).astype(np.float32), rng.integers(0, 4, 16)
    run = sgd_steps(_two_branch(jnn, {}), _two_branch(pnn, {"device": "cpu"}), x, y, batch=8)
    assert len(run["losses"]) == len(run["jax_losses"]) == 3
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=1e-5)
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=1e-5, err_msg=k)
    assert update_distance(run) <= 1e-3


def test_loading_jax_weights_still_checks_paths_and_shapes():
    """The nested trees of the new containers and cells go through
    ``load_jax_params`` unchanged, and a missing key, an extra key or a
    shape mismatch still raises before anything is copied."""
    xs = _arrays((4, 5), (4, 5))
    jm = jnn.MapTable(jnn.Linear(5, 3))
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=to_jax(xs))
    pm = pnn.MapTable(pnn.Linear(5, 3, device="cpu"), device="cpu")
    pm.init(sample_input=PT(*[torch.from_numpy(x) for x in xs]))
    tree = np_tree(jp)
    before = pm[0].weight.detach().clone()
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, {"Linear_0": {"weight": tree["Linear_0"]["weight"]}})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(pm, {"Linear_0": {**tree["Linear_0"], "peep": np.zeros(3)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(pm, {"Linear_0": {**tree["Linear_0"], "bias": np.zeros(4)}})
    assert torch.equal(pm[0].weight.detach(), before)
    cell = pnn.ConvLSTMPeephole(2, 3, 3, 2, device="cpu")
    cell.init(sample_input=np.zeros((1, 2, 5, 5), np.float32))
    assert {k: tuple(v.shape) for k, v in cell.named_parameters()} == {
        "i2g": (12, 2, 3, 3), "h2g": (12, 3, 2, 2), "bias": (12,), "peep": (3, 3)}
