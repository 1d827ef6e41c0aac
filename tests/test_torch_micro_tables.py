"""Micro-batches on ``Table`` batches: the port's ``LocalOptimizer`` with
``set_micro_batches(n)`` against the JAX package's, whose step splits every
leaf of the input and the target (``tree_map(_split, ...)``).

* A two-input ``Graph`` whose ``Linear`` sits at both input nodes (one
  parameter set, its gradient summed over the sites), a ``CAddTable``, a
  ``BatchNormalization`` (its running statistics carried from slice to
  slice: ghost batch norm), and two heads, the second wrapped in a
  ``Table`` of its own, trained under a ``ParallelCriterion`` nested the
  same way on a nested ``Table`` target ``T(y1, T(y2))``: 2 epochs of 3
  batches of 8, at micro 1, 2 and 4.
* The same two inputs without BN into one ``ClassNLLCriterion`` head, 20
  records at batch 8: the 4-row epoch tail padded to 8 and masked out of
  the loss (micro-batch m holds ``clip(nvalid - m*mb, 0, mb)`` real rows
  and weighs by them), at micro 2 and 4.
* A leaf whose length the micro count does not divide: ``ValueError`` with
  the JAX message, in both packages.
* A Wide&Deep ``Table`` (a ``SparseTensor`` column beside a dense one):
  the JAX step cuts the sparse column's COO arrays by entry count and its
  forward then raises ``TypeError`` on rows that no longer match; where the
  entry count is not divisible it raises the ``ValueError`` above. The port
  raises the same types, naming the sparse leaf, and never splits entries.

f32 on the CPU, the JAX model's weights and BN state carried over, the same
batches in both packages. Tolerance 1e-5 absolute and relative on each
step's loss, the final parameters and the BN state: the same f32 sums in
another order (the optimizer-features tests' bound).
"""

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.criteo import load_criteo as jload_criteo
from bigdl_tpu.dataset.dataset import AbstractDataSet as JAbstractDataSet
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.models import WideAndDeep as JWideAndDeep
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import AbstractDataSet, DataSet, MiniBatch, load_criteo
from bigdl_tpu_torch.models import WideAndDeep
from bigdl_tpu_torch.optim.local_optimizer import split_micro_batches
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
from bigdl_tpu_torch.utils.table import T

from test_torch_conv_bn import flat, np_tree
from test_torch_validation import _RecordingJax

TOL = 1e-5
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    """The JAX optimizer here runs on one device (see test_torch_training.py)."""
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


def two_input(nn, d, bn: bool):
    """Table(a, b) -> the shared Linear at both -> add -> [BN] -> ReLU ->
    with ``bn`` two heads, Table(log p1, Table(log p2)); else one head."""
    a, b = nn.Input(), nn.Input()
    shared = nn.Linear(6, 8, **d)
    h = nn.CAddTable(**d).inputs(shared.inputs(a), shared.inputs(b))
    if bn:
        h = nn.BatchNormalization(8, **d).inputs(h)
    h = nn.ReLU(**d).inputs(h)
    head1 = nn.LogSoftMax(**d).inputs(nn.Linear(8, 3, **d).inputs(h))
    if not bn:
        return nn.Graph([a, b], [head1], **d)
    head2 = nn.LogSoftMax(**d).inputs(nn.Linear(8, 2, **d).inputs(h))
    wrapped = nn.ConcatTable(**d).add(nn.Identity(**d)).inputs(head2)
    return nn.Graph([a, b], [head1, wrapped], **d)


def _criterion(nn, bn: bool):
    if not bn:
        return nn.ClassNLLCriterion()
    inner = nn.ParallelCriterion().add(nn.ClassNLLCriterion())
    return nn.ParallelCriterion().add(nn.ClassNLLCriterion()).add(inner, 0.5)


def _records(n, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 6)).astype(np.float32),
            r.standard_normal((n, 6)).astype(np.float32),
            r.integers(0, 3, n), r.integers(0, 2, n))


def _batches(n, batch, seed, bn, table, mini):
    """The epoch's batches in order (the last one short when ``batch``
    does not divide ``n``): Table(a, b) inputs; the nested Table target
    with ``bn``, else y1."""
    xa, xb, y1, y2 = _records(n, seed)
    out = []
    for s in range(0, n, batch):
        sl = slice(s, s + batch)
        t = table(y1[sl], table(y2[sl])) if bn else y1[sl]
        out.append(mini(table(xa[sl], xb[sl]), t))
    return out


class _Fixed(AbstractDataSet):
    def __init__(self, batches):
        self._b = batches

    def size(self):
        return sum(b.size() for b in self._b)

    def data(self, train):
        return iter(self._b)


class _JFixed(JAbstractDataSet):
    def __init__(self, batches):
        self._b = batches

    def size(self):
        return sum(b.size() for b in self._b)

    def data(self, train):
        return iter(self._b)


def _run_both(bn, micro, n=24, epochs=2, jax_side=True):
    sample = _records(8, 0)
    jm = two_input(jnn, {}, bn)
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=JT(sample[0], sample[1]))
    pm = two_input(pnn, {"device": "cpu"}, bn)
    pm.init(sample_input=T(torch.from_numpy(sample[0]), torch.from_numpy(sample[1])))
    load_jax_params(pm, np_tree(jp))
    load_jax_state(pm, np_tree(js))
    JRandom.set_seed(SEED)
    jopt = _RecordingJax(jm, _JFixed(_batches(n, 8, 5, bn, JT, JMiniBatch)), _criterion(jnn, bn))
    jopt.set_optim_method(joptim.SGD(learningrate=0.2, momentum=0.9))
    if jax_side:
        jopt.set_micro_batches(micro).set_end_when(joptim.Trigger.max_epoch(epochs)).optimize()
    RandomGenerator.set_seed(SEED)
    popt = poptim.LocalOptimizer(pm, _Fixed(_batches(n, 8, 5, bn, T, MiniBatch)),
                                 _criterion(pnn, bn))
    popt.set_optim_method(poptim.SGD(learningrate=0.2, momentum=0.9))
    popt.set_micro_batches(micro).set_end_when(poptim.Trigger.max_epoch(epochs)).optimize()
    return jopt, popt, jm, pm


def _assert_same_training(jopt, popt, jm, pm):
    np.testing.assert_allclose([h["loss"] for h in popt.history], jopt.losses, atol=TOL,
                               rtol=TOL)
    assert popt.optim_method.state["neval"] == jopt.optim_method.state["neval"]
    for got, want in ((flat(pm.get_parameters()), flat(np_tree(jm.get_parameters()))),
                      (flat(pm.get_state()), flat(np_tree(jm.get_state())))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("micro", [1, 2, 4])
def test_shared_module_bn_and_nested_table_target_match_jax(micro):
    """One update a step from the slices' mean gradient (the shared
    Linear's summed over its two sites), BN advanced ``micro`` times a
    step; ``micro`` 1 is the unsplit step the others are held beside."""
    jopt, popt, jm, pm = _run_both(bn=True, micro=micro)
    assert not popt._mask_ragged and not jopt._mask_ragged  # BN couples the rows
    assert [h["records"] for h in popt.history] == [8] * 6
    _assert_same_training(jopt, popt, jm, pm)


def test_micro_batches_move_the_bn_statistics_otherwise():
    """Ghost batch norm: the statistics after micro 2 are not the unsplit
    run's (the slices' own batch statistics)."""
    pm1, pm2 = _run_both(bn=True, micro=1)[3], _run_both(bn=True, micro=2)[3]
    key = next(k for k in flat(pm1.get_state()) if k.endswith("running_mean"))
    assert not np.allclose(flat(pm1.get_state())[key], flat(pm2.get_state())[key])


@pytest.mark.parametrize("micro", [2, 4])
def test_padded_ragged_tail_of_a_table_batch_matches_jax(micro):
    """20 records at batch 8: the 4-row tail padded to 8 and masked; at
    micro 4 its last slice is all padding and weighs 0."""
    jopt, popt, jm, pm = _run_both(bn=False, micro=micro, n=20, epochs=3)
    assert popt._mask_ragged and jopt._mask_ragged
    assert [h["records"] for h in popt.history] == [8, 8, 4] * 3
    _assert_same_training(jopt, popt, jm, pm)


def test_split_cuts_every_leaf_by_rows():
    x = T(np.arange(8).reshape(8, 1), [np.arange(8), {"k": np.arange(16).reshape(8, 2)}])
    t = T(np.arange(8), T(np.arange(8) * 2))
    parts = split_micro_batches(x, t, 4)
    assert len(parts) == 4
    for i, (xm, tm) in enumerate(parts):
        rows = np.arange(2 * i, 2 * i + 2)
        np.testing.assert_array_equal(xm[1][:, 0], rows)
        np.testing.assert_array_equal(xm[2][0], rows)
        np.testing.assert_array_equal(xm[2][1]["k"][:, 0], 2 * rows)
        np.testing.assert_array_equal(tm[2][1], 2 * rows)


def test_indivisible_table_leaf_raises_like_jax():
    """A batch of 8 at micro 3: the same ValueError and message."""
    for bn in (True, False):
        for jax_side in (True, False):
            with pytest.raises(ValueError) as e:
                _run_both(bn=bn, micro=3, n=8, epochs=1, jax_side=jax_side)
            assert str(e.value) == "batch size 8 not divisible by micro batch count 3"
    x, y = T(np.zeros((6, 2)), np.zeros((9, 2))), np.zeros(6)
    with pytest.raises(ValueError, match="batch size 9 not divisible by micro batch count 2"):
        split_micro_batches(x, y, 2)


def _widedeep_both(micro):
    """One step of Wide&Deep at micro ``micro`` in each package: the
    exception each raises (None when it trains)."""
    (jt, jy), (pt, py) = (f(None, n=16, seed=0) for f in (jload_criteo, load_criteo))
    got = []
    jm = JWideAndDeep(2)
    jm.init(jax.random.PRNGKey(SEED), sample_input=jt)
    pm = WideAndDeep(2, device="cpu")
    pm.init(sample_input=pt)
    jopt = joptim.LocalOptimizer(jm, JDataSet.array(jt, jy, batch_size=8),
                                 jnn.ClassNLLCriterion())
    popt = poptim.LocalOptimizer(pm, DataSet.array(pt, py, batch_size=8),
                                 pnn.ClassNLLCriterion())
    jopt.set_end_when(joptim.Trigger.max_iteration(1))
    popt.set_end_when(poptim.Trigger.max_iteration(1))
    for opt in (jopt, popt):
        opt.set_micro_batches(micro)
        try:
            opt.optimize()
            got.append(None)
        except Exception as e:  # the type each package raises
            got.append(e)
    return got


@pytest.mark.parametrize("micro,kind", [(2, TypeError), (4, TypeError), (3, ValueError)])
def test_sparse_tensor_leaf_raises_like_jax(micro, kind):
    """The JAX step splits the sparse column by its 8 entries: at micro 2
    and 4 its forward fails on the rows (TypeError), at 3 the entry count
    fails the divisibility check. The port raises the same types before
    any forward, naming the SparseTensor leaf where it refuses it."""
    j, p = _widedeep_both(micro)
    assert type(j) is kind and type(p) is kind, (j, p)
    if kind is TypeError:
        assert "SparseTensor at input[1]" in str(p) and "not rows" in str(p)
    else:
        assert str(p) == str(j) == f"batch size 8 not divisible by micro batch count {micro}"
