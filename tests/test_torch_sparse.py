"""The port's sparse family against the JAX package's: ``SparseTensor``
(``to_dense``, ``dot_dense``, ``from_dense``) and ``sparse_join``;
``SparseLinear`` forward and weight/bias gradients in f32 and under the
bf16 policy; ``LookupTableSparse`` with each combiner, with and without
``max_norm``, with absent ids; ``DenseToSparse -> LookupTableSparse`` and
``SparseJoinTable``; ``load_criteo`` (the synthetic log bit for bit, the
TSV path on a file the test writes, read by both packages in this one
process, since ``hash()`` of a string is salted per process);
``LocalTableDataSet``'s batches and epoch order, and the ``Table`` seams
of ``MiniBatch``, ``pad_minibatch`` and ``to_device``.

Inputs from numpy with a seed, on the CPU. Every COO input repeats some
(row, col) pairs and carries zero-valued padding entries (row 0, col 0,
value 0), as ``LocalTableDataSet``'s fixed-capacity batches do.
Tolerances, fixed before the first run: integer arrays and the data
equal exactly; f32 results 1e-6 absolute + 1e-6 relative (the same f32
products, and sums of at most a few dozen terms in another order); under
the bf16 policy the sparse product stays f32 in both packages (no cast:
the JAX module multiplies in the weight's dtype), so it is held to the
same limit, and its dtype must be float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.criteo import load_criteo as jload_criteo
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import LocalTableDataSet as JLocalTableDataSet
from bigdl_tpu.tensor.sparse import SparseTensor as JSparseTensor
from bigdl_tpu.tensor.sparse import sparse_join as jsparse_join
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import (DataSet, LocalTableDataSet, MiniBatch, load_criteo,
                                     pad_minibatch, to_device)
from bigdl_tpu_torch.tensor import SparseTensor, sparse_join
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.table import T

from test_torch_conv_bn import flat, np_tree

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    yield
    Engine.set_compute_dtype(None)


def coo(n_rows, n_cols, nnz, seed, values="normal", n_pad=3):
    """(rows, cols, values) with repeated (row, col) pairs and ``n_pad``
    zero-valued (0, 0) padding entries at the end; ``values="ids"`` draws
    1-based ids in [0, 13) (0: absent, 12: past an 11-row table) as floats."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    rows[nnz // 2:nnz // 2 + 3], cols[nnz // 2:nnz // 2 + 3] = rows[0], cols[0]  # duplicates
    if values == "ids":
        vals = rng.integers(0, 13, nnz).astype(np.float32)
    else:
        vals = rng.standard_normal(nnz).astype(np.float32)
    pad = np.zeros(n_pad, np.int64)
    return (np.concatenate([rows, pad]), np.concatenate([cols, pad]),
            np.concatenate([vals, np.zeros(n_pad, np.float32)]))


def both(rows, cols, vals, shape):
    return JSparseTensor.from_coo(rows, cols, vals, shape), SparseTensor.from_coo(rows, cols,
                                                                                   vals, shape)


def same_sparse(p, j):
    """The port's SparseTensor equals the JAX one: arrays exactly, shape and dtypes."""
    assert p.shape == j.shape and p.nnz == j.nnz
    assert p.row_indices.dtype == p.col_indices.dtype == torch.int32
    np.testing.assert_array_equal(p.row_indices.numpy(), np.asarray(j.row_indices))
    np.testing.assert_array_equal(p.col_indices.numpy(), np.asarray(j.col_indices))
    np.testing.assert_array_equal(p.values.numpy(), np.asarray(j.values))
    assert p.values.numpy().dtype == np.asarray(j.values).dtype


# ------------------------------------------------------------ SparseTensor
def test_sparse_tensor_ops_match_jax():
    rows, cols, vals = coo(6, 9, 30, 0)
    js, ps = both(rows, cols, vals, (6, 9))
    same_sparse(ps, js)
    np.testing.assert_allclose(ps.to_dense().numpy(), np.asarray(js.to_dense()), **TOL)
    w = np.random.default_rng(1).standard_normal((9, 5)).astype(np.float32)
    np.testing.assert_allclose(ps.dot_dense(torch.from_numpy(w)).numpy(),
                               np.asarray(js.dot_dense(jnp.asarray(w))), **TOL)
    dense = np.where(np.random.default_rng(2).random((4, 7)) < 0.3,
                     np.random.default_rng(3).standard_normal((4, 7)), 0.0)
    same_sparse(SparseTensor.from_dense(dense), JSparseTensor.from_dense(dense))
    moved = ps.to("cpu")
    assert moved.shape == ps.shape and moved.device == torch.device("cpu")


def test_sparse_join_matches_jax():
    parts = [both(*coo(5, w, 12, seed), (5, w)) for seed, w in ((4, 7), (5, 3), (6, 11))]
    j = jsparse_join([p[0] for p in parts])
    p = sparse_join([p[1] for p in parts])
    same_sparse(p, j)
    join = pnn.SparseJoinTable(device="cpu").forward(T(*[p[1] for p in parts]))
    same_sparse(join, jnn.SparseJoinTable().apply({}, {}, [p[0] for p in parts])[0])
    with pytest.raises(ValueError, match="dimension=2"):
        pnn.SparseJoinTable(1, device="cpu")


# ------------------------------------------------------------ SparseLinear
def _sparse_linear_pair(n_in, n_out, x):
    jm = jnn.SparseLinear(n_in, n_out)
    jp, _ = jm.init(jax.random.PRNGKey(0), sample_input=x[0])
    pm = pnn.SparseLinear(n_in, n_out, device="cpu")
    pm.init(sample_input=x[1])
    load_jax_params(pm, np_tree(jp))
    return jm, jp, pm


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_sparse_linear_matches_jax(policy):
    rows, cols, vals = coo(8, 40, 50, 7)
    x = both(rows, cols, vals, (8, 40))
    jm, jp, pm = _sparse_linear_pair(40, 3, x)
    dy = np.random.default_rng(8).standard_normal((8, 3)).astype(np.float32)
    prev = (JEngine._state.compute_dtype, JEngine._state.activation_dtype)
    for engine in (JEngine, Engine):
        engine.set_compute_dtype(policy)
        engine.set_activation_dtype(None if policy == "float32" else policy)
    try:
        jy, vjp = jax.vjp(lambda p: jm.apply(p, {}, x[0])[0], jp)
        (jg,) = vjp(jnp.asarray(dy))
        params = pm.get_parameters()
        py, _ = pm.apply(params, {}, x[1])
        grads = torch.autograd.grad(py, [params["weight"], params["bias"]], torch.from_numpy(dy))
    finally:
        JEngine._state.compute_dtype, JEngine._state.activation_dtype = prev
        Engine.set_activation_dtype(None)
    assert jy.dtype == jnp.float32 and py.dtype == torch.float32  # no cast under bf16
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **TOL)
    for got, key in zip(grads, ("weight", "bias")):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg[key]), **TOL, err_msg=key)


def test_sparse_linear_takes_a_dense_input_as_linear():
    x = np.random.default_rng(9).standard_normal((4, 6)).astype(np.float32)
    jm = jnn.SparseLinear(6, 2)
    jp, _ = jm.init(jax.random.PRNGKey(1), sample_input=x)
    pm = pnn.SparseLinear(6, 2, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, np_tree(jp))
    np.testing.assert_allclose(pm.forward(x).detach().numpy(),
                               np.asarray(jm.apply(jp, {}, jnp.asarray(x))[0]), **TOL)


# ------------------------------------------------------ LookupTableSparse
def _lookup_pair(x, **opts):
    jm = jnn.LookupTableSparse(11, 4, **opts)
    jp, _ = jm.init(jax.random.PRNGKey(2), sample_input=x[0])
    pm = pnn.LookupTableSparse(11, 4, **opts, device="cpu")
    pm.init(sample_input=x[1])
    load_jax_params(pm, np_tree(jp))
    return jm, jp, pm


def _hold_forward_and_grad(jm, jp, pm, jx, px, n_rows):
    dy = np.random.default_rng(10).standard_normal((n_rows, 4)).astype(np.float32)
    jy, vjp = jax.vjp(lambda p: jm.apply(p, {}, jx)[0], jp)
    (jg,) = vjp(jnp.asarray(dy))
    w = pm.get_parameters()["weight"]
    py, _ = pm.apply(pm.get_parameters(), {}, px)
    (g,) = torch.autograd.grad(py, [w], torch.from_numpy(dy))
    assert py.dtype == torch.float32
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["weight"]), **TOL)
    return py.detach().numpy()


@pytest.mark.parametrize("max_norm", [None, 1.0], ids=["no_max_norm", "max_norm"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_lookup_table_sparse_matches_jax(combiner, max_norm):
    # ids in [0, 13): 0 is absent, 12 is past the table's 11 rows and clamps
    # to the last; row 5 holds only absent ids
    rows, cols, vals = coo(6, 4, 30, 11, values="ids")
    vals[rows == 5] = 0.0
    x = both(rows, cols, vals, (6, 4))
    jm, jp, pm = _lookup_pair(x, combiner=combiner, max_norm=max_norm)
    y = _hold_forward_and_grad(jm, jp, pm, x[0], x[1], 6)
    assert not y[5].any()  # a row of absent ids embeds to 0, also under mean/sqrtn


def test_dense_to_sparse_feeds_lookup_table_sparse():
    ids = np.random.default_rng(12).integers(0, 13, (5, 3)).astype(np.float32)
    ids[1] = 0  # a record with no ids
    js = jnn.DenseToSparse().apply({}, {}, jnp.asarray(ids))[0]
    ps = pnn.DenseToSparse(device="cpu").forward(ids)
    same_sparse(ps, js)
    assert ps.nnz == ids.size  # the fixed capacity, zeros kept
    jm, jp, pm = _lookup_pair((js, ps), combiner="mean")
    _hold_forward_and_grad(jm, jp, pm, js, ps, 5)


def test_lookup_table_sparse_errors():
    with pytest.raises(ValueError, match="combiner"):
        pnn.LookupTableSparse(3, 2, combiner="max", device="cpu")
    with pytest.raises(ValueError, match="SparseTensor"):
        pnn.LookupTableSparse(3, 2, device="cpu").init(sample_input=np.zeros((2, 2), np.float32))


# ----------------------------------------------------------- load_criteo
@pytest.mark.parametrize("n,wide_dim,vocab", [(1, 5000, 100), (37, 5000, 100), (64, 300, 7)])
def test_load_criteo_synthetic_matches_jax_bit_for_bit(n, wide_dim, vocab):
    jt, jy = jload_criteo(None, n=n, wide_dim=wide_dim, embed_vocab=vocab, seed=4)
    pt, py = load_criteo(None, n=n, wide_dim=wide_dim, embed_vocab=vocab, seed=4)
    same_sparse(pt[1], jt[1])
    assert pt[2].dtype == jt[2].dtype == np.float32 and py.dtype == jy.dtype == np.int64
    np.testing.assert_array_equal(pt[2], jt[2])
    np.testing.assert_array_equal(py, jy)


def test_load_criteo_tsv_matches_jax_in_one_process(tmp_path):
    rng = np.random.default_rng(13)
    lines = []
    for i in range(7):
        numeric = [("" if rng.random() < 0.2 else f"{rng.integers(-3, 500)}") for _ in range(13)]
        cats = [("" if rng.random() < 0.1 else f"{rng.integers(0, 1 << 32):08x}")
                for _ in range(26)]
        lines.append("\t".join([str(i % 2)] + numeric + cats))
    path = tmp_path / "day_0.tsv"
    path.write_text("\n".join(lines) + "\n")
    jt, jy = jload_criteo(str(path), n=5, wide_dim=997, embed_vocab=31)
    pt, py = load_criteo(str(path), n=5, wide_dim=997, embed_vocab=31)
    same_sparse(pt[1], jt[1])
    assert pt[1].nnz == 5 * 26
    np.testing.assert_array_equal(pt[2], jt[2])
    np.testing.assert_array_equal(py, jy)


# ----------------------------------------------------- LocalTableDataSet
def _table_columns(n, seed=14):
    """A ragged sparse column (0 to 3 entries a record, some records none),
    a dense matrix and a dense vector."""
    rng = np.random.default_rng(seed)
    per_row = rng.integers(0, 4, n)
    rows = np.repeat(np.arange(n), per_row)
    order = rng.permutation(len(rows))  # the COO arrives unsorted
    cols = rng.integers(0, 20, len(rows))
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    dense = rng.standard_normal((n, 3)).astype(np.float32)
    vec = rng.integers(0, 5, n).astype(np.int32)
    labels = rng.integers(0, 2, n)
    return (rows[order], cols[order], vals[order]), dense, vec, labels


@pytest.mark.parametrize("epoch", [None, 0, 3], ids=["unshuffled", "epoch0", "epoch3"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_local_table_dataset_matches_jax(train, epoch):
    (rows, cols, vals), dense, vec, labels = _table_columns(23)
    jds = JDataSet.array(JT(JSparseTensor.from_coo(rows, cols, vals, (23, 20)), dense, vec),
                         labels, batch_size=5)
    pds = DataSet.array(T(SparseTensor.from_coo(rows, cols, vals, (23, 20)), dense, vec), labels,
                        batch_size=5)
    assert isinstance(jds, JLocalTableDataSet) and isinstance(pds, LocalTableDataSet)
    assert pds.size() == jds.size() == 23
    if epoch is not None:
        JRandom.set_seed(21)
        RandomGenerator.set_seed(21)
        jds.shuffle(epoch)
        pds.shuffle(epoch)
    jb, pb = list(jds.data(train=train)), list(pds.data(train=train))
    assert len(pb) == len(jb) == (4 if train else 5)
    for j, p in zip(jb, pb):
        assert p.size() == j.size()
        same_sparse(p.get_input()[1], j.get_input()[1])
        assert p.get_input()[1].nnz == p.size() * 3  # the fixed capacity
        for k in (2, 3):
            np.testing.assert_array_equal(p.get_input()[k], j.get_input()[k])
        np.testing.assert_array_equal(p.get_target(), j.get_target())


def test_table_batches_are_never_row_padded():
    """A short Table batch holding a SparseTensor cannot be padded (the
    JAX package pads its COO arrays as if they were rows); one of dense
    columns only pads each column."""
    (rows, cols, vals), dense, vec, labels = _table_columns(6)
    sparse = SparseTensor.from_coo(rows, cols, vals, (6, 20))
    batch = MiniBatch(T(sparse, dense), labels)
    assert batch.size() == 6
    assert pad_minibatch(batch, 8) is None
    padded, n = pad_minibatch(MiniBatch(T(dense, vec), labels), 8)
    assert n == 6 and padded.size() == 8
    np.testing.assert_array_equal(padded.get_input()[1][6:], np.stack([dense[0]] * 2))
    np.testing.assert_array_equal(padded.get_input()[2][6:], [vec[0]] * 2)
    moved = to_device(T(sparse, dense), torch.device("cpu"))
    assert isinstance(moved[1], SparseTensor) and isinstance(moved[2], torch.Tensor)
    same_sparse(moved[1], JSparseTensor.from_coo(rows, cols, vals, (6, 20)))
    with pytest.raises(TypeError, match="Table"):
        LocalTableDataSet(dense, labels)
    with pytest.raises(ValueError, match="row count"):
        LocalTableDataSet(T(sparse, dense[:5]), labels)
