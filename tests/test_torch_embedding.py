"""The port's ``LookupTable`` against the JAX package's, with the JAX table
carried over: every option's forward and the table's gradient (of a
weighted sum of the output, the weights from numpy with a seed).

Options: 0- and 1-based indices, indices outside the table (clipped, not
raised on), float indices (truncated), ``padding_value`` (its row zero at
init and its lookups masked), ``max_norm`` under two norms (only the
gathered rows renormalised, the table never written) and
``should_scale_grad_by_freq`` (each row's gradient divided by its
frequency in the batch). Tolerance: the forward is a gather (exact) times
at most a renormalising scale (1e-6 relative); gradients sum a few rows in
another order (1e-6 absolute and relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.convert import load_jax_params

V, D = 11, 6
TOL = dict(rtol=1e-6, atol=1e-6)

OPTIONS = {
    "default": {},
    "one-based": dict(one_based_input=True),
    "padding": dict(padding_value=3),
    "padding-one-based": dict(padding_value=3, one_based_input=True),
    "max-norm-l2": dict(max_norm=1.5),
    "max-norm-l1": dict(max_norm=2.0, norm_type=1.0),
    "scale-grad-by-freq": dict(should_scale_grad_by_freq=True),
    "all": dict(padding_value=2, max_norm=1.0, should_scale_grad_by_freq=True,
                one_based_input=True),
}


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)


def _indices(seed, float_ids=False):
    """(4, 9) ids with repeats, every option's padding row, and ids outside
    the table on both sides (and, with ``float_ids``, fractions)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V + 1, (4, 9)).astype(np.int32)
    ids[0, :5] = [-3, 0, V, V + 5, 2]
    ids[1, :4] = [3, 3, 3, 1]
    if float_ids:
        return ids.astype(np.float32) + 0.7
    return ids


def _jax_run(opts, ids, cot):
    m = jnn.LookupTable(V, D, **opts)
    params, _ = m.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)

    def loss(p):
        y, _ = m.apply(p, {}, jnp.asarray(ids))
        return jnp.sum(y * cot)

    y, _ = m.apply(params, {}, jnp.asarray(ids))
    return params, np.asarray(y), np.asarray(jax.grad(loss)(params)["weight"])


def _port_run(opts, ids, cot, params):
    m = pnn.LookupTable(V, D, **opts, device="cpu")
    m.init(sample_input=ids)
    load_jax_params(m, params)
    before = m.weight.detach().clone()
    y = m.forward(ids)
    (y * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(m.weight.detach(), before)  # max_norm never writes the table
    return m, y.detach().numpy(), m.weight.grad.numpy()


@pytest.mark.parametrize("float_ids", [False, True], ids=["int-ids", "float-ids"])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_lookup_table_matches_jax(name, float_ids):
    opts = OPTIONS[name]
    ids = _indices(sorted(OPTIONS).index(name), float_ids)
    cot = np.random.default_rng(99).standard_normal(ids.shape + (D,)).astype(np.float32)
    params, jy, jgrad = _jax_run(opts, ids, cot)
    m, y, grad = _port_run(opts, ids, cot, params)
    assert y.dtype == np.float32 and y.shape == ids.shape + (D,)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(grad, jgrad, **TOL)  # NaN where JAX has NaN, and only there
    if "padding_value" in opts:
        pad = opts["padding_value"] - (1 if opts.get("one_based_input") else 0)
        assert not jy[ids.astype(np.int64) - (1 if opts.get("one_based_input") else 0) == pad].any()
        if "max_norm" in opts:
            # the norm of the all-zero padding row has no derivative at 0: in
            # both packages its gradient is 0 * inf = NaN (ROADMAP Queue 3)
            assert np.isnan(grad[pad]).all() and np.isnan(jgrad[pad]).all()
            assert not np.isnan(np.delete(grad, pad, 0)).any()
        else:
            assert not grad[pad].any()


@pytest.mark.parametrize("name", ["padding", "padding-one-based"])
def test_padding_row_is_zero_at_init(name):
    opts = OPTIONS[name]
    m = pnn.LookupTable(V, D, **opts, device="cpu")
    m.init(sample_input=np.zeros((1, 2), np.int32))
    pad = opts["padding_value"] - (1 if opts.get("one_based_input") else 0)
    assert not m.weight[pad].any() and m.weight.detach().abs().sum() > 0


def test_init_is_standard_normal():
    torch.manual_seed(0)
    m = pnn.LookupTable(400, 50, device="cpu")
    m.init(sample_input=np.zeros((1, 1), np.int32))
    w = m.weight.detach()
    assert abs(w.mean().item()) < 0.02 and abs(w.std().item() - 1) < 0.02


def test_output_stays_fp32_under_the_bf16_policy():
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    m = pnn.LookupTable(V, D, device="cpu")
    m.init(sample_input=np.zeros((2, 3), np.int32))
    assert m.forward(np.ones((2, 3), np.int32)).dtype == torch.float32


def test_regularizer_is_not_ported():
    with pytest.raises(NotImplementedError, match="w_regularizer"):
        pnn.LookupTable(V, D, w_regularizer=object(), device="cpu")
