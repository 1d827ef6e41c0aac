"""The port's convolution and batch normalization against the JAX package's,
with the JAX module's parameters and state carried over: outputs, new state,
and the gradients of the input and of every parameter (``jax.vjp`` against
torch autograd, with one numpy-made cotangent). Also the repair that keeps a
train-mode forward's new BN state free of autograd history.

Inputs from numpy with a seed, f32 on the CPU. Tolerances: 1e-5 absolute
and relative in f32 (the same products summed in another order, at most a
few hundred terms per output); the bf16 BN fold path 1e-2 (x is bf16 and the
fp32 scale/shift are rounded to bf16 before they are applied, so one bf16
step of the output, 2^-8 relative, plus the input's own steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def run_pair(jm, pm, x, training, seed=0):
    """Build both modules on ``x`` (the port's from the JAX module's params
    and state), run forward and backward with one cotangent; returns
    ``(jax, port)`` dicts of y, state, dx and the parameter gradients."""
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm.init(sample_input=torch.from_numpy(np.array(x)))
    load_jax_params(pm, np_tree(jp))
    load_jax_state(pm, np_tree(js))

    def f(p, v):
        return jm.apply(p, js, v, training=training, rng=None)

    jy, vjp, jns = jax.vjp(f, jp, jnp.asarray(x), has_aux=True)
    dy = np.random.default_rng(seed + 100).standard_normal(jy.shape).astype(np.float32)
    jgp, jdx = vjp(jnp.asarray(dy, jy.dtype))

    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    py, pns = pm.apply(pm.get_parameters(), pm.get_state(), xt, training=training)
    names = [k for k, _ in pm.named_parameters()]
    grads = torch.autograd.grad(py, [xt] + [p for _, p in pm.named_parameters()],
                                torch.from_numpy(dy).to(py.dtype))
    jax_side = dict(y=np.asarray(jy, np.float32), state=flat(np_tree(jns)),
                    dx=np.asarray(jdx, np.float32), dparams=flat(np_tree(jgp)))
    port_side = dict(y=py.detach().float().numpy(), state=flat(pns),
                     dx=grads[0].float().numpy(),
                     dparams={n: g.numpy() for n, g in zip(names, grads[1:])})
    return jax_side, port_side


def assert_pair(j, p, atol=ATOL, rtol=RTOL):
    assert p["y"].shape == j["y"].shape
    np.testing.assert_allclose(p["y"], j["y"], atol=atol, rtol=rtol)
    np.testing.assert_allclose(p["dx"], j["dx"], atol=atol, rtol=rtol)
    assert set(p["state"]) == set(j["state"]) and set(p["dparams"]) == set(j["dparams"])
    for k in j["state"]:
        np.testing.assert_allclose(p["state"][k], j["state"][k], atol=atol, rtol=rtol, err_msg=k)
    for k in j["dparams"]:
        np.testing.assert_allclose(p["dparams"][k], j["dparams"][k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("args,kw,shape", [
    ((4, 6, 3, 3, 1, 1, 1, 1), {}, (2, 4, 9, 8)),                         # padding, bias
    ((4, 6, 3, 3, 2, 2, -1, -1), {}, (2, 4, 9, 8)),                       # SAME, odd cell high
    ((4, 6, 2, 3, 2, 1, 0, 1), dict(n_group=2, with_bias=False), (2, 4, 9, 8)),  # groups
    ((12, 8, 5, 5, 1, 1, 2, 2), dict(with_bias=False), (2, 12, 8, 8)),   # the s2d stem conv
    ((4, 6, 3, 3, 1, 1, 1, 1), dict(activation="relu"), (2, 4, 7, 7)),
    ((4, 6, 1, 1), dict(activation="tanh"), (2, 4, 7, 7)),
    ((4, 6, 3, 3, 1, 1, 0, 0), dict(activation="gelu"), (2, 4, 7, 7)),
])
def test_spatial_convolution_matches_jax(args, kw, shape):
    j, p = run_pair(jnn.SpatialConvolution(*args, **kw),
                    pnn.SpatialConvolution(*args, **kw, device="cpu"), _x(shape), True)
    assert_pair(j, p)


def test_convolution_rejects_unknown_activation():
    with pytest.raises(ValueError, match="activation"):
        pnn.SpatialConvolution(4, 6, 3, activation="swish", device="cpu")


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape", [(4, 5, 6, 7), (8, 5)])
def test_batch_normalization_matches_jax(training, shape):
    """Train mode: batch statistics, new running mean and UNBIASED running
    var (momentum 0.1); eval mode: the running statistics, state unchanged."""
    x = _x(shape, 1) * 3 + 1
    cls = (jnn.SpatialBatchNormalization, pnn.SpatialBatchNormalization) if len(shape) == 4 \
        else (jnn.BatchNormalization, pnn.BatchNormalization)
    jm, pm = cls[0](shape[1]), cls[1](shape[1], device="cpu")
    j, p = run_pair(jm, pm, x, training, seed=2)
    assert_pair(j, p)
    if training:
        xf = x.reshape(shape[0], shape[1], -1).transpose(1, 0, 2).reshape(shape[1], -1)
        np.testing.assert_allclose(p["state"]["running_var"],
                                   0.9 + 0.1 * xf.var(axis=1, ddof=1), rtol=1e-5)
    else:  # the running statistics are returned unchanged
        assert not p["state"]["running_mean"].any() and (p["state"]["running_var"] == 1).all()


def test_batch_normalization_bf16_fold_matches_jax():
    """A bf16 input: fp32 statistics folded into an fp32 (scale, shift)
    applied in bf16; the output stays bf16 and the running statistics fp32."""
    x = np.array(jnp.asarray(_x((4, 6, 5, 5), 3) * 2 - 1, jnp.bfloat16).astype(jnp.float32))
    jm, pm = jnn.SpatialBatchNormalization(6), pnn.SpatialBatchNormalization(6, device="cpu")
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=x)
    pm.init(sample_input=torch.from_numpy(x))
    gamma = np.linspace(0.5, 1.5, 6).astype(np.float32)
    jp = {"weight": jnp.asarray(gamma), "bias": jnp.asarray(-gamma / 3)}
    load_jax_params(pm, np_tree(jp))
    jy, jns = jm.apply(jp, js, jnp.asarray(x, jnp.bfloat16), training=True)
    py, pns = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x).bfloat16(),
                       training=True)
    assert py.dtype == torch.bfloat16 and pns["running_mean"].dtype == torch.float32
    np.testing.assert_allclose(py.detach().float().numpy(), np.asarray(jy, np.float32), atol=1e-2,
                               rtol=1e-2)
    for k, v in flat(np_tree(jns)).items():
        np.testing.assert_allclose(pns[k].numpy(), v, atol=1e-6, rtol=1e-5)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_train_forward_state_carries_no_autograd_history():
    """The running statistics a train-mode forward returns hold no graph:
    through ``apply`` (what LocalOptimizer stores), ``forward`` and a
    container, after a forward and a backward."""
    x = torch.from_numpy(_x((4, 3, 6, 6), 4))
    seq = pnn.Sequential(pnn.SpatialConvolution(3, 5, 3, 3, 1, 1, 1, 1, device="cpu"),
                         pnn.SpatialBatchNormalization(5, device="cpu"), device="cpu")
    seq.init(sample_input=x)
    seq.train()
    y, new_state = seq.apply(seq.get_parameters(), seq.get_state(), x, training=True)
    y.square().sum().backward()
    leaves = list(_leaves(new_state))
    assert len(leaves) == 2
    assert all(t.grad_fn is None and not t.requires_grad for t in leaves)
    seq.forward(x).sum().backward()
    assert all(t.grad_fn is None and not t.requires_grad for t in _leaves(seq.get_state()))
    assert list(seq.get_state()) == ["SpatialConvolution_0", "SpatialBatchNormalization_1"]
    assert seq.get_state()["SpatialBatchNormalization_1"] is seq[1].get_state()
