"""The port's ``LBFGS`` against the JAX package's: with the fixed step and
with ``line_search="lswolfe"``, on a small least-squares problem and on a
small tanh MLP's cross-entropy, from the same numpy-made start; each
package's ``feval`` computes the loss and gradient with its own autodiff
(f32), and both run the same float64 host math over the raveled
parameters (in ``ravel_pytree``'s order, keys sorted).

Tolerances, fixed before the first run: the loss histories within 1e-5
relative (least squares) and 1e-4 relative (the MLP), and the final
parameters within 1e-4 (absolute and relative): the two packages' f32
losses and gradients differ by summation order (~1e-7 relative), which the
line search's accept/reject decisions and the two-loop recursion carry
forward without flipping a decision at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.optim as joptim
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.optim.lbfgs import _cubic_interpolate

N, D, H, C = 32, 6, 8, 3


def _problem(kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    if kind == "lsq":
        y = (x @ rng.standard_normal((D, 2)) + 0.1 * rng.standard_normal((N, 2))).astype(
            np.float32)
        params = {"w": np.zeros((D, 2), np.float32), "b": np.zeros(2, np.float32)}
    else:
        y = rng.integers(0, C, N)
        params = {"l1": {"w": (0.5 * rng.standard_normal((D, H))).astype(np.float32),
                         "b": np.zeros(H, np.float32)},
                  "l2": {"w": (0.5 * rng.standard_normal((H, C))).astype(np.float32),
                         "b": np.zeros(C, np.float32)}}
    return x, y, params


def _jax_loss(kind, x, y):
    def loss(p):
        if kind == "lsq":
            return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)
        h = jnp.tanh(x @ p["l1"]["w"] + p["l1"]["b"])
        logits = h @ p["l2"]["w"] + p["l2"]["b"]
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(N), y])
    return jax.value_and_grad(loss)


def _port_feval(kind, x, y, counter):
    def feval(p):
        counter.append(1)
        dev = next(_leaves(p)).device
        xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(np.asarray(y)).to(dev)
        leaves = [t.requires_grad_() for t in _leaves(p)]
        if kind == "lsq":
            loss = torch.mean((xt @ p["w"] + p["b"] - yt) ** 2)
        else:
            h = torch.tanh(xt @ p["l1"]["w"] + p["l1"]["b"])
            logits = h @ p["l2"]["w"] + p["l2"]["b"]
            loss = torch.nn.functional.cross_entropy(logits, yt)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), _map(lambda _: next(it), p)
    return feval


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        out.update(_paths(v, path) if isinstance(v, dict) else {path: v})
    return out


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


@pytest.mark.parametrize("line_search", [None, "lswolfe"])
@pytest.mark.parametrize("kind,rtol", [("lsq", 1e-5), ("mlp", 1e-4)])
def test_lbfgs_matches_jax(kind, rtol, line_search):
    x, y, params = _problem(kind)
    kw = dict(max_iter=12, line_search=line_search,
              learningrate=1.0 if line_search else 0.5)
    jm, pm = joptim.LBFGS(**kw), poptim.LBFGS(**kw)
    jfeval = _jax_loss(kind, x, y)
    jp, jhist = jm.optimize(jfeval, _map(jnp.asarray, params))
    evals = []
    start = _map(torch.from_numpy, params)
    pp, phist = pm.optimize(_port_feval(kind, x, y, evals), start)
    assert len(phist) == len(jhist) > 3
    np.testing.assert_allclose(phist, jhist, rtol=rtol)
    assert phist[-1] < 0.5 * phist[0]
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = _paths(pp)
    assert got.keys() == want.keys() and list(pp) == list(params)  # the caller's key order
    for path, a in got.items():
        np.testing.assert_allclose(a.numpy(), want[path], atol=1e-4, rtol=1e-4, err_msg=path)
        assert a.dtype == torch.float32
    np.testing.assert_array_equal(next(_leaves(start)).numpy(),
                                  next(_leaves(params)))  # the start is left untouched
    assert pm.state["neval"] == jm.state["neval"] and len(evals) >= len(phist)
    if line_search:  # the strong-Wolfe search never accepts a larger loss
        assert all(b <= a for a, b in zip(phist, phist[1:]))


def test_lbfgs_is_closure_driven_and_checks_its_options():
    m = poptim.LBFGS()
    with pytest.raises(NotImplementedError, match="closure-driven"):
        m.init_slots({})
    with pytest.raises(NotImplementedError, match="closure-driven"):
        m.update({}, {}, {}, 0.1, 1)
    with pytest.raises(ValueError, match="line_search"):
        poptim.LBFGS(line_search="armijo")
    assert poptim.LBFGS(max_iter=8).max_eval == joptim.LBFGS(max_iter=8).max_eval == 10.0


@pytest.mark.parametrize("args", [(0.0, 1.0, -2.0, 1.0, 0.5, 1.0), (1.0, 0.3, 0.5, 0.0, 1.0, -1.0),
                                  (0.0, 1.0, -1.0, 2.0, 5.0, 3.0, (0.1, 3.0))])
def test_cubic_interpolate_matches_jax(args):
    from bigdl_tpu.optim.lbfgs import _cubic_interpolate as jcubic

    assert _cubic_interpolate(*args) == jcubic(*args)


def test_lbfgs_stops_at_a_zero_gradient():
    m = poptim.LBFGS()
    p = {"w": torch.ones(3)}
    calls = []
    out, hist = m.optimize(lambda q: calls.append(1) or (torch.tensor(0.0), {"w": torch.zeros(3)}),
                           p)
    assert hist == [0.0] and torch.equal(out["w"], p["w"]) and len(calls) == 1


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_lbfgs.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("line_search", [None, "lswolfe"])
def test_lbfgs_feval_on_card_matches_cpu(cuda_card, line_search):
    """``feval`` runs on the parameters' device: the card's history against
    the CPU's, within the MLP's 1e-4."""
    x, y, params = _problem("mlp")
    kw = dict(max_iter=8, line_search=line_search, learningrate=1.0 if line_search else 0.5)
    _, cpu_hist = poptim.LBFGS(**kw).optimize(_port_feval("mlp", x, y, []),
                                              _map(torch.from_numpy, params))
    out, card_hist = poptim.LBFGS(**kw).optimize(
        _port_feval("mlp", x, y, []), _map(lambda t: torch.from_numpy(t).cuda(), params))
    assert all(t.is_cuda for t in _leaves(out))
    np.testing.assert_allclose(card_hist, cpu_hist, rtol=1e-4)


def test_lbfgs_keeps_subtrees_without_parameters():
    """A module tree's parameter-less layers (``{}``) survive the ravel, as
    ``ravel_pytree``'s unflatten keeps them: the model's apply can index them."""
    p = {"a_reshape": {}, "fc": {"w": torch.ones(2)}, "z_act": {}}
    out, _ = poptim.LBFGS(max_iter=2).optimize(
        lambda q: (torch.sum(q["fc"]["w"] ** 2), {"a_reshape": {}, "fc": {"w": 2 * q["fc"]["w"]},
                                                  "z_act": {}}), p)
    assert out.keys() == p.keys() and out["a_reshape"] == {} and out["z_act"] == {}
