"""The port's NeuralCF (NeuMF) slice against the JAX package's: the model's
parameter paths, log-probabilities and gradient tree with and without the
GMF tower, 3 ``LocalOptimizer`` Adam steps (``ClassNLLCriterion``, the
example's recipe) from the JAX model's weights carried over,
``load_movielens`` (the synthetic log equal to JAX's array for array; a
``ratings.dat`` the test writes, by path and by folder, equal too; a
missing file raising), and ``examples/ncf_train``'s ``main`` to its end at
a tiny size (its ranking groups, its refused flags).

Inputs from numpy with a seed, f32 on the CPU. Tolerances, fixed before
the first run: log-probabilities, loss and every gradient 1e-6 absolute +
1e-5 relative (the same f32 products summed in another order through
gathers and three small layers); after 3 Adam steps (lr 1e-3), losses
1e-5, every parameter 1e-5 absolute and the whole update within 1e-3
relative L2 (Adam divides by sqrt(v) + 1e-8, so a gradient entry that is
f32 noise on both sides could step differently; none here is, by the
readings). The loaders' arrays are equal exactly.

``train_both`` is shared with ``test_torch_text_models.py`` and
``test_torch_autoencoder.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.movielens import load_movielens as jload_movielens
from bigdl_tpu.models import NeuralCF as JNeuralCF
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataSet, load_movielens
from bigdl_tpu_torch.examples import ncf_train
from bigdl_tpu_torch.models import NeuralCF
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

from test_torch_conv_bn import flat, np_tree
from test_torch_lenet import update_distance

SEED = 3
TOL = dict(atol=1e-6, rtol=1e-5)


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


class _Recording(joptim.LocalOptimizer):
    """The JAX LocalOptimizer, keeping each logged (one-step-late) loss."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.losses = []

    def _log_iteration(self, state, loss, records, wall, throughput):
        self.losses.append(float(loss))


def train_both(jax_model, port_model, x, y, batch, criterion, method, steps=3, seed=SEED,
               jax_dataset=None, port_dataset=None):
    """``steps`` LocalOptimizer steps of the JAX model and of the port's from
    the JAX model's initial weights, over the same records in the same epoch
    order (one global seed). ``criterion(nn)`` and ``method(optim)`` build
    each package's criterion and optimization method from its modules."""
    JRandom.set_seed(seed)
    jp, _ = jax_model.init(jax.random.PRNGKey(seed), sample_input=x[:batch])
    init = np_tree(jp)
    jds = jax_dataset or JDataSet.array(x, y, batch_size=batch)
    jopt = _Recording(jax_model, jds, criterion(jnn))
    jopt.set_optim_method(method(joptim))
    jopt.set_end_when(joptim.Trigger.max_iteration(steps)).optimize()

    RandomGenerator.set_seed(seed)
    port_model.init(sample_input=x[:batch])
    load_jax_params(port_model, init)
    pds = port_dataset or DataSet.array(x, y, batch_size=batch)
    opt = poptim.LocalOptimizer(port_model, pds, criterion(pnn))
    opt.set_optim_method(method(poptim))
    opt.set_end_when(poptim.Trigger.max_iteration(steps)).optimize()
    return dict(init=flat(init), jax_losses=jopt.losses,
                losses=[h["loss"] for h in opt.history], records=[h["records"] for h in
                                                                    opt.history],
                jax_params=flat(np_tree(jax_model.get_parameters())),
                params=flat(port_model.get_parameters()))


def assert_trained_alike(run, steps=3, atol=1e-5, update=1e-3, params_atol=None):
    assert len(run["losses"]) == len(run["jax_losses"]) == steps
    np.testing.assert_allclose(run["losses"], run["jax_losses"], atol=atol)
    assert set(run["params"]) == set(run["jax_params"])
    for k, v in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][k], v, atol=params_atol or atol, err_msg=k)
    assert update_distance(run) <= update


def _ids(n, users, items, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, users + 1, n), rng.integers(1, items + 1, n)],
                    axis=1).astype(np.int64), rng.integers(0, 2, n)


def _ncf_kw(include_mf):
    return dict(class_num=2, user_embed=6, item_embed=5, hidden_layers=(12, 8, 4),
                include_mf=include_mf, mf_embed=7)


@pytest.mark.parametrize("include_mf", [True, False], ids=["neumf", "mlp_only"])
def test_ncf_forward_and_gradients_match_jax(include_mf):
    x, y = _ids(16, 30, 40)
    x[0] = (30, 40)  # the last id of each table
    jm = JNeuralCF(30, 40, **_ncf_kw(include_mf))
    jp, js = jm.init(jax.random.PRNGKey(SEED), sample_input=x)
    pm = NeuralCF(30, 40, **_ncf_kw(include_mf), device="cpu")
    pm.init(sample_input=x)
    want = {k: v.shape for k, v in flat(np_tree(jp)).items()}
    assert {k: tuple(v.shape) for k, v in pm.named_parameters()} == want
    assert [m.name() for m in pm] == [m.name() for m in jm.modules]
    load_jax_params(pm, np_tree(jp))

    def jloss(p):
        out, _ = jm.apply(p, js, jnp.asarray(x), training=True)
        return jnn.ClassNLLCriterion()._apply(out, jnp.asarray(y)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    out, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(x), training=True)
    loss = pnn.ClassNLLCriterion()._apply(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    got, want = flat(pm.get_grad_parameters()), flat(np_tree(jg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert np.abs(got["mlp_user_embed.weight"][29]).sum() > 0  # id 30 -> row 29


def test_ncf_trees_carry_across_and_refuse_a_missing_key():
    x, _ = _ids(4, 30, 40)
    jm = JNeuralCF(30, 40, **_ncf_kw(True))
    jp, js = jm.init(jax.random.PRNGKey(SEED), sample_input=x)
    pm = NeuralCF(30, 40, **_ncf_kw(True), device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, np_tree(jp))
    load_jax_state(pm, np_tree(js))  # every child stateless: nested empty trees
    for k, v in flat(np_tree(jp)).items():
        np.testing.assert_array_equal(dict(pm.named_parameters())[k].detach().numpy(), v)
    tree = np_tree(jp)
    del tree["mlp_tower"]["mlp_fc1"]
    with pytest.raises(KeyError, match="mlp_tower.mlp_fc1.bias"):
        load_jax_params(pm, tree)


def test_ncf_trains_like_jax():
    x, y, users, items = load_movielens(None, n=48, n_users=20, n_items=30, seed=4)
    run = train_both(JNeuralCF(users, items, **_ncf_kw(True)),
                     NeuralCF(users, items, **_ncf_kw(True), device="cpu"), x, y, 16,
                     lambda nn: nn.ClassNLLCriterion(),
                     lambda o: o.Adam(learningrate=1e-3))
    assert_trained_alike(run)


@pytest.mark.parametrize("kw", [dict(), dict(n=300, n_users=7, n_items=9, neg_per_pos=2, seed=5),
                                dict(n=None), dict(n=64, n_users=3, n_items=2)],
                         ids=["default", "small", "n_none", "dense"])
def test_load_movielens_synthetic_matches_jax(kw):
    got, want = load_movielens(None, **kw), jload_movielens(None, **kw)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2:] == want[2:]


def test_load_movielens_ratings_file_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    lines = [f"{u}::{i}::{rng.integers(1, 6)}::97830{k}" for k, (u, i) in enumerate(
        zip(rng.integers(1, 40, 200), rng.integers(1, 60, 200)))]
    (tmp_path / "ratings.dat").write_text("\n".join(lines + ["", "bad line"]) + "\n")
    for path, n in ((str(tmp_path / "ratings.dat"), 50), (str(tmp_path), None)):
        got, want = load_movielens(path, n=n, seed=2), jload_movielens(path, n=n, seed=2)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2:] == want[2:]
    x, y, users, items = load_movielens(str(tmp_path), n=None)
    assert (users, items) == (max(int(s.split("::")[0]) for s in lines),
                              max(int(s.split("::")[1]) for s in lines))
    assert int(y.sum()) == 200 and x.min() >= 1


def test_load_movielens_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="ratings file not found"):
        load_movielens(str(tmp_path / "nope.dat"))
    with pytest.raises(FileNotFoundError, match="ratings file not found"):
        load_movielens(str(tmp_path))  # a folder without ratings.dat
    (tmp_path / "ratings.dat").write_text("header only\n")
    with pytest.raises(ValueError, match="no 'user::item::rating' rows"):
        load_movielens(str(tmp_path))


def test_ncf_example_runs_to_its_end(capsys):
    run = ncf_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "400",
                          "--embed-dim", "4", "--mf-embed", "4", "-b", "32"])
    out = capsys.readouterr().out
    assert len(run.optimizer.history) == int(0.8 * 800) // 32
    assert all(np.isfinite(h["loss"]) for h in run.optimizer.history)
    for name in ("Top1Accuracy", "HitRatio@10", "NDCG@10"):
        assert 0.0 <= run.results[name] <= 1.0 and f"{name}: " in out
    assert run.results["NDCG@10"] <= run.results["HitRatio@10"]
    # the ranking groups: (positive, 20 negatives the log never holds) each
    x, y, _, items = load_movielens(None, n=400, seed=0)
    rows = ncf_train.ranking_groups(x, y, int(0.8 * len(x)), items)
    assert len(rows) % 21 == 0 and len(rows) > 0
    seen = set(map(tuple, x.tolist()))
    groups = rows.reshape(-1, 21, 2)
    assert all(tuple(g[0]) in seen and not any(tuple(r) in seen for r in g[1:])
               and (g[:, 0] == g[0, 0]).all() for g in groups)


@pytest.mark.parametrize("flag", ["--model-save", "--summary-dir", "--n-devices"])
def test_ncf_example_flags(flag, tmp_path):
    """``--model-save`` writes the model, ``--summary-dir`` is taken and
    left empty, as by the JAX main; ``--n-devices`` above 1 is for the
    DistriOptimizer mains: NCF trains on one card."""
    if flag == "--n-devices":
        with pytest.raises(ValueError, match="one card"):
            ncf_train.main(["--platform", "cpu", flag, "2"])
        return
    path = tmp_path / "out"
    run = ncf_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "400",
                          "--embed-dim", "4", "--mf-embed", "4", "-b", "32", flag, str(path)])
    if flag == "--model-save":
        loaded = pnn.load_module(str(path), device="cpu")
        assert set(dict(loaded.named_parameters())) == set(dict(run.model.named_parameters()))
    else:
        assert not path.exists() or not any(p.is_file() for p in path.rglob("*"))
