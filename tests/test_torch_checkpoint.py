"""Checkpoints between the port and the JAX package, both ways, and the
port's resume.

* A port-written checkpoint has the JAX package's file names, passes its
  ``verify_checkpoint`` and loads with its ``load_checkpoint`` bit for bit
  (the port's own parameters, BN state and slots); the JAX
  ``LocalOptimizer`` resumes from it.
* A JAX-written checkpoint taken mid-epoch, resumed by the port, continues
  as the JAX package's own resume of it does.
* A truncated newest file falls back to the older verified checkpoint;
  ``keep_last`` prunes; a port resume in the middle of an epoch equals the
  uninterrupted run bit for bit on the CPU (dropout on, so the RNG position
  is part of it, and a decaying learning rate, so the state table is).

Data and weights from numpy with a seed, the JAX model's initial weights
and BN state carried over, the same global seed in both packages (the same
epoch order). Tolerances across the packages are
``test_torch_resnet_training.py``'s: losses and parameters 1e-3 absolute,
BN state 1e-3 absolute + 1e-3 relative (f32 summed in another order);
within one package, exact.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.resilience import CheckpointCorrupt
from bigdl_tpu_torch.utils import serialization as pser

from test_torch_conv_bn import flat, np_tree
from test_torch_validation import _RecordingJax, carried_pair, cnn, images

ATOL = 1e-3
SEED = 9


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
    yield
    Engine.set_compute_dtype(None)


def _train(pkg, model, x, y, iters, ckpt=None, every=3, keep_last=None, resume=None,
           lr_decay=0.0):
    """``iters`` iterations of SGD (lr 0.1, momentum 0.9) at batch 8 in the
    JAX package (``pkg="jax"``) or the port, checkpointing every ``every``
    into ``ckpt``, after resuming from ``resume`` when given."""
    if pkg == "jax":
        JRandom.set_seed(SEED)
        opt = _RecordingJax(model, JDataSet.array(x, y, batch_size=8), jnn.ClassNLLCriterion())
        om, trig = joptim, joptim.Trigger
    else:
        RandomGenerator.set_seed(SEED)
        opt = poptim.LocalOptimizer(model, DataSet.array(x, y, batch_size=8),
                                    pnn.ClassNLLCriterion())
        om, trig = poptim, poptim.Trigger
    opt.set_optim_method(om.SGD(learningrate=0.1, momentum=0.9, learningrate_decay=lr_decay))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, trig.several_iteration(every), keep_last=keep_last)
    if resume is not None:
        opt.resume(resume)
    opt.set_end_when(trig.max_iteration(iters)).optimize()
    return opt


def _losses(opt):
    return opt.losses if hasattr(opt, "losses") else [h["loss"] for h in opt.history]


def _only_step(src, step, dst):
    """A directory holding only ``src``'s checkpoint ``step``."""
    os.makedirs(dst)
    for name in (f"model.{step}.npz", f"optimMethod.{step}.npz", f"state.{step}.json",
                 f"manifest.{step}.json"):
        shutil.copy(os.path.join(src, name), dst)
    return str(dst)


def test_port_checkpoint_is_read_by_jax(tmp_path):
    """Same file names as the JAX package's run writes; JAX verifies and
    loads the port's arrays bit for bit; JAX resumes from them."""
    x, y = images(40, 11)
    jm, pm = carried_pair(cnn, x[:8])
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jopt = _train("jax", jm, x, y, 6, jdir)
    popt = _train("port", pm, x, y, 6, pdir)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == sorted(
        f"{kind}.{s}.{ext}" for s in (4, 7) for kind, ext in (
            ("model", "npz"), ("optimMethod", "npz"), ("state", "json"), ("manifest", "json")))
    for step in (4, 7):
        assert jser.verify_checkpoint(pdir, step) is None
    params, slots, host, state = jser.load_checkpoint(pdir, 7)
    assert params.keys() == {k.replace(".", "/") for k in flat(pm.get_parameters())}
    for k, v in flat(pm.get_parameters()).items():
        assert params[k.replace(".", "/")].dtype == v.dtype
        np.testing.assert_array_equal(params[k.replace(".", "/")], v, err_msg=k)
    for k, v in flat(pm.get_state()).items():
        np.testing.assert_array_equal(state[k.replace(".", "/")], v, err_msg=k)
    assert set(slots) == {f"velocity/{k.replace('.', '/')}" for k in flat(pm.get_parameters())}
    _, jslots, jhost, _ = jser.load_checkpoint(jdir, 7)
    for k in jslots:
        np.testing.assert_allclose(slots[k], jslots[k], atol=ATOL, err_msg=k)
    assert set(host) == set(jhost)
    for k in ("neval", "epoch", "_iter_in_epoch", "_epoch_done", "_rng_seed"):
        assert host[k] == jhost[k], k
    assert host["neval"] == 7 and host["epoch"] == 2 and host["_iter_in_epoch"] == 1
    np.testing.assert_allclose(_losses(popt), _losses(jopt), atol=ATOL)
    # the JAX package resumes from the port's step 4 and continues as the port did
    jm2, _ = carried_pair(cnn, x[:8])
    jres = _train("jax", jm2, x, y, 6, resume=_only_step(pdir, 4, tmp_path / "p4"))
    np.testing.assert_allclose(jres.losses, _losses(popt)[3:], atol=ATOL)
    want = flat(pm.get_parameters())
    for k, v in flat(np_tree(jm2.get_parameters())).items():
        np.testing.assert_allclose(v, want[k], atol=ATOL, err_msg=k)


def test_jax_checkpoint_is_resumed_by_the_port(tmp_path):
    """JAX trains 7 iterations (5 an epoch), checkpointing at step 4 (mid
    epoch 1, three batches into it); JAX and the port each resume from it
    and train iterations 4-7 across the epoch boundary."""
    x, y = images(40, 12)
    jm, _ = carried_pair(cnn, x[:8])
    jdir = str(tmp_path / "jax")
    jfull = _train("jax", jm, x, y, 7, jdir)
    src = _only_step(jdir, 4, tmp_path / "j4")
    jm2, pm2 = carried_pair(cnn, x[:8])
    jres = _train("jax", jm2, x, y, 7, resume=src)
    popt = _train("port", pm2, x, y, 7, resume=src)
    assert [h["neval"] for h in popt.history] == [4, 5, 6, 7]
    assert [h["epoch"] for h in popt.history] == [1, 1, 2, 2]
    np.testing.assert_allclose(_losses(popt), jres.losses, atol=ATOL)
    np.testing.assert_allclose(jres.losses, jfull.losses[3:], atol=1e-6)
    want_p, want_s = flat(np_tree(jm2.get_parameters())), flat(np_tree(jm2.get_state()))
    for k, v in flat(pm2.get_parameters()).items():
        np.testing.assert_allclose(v, want_p[k], atol=ATOL, err_msg=k)
    for k, v in flat(pm2.get_state()).items():
        np.testing.assert_allclose(v, want_s[k], atol=ATOL, rtol=ATOL, err_msg=k)
    assert popt.optim_method.state["neval"] == jres.optim_method.state["neval"] == 8


def _dropout_cnn(nn, d):
    m = cnn(nn, d)
    m.add(nn.Dropout(0.3, **d))  # dropout on the log-probabilities: draws every step
    return m


def test_mid_epoch_resume_is_bit_exact(tmp_path):
    """8 uninterrupted iterations against 3, a checkpoint, then a fresh model
    resumed from it (mid epoch 1) for iterations 4-8: the same losses,
    parameters, BN state, slots and state table, bit for bit."""
    x, y = images(40, 13)
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    _, pm = carried_pair(_dropout_cnn, x[:8])
    full = _train("port", pm, x, y, 8, full_dir, lr_decay=0.05)
    _, pm_cut = carried_pair(_dropout_cnn, x[:8])
    _train("port", pm_cut, x, y, 3, cut_dir, lr_decay=0.05)
    assert pser.latest_checkpoint_step(cut_dir) == 4
    RandomGenerator.set_seed(123)  # a fresh process's stream: the resume must restore it
    fresh = _dropout_cnn(pnn, {"device": "cpu"})
    fresh.init(sample_input=torch.from_numpy(x[:8]))
    params_before = {k: (id(p), p.data_ptr()) for k, p in fresh.named_parameters()}
    res = _train("port", fresh, x, y, 8, cut_dir, resume=cut_dir, lr_decay=0.05)
    assert [h["neval"] for h in res.history] == [4, 5, 6, 7, 8]
    assert [h["loss"] for h in res.history] == [h["loss"] for h in full.history][3:]
    assert [h["lr"] for h in res.history] == [h["lr"] for h in full.history][3:]
    for k, v in flat(pm.get_parameters()).items():
        np.testing.assert_array_equal(flat(fresh.get_parameters())[k], v, err_msg=k)
    for k, v in flat(pm.get_state()).items():
        np.testing.assert_array_equal(flat(fresh.get_state())[k], v, err_msg=k)
    # parameters restored in place, BN state without autograd history
    assert {k: (id(p), p.data_ptr()) for k, p in fresh.named_parameters()} == params_before
    assert all(t.grad_fn is None and not t.requires_grad
               for t in flat_tensors(fresh.get_state()))
    assert dict(full.optim_method.state) == dict(res.optim_method.state)
    # the step-7 checkpoints of both runs: the same arrays (slots too) and host table
    for a, b in zip(pser.load_checkpoint(full_dir, 7), pser.load_checkpoint(cut_dir, 7)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def flat_tensors(tree):
    for v in tree.values():
        yield from (flat_tensors(v) if isinstance(v, dict) else (v,))


def test_resume_restores_slots_and_rng_position(tmp_path):
    x, y = images(16, 14)
    _, pm = carried_pair(cnn, x[:8])
    d = str(tmp_path / "c")
    opt = _train("port", pm, x, y, 2, d, every=2)
    _, slots, host, _ = pser.load_checkpoint(d)
    RandomGenerator.set_seed(1)
    _, pm2 = carried_pair(cnn, x[:8])
    opt2 = poptim.LocalOptimizer(pm2, DataSet.array(x, y, batch_size=8), pnn.ClassNLLCriterion())
    opt2.set_optim_method(poptim.SGD(learningrate=0.1, momentum=0.9)).resume(d)
    assert (RandomGenerator.get_seed(), RandomGenerator._counter) == (
        host["_rng_seed"], host["_rng_counter"]) == (SEED, host["_rng_counter"])
    fresh = opt2._init_slots(opt2.optim_method, pm2.get_parameters())
    got = pser.flatten_pytree(fresh)
    assert got.keys() == slots.keys() and all(np.array_equal(got[k], slots[k]) for k in got)
    # written after the epoch's last batch, before its end: that epoch's 2 batches to skip
    assert opt2.optim_method.state["neval"] == 3 and opt2._resume_skip_iters == 2
    assert opt.optim_method.state["epoch"] == opt2.optim_method.state["epoch"] == 1


def test_truncated_newest_checkpoint_falls_back(tmp_path, caplog):
    x, y = images(40, 15)
    _, pm = carried_pair(cnn, x[:8])
    d = str(tmp_path / "c")
    _train("port", pm, x, y, 6, d, every=2)
    assert pser._checkpoint_steps(d) == [7, 5, 3]
    path = os.path.join(d, "optimMethod.7.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert "truncated" in pser.verify_checkpoint(d, 7)
    assert "truncated" in jser.verify_checkpoint(d, 7)
    with pytest.raises(CheckpointCorrupt, match="step 7"):
        pser.load_checkpoint(d, 7)
    _, _, host, _ = pser.load_checkpoint(d)
    assert host["neval"] == 5
    assert "falling back" in caplog.text
    _, pm2 = carried_pair(cnn, x[:8])
    opt = poptim.LocalOptimizer(pm2, DataSet.array(x, y, batch_size=8), pnn.ClassNLLCriterion())
    opt.resume(d)
    assert opt.optim_method.state["neval"] == 5 and opt._resume_skip_iters == 4


def test_keep_last_prunes_and_keeps_the_newest_finite(tmp_path):
    x, y = images(40, 16)
    _, pm = carried_pair(cnn, x[:8])
    d = str(tmp_path / "c")
    _train("port", pm, x, y, 6, d, every=2, keep_last=2)
    assert pser._checkpoint_steps(d) == [7, 5]
    assert sorted(os.listdir(d)) == sorted(
        f"{k}.{s}.{e}" for s in (5, 7) for k, e in (("model", "npz"), ("optimMethod", "npz"),
                                                     ("state", "json"), ("manifest", "json")))
    bad = {"w": torch.tensor([float("nan")])}
    for step in (9, 11):
        m = pser.save_checkpoint(d, step, bad, {}, {"neval": step}, keep_last=2)
        assert m["finite"] is False
    # the two newest are non-finite: the newest finite (7) stays beside them
    assert pser._checkpoint_steps(d) == [11, 9, 7]
    assert jser._checkpoint_steps(d) == [11, 9, 7]
    assert [s for s in pser._checkpoint_steps(d) if pser._manifest_finite(d, s)] == [7]
    assert pser.quarantine_nonfinite(d) == [11, 9]
    assert pser.latest_checkpoint_step(d) == 7
    with pytest.raises(ValueError, match="keep_last"):
        pser.prune_checkpoints(d, 0)


def test_checkpoint_configuration_errors(tmp_path):
    x, y = images(8, 17)
    opt = poptim.LocalOptimizer(cnn(pnn, {"device": "cpu"}), DataSet.array(x, y, batch_size=8),
                                pnn.ClassNLLCriterion())
    with pytest.raises(ValueError, match="path"):
        opt.set_checkpoint(None, poptim.Trigger.every_epoch())
    with pytest.raises(ValueError, match="trigger"):
        opt.set_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint path"):
        opt.resume()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        opt.resume(str(tmp_path / "empty"))


def test_bf16_leaves_are_stored_as_the_jax_package_stores_them(tmp_path):
    """numpy has no bfloat16: both packages store its raw 2 bytes (``|V2``)."""
    v = np.array([1.5, -2.25, 3e-3, 65280.0], np.float32)
    pser.save_pytree(str(tmp_path / "p.npz"), {"a": {"w": torch.from_numpy(v).bfloat16()}})
    jser.save_pytree(str(tmp_path / "j.npz"), {"a": {"w": jnp.asarray(v, jnp.bfloat16)}})
    p, j = pser.load_pytree(str(tmp_path / "p.npz")), jser.load_pytree(str(tmp_path / "j.npz"))
    assert p["a/w"].dtype == j["a/w"].dtype == np.dtype("V2")
    assert p["a/w"].tobytes() == j["a/w"].tobytes()
    dst = {"a": {"w": torch.zeros(4, dtype=torch.bfloat16)}}
    pser.copy_into(dst, j, "test")
    assert torch.equal(dst["a"]["w"], torch.from_numpy(v).bfloat16())
    with pytest.raises(KeyError, match="missing"):
        pser.copy_into({"a": {"w": dst["a"]["w"], "b": dst["a"]["w"]}}, j, "test")
    with pytest.raises(ValueError, match="shape"):
        pser.copy_into({"a": {"w": torch.zeros(3)}}, j, "test")


def test_state_file_is_json_of_the_host_table(tmp_path):
    d = str(tmp_path)
    pser.save_checkpoint(d, 3, {"w": torch.ones(2)}, {"velocity": {"w": torch.zeros(2)}},
                         {"neval": 3, "epoch": 1, "loss": 0.5, "obj": object()},
                         model_state={"bn": {"running_mean": torch.zeros(2)}})
    with open(os.path.join(d, "state.3.json")) as f:
        host = json.load(f)
    assert host == {"neval": 3, "epoch": 1, "loss": 0.5, "_rng_seed": RandomGenerator.get_seed(),
                    "_rng_counter": RandomGenerator._counter}
    params, slots, _, state = jser.load_checkpoint(d, 3)
    assert list(params) == ["w"] and list(slots) == ["velocity/w"]
    assert list(state) == ["bn/running_mean"]
    params, slots, _, _ = pser.load_checkpoint(d, 3)
    slots = pser.unflatten_to_like(slots, {"velocity": {"w": 0}})
    assert params["w"].tolist() == [1.0, 1.0] and slots["velocity"]["w"].tolist() == [0.0, 0.0]
