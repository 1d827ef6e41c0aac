"""The port's retry ladder against the JAX package's, on the CPU: the
training scenarios of ``tests/test_resilience.py``,
``tests/test_failure_retry.py`` and ``tests/test_chaos_matrix.py`` through
both packages' ``LocalOptimizer`` in one test.

Model and data: the JAX tests' toy classifier (5 -> Linear(16) -> Tanh ->
Linear(3) -> LogSoftMax, ClassNLL) with the JAX model's initial weights
carried into the port (``load_jax_params``), the same records and the same
global seed, so both visit the same batches in the same order. Outcomes
that must be equal: the record sequence of the retry ladder (``retry`` /
``rollback`` / ``fault_injected`` / ``preempt_checkpoint`` records, fields
other than times), the policy's counters and skip positions, ``neval`` and
the LR scale. Parameters: a faulted and recovered run ends bit-equal to the
same package's clean run; port against JAX within ``ATOL`` (both compute in
f32, summed in another order: 1e-5 of the unit-scale weights after 10-20
SGD steps).
"""

import importlib.util
import os
import signal
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.obs as jobs
import bigdl_tpu.optim as joptim
import bigdl_tpu.resilience as jres
import bigdl_tpu.utils.serialization as jser
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.obs as pobs
import bigdl_tpu_torch.optim as poptim
import bigdl_tpu_torch.resilience as pres
import bigdl_tpu_torch.utils.serialization as pser
from bigdl_tpu.dataset.dataset import AbstractDataSet as JAbstract
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.dataset import DataSet as PDataSet
from bigdl_tpu_torch.dataset import MiniBatch as PMiniBatch
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet as PAbstract
from bigdl_tpu_torch.utils.convert import load_jax_params

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("obs_report", REPO / "tools" / "obs_report.py")
obs_report = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = obs_report
_spec.loader.exec_module(obs_report)

ATOL = 1e-5
RESILIENCE = ("retry", "rollback", "fault_injected", "preempt_checkpoint")
_TIMES = {"ts", "host", "process_index", "process_count", "dump_latency_s", "bundle"}


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _problem(n=64, d=5, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, classes)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int32)
    return x, y


def _jax_model(seed=5):
    JRandom.set_seed(seed)
    m = jnn.Sequential(jnn.Linear(5, 16), jnn.Tanh(), jnn.Linear(16, 3), jnn.LogSoftMax())
    m.init(sample_input=np.zeros((1, 5), np.float32))
    return m


def _port_model(seed=5):
    d = {"device": "cpu"}
    m = pnn.Sequential(pnn.Linear(5, 16, **d), pnn.Tanh(**d), pnn.Linear(16, 3, **d),
                       pnn.LogSoftMax(**d), **d)
    m.init(sample_input=np.zeros((1, 5), np.float32))
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, _jax_model(seed).get_parameters()))
    return m


def _jflat(model):
    return {f"{a}/{b}": np.asarray(v) for a, sub in model.get_parameters().items()
            for b, v in sub.items()}


def _pflat(model):
    return {f"{a}/{b}": v.detach().numpy().copy() for a, sub in model.get_parameters().items()
            for b, v in sub.items()}


class _JHooked(JAbstract):
    """``hook(epoch, index, batch) -> batch or None`` on every train batch."""

    def __init__(self, base, hook):
        self.base, self.hook, self._epoch = base, hook, 1

    def size(self):
        return self.base.size()

    def shuffle(self, epoch=None):
        if epoch is not None:
            self._epoch = int(epoch)
        self.base.shuffle(epoch)

    def data(self, train):
        for i, b in enumerate(self.base.data(train)):
            out = self.hook(self._epoch, i, b) if train else None
            yield b if out is None else out


class _PHooked(PAbstract):
    def __init__(self, base, hook):
        self.base, self.hook, self._epoch = base, hook, 1

    def size(self):
        return self.base.size()

    def shuffle(self, epoch=None):
        if epoch is not None:
            self._epoch = int(epoch)
        self.base.shuffle(epoch)

    def data(self, train):
        for i, b in enumerate(self.base.data(train)):
            out = self.hook(self._epoch, i, b) if train else None
            yield b if out is None else out


JAX = SimpleNamespace(name="jax", nn=jnn, optim=joptim, obs=jobs, r=jres, ser=jser,
                      DataSet=JDataSet, MiniBatch=JMiniBatch, Hooked=_JHooked,
                      Random=JRandom, model=_jax_model, flat=_jflat)
PORT = SimpleNamespace(name="port", nn=pnn, optim=poptim, obs=pobs, r=pres, ser=pser,
                       DataSet=PDataSet, MiniBatch=PMiniBatch, Hooked=_PHooked,
                       Random=RandomGenerator, model=_port_model, flat=_pflat)
PKGS = (JAX, PORT)


def _records(tel, types=RESILIENCE):
    return [{k: v for k, v in r.items() if k not in _TIMES}
            for r in tel.ring.records if r["type"] in types]


def _opt(pkg, ds, iters, lr=0.2, seed=13, **kw):
    model = pkg.model()
    pkg.Random.set_seed(seed)  # after the model: its init sets the JAX seed
    opt = pkg.optim.LocalOptimizer(model, ds, pkg.nn.ClassNLLCriterion(), **kw)
    opt.set_optim_method(pkg.optim.SGD(learningrate=lr, momentum=0.9))
    opt.set_end_when(pkg.optim.Trigger.max_iteration(iters))
    return opt


def _both(run):
    """``run(pkg) -> (outcome, params)`` for each package: equal outcomes,
    parameters within ATOL; returns the port's ``(outcome, params)``."""
    out = {p.name: run(p) for p in PKGS}
    assert out["port"][0] == out["jax"][0], (out["port"][0], out["jax"][0])
    jp, pp = out["jax"][1], out["port"][1]
    if jp is not None:
        assert jp.keys() == pp.keys()
        for k in jp:
            np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=ATOL, err_msg=k)
    return out["port"]


def _clean(pkg, x, y, iters, tmp, batch=8):
    opt = _opt(pkg, pkg.DataSet.array(x, y, batch_size=batch), iters)
    opt.set_checkpoint(str(tmp / f"clean_{pkg.name}"), pkg.optim.Trigger.several_iteration(1))
    return pkg.flat(opt.optimize())


# ------------------------------------------------------------- chaos matrix
SEAMS = ("prefetch", "dispatch", "checkpoint", "checkpoint_load", "validation", "pad_mask")


def _arm(plan, seam):
    if seam == "checkpoint_load":  # the load seam runs in a resume only
        plan.arm("dispatch", at_hit=4)
        plan.arm("checkpoint_load", at_hit=1)
    elif seam == "checkpoint":
        plan.arm("checkpoint", at_hit=3)
    elif seam in ("validation", "pad_mask"):
        plan.arm(seam, at_hit=1)
    else:
        plan.arm(seam, at_hit=4)


@pytest.mark.parametrize("seam", SEAMS)
def test_injected_fault_recovers_bit_equal(seam, tmp_path):
    """One fault at each training seam: both packages recover through the
    same ladder, and each ends bit-equal to its own clean run."""
    x, y = _problem(n=68 if seam == "pad_mask" else 64)  # 68: a 4-row ragged tail

    def run(pkg):
        clean = _clean(pkg, x, y, 10, tmp_path)
        tel = pkg.obs.Telemetry(exporters=[])
        plan = pkg.r.FaultPlan(telemetry=tel)
        _arm(plan, seam)
        ds = (pkg.DataSet.array(x, y, batch_size=8) if seam != "pad_mask" else
              _ragged(pkg, x, y))
        opt = _opt(pkg, ds, 10)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(1))
        opt.set_failure_policy(pkg.r.FailurePolicy(backoff_base_s=0.0))
        opt.set_validation(pkg.optim.Trigger.several_iteration(5),
                           pkg.DataSet.array(x[:16], y[:16], batch_size=8),
                           [pkg.optim.Top1Accuracy()])
        opt.set_telemetry(tel)
        with plan:
            got = pkg.flat(opt.optimize())
        if seam != "pad_mask":
            for k in clean:
                np.testing.assert_array_equal(got[k], clean[k], err_msg=f"{pkg.name} {k}")
        return ((plan.events, _records(tel), opt.optim_method.state["neval"],
                 opt.failure_policy.total_attempts), got)

    (events, recs, neval, attempts), _ = _both(run)
    assert any(e["seam"] == seam for e in events) and attempts >= 1 and neval >= 10
    assert any(r["type"] == "retry" for r in recs)


def _ragged(pkg, x, y):
    from bigdl_tpu.dataset.dataset import SampleToMiniBatch as JS
    from bigdl_tpu_torch.dataset.dataset import SampleToMiniBatch as PS

    if pkg is JAX:
        return JDataSet.array(x, y, transformer=JS(8))
    return PDataSet.array(x, y, transformer=PS(8))


# ------------------------------------------------------------- divergence
def test_nan_rolls_back_backs_off_then_skips(tmp_path):
    """NaN features at (epoch 1, batch 5): the divergence guard rolls back to
    the newest finite checkpoint with the LR halved; the same position
    diverges again and is skipped as poison. The rollback sequence, the
    policy's counters and the final parameters agree."""
    x, y = _problem(n=64)

    def run(pkg):
        def poison(epoch, i, batch):
            if epoch == 1 and i == 5:
                xb = np.asarray(batch.get_input()).copy()
                xb[:] = np.nan
                return pkg.MiniBatch(xb, batch.get_target())
            return None

        tel = pkg.obs.Telemetry(exporters=[])
        opt = _opt(pkg, pkg.Hooked(pkg.DataSet.array(x, y, batch_size=8), poison), 14, lr=0.3,
                   seed=31)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(1))
        opt.set_failure_policy(pkg.r.FailurePolicy(backoff_base_s=0.0))
        opt.set_telemetry(tel)
        got = pkg.flat(opt.optimize())
        pol = opt.failure_policy
        for rec in tel.ring.records:
            obs_report.validate_record(rec)
        return ((_records(tel), dict(pol.counts), sorted(pol.skip_positions),
                 opt.optim_method.state["_lr_scale"], opt.optim_method.state["neval"]), got)

    (recs, counts, skips, scale, neval), got = _both(run)
    assert counts["divergence"] == 1 and counts["poison_batch"] == 1
    assert skips == [(1, 5)] and scale == 0.5 and neval >= 14
    rollback = [r for r in recs if r["type"] == "rollback"]
    assert rollback and rollback[0]["reason"] == "non_finite_loss"
    assert rollback[0]["restored_step"] is not None and rollback[0]["lr_scale"] == 0.5
    assert all(np.isfinite(v).all() for v in got.values())


def test_health_names_the_poisoned_layer_in_the_rollback(tmp_path):
    """A NaN planted in one weight after step 3: with health attached the
    rollback record names the first non-finite layer and the source, as
    the JAX package's does."""
    x, y = _problem(n=64)

    def run(pkg):
        state = {"done": False}

        def poison(epoch, i, batch):
            if epoch == 1 and i == 3 and not state["done"]:
                state["done"] = True
                xb = np.asarray(batch.get_input()).copy()
                xb[0, 0] = np.inf
                return pkg.MiniBatch(xb, batch.get_target())
            return None

        tel = pkg.obs.Telemetry(exporters=[])
        opt = _opt(pkg, pkg.Hooked(pkg.DataSet.array(x, y, batch_size=8), poison), 8)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(1))
        opt.set_failure_policy(pkg.r.FailurePolicy(backoff_base_s=0.0))
        opt.set_health(pkg.obs.HealthConfig(every_n_steps=4))
        opt.set_telemetry(tel)
        got = pkg.flat(opt.optimize())
        return _records(tel, ("rollback",)), got

    recs, _ = _both(run)
    # jax.tree_util's order (keys sorted): the bias row comes first
    assert recs[0]["layer"] == "Linear_0/bias" and recs[0]["source"] == "grads"


# ------------------------------------------------------ snapshot and legacy
def test_retry_before_any_checkpoint_resets_to_the_entry_state(tmp_path):
    """A fault at the 3rd dispatch with no checkpoint written yet: the run
    restarts from the step-0 snapshot (not the drifted state) and ends
    bit-equal to a clean run."""
    x, y = _problem(n=64)

    def run(pkg):
        ref_opt = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 8)
        ref = pkg.flat(ref_opt.optimize())
        tel = pkg.obs.Telemetry(exporters=[])
        opt = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 8)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(100))
        opt.set_failure_policy(pkg.r.FailurePolicy(backoff_base_s=0.0))
        opt.set_telemetry(tel)
        with pkg.r.FaultPlan().arm("dispatch", at_hit=3):
            got = pkg.flat(opt.optimize())
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        return _records(tel), got

    _both(run)


def test_set_retry_times_resumes_and_completes_then_exhausts(tmp_path):
    x, y = _problem(n=64)

    def run(pkg):
        opt = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 10)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(2))
        opt.set_retry_times(2)
        with pkg.r.FaultPlan().arm("dispatch", at_hit=5):
            got = pkg.flat(opt.optimize())
        opt2 = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 10)
        opt2.set_checkpoint(str(tmp_path / (pkg.name + "2")),
                            pkg.optim.Trigger.several_iteration(2))
        opt2.set_retry_times(1)
        with pkg.r.FaultPlan().arm("dispatch", at_hit=3, times=5):
            with pytest.raises(pkg.r.FaultInjected) as e:
                opt2.optimize()
        no_ckpt = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 10)
        no_ckpt.set_retry_times(3)
        with pkg.r.FaultPlan().arm("dispatch", at_hit=2):
            with pytest.raises(pkg.r.FaultInjected):
                no_ckpt.optimize()
        return (opt.optim_method.state["neval"], str(e.value)), got

    _both(run)


# ------------------------------------------------------------- preemption
def test_sigterm_checkpoint_resume_bit_identical(tmp_path):
    x, y = _problem(n=96)

    def run(pkg):
        ckpt = str(tmp_path / pkg.name)
        ref = pkg.flat(_opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 18, seed=24).optimize())
        sent = {"n": 0}

        def kill(epoch, i, batch):
            if sent["n"] == 0 and i == 6:
                sent["n"] += 1
                os.kill(os.getpid(), signal.SIGTERM)
            return None

        tel = pkg.obs.Telemetry(exporters=[])
        opt = _opt(pkg, pkg.Hooked(pkg.DataSet.array(x, y, batch_size=8), kill), 18, seed=24)
        opt.set_checkpoint(ckpt, pkg.optim.Trigger.several_iteration(3))
        opt.set_preemption()
        opt.set_telemetry(tel)
        with pytest.raises(pkg.r.TrainingPreempted) as ei:
            opt.optimize()
        assert ei.value.exit_code == 0 and ei.value.checkpoint_dir == ckpt
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
        step = pkg.ser.latest_checkpoint_step(ckpt)
        assert pkg.ser.verify_checkpoint(ckpt, step) is None
        opt2 = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 18, seed=24)
        opt2.resume(ckpt)
        got = pkg.flat(opt2.optimize())
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        # the step that notices the signal depends on how far the prefetch
        # thread had run ahead: not compared across packages
        recs = [{k: v for k, v in r.items() if k not in ("checkpoint_dir", "step")}
                for r in _records(tel)]
        return recs, got

    recs, _ = _both(run)
    assert recs[0]["type"] == "preempt_checkpoint" and recs[0]["signal"] == int(signal.SIGTERM)


# ------------------------------------------------------------------- stall
def test_stall_note_restarts_from_the_checkpoint(tmp_path):
    x, y = _problem(n=64)

    def run(pkg):
        holder = {}

        def note(epoch, i, batch):
            if epoch == 1 and i == 4 and "done" not in holder:
                holder["done"] = True
                holder["opt"].failure_policy.note_stall({"waited_s": 9.0})
            return None

        tel = pkg.obs.Telemetry(exporters=[])
        opt = _opt(pkg, pkg.Hooked(pkg.DataSet.array(x, y, batch_size=8), note), 10)
        holder["opt"] = opt
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(2))
        opt.set_failure_policy(pkg.r.FailurePolicy(backoff_base_s=0.0))
        opt.set_telemetry(tel)
        got = pkg.flat(opt.optimize())
        return (_records(tel), dict(opt.failure_policy.counts)), got

    (recs, counts), _ = _both(run)
    assert counts["stall"] == 1 and recs[0]["fault_class"] == "stall"


def test_watchdog_stall_feeds_the_policy(tmp_path):
    """The telemetry's watchdog registers the optimizer's forwarder: a
    declared stall reaches the running policy, as in the JAX package."""
    x, y = _problem(n=32)

    def run(pkg):
        wd = pkg.obs.StallWatchdog(poll_interval_s=60.0)
        tel = pkg.obs.Telemetry(exporters=[], watchdog=wd)
        opt = _opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 2)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(1))
        opt.set_failure_policy(pkg.r.FailurePolicy())
        opt.set_telemetry(tel)
        opt.optimize()
        return (opt._on_watchdog_stall in wd._callbacks, tel._on_stall in wd._callbacks), None

    assert _both(run)[0] == (True, True)


# ----------------------------------------------------- cooperative skips
def test_pipeline_never_builds_a_poisoned_position(tmp_path):
    """With a ``DataPipeline`` the policy's skip positions reach
    ``data(skip_positions=)``: the poisoned chunk is never transformed, and
    the run still ends as the JAX package's."""
    from bigdl_tpu.dataset.pipeline import DataPipeline as JPipe
    from bigdl_tpu_torch.dataset.pipeline import DataPipeline as PPipe

    x, y = _problem(n=64)

    def run(pkg):
        pipe = (JPipe if pkg is JAX else PPipe)(pkg.DataSet.array(x, y, batch_size=8),
                                               num_workers=2)
        opt = _opt(pkg, pipe, 12)
        opt.set_checkpoint(str(tmp_path / pkg.name), pkg.optim.Trigger.several_iteration(1))
        opt.set_failure_policy(pkg.r.FailurePolicy(backoff_base_s=0.0))
        # the 3rd batch's prefetch fails, and again on the replay: the same
        # position twice is poison, skipped
        with pkg.r.FaultPlan().arm("prefetch", at_hit=3, times=2):
            got = pkg.flat(opt.optimize())
        pol = opt.failure_policy
        return (dict(pol.counts), sorted(pol.skip_positions),
                opt.optim_method.state["neval"]), got

    counts, skips, neval = _both(run)[0]
    assert counts["poison_batch"] == 1 and skips and neval >= 12


# ---------------------------------------------------------------- donation
@pytest.mark.parametrize("flat", [False, True])
def test_donate_false_keeps_pre_step_tensors_and_the_bits(flat):
    """``donate=False``: the numbers are the donated run's to the bit, and a
    tensor taken from a parameter before the fit keeps its values (the
    JAX package's undonated inputs stay readable)."""
    x, y = _problem(n=32)

    def fit(donate):
        opt = _opt(PORT, PDataSet.array(x, y, batch_size=8), 6, donate=donate,
                   flat_update=flat)
        m = opt.model
        pre = {k: v.detach() for k, v in _leaves(m).items()}
        pre_vals = {k: v.clone() for k, v in pre.items()}
        opt.optimize()
        return _pflat(m), pre, pre_vals

    a, pre_a, vals_a = fit(True)
    b, pre_b, vals_b = fit(False)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert all(torch.equal(pre_b[k], vals_b[k]) for k in pre_b)  # kept
    if not flat:  # the flat layout rebinds the parameters at optimize() anyway
        assert not all(torch.equal(pre_a[k], vals_a[k]) for k in pre_a)  # updated in place


def _leaves(m):
    return {f"{a}/{b}": v for a, sub in m.get_parameters().items() for b, v in sub.items()}


# --------------------------------------------------------------- postmortem
def test_terminal_fault_leaves_a_bundle_both_packages_verify(tmp_path):
    """The budget spent: the fault leaves ``optimize()`` and a port bundle
    verifies with the JAX package's ``verify_bundle`` and renders in
    ``tools/postmortem.py``."""
    from bigdl_tpu.obs import blackbox as jbb
    from bigdl_tpu_torch.obs import blackbox as pbb

    spec = importlib.util.spec_from_file_location("pm_tool", REPO / "tools" / "postmortem.py")
    pm_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pm_tool)
    x, y = _problem(n=64)
    Engine.set_run_dir(str(tmp_path / "run"))
    try:
        tel = pobs.Telemetry(exporters=[])
        opt = _opt(PORT, PDataSet.array(x, y, batch_size=8), 10)
        opt.set_checkpoint(str(tmp_path / "ckpt"), poptim.Trigger.several_iteration(1))
        opt.set_failure_policy(pres.FailurePolicy(backoff_base_s=0.0, max_total=0))
        opt.set_telemetry(tel)
        with pres.FaultPlan(telemetry=tel).arm("checkpoint", at_hit=3):
            with pytest.raises(pres.FaultInjected):
                opt.optimize()
    finally:
        Engine.set_run_dir(None)
        pbb.disarm_crash_handler()  # the sink under the run dir armed it
    root = tmp_path / "run" / "postmortem"
    bundles = sorted(p for p in root.iterdir() if (p / "MANIFEST.json").exists())
    assert bundles
    bundle = str(bundles[-1])
    loaded = pbb.load_bundle(bundle)
    jbb.verify_bundle(bundle)
    pm_tool.verify_bundle(bundle)
    assert loaded["reason"]["error"]["class"] == "FaultInjected"
    live = [r for r in tel.ring.records if r["type"] == "step"]
    assert loaded["rings"]["step"][-1]["iteration"] == live[-1]["iteration"]
    assert any(r["seam"] == "checkpoint" for r in loaded["rings"]["fault_injected"])
    assert loaded["checkpoint"]["verify"] is None
    pm = [r for r in tel.ring.records if r["type"] == "postmortem"]
    assert pm and pm[-1]["bundle"] == bundle
    obs_report.validate_record(pm[-1])
    report = pm_tool.render(pm_tool.load_bundle(bundle))
    assert "FaultInjected" in report and "checkpoint" in report
