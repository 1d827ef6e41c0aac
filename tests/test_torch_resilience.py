"""The port's resilience runtime against the JAX package's, on the CPU: the
parts that need no training loop.

Each scenario of ``tests/test_resilience.py`` (the failure policy, the
checkpoint manifest's finiteness), ``tests/test_chaos_matrix.py`` (the
plan's determinism and scope) and the preemption guard runs through both
packages' objects in one test, and the outcomes must be equal: the
policy's decisions and its seeded backoff schedule float for float, the
plan's ``events`` for each seam x kind, the typed errors' messages and
fields. Every class and function of the ported modules exists at the
port's path (the walk at the end).
"""

import importlib
import inspect
import signal
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import bigdl_tpu.resilience as jres
import bigdl_tpu.utils.serialization as jser
import bigdl_tpu_torch.resilience as pres
import bigdl_tpu_torch.utils.serialization as pser
from bigdl_tpu.obs import trace as jtrace
from bigdl_tpu_torch.obs import trace as ptrace

JAX = SimpleNamespace(name="jax", r=jres, trace=jtrace, ser=jser)
PORT = SimpleNamespace(name="port", r=pres, trace=ptrace, ser=pser)
PKGS = (JAX, PORT)


def both(scenario, *args):
    """``scenario(pkg, *args)`` for each package; the port's outcome must
    equal the JAX package's. Returns the port's."""
    out = {p.name: scenario(p, *args) for p in PKGS}
    assert out["port"] == out["jax"], out
    return out["port"]


def _decision(d):
    return (d.retry, d.fault_class, d.attempt, d.total_attempts, d.backoff_s, d.reason,
            d.skip_position, dict(d.extra))


# ------------------------------------------------------------------ policy
def test_classification_and_poison_on_second_hit():
    def scenario(pkg):
        pol = pkg.r.FailurePolicy(backoff_base_s=0.0)
        out = [_decision(pol.on_failure(RuntimeError("io"), position=(1, 3))),
               _decision(pol.on_failure(RuntimeError("io"), position=(1, 3)))]
        return out, sorted(pol.skip_positions), dict(pol.counts)

    out = both(scenario)
    assert out[0][0][1] == "transient" and out[0][1][1] == "poison_batch"
    assert out[1] == [(1, 3)]


def test_divergence_and_stall_classes_and_lr_scale():
    def scenario(pkg):
        pol = pkg.r.FailurePolicy(backoff_base_s=0.0)
        d1 = pol.on_failure(pkg.r.DivergenceError(float("nan"), 7, position=(2, 1),
                                                  layer="Linear_0/weight", source="grads"),
                            position=(2, 1))
        d2 = pol.on_failure(pkg.r.StallEscalation({"waited_s": 3.0}), position=None)
        return _decision(d1), _decision(d2), pol.lr_scale(), pol.total_attempts

    out = both(scenario)
    assert out[0][1] == "divergence" and out[0][7] == {"layer": "Linear_0/weight",
                                                      "source": "grads"}
    assert out[1][1] == "stall" and out[2] == 0.5


def test_budgets_exhaust_per_class_and_in_total():
    def scenario(pkg):
        pol = pkg.r.FailurePolicy(budgets={"transient": 2}, max_total=3, backoff_base_s=0.0)
        per_class = [_decision(pol.on_failure(RuntimeError(str(i)), position=(1, i)))
                     for i in range(3)]
        pol.reset()
        pol2 = pkg.r.FailurePolicy(max_total=1, backoff_base_s=0.0)
        total = [_decision(pol2.on_failure(RuntimeError(str(i)), position=(1, i)))
                 for i in range(2)]
        return per_class, total

    per_class, total = both(scenario)
    assert [d[0] for d in per_class] == [True, True, False]
    assert per_class[2][5] == "class budget exhausted"
    assert total[1][5] == "total retry budget exhausted"


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_schedule_is_the_same_floats(seed):
    """The seeded jitter: exponential, capped, and float for float the JAX
    package's (both draw numpy's default_rng(seed))."""
    def scenario(pkg):
        pol = pkg.r.FailurePolicy(budgets={"transient": 12}, backoff_base_s=0.25,
                                  backoff_max_s=4.0, jitter=0.3, seed=seed)
        return [pol.on_failure(RuntimeError("x"), position=(1, i)).backoff_s for i in range(12)]

    sched = both(scenario)
    assert sched[0] >= 0.25 and max(sched) <= 4.0 * 1.3 and sched[4] > sched[0]


def test_skip_window_action():
    def scenario(pkg):
        pol = pkg.r.FailurePolicy(divergence_action="skip_window", skip_window=3,
                                  backoff_base_s=0.0)
        d = pol.on_failure(pkg.r.DivergenceError(float("inf"), 4, position=(1, 2)),
                           position=(1, 2))
        return _decision(d), sorted(pol.skip_positions), pol.lr_scale()

    out = both(scenario)
    assert out[1] == [(1, 2), (1, 3), (1, 4)] and out[2] == 1.0


def test_legacy_shim_never_skips_and_never_escalates():
    def scenario(pkg):
        pol = pkg.r.FailurePolicy.legacy(2)
        ds = [_decision(pol.on_failure(RuntimeError("x"), position=(1, 0))) for _ in range(3)]
        pol.note_stall({"waited_s": 1})
        return ds, sorted(pol.skip_positions), pol.divergence_guard, pol.stall_pending()

    ds, skips, guard, stall = both(scenario)
    assert [d[0] for d in ds] == [True, True, False] and skips == [] and not guard
    assert not stall


def test_stall_notes_escalate_after_the_threshold_and_rearm():
    def scenario(pkg):
        pol = pkg.r.FailurePolicy(stall_escalate_after=2)
        pol.note_stall({"waited_s": 1.0})
        first = pol.stall_pending()
        pol.note_stall({"waited_s": 2.0})
        second = pol.stall_pending()
        info = pol.take_stall()
        return first, second, info, pol.stall_pending()

    assert both(scenario) == (False, True, {"waited_s": 2.0}, False)


def test_policy_rejects_bad_arguments_the_same():
    def scenario(pkg):
        msgs = []
        for kw in ({"divergence_action": "retry"}, {"budgets": {"bogus": 1}}):
            with pytest.raises(ValueError) as e:
                pkg.r.FailurePolicy(**kw)
            msgs.append(str(e.value))
        return msgs

    both(scenario)


# ------------------------------------------------------------------ errors
def test_typed_errors_messages_and_fields():
    def scenario(pkg):
        r = pkg.r
        errs = [r.DivergenceError(float("nan"), 5, position=(1, 4), layer="a/b", source="grads"),
                r.DivergenceError(float("inf"), 2, source="loss"),
                r.StallEscalation({"waited_s": 9}),
                r.TrainingPreempted(15, step=12, checkpoint_dir="/x"),
                r.TrainingPreempted(15),
                r.FaultInjected("dispatch", 3),
                r.CheckpointCorrupt("/d", 4, "truncated")]
        return [(type(e).__name__, str(e), getattr(e, "exit_code", None)) for e in errs]

    out = both(scenario)
    assert out[3][2] == 0


# ------------------------------------------------------------------- chaos
SEAM_NAMES = ("prefetch", "pad_mask", "dispatch", "checkpoint", "checkpoint_load",
              "validation", "place_batch") + tuple(jres.SERVING_SEAMS)


@pytest.mark.parametrize("kind", ["raise", "delay", "callback"])
@pytest.mark.parametrize("seam", SEAM_NAMES)
def test_plan_events_for_each_seam_and_kind(seam, kind):
    """Hits counted per seam, the window [at_hit, at_hit + times), the
    events in order; a raise is ``FaultInjected``; spans and bare fault
    points both report."""
    def scenario(pkg):
        called = []
        plan = pkg.r.FaultPlan().arm(seam, kind=kind, at_hit=2, times=2, delay_s=0.0,
                                     callback=called.append if kind == "callback" else None)
        raised = []
        with plan:
            for i in range(5):
                try:
                    if i % 2:
                        with pkg.trace.span(seam):
                            pass
                    else:
                        pkg.trace.fault_point(seam)
                except pkg.r.FaultInjected as e:
                    raised.append((e.seam, e.hit, e.kind, str(e)))
        return plan.events, plan.hits(seam), raised, called, pkg.trace.fault_hook() is None

    events, hits, raised, called, cleared = both(scenario)
    assert [e["hit"] for e in events] == [2, 3] and hits == 5 and cleared
    assert (len(raised) == 2) == (kind == "raise")
    assert called == ([2, 3] if kind == "callback" else [])


def test_plan_custom_exception_and_two_plans_cannot_stack():
    def scenario(pkg):
        plan = pkg.r.FaultPlan().arm("dispatch", exc=lambda: KeyError("k"))
        with plan:
            with pytest.raises(KeyError):
                pkg.trace.fault_point("dispatch")
            with pytest.raises(RuntimeError, match="already installed") as e:
                pkg.r.FaultPlan().install()
        return str(e.value), plan.events

    both(scenario)


def test_fault_spec_validation():
    def scenario(pkg):
        msgs = []
        for kw in ({"kind": "explode"}, {"kind": "callback"}, {"at_hit": 0}):
            with pytest.raises(ValueError) as e:
                pkg.r.FaultSpec("dispatch", **kw)
            msgs.append(str(e.value))
        return msgs

    both(scenario)


def test_plan_reports_to_telemetry():
    from bigdl_tpu.obs import Telemetry as JTelemetry
    from bigdl_tpu_torch.obs import Telemetry as PTelemetry

    def scenario(pkg):
        tel = (JTelemetry if pkg is JAX else PTelemetry)(exporters=[])
        plan = pkg.r.FaultPlan(telemetry=tel).arm("checkpoint", kind="delay", delay_s=0.0)
        with plan:
            pkg.trace.fault_point("checkpoint")
        return [{k: v for k, v in r.items() if k in ("type", "seam", "kind", "hit")}
                for r in tel.ring.records]

    assert both(scenario) == [{"type": "fault_injected", "seam": "checkpoint", "kind": "delay",
                               "hit": 1}]


# -------------------------------------------------------------- preemption
def test_preemption_guard_flags_and_restores_the_handler():
    assert threading.current_thread() is threading.main_thread()

    def scenario(pkg):
        before = signal.getsignal(signal.SIGUSR1)
        guard = pkg.r.PreemptionGuard(signals=(signal.SIGUSR1,))
        with guard:
            pending0 = guard.pending()
            signal.raise_signal(signal.SIGUSR1)
            pending = guard.pending()
            guard.clear()
            cleared = guard.pending()
        return pending0, int(pending), cleared, signal.getsignal(signal.SIGUSR1) == before

    assert both(scenario) == (None, int(signal.SIGUSR1), None, True)


def test_preemption_guard_off_the_main_thread_degrades():
    def scenario(pkg):
        out = {}

        def run():
            guard = pkg.r.PreemptionGuard().install()
            out["installed"] = guard._installed
            guard.uninstall()

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        return out

    assert both(scenario) == {"installed": False}


# -------------------------------------------------------------- checkpoints
def test_require_finite_skips_a_nan_checkpoint(tmp_path):
    """A port checkpoint with NaN params is skipped by both packages'
    ``load_checkpoint(require_finite=True)`` and quarantined by both."""
    import torch

    d = str(tmp_path)
    for step, val in ((2, 1.0), (3, float("nan"))):
        pser.save_checkpoint(d, step=step, params={"w": torch.full((3,), val)},
                             optim_slots={}, optim_state={"neval": step, "epoch": 1,
                                                          "_rng_seed": 1, "_rng_counter": 0},
                             model_state={})

    def scenario(pkg):
        p, _, host, _ = pkg.ser.load_checkpoint(d, require_finite=True)
        plain = pkg.ser.load_checkpoint(d)[2]["neval"]
        return int(host["neval"]), np.asarray(p["w"]).tolist(), int(plain)

    assert both(scenario) == (2, [1.0, 1.0, 1.0], 3)
    assert pser.quarantine_nonfinite(d) == [3]
    assert jser.latest_checkpoint_step(d) == 2


# --------------------------------------------------------------------- walk
_WALK = {
    "resilience.errors": (),
    "resilience.policy": (),
    "resilience.chaos": (),
    "resilience.preemption": (),
    "resilience.elastic": (),
    "obs.trace": (),
    "obs.telemetry": (),
    "obs.health": (),
    "obs.export": (),
    "utils.aot": ("export_jit",),
    "serving.artifacts": (),
    "obs.perf": (),
    "obs.profiler": (),
    "obs.blackbox": (),
    "obs.watchdog": (),
    "obs.fleet": (),
    "visualization.tb": (),
    "visualization.summary": (),
    "optim.metrics": (),
    "ml.estimator": (),
    "tensor.tensor": (),
    "utils.shape": (),
    "analysis.concurrency": (),
    "analysis.lock_tracer": (),
    "nn.ops": (),
    "nn.keras.converter": (),
    "utils.caffe": (),
    "utils.tf_loader": (),
    "utils.tf_session": (),
    "utils.tf_saver": (),
    "utils.torch_file": (),
}
# What the port leaves out, and why (ROADMAP lists each): aot's export_jit
# serializes a jitted program, which the eager port has not.


@pytest.mark.parametrize("mod", sorted(_WALK))
def test_every_jax_symbol_has_a_port(mod):
    """Every public class and function defined in ``bigdl_tpu/<mod>.py``
    exists at the port's path, less the listed exceptions."""
    jm = importlib.import_module(f"bigdl_tpu.{mod}")
    pm = importlib.import_module(f"bigdl_tpu_torch.{mod}")
    names = [n for n, v in vars(jm).items()
             if not n.startswith("_") and (inspect.isclass(v) or inspect.isfunction(v))
             and getattr(v, "__module__", "") == jm.__name__]
    if mod == "optim.metrics":
        names = ["Metrics"]
    assert names
    missing = [n for n in names if n not in _WALK[mod] and not hasattr(pm, n)]
    assert not missing, f"{mod}: {missing}"


def test_ml_tensor_and_shape_exports_match():
    """``bigdl_tpu.ml``, ``bigdl_tpu.tensor`` and the ``Shape`` names of
    ``bigdl_tpu.utils`` at the port's paths."""
    import bigdl_tpu.ml as jml
    import bigdl_tpu.tensor as jtensor
    import bigdl_tpu_torch.ml as pml
    import bigdl_tpu_torch.tensor as ptensor
    import bigdl_tpu_torch.utils as putils

    assert set(jml.__all__) == set(pml.__all__)
    assert set(jtensor.__all__) == set(ptensor.__all__)
    assert {"Shape", "SingleShape", "MultiShape", "T", "Table", "Engine", "RandomGenerator",
            "set_seed"} <= set(putils.__all__)


def test_package_exports_match_less_the_next_slice():
    import bigdl_tpu.obs as jobs
    import bigdl_tpu_torch.obs as pobs

    assert set(jobs.__all__) <= set(pobs.__all__)  # the elastic names too since 9b
    assert set(jres.__all__) <= set(pres.__all__)
