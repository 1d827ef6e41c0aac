"""The port's observability layer against the JAX package's, on the CPU:
span tracing, the telemetry stream, the stall watchdog, the fleet identity
and heartbeat files, the TensorBoard event files and the run directory.

Each scenario of ``tests/test_trace.py`` and ``tests/test_obs.py`` that
this slice covers runs through both packages in one test, and the outcomes
must be equal: trace and span ids (both derive them from the same fleet
identity and counters), sampling verdicts, the emitted span chains, the
record types and their fields other than times and memory, the watchdog's
decisions under a fake clock. The files each package writes are read by
the other's reader (heartbeats, event files), and every port record passes
``tools/obs_report.py``'s validator.
"""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import bigdl_tpu.obs as jobs
import bigdl_tpu.obs.fleet as jfleet
import bigdl_tpu.obs.trace as jtrace
import bigdl_tpu.visualization as jviz
import bigdl_tpu_torch.obs as pobs
import bigdl_tpu_torch.obs.fleet as pfleet
import bigdl_tpu_torch.obs.trace as ptrace
import bigdl_tpu_torch.visualization as pviz
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("obs_report", REPO / "tools" / "obs_report.py")
obs_report = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = obs_report
_spec.loader.exec_module(obs_report)

JAX = SimpleNamespace(name="jax", obs=jobs, trace=jtrace, fleet=jfleet, viz=jviz, Engine=JEngine)
PORT = SimpleNamespace(name="port", obs=pobs, trace=ptrace, fleet=pfleet, viz=pviz,
                       Engine=Engine)
PKGS = (JAX, PORT)
_VOLATILE = {"ts", "memory", "hbm_peak_bytes", "devices", "fused_kernels", "xla_flags",
             "xla_flags_env_pinned", "compile_cache_dir", "run_dir", "host"}


def both(scenario, *args):
    out = {p.name: scenario(p, *args) for p in PKGS}
    assert out["port"] == out["jax"], out
    return out["port"]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in _VOLATILE}


@pytest.fixture(autouse=True)
def _fresh_trace_state(monkeypatch):
    """Both packages' id counters and identity bases from the same start,
    sampling at its default, nothing bound afterwards."""
    prev = {}
    for pkg in PKGS:
        monkeypatch.setattr(pkg.trace, "_id_seq", 0)
        monkeypatch.setattr(pkg.trace, "_id_base", None)
        prev[pkg.name] = pkg.trace.configure(sample_rate=0.0)
    yield
    for pkg in PKGS:
        pkg.trace.configure(**prev[pkg.name])
        pkg.trace.bind_collector(None)
        pkg.trace.bind_context(None)


@pytest.fixture
def _no_run_dir(monkeypatch):
    monkeypatch.delenv("BIGDL_RUN_DIR", raising=False)
    prev = JEngine._state.run_dir
    JEngine._state.run_dir = None
    Engine.set_run_dir(None)
    yield
    JEngine._state.run_dir = prev
    Engine.set_run_dir(None)
    from bigdl_tpu_torch.obs import blackbox

    blackbox.disarm_crash_handler()  # a sink under a run dir armed it


# ------------------------------------------------------------------- trace
def test_context_ids_are_the_same_in_both_packages():
    def scenario(pkg):
        a = pkg.trace.new_context()
        b = a.child()
        keyed = pkg.trace.new_context(key=("pipeline", 2, 5))
        return (a.to_fields(), b.to_fields(), keyed.trace_id, keyed.sampled, repr(b))

    out = both(scenario)
    assert out[1]["parent_id"] == out[0]["span_id"]


@pytest.mark.parametrize("rate", [0.0, 0.25, 1.0])
def test_sampling_is_deterministic_and_periodic(rate):
    def scenario(pkg):
        prev = pkg.trace.configure(sample_rate=rate)
        try:
            keyed = [pkg.trace.new_context(key=("c", i)).sampled for i in range(16)]
            return [pkg.trace.new_context().sampled for _ in range(16)], keyed, \
                pkg.trace.sampling()
        finally:
            pkg.trace.configure(**prev)

    plain, keyed, cfg = both(scenario)
    assert sum(plain) == {0.0: 0, 0.25: 4, 1.0: 16}[rate]


def test_nested_spans_emit_the_parent_chain_and_close_on_exceptions():
    def scenario(pkg):
        sink = []
        col = pkg.trace.SpanCollector()
        col.on_span = sink.append
        pkg.trace.bind_collector(col)
        root = pkg.trace.new_context(sampled=True)
        with pkg.trace.context_scope(root):
            with pkg.trace.span("outer"):
                with pkg.trace.span("inner"):
                    pass
                with pytest.raises(KeyError):
                    with pkg.trace.span("boom"):
                        raise KeyError("x")
            pkg.trace.emit_span("dispatch", 0.5, root.child(), iteration=3)
        pkg.trace.add_sample("dispatch", 0.25)
        agg = {k: v["n"] for k, v in col.drain().items()}
        pkg.trace.bind_collector(None)
        return ([{k: v for k, v in r.items() if k not in ("dur_s", "thread")} for r in sink],
                agg, col.drain())

    sink, agg, empty = both(scenario)
    assert [r["name"] for r in sink] == ["inner", "boom", "outer", "dispatch"]
    assert sink[0]["parent_id"] == sink[2]["span_id"]
    assert agg == {"outer": 1, "outer/inner": 1, "outer/boom": 1, "dispatch": 1} and empty == {}


def test_unsampled_or_no_context_emits_nothing_but_still_times():
    def scenario(pkg):
        sink = []
        col = pkg.trace.SpanCollector()
        col.on_span = sink.append
        pkg.trace.bind_collector(col)
        with pkg.trace.context_scope(pkg.trace.new_context(sampled=False)):
            with pkg.trace.span("a"):
                pass
        with pkg.trace.span("b"):
            pass
        pkg.trace.bind_collector(None)
        with pkg.trace.span("c"):  # detached: only the profiler range
            pass
        return sink, sorted(col.peek())

    assert both(scenario) == ([], ["a", "b"])


def test_span_names_are_torch_profiler_ranges():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ptrace.span("checkpoint"):
            torch.ones(2).sum()
        with ptrace.step_annotation(7):
            pass
    names = {e.name for e in prof.events()}
    assert {"checkpoint", "train#7"} <= names


# --------------------------------------------------------------- telemetry
def _emit_all(pkg, tel):
    tel.step(iteration=3, records=8, wall_s=0.25, epoch=1, loss=1.5, lr=0.1,
             records_per_sec=32.0, dispatch_s=0.01, input_wait_s=0.002, input_qdepth=2,
             model_flops=1e9)
    tel.perf(iteration=8, window=8, breakdown={"compute_s": 0.2, "comms_s": None,
                                               "input_s": 0.0, "host_s": 0.01}, epoch=1,
             mfu=None)
    tel.health(iteration=3, epoch=1, stride=1, **{"global": {
        "grad_norm": 1.0, "weight_norm": 2.0, "update_ratio": 0.01, "nonfinite_grads": 0,
        "nonfinite_params": 0}})
    tel.warn(reason="update_ratio", iteration=4, ratio=0.5)
    tel.compile_event(iteration=1, seconds=0.5, count=1, cache_hit=False)
    tel.retry_event(attempt=1, fault_class="transient", backoff_s=0.5, error="E()",
                    skip_position=[1, 2])
    tel.rollback_event(reason="non_finite_loss", restored_step=4, iteration=6, lr_scale=0.5,
                       layer="a/b", source="grads")
    tel.preempt_event(signal=15, step=9, checkpoint_dir="/c")
    tel.fault_injected_event(seam="dispatch", kind="raise", hit=2)
    tel.span_record({"name": "x", "trace_id": "t", "span_id": "s", "dur_s": 0.1})


def test_record_types_and_fields_equal_the_jax_package(_no_run_dir):
    def scenario(pkg):
        tel = pkg.obs.Telemetry(exporters=[])
        tel.run_started("LocalOptimizer", warm_start=None, low_precision=None)
        _emit_all(pkg, tel)
        tel.run_ended("LocalOptimizer", iterations=9)
        recs = tel.ring.records
        for r in recs:
            obs_report.validate_record(r)
        return [_strip(r) for r in recs], tel.compile_count

    recs, compiles = both(scenario)
    assert [r["type"] for r in recs][:3] == ["meta", "step", "perf"] and compiles == 1


def test_memory_stats_none_on_the_cpu():
    assert pobs.device_memory_stats() is None and jobs.device_memory_stats() is None


def test_exporter_fanout_and_summary_exporter(tmp_path, _no_run_dir):
    """JSONL, ring and the summary bridge get the same step records; the
    summary's event file reads back through both packages' readers."""
    def scenario(pkg):
        summ = pkg.viz.TrainSummary(str(tmp_path / pkg.name), "app")
        path = tmp_path / f"{pkg.name}.jsonl"
        tel = pkg.obs.Telemetry(exporters=[pkg.obs.JsonlExporter(str(path)),
                                           pkg.obs.SummaryExporter(summ)])
        for i in range(3):
            tel.step(iteration=i + 1, records=4, wall_s=0.5, loss=2.0 - i, lr=0.1,
                     records_per_sec=8.0)
        tel.warn(reason="x")
        tel.flush()
        lines = [_strip(r) for r in obs_report.load(str(path))]
        d = str(tmp_path / pkg.name / "app" / "train")
        out = (lines == [_strip(r) for r in tel.ring.records], summ.read_scalar("Loss"),
               [(e["step"], e["scalars"]) for e in jviz.read_events(d)],
               [(e["step"], e["scalars"]) for e in pviz.read_events(d)])
        tel.close()
        return out

    same, loss, jread, pread = both(scenario)
    assert same and loss == [(1, 2.0), (2, 1.0), (3, 0.0)] and jread == pread


def test_event_files_are_byte_compatible(tmp_path):
    """An event encoded by the port is the JAX package's bytes (the CRC is
    the native host library's), and each package reads the other's file."""
    from bigdl_tpu.visualization import tb as jtb
    from bigdl_tpu_torch.visualization import tb as ptb

    ev = ptb.encode_event(12.5, step=3, summary=ptb.encode_scalar_summary("Loss", 0.25))
    assert ev == jtb.encode_event(12.5, step=3, summary=jtb.encode_scalar_summary("Loss", 0.25))
    h = np.linspace(-2, 3, 50)
    assert ptb.encode_histogram_summary("w", h) == jtb.encode_histogram_summary("w", h)
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert ptb.crc32c(data) == jtb._py_crc32c(data) == ptb._py_crc32c(data)
    for writer, reader in ((pviz, jviz), (jviz, pviz)):
        d = tmp_path / writer.__name__
        s = writer.ValidationSummary(str(d), "run")
        s.add_scalar("Top1Accuracy", 0.75, 10)
        s.add_histogram("w", np.arange(5.0), 10)
        s.close()
        evs = reader.read_events(str(d / "run" / "validation"))
        assert [(e["step"], e["scalars"]) for e in evs if e["scalars"]] == [
            (10, {"Top1Accuracy": 0.75})]


def test_metrics_time_records_despite_an_exception():
    from bigdl_tpu.optim.metrics import Metrics as JMetrics
    from bigdl_tpu_torch.optim.metrics import Metrics as PMetrics

    for M in (JMetrics, PMetrics):
        m = M()
        with pytest.raises(ValueError):
            with m.time("step"):
                raise ValueError
        m.add("step", 1.0)
        assert m._counts["step"] == 2 and "step" in repr(m)


# ---------------------------------------------------------------- watchdog
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_stall_watchdog_decisions_under_a_fake_clock():
    def scenario(pkg):
        clock, seen = _Clock(), []
        wd = pkg.obs.StallWatchdog(k=3.0, min_timeout_s=1.0, window=4, on_stall=seen.append,
                                   clock=clock, first_step_timeout_s=None)
        out = [wd.check()]
        wd._started_at = clock()  # start() without its thread
        for d in (0.5, 0.5, 1.0):
            clock.t += d
            wd.notify_step(d)
        out += [wd.estimate_s(), wd.deadline_s()]
        clock.t += 1.4
        out.append(wd.check())
        clock.t += 0.2
        out.append(wd.check())
        out.append(wd.check())  # once a stall
        wd.notify_step(0.5)
        clock.t += 10
        out.append(wd.check())
        return out, seen, wd.stall_count

    out, seen, count = both(scenario)
    assert out[0] is None and out[3] is None and out[4]["waited_s"] == 1.6 and out[5] is None
    assert count == 2 and len(seen) == 2


def test_first_step_timeout_and_restart_between_runs():
    def scenario(pkg):
        clock = _Clock()
        wd = pkg.obs.StallWatchdog(first_step_timeout_s=5.0, clock=clock,
                                   poll_interval_s=60.0)
        wd.start()
        clock.t += 6
        first = wd.check()
        wd.notify_step(0.1)
        wd.stop()
        clock.t += 1000
        wd.start()  # a new run: the idle gap is no stall
        gap = wd.check()
        wd.stop()
        return first, gap

    first, gap = both(scenario)
    assert first["steps_completed"] == 0 and gap is None


def test_stall_record_reaches_the_stream(_no_run_dir):
    def scenario(pkg):
        clock = _Clock()
        wd = pkg.obs.StallWatchdog(min_timeout_s=0.5, clock=clock)
        tel = pkg.obs.Telemetry(exporters=[], watchdog=wd)
        wd.notify_step(0.01)
        clock.t += 2
        wd.check()
        return [_strip(r) for r in tel.ring.records if r["type"] == "stall"]

    assert both(scenario)[0]["waited_s"] == 2.0


# ------------------------------------------------------------------- fleet
def test_process_identity_overrides(monkeypatch):
    monkeypatch.setenv("BIGDL_PROCESS_INDEX", "3")
    monkeypatch.setenv("BIGDL_PROCESS_COUNT", "4")
    monkeypatch.setenv("BIGDL_HOST_TAG", "h7")
    assert pfleet.process_identity() == jfleet.process_identity() == {
        "process_index": 3, "process_count": 4, "host": "h7"}
    monkeypatch.setenv("BIGDL_PROCESS_INDEX", "x")
    assert pfleet.process_identity()["process_index"] == 0


def test_heartbeat_files_cross_read(tmp_path):
    ident = {"process_index": 1, "process_count": 2, "host": "h"}
    pfleet.write_heartbeat(str(tmp_path), identity=ident, step=5, epoch=1, wall_s=0.5,
                           summary={"type": "step"}, clock=lambda: 10.0)
    jfleet.write_heartbeat(str(tmp_path), identity=dict(ident, process_index=0), step=4,
                           leaving=True, clock=lambda: 11.0)
    assert jfleet.read_heartbeats(str(tmp_path)) == pfleet.read_heartbeats(str(tmp_path))
    beats = pfleet.read_heartbeats(str(tmp_path))
    assert beats[1]["step"] == 5 and beats[0]["leaving"] is True
    (tmp_path / "fleet" / "p9.hb").write_text("{torn")
    assert sorted(pfleet.read_heartbeats(str(tmp_path))) == [0, 1]


def test_telemetry_under_a_run_dir_writes_jsonl_and_heartbeats(tmp_path, _no_run_dir):
    Engine.set_run_dir(str(tmp_path))
    try:
        tel = pobs.Telemetry()
        tel.run_started("LocalOptimizer")
        tel.step(iteration=1, records=4, wall_s=0.1, epoch=1, loss=1.0)
        tel.run_ended("LocalOptimizer")
        tel.close()
    finally:
        Engine.set_run_dir(None)
    recs = obs_report.load(str(tmp_path / "telemetry" / "p0.jsonl"))
    assert [r["type"] for r in recs] == ["meta", "step", "meta"]
    beats = jfleet.read_heartbeats(str(tmp_path))
    assert beats[0]["leaving"] is True and beats[0]["process_index"] == 0


def test_run_dir_defaults_for_checkpoints_and_profiles(tmp_path, _no_run_dir, monkeypatch):
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Linear
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger

    opt = LocalOptimizer(Linear(2, 2, device="cpu"),
                         DataSet.array(np.zeros((4, 2), np.float32), np.zeros(4, np.int32),
                                       batch_size=2), ClassNLLCriterion())
    with pytest.raises(ValueError, match="run dir"):
        opt.set_checkpoint(trigger=Trigger.every_epoch())
    with pytest.raises(ValueError, match="run dir"):
        opt.set_profile()
    monkeypatch.setenv("BIGDL_RUN_DIR", str(tmp_path / "env"))
    assert Engine.run_dir() == str(tmp_path / "env")
    opt.set_checkpoint(trigger=Trigger.every_epoch()).set_profile()
    assert opt.checkpoint_path == str(tmp_path / "env" / "checkpoints")
    assert opt._profile["dir"] == str(tmp_path / "env" / "profile")


# ----------------------------------------------------- a fit's whole stream
def test_fit_stream_fields_equal_the_jax_package(_no_run_dir):
    """The LM-free toy fit of ``test_torch_resilience_training`` with a
    telemetry sink: the same record types in the same order, the step
    records' keys equal (the port adds no key and drops none; the JAX
    package's ``compile`` records have no counterpart on the CPU), losses
    within 1e-5, and every port record valid."""
    import test_torch_resilience_training as T

    x, y = T._problem(n=32)

    def run(pkg):
        tel = pkg.obs.Telemetry(exporters=[])
        opt = T._opt(pkg, pkg.DataSet.array(x, y, batch_size=8), 6)
        opt.set_telemetry(tel)
        opt.optimize()
        recs = [r for r in tel.ring.records if r["type"] != "compile"]
        for r in recs:
            obs_report.validate_record(r)
        steps = [r for r in recs if r["type"] == "step"]
        return ([r["type"] for r in recs], [sorted(r) for r in steps],
                [r["loss"] for r in steps], [r["iteration"] for r in steps],
                sorted(steps[-1]["spans"]))

    out = {p.name: run(p) for p in T.PKGS}
    j, p = out["jax"], out["port"]
    assert p[0] == j[0] and p[3] == j[3]
    assert p[1] == [sorted(set(k) - {"model_flops", "achieved_flops_s", "mfu"}) for k in j[1]] \
        or p[1] == j[1]
    np.testing.assert_allclose(p[2], j[2], rtol=0, atol=1e-5)
    assert "summary_flush" in p[4]


def test_detached_fit_collects_no_spans(_no_run_dir):
    import test_torch_resilience_training as T

    x, y = T._problem(n=16)
    col = ptrace.SpanCollector()
    ptrace.bind_collector(None)
    T._opt(T.PORT, T.PDataSet.array(x, y, batch_size=8), 2).optimize()
    assert ptrace.current_collector() is None and col.peek() == {}
