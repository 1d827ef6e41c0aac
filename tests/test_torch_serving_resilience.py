"""The port's serving resilience against the JAX package's, on the CPU.

Each scenario of ``tests/test_serving_resilience.py`` (deadlines, the
circuit breaker's state machine and its end-to-end cycle, the supervisor on
stub workers and end to end, close/stop failing what is pending, the health
surface) runs through both packages with the same inputs, and the test
requires the same outcome: the typed error and its seam, breaker states and
transition causes, the backoff schedule (seeded jitter: the same floats),
the supervisor's actions, counters, the serve and warn records' fields other
than times. Where only a bound holds (a deadline that fires "around" its
time), both packages are held to it.

The JAX tests inject faults through chaos seams (``FaultPlan`` at
``serve_dispatch`` / ``serve_worker``), which the port does not have. Here
both packages reach the same state another way, the same way: a predictor
whose ``forward_batch`` raises or sleeps, or a worker whose queue read
raises once, which kills its thread.

Models: the JAX tests' MLP (12 -> 16 -> 4) with the JAX model's weights
carried into the port (``load_jax_params``). Served rows against the same
package's ``Predictor``: 1e-6 (the same f32 arithmetic); port against JAX:
1e-5 (f32 sums in another order). Every wait has a timeout.
"""

import contextlib
import importlib.util
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.serving as jserving
import bigdl_tpu.serving.resilience as jresilience
from bigdl_tpu import nn as jnn
from bigdl_tpu.obs import Telemetry as JTelemetry
from bigdl_tpu.optim.predictor import Predictor as JPredictor
from bigdl_tpu.serving import batcher as jbatcher
from bigdl_tpu.utils.random import RandomGenerator as JRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.serving as pserving
import bigdl_tpu_torch.serving.resilience as presilience
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.obs import Telemetry as PTelemetry
from bigdl_tpu_torch.optim import Predictor as PPredictor
from bigdl_tpu_torch.serving import batcher as pbatcher
from bigdl_tpu_torch.utils.convert import load_jax_params

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("obs_report", REPO / "tools" / "obs_report.py")
obs_report = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = obs_report
_spec.loader.exec_module(obs_report)

TIMEOUT = 30
ROW_TOL = 1e-6    # served row vs the same package's Predictor
CROSS_TOL = 1e-5  # port row vs JAX row


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _jax_mlp(seed=7, n_in=12, n_out=4):
    JRandomGenerator.set_seed(seed)
    m = jnn.Sequential(jnn.Linear(n_in, 16), jnn.ReLU(), jnn.Linear(16, n_out))
    m.init(sample_input=np.zeros((1, n_in), np.float32))
    return m


def _port_mlp(seed=7, n_in=12, n_out=4):
    """The port's MLP with the JAX MLP's weights of the same seed."""
    m = pnn.Sequential(pnn.Linear(n_in, 16, device="cpu"), pnn.ReLU(device="cpu"),
                       pnn.Linear(16, n_out, device="cpu"), device="cpu")
    m.init(sample_input=np.zeros((1, n_in), np.float32))
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, _jax_mlp(seed, n_in, n_out)
                                              .get_parameters()))
    return m


def _rows(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


JAX = SimpleNamespace(name="jax", s=jserving, r=jresilience, Telemetry=JTelemetry,
                      mlp=_jax_mlp,
                      predictor=lambda m, bs, **kw: JPredictor(m, batch_size=bs, **kw),
                      nearest_rank=jbatcher._nearest_rank, ServeStats=jbatcher.ServeStats)
PORT = SimpleNamespace(name="port", s=pserving, r=presilience, Telemetry=PTelemetry,
                       mlp=_port_mlp,
                       predictor=lambda m, bs, **kw: PPredictor(m, batch_size=bs, **kw),
                       nearest_rank=pbatcher._nearest_rank, ServeStats=pbatcher.ServeStats)
PKGS = (JAX, PORT)


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` for each package; the port's outcome
    must equal the JAX package's. Returns the port's."""
    out = {p.name: scenario(p, *args) for p in PKGS}
    assert out["port"] == out["jax"], out
    return out["port"]


def _batcher(pkg, tel=None, model=None, **kw):
    model = pkg.mlp() if model is None else model
    kw.setdefault("max_delay_ms", 5.0)
    b = pkg.s.ContinuousBatcher(pkg.predictor(model, 4), name="m", telemetry=tel, **kw)
    b.start()
    return b, model


def _wait_until(cond, timeout=10.0, tick=0.01):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if cond():
            return True
        time.sleep(tick)
    return False


def _records(tel, rtype):
    return [r for r in tel.ring.records if r["type"] == rtype]


class Injected(RuntimeError):
    """The fault the stub predictors raise (the chaos seam's stand-in)."""


def flaky(forward, fail=0, delay_s=0.0):
    """``forward_batch`` that raises ``Injected`` on its first ``fail``
    calls, or sleeps ``delay_s`` on its first call, then forwards."""
    calls = [0]

    def f(x):
        calls[0] += 1
        if calls[0] <= fail:
            raise Injected(f"injected failure {calls[0]}")
        if calls[0] == 1 and delay_s:
            time.sleep(delay_s)
        return forward(x)

    return f


@contextlib.contextmanager
def _server(pkg, **kw):
    """A ``ModelServer`` closed on exit. The JAX server's run binds its span
    collector to the thread that registered; the binding before it is
    restored, as the JAX tests do around a close from another thread."""
    from bigdl_tpu.obs import trace as obs_trace
    from bigdl_tpu_torch.obs import trace as port_trace

    prev = obs_trace.current_collector()
    port_prev = port_trace.current_collector()
    srv = pkg.s.ModelServer(**kw)
    try:
        yield srv
    finally:
        try:
            srv.close(timeout=TIMEOUT)
        finally:
            obs_trace.bind_collector(prev)
            port_trace.bind_collector(port_prev)


# ---------------------------------------------------------------------------
# percentiles
# ---------------------------------------------------------------------------

def test_nearest_rank_and_serve_stats_match_jax():
    lats = list(np.random.default_rng(3).exponential(0.02, 257))

    def scenario(pkg):
        ranks = [pkg.nearest_rank(sorted(lats[:n]), p) for n in (1, 2, 99, 100, 257)
                 for p in (1, 50, 90, 99, 100)]
        st = pkg.ServeStats(window=64)
        summaries = [st.summary(0.0)]
        for i, lat in enumerate(lats):
            st.complete(lat, 1.0 + 0.01 * i)
            if i % 50 == 0:
                summaries.append(st.summary(2.0 + 0.01 * i))
        return ranks, summaries, st.completed

    ranks, summaries, completed = both(scenario)
    assert summaries[0] == (None, None, None) and completed == 257


# ---------------------------------------------------------------------------
# request deadlines
# ---------------------------------------------------------------------------

class TestDeadlines:
    def test_expired_in_queue_raises_typed_and_is_swept(self):
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            b, _ = _batcher(pkg, tel, max_delay_ms=60000.0)  # nothing flushes
            try:
                fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32), deadline_ms=30.0))
                t0 = time.perf_counter()
                with pytest.raises(pkg.s.DeadlineExceeded) as ei:
                    fut.result(timeout=TIMEOUT)
                back = time.perf_counter() - t0 < 5.0  # at the deadline, not the timeout
                swept = _wait_until(lambda: b.health_snapshot()["swept_expired"] >= 1)
                # the sweep counts before it emits its warn: wait for the record too
                warned = _wait_until(lambda: any(w["reason"] == "deadline_exceeded"
                                                 for w in _records(tel, "warn")))
                return (back, ei.value.stage in ("result", "queue"), swept,
                        b.health_snapshot()["deadline_missed"] >= 1, warned)
            finally:
                b.stop()

        assert both(scenario) == (True, True, True, True, True)

    def test_per_model_default_deadline(self):
        def scenario(pkg):
            b, _ = _batcher(pkg, None, max_delay_ms=60000.0, deadline_ms=25.0)
            try:
                fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                with pytest.raises(pkg.s.DeadlineExceeded) as ei:
                    fut.result(timeout=TIMEOUT)
                return type(ei.value).__name__, round(ei.value.deadline_ms, 3)
            finally:
                b.stop()

        assert both(scenario) == ("DeadlineExceeded", 25.0)

    def test_live_requests_unaffected_and_exact(self):
        """An expired request pads no batch and poisons no companion."""
        recs = np.random.default_rng(2).standard_normal((3, 12)).astype(np.float32)

        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            b, model = _batcher(pkg, tel, max_delay_ms=200.0)
            try:
                doomed = b.submit(pkg.s.ServeRequest(recs[0], deadline_ms=5.0))
                time.sleep(0.06)  # the sweep collects it first
                live = [b.submit(pkg.s.ServeRequest(r, deadline_ms=60000.0))
                        for r in recs[1:]]
                with pytest.raises(pkg.s.DeadlineExceeded):
                    doomed.result(timeout=TIMEOUT)
                outs = np.stack([_rows(f.result(timeout=TIMEOUT)) for f in live])
                ref = _rows(pkg.predictor(model, 4).predict(recs[1:]))
                np.testing.assert_allclose(outs, ref, rtol=0, atol=ROW_TOL)
                serves = _records(tel, "serve")
                return (outs, bool(serves) and serves[-1]["deadline_missed"] >= 1,
                        all(s["records"] <= 2 for s in serves))
            finally:
                b.stop()

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][1:] == outs["jax"][1:] == (True, True)
        np.testing.assert_allclose(outs["port"][0], outs["jax"][0], rtol=0, atol=CROSS_TOL)

    def test_inflight_result_seam_miss_is_counted(self):
        """A request that expires mid-dispatch (popped, so no sweep or flush
        seam sees it again) resolves on the caller's thread, and the miss
        still lands in the counter. The JAX test delays the dispatch through
        the ``serve_dispatch`` chaos seam; here the predictor sleeps."""
        def scenario(pkg):
            model = pkg.mlp()
            pred = pkg.predictor(model, 4)
            pred.forward_batch = flaky(pred.forward_batch, delay_s=0.4)
            b = pkg.s.ContinuousBatcher(pred, name="m", max_delay_ms=2.0)
            b.start()
            try:
                fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32), deadline_ms=60.0))
                with pytest.raises(pkg.s.DeadlineExceeded) as ei:
                    fut.result(timeout=10)
                counted = _wait_until(lambda: b.health_snapshot()["deadline_missed"] >= 1)
                return ei.value.stage, counted, b.health_snapshot()["swept_expired"]
            finally:
                b.stop()

        assert both(scenario) == ("result", True, 0)

    def test_fully_expired_flush_still_warns(self):
        """A flush whose every request was dropped at the flush seam has no
        serve record: the misses surface as one warn."""
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            b = pkg.s.ContinuousBatcher(pkg.predictor(pkg.mlp(), 4), name="m",
                                        telemetry=tel)  # not started
            reqs = [pkg.s.ServeRequest(np.ones(12, np.float32), deadline_ms=1.0)
                    for _ in range(2)]
            for r in reqs:
                r.future._on_resolve = b._future_resolved
            time.sleep(0.01)  # both expired
            b._flush(None, reqs, "max_batch")
            w = _records(tel, "warn")[-1]
            return (all(r.future.done() for r in reqs), _records(tel, "serve"),
                    {k: w[k] for k in ("reason", "path", "model", "count",
                                       "deadline_missed")})

        done, serves, warn = both(scenario)
        assert done and serves == [] and warn["count"] == 2

    def test_admission_seam_expired(self):
        def scenario(pkg):
            b, _ = _batcher(pkg, None, max_delay_ms=60000.0)
            try:
                req = pkg.s.ServeRequest(np.ones(12, np.float32), deadline_ms=0.001)
                time.sleep(0.01)
                with pytest.raises(pkg.s.DeadlineExceeded) as ei:
                    b.submit(req)
                return ei.value.stage, b.health_snapshot()["deadline_missed"]
            finally:
                b.stop()

        assert both(scenario) == ("admission", 1)

    def test_deadline_validation(self):
        def scenario(pkg):
            with pytest.raises(ValueError):
                pkg.s.ServeRequest(np.zeros(3, np.float32), deadline_ms=-1.0)
            with pytest.raises(ValueError):
                pkg.s.ContinuousBatcher(pkg.predictor(pkg.mlp(), 4), deadline_ms=0.0)
            return True

        assert both(scenario)

    def test_server_infer_deadline_override(self):
        def scenario(pkg):
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             max_delay_ms=60000.0, deadline_ms=60000.0)
                with pytest.raises(pkg.s.DeadlineExceeded):
                    srv.infer("m", np.ones(12, np.float32),
                              deadline_ms=20.0).result(timeout=TIMEOUT)
                return srv.models()["m"]["deadline_ms"]

        assert both(scenario) == 60000.0


# ---------------------------------------------------------------------------
# circuit breaker: fake-clock state machine (deterministic: equal traces)
# ---------------------------------------------------------------------------

def _breaker(pkg, **cfg):
    now = {"t": 0.0}
    events = []
    defaults = dict(failure_threshold=3, miss_rate_threshold=0.5, window=8, min_samples=4,
                    probe_backoff_s=1.0, probe_backoff_max_s=8.0, jitter=0.0)
    defaults.update(cfg)
    br = pkg.s.CircuitBreaker(pkg.s.BreakerConfig(**defaults), clock=lambda: now["t"],
                              on_transition=lambda o, n, i: events.append((o, n, i)))
    return br, now, events


class TestCircuitBreakerUnit:
    def test_consecutive_failures_trip_and_probe_closes(self):
        def scenario(pkg):
            br, now, events = _breaker(pkg)
            trace = []
            for step in ("f", "f", "s", "f", "f", "f"):
                (br.record_failure if step == "f" else br.record_success)()
                trace.append(br.state)
            trace += [br.admit(), br.shed, br.retry_in_s()]
            now["t"] = 1.01
            trace += [br.admit(), br.state, br.admit(), br.shed]
            br.record_success()
            trace.append(br.state)
            return trace, events

        trace, events = both(scenario)
        assert trace == ["closed"] * 5 + ["open", False, 1, 1.0, "probe", "half_open", False,
                                          2, "closed"]
        assert events[0][2]["cause"] == "3 consecutive failures"
        assert events[-1][1:] == ("closed", {"cause": "probe_success", "trips": 1})

    def test_probe_failure_reopens_with_longer_backoff(self):
        def scenario(pkg):
            br, now, events = _breaker(pkg)
            for _ in range(3):
                br.record_failure()
            trace = [br.retry_in_s()]
            now["t"] = 1.5
            trace.append(br.admit())
            br.record_failure()  # the probe failed
            trace += [br.state, br.retry_in_s()]
            now["t"] = 4.0
            trace.append(br.admit())
            br.record_deadline_miss()  # an expired probe re-opens too
            trace += [br.state, br.retry_in_s()]
            return trace, [e[2]["cause"] for e in events]

        trace, causes = both(scenario)
        assert trace == [1.0, "probe", "open", 2.0, "probe", "open", 4.0]
        assert causes == ["3 consecutive failures", "probe_window", "probe_failure",
                          "probe_window", "probe_deadline_miss"]

    def test_miss_rate_trips(self):
        def scenario(pkg):
            br, _, events = _breaker(pkg, failure_threshold=100)
            br.record_success(2)
            br.record_deadline_miss()
            first = br.state
            br.record_deadline_miss()  # [F, F, T, T]: rate 0.5 at n = 4
            return first, br.state, events[-1][2]["cause"]

        assert both(scenario) == ("closed", "open", "deadline miss rate 0.50")

    @pytest.mark.parametrize("seed", [0, 1, 17])
    def test_seeded_jitter_deterministic(self, seed):
        """numpy's generator draws the jitter as the JAX package's does: the
        same seed gives the same backoff schedule, float for float."""
        def scenario(pkg):
            br, now, events = _breaker(pkg, jitter=0.3, seed=seed)
            backoffs = []
            for _ in range(4):
                for _ in range(3):
                    br.record_failure()
                backoffs.append(br.retry_in_s())
                now["t"] += 100.0
                assert br.admit() == "probe"
                br.record_failure()  # re-open: the next trip
                backoffs.append(br.retry_in_s())
                now["t"] += 100.0
                br.admit()
                br.record_success(probe=True)
            return backoffs, [e[2].get("retry_in_s") for e in events]

        backoffs, _ = both(scenario)
        assert backoffs == scenario(PORT)[0]  # the same seed again: the same schedule
        assert len(set(backoffs)) > 1

    def test_probe_aborted_frees_the_slot(self):
        def scenario(pkg):
            br, now, _ = _breaker(pkg)
            for _ in range(3):
                br.record_failure()
            now["t"] = 2.0
            trace = [br.admit(), br.admit()]
            br.probe_aborted()
            return trace + [br.admit()]

        assert both(scenario) == ["probe", False, "probe"]

    def test_worker_crash_mid_probe_does_not_wedge_breaker(self):
        def scenario(pkg):
            b, _ = _batcher(pkg, None, max_delay_ms=60000.0, breaker=pkg.s.BreakerConfig(
                failure_threshold=1, probe_backoff_s=0.01, probe_backoff_max_s=0.01,
                jitter=0.0))
            try:
                b.breaker.record_failure()  # trip
                time.sleep(0.02)  # the probe window opens
                probe = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                state = b.breaker.state
                b.fail_pending(pkg.s.WorkerCrashed("test kill"))
                with pytest.raises(pkg.s.WorkerCrashed):
                    probe.result(timeout=5)
                fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                return state, fut is not None, fut.probe
            finally:
                b.stop()

        assert both(scenario) == ("half_open", True, True)

    def test_close_resets_outcome_window(self):
        def scenario(pkg):
            br, now, _ = _breaker(pkg, failure_threshold=100, min_samples=2)
            br.record_deadline_miss(2)
            trace = [br.state]
            br.record_deadline_miss(4, probe=False)  # swept while open
            now["t"] = 2.0
            trace.append(br.admit())
            br.record_success(1, probe=True)
            trace.append(br.state)
            br.record_deadline_miss(1, probe=False)
            return trace + [br.state]

        assert both(scenario) == ["open", "probe", "closed", "closed"]

    def test_straggler_cannot_steal_probe_verdict(self):
        def scenario(pkg):
            br, now, _ = _breaker(pkg)
            for _ in range(3):
                br.record_failure()
            now["t"] = 2.0
            trace = [br.admit()]
            br.record_deadline_miss(probe=False)
            trace.append(br.state)
            br.record_failure(probe=False)
            trace.append(br.state)
            br.record_success(2, probe=False)
            trace.append(br.state)
            br.record_success(1, probe=True)
            return trace + [br.state]

        assert both(scenario) == ["probe", "half_open", "half_open", "half_open", "closed"]

    def test_snapshot_shape(self):
        def scenario(pkg):
            br, now, _ = _breaker(pkg)
            snaps = [br.snapshot()]
            for _ in range(3):
                br.record_failure()
            snaps.append(br.snapshot())
            now["t"] = 0.25
            br.record_deadline_miss()
            return snaps + [br.snapshot()]

        snaps = both(scenario)
        assert snaps[1]["state"] == "open" and snaps[1]["probe_in_s"] == 1.0
        assert snaps[2]["probe_in_s"] == 0.75 and snaps[2]["miss_rate"] == 1.0

    def test_config_validation(self):
        bad = [dict(failure_threshold=0), dict(miss_rate_threshold=1.5),
               dict(probe_backoff_s=0.0), dict(probe_backoff_max_s=0.0), dict(jitter=-1.0),
               dict(window=0)]

        def scenario(pkg):
            for cfg in bad:
                with pytest.raises(ValueError):
                    pkg.s.BreakerConfig(**cfg)
            with pytest.raises(ValueError):
                pkg.s.ContinuousBatcher(pkg.predictor(pkg.mlp(), 4), breaker="yes")
            return len(bad)

        assert both(scenario) == 6


# ---------------------------------------------------------------------------
# circuit breaker: end to end through a server
# ---------------------------------------------------------------------------

class TestCircuitBreakerEndToEnd:
    def test_trip_shed_probe_close_cycle(self):
        """Two failed flushes trip the breaker; the open breaker sheds on the
        caller's thread at once; a sibling model keeps serving; the probe
        closes it. The JAX test fails the dispatches through the chaos seam;
        here the registered predictor's ``forward_batch`` raises twice."""
        x = np.linspace(0, 1, 12).astype(np.float32)

        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            cfg = pkg.s.BreakerConfig(failure_threshold=2, probe_backoff_s=0.05,
                                      probe_backoff_max_s=0.05, jitter=0.0)
            model = pkg.mlp(seed=3)
            with _server(pkg, telemetry=tel) as srv:
                srv.register("frail", model, sample_input=x, max_batch=1, max_delay_ms=2.0,
                             breaker=cfg)
                srv.register("healthy", pkg.mlp(seed=4), sample_input=x, max_delay_ms=2.0)
                pred = srv._entry("frail").predictor
                pred.forward_batch = flaky(pred.forward_batch, fail=2)
                for _ in range(2):
                    with pytest.raises(Injected):
                        srv.infer("frail", x).result(timeout=TIMEOUT)
                opened = _wait_until(lambda: srv.health()["frail"]["state"] == "open")
                t0 = time.perf_counter()
                with pytest.raises(pkg.s.CircuitOpen) as ei:
                    srv.infer("frail", x)
                fast = time.perf_counter() - t0 < 0.05
                sibling = _rows(srv.predict("healthy", [x])).shape
                time.sleep(0.08)  # past the probe backoff
                probe = _rows(srv.infer("frail", x).result(timeout=TIMEOUT))
                ref = _rows(pkg.predictor(model, 32).predict(x[None]))[0]
                np.testing.assert_allclose(probe, ref, rtol=0, atol=ROW_TOL)
                h = srv.health()["frail"]
                out = (opened, fast, ei.value.retry_in_s is not None, sibling, h["state"],
                       h["breaker"]["trips"], h["breaker"]["shed"])
            for rec in tel.ring.records:
                obs_report.validate_record(rec)
            warns = [(w["reason"], w.get("cause")) for w in _records(tel, "warn")]
            sres = obs_report.summarize(tel.ring.records)["serving_resilience"]
            errors = [s["error"].split("(")[0] for s in _records(tel, "serve") if "error" in s]
            return (out, warns, [e["event"] for e in sres["breaker_timeline"]],
                    sres["models"]["frail"]["shed"], errors, probe)

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][:5] == outs["jax"][:5]
        np.testing.assert_allclose(outs["port"][5], outs["jax"][5], rtol=0, atol=CROSS_TOL)
        out, warns, timeline, shed, errors, _ = outs["port"]
        assert out == (True, True, True, (1, 4), "serving", 1, 1)
        assert warns == [("circuit_open", "2 consecutive failures"),
                         ("circuit_closed", "probe_success")]
        assert timeline == ["circuit_open", "circuit_closed"] and shed >= 1
        assert errors == ["Injected", "Injected"]

    def test_deadline_miss_rate_trips_breaker(self):
        def scenario(pkg):
            cfg = pkg.s.BreakerConfig(failure_threshold=100, miss_rate_threshold=0.5,
                                      min_samples=2, probe_backoff_s=60.0, jitter=0.0)
            b, _ = _batcher(pkg, pkg.Telemetry(exporters=[]), max_delay_ms=60000.0, breaker=cfg)
            try:
                futs = [b.submit(pkg.s.ServeRequest(np.ones(12, np.float32), deadline_ms=20.0))
                        for _ in range(2)]
                for f in futs:
                    with pytest.raises(pkg.s.DeadlineExceeded):
                        f.result(timeout=TIMEOUT)
                opened = _wait_until(lambda: b.breaker.state == "open")
                with pytest.raises(pkg.s.CircuitOpen) as ei:
                    b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                return opened, ei.value.reason
            finally:
                b.stop()

        assert both(scenario) == (True, "open after 1 trip(s)")


# ---------------------------------------------------------------------------
# supervisor: fake-clock units on stub workers (deterministic: equal actions)
# ---------------------------------------------------------------------------

class _StubWorker:
    def __init__(self):
        self.alive = True
        self.beat = 0.0
        self._stopped = False
        self.failures = []
        self.restarts = 0
        self.failed_reason = None
        self.wedged = False
        self.calls = []

    def stopped(self):
        return self._stopped

    def worker_alive(self):
        return self.alive

    def last_beat(self):
        return self.beat

    def fail_pending(self, exc):
        self.calls.append("fail_pending")
        self.failures.append(type(exc).__name__)
        return 1

    def restart_worker(self):
        self.restarts += 1
        self.alive = True
        return True

    def mark_failed(self, reason):
        self.calls.append("mark_failed")
        self.failed_reason = reason

    def note_wedged(self, wedged):
        self.wedged = wedged


def _sup(pkg, **kw):
    now = {"t": 0.0}
    tel = pkg.Telemetry(exporters=[])
    defaults = dict(heartbeat_timeout_s=5.0, restart_backoff_base_s=1.0,
                    restart_backoff_max_s=8.0, jitter=0.0, max_restarts=2, telemetry=tel,
                    clock=lambda: now["t"])
    defaults.update(kw)
    return pkg.s.ServingSupervisor(**defaults), now, tel


def _warn_reasons(tel):
    return [r["reason"] for r in _records(tel, "warn")]


class TestSupervisorUnit:
    def test_dead_worker_failed_then_restarted_after_backoff(self):
        def scenario(pkg):
            sup, now, tel = _sup(pkg)
            w = _StubWorker()
            sup.watch("m", w)
            acts = [sup.check()]
            w.alive = False
            acts.append(sup.check())
            now["t"] = 0.5
            acts.append(sup.check())
            now["t"] = 1.1
            acts.append(sup.check())
            return acts, w.failures, w.restarts, w.alive, _warn_reasons(tel)

        acts, failures, restarts, alive, warns = both(scenario)
        assert acts[0] == [] and acts[1][0]["action"] == "fail_pending"
        assert acts[1][0]["restart_in_s"] == 1.0 and acts[2] == []
        assert acts[3][0]["action"] == "restart" and restarts == 1 and alive
        assert failures == ["WorkerCrashed"] and warns == ["worker_restart"]

    @pytest.mark.parametrize("jitter", [0.0, 0.2])
    def test_restart_backoff_grows_with_attempts(self, jitter):
        def scenario(pkg):
            sup, now, _ = _sup(pkg, jitter=jitter, seed=5, max_restarts=5)
            w = _StubWorker()
            sup.watch("m", w)
            backoffs = []
            for _ in range(4):
                w.alive = False
                b = sup.check()[0]["restart_in_s"]
                backoffs.append(b)
                now["t"] += b + 0.01
                sup.check()  # the restart
            return backoffs

        backoffs = both(scenario)
        if jitter == 0.0:
            assert backoffs == [1.0, 2.0, 4.0, 8.0]
        else:
            assert all(1.0 <= b / min(8.0, 2.0 ** i) <= 1.2 for i, b in enumerate(backoffs))

    def test_restart_budget_exhausted_marks_failed(self):
        def scenario(pkg):
            sup, now, tel = _sup(pkg, max_restarts=1)
            w = _StubWorker()
            w.restarts = 1  # budget already spent
            sup.watch("m", w)
            w.alive = False
            acts = [sup.check(), sup.check()]
            return (acts, w.failed_reason, w.failures, w.calls, _warn_reasons(tel))

        acts, reason, failures, calls, warns = both(scenario)
        assert acts == [[{"model": "m", "action": "gave_up", "failed_pending": 1}], []]
        assert reason is not None and failures == ["WorkerCrashed"]
        assert calls.index("mark_failed") < calls.index("fail_pending")
        assert warns == ["worker_dead"]

    def test_wedged_worker_fails_pending_and_rearms(self):
        def scenario(pkg):
            sup, now, tel = _sup(pkg)
            w = _StubWorker()
            sup.watch("m", w)
            now["t"] = 6.0  # past the 5 s heartbeat bound
            trace = [sup.check(), w.wedged, sup.check()]
            w.beat = 6.0
            trace += [sup.check(), w.wedged]
            now["t"] = 12.0
            trace += [sup.check(), len(w.failures)]
            wedge_warns = [{k: r[k] for k in ("reason", "model", "heartbeat_age_s",
                                              "failed_pending")}
                           for r in _records(tel, "warn")]
            return trace, wedge_warns

        trace, warns = both(scenario)
        assert trace[0][0]["action"] == "wedged" and trace[1] is True
        assert trace[3] == [] and trace[4] is False and trace[6] == 3
        assert [w["reason"] for w in warns] == ["worker_wedged", "worker_wedged"]

    def test_stopped_worker_ignored(self):
        def scenario(pkg):
            sup, _, _ = _sup(pkg)
            w = _StubWorker()
            w._stopped, w.alive = True, False
            sup.watch("m", w)
            acts = sup.check()
            sup.unwatch("m")
            return acts, sup.watched()

        assert both(scenario) == ([], [])


# ---------------------------------------------------------------------------
# supervisor: end to end, a killed worker restarts and serves again
# ---------------------------------------------------------------------------

def kill_once(batcher):
    """Make the batching thread's next queue read raise once: the exception
    escapes its loop and kills the thread (the JAX test's ``serve_worker``
    chaos seam does the same from inside the loop)."""
    groups, fired = batcher.queue.groups, []

    def dying():
        if not fired:
            fired.append(1)
            raise Injected("worker killed")
        return groups()

    batcher.queue.groups = dying


class TestSupervisorEndToEnd:
    def test_killed_worker_restarts_and_serves_again(self):
        x = np.linspace(-1, 1, 12).astype(np.float32)

        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            sup = pkg.s.ServingSupervisor(poll_interval_s=0.02, heartbeat_timeout_s=30.0,
                                          restart_backoff_base_s=0.01,
                                          restart_backoff_max_s=0.02, jitter=0.0,
                                          telemetry=tel)
            model = pkg.mlp(seed=5)
            with _server(pkg, telemetry=tel, supervisor=sup) as srv:
                srv.register("m", model, sample_input=x, max_delay_ms=60000.0)
                kill_once(srv._entry("m").batcher)
                with pytest.raises(pkg.s.WorkerCrashed):
                    srv.infer("m", x).result(timeout=TIMEOUT)
                restarted = _wait_until(lambda: srv.health()["m"]["worker_alive"]
                                        and srv.health()["m"]["restarts"] >= 1)
                # the delay bound is far out: close()'s drain serves this one,
                # on the restarted worker
                fut = srv.infer("m", x)
            out = _rows(fut.result(timeout=TIMEOUT))
            ref = _rows(pkg.predictor(model, 32).predict(x[None]))[0]
            np.testing.assert_allclose(out, ref, rtol=0, atol=ROW_TOL)
            n_restarts = obs_report.summarize(tel.ring.records)["serving_resilience"][
                "n_restarts"]
            return restarted, "worker_restart" in _warn_reasons(tel), n_restarts >= 1, out

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][:3] == outs["jax"][:3] == (True, True, True)
        np.testing.assert_allclose(outs["port"][3], outs["jax"][3], rtol=0, atol=CROSS_TOL)


# ---------------------------------------------------------------------------
# close/stop never leaves a caller blocked
# ---------------------------------------------------------------------------

class TestCloseFailsPending:
    def test_stop_no_drain_fails_queued_typed(self):
        def scenario(pkg):
            b, _ = _batcher(pkg, None, max_delay_ms=60000.0)
            fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
            stopper = threading.Thread(target=lambda: (time.sleep(0.05), b.stop(drain=False)),
                                       daemon=True)
            stopper.start()
            with pytest.raises(pkg.s.ServerClosed):
                fut.result(timeout=TIMEOUT)
            stopper.join(TIMEOUT)
            with pytest.raises(pkg.s.ServingStopped):
                b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
            return stopper.is_alive()

        assert both(scenario) is False

    def test_drain_join_timeout_fails_stragglers(self):
        """A drain whose worker is stuck in a dispatch fails both the popped
        request and the queued one once the join times out. The JAX test
        delays the dispatch through the chaos seam; here the predictor
        sleeps."""
        def scenario(pkg):
            pred = pkg.predictor(pkg.mlp(), 4)
            pred.forward_batch = flaky(pred.forward_batch, delay_s=1.5)
            b = pkg.s.ContinuousBatcher(pred, name="m", max_delay_ms=5.0)
            b.start()
            f1 = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
            inside = _wait_until(lambda: b.queue.depth() == 0)
            f2 = b.submit(pkg.s.ServeRequest(np.zeros(12, np.float32)))
            t0 = time.perf_counter()
            b.stop(drain=True, timeout=0.1)
            quick = time.perf_counter() - t0 < 1.0
            errs = []
            for f in (f1, f2):
                with pytest.raises(pkg.s.ServerClosed) as ei:
                    f.result(timeout=5)
                errs.append(type(ei.value).__name__)
            time.sleep(1.6)  # the stuck dispatch completes and loses the race
            return inside, quick, errs, f1.error() is not None

        assert both(scenario) == (True, True, ["ServerClosed"] * 2, True)

    def test_server_close_no_drain_fails_pending(self):
        def scenario(pkg):
            # close() runs on another thread; the second close on exit is a no-op
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             max_delay_ms=60000.0)
                fut = srv.infer("m", np.ones(12, np.float32))
                closer = threading.Thread(
                    target=lambda: (time.sleep(0.05), srv.close(drain=False)), daemon=True)
                closer.start()
                try:
                    with pytest.raises(pkg.s.ServerClosed) as ei:
                        fut.result(timeout=TIMEOUT)
                finally:
                    closer.join(TIMEOUT)
            return type(ei.value).__name__, closer.is_alive()

        assert both(scenario) == ("ServerClosed", False)

    def test_clean_drain_still_serves(self):
        xs = np.stack([np.full(12, i, np.float32) for i in range(3)])

        def scenario(pkg):
            b, model = _batcher(pkg, None, max_delay_ms=60000.0)
            futs = [b.submit(pkg.s.ServeRequest(r)) for r in xs]
            b.stop(drain=True)
            outs = np.stack([_rows(f.result(timeout=TIMEOUT)) for f in futs])
            np.testing.assert_allclose(outs, _rows(pkg.predictor(model, 4).predict(xs)),
                                       rtol=0, atol=ROW_TOL)
            return outs

        outs = {p.name: scenario(p) for p in PKGS}
        np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=CROSS_TOL)


# ---------------------------------------------------------------------------
# health surface
# ---------------------------------------------------------------------------

class TestHealthSurface:
    def test_health_contract_fields(self):
        def scenario(pkg):
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             max_delay_ms=3.0)
                srv.predict("m", [np.ones(12, np.float32)])
                h = srv.health()["m"]
                info = srv.models()["m"]
            ages = (h.pop("heartbeat_age_s") is not None, h.pop("last_flush_age_s") is not None)
            return (h, ages, pkg.r.is_routable(h),
                    {k: info[k] for k in ("version", "restarts", "deadline_ms", "rejected",
                                          "completed", "max_pending", "retired_versions")})

        h, ages, routable, info = both(scenario)
        assert h["state"] == "serving" and h["breaker"]["state"] == "closed"
        assert ages == (True, True) and routable
        assert info == {"version": 1, "restarts": 0, "deadline_ms": None, "rejected": 0,
                        "completed": 1, "max_pending": None, "retired_versions": []}

    def test_stopped_state_and_breaker_disabled(self):
        def scenario(pkg):
            b, _ = _batcher(pkg, None, breaker=False)
            first = b.health_snapshot()["breaker"]
            b.stop()
            return first, b.health_snapshot()["state"]

        assert both(scenario) == (None, "stopped")

    def test_down_outranks_open(self):
        def scenario(pkg):
            b = pkg.s.ContinuousBatcher(
                pkg.predictor(pkg.mlp(), 4),
                breaker=pkg.s.BreakerConfig(failure_threshold=1, probe_backoff_s=60.0,
                                            jitter=0.0))  # never started
            b.breaker.record_failure()
            return b.breaker.state, b.health_snapshot()["state"], pkg.r.ROUTABLE_STATES

        assert both(scenario) == ("open", "down", ("serving", "probing"))


# ---------------------------------------------------------------------------
# serve records: every field but the times equal
# ---------------------------------------------------------------------------

TIME_FIELDS = {"ts", "wall_s", "queue_wait_ms", "p50_ms", "p99_ms", "rps", "trace_id", "host"}


def test_serve_records_match_jax_field_for_field():
    """Admission rejects, a flush of 3 of 4 rows, a failed flush and a
    drained one: the serve and warn records' fields other than times are
    the JAX package's, and every port record passes the JAX stream
    validator (``tools/obs_report.py``)."""
    def scenario(pkg):
        tel = pkg.Telemetry(exporters=[])
        pred = pkg.predictor(pkg.mlp(), 4)
        b = pkg.s.ContinuousBatcher(pred, name="m", telemetry=tel, max_pending=3,
                                    max_delay_ms=60000.0)
        x = np.random.default_rng(1).standard_normal((4, 12)).astype(np.float32)
        futs = [b.submit(pkg.s.ServeRequest(r)) for r in x[:3]]
        with pytest.raises(pkg.s.AdmissionRejected):
            b.submit(pkg.s.ServeRequest(x[3]))
        b._flush(None, b.queue.pop(None, 4), "max_delay")
        rows = np.stack([_rows(f.result(timeout=TIMEOUT)) for f in futs])
        futs = [b.submit(pkg.s.ServeRequest(r)) for r in x[:2]]
        forward = pred.forward_batch
        pred.forward_batch = flaky(forward, fail=1)
        b._flush(None, b.queue.pop(None, 4), "max_batch")
        for f in futs:
            with pytest.raises(Injected):
                f.result(timeout=TIMEOUT)
        b.submit(pkg.s.ServeRequest(x[3]))
        b.start()
        b.stop(drain=True)
        recs = [r for r in tel.ring.records if r["type"] in ("serve", "warn")]
        for r in recs:
            obs_report.validate_record(r)
        return rows, [{k: v for k, v in r.items() if k not in TIME_FIELDS} for r in recs]

    outs = {p.name: scenario(p) for p in PKGS}
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], rtol=0, atol=CROSS_TOL)
    port, jx = outs["port"][1], outs["jax"][1]
    for r in jx:
        r["error"] = r.get("error", "").split("(")[0] or None
    for r in port:
        r["error"] = r.get("error", "").split("(")[0] or None
    assert port == jx
    assert [(r["records"], r["batch_fill"], r["trigger"], r["rejected"]) for r in port] == [
        (3, 0.75, "max_delay", 1), (2, 0.5, "max_batch", 1), (1, 0.25, "drain", 1)]
