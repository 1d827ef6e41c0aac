"""Serving's remaining surface in the port against the JAX package's, on the
CPU: activation drift, the scrape endpoint, causal request spans, bucket
costs, ``PredictionService`` and the server's postmortem.

Each scenario runs through both packages' objects in one test (the MLP
pair, the server helper and ``CROSS_TOL`` are
``test_torch_serving_resilience``'s). Tolerances: drift statistics 1e-5
(f32 means and deviations of the same rows summed in another order), served
and predicted rows ``CROSS_TOL``; the bucket FLOPs within 1% of the analytic
product count, as ``test_torch_obs_health_perf`` holds the LM's step. Every
port record with the new fields passes ``tools/obs_report.py``'s validator.

Tests that touch ``Engine.set_metrics_port``, the run directory or the
trace sampling put back what they found, for later files on the same xdist
worker. The JAX ``Engine`` is reset for the module and put back after it:
a JAX test file that ran before on the same worker may leave it on all 8
virtual devices, where the JAX predictor refuses the batch of 4.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bigdl_tpu.obs import export as jexport
from bigdl_tpu.obs import health as jhealth
from bigdl_tpu.obs import trace as jtrace
from bigdl_tpu.optim.predictor import PredictionService as JPredictionService
from bigdl_tpu_torch.obs import export as pexport
from bigdl_tpu_torch.obs import health as phealth
from bigdl_tpu_torch.obs import trace as ptrace
from bigdl_tpu_torch.optim import PredictionService as PPredictionService

from test_torch_serving_resilience import (CROSS_TOL, JAX, PKGS, PORT, TIMEOUT, _batcher,
                                           _records, _rows, _server, _wait_until, obs_report)

DRIFT_TOL = 1e-5
ACT_KEY = phealth.ACT_STATE_KEY


def _tracing(pkg):
    return jtrace if pkg is JAX else ptrace


@pytest.fixture(autouse=True, scope="module")
def _jax_engine_as_found():
    from bigdl_tpu.utils.engine import Engine as JEngine

    saved = JEngine._state
    JEngine.reset()
    yield
    JEngine._state = saved


@pytest.fixture
def sampled():
    """Every trace head-sampled in both packages; the knobs put back."""
    prev = (jtrace.configure(sample_rate=1.0), ptrace.configure(sample_rate=1.0))
    yield
    jtrace.configure(**prev[0])
    ptrace.configure(**prev[1])


def _validate(records):
    for r in records:
        obs_report.validate_record(r)


# ---------------------------------------------------------------- drift
class TestActivationDrift:
    def test_sample_scores_against_ema_baseline(self):
        """The same matrices through both monitors: the same z, the same
        breach (five stable samples, then a shift of the first layer's
        mean)."""
        def scenario(mod, as_leaf):
            drift = mod.ActivationDrift(mod.DriftConfig(warn_z=6.0, min_samples=3))
            out = []
            for i in range(7):
                mean = 9.0 if i == 6 else 0.1 + 1e-3 * i
                state = {"Linear_0": {ACT_KEY: as_leaf([mean, 1.0, 0.0])},
                         "ReLU_1": {ACT_KEY: as_leaf([0.5, 0.25 + 1e-3 * i, 0.5])}}
                s = drift.sample(state)
                out.append((s["breach"], {p: (round(a["mean_z"], 3), round(a["std_z"], 3))
                                          for p, a in s["acts"].items()}, s["samples"]))
            return out

        jax_out = scenario(jhealth, lambda v: np.asarray(v, np.float32))
        assert scenario(phealth, lambda v: np.asarray(v, np.float32)) == jax_out
        assert scenario(phealth, lambda v: torch.tensor(v, dtype=torch.float32)) == jax_out
        assert jax_out[-1][0]["layer"] == "Linear_0" and jax_out[-1][0]["z"] > 6.0
        assert all(o[0] is None for o in jax_out[:-1])

    def test_no_act_entries_returns_none(self):
        for mod in (jhealth, phealth):
            drift = mod.ActivationDrift()
            assert drift.sample({"Linear_0": {"bias": np.zeros(3, np.float32)}}) is None
            assert drift.sample(None) is None

    def test_served_mlp_drift_rows_match(self):
        """The MLP served by both servers with ``drift=True, drift_every=1``:
        the same layer paths; mean, std and zero fraction within 1e-5."""
        x = np.linspace(-1, 1, 12).astype(np.float32)

        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            with _server(pkg, telemetry=tel) as srv:
                srv.register("m", pkg.mlp(), sample_input=x, drift=True, drift_every=1,
                             max_delay_ms=2, batch_size=4)
                for scale in (1.0, 0.5, -2.0):
                    srv.predict("m", [x * scale])
            # after close(): the batcher samples after resolving the futures
            return [r for r in _records(tel, "serve") if r.get("drift")]

        serves = {pkg.name: scenario(pkg) for pkg in PKGS}
        _validate(serves["port"])
        assert len(serves["port"]) == len(serves["jax"]) == 3
        for p, j in zip(serves["port"], serves["jax"]):
            assert sorted(p["drift"]) == sorted(j["drift"]) == ["Linear_0", "Linear_2",
                                                                "ReLU_1"]
            for layer, jrow in j["drift"].items():
                for k in ("mean", "std", "zero_frac"):
                    assert abs(p["drift"][layer][k] - jrow[k]) <= DRIFT_TOL, (layer, k)
                assert set(p["drift"][layer]) == set(jrow)

    def test_hot_swap_installs_on_new_and_releases_old_model(self):
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            m1, m2 = pkg.mlp(seed=1), pkg.mlp(seed=2)
            walk = (lambda m: m.walk()) if pkg is JAX else (lambda m: list(m.walk()))
            with _server(pkg, telemetry=tel) as srv:
                srv.register("m", m1, drift=True, drift_every=1, max_delay_ms=2)
                srv.predict("m", [np.ones(12, np.float32)])
                srv.update("m", m2)
                old_clean = all(ACT_KEY not in mod._state for mod in walk(m1))
                new_hooked = any(ACT_KEY in mod._state for mod in walk(m2))
                srv.predict("m", [np.ones(12, np.float32)])
            after_close = all(ACT_KEY not in mod._state for mod in walk(m2))
            drifted = [r["version"] for r in _records(tel, "serve") if r.get("drift")]
            return old_clean, new_hooked, after_close, drifted

        assert scenario(JAX)[:2] == scenario(PORT)[:2] == (True, True)
        clean, hooked, after, drifted = scenario(PORT)
        assert after and drifted == [1, 2]  # sampled across the swap; unhooked at close

    def test_shifted_stream_warns_naming_a_layer(self):
        """A stable stream builds the baseline; a shifted one breaches it:
        an ``activation_drift`` warn naming a layer, in both packages."""
        rng = np.random.default_rng(0)
        stable = rng.standard_normal((8, 12)).astype(np.float32) * 0.1

        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            with _server(pkg, telemetry=tel) as srv:
                srv.register("m", pkg.mlp(), sample_input=stable[0], drift=True,
                             drift_every=1, max_delay_ms=2, batch_size=4)
                for r in stable:
                    srv.predict("m", [r])
                srv.predict("m", [stable[0] + 25.0])
            return [(w["reason"], w["model"], w["layer"]) for w in _records(tel, "warn")]

        jw, pw = scenario(JAX), scenario(PORT)
        assert pw and pw[0][:2] == ("activation_drift", "m")
        assert [w[2] for w in pw] == [w[2] for w in jw]


# ------------------------------------------------------------ the endpoint
SERVE_GAUGES = ("bigdl_serve_", "bigdl_model_", "bigdl_breaker_", "bigdl_deadline_",
                "bigdl_rejected_")


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


class TestScrapeEndpoint:
    def test_render_prometheus_is_identical(self):
        """One record list and one health dict: the same text."""
        records = [
            {"type": "step", "iteration": i, "epoch": 1, "loss": 0.5 / (i + 1),
             "records_per_sec": 100.0 + i, "wall_s": 0.01 * (i + 1),
             "input_wait_s": 0.001 * i, "mfu": 0.25, "achieved_flops_s": 1.5e12,
             "model_flops": 3e10, "input_qdepth": 2} for i in range(5)
        ] + [
            {"type": "perf", "mfu": 0.3, "wall_mean_s": 0.02, "arithmetic_intensity": 12.5,
             "bound": "compute", "collective_bytes": 1024,
             "breakdown": {"compute_s": 0.015, "host_s": 0.005}},
            {"type": "compile", "total_compiles": 3},
            {"type": "warn", "reason": "x"}, {"type": "stall"},
            {"type": "serve", "model": "lm", "queue_depth": 3, "batch_fill": 0.75,
             "p50_ms": 12.5, "p99_ms": 40.25, "rps": 80.0, "mfu": 0.1,
             "achieved_flops_s": 9e11, "iteration": 7, "shed": 0},
        ]
        health = {"lm": {"state": "serving", "restarts": 1, "queue_depth": 3, "pending": 4,
                         "deadline_missed": 0, "rejected": 2,
                         "breaker": {"state": "closed"}},
                  "b": {"state": "open", "restarts": 0, "breaker": {"state": "open"}}}
        ident = {"process_index": 0, "host": "h\"1"}
        text = pexport.render_prometheus(records, health, ident)
        assert text == jexport.render_prometheus(records, health, ident)
        assert 'bigdl_model_ready{process="0",host="h\\"1",model="b"} 0' in text
        assert pexport.render_prometheus([], None, ident) == "\n"

    def test_live_servers_answer_with_the_same_status_codes(self, sampled):
        """A live server of each package with ``metrics_port=0``: the same
        status codes for every route (the JAX fleet and trace tests' routes),
        the same gauges, and the endpoint gone after close."""
        def scenario(pkg):
            codes = {}
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[]), metrics_port=0) as srv:
                srv.register("m1", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             batch_size=4, max_delay_ms=2)
                for _ in range(2):  # the second flush's record holds the latencies
                    fut = srv.infer("m1", np.ones(12, np.float32))
                    fut.result(timeout=TIMEOUT)
                tid = fut.trace.trace_id
                base = f"http://127.0.0.1:{srv.metrics_port}"
                assert _wait_until(lambda: '"serve_request"' in _get(
                    f"{base}/trace?id={tid}")[1], timeout=5.0)
                for path in ("/healthz", "/metrics", "/telemetry/tail?n=3",
                             "/telemetry/tail?n=banana", "/telemetry/tail?n=-1",
                             f"/trace?id={tid}", "/trace?id=deadbeef-00000001",
                             "/trace?id=a;drop", "/trace", "/not/a/route"):
                    codes[path.replace(tid, "<tid>")] = _get(base + path)[0]
                _, h = _get(base + "/healthz")
                h = json.loads(h)
                _, metrics = _get(base + "/metrics")
                _, tail = _get(base + "/telemetry/tail?n=3")
                if pkg is PORT:
                    codes["/trace/<tid>"] = _get(f"{base}/trace/{tid}")[0]
                    _, body = _get(f"{base}/trace/{tid}")
                    assert json.loads(body)["trace_id"] == tid
            assert srv.metrics_port is None
            with pytest.raises((urllib.error.URLError, ConnectionError)):
                urllib.request.urlopen(base + "/healthz", timeout=2.0)
            # the serving gauges: the JAX predictor also streams step and
            # compile records of its own, which the port's does not
            gauges = sorted({line.split("{", 1)[0] for line in metrics.splitlines()
                             if line.startswith(SERVE_GAUGES)})
            return (codes, h["ready"], h["models"]["m1"]["state"], gauges,
                    len(json.loads(tail)))

        jout, pout = scenario(JAX), scenario(PORT)
        assert pout[0].pop("/trace/<tid>") == 200
        assert pout == jout
        assert jout[0]["/healthz"] == 200 and jout[0]["/trace?id=<tid>"] == 200
        assert jout[0]["/trace?id=deadbeef-00000001"] == 404
        assert "bigdl_model_ready" in jout[3] and "bigdl_serve_p99_ms" in jout[3]

    def test_engine_metrics_port_attaches_every_telemetry(self):
        """``Engine.set_metrics_port(0)`` binds the process endpoint; a sink
        made while it is set attaches its ring and detaches at close."""
        from bigdl_tpu_torch import Engine
        from bigdl_tpu_torch.obs import Telemetry

        assert Engine.metrics_port() is None
        endpoint = Engine.set_metrics_port(0)
        try:
            assert Engine.metrics_port() == endpoint.port > 0
            tel = Telemetry(exporters=[], heartbeat_interval_s=None)
            tel.warn(reason="probe", path="train")
            assert any(r.get("reason") == "probe" for r in endpoint.tail(5))
            code, body = _get(endpoint.url("/healthz"))
            assert code == 200 and json.loads(body)["models"] is None
            tel.close()
            assert endpoint.tail(5) == []
        finally:
            Engine.set_metrics_port(None)
        assert pexport.default_endpoint() is None and Engine.metrics_port() is None


# ------------------------------------------------------------ causal spans
def _spans(tel):
    return [r for r in tel.ring.records if r.get("type") == "span"]


STAGES = ("req_queue", "req_assembly", "req_dispatch", "req_materialize")


class TestCausalSpans:
    def test_flush_span_links_members(self, sampled):
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[], heartbeat_interval_s=None)
            b, _ = _batcher(pkg, tel)
            try:
                futs = [b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                        for _ in range(3)]
                for f in futs:
                    f.result(timeout=TIMEOUT)
            finally:
                b.stop(drain=False, timeout=10.0)
            assert _wait_until(lambda: any(s["name"] == "serve_flush" for s in _spans(tel)),
                               timeout=5.0)
            flushes = [s for s in _spans(tel) if s["name"] == "serve_flush"]
            linked = {link["trace_id"] for s in flushes for link in s["links"]}
            assert all(f.trace.trace_id in linked for f in futs)
            assert all(s["records"] >= 1 for s in flushes)
            _validate(_spans(tel))
            # the assembly and dispatch spans parent on the flush span
            flush_ids = {s["span_id"] for s in flushes}
            inner = [s for s in _spans(tel) if s["name"] in ("serve_assembly",
                                                             "serve_dispatch")]
            assert inner and all(s["parent_id"] in flush_ids for s in inner)
            return sorted({s["name"] for s in _spans(tel)})

        # the JAX predictor's "pad_mask" span (its pad and device_put) has no
        # counterpart: the port pads inside the forward
        assert scenario(PORT) == [n for n in scenario(JAX) if n != "pad_mask"]

    def test_caller_context_is_parent_of_request(self, sampled):
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[], heartbeat_interval_s=None)
            b, _ = _batcher(pkg, tel)
            caller = _tracing(pkg).new_context()
            try:
                with _tracing(pkg).context_scope(caller):
                    fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                fut.result(timeout=TIMEOUT)
            finally:
                b.stop(drain=False, timeout=10.0)
            return fut.trace.trace_id == caller.trace_id, fut.trace.parent_id == caller.span_id

        assert scenario(JAX) == scenario(PORT) == (True, True)

    def test_slow_request_promoted_fast_one_silent(self):
        def scenario(pkg, slow_ms):
            tr = _tracing(pkg)
            prev = tr.configure(sample_rate=0.0, slow_ms=slow_ms)
            tel = pkg.Telemetry(exporters=[], heartbeat_interval_s=None)
            b, _ = _batcher(pkg, tel)
            try:
                fut = b.submit(pkg.s.ServeRequest(np.ones(12, np.float32)))
                fut.result(timeout=TIMEOUT)
            finally:
                b.stop(drain=False, timeout=10.0)
                tr.configure(**prev)
            roots = [s for s in _spans(tel) if s["name"] == "serve_request"]
            return ([(r["promoted"], r["trace_id"] == fut.trace.trace_id) for r in roots],
                    sorted({s["name"] for s in _spans(tel)}))

        assert scenario(PORT, 0.0) == scenario(JAX, 0.0) == (
            [(True, True)], sorted(("serve_request",) + STAGES))
        assert scenario(PORT, 60000.0) == scenario(JAX, 60000.0) == ([], [])

    def test_live_server_stages_sum_to_total(self, sampled):
        """Every completed request's four stages sum to its root span."""
        tel = PORT.Telemetry(exporters=[], heartbeat_interval_s=None)
        with _server(PORT, telemetry=tel) as srv:
            srv.register("m", PORT.mlp(), sample_input=np.zeros(12, np.float32),
                         batch_size=4, max_delay_ms=2)
            rows = [None] * 12

            def client(idx):
                for i in idx:
                    rows[i] = srv.infer("m", np.full(12, i, np.float32)).result(TIMEOUT)

            threads = [threading.Thread(target=client, args=(range(c, 12, 3),))
                       for c in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
        spans = _spans(tel)
        roots = {s["span_id"]: s for s in spans if s["name"] == "serve_request"}
        assert len(roots) == 12
        for sid, root in roots.items():
            stages = [s for s in spans if s.get("parent_id") == sid]
            assert sorted(s["name"] for s in stages) == sorted(STAGES)
            assert abs(sum(s["dur_s"] for s in stages) - root["dur_s"]) <= 1e-5
        _validate(spans)
        serves = _records(tel, "serve")
        assert all(r["trace_id"] for r in serves)


# ------------------------------------------------------------ bucket costs
COST_FIELDS = ("model_flops", "flops_per_record", "achieved_flops_s", "mfu")


class TestBucketCosts:
    def test_same_cost_fields_and_mlp_flops(self):
        """The serve records of both packages carry the same cost fields;
        the MLP's flops are its products' count, 2 * batch * (12*16 + 16*4)."""
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            with _server(pkg, telemetry=tel) as srv:
                srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             batch_size=4, max_delay_ms=2)
                for _ in range(2):
                    srv.predict("m", [np.ones(12, np.float32)])
            serves = _records(tel, "serve")
            return [sorted(k for k in COST_FIELDS if k in r) for r in serves], serves

        (jkeys, jserves), (pkeys, pserves) = scenario(JAX), scenario(PORT)
        assert pkeys == jkeys and pkeys[-1] == sorted(COST_FIELDS)
        _validate(pserves)
        analytic = 2 * 4 * (12 * 16 + 16 * 4)
        assert pserves[-1]["model_flops"] == analytic
        assert pserves[-1]["flops_per_record"] == analytic / 4
        # XLA's cost analysis adds the bias and ReLU elementwise work (+7%)
        assert analytic <= jserves[-1]["model_flops"] <= 1.1 * analytic

    def test_lm_bucket_flops_are_the_analytic_count(self):
        """The LM's padded-batch forward per bucket (dense attention on the
        CPU): 2 * rows * T * (2-D weights) + 4 * dh * T^2 * rows * heads *
        layers, within 1%."""
        from bigdl_tpu_torch.nn import Transformer
        from bigdl_tpu_torch.serving import ModelServer
        from bigdl_tpu_torch.utils.serialization import tree_items

        v, h, heads, f, layers, b = 96, 32, 2, 64, 2, 4
        m = Transformer(vocab_size=v, hidden_size=h, num_heads=heads, filter_size=f,
                        num_hidden_layers=layers, postprocess_dropout=0.0,
                        attention_dropout=0.0, relu_dropout=0.0, mode="lm", device="cpu")
        ids = np.ones((1, 24), np.int32)
        m.init(sample_input=ids)
        weights = sum(p.numel() for p in tree_items(m.get_parameters()).values()
                      if p.dim() == 2)
        with ModelServer() as srv:
            srv.register("lm", m, sample_input=ids[0], batch_size=b, shape_buckets=(16, 24))
            costs = srv._entry("lm").bucket_costs
        for t in (16, 24):
            analytic = 2 * b * t * weights + 4 * (h // heads) * t * t * b * heads * layers
            assert abs(costs[t]["flops"] - analytic) <= 0.01 * analytic, (t, costs[t])
            assert costs[t]["flops_per_record"] == costs[t]["flops"] / b


# ------------------------------------------------------- PredictionService
class TestPredictionService:
    def test_rows_agree_across_packages_and_threads(self):
        x = np.random.default_rng(4).standard_normal((9, 12)).astype(np.float32)
        jsvc, psvc = JPredictionService(JAX.mlp()), PPredictionService(PORT.mlp())
        want = np.asarray(jsvc.predict(x))
        assert want.shape == (9, 4)
        got = [None] * 9

        def client(idx):
            for i in idx:
                got[i] = _rows(psvc.predict(x[i], single=True))

        threads = [threading.Thread(target=client, args=(range(c, 9, 4),)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        np.testing.assert_allclose(np.stack(got), want, rtol=0, atol=CROSS_TOL)
        batched = psvc.predict(x)
        assert isinstance(batched, torch.Tensor) and batched.device.type == "cpu"
        np.testing.assert_allclose(_rows(batched), want, rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(_rows(jsvc.predict(x[0], single=True)), want[0],
                                   rtol=0, atol=CROSS_TOL)
        assert psvc.pool_size == jsvc.pool_size == 1


# --------------------------------------------------------------- postmortem
class TestServerPostmortem:
    def test_escaping_exception_leaves_a_verified_bundle(self, tmp_path):
        from bigdl_tpu.obs import blackbox as jbb
        from bigdl_tpu.utils.engine import Engine as JEngine
        from bigdl_tpu_torch import Engine as PEngine
        from bigdl_tpu_torch.obs import blackbox as pbb

        class Boom(RuntimeError):
            pass

        def scenario(pkg, engine, bb):
            prev = engine.run_dir()
            collectors = (jtrace.current_collector(), ptrace.current_collector())
            engine.set_run_dir(str(tmp_path / pkg.name))
            try:
                with pytest.raises(Boom):
                    with pkg.s.ModelServer(telemetry=pkg.Telemetry(exporters=[])) as srv:
                        srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                                     max_delay_ms=2)
                        srv.predict("m", [np.ones(12, np.float32)])
                        raise Boom("escaped")
            finally:
                jtrace.bind_collector(collectors[0])
                ptrace.bind_collector(collectors[1])
                bb.disarm_crash_handler()  # the sinks made under the run dir armed it
                if prev:
                    engine.set_run_dir(prev)
                else:
                    _clear_run_dir(engine)
            root = tmp_path / pkg.name / "postmortem"
            bundles = sorted(p for p in root.iterdir() if p.is_dir() and p.name != "hard_crash")
            assert len(bundles) == 1, bundles
            bb.verify_bundle(str(bundles[0]))  # raises on a truncated or tampered bundle
            with open(bundles[0] / "reason.json") as f:
                reason = json.load(f)
            return reason["reason"], reason["error"]["class"]

        jout = scenario(JAX, JEngine, jbb)
        pout = scenario(PORT, PEngine, pbb)
        assert pout == jout
        assert pout == ("server_Boom", "Boom")


def _clear_run_dir(engine):
    import os

    if hasattr(engine, "_state"):
        engine._state.run_dir = None
    else:
        engine.set_run_dir(None)
    os.environ.pop("BIGDL_RUN_DIR", None)
